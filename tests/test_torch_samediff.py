"""The port's SameDiff against the JAX package's, on the CPU.

The same graphs are built through both packages' SameDiff API from the
same seeded numpy values and fed the same batches: the forward (the
cached plan and the interpreter), the inferred shapes and dtypes
(``to_dict``), the namespaces and reductions, ``calculate_gradients``,
three Adam steps of ``fit``, and ``save``/``load`` both ways (a zip the
JAX package saved after two Adam steps resumes in the port with JAX's
third step, and the other way round). Outputs to 1e-5 relative (1e-6
absolute), gradients and fitted values to 1e-5 relative (1e-7 absolute);
dtypes equal. ``check_samediff_gradients`` passes in float64.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import autodiff as jad
from deeplearning4j_tpu_torch import autodiff as tad
from deeplearning4j_tpu_torch.autodiff.samediff import dtype_name

RTOL, ATOL = 1e-5, 1e-6
RTOL_GRAD, ATOL_GRAD = 1e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _new(pkg):
    return pkg.SameDiff.create() if pkg is jad else pkg.SameDiff.create(
        device="cpu")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same(got, want, rtol=RTOL, atol=ATOL):
    got_np, want_np = _np(got), np.asarray(want)
    assert got_np.dtype == want_np.dtype, (got_np.dtype, want_np.dtype)
    assert got_np.shape == want_np.shape
    np.testing.assert_allclose(got_np, want_np, rtol=rtol, atol=atol)


# -- graphs, each built the same way through either package ----------------

def _linear(pkg):
    sd = _new(pkg)
    x = sd.placeholder("x", (4, 3), "float32")
    w = sd.var("w", np.arange(12, dtype=np.float32).reshape(3, 4) / 10)
    b = sd.var("b", _rand(1, 4))
    y = x.mmul(w) + b
    return sd, {"x": _rand(2, 4, 3)}, [y.name]


def _sugar(pkg):
    sd = _new(pkg)
    a = sd.constant("a", _rand(3, 2, 3))
    x = sd.placeholder("x", (2, 3), "float32")
    outs = [(a * 3 - 1) / 5, 2.0 - a, 1.0 / (a * a + 1), (a + x) ** 2,
            -x, a.rsub(1.5), a.rdiv(2.0), a.gt(x), a.lte(0.0),
            a.transpose(), a.permute(1, 0), a.reshape(3, 2),
            a.cast("int32"), x.cast("float64")]
    return sd, {"x": _rand(4, 2, 3)}, [o.name for o in outs]


def _namespaces(pkg):
    sd = _new(pkg)
    x = sd.placeholder("x", (3, 4), "float32")
    outs = [sd.nn.softmax(x), sd.nn.gelu(x), sd.nn.layer_norm(x),
            sd.nn.relu(x), sd.math.sin(x), sd.math.cos(x), sd.math.sign(x),
            sd.math.floor(x * 3.0), sd.math.ceil(x * 3.0),
            sd.math.round(x * 3.0), x.norm2(axis=1), sd.nn.leaky_relu(x, 0.2),
            sd.math.logical_and(x.gt(0.0), x.lt(0.5))]
    return sd, {"x": _rand(5, 3, 4)}, [o.name for o in outs]


def _reductions(pkg):
    sd = _new(pkg)
    a = sd.placeholder("a", (3, 5), "float32")
    outs = [a.sum(axis=1), a.sum(), a.mean(), a.mean(axis=0, keepdims=True),
            a.max(axis=1), a.min(), a.std(bias_corrected=True, axis=0),
            a.std(bias_corrected=False), a.argmax(axis=1), a.argmin(),
            sd._record("prod", [a], {"axis": [0, 1], "keepdims": False}),
            sd._record("var", [a], {"axis": 1}),
            sd._record("sum", [a], {"axis": []}),
            sd._record("cumsum", [a], {"axis": 1})]
    return sd, {"a": _rand(6, 3, 5)}, [o.name for o in outs]


def _structural(pkg):
    sd = _new(pkg)
    x = sd.placeholder("x", (2, 3, 4), "float32")
    ids = sd.placeholder("ids", (2, 2), "int32")
    table = sd.constant("table", _rand(7, 6, 3))
    r = sd._record
    outs = [
        r("concat", [x, x], {"__argspec__": ["var", "var"],
                             "__posattrs__": [], "axis": 1}),
        r("stack", [x, x], {"__argspec__": ["var", "var"],
                            "__posattrs__": [], "axis": 0}),
        r("expand_dims", [x], {"axis": 1}),
        r("squeeze", [r("expand_dims", [x], {"axis": 0})], {"axis": [0]}),
        r("slice", [x], {"begin": [0, 1, 1], "size": [2, 2, 3]}),
        r("slice", [x], {"begin": [0, 2, 3], "size": [1, 2, 2]}),  # clamped
        r("strided_slice", [x], {"begin": [0, 2, 3], "end": [2, -4, 0],
                                 "strides": [1, -1, -2]}),
        r("gather", [table, ids], {"axis": 0}),
        r("gather", [x, ids], {"axis": 2}),
        r("tile", [x], {"reps": [1, 2]}),
        r("where", [x.gt(0.0), x, x * 2.0], {}),
        r("maximum", [x, x * 0.5], {}), r("minimum", [x, x * 0.5], {}),
        r("zeros_like", [x], {}), r("ones_like", [x], {}),
        r("shape_of", [x], {}), r("size", [x], {}), r("rank", [x], {}),
        r("mod", [x, sd.constant("three", np.float32(3.0))], {}),
    ]
    *_, last = r("unstack", [x], {"axis": 1})
    feeds = {"x": _rand(8, 2, 3, 4),
             "ids": np.asarray([[0, 5], [-1, 2]], np.int32)}
    return sd, feeds, [o.name for o in outs] + [last.name]


GRAPHS = {"linear": _linear, "sugar": _sugar, "namespaces": _namespaces,
          "reductions": _reductions, "structural": _structural}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph_pair(request):
    build = GRAPHS[request.param]
    return build(jad), build(tad)


def test_forward_matches_jax(graph_pair):
    (jsd, feeds, names), (tsd, _, tnames) = graph_pair
    assert names == tnames
    want = jsd.output(feeds, names)
    got = tsd.output(feeds, names)
    for n in names:
        assert got[n].device.type == "cpu"
        _same(got[n], want[n])


def test_interpreted_matches_compiled(graph_pair):
    (jsd, feeds, names), (tsd, _, _) = graph_pair
    plan = tsd.output(feeds, names)
    interp = tsd.output(feeds, names, interpreted=True)
    want = jsd.output(feeds, names, interpreted=True)
    for n in names:
        np.testing.assert_array_equal(_np(plan[n]), _np(interp[n]))
        _same(interp[n], want[n])


def test_inferred_shapes_and_dtypes_match_jax(graph_pair):
    (jsd, _, _), (tsd, _, _) = graph_pair
    jd, td = jsd.to_dict(), tsd.to_dict()
    assert td["variables"] == jd["variables"]
    assert [o["op"] for o in td["ops"]] == [o["op"] for o in jd["ops"]]
    assert [o["attrs"] for o in td["ops"]] == [o["attrs"] for o in jd["ops"]]


def test_unknown_shapes_fall_back_where_jax_does():
    """A None dim keeps rank and dtype but no shape; an op that needs its
    inputs' values (tfimport.range) infers nothing, as in jax.eval_shape."""
    from deeplearning4j_tpu.modelimport.tf import ensure_tfimport_ops
    from deeplearning4j_tpu_torch.modelimport import tf as ttf  # noqa: F401

    ensure_tfimport_ops()

    def build(pkg):
        sd = _new(pkg)
        x = sd.placeholder("x", (None, 3), "float32")
        y = sd.math.sin(x).sum(axis=1)
        n = sd.placeholder("n", (), "int32")
        one = sd.constant("one", np.int32(1))
        zero = sd.constant("zero", np.int32(0))
        rng = sd._record("tfimport.range", [zero, n, one], {
            "__argspec__": ["var"] * 3, "__posattrs__": []})
        filled = sd._record("tfimport.fill", [one], {
            "__argspec__": ["attr", "var"], "__posattrs__": [[2, 3]]})
        return sd, [y, rng, filled]

    (jsd, jv), (tsd, tv) = build(jad), build(tad)
    for a, b in zip(jv, tv):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert [v.shape for v in tv] == [None, None, (2, 3)]
    assert tsd.to_dict()["variables"] == jsd.to_dict()["variables"]
    for n in (2, 7):
        xv = _rand(9, n, 3)
        _same(tsd.output({"x": xv}, [tv[0].name])[tv[0].name],
              jsd.output({"x": xv}, [jv[0].name])[jv[0].name])


def test_gather_reads_out_of_range_ids_as_jnp_take_does():
    def build(pkg):
        sd = _new(pkg)
        t = sd.constant("t", _rand(10, 4, 2))
        it = sd.constant("it", np.arange(4, dtype=np.int32) * 3)
        ids = sd.placeholder("ids", (5,), "int32")
        return sd, [sd._record("gather", [t, ids], {"axis": 0}).name,
                    sd._record("gather", [it, ids], {"axis": 0}).name]

    (jsd, names), (tsd, _) = build(jad), build(tad)
    feeds = {"ids": np.asarray([0, 3, -1, 4, -5], np.int32)}
    want, got = jsd.output(feeds, names), tsd.output(feeds, names)
    for n in names:
        np.testing.assert_array_equal(_np(got[n]), want[n])


def test_op_listener_fires_interpreted():
    sd, feeds, names = _linear(tad)
    seen = []

    class L:
        def on_op(self, node, outputs):
            seen.append((node.op, dtype_name(outputs[node.outputs[0]].dtype)))

    sd.listeners.append(L())
    sd.output(feeds, names)
    assert seen == []
    sd.output(feeds, names, interpreted=True)
    assert seen == [("matmul", "float32"), ("add", "float32")]


def test_feeding_a_variable_or_constant_raises():
    for pkg in (jad, tad):
        sd, feeds, names = _linear(pkg)
        with pytest.raises(ValueError, match="only placeholders"):
            sd.output(dict(feeds, w=np.zeros((3, 4), np.float32)), names)
        with pytest.raises(KeyError, match="unknown placeholder"):
            sd.output(dict(feeds, nope=np.zeros(1)), names)


def _mlp(pkg, updater="adam"):
    sd = _new(pkg)
    x = sd.placeholder("x", (None, 3), "float32")
    t = sd.placeholder("t", (None,), "int32")
    w1 = sd.var("w1", _rand(11, 3, 8) * 0.5)
    b1 = sd.var("b1", _rand(12, 8) * 0.1)
    w2 = sd.var("w2", _rand(13, 8, 4) * 0.5)
    sd.constant("frozen", _rand(14, 4))
    h = sd.math.sin(sd.nn.layer_norm(x.mmul(w1) + b1))
    logits = h.mmul(w2) + sd.get_variable("frozen")
    loss = sd.loss.sparse_softmax_cross_entropy(logits, t)
    cfg = pkg.TrainingConfig(
        loss_variable=loss.name, feature_placeholders=["x"],
        label_placeholders=["t"], updater=updater,
        updater_args={"learning_rate": 0.05}, l2=1e-3)
    return sd, cfg, loss.name


def _batches(n=3):
    r = np.random.default_rng(15)
    return [{"x": r.standard_normal((6, 3)).astype(np.float32),
             "t": r.integers(0, 4, 6).astype(np.int32)} for _ in range(n)]


def test_calculate_gradients_match_jax():
    (jsd, _, jl), (tsd, _, tl) = _mlp(jad), _mlp(tad)
    feeds = _batches(1)[0]
    want = jsd.calculate_gradients(feeds, jl)
    got = tsd.calculate_gradients(feeds, tl)
    assert sorted(got) == sorted(want) == ["b1", "w1", "w2"]
    for n in want:
        _same(got[n], want[n], RTOL_GRAD, ATOL_GRAD)
    _same(tsd.grad(feeds, tl, "b1"), want["b1"], RTOL_GRAD, ATOL_GRAD)
    _same(tsd.output(feeds, [tl])[tl], jsd.output(feeds, [jl])[jl])


def test_three_adam_steps_of_fit_match_jax():
    (jsd, jcfg, _), (tsd, tcfg, _) = _mlp(jad), _mlp(tad)
    want_hist = jsd.fit(_batches(), jcfg, epochs=1)
    got_hist = tsd.fit(_batches(), tcfg, epochs=1)
    np.testing.assert_allclose(got_hist, want_hist, rtol=RTOL_GRAD)
    assert tsd._iteration == jsd._iteration == 3
    for n in ("w1", "b1", "w2", "frozen"):
        got = tsd.get_value(n)
        assert isinstance(got, np.ndarray)
        _same(got, jsd.get_value(n), RTOL_GRAD, ATOL_GRAD)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_resumes_across_packages(tmp_path, direction):
    """Two Adam steps and a save in one package; load in the other and take
    the third step: the same values as the first package's third step."""
    src, dst = (jad, tad) if direction == "jax_to_port" else (tad, jad)
    batches = _batches()
    sd, cfg, loss = _mlp(src)
    sd.fit(batches[:2], cfg, epochs=1)
    path = tmp_path / "mlp.sdz"
    sd.save(path)
    loaded = (dst.SameDiff.load(path) if dst is jad
              else dst.SameDiff.load(path, device="cpu"))
    assert loaded._iteration == 2
    assert loaded.get_variable("frozen").var_type.value == "CONSTANT"
    assert loaded.get_variable("w1").var_type.value == "VARIABLE"
    feeds = batches[2]
    _same(_np(loaded.output(feeds, [loss])[loss]),
          _np(sd.output(feeds, [loss])[loss]))
    want = sd.fit(batches[2:], epochs=1)
    got = loaded.fit(batches[2:], epochs=1)  # TrainingConfig from the file
    np.testing.assert_allclose(got, want, rtol=RTOL_GRAD)
    for n in ("w1", "b1", "w2"):
        _same(loaded.get_value(n), sd.get_value(n), RTOL_GRAD, ATOL_GRAD)


def test_check_samediff_gradients_passes_in_float64():
    from deeplearning4j_tpu.autodiff import check_samediff_gradients as jcheck

    (jsd, _, jl), (tsd, _, tl) = _mlp(jad), _mlp(tad)
    feeds = _batches(1)[0]
    got = tad.check_samediff_gradients(tsd, feeds, tl, samples_per_param=6,
                                       op_name="tfimport.batch_matmul")
    want = jcheck(jsd, feeds, jl, samples_per_param=6)
    assert got["passed"] and got["checked"] == want["checked"] == 6 * 3
    assert got["worst"]["rel_error"] <= 1e-4
    assert "tfimport.batch_matmul" not in tad.coverage_report()["missing"]


def test_convert_constant_and_variable_in_place():
    sd, cfg, loss = _mlp(tad)
    sd.convert_to_variable("frozen")
    feeds = _batches(1)[0]
    assert "frozen" in sd.calculate_gradients(feeds, loss)
    sd.convert_to_constant("w1")
    assert sorted(sd.calculate_gradients(feeds, loss)) == ["b1", "frozen",
                                                           "w2"]
    with pytest.raises(ValueError, match="PLACEHOLDER"):
        sd.convert_to_variable("x")


def test_jax_control_flow_graph_is_refused_at_load(tmp_path):
    """A JAX-package graph holding a cond loads in the port (the refusal
    of the straight-line slice is gone) and gives the JAX package's output
    for either predicate."""
    t = jad.SameDiff.create()
    t._record("square", [t.placeholder("a", (3,), "float32")], {})
    f = jad.SameDiff.create()
    f._record("neg", [f.placeholder("a", (3,), "float32")], {})
    sd = jad.SameDiff.create()
    out = sd.cond(sd.placeholder("p", (), "bool"), t, f,
                  [sd.placeholder("x", (3,), "float32")])
    sd.save(tmp_path / "cf.sdz")
    loaded = tad.SameDiff.load(tmp_path / "cf.sdz", device="cpu")
    x = _rand(3, 3)
    for p in (True, False):
        _same(loaded.output({"p": p, "x": x}, [out.name])[out.name],
              sd.output({"p": p, "x": x}, [out.name])[out.name])
