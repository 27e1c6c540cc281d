"""The port's SameDiff control flow and whole-graph export, against the JAX package.

- ``cond`` and ``while_loop`` built through both packages' SameDiff API
  (``tests/test_samediff.py::test_cond``, ``::test_while_loop``) give the
  same values; a recorded loop's inferred output types are the JAX
  package's; a body that changes its carry's type is refused at record
  time in both.
- ``export_stablehlo`` → ``run_stablehlo`` (``::test_stablehlo_export_
  roundtrip``): the exported program computes what ``sd.output`` does, for
  a straight-line graph, a static-trip loop (unrolled), a data-dependent
  loop (``while_loop``) and a ``cond`` (``torch.cond``); the text form
  names every placeholder in argument order, an unused one included;
  ``_require_placeholders``' errors are the JAX package's; ``slice``
  (``lax.dynamic_slice``) takes a fed start on the device and wraps a
  negative start as the JAX package does.
- The north-star chain of ``tests/test_northstar_chain.py`` without its
  native-runtime case: a frozen BERT-mini MLM GraphDef built by
  TensorFlow, imported, fine-tuned with ``sd.fit``, exported, and the
  program run equal to the tuned graph's ``sd.output`` (the JAX chain's
  limits: import 1e-4 of TensorFlow, the loss halved, export 1e-5).
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import autodiff as jad
from deeplearning4j_tpu_torch import autodiff as tad
from deeplearning4j_tpu_torch.autodiff import samediff as tsd_mod

RTOL, ATOL = 1e-5, 1e-6


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


def _cond_graph(pkg):
    """tests/test_samediff.py::test_cond (the core ops square and neg)."""
    t = _new(pkg)
    t._record("square", [t.placeholder("a", (3,), "float32")], {})
    f = _new(pkg)
    f._record("neg", [f.placeholder("a", (3,), "float32")], {})
    sd = _new(pkg)
    pred = sd.placeholder("p", (), "bool")
    x = sd.placeholder("x", (3,), "float32")
    return sd, sd.cond(pred, t, f, [x])


def _while_graph(pkg, counter=True):
    """tests/test_samediff.py::test_while_loop: while i < 5: i += 1,
    s *= 2. With ``counter`` the branches carry explicit outputs, so the
    trip count is static; without, the loop reads its condition."""
    cond = _new(pkg)
    i_c = cond.placeholder("i", (), "int32")
    cond.placeholder("s", (), "float32")
    lt = i_c.lt(5)
    body = _new(pkg)
    i_b = body.placeholder("i", (), "int32")
    s_b = body.placeholder("s", (), "float32")
    outs = [i_b + 1, s_b * 2.0]
    if counter:
        cond.branch_outputs = [lt.name]
        body.branch_outputs = [v.name for v in outs]
    sd = _new(pkg)
    i0 = sd.constant("i0", np.int32(0))
    s0 = sd.constant("s0", np.float32(1.0))
    return sd, sd.while_loop(cond, body, [i0, s0])


def _linear_graph(pkg):
    """tests/test_samediff.py::_linear_graph."""
    sd = _new(pkg)
    x = sd.placeholder("x", (4, 3), "float32")
    w = sd.var("w", np.arange(12, dtype=np.float32).reshape(3, 4) / 10)
    b = sd.var("b", np.zeros(4, np.float32))
    return sd, x.mmul(w) + b


def test_cond():
    (jsd, jout), (tsd, tout) = _cond_graph(jad), _cond_graph(tad)
    assert tsd.to_dict()["variables"] == jsd.to_dict()["variables"]
    xv = np.array([1.0, 2.0, 3.0], np.float32)
    for p, want in ((True, xv ** 2), (False, -xv)):
        got = tsd.output({"p": p, "x": xv}, [tout.name])[tout.name]
        np.testing.assert_allclose(got.numpy(), want)
        np.testing.assert_allclose(
            got.numpy(), jsd.output({"p": p, "x": xv}, [jout.name])[jout.name])


@pytest.mark.parametrize("counter", [True, False],
                         ids=["static_trip", "data_dependent"])
def test_while_loop(counter):
    (jsd, jouts), (tsd, touts) = (_while_graph(jad, counter),
                                  _while_graph(tad, counter))
    assert tsd.to_dict()["variables"] == jsd.to_dict()["variables"]
    (node,) = tsd.ops()
    assert tsd_mod._while_static_trip(tsd, node) == (5 if counter else None)
    i_out, s_out = touts
    tsd_mod.reset_loop_stats()
    assert int(i_out.eval()) == 5 == int(jouts[0].eval())
    assert float(s_out.eval()) == 32.0 == float(jouts[1].eval())
    stats = tsd_mod.loop_stats()
    assert (stats["static"] == {5: 2}) if counter else (
        stats["dynamic_iterations"] == 10)


def test_body_that_changes_its_carry_type_is_refused():
    for pkg in (jad, tad):
        cond = _new(pkg)
        cond.placeholder("i", (), "int32").lt(5)
        body = _new(pkg)
        body.placeholder("i", (), "int32").cast("float32")
        sd = _new(pkg)
        with pytest.raises(ValueError, match="failed shape inference"):
            sd.while_loop(cond, body, [sd.constant("i0", np.int32(0))])


def test_stablehlo_export_roundtrip():
    (jsd, jy), (tsd, ty) = _linear_graph(jad), _linear_graph(tad)
    specs = {"x": ((4, 3), "float32")}
    blob = tsd.export_stablehlo([ty.name], specs)
    assert isinstance(blob, bytes) and len(blob) > 100
    xv = np.random.RandomState(8).randn(4, 3).astype(np.float32)
    out = tad.SameDiff.run_stablehlo(blob, {"x": xv})[ty.name]
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), xv @ tsd.get_value("w"),
                               rtol=1e-5)
    jblob = jsd.export_stablehlo([jy.name], specs)
    np.testing.assert_allclose(
        out.numpy(), jad.SameDiff.run_stablehlo(jblob, {"x": xv})[jy.name],
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("graph", ["cond", "static_while", "dynamic_while"])
def test_control_flow_exports_and_runs(graph):
    if graph == "cond":
        sd, out = _cond_graph(tad)
        specs = {"p": ((), "bool"), "x": ((3,), "float32")}
        feeds = [{"p": p, "x": np.array([1.0, -2.0, 3.0], np.float32)}
                 for p in (True, False)]
    else:
        sd, (_, out) = _while_graph(tad, counter=graph == "static_while")
        specs, feeds = {}, [{}]
    blob = sd.export_stablehlo([out.name], specs)
    text, order = sd.export_stablehlo_text([out.name], specs)
    assert order == sorted(specs)
    assert ("higher_order.cond" in text) == (graph == "cond")
    assert ("while_loop" in text) == (graph == "dynamic_while")
    run = tad.SameDiff.load_stablehlo(blob)
    for f in feeds:
        got = run(f)[out.name]
        want = sd.output(f, [out.name])[out.name]
        assert torch.equal(got, want), (got, want)


def test_require_placeholders_errors():
    for pkg in (jad, tad):
        sd, y = _linear_graph(pkg)
        with pytest.raises(KeyError, match="unknown placeholder"):
            sd.export_stablehlo([y.name], {"nope": ((1,), "float32")})
        with pytest.raises(ValueError, match="is VARIABLE, not a placeholder"):
            sd.export_stablehlo_text([y.name], {"w": ((3, 4), "float32")})


def test_text_form_names_every_placeholder_in_order():
    """An unused placeholder stays an argument (keep_unused), in sorted
    order, in the text and in the program's signature."""
    sd, y = _linear_graph(tad)
    sd.placeholder("a_unused", (2,), "float32")
    specs = {"x": ((4, 3), "float32"), "a_unused": ((2,), "float32")}
    text, order = sd.export_stablehlo_text([y.name], specs)
    assert order == ["a_unused", "x"]
    sig = text.split("def forward(self, ", 1)[1].split(")", 1)[0]
    args = [a.split(":")[0].strip() for a in sig.split(",")]
    users = [a for a in args if a in order]
    assert users == order, sig
    blob = sd.export_stablehlo([y.name], specs)
    xv = np.ones((4, 3), np.float32)
    got = tad.SameDiff.run_stablehlo(blob, {"x": xv, "a_unused": np.zeros(
        2, np.float32)})[y.name]
    torch.testing.assert_close(got, sd.output({"x": xv}, [y.name])[y.name],
                               rtol=0, atol=0)


# -- the north-star chain: TF-frozen BERT-mini → import → fit → export → run --

sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture(scope="module")
def chain():
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    tf = pytest.importorskip("tensorflow")
    import test_northstar_chain as ns

    from deeplearning4j_tpu_torch.modelimport import (
        freeze_tf_function,
        import_tf_graph,
    )

    _, loss_fn = ns._build_tf_bert_mini()
    ids, labels, mask = ns._mlm_batch()
    gd, in_names, out_names = freeze_tf_function(
        loss_fn, tf.constant(ids), tf.constant(labels), tf.constant(mask))
    sd, in_map, out_map = import_tf_graph(
        gd, inputs={in_names[0]: (ns.N, ns.T), in_names[1]: (ns.N, ns.T, ns.V),
                    in_names[2]: (ns.N, ns.T)},
        outputs=out_names, device="cpu")
    feeds = {in_map[in_names[0]]: ids, in_map[in_names[1]]: labels,
             in_map[in_names[2]]: mask}
    loss_name = out_map[out_names[0]]
    tf_loss = float(loss_fn(tf.constant(ids), tf.constant(labels),
                            tf.constant(mask)).numpy())
    imported_loss = float(sd.output(feeds, [loss_name])[loss_name])
    promoted = []
    for name, var in list(sd._vars.items()):
        val = sd._values.get(name)
        if var.var_type.value == "CONSTANT" and val is not None \
                and val.dim() >= 1 and val.numel() > ns.H:
            sd.convert_to_variable(name)
            promoted.append(name)
    cfg = tad.TrainingConfig(
        loss_variable=loss_name, feature_placeholders=[in_map[in_names[0]]],
        label_placeholders=[in_map[in_names[1]], in_map[in_names[2]]],
        updater="adam", updater_args={"lr": 3e-3})
    history = []
    for _ in range(50):
        sd.fit([feeds], cfg)
        history.append(float(sd.output(feeds, [loss_name])[loss_name]))
    specs = {in_map[in_names[0]]: ((ns.N, ns.T), "int32"),
             in_map[in_names[1]]: ((ns.N, ns.T, ns.V), "float32"),
             in_map[in_names[2]]: ((ns.N, ns.T), "float32")}
    blob = sd.export_stablehlo([loss_name], specs)
    exported = tad.SameDiff.run_stablehlo(blob, feeds)[loss_name]
    text, arg_order = sd.export_stablehlo_text([loss_name], specs)
    return dict(tf_loss=tf_loss, imported_loss=imported_loss,
                promoted=promoted, history=history,
                tuned=sd.output(feeds, [loss_name])[loss_name],
                exported=exported, text=text, arg_order=arg_order,
                specs=specs)


class TestNorthStarChain:
    def test_import_matches_tf_oracle(self, chain):
        assert chain["imported_loss"] == pytest.approx(chain["tf_loss"],
                                                       rel=1e-4)

    def test_imported_graph_trains(self, chain):
        assert chain["promoted"], "no weight constants were promoted"
        h = chain["history"]
        assert h[-1] < chain["imported_loss"] * 0.5, h
        assert all(np.isfinite(x) for x in h)

    def test_exported_program_matches_tuned_graph(self, chain):
        assert float(chain["exported"]) == pytest.approx(
            float(chain["tuned"]), rel=1e-5)
        assert chain["exported"].dtype == chain["tuned"].dtype

    def test_text_form_is_the_exported_program(self, chain):
        assert "ExportedProgram" in chain["text"]
        assert chain["arg_order"] == sorted(chain["specs"])
        assert len(chain["arg_order"]) == 3


@pytest.mark.parametrize("fed", [True, False], ids=["fed_start", "attr_start"])
@pytest.mark.parametrize("begin", [[1, 2], [3, 4], [-2, 1], [9, 9]])
def test_dynamic_slice_start_as_jax_and_on_the_device(begin, fed):
    """``slice`` (``lax.dynamic_slice``: a negative start counts from the
    end, a start is clamped so the window fits) gives the JAX package's
    window with its start fed as a tensor or recorded as an attr; a fed
    start is read on the device, so the graph exports."""
    def graph(pkg):
        sd = _new(pkg)
        x = sd.placeholder("x", (5, 6), "float32")
        if not fed:
            return sd, sd._record("slice", [x], {"begin": begin,
                                                 "size": [2, 3]})
        b = sd.placeholder("b", (2,), "int32")
        return sd, sd._record("slice", [x, b], {
            "__argspec__": ["var", "var", "attr"], "__posattrs__": [[2, 3]]})

    (jsd, jy), (tsd, ty) = graph(jad), graph(tad)
    feeds = {"x": np.arange(30, dtype=np.float32).reshape(5, 6)}
    specs = {"x": ((5, 6), "float32")}
    if fed:
        feeds["b"] = np.asarray(begin, np.int32)
        specs["b"] = ((2,), "int32")
    got = tsd.output(feeds, [ty.name])[ty.name]
    np.testing.assert_array_equal(got.numpy(),
                                  jsd.output(feeds, [jy.name])[jy.name])
    blob = tsd.export_stablehlo([ty.name], specs)
    assert torch.equal(tad.SameDiff.run_stablehlo(blob, feeds)[ty.name], got)
