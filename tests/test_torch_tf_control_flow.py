"""TF control flow through the port's importer, against the JAX package and TensorFlow.

The cases of ``tests/test_tf_control_flow.py``, one for one and at its
tolerances: each graph is frozen once by TensorFlow (lowered TF1 frames or
functional While/If), imported by the JAX package's ``import_tf_graph``
and by the port's onto the CPU, and

- the outputs are held to each other and to TensorFlow's run;
- the gradients of sum(output) with respect to the input (the input
  promoted to a VARIABLE, as the JAX tests do) are held port against JAX,
  and against TensorFlow's tape where the JAX test holds them there; a
  data-dependent loop raises in both;
- the graph saved by one package loads in the other and gives its
  outputs.

The Keras LSTM(8), GRU(6) and SavedModel-LSTM cases are held against
Keras' own output (rtol 2e-5, atol 2e-6).
"""

import functools
import io
import os
import zipfile

import numpy as np
import pytest
import torch

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.autodiff import samediff as jsd_mod  # noqa: E402
from deeplearning4j_tpu.modelimport.tf import (  # noqa: E402
    ensure_tfimport_ops,
)
from deeplearning4j_tpu.modelimport.tf import (  # noqa: E402
    import_tf_graph as jax_import,
)
from deeplearning4j_tpu_torch.autodiff import samediff as tsd_mod  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    TFImportError,
    import_tf_graph,
    import_tf_saved_model,
)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _freeze(fn, spec, lower):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    conc = tf.function(fn).get_concrete_function(spec)
    frozen = convert_variables_to_constants_v2(conc, lower_control_flow=lower)
    return (frozen.graph.as_graph_def(),
            [t.name.split(":")[0] for t in frozen.inputs],
            [t.name.split(":")[0] for t in frozen.outputs])


# -- the programs of tests/test_tf_control_flow.py ---------------------------

def _loop_fn(x):
    def body(i, acc):
        return i + 1, acc * 1.1 + 0.5

    return tf.while_loop(lambda i, acc: i < 5, body, [tf.constant(0), x])[1]


def _rnn_fn():
    T, N, D, H = 6, 2, 3, 4
    rng = np.random.default_rng(1)
    wx = tf.constant(rng.normal(size=(D, H)).astype(np.float32) * 0.4)
    wh = tf.constant(rng.normal(size=(H, H)).astype(np.float32) * 0.4)
    b = tf.constant(rng.normal(size=(H,)).astype(np.float32) * 0.1)

    def rnn(x):
        def body(t, h):
            return t + 1, tf.tanh(tf.matmul(x[t], wx) + tf.matmul(h, wh) + b)

        return tf.while_loop(lambda t, h: t < T, body,
                             [tf.constant(0), tf.zeros((N, H))])[1]

    return rnn, (T, N, D), rng.normal(size=(T, N, D)).astype(np.float32)


def _captured_fn():
    T, N, D, H = 4, 2, 3, 4
    rng = np.random.default_rng(7)
    wx = tf.constant(rng.normal(size=(D, H)).astype(np.float32) * 0.4)

    def rnn(x):
        def body(t, h):
            return t + 1, tf.tanh(tf.matmul(x[t], wx) + h)

        return tf.while_loop(lambda t, h: t < T, body,
                             [tf.constant(0), tf.zeros((N, H))])[1]

    return rnn, (T, N, D), rng.normal(size=(T, N, D)).astype(np.float32)


def _nested_fn(scale):
    def nested(x):
        def outer_body(i, acc):
            def inner_body(j, a):
                return j + 1, a + 0.5

            _, acc2 = tf.while_loop(lambda j, a: j < 2, inner_body,
                                    [tf.constant(0), acc])
            return i + 1, acc2 * scale

        return tf.while_loop(lambda i, a: i < 3, outer_body,
                             [tf.constant(0), x])[1]

    return nested


def _three_level(x):
    def b1(i, a):
        def b2(j, b):
            def b3(k, c):
                return k + 1, c * 1.1

            _, b2v = tf.while_loop(lambda k, c: k < 2, b3,
                                   [tf.constant(0), b])
            return j + 1, b2v + 0.25

        _, a2 = tf.while_loop(lambda j, b: j < 2, b2, [tf.constant(0), a])
        return i + 1, a2

    return tf.while_loop(lambda i, a: i < 2, b1, [tf.constant(0), x])[1]


def _cond_fn(x):
    return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0, lambda: x - 1.0)


def _lowered_cond_fn(x):
    return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0 + 1.0,
                   lambda: x - 1.0)


def _identity_branch_fn(x):
    return tf.cond(tf.reduce_max(x) > 0.0, lambda: x, lambda: x * 3.0)


def _multi_cond_fn(x):
    def then():
        y = x * 2.0
        return y + 1.0, y - 1.0

    a, b = tf.cond(tf.reduce_sum(x) > 0.0, then, lambda: (x - 3.0, x + 3.0))
    return a * b


def _cond_in_loop_fn(x):
    def body(i, a):
        return i + 1, tf.cond(tf.reduce_sum(a) > 0.0, lambda: a * 0.5,
                              lambda: a + 1.0)

    return tf.while_loop(lambda i, a: i < 3, body, [tf.constant(0), x])[1]


def _multi_cond_in_loop_fn(x):
    def body(i, a):
        p, q = tf.cond(tf.reduce_sum(a) > 0.0, lambda: (a * 0.5, a - 1.0),
                       lambda: (a + 1.0, a * 2.0))
        return i + 1, p + q * 0.25

    return tf.while_loop(lambda i, a: i < 3, body, [tf.constant(0), x])[1]


def _data_dependent_fn(x):
    return tf.while_loop(lambda acc: tf.reduce_sum(acc) < 100.0,
                         lambda acc: (acc * 2.0,), [x])[0]


def _tensor_array_fn():
    T = 6

    def loop_seq(x):
        ta = tf.TensorArray(tf.float32, size=T, element_shape=(2, 3))

        def body(t, h, ta):
            h2 = tf.tanh(x[t] + h)
            return t + 1, h2, ta.write(t, h2)

        _, _, ta = tf.while_loop(lambda t, h, ta: t < T, body,
                                 [0, tf.zeros((2, 3)), ta])
        return ta.stack()

    return loop_seq, (T, 2, 3), np.random.default_rng(5).normal(
        size=(T, 2, 3)).astype(np.float32)


def _keras(layer, in_shape, batch, seed):
    from tensorflow import keras

    m = keras.Sequential([keras.layers.Input(in_shape), layer])
    x = np.random.default_rng(seed).normal(
        size=(batch, *in_shape)).astype(np.float32)
    return (lambda v: m(v, training=False)), (batch, *in_shape), x


def _signs(seed, shape):
    a = np.abs(np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)
    return [a, -a]


def _case(fn, shape, xs, lower, rtol, atol=0.0, grad="jax", ops=()):
    return dict(fn=fn, shape=shape, xs=xs, lower=lower, rtol=rtol,
                atol=atol, grad=grad, ops=ops)


def _from(fn_shape_x, lower, rtol, atol=0.0):
    fn, shape, x = fn_shape_x
    return _case(fn, shape, [x], lower, rtol, atol)


def _rnn(lower):
    return _from(_rnn_fn(), lower, 2e-5, 1e-6)


def _keras_lstm():
    from tensorflow import keras

    fn, shape, x = _keras(keras.layers.LSTM(8, return_sequences=True),
                          (12, 5), 2, 6)
    return _case(fn, shape, [x], False, 2e-5, 2e-6,
                 ops=("TensorListReserve", "While"))


def _keras_gru():
    from tensorflow import keras

    fn, shape, x = _keras(keras.layers.GRU(6, return_sequences=True,
                                           reset_after=True), (10, 4), 3, 8)
    return _case(fn, shape, [x], False, 2e-5, 2e-6)


def _keras_lstm_grad():
    from tensorflow import keras

    fn, shape, x = _keras(keras.layers.LSTM(4, return_sequences=True),
                          (6, 3), 2, 15)
    return _case(fn, shape, [x], False, 2e-5, 2e-6, grad=(5e-5, 1e-5))


def _x(seed, shape):
    return [np.random.default_rng(seed).normal(size=shape).astype(np.float32)]


CASES = {
    # test_while_accumulator_matches_tf and the counter-bounded gradient
    "accumulator_tf1_frames": lambda: _case(
        _loop_fn, (2, 3), _x(0, (2, 3)), True, 1e-5, grad=(2e-5, 1e-6),
        ops=("Enter", "Merge")),
    "accumulator_functional": lambda: _case(
        _loop_fn, (2, 3), _x(0, (2, 3)), False, 1e-5, grad=(2e-5, 1e-6),
        ops=("StatelessWhile",)),
    # test_dynamic_rnn_style_loop
    "dynamic_rnn_tf1_frames": lambda: _rnn(True),
    "dynamic_rnn_functional": lambda: _rnn(False),
    # test_functional_while_with_captured_weights_saves_binary
    "captured_weights_functional": lambda: _from(_captured_fn(), False,
                                                 1e-6),
    # test_nested_frames_import, test_nested_functional_while_imports
    "nested_tf1_frames": lambda: _case(
        _nested_fn(1.25), (2,), [np.asarray([1.0, -2.0], np.float32)], True,
        1e-6, ops=("Enter",)),
    "nested_functional": lambda: _case(
        _nested_fn(1.0), (2,), [np.asarray([1.0, -2.0], np.float32)], False,
        1e-6),
    # test_three_level_nested_frames_import
    "three_level_tf1_frames": lambda: _case(
        _three_level, (3,), [np.asarray([1.0, -1.0, 0.5], np.float32)], True,
        1e-5),
    # test_functional_cond_both_branches, test_grad_flows_through_imported_cond
    "cond_functional": lambda: _case(
        _cond_fn, (2, 3), _signs(3, (2, 3)), False, 1e-6, grad=(2e-5, 1e-6),
        ops=("StatelessIf",)),
    # TestLoweredCondImport
    "cond_tf1": lambda: _case(
        _lowered_cond_fn, (2, 3), _signs(9, (2, 3)), True, 1e-6,
        ops=("Switch", "Merge")),
    "cond_identity_branch_tf1": lambda: _case(
        _identity_branch_fn, (4,),
        [np.asarray(a, np.float32) for a in ([1.0, -2.0, 3.0, 0.5],
                                             [-1.0, -2.0, -3.0, -0.5])],
        True, 1e-6),
    "multi_output_cond_tf1": lambda: _case(
        _multi_cond_fn, (2, 2), _signs(11, (2, 2)), True, 1e-6),
    # test_cond_inside_lowered_frame_imports and its functional form
    "cond_in_loop_tf1_frames": lambda: _case(
        _cond_in_loop_fn, (2,), [np.asarray(a, np.float32) for a in
                                 ([2.0, 1.0], [-3.0, -1.0])], True, 1e-6),
    "cond_in_loop_functional": lambda: _case(
        _cond_in_loop_fn, (2,), [np.asarray(a, np.float32) for a in
                                 ([2.0, 1.0], [-3.0, -1.0])], False, 1e-6),
    # test_multi_output_cond_inside_frame_single_lax_cond
    "multi_output_cond_in_loop_tf1_frames": lambda: _case(
        _multi_cond_in_loop_fn, (2,), [np.asarray([2.0, -1.0], np.float32)],
        True, 1e-6),
    # test_grad_through_data_dependent_while_raises_cleanly
    "data_dependent_while_functional": lambda: _case(
        _data_dependent_fn, (2, 3), [np.abs(_x(4, (2, 3))[0])], False, 1e-6,
        grad="raises"),
    # TestTensorListLoops
    "tensor_array_functional": lambda: _from(_tensor_array_fn(), False,
                                             1e-5, 1e-6),
    "keras_lstm8": _keras_lstm,
    "keras_gru6": _keras_gru,
    # test_imported_keras_lstm_is_differentiable
    "keras_lstm4_grad": _keras_lstm_grad,
}


@functools.lru_cache(maxsize=None)
def _frozen(name):
    c = CASES[name]()
    gd, ins, outs = _freeze(c["fn"], tf.TensorSpec(c["shape"], tf.float32),
                            c["lower"])
    ops = {n.op for n in gd.node}
    for op in c["ops"]:
        assert op in ops, (name, op)
    if c["lower"]:
        assert "Merge" in ops  # really the lowered TF1 form
    else:
        assert not ops & {"Enter", "Merge", "Switch"}
    c["want"] = [np.asarray(c["fn"](tf.constant(x))) for x in c["xs"]]
    return c, gd, ins[0], outs[0]


def _imports(name):
    c, gd, in_name, out_name = _frozen(name)
    jsd, jin, jout = jax_import(gd, outputs=[out_name])
    tsd, tin, tout = import_tf_graph(gd, outputs=[out_name], device="cpu")
    assert tin == jin and tout == jout
    return c, (jsd, tsd), tin[in_name], tout[out_name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_match_jax_and_tf(name):
    c, (jsd, tsd), ph, out = _imports(name)
    for x, want in zip(c["xs"], c["want"]):
        jgot = jsd.output({ph: x}, [out])[out]
        got = tsd.output({ph: x}, [out])[out]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), jgot, rtol=c["rtol"],
                                   atol=c["atol"])
        np.testing.assert_allclose(got.numpy(), want, rtol=c["rtol"],
                                   atol=c["atol"])
    # the recorded variables (shapes and dtypes inferred) are the JAX
    # package's, subgraphs included
    assert tsd.to_dict()["variables"] == jsd.to_dict()["variables"]


def _grad(sd, ph, x, out, value):
    """d sum(out) / d x, the input promoted to a VARIABLE in place."""
    sd._vars[ph].var_type = jsd_mod.VariableType.VARIABLE \
        if isinstance(sd, jsd_mod.SameDiff) else tsd_mod.VariableType.VARIABLE
    sd._values[ph] = value
    loss = sd.get_variable(out).sum()
    return sd.calculate_gradients({}, loss.name, [ph])[ph]


def _tape(fn, x):
    with tf.GradientTape() as tape:
        xt = tf.constant(x)
        tape.watch(xt)
        loss = tf.reduce_sum(fn(xt))
    return np.asarray(tape.gradient(loss, xt))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax(name):
    c, _, _, _ = _frozen(name)
    for x in c["xs"]:
        c, (jsd, tsd), ph, out = _imports(name)  # fresh graphs each time
        if c["grad"] == "raises":
            with pytest.raises(ValueError, match="while_loop|fori_loop"):
                _grad(jsd, ph, x, out, x)
            with pytest.raises(ValueError, match="while_loop|fori_loop"):
                _grad(tsd, ph, x, out, torch.from_numpy(x))
            continue
        want = _grad(jsd, ph, x, out, x)
        got = _grad(tsd, ph, x, out, torch.from_numpy(x.copy())).numpy()
        rtol, atol = c["grad"] if c["grad"] != "jax" else (
            c["rtol"], max(c["atol"], 1e-6))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        if c["grad"] != "jax":  # the JAX test's own oracle: TF's tape
            np.testing.assert_allclose(got, _tape(c["fn"], x), rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_save_load_across_packages(name, tmp_path):
    """Saved by the JAX package → loaded by the port, and back: the
    subgraphs, their values (``__sub__|`` keys) and branch_outputs survive;
    the loaded graph gives the saving package's output."""
    c, (jsd, tsd), ph, out = _imports(name)
    x = c["xs"][0]
    jsd.save(tmp_path / "jax.sdz")
    tsd.save(tmp_path / "port.sdz")
    from_jax = tsd_mod.SameDiff.load(tmp_path / "jax.sdz", device="cpu")
    from_port = jsd_mod.SameDiff.load(tmp_path / "port.sdz")
    ensure_tfimport_ops()
    np.testing.assert_array_equal(from_jax.output({ph: x}, [out])[out].numpy(),
                                  tsd.output({ph: x}, [out])[out].numpy())
    np.testing.assert_array_equal(from_port.output({ph: x}, [out])[out],
                                  jsd.output({ph: x}, [out])[out])
    with zipfile.ZipFile(tmp_path / "port.sdz") as zf:
        with np.load(io.BytesIO(zf.read("arrays.npz"))) as npz:
            port_keys = sorted(npz.files)
    with zipfile.ZipFile(tmp_path / "jax.sdz") as zf:
        with np.load(io.BytesIO(zf.read("arrays.npz"))) as npz:
            assert port_keys == sorted(npz.files)
    if name == "captured_weights_functional":
        # captured body weights land in arrays.npz, binary
        assert any(k.startswith("__sub__|") for k in port_keys)


def test_multi_output_cond_is_one_cond_op():
    _, (jsd, tsd), _, _ = _imports("multi_output_cond_tf1")
    assert [n.op for n in tsd.ops()].count("__cond__") == 1
    assert [n.op for n in jsd.ops()].count("__cond__") == 1


def test_multi_output_cond_inside_frame_is_one_cond_op():
    _, (_, tsd), _, _ = _imports("multi_output_cond_in_loop_tf1_frames")
    (loop,) = [n for n in tsd.ops() if n.op == "__while__"]
    assert [n.op for n in loop.subgraphs["body"].ops()].count("__cond__") == 1


@pytest.mark.parametrize("name,trip", [("accumulator_tf1_frames", 5),
                                       ("accumulator_functional", 5),
                                       ("keras_gru6", 10),
                                       ("data_dependent_while_functional",
                                        None)])
def test_loop_route(name, trip):
    """A counter-bounded loop (Keras' included) takes the static route
    with the JAX package's trip count and reads no condition; a
    data-dependent one reads its condition once an iteration."""
    c, (_, tsd), ph, out = _imports(name)
    (node,) = [n for n in tsd.ops() if n.op == "__while__"]
    assert tsd_mod._while_static_trip(tsd, node) == trip
    tsd_mod.reset_loop_stats()
    tsd.output({ph: c["xs"][0]}, [out])
    stats = tsd_mod.loop_stats()
    if trip is None:
        assert stats["static"] == {} and stats["dynamic_loops"] == 1
        assert stats["dynamic_iterations"] >= 1
    else:
        assert stats["static"] == {trip: 1}
        assert stats["dynamic_iterations"] == 0


def test_tensor_array_without_element_shape_refused():
    """An undeclared element_shape freezes as TensorListReserve(-1): both
    importers refuse it, naming the fix."""
    T = 4

    def loop_seq(x):
        ta = tf.TensorArray(tf.float32, size=T)

        def body(t, ta):
            return t + 1, ta.write(t, x[t] * 2.0)

        return tf.while_loop(lambda t, ta: t < T, body, [0, ta])[1].stack()

    gd, _, outs = _freeze(loop_seq, tf.TensorSpec((T, 3), tf.float32), False)
    with pytest.raises(TFImportError, match="element_shape"):
        import_tf_graph(gd, outputs=outs, device="cpu")
    with pytest.raises(Exception, match="element_shape"):
        jax_import(gd, outputs=outs)


@pytest.mark.parametrize("index", [0, 3, 5, -1, -6, 6, 9, -7])
def test_list_ops_read_clamped_write_dropped_as_jax(index):
    """tfimport.list_get / list_set at an index in and out of range equal
    the JAX package's (dynamic indexing clamps, .at[].set drops)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.autodiff.samediff import OP_REGISTRY as JOPS
    from deeplearning4j_tpu_torch.autodiff.samediff import OP_REGISTRY as TOPS

    ensure_tfimport_ops()
    handle = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    item = np.asarray([-1.0, -2.0], np.float32)
    i = np.int32(index)
    np.testing.assert_array_equal(
        TOPS["tfimport.list_get"](torch.from_numpy(handle),
                                  torch.tensor(i)).numpy(),
        np.asarray(JOPS["tfimport.list_get"](jnp.asarray(handle),
                                             jnp.asarray(i))))
    np.testing.assert_array_equal(
        TOPS["tfimport.list_set"](torch.from_numpy(handle), torch.tensor(i),
                                  torch.from_numpy(item)).numpy(),
        np.asarray(JOPS["tfimport.list_set"](jnp.asarray(handle),
                                             jnp.asarray(i),
                                             jnp.asarray(item))))


def test_saved_model_with_lstm_imports(tmp_path):
    """A TF2 SavedModel holding a Keras LSTM (While + TensorList inside the
    serving signature), through both packages' import_tf_saved_model."""
    from tensorflow import keras

    from deeplearning4j_tpu.modelimport.tf import (
        import_tf_saved_model as jax_saved_model,
    )

    m = keras.Sequential([
        keras.layers.Input((8, 3), batch_size=2),
        keras.layers.LSTM(5, return_sequences=True)])
    d = str(tmp_path / "sm")

    @tf.function(input_signature=[tf.TensorSpec((2, 8, 3), tf.float32)])
    def serve(x):
        return {"y": m(x, training=False)}

    tf.saved_model.save(m, d, signatures={"serving_default": serve})
    sd, in_map, out_map = import_tf_saved_model(d, device="cpu")
    jsd, jin, jout = jax_saved_model(d)
    assert (in_map, out_map) == (jin, jout)
    x = np.random.default_rng(12).normal(size=(2, 8, 3)).astype(np.float32)
    want = np.asarray(m(x, training=False))
    (in_name,), (out_name,) = in_map, out_map
    got = sd.output({in_map[in_name]: x}, [out_map[out_name]])[
        out_map[out_name]].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(
        got, jsd.output({jin[in_name]: x}, [jout[out_name]])[jout[out_name]],
        rtol=2e-5, atol=2e-6)
