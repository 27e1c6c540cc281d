"""ConvLSTM2D and the Keras next-frame model in the port against the JAX package, on the CPU.

The layer (``nn/layers/recurrent.py``) over [N, T, H, W, C], built as the
JAX package's own tests build it (``tests/test_layers_round3.py``
``TestConvLSTM2D``, ``tests/test_tbptt.py``): SAME and VALID, stride 2,
kernel (3, 2), kernel 2 under VALID, ``return_sequences`` False,
``use_bias`` False, ``unit_forget_bias`` False, an ``initial_state``,
Keras 2's ``hard_sigmoid`` recurrent activation and ``softmax`` gates
(over the channel axis). Every param is drawn from
a numpy seed and carried across; the JAX side is jitted. float32 on both
sides, sums in another order: the forward and the gradients of Σ y·c (a
random cotangent c) with respect to W, RW, b and the input to TOL of each
leaf's max. Shapes, the config JSON both ways, window chaining and the
JAX package's ``Bidirectional`` over a 5-D output (its backward half
left in reversed time) too.

The next-frame model of Keras' ``examples/conv_lstm.py`` at a small size
(2 × [ConvLSTM2D(4) → BatchNorm], Conv3D(1), sigmoid + binary
cross-entropy; 8×8 frames, T=5, batch 3, AdaDelta(rho=0.95, eps=1e-7)),
the config the JAX package's, carried across as JSON, its variables the
JAX ``init``: the loss to TOL_LOSS relative, every gradient leaf to TOL of
its max, BatchNorm's running statistics and one AdaDelta step to
TOL_STEP absolute (an AdaDelta update is at most sqrt(eps/(1 − rho)) ≈
1.4e-3 in size, and a function of g with slope ≤ 1); one TBPTT batch
(``tbptt_length=2``: windows of 2, 2 and a tail of 1) window by window:
each window's loss, the carries it hands on and the params after the
batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNet
from deeplearning4j_tpu.nn.config import SequentialConfig as JaxSeqConfig
from deeplearning4j_tpu.nn.config import config_from_json as jax_from_json
from deeplearning4j_tpu.nn.config import config_to_json as jax_to_json
from deeplearning4j_tpu.nn.model import SequentialModel as JaxModel
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import AdaDelta as JaxAdaDelta
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import (
    SequentialConfig,
    config_from_json,
    config_to_json,
)
from deeplearning4j_tpu_torch.nn.model import SequentialModel
from deeplearning4j_tpu_torch.train.trainer import Trainer
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

TOL = 1e-5
TOL_LOSS = 1e-5
TOL_STEP = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(float(np.abs(want).max()),
                                                 1e-30)


# (id, layer kwargs, input shape [T, H, W, C] with batch 2, initial state)
LAYER_CASES = [
    ("same", dict(filters=4, kernel=3, padding="SAME"), (5, 6, 6, 3), False),
    ("valid", dict(filters=4, kernel=3, padding="VALID"), (5, 6, 6, 3),
     False),
    ("stride2_kernel32_valid", dict(filters=4, kernel=(3, 2), stride=(2, 2),
                                    padding="VALID"), (5, 8, 8, 3), False),
    ("stride2_same", dict(filters=3, kernel=3, stride=2, padding="SAME"),
     (4, 7, 6, 2), False),
    ("kernel32_same", dict(filters=3, kernel=(3, 2), padding="SAME"),
     (4, 6, 7, 2), False),
    ("kernel2_valid", dict(filters=2, kernel=2, padding="VALID"),
     (3, 5, 5, 1), False),
    ("last_step", dict(filters=3, kernel=3, padding="SAME",
                       return_sequences=False), (4, 6, 6, 2), False),
    ("no_bias", dict(filters=3, kernel=3, padding="SAME", use_bias=False),
     (4, 6, 6, 2), False),
    ("no_unit_forget_bias", dict(filters=3, kernel=3, padding="SAME",
                                 unit_forget_bias=False), (4, 6, 6, 2),
     False),
    ("initial_state", dict(filters=3, kernel=3, padding="SAME"),
     (4, 6, 6, 2), True),
    ("keras2_hard_sigmoid", dict(filters=3, kernel=3, padding="SAME",
                                 recurrent_activation="hardsigmoid"),
     (4, 6, 6, 2), False),
    # softmax acts over the gates' channel axis, as on the JAX layer's NHWC
    ("channel_softmax", dict(filters=3, kernel=3, padding="SAME",
                             activation="softmax",
                             recurrent_activation="log_softmax"),
     (4, 6, 6, 2), False),
]


def _layer_case(kw, shape, seed):
    """Both layers, the JAX init's shapes with every leaf drawn from the
    seed (biases included), and an input [2, T, H, W, C]."""
    jl, pl = JL.ConvLSTM2D(**kw), L.ConvLSTM2D(**kw)
    p, _ = jl.init(jax.random.key(0), shape, jnp.float32)
    params = {k: _rand(seed + i, v.shape, 0.3)
              for i, (k, v) in enumerate(sorted(p.items()))}
    return jl, pl, params, _rand(seed + 10, (2, *shape))


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_layer_forward_and_gradients_match_jax(case):
    _, kw, shape, with_state = case
    jl, pl, params, x = _layer_case(kw, shape, 1)
    out = jl.output_shape(shape)
    assert pl.output_shape(shape) == out
    state = None
    if with_state:
        hw = jl.output_shape(shape)[1:]
        state = (_rand(20, (2, *hw), 0.5), _rand(21, (2, *hw), 0.5))
    c = _rand(30, (2, *out))

    def jax_loss(p, x, s):
        y, _ = jl.apply(p, {}, x, initial_state=s)
        return jnp.sum(y * c), y

    (_, y_want), (g_want, gx_want) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, x, state)
    pt = {k: _t(v, True) for k, v in params.items()}
    xt = _t(x, True)
    st = None if state is None else tuple(_t(s) for s in state)
    y, new_state = pl.apply(pt, {}, xt, initial_state=st)
    assert new_state == {}
    _close(y, y_want)
    (y * _t(c)).sum().backward()
    assert set(pt) == set(g_want) == ({"W", "RW", "b"} if kw.get(
        "use_bias", True) else {"W", "RW"})
    for k in pt:
        _close(pt[k].grad, g_want[k])
    _close(xt.grad, gx_want)


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_init_shapes_and_config_json_match_jax(case):
    _, kw, shape, _ = case
    jl, pl = JL.ConvLSTM2D(**kw), L.ConvLSTM2D(**kw)
    jp, _ = jl.init(jax.random.key(0), shape, jnp.float32)
    pp, pstate = pl.init(torch.Generator().manual_seed(0), shape,
                         torch.float32)
    assert pstate == {}
    assert {k: tuple(v.shape) for k, v in pp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    if "b" in pp:
        # the Keras gate order i, f, c, o: with unit_forget_bias the f
        # slice starts at 1
        np.testing.assert_array_equal(pp["b"].numpy(), np.asarray(jp["b"]))
    # the JAX package's JSON loads in the port, the port's in the JAX
    # package, and both write the same document
    back = config_from_json(jax_to_json(jl))
    assert isinstance(back, L.ConvLSTM2D)
    assert back.output_shape(shape) == jl.output_shape(shape)
    assert config_to_json(back) == jax_to_json(jl) == config_to_json(pl)
    assert jax_from_json(config_to_json(back)) == jax_from_json(
        jax_to_json(jl))


def test_window_chaining_equals_the_full_forward():
    """``apply_window`` over 4 + 6 frames, the carry handed on, equals
    ``apply`` over 10, and each window's final (h, c) the JAX layer's."""
    kw = dict(filters=4, kernel=3, padding="SAME")
    jl, pl, params, _ = _layer_case(kw, (10, 6, 6, 3), 3)
    x = _rand(40, (2, 10, 6, 6, 3))
    pt = {k: _t(v) for k, v in params.items()}
    with torch.no_grad():
        y_full, _ = pl.apply(pt, {}, _t(x))
        y1, s1, carry = pl.apply_window(pt, {}, _t(x[:, :4]), None)
        y2, _, final = pl.apply_window(pt, {}, _t(x[:, 4:]), carry)
    assert s1 == {}
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               rtol=1e-5, atol=1e-5)
    _, _, jcarry = jax.jit(lambda p, x: jl.apply_window(p, {}, x, None))(
        params, x[:, :4])
    _, _, jfinal = jax.jit(lambda p, x, c: jl.apply_window(p, {}, x, c))(
        params, x[:, 4:], jcarry)
    for got, want in zip(carry + final, tuple(jcarry) + tuple(jfinal)):
        _close(got, want)
    # return_sequences=False: a window gives h_T, the final carry's h
    last = L.ConvLSTM2D(**kw, return_sequences=False)
    with torch.no_grad():
        h, _, (h_t, _) = last.apply_window(pt, {}, _t(x[:, :4]), None)
    assert torch.equal(h, h_t) and torch.equal(h, y1[:, -1])


@pytest.mark.parametrize("merge", ["concat", "add"])
def test_bidirectional_over_5d_keeps_the_jax_packages_time_order(merge):
    """``Bidirectional`` flips the backward direction's output back only
    when it is 3-D, in both packages: over ConvLSTM2D's [N, T, H, W, F]
    the backward half stays in reversed time. The port computes the JAX
    package's function, that one included."""
    kw = dict(filters=3, kernel=3, padding="SAME")
    shape = (4, 5, 5, 2)
    jb = JL.Bidirectional(layer=JL.ConvLSTM2D(**kw), merge=merge)
    pb = L.Bidirectional(layer=L.ConvLSTM2D(**kw), merge=merge)
    assert pb.output_shape(shape) == jb.output_shape(shape)
    _, _, pf, x = _layer_case(kw, shape, 5)
    _, _, pbk, _ = _layer_case(kw, shape, 9)
    params = {"fwd": pf, "bwd": pbk}
    want, _ = jax.jit(lambda p, x: jb.apply(p, {"fwd": {}, "bwd": {}}, x))(
        params, x)
    pt = {d: {k: _t(v) for k, v in p.items()} for d, p in params.items()}
    with torch.no_grad():
        got, _ = pb.apply(pt, {"fwd": {}, "bwd": {}}, _t(x))
        fwd, _ = pb.layer.apply(pt["fwd"], {}, _t(x))
        bwd, _ = pb.layer.apply(pt["bwd"], {}, torch.flip(_t(x), dims=(1,)))
    _close(got, want)
    unflipped = torch.cat([fwd, bwd], -1) if merge == "concat" else fwd + bwd
    torch.testing.assert_close(got, unflipped, rtol=0, atol=0)
    flipped = torch.flip(bwd, dims=(1,))
    realigned = (torch.cat([fwd, flipped], -1) if merge == "concat"
                 else fwd + flipped)
    assert (got - realigned).abs().max() > 1e-3


# --- the next-frame model at a small size -----------------------------------

T, S, N, F = 5, 8, 3, 4


def _jax_next_frame(backprop_type="standard", length=0):
    layers = []
    for _ in range(2):
        layers += [JL.ConvLSTM2D(filters=F, kernel=3, padding="SAME",
                                 return_sequences=True), JL.BatchNorm()]
    layers += [JL.Conv3D(filters=1, kernel=3, padding="SAME"),
               JL.LossLayer(activation="sigmoid", loss="xent")]
    net = JaxNet(seed=0, updater=JaxAdaDelta(rho=0.95, eps=1e-7),
                 backprop_type=backprop_type, tbptt_length=length)
    return JaxModel(JaxSeqConfig(net=net, layers=layers,
                                 input_shape=(T, S, S, 1)))


def _port(jm):
    return SequentialModel(SequentialConfig.from_json(jm.config.to_json()),
                           device="cpu")


def _movies(seed):
    """Squares that move by a pixel a frame, a ±0.1 noise ring, the next
    frame as the target (the example's generator at 8×8)."""
    r = np.random.default_rng(seed)
    x = np.zeros((N, T + 1, S, S, 1), np.float32)
    for i in range(N):
        for _ in range(2):
            y0, x0 = r.integers(2, 6, 2)
            dy, dx = r.integers(-1, 2, 2)
            for t in range(T + 1):
                yy, xx = y0 + dy * t, x0 + dx * t
                x[i, t, max(yy - 1, 0):yy + 1, max(xx - 1, 0):xx + 1] = 1.0
    noisy = x[:, :T] + 0.1 * r.choice([-1.0, 0.0, 1.0], size=x[:, :T].shape)
    return {"features": np.clip(noisy, None, 1.0).astype(np.float32),
            "labels": x[:, 1:]}


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


@pytest.fixture(scope="module")
def next_frame():
    jm = _jax_next_frame()
    v = jax.tree_util.tree_map(np.array, jm.init(seed=2))
    return jm, v, _movies(7)


def test_next_frame_model_has_the_examples_layers(next_frame):
    jm, v, batch = next_frame
    model = _port(jm)
    assert [type(l).__name__ for l in model.layers] == [
        "ConvLSTM2D", "BatchNorm", "ConvLSTM2D", "BatchNorm", "Conv3D",
        "LossLayer"]
    assert model.shapes == [tuple(s) for s in jm.shapes]
    assert model.shapes[-1] == (T, S, S, 1)
    n = sum(a.size for a in _np(v["params"]).values())
    assert n == sum(a.numel() for a in flatten_with_names(
        model.init()["params"]) for a in [a[1]])


def test_next_frame_loss_gradients_and_one_adadelta_step_match_jax(
        next_frame):
    jm, v, batch = next_frame
    jt = JaxTrainer(jm)
    jts = jt.init_state(jax.tree_util.tree_map(jnp.asarray, v))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jts.model_state, batch, rng=None),
        has_aux=True))(jts.params)
    jts1, jm1 = jt.train_step(jts, batch)

    trainer = Trainer(_port(jm))
    ts = trainer.init_state(v)
    loss, _, _, grads = trainer._grad_of(ts.params, ts.model_state,
                                         trainer._cast_batch({
                                             k: torch.from_numpy(a)
                                             for k, a in batch.items()}),
                                         None)
    assert abs(float(loss) - float(jloss)) <= TOL_LOSS * abs(float(jloss))
    want_g = _np(jax.tree_util.tree_map(np.array, jgrads))
    got_g = _np(grads)
    assert got_g.keys() == want_g.keys() and len(got_g) == 12
    for n, w in want_g.items():
        _close(got_g[n], w)

    ts1, m1 = trainer.train_step(ts, batch)
    assert abs(float(m1["total_loss"]) - float(jm1["total_loss"])) <= \
        TOL_LOSS * abs(float(jm1["total_loss"]))
    for tree, jtree in ((ts1.params, jts1.params),
                        (ts1.model_state, jts1.model_state),
                        (ts1.opt_state, jts1.opt_state)):
        want = _np(jax.tree_util.tree_map(np.array, jtree))
        got = _np(tree)
        assert got.keys() == want.keys()
        for n, w in want.items():
            assert np.abs(got[n] - w).max() <= TOL_STEP, n
    moved = max(float(np.abs(_np(ts1.params)[n] - a).max())
                for n, a in _np(v["params"]).items())
    assert 1e-4 < moved <= 1.5e-3


def test_next_frame_tbptt_batch_matches_jax_window_by_window():
    """tbptt_length 2 over T=5: windows of 2, 2 and a tail of 1, each one
    AdaDelta update from the carries the window before handed on (the
    port derives ConvLSTM2D's zero carries from a meta-device step, the
    JAX Trainer from eval_shape)."""
    jm = _jax_next_frame("tbptt", 2)
    v = jax.tree_util.tree_map(np.array, jm.init(seed=3))
    batch = _movies(8)
    bounds = [(0, 2), (2, 4), (4, 5)]
    windows = [{k: a[:, lo:hi] for k, a in batch.items()}
               for lo, hi in bounds]

    jt = JaxTrainer(jm)
    jts = jt.init_state(jax.tree_util.tree_map(jnp.asarray, v))
    jcarries = jt._zero_carries(jts, windows[0]["features"])
    jlosses, jhanded = [], []
    for wb in windows:
        jts, jcarries, jmet = jt.train_step_tbptt(jts, wb, jcarries)
        jlosses.append(float(jmet["total_loss"]))
        jhanded.append(_np(jax.tree_util.tree_map(np.array, jcarries)))
    _, jfit = jt._fit_tbptt_batch(
        jt.init_state(jax.tree_util.tree_map(jnp.asarray, v)), batch)
    np.testing.assert_allclose([float(m["total_loss"]) for m in jfit],
                               jlosses, rtol=1e-6)

    trainer = Trainer(_port(jm))
    ts = trainer.init_state(v)
    carries = trainer._zero_carries(ts, torch.from_numpy(
        windows[0]["features"]))
    assert {n: tuple(a.shape) for n, a in _np(carries).items()} == {
        n: tuple(a.shape) for n, a in _np(jax.tree_util.tree_map(
            np.array, jt._zero_carries(jts, windows[0]["features"]))).items()}
    assert all(float(a.abs().max()) == 0 for _, a in flatten_with_names(
        carries))
    losses = []
    for wb, want in zip(windows, jhanded):
        ts, carries, m = trainer.train_step_tbptt(ts, wb, carries)
        losses.append(float(m["total_loss"]))
        got = _np(carries)
        assert got.keys() == want.keys() and len(got) == 4
        for n, w in want.items():
            _close(got[n], w)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL_LOSS)
    want = _np(jax.tree_util.tree_map(np.array, jts.params))
    got = _np(ts.params)
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= 3 * TOL_STEP, n
    # the fit's batch split gives the loop's params
    ts_fit, wmetrics = trainer._fit_tbptt_batch(trainer.init_state(v), batch)
    assert len(wmetrics) == 3 and ts_fit.step == 3
    for n, a in _np(ts_fit.params).items():
        np.testing.assert_array_equal(a, got[n])


def test_tbptt_refuses_a_last_step_convlstm_as_jax_does():
    jm = JaxModel(JaxSeqConfig(
        net=JaxNet(backprop_type="tbptt", tbptt_length=2),
        layers=[JL.ConvLSTM2D(filters=2, padding="SAME",
                              return_sequences=False),
                JL.Flatten(), JL.OutputLayer(units=2, loss="mcxent")],
        input_shape=(4, 5, 5, 1)))
    model = _port(jm)
    with pytest.raises(ValueError, match="return_sequences=True on "
                                         "ConvLSTM2D"):
        model._check_tbptt_compatible(model.layers[0])
