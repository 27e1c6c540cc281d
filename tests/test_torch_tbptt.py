"""Truncated BPTT and weight constraints in the port against the JAX package, on the CPU.

A one-hot char stack (vocab 11, two recurrent layers of 32, a softmax
head) of LSTM, GravesLSTM, GRU or SimpleRnn, trained by truncated BPTT
over T = 13 with windows of 5: two full windows and a tail of 3, each one
Adam update. The configs are the JAX package's, carried across as JSON,
and the variables its ``init`` as numpy; the JAX package runs its own
Trainer (jitted, default backends, as its TBPTT tests run it), the port
the plain versions of its sweeps. Per-window losses, the params after the
batch, the refusals and their messages, the window split of masks and
weights, ``fit``'s per-window iterations, the gradient's truncation at a
window's start, and the constraints (each projection and one constrained
step) against the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import constraints as jax_constraints
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNet
from deeplearning4j_tpu.nn.config import SequentialConfig as JaxSeqConfig
from deeplearning4j_tpu.nn.layers import attention as jax_attention
from deeplearning4j_tpu.nn.model import SequentialModel as JaxModel
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.nn import constraints
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import SequentialConfig
from deeplearning4j_tpu_torch.nn.model import GraphModel, SequentialModel
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.utils.pytree import (
    flatten_with_names,
    tree_leaves,
)

V, HID, T, N, WIN = 11, 32, 13, 4, 5   # windows of 5, 5 and a tail of 3
LR = 1e-3
KINDS = ("LSTM", "GravesLSTM", "GRU", "SimpleRnn")
# As tests/test_torch_charrnn.py: float32 on both sides, sums in another
# order. Losses to 1e-6 relative. Adam moves an entry by about lr·sign(g),
# so an entry whose JAX gradient in any window so far is non-zero and under
# GRAD_FLOOR of its leaf's largest is exempt from TOL_ADAM_PARAM and held
# to 2·lr per window; at most MAX_EXEMPT of all entries may be. (A gradient
# that is exactly 0 in JAX, W's rows of chars a window lacks, must stay
# exactly 0 in the port: those entries are not exempt.)
TOL_LOSS = 1e-6
GRAD_FLOOR = 1e-5
TOL_ADAM_PARAM = 1e-6
MAX_EXEMPT = 0.02


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_model(kind, *, length=WIN, layers=None, input_shape=(T, V)):
    net = JaxNet(seed=1, updater=JaxAdam(LR), backprop_type="tbptt",
                 tbptt_length=length)
    layers = layers or [getattr(JL, kind)(units=HID),
                        getattr(JL, kind)(units=HID),
                        JL.RnnOutputLayer(units=V, activation="softmax",
                                          loss="mcxent")]
    return JaxModel(JaxSeqConfig(net=net, layers=layers,
                                 input_shape=input_shape))


def _port(jm):
    return SequentialModel(SequentialConfig.from_json(jm.config.to_json()),
                           device="cpu")


def _variables(jm):
    v = jax.tree_util.tree_map(np.array, jm.init(seed=2))
    r = np.random.default_rng(3)
    for p in v["params"].values():
        for k in ("pI", "pF", "pO"):
            if k in p:
                p[k] = (0.1 * r.standard_normal(p[k].shape)).astype(
                    np.float32)
    return v


def _batch(seed, t=T, mask=False, weights=False):
    r = np.random.default_rng(seed)
    ids = r.integers(0, V, (N, t + 1))
    eye = np.eye(V, dtype=np.float32)
    b = {"features": eye[ids[:, :-1]], "labels": eye[ids[:, 1:]]}
    if mask:
        lengths = r.integers(WIN + 1, t + 1, N)
        b["mask"] = (np.arange(t)[None] < lengths[:, None]).astype(
            np.float32)
    if weights:
        b["weights"] = r.uniform(0.5, 1.5, (N, t)).astype(np.float32)
    return b


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


def _windows(batch, length=WIN, t=T):
    """The batch cut as the Trainers cut it, window by window."""
    bounds = list(range(0, t, length)) + [t]
    return [{k: v[:, lo:hi] for k, v in batch.items()}
            for lo, hi in zip(bounds, bounds[1:])]


def _jax_reference(jm, v, batch, length=WIN):
    """The JAX Trainer's ``_fit_tbptt_batch``: (per-window losses, params
    after the batch), and each window's gradient from a host loop of
    ``train_step_tbptt`` (for the exemption of near-zero gradients)."""
    trainer = JaxTrainer(jm)
    ts0 = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, v))
    grads = []
    ts = ts0
    carries = trainer._zero_carries(ts, batch["features"][:, :length])
    for wb in _windows(batch, length):
        rng = jax.random.fold_in(ts.rng, ts.step)
        g = jax.grad(lambda p, c=carries, wb=wb, rng=rng: jm.loss_fn_tbptt(
            p, ts.model_state, wb, c, rng=rng)[0])(ts.params)
        grads.append(_np(jax.tree_util.tree_map(np.array, g)))
        ts, carries, _ = trainer.train_step_tbptt(ts, wb, carries)
    loop_params = _np(jax.tree_util.tree_map(np.array, ts.params))
    ts, wmetrics = trainer._fit_tbptt_batch(
        trainer.init_state(jax.tree_util.tree_map(jnp.asarray, v)), batch)
    losses = [float(m["total_loss"]) for m in wmetrics]
    params = _np(jax.tree_util.tree_map(np.array, ts.params))
    for n, a in loop_params.items():
        np.testing.assert_allclose(a, params[n], rtol=0, atol=1e-6)
    return losses, params, grads


def _check_params(got, want, grads):
    exempt, n_exempt, n_all = {}, 0, 0
    for n, w in want.items():
        for g in grads:
            low = (np.abs(g[n]) < GRAD_FLOOR * np.abs(g[n]).max()) & (
                g[n] != 0)
            exempt[n] = exempt.get(n, False) | low
        err = np.abs(got[n] - w)
        assert err[~exempt[n]].max(initial=0) <= TOL_ADAM_PARAM, n
        assert err.max() <= 2 * len(grads) * LR, n
        n_exempt += int(exempt[n].sum())
        n_all += w.size
    assert n_exempt <= MAX_EXEMPT * n_all, (n_exempt, n_all)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("kind", KINDS)
def test_fit_tbptt_batch_matches_jax(kind, masked):
    """Per-window losses and the params after the batch equal the JAX
    Trainer's: two windows of 5 and a tail of 3, three updates."""
    jm = _jax_model(kind)
    v = _variables(jm)
    batch = _batch(4, mask=masked, weights=masked)
    jlosses, jparams, jgrads = _jax_reference(jm, v, batch)
    trainer = Trainer(_port(jm))
    ts, wmetrics = trainer._fit_tbptt_batch(trainer.init_state(v), batch)
    assert ts.step == 3 and len(wmetrics) == 3
    assert [m["batch_size"] for m in wmetrics] == [N] * 3
    losses = [float(m["total_loss"]) for m in wmetrics]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL_LOSS)
    got = _np(ts.params)
    assert got.keys() == jparams.keys()
    _check_params(got, jparams, jgrads)


@pytest.mark.parametrize("length", [T, T + 4], ids=["equal", "longer"])
def test_one_window_spanning_the_sequence_is_the_standard_step(length):
    """tbptt_length >= T: one window from zero carries, bit for bit the
    standard step."""
    jm = _jax_model("GravesLSTM", length=length)
    v = _variables(jm)
    batch = _batch(5)
    tb = Trainer(_port(jm))
    ts_tb, wmetrics = tb._fit_tbptt_batch(tb.init_state(v), batch)
    std_model = _port(jm)
    std_model.net = dataclasses.replace(std_model.net,
                                        backprop_type="standard")
    std = Trainer(std_model)
    ts_std, metrics = std.train_step(std.init_state(v), batch)
    assert len(wmetrics) == 1 and ts_tb.step == ts_std.step == 1
    assert float(wmetrics[0]["total_loss"]) == float(metrics["total_loss"])
    for a, b in zip(tree_leaves(ts_tb.params), tree_leaves(ts_std.params)):
        assert torch.equal(a, b)


def test_window_gradient_stops_at_the_window_start(monkeypatch):
    """Window 2's update takes the gradient of a fresh ``loss_fn_tbptt``
    from window 1's carries, detached; the carries handed on hold no
    graph. Without the truncation the gradient would differ."""
    jm = _jax_model("LSTM")
    v = _variables(jm)
    trainer = Trainer(_port(jm))
    model = trainer.model
    batch = batch_to_device(_batch(6), "cpu")
    w1, w2 = _windows(batch)[:2]
    seen = []
    finish = trainer._finish_step
    monkeypatch.setattr(trainer, "_finish_step",
                        lambda ts, grads, *a: (seen.append(grads),
                                               finish(ts, grads, *a))[1])
    ts1, carries, _ = trainer.train_step_tbptt(
        trainer.init_state(v), w1, trainer._zero_carries(
            trainer.init_state(v), w1["features"]))
    assert all(c.grad_fn is None and not c.requires_grad
               for c in tree_leaves(carries))
    trainer.train_step_tbptt(ts1, w2, carries)

    def grads_from(c):
        leaves = {k: {n: p.detach().clone().requires_grad_()
                      for n, p in lp.items()} for k, lp in ts1.params.items()}
        loss = model.loss_fn_tbptt(leaves, {}, w2, c)[0]
        return dict(zip([n for n, _ in flatten_with_names(leaves)],
                        torch.autograd.grad(loss, tree_leaves(leaves))))

    fresh = grads_from(carries)
    used = dict(flatten_with_names(seen[1]))
    for n, g in fresh.items():
        assert torch.equal(used[n], g), n
    # the untruncated gradient: window 1 run again with the graph kept
    leaves1 = {k: {n: p.detach().clone().requires_grad_()
                   for n, p in lp.items()} for k, lp in ts1.params.items()}
    _, (_, _, live) = model.loss_fn_tbptt(
        leaves1, {}, w1, trainer._zero_carries(ts1, w1["features"]))
    assert all(c.requires_grad for c in tree_leaves(live))
    untruncated = grads_from(live)
    assert any(not torch.equal(untruncated[n], g) for n, g in fresh.items())


def test_mask_and_weights_split_per_window(monkeypatch):
    """Features, labels, mask [N,T] and weights [N,T] are cut at the
    window bounds; per-example weights [N] pass whole."""
    jm = _jax_model("GRU")
    model = _port(jm)
    trainer = Trainer(model)
    seen = []
    out_loss = model._output_loss
    monkeypatch.setattr(model, "_output_loss", lambda p, s, x, b, g: (
        seen.append({k: tuple(v.shape) for k, v in b.items()}),
        out_loss(p, s, x, b, g))[1])
    batch = _batch(7, mask=True, weights=True)
    trainer._fit_tbptt_batch(trainer.init_state(_variables(jm)), batch)
    assert seen == [{"features": (N, t, V), "labels": (N, t, V),
                     "mask": (N, t), "weights": (N, t)} for t in (5, 5, 3)]
    seen.clear()
    batch["weights"] = batch["weights"][:, 0]
    trainer._fit_tbptt_batch(trainer.init_state(_variables(jm)), batch)
    assert [s["weights"] for s in seen] == [(N,)] * 3


def test_fit_fires_each_listener_once_per_window():
    """Two batches of three windows: six iterations, steps 1..6, each with
    its window's metrics and the state after its batch."""
    jm = _jax_model("SimpleRnn")
    v = _variables(jm)
    trainer = Trainer(_port(jm))

    class Record(TrainingListener):
        def __init__(self):
            self.seen = []

        def on_iteration(self, epoch, step, ts, metrics):
            self.seen.append((step, ts.step, float(metrics["total_loss"])))
            return False

    rec = Record()
    batches = [_batch(8), _batch(9)]
    ts = trainer.fit(trainer.init_state(v), batches, listeners=[rec])
    assert ts.step == 6
    # the listener sees the state after the batch, as in the JAX package
    assert [(s, k) for s, k, _ in rec.seen] == [
        (1, 3), (2, 3), (3, 3), (4, 6), (5, 6), (6, 6)]
    ts2, w1 = trainer._fit_tbptt_batch(trainer.init_state(v), batches[0])
    _, w2 = trainer._fit_tbptt_batch(ts2, batches[1])
    assert [x for _, _, x in rec.seen] == [float(m["total_loss"])
                                           for m in w1 + w2]


REFUSED_LAYERS = {
    "bidirectional": lambda ly, at: ly.Bidirectional(layer=ly.LSTM(units=4)),
    "self_attention": lambda ly, at: at.SelfAttention(),
    "learned_self_attention": lambda ly, at: at.LearnedSelfAttention(),
    "cross_attention": lambda ly, at: at.CrossAttention(),
    "recurrent_attention": lambda ly, at: at.RecurrentAttention(),
    "transformer_encoder_block": lambda ly, at: at.TransformerEncoderBlock(),
    "positional_embedding": lambda ly, at: at.PositionalEmbedding(),
    "last_time_step": lambda ly, at: ly.LastTimeStep(),
    "global_pooling": lambda ly, at: ly.GlobalPooling(),
    "return_sequences_false": lambda ly, at: ly.GRU(units=4,
                                                    return_sequences=False),
}


@pytest.mark.parametrize("case", sorted(REFUSED_LAYERS))
def test_tbptt_refuses_what_jax_refuses_with_its_message(case):
    from deeplearning4j_tpu_torch.nn.layers import attention

    make = REFUSED_LAYERS[case]
    with pytest.raises(ValueError) as err:
        SequentialModel._check_tbptt_compatible(make(L, attention))
    with pytest.raises(ValueError) as jerr:
        JaxModel._check_tbptt_compatible(make(JL, jax_attention))
    assert str(err.value) == str(jerr.value)
    assert "truncated BPTT" in str(err.value)


def test_trainer_refusals_match_jax():
    """Through the Trainers: a time-collapsing stack, full-sequence
    labels, rank-2 features (int ids), tbptt_length 0, a model without
    TBPTT (GraphModel), an unknown backprop_type and grad_accum > 1."""
    def both(jm, batch, **kw):
        port = Trainer(_port(jm), **kw)
        with pytest.raises(ValueError) as err:
            port._fit_tbptt_batch(port.init_state(), batch)
        jt = JaxTrainer(jm, **kw)
        with pytest.raises(ValueError) as jerr:
            jt._fit_tbptt_batch(jt.init_state(), batch)
        assert str(err.value) == str(jerr.value)
        return str(err.value)

    collapsing = _jax_model("LSTM", layers=[
        JL.LSTM(units=6), JL.LastTimeStep(),
        JL.OutputLayer(units=V, activation="softmax", loss="mcxent")])
    assert "LastTimeStep" in both(collapsing, _batch(10))
    full_labels = dict(_batch(10), labels=np.eye(T, dtype=np.float32)[:N])
    assert "per-timestep labels" in both(_jax_model("LSTM"), full_labels)
    ids = _jax_model("GRU", input_shape=(T,), layers=[
        JL.Embedding(vocab_size=V, units=8), JL.GRU(units=HID),
        JL.RnnOutputLayer(units=V, activation="softmax", loss="mcxent")])
    ids_batch = {"features": np.zeros((N, T), np.int32),
                 "labels": _batch(10)["labels"]}
    assert "sequence features" in both(ids, ids_batch)
    assert "tbptt_length>0" in both(_jax_model("LSTM", length=0), _batch(10))

    from deeplearning4j_tpu_torch.nn.config import (
        GraphConfig,
        GraphVertex,
        NeuralNetConfiguration,
    )

    graph = GraphModel(GraphConfig(
        net=NeuralNetConfiguration(seed=0, backprop_type="tbptt",
                                   tbptt_length=4),
        inputs=["in"], input_shapes={"in": (T, V)},
        vertices={"out": GraphVertex(kind="layer", inputs=["in"],
                                     layer=L.RnnOutputLayer(units=V))},
        outputs=["out"]), device="cpu")
    with pytest.raises(ValueError, match="requires a model with TBPTT "
                                         "support"):
        Trainer(graph)._fit_tbptt_batch(None, _batch(10))
    bad = _port(_jax_model("LSTM"))
    bad.net = dataclasses.replace(bad.net, backprop_type="TBPTT")
    with pytest.raises(ValueError, match="unknown backprop_type 'TBPTT'"):
        Trainer(bad)
    with pytest.raises(ValueError, match="grad_accum is not supported"):
        Trainer(_port(_jax_model("LSTM")), grad_accum=2)


def test_zero_carries_follow_the_window_dtype():
    """Zero carries per recurrent layer, float32, and bf16 under mixed
    precision (the dtype the JAX package's bf16 window returns)."""
    for mixed in (False, True):
        jm = _jax_model("GravesLSTM")
        model = _port(jm)
        model.net = dataclasses.replace(model.net, mixed_precision=mixed)
        trainer = Trainer(model)
        ts = trainer.init_state(_variables(jm))
        carries = trainer._zero_carries(ts, torch.zeros((N, WIN, V)))
        assert sorted(carries) == model.layer_names[:2]
        want = torch.bfloat16 if mixed else torch.float32
        for c in tree_leaves(carries):
            assert c.shape == (N, HID) and c.dtype == want and not c.any()


@pytest.mark.parametrize("kind", ["GravesLSTM", "GRU"])
def test_mixed_precision_windows_train(kind):
    """bf16 windows from bf16 carries: finite losses, float32 master
    params that move, the carries of each window in bf16."""
    jm = _jax_model(kind)
    model = _port(jm)
    model.net = dataclasses.replace(model.net, mixed_precision=True)
    trainer = Trainer(model)
    ts0 = trainer.init_state(_variables(jm))
    ts, wmetrics = trainer._fit_tbptt_batch(ts0, _batch(11))
    assert len(wmetrics) == 3
    assert all(np.isfinite(float(m["total_loss"])) for m in wmetrics)
    assert all(p.dtype == torch.float32 for p in tree_leaves(ts.params))
    assert not torch.equal(ts.params[model.layer_names[0]]["W"],
                           ts0.params[model.layer_names[0]]["W"])


# -- weight constraints --------------------------------------------------------

CONSTRAINTS = {
    "max_norm": lambda c: c.MaxNorm(max_norm=1.5),
    "max_norm_axis0_keys": lambda c: c.MaxNorm(max_norm=0.7, axis=0,
                                               keys=("W",)),
    "min_max_norm": lambda c: c.MinMaxNorm(min_norm=0.5, max_norm=1.0),
    "min_max_norm_rate": lambda c: c.MinMaxNorm(min_norm=0.0, max_norm=2.0,
                                                rate=0.5),
    "unit_norm": lambda c: c.UnitNorm(),
    "unit_norm_with_bias": lambda c: c.UnitNorm(apply_to_bias=True),
    "non_negative": lambda c: c.NonNegative(),
}


@pytest.mark.parametrize("case", sorted(CONSTRAINTS))
def test_constraint_projection_matches_jax(case):
    """``constrain_params`` over a Dense, a GravesLSTM and a conv kernel's
    params, against the JAX package's (biases and peepholes left alone
    unless ``apply_to_bias``; ``keys`` limits it to those names)."""
    r = np.random.default_rng(12)
    params = {
        "0_dense": {"W": 3 * r.standard_normal((16, 8)),
                    "b": 3 * r.standard_normal(8)},
        "1_lstm": {"W": r.standard_normal((8, 12)),
                   "RW": r.standard_normal((3, 12)),
                   "b": r.standard_normal(12), "pI": r.standard_normal(3)},
        "2_conv": {"W": r.standard_normal((3, 3, 2, 4))},
        "3_free": {"W": r.standard_normal((4, 4))},
    }
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)

    def named(pkg):
        cons = CONSTRAINTS[case](pkg)
        return [(n, JL.Dense(units=1, constraints=[cons])
                 if pkg is jax_constraints
                 else L.Dense(units=1, constraints=[cons]))
                for n in ("0_dense", "1_lstm", "2_conv")] + [
            ("3_free", JL.Dense(units=1) if pkg is jax_constraints
             else L.Dense(units=1))]

    want = _np(jax.tree_util.tree_map(np.array, jax_constraints
                                      .constrain_params(named(jax_constraints),
                                                        params)))
    got = _np(constraints.constrain_params(named(constraints),
                                           variables_from_numpy(params)))
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-6, atol=1e-6,
                                   err_msg=n)


def test_constrained_trainer_step_matches_jax():
    """A JAX config with MaxNorm on a recurrent layer and NonNegative on
    the head loads from JSON; two Adam steps (TBPTT windows) match the
    JAX Trainer's and leave every constrained norm in bounds."""
    layers = [JL.GravesLSTM(units=HID, constraints=[
                  jax_constraints.MaxNorm(max_norm=0.5)]),
              JL.RnnOutputLayer(units=V, activation="softmax",
                                loss="mcxent",
                                constraints=jax_constraints.NonNegative())]
    jm = _jax_model("GravesLSTM", layers=layers, length=7)
    model = _port(jm)
    assert isinstance(model.layers[0].constraints[0], constraints.MaxNorm)
    v = _variables(jm)
    batch = _batch(13)
    jlosses, jparams, jgrads = _jax_reference(jm, v, batch, length=7)
    trainer = Trainer(model)
    ts, w = trainer._fit_tbptt_batch(trainer.init_state(v), batch)
    np.testing.assert_allclose([float(m["total_loss"]) for m in w],
                               jlosses, rtol=TOL_LOSS)
    _check_params(_np(ts.params), jparams, jgrads)
    rnn = ts.params[model.layer_names[0]]
    for k in ("W", "RW"):
        norms = torch.sqrt(torch.sum(rnn[k] ** 2, dim=0))
        assert float(norms.max()) <= 0.5 + 1e-6, k
    assert float(ts.params[model.layer_names[1]]["W"].min()) >= 0.0
