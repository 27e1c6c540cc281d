"""The GravesLSTM char-RNN in the port against the JAX package, on the CPU.

``text_generation_lstm(vocab_size=11, hidden=128, seq_len=8,
backend="pallas")`` from the same numpy variables (the JAX package's init,
peepholes made non-zero) and the same batches in both packages: the
config's JSON, the loss and every gradient, two Adam steps of the
Trainer, checkpoints across, and the model served by the port's
``ModelServer``. The JAX package runs its Pallas LSTM kernels in interpret
mode (``DL4J_TPU_FORCE_PALLAS=1``), the port the plain versions of its
CUDA kernels.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo.classic import (
    text_generation_lstm as jax_char_rnn,
)
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.kernels import lstm_scan
from deeplearning4j_tpu_torch.models.zoo.classic import (
    next_char_probs,
    text_generation_lstm,
)
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn.model import SequentialModel
from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect
from deeplearning4j_tpu_torch.ops import rnn as opsrnn
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.serving import (
    ModelRegistry,
    ModelServer,
    ServingClient,
    spec,
)
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

V, HID, T, N = 11, 128, 8, 8
LR = 1e-3
KW = dict(vocab_size=V, hidden=HID, seq_len=T, backend="pallas")
# float32 on both sides; sums in another order. Loss to 1e-6 relative;
# each gradient leaf to 1e-4 of its max |gradient|, that max floored at
# 1e-4 of the model's largest gradient (a leaf whose gradient is ~0).
TOL_LOSS = 1e-6
TOL_GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _env():
    """Two torch threads (the suite runs beside others), and the JAX
    package on its Pallas kernels (interpret mode) for this module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DL4J_TPU_FORCE_PALLAS", "1")
        yield
    torch.set_num_threads(before)


def _batch(seed, masked=False):
    r = np.random.default_rng(seed)
    ids = r.integers(0, V, (N, T + 1))
    eye = np.eye(V, dtype=np.float32)
    batch = {"features": eye[ids[:, :-1]], "labels": eye[ids[:, 1:]]}
    if masked:
        lengths = r.integers(1, T + 1, N)
        batch["mask"] = (np.arange(T)[None, :] < lengths[:, None]).astype(
            np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_model():
    return jax_char_rnn(**KW, updater=JaxAdam(LR))


@pytest.fixture(scope="module")
def variables(jax_model):
    """The JAX package's init as numpy, with non-zero peepholes."""
    v = jax.tree_util.tree_map(np.array, jax_model.init(seed=3))
    r = np.random.default_rng(4)
    for layer in ("0_graveslstm", "1_graveslstm"):
        for k in ("pI", "pF", "pO"):
            v["params"][layer][k] = (0.1 * r.standard_normal(HID)).astype(
                np.float32)
    return v


def _port_model(**kw):
    return text_generation_lstm(device="cpu", **KW, updater=Adam(LR), **kw)


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


def test_config_json_and_layer_names_cross_both_ways(jax_model):
    model = _port_model()
    assert model.layer_names == jax_model.layer_names == [
        "0_graveslstm", "1_graveslstm", "2_rnnoutputlayer"]
    jcfg = jax_config.SequentialConfig.from_json(model.config.to_json())
    assert jax_config.config_to_dict(jcfg) == jax_config.config_to_dict(
        jax_model.config)
    back = nnconfig.SequentialConfig.from_json(jax_model.config.to_json())
    assert nnconfig.config_to_dict(back) == nnconfig.config_to_dict(
        model.config)


def test_jax_config_with_tbptt_or_constraints_is_refused(jax_model):
    """What the JAX Trainer refuses of a config with TBPTT, the port's
    refuses with the same words: an unknown backprop_type, and
    grad_accum > 1 under TBPTT."""
    for net, kw, match in (
            (dict(backprop_type="TBPTT"), {}, "unknown backprop_type"),
            (dict(backprop_type="tbptt", tbptt_length=4),
             dict(grad_accum=2), "grad_accum is not supported")):
        cfg = dataclasses.replace(jax_model.config, net=dataclasses.replace(
            jax_model.config.net, **net))
        model = SequentialModel(
            nnconfig.SequentialConfig.from_json(cfg.to_json()), device="cpu")
        with pytest.raises(ValueError, match=match) as err:
            Trainer(model, **kw)
        with pytest.raises(ValueError) as jerr:
            JaxTrainer(type(jax_model)(cfg), **kw)
        assert str(err.value) == str(jerr.value)


def _jax_windows(jmodel, variables, batch, length):
    """The JAX Trainer's TBPTT batch, window by window: (losses, params
    after the batch, each window's gradient)."""
    trainer = JaxTrainer(jmodel)
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
    carries = trainer._zero_carries(ts, batch["features"][:, :length])
    losses, grads = [], []
    for lo in range(0, T, length):
        wb = {k: v[:, lo:lo + length] for k, v in batch.items()}
        rng = jax.random.fold_in(ts.rng, ts.step)
        grads.append(_np(jax.tree_util.tree_map(np.array, jax.grad(
            lambda p: jmodel.loss_fn_tbptt(p, {}, wb, carries,
                                           rng=rng)[0])(ts.params))))
        ts, carries, m = trainer.train_step_tbptt(ts, wb, carries)
        losses.append(float(m["total_loss"]))
    return losses, _np(jax.tree_util.tree_map(np.array, ts.params)), grads


@pytest.mark.parametrize("setting", ["tbptt", "max_norm"])
def test_jax_config_with_tbptt_or_constraints_trains_like_jax(
        jax_model, variables, setting):
    """A JAX char-RNN config with backprop_type "tbptt" (a window of 5 over
    T = 8 and a tail of 3), or with MaxNorm on its second layer,
    loads from JSON and trains like the JAX Trainer: the losses to
    TOL_LOSS, the params to TOL_ADAM_PARAM (GRAD_FLOOR exemption)."""
    from deeplearning4j_tpu.nn.constraints import MaxNorm

    from deeplearning4j_tpu_torch.nn.constraints import (
        MaxNorm as PortMaxNorm,
    )

    cfg = jax_model.config
    if setting == "tbptt":
        cfg = dataclasses.replace(cfg, net=dataclasses.replace(
            cfg.net, backprop_type="tbptt", tbptt_length=5))
    else:
        layers = list(cfg.layers)
        layers[1] = dataclasses.replace(layers[1],
                                        constraints=[MaxNorm(0.3)])
        cfg = dataclasses.replace(cfg, layers=layers)
    jmodel = type(jax_model)(cfg)
    model = SequentialModel(nnconfig.SequentialConfig.from_json(
        cfg.to_json()), device="cpu")
    trainer = Trainer(model)
    batch = _batch(10)
    if setting == "tbptt":
        assert model.net.backprop_type == "tbptt"
        jlosses, jparams, jgrads = _jax_windows(jmodel, variables, batch, 5)
        ts, wm = trainer._fit_tbptt_batch(trainer.init_state(variables),
                                          batch)
        losses = [float(m["total_loss"]) for m in wm]
    else:
        assert isinstance(model.layers[1].constraints[0], PortMaxNorm)
        jt = JaxTrainer(jmodel)
        jts = jt.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
        jgrads = [_np(jax.tree_util.tree_map(np.array, jax.grad(
            lambda p: jmodel.loss_fn(p, {}, batch)[0])(jts.params)))]
        jts, jm = jt.train_step(jts, batch)
        jlosses = [float(jm["total_loss"])]
        jparams = _np(jax.tree_util.tree_map(np.array, jts.params))
        ts, m = trainer.train_step(trainer.init_state(variables), batch)
        losses = [float(m["total_loss"])]
        rw = ts.params["1_graveslstm"]["RW"]
        assert float(torch.sqrt((rw ** 2).sum(0)).max()) <= 0.3 + 1e-6
    np.testing.assert_allclose(losses, jlosses, rtol=TOL_LOSS)
    got = _np(ts.params)
    n_exempt = n_all = 0
    for n, w in jparams.items():
        exempt = np.zeros(w.shape, bool)
        for g in jgrads:
            exempt |= (np.abs(g[n]) < GRAD_FLOOR * np.abs(g[n]).max()) & (
                g[n] != 0)
        err = np.abs(got[n] - w)
        assert err[~exempt].max(initial=0) <= TOL_ADAM_PARAM, n
        assert err.max() <= 2 * len(jgrads) * LR, n
        n_exempt += int(exempt.sum())
        n_all += w.size
    assert n_exempt <= MAX_EXEMPT * n_all, (n_exempt, n_all)


def test_init_has_the_jax_names_shapes_and_dtypes(jax_model):
    want = {n: (a.shape, str(a.dtype))
            for n, a in flatten_with_names(jax_model.init(seed=0))}
    got = {n: (tuple(a.shape), str(a.dtype)[6:])
           for n, a in flatten_with_names(_port_model().init(seed=0))}
    assert got == want
    assert _port_model().num_params(_port_model().init()) == sum(
        int(np.prod(s)) for s, _ in want.values())


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_loss_and_every_gradient_match_jax(jax_model, variables, masked):
    batch = _batch(5, masked)
    (jloss, (_, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.loss_fn(p, {}, b), has_aux=True))(
        variables["params"], batch)
    trainer = Trainer(_port_model())
    calls = []
    orig = lstm_scan.reference_lstm_bwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lstm_scan, "reference_lstm_bwd",
                   lambda *a: (calls.append(1), orig(*a))[1])
        loss, _, metrics, grads = trainer._grad_of(
            batch_to_device(variables["params"], "cpu"), {},
            batch_to_device(batch, "cpu"), None)
    assert len(calls) == 2  # both layers' backward sweeps
    assert float(loss) == pytest.approx(float(jloss), rel=TOL_LOSS)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=TOL_LOSS)
    got, want = _np(grads), _np(jgrads)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        scale = max(np.abs(w).max(), 1e-4 * top)
        assert np.abs(got[n] - w).max() <= TOL_GRAD * scale, n


@pytest.fixture(scope="module")
def jax_two_steps(jax_model, variables):
    """The JAX package's Trainer, two jitted Adam steps: (states after
    each, losses, the gradient each step took)."""
    trainer = JaxTrainer(jax_model)
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
    grad = jax.jit(jax.grad(lambda p, b: jax_model.loss_fn(p, {}, b)[0]))
    losses, states, grads = [], [], []
    for b in (_batch(6), _batch(7)):
        grads.append(_np(jax.tree_util.tree_map(np.array,
                                                grad(ts.params, b))))
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        # copies: the next step donates this state's buffers
        states.append(jax.tree_util.tree_map(
            lambda x: jax.random.wrap_key_data(np.array(
                jax.random.key_data(x))) if jax.dtypes.issubdtype(
                x.dtype, jax.dtypes.prng_key) else np.array(x), ts))
    return trainer, states, losses, grads


# Adam's first steps move an entry by about lr·sign(g), so an entry whose
# gradient is ~0 moves by up to ±lr on a difference in g at rounding
# level. Entries whose JAX gradient, in any step so far, is under
# GRAD_FLOOR of its leaf's largest (float32 rounding of sums over a few
# hundred terms) are exempt from TOL_ADAM_PARAM and held to 2·lr per step;
# at most MAX_EXEMPT of all entries may be (about 1.2% are at this seed).
# A skipped or sign-flipped update moves the other entries by ~lr.
GRAD_FLOOR = 1e-5
TOL_ADAM_PARAM = 1e-6
MAX_EXEMPT = 0.02


def test_two_adam_steps_match_the_jax_trainer(variables, jax_two_steps):
    """Losses to 1e-5; the params after each step to TOL_ADAM_PARAM."""
    _, states, jlosses, jgrads = jax_two_steps
    trainer = Trainer(_port_model())
    ts = trainer.init_state(variables)
    losses = []
    exempt = {}
    for k, b in enumerate((_batch(6), _batch(7))):
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        got, want = _np(ts.params), _np(states[k].params)
        assert got.keys() == want.keys() == jgrads[k].keys()
        n_exempt = n_all = 0
        for n, w in want.items():
            g = np.abs(jgrads[k][n])
            low = g < GRAD_FLOOR * g.max()
            exempt[n] = exempt.get(n, False) | low
            err = np.abs(got[n] - w)
            assert err[~exempt[n]].max(initial=0) <= TOL_ADAM_PARAM, (k, n)
            assert err.max() <= 2 * (k + 1) * LR, (k, n)
            n_exempt += int(exempt[n].sum())
            n_all += w.size
        assert n_exempt <= MAX_EXEMPT * n_all, (k, n_exempt, n_all)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_checkpoints_cross_both_ways(jax_model, variables, jax_two_steps,
                                     tmp_path):
    jtrainer, states, jlosses, _ = jax_two_steps
    # JAX → port: bit-equal restore, and the next step's loss
    path = jax_ckpt.save_checkpoint(tmp_path / "jax", states[0],
                                    model=jax_model)
    trainer = Trainer(_port_model())
    ts = ckpt.restore_checkpoint(path, trainer.init_state(variables))
    want = _np({"p": states[0].params, "o": states[0].opt_state})
    got = _np({"p": ts.params, "o": ts.opt_state})
    assert ts.step == 1 and got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    _, m = trainer.train_step(ts, _batch(7))
    assert float(m["total_loss"]) == pytest.approx(jlosses[1], rel=1e-5)
    served = ckpt.load_inference_variables(path, trainer.model)
    for n, a in _np(served["params"]).items():
        np.testing.assert_array_equal(a, want[f"p/{n}"], err_msg=n)
    # port → JAX: the same leaves, the config, and it trains on
    out = ckpt.save_checkpoint(tmp_path / "port", ts, model=trainer.model)
    assert jax_ckpt.verify_checkpoint(out, deep=True) == (True, "ok")
    template = jtrainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, variables))
    restored = jax_ckpt.restore_checkpoint(out, template)
    back = _np({"p": restored.params, "o": restored.opt_state})
    for n in got:
        np.testing.assert_array_equal(back[n], got[n], err_msg=n)
    cfg = jax_ckpt.load_model_config(out)
    assert [type(l).__name__ for l in cfg.layers] == [
        "GravesLSTM", "GravesLSTM", "RnnOutputLayer"]
    assert cfg.layers[0].backend == "pallas" and cfg.net.updater.lr == LR
    _, jm = jtrainer.train_step(restored, _batch(7))
    assert float(jm["total_loss"]) == pytest.approx(jlosses[1], rel=1e-5)


def test_output_backends_and_score_match_jax(jax_model, variables):
    """``output`` through the sweeps (``backend="pallas"`` and ``"xla"``)
    and through the plain loop (``backend="plain"``) against the JAX
    package's; ``score`` is the loss."""
    batch = _batch(8)
    want = np.asarray(jax_model.output(variables, batch["features"]))
    feats = torch.from_numpy(batch["features"])
    params = batch_to_device(variables, "cpu")
    for backend in ("pallas", "xla", "plain"):
        model = text_generation_lstm(device="cpu", **{**KW,
                                                      "backend": backend})
        got = model.output(params, feats)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=backend)
        acts, _ = model.feed_forward(params, feats)
        assert [tuple(a.shape) for a in acts] == [
            (N, T, V), (N, T, HID), (N, T, HID), (N, T, V)]
    assert _port_model().score(params, batch) == pytest.approx(
        float(jax_model.score(variables, batch)), rel=TOL_LOSS)


@pytest.mark.parametrize("graves", [True, False], ids=["graves", "lstm"])
def test_jax_default_backend_config_runs_the_sweeps(graves, monkeypatch):
    """A char-RNN config built by the JAX package with its default backend
    ("xla") loads in the port and runs both LSTM layers through
    ``lstm_scan.lstm`` (the kernels on the card), never ``ops/rnn.lstm``;
    its output matches the JAX package's."""
    jmodel = jax_char_rnn(vocab_size=V, hidden=HID, seq_len=T,
                          graves=graves)
    cfg = nnconfig.SequentialConfig.from_json(jmodel.config.to_json())
    assert [l.backend for l in cfg.layers[:2]] == ["xla", "xla"]
    variables = jax.tree_util.tree_map(np.array, jmodel.init(seed=6))
    feats = _batch(9)["features"]
    want = np.asarray(jmodel.output(variables, feats))
    calls = []
    sweep = lstm_scan.lstm

    def spy(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return sweep(x, *args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("ops/rnn.lstm called for an 'xla' layer")

    monkeypatch.setattr(lstm_scan, "lstm", spy)
    monkeypatch.setattr(opsrnn, "lstm", refused)
    got = SequentialModel(cfg, device="cpu").output(
        batch_to_device(variables, "cpu"), torch.from_numpy(feats))
    assert calls == [(N, T, V), (N, T, HID)]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_served_char_rnn_answers_like_output(variables):
    """Next-char probabilities of the last step for int char ids, served
    by ModelServer → ModelRegistry → ParallelInference (batched, buckets
    up to 4 rows) to concurrent clients, against ``model.output``."""
    model = _port_model()
    params = batch_to_device(variables, "cpu")
    reg = ModelRegistry()
    reg.register("char_rnn", functools.partial(next_char_probs, model),
                 params, input_spec=spec((T,), np.int32, high=V),
                 mode="batched", max_batch_size=4, devices=["cpu"])
    srv = ModelServer(reg, port=0)
    srv.start(warm=True)
    try:
        client = ServingClient(srv.url, timeout=60)
        reqs = [np.random.default_rng(20 + i).integers(
            0, V, (1 + i % 3, T)).astype(np.int32) for i in range(12)]
        with ThreadPoolExecutor(4) as pool:
            resps = list(pool.map(
                lambda r: client.predict("char_rnn", r.tolist()), reqs))
    finally:
        srv.stop()
    eye = torch.eye(V)
    for req, resp in zip(reqs, resps):
        got = np.asarray(resp["outputs"], np.float32)
        want = model.output(params, eye[torch.from_numpy(req).long()])
        assert got.shape == (req.shape[0], V)
        np.testing.assert_allclose(got, want[:, -1].numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_weight_noise_applies_only_in_training_and_follows_the_seed(
        variables):
    model = _port_model()
    model.layers[0] = dataclasses.replace(model.layers[0],
                                          weight_noise=DropConnect(p=0.5))
    params = batch_to_device(variables["params"], "cpu")
    batch = batch_to_device(_batch(9), "cpu")

    def loss(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return float(model.loss_fn(params, {}, batch, generator=gen)[0])

    plain = float(_port_model().loss_fn(params, {}, batch)[0])
    assert loss(None) == plain  # no generator: no noise, as without an rng
    assert loss(1) == loss(1) != plain
    assert loss(2) != loss(1)
    tree = {"params": params, "state": {}}
    assert torch.equal(model.output(tree, batch["features"]),
                       _port_model().output(tree, batch["features"]))
