"""The char-level GRU (Embedding → GRU → softmax) in the port against the JAX package, on the CPU.

The TensorFlow text-generation tutorial's model as this repository writes
it (``Embedding`` → ``GRU(backend="pallas")`` → softmax ``RnnOutputLayer``
with ``mcxent``), cut to E=32, H=128, T=8, N=8 at its vocabulary of 66,
built in both packages from the same numpy variables (the JAX package's
init) and fed the same batches: the config's JSON, the loss and every
gradient, two Adam steps of the Trainer, checkpoints across, and the model
served by the port's ``ModelServer``. The JAX package runs its Pallas GRU
kernels in interpret mode (``DL4J_TPU_FORCE_PALLAS=1``), the port the
plain versions of its CUDA kernels.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import gru_scan as jax_gru_scan
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.nn.model import SequentialModel as JaxModel
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.kernels import gru_scan
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.nn.model import SequentialModel
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

V, E, HID, T, N = 66, 32, 128, 8, 8
LR = 1e-3
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


def _config(pkg, backend="pallas"):
    """The char-GRU's SequentialConfig from either package's classes;
    ``backend=None`` leaves the GRU at its package's default."""
    cfg, ly, upd = ((jax_config, jax_layers, JaxAdam) if pkg == "jax"
                    else (nnconfig, layers, Adam))
    named = {} if backend is None else {"backend": backend}
    return cfg.SequentialConfig(
        net=cfg.NeuralNetConfiguration(seed=0, updater=upd(LR),
                                       weight_init="xavier"),
        layers=[ly.Embedding(vocab_size=V, units=E),
                ly.GRU(units=HID, **named),
                ly.RnnOutputLayer(units=V, activation="softmax",
                                  loss="mcxent")],
        input_shape=(T,))


def _port_model(backend="pallas"):
    return SequentialModel(_config("port", backend), device="cpu")


def _batch(seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, V, (N, T + 1)).astype(np.int32)
    return {"features": ids[:, :-1],
            "labels": np.eye(V, dtype=np.float32)[ids[:, 1:]]}


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel(_config("jax"))


@pytest.fixture(scope="module")
def variables(jax_model):
    """The JAX package's init as numpy, with a non-zero GRU bias."""
    v = jax.tree_util.tree_map(np.array, jax_model.init(seed=3))
    v["params"]["1_gru"]["b"] = (0.1 * np.random.default_rng(4)
                                 .standard_normal(3 * HID)).astype(np.float32)
    return v


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


def test_config_json_and_layer_names_cross_both_ways(jax_model):
    model = _port_model()
    assert model.layer_names == jax_model.layer_names == [
        "0_embedding", "1_gru", "2_rnnoutputlayer"]
    back = nnconfig.SequentialConfig.from_json(jax_model.config.to_json())
    assert nnconfig.config_to_dict(back) == nnconfig.config_to_dict(
        model.config)
    jcfg = jax_config.SequentialConfig.from_json(model.config.to_json())
    assert jax_config.config_to_dict(jcfg) == jax_config.config_to_dict(
        jax_model.config)
    assert model.shapes == [(T,), (T, E), (T, HID), (T, V)]


def test_init_has_the_jax_names_shapes_and_dtypes(jax_model):
    want = {n: (a.shape, str(a.dtype))
            for n, a in flatten_with_names(jax_model.init(seed=0))}
    model = _port_model()
    v = model.init(seed=0)
    got = {n: (tuple(a.shape), str(a.dtype)[6:])
           for n, a in flatten_with_names(v)}
    assert got == want
    assert model.num_params(v) == sum(int(np.prod(s))
                                      for s, _ in want.values())
    # Embedding's own default is normal(0.01); the net's xavier applies
    # to a layer that names none, in both packages
    assert model.layers[0].weight_init is None
    assert float(v["params"]["0_embedding"]["W"].std()) > 0.05


def test_loss_and_every_gradient_match_jax(jax_model, variables,
                                           monkeypatch):
    jax_fell_back = []
    orig = jax_gru_scan.opsrnn.gru
    monkeypatch.setattr(jax_gru_scan.opsrnn, "gru", lambda *a, **k: (
        jax_fell_back.append(1), orig(*a, **k))[1])
    batch = _batch(5)
    (jloss, (_, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.loss_fn(p, {}, b), has_aux=True))(
        variables["params"], batch)
    assert not jax_fell_back, "the JAX reference left its kernel path"
    trainer = Trainer(_port_model())
    calls = []
    orig_bwd = gru_scan.reference_gru_bwd
    monkeypatch.setattr(gru_scan, "reference_gru_bwd",
                        lambda *a: (calls.append(1), orig_bwd(*a))[1])
    loss, _, metrics, grads = trainer._grad_of(
        batch_to_device(variables["params"], "cpu"), {},
        batch_to_device(batch, "cpu"), None)
    assert len(calls) == 1  # the GRU layer's backward sweep
    assert float(loss) == pytest.approx(float(jloss), rel=TOL_LOSS)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=TOL_LOSS)
    got, want = _np(grads), _np(jgrads)
    assert got.keys() == want.keys() == {
        "0_embedding/W", "1_gru/W", "1_gru/RW", "1_gru/b",
        "2_rnnoutputlayer/W", "2_rnnoutputlayer/b"}
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
# gradient is ~0 but not exactly 0 moves by up to ±lr on a difference in
# g at rounding level. Entries whose JAX gradient, in any step so far, is
# under GRAD_FLOOR of its leaf's largest are exempt from TOL_ADAM_PARAM
# and held to 2·lr per step; at most MAX_EXEMPT of all entries may be.
# (Embedding rows of characters absent from a batch have a gradient of
# exactly 0 in both packages and do not move.)
GRAD_FLOOR = 1e-5
TOL_ADAM_PARAM = 1e-6
MAX_EXEMPT = 0.02


def test_two_adam_steps_match_the_jax_trainer(variables, jax_two_steps):
    """Losses to 1e-5; the params after each step to TOL_ADAM_PARAM."""
    _, states, jlosses, jgrads = jax_two_steps
    trainer = Trainer(_port_model())
    ts = trainer.init_state(variables)
    losses, exempt = [], {}
    for k, b in enumerate((_batch(6), _batch(7))):
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        got, want = _np(ts.params), _np(states[k].params)
        assert got.keys() == want.keys() == jgrads[k].keys()
        n_exempt = n_all = 0
        for n, w in want.items():
            g = np.abs(jgrads[k][n])
            low = (g < GRAD_FLOOR * g.max()) & (g > 0)
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
    # JAX → port: bit-equal restore, the next step's loss, and the
    # inference variables a server loads
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
        "Embedding", "GRU", "RnnOutputLayer"]
    assert cfg.layers[1].backend == "pallas" and cfg.net.updater.lr == LR
    _, jm = jtrainer.train_step(restored, _batch(7))
    assert float(jm["total_loss"]) == pytest.approx(jlosses[1], rel=1e-5)


def test_output_backends_and_score_match_jax(jax_model, variables):
    """``output`` through the sweeps (``backend="pallas"`` and ``"xla"``)
    and through the plain loop (``backend="plain"``) against the JAX
    package's; ``score`` is the loss."""
    batch = _batch(8)
    want = np.asarray(jax_model.output(variables, batch["features"]))
    feats = torch.from_numpy(batch["features"])
    # the JAX package's numpy variables, by their checkpoint names
    params = ckpt.variables_from_numpy(variables)
    assert {n for n, _ in flatten_with_names(params["params"])} == {
        "0_embedding/W", "1_gru/W", "1_gru/RW", "1_gru/b",
        "2_rnnoutputlayer/W", "2_rnnoutputlayer/b"}
    for backend in ("pallas", "xla", "plain"):
        model = _port_model(backend)
        got = model.output(params, feats)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=backend)
        acts, _ = model.feed_forward(params, feats)
        assert [tuple(a.shape) for a in acts] == [
            (N, T), (N, T, E), (N, T, HID), (N, T, V)]
    assert _port_model().score(params, batch) == pytest.approx(
        float(jax_model.score(variables, batch)), rel=TOL_LOSS)


def _next_char_probs(model, variables, ids):
    """The served function: int char ids [rows, T] → the last step's
    next-char probabilities [rows, V]."""
    return model.output(variables, ids)[:, -1, :]


def test_served_char_gru_answers_like_output(variables):
    """Served by ModelServer → ModelRegistry → ParallelInference (batched,
    buckets up to 4 rows) to concurrent clients, against ``output``."""
    model = _port_model()
    params = batch_to_device(variables, "cpu")
    reg = ModelRegistry()
    reg.register("char_gru", functools.partial(_next_char_probs, model),
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
                lambda r: client.predict("char_gru", r.tolist()), reqs))
    finally:
        srv.stop()
    for req, resp in zip(reqs, resps):
        got = np.asarray(resp["outputs"], np.float32)
        want = model.output(params, torch.from_numpy(req))
        assert got.shape == (req.shape[0], V)
        np.testing.assert_allclose(got, want[:, -1].numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_unknown_gru_backend_is_refused(variables):
    model = _port_model("cudnn")
    with pytest.raises(ValueError, match="GRU backend"):
        model.output(batch_to_device(variables, "cpu"),
                     torch.zeros((1, T), dtype=torch.int32))


def test_embedding_default_init_is_normal_001():
    """An Embedding that names no init and sits in a net without one draws
    from normal(0.01), the JAX package's default for the layer."""
    layer = layers.Embedding(vocab_size=500, units=64)
    params, _ = layer.init(torch.Generator().manual_seed(0), (T,),
                           torch.float32)
    w = params["W"]
    assert tuple(w.shape) == (500, 64) and w.dtype == torch.float32
    assert abs(float(w.std()) - 0.01) < 5e-4 and abs(float(w.mean())) < 5e-4
    ids = torch.tensor([[0, 499, 7]])
    out, _ = layer.apply(params, {}, ids)
    assert torch.equal(out[0], w[[0, 499, 7]])
    with pytest.raises(IndexError):
        layer.apply(params, {}, torch.tensor([[500]]))
