"""The seq2seq cross-attention graph of examples/seq2seq_attention.py in the port against the JAX package, on the CPU.

The example's ``GraphModel`` (Embedding → Bidirectional(LSTM) encoder, a
PositionalEmbedding for the decoder queries, a two-input CrossAttention
vertex, an RnnOutputLayer) at its own widths (vocab 12, T=10, hidden 64,
4 heads of 16) with batches of 8: the config JSON the JAX package writes
loaded by the port and written back equal (and equal to
``chip_smoke.seq2seq_config``, the one the card runs); the JAX package's
variables (nested ``fwd``/``bwd`` trees) carried across by
``variables_from_numpy``; the forward, the loss and every gradient, three
Adam steps of the Trainer, checkpoints both ways, ``evaluate_model`` and
the model served behind ``ModelServer`` with a dict input spec.

Tolerances, float32 on both sides with sums in another order: outputs to
1e-5; the loss to 1e-5 relative; each gradient leaf to 1e-3 of its max
|JAX gradient| (the key biases, whose gradient is 0 in exact arithmetic,
to 1e-6 of the model's largest on both sides); parameters after each Adam
step to 1e-5, entries whose gradient is ~0 held to 2·lr a step as in
tests/test_torch_gpt.py.
"""

import importlib.util
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.evaluation import classification as jax_eval
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu_torch.evaluation import evaluate_model
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn import layers  # noqa: F401 (registers them)
from deeplearning4j_tpu_torch.nn.model import GraphModel
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.serving import (
    ModelRegistry,
    ModelServer,
    ServingClient,
    spec,
)
from deeplearning4j_tpu_torch.serving.errors import BadRequestError
from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the same config, as the card runs it)

VOCAB, T, HIDDEN, N = 12, 10, 64, 8
LR = 3e-3
TOL = 1e-5
TOL_GRAD_FRAC = 1e-3
ZERO_GRAD = 1e-6
TOL_ADAM_PARAM = 1e-5
GRAD_FLOOR = 1e-5
MAX_EXEMPT = 0.02


def _exactly_zero_grad(name):
    # softmax ignores a shift of a whole row of scores
    return name.endswith("xatt/bk")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_model():
    """The example's own ``build`` (examples/seq2seq_attention.py)."""
    spec_ = importlib.util.spec_from_file_location(
        "seq2seq_attention_example", ROOT / "examples" /
        "seq2seq_attention.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.build(VOCAB, T, HIDDEN)


@pytest.fixture(scope="module")
def variables(jax_model):
    """The JAX package's init as numpy, every leaf moved off its initial
    value (the zero biases too)."""
    v = jax.tree_util.tree_map(np.array, jax.jit(
        lambda: jax_model.init(seed=5))())
    r = np.random.default_rng(6)
    v["params"] = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * r.standard_normal(a.shape)).astype(
            np.float32), v["params"])
    return v


def _batch(seed, n=N):
    return chip_smoke.seq2seq_batch(n, seed)[0]


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a,
                          np.float32)
            for n, a in flatten_with_names(tree)}


def _port(backend="xla"):
    return GraphModel(chip_smoke.seq2seq_config(backend), device="cpu")


def test_config_json_is_the_examples_both_ways(jax_model):
    want = jax_config.config_to_dict(jax_model.config)
    loaded = nnconfig.GraphConfig.from_json(jax_model.config.to_json())
    assert nnconfig.config_to_dict(loaded) == want
    assert nnconfig.config_to_dict(chip_smoke.seq2seq_config()) == want
    model = GraphModel(loaded, device="cpu")
    assert model.order == jax_model.order
    assert model.shapes == {k: tuple(s) for k, s in jax_model.shapes.items()}
    assert model.shapes["xatt"] == (T, HIDDEN)
    back = jax_config.GraphConfig.from_json(loaded.to_json())
    assert jax_config.config_to_dict(back) == want


def test_variables_tree_is_the_jax_packages(jax_model, variables):
    got = _port().init()
    assert {n: tuple(a.shape) for n, a in flatten_with_names(got)} == {
        n: a.shape for n, a in flatten_with_names(variables)}
    assert set(got["params"]["enc"]) == {"fwd", "bwd"}
    assert got["state"] == {"enc": {"fwd": {}, "bwd": {}}} == variables[
        "state"]
    moved = _np(ckpt.variables_from_numpy(variables))
    assert moved.keys() == _np(variables).keys()
    for n, a in _np(variables).items():
        np.testing.assert_array_equal(moved[n], a, err_msg=n)
    assert {"params/enc/bwd/RW", "params/enc/fwd/W"} <= set(moved)


@pytest.mark.parametrize("backend", ["xla", "plain"])
def test_forward_matches_jax(jax_model, variables, backend):
    b = _batch(1)
    want = np.asarray(jax_model.output(variables, b["features"])["out"])
    got = _port(backend).output(ckpt.variables_from_numpy(variables),
                                b["features"])["out"]
    assert got.shape == (N, T, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # training mode (no dropout in this graph) through both packages
    jtrain = jax_model.apply(variables, b["features"], train=True)[0]["out"]
    ttrain = _port(backend).apply(
        ckpt.variables_from_numpy(variables),
        batch_to_device(b["features"], "cpu"), train=True)[0]["out"]
    np.testing.assert_allclose(ttrain.detach().numpy(), np.asarray(jtrain),
                               atol=TOL)


def test_loss_and_every_gradient_match_jax(jax_model, variables):
    b = _batch(2)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, {}, jb)[0]))(variables["params"])
    trainer = Trainer(_port())
    loss, _, _, grads = trainer._grad_of(
        ckpt.variables_from_numpy(variables["params"]), {},
        batch_to_device(b, "cpu"), None)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    got, want = _np(grads), _np(jgrads)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        if _exactly_zero_grad(n):
            assert max(np.abs(got[n]).max(), np.abs(w).max()) \
                <= ZERO_GRAD * top, n
        else:
            assert np.abs(got[n] - w).max() \
                <= TOL_GRAD_FRAC * np.abs(w).max(), n


@pytest.fixture(scope="module")
def jax_three_steps(jax_model, variables):
    """The JAX package's Trainer (the example's Adam(3e-3)): three steps
    from the shared init, with copies of each state and each step's
    gradients."""
    trainer = JaxTrainer(jax_model)
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
    grad = jax.jit(jax.grad(lambda p, b: jax_model.loss_fn(p, {}, b)[0]))
    states, losses, grads = [], [], []
    for seed in (6, 7, 8):
        b = _batch(seed)
        grads.append(_np(grad(ts.params, jax.tree_util.tree_map(
            jnp.asarray, b))))
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        states.append(jax.tree_util.tree_map(
            lambda x: jax.random.wrap_key_data(
                np.array(jax.random.key_data(x)),
                impl=str(jax.random.key_impl(x)))
            if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
            else np.array(x), ts))
    return trainer, states, losses, grads


def test_three_adam_steps_match_the_jax_trainer(variables, jax_three_steps):
    _, states, jlosses, jgrads = jax_three_steps
    trainer = Trainer(_port())
    ts = trainer.init_state(variables)
    losses, exempt = [], {}
    for k, seed in enumerate((6, 7, 8)):
        ts, m = trainer.train_step(ts, _batch(seed))
        assert ts.step == k + 1
        losses.append(float(m["total_loss"]))
        got, want = _np(ts.params), _np(states[k].params)
        assert got.keys() == want.keys() == jgrads[k].keys()
        n_exempt = n_all = 0
        for n, w in want.items():
            g = np.abs(jgrads[k][n])
            low = (g < GRAD_FLOOR * g.max()) & (g > 0)
            exempt[n] = exempt.get(n, False) | low | _exactly_zero_grad(n)
            err = np.abs(got[n] - w)
            assert err[~exempt[n]].max(initial=0) <= TOL_ADAM_PARAM, (k, n)
            assert err.max() <= 2 * (k + 1) * LR, (k, n)
            n_exempt += int(exempt[n].sum())
            n_all += w.size
        assert n_exempt <= MAX_EXEMPT * n_all, (k, n_exempt, n_all)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)


def test_checkpoints_cross_both_ways(jax_model, variables, jax_three_steps,
                                     tmp_path):
    jtrainer, states, jlosses, _ = jax_three_steps
    path = jax_ckpt.save_checkpoint(tmp_path / "jax", states[0],
                                    model=jax_model)
    trainer = Trainer(_port())
    ts = ckpt.restore_checkpoint(path, trainer.init_state(variables))
    want = _np({"p": states[0].params, "o": states[0].opt_state})
    got = _np({"p": ts.params, "o": ts.opt_state})
    assert ts.step == 1 and got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    _, m = trainer.train_step(ts, _batch(7))
    assert float(m["total_loss"]) == pytest.approx(jlosses[1], rel=TOL)
    served = ckpt.load_inference_variables(path, trainer.model)
    for n, a in _np(served["params"]).items():
        np.testing.assert_array_equal(a, want[f"p/{n}"], err_msg=n)
    out = ckpt.save_checkpoint(tmp_path / "port", ts, model=trainer.model)
    template = jtrainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, variables))
    restored = jax_ckpt.restore_checkpoint(out, template)
    back = _np({"p": restored.params, "o": restored.opt_state})
    for n in got:
        np.testing.assert_array_equal(back[n], got[n], err_msg=n)
    cfg = jax_ckpt.load_model_config(out)
    assert jax_config.config_to_dict(cfg) == jax_config.config_to_dict(
        jax_model.config)


def test_evaluate_model_counts_like_jax(jax_model, variables):
    """Per-token confusion counts over the [N, T, 12] head, dict features
    and one-hot labels, against the JAX package's ``Evaluation`` of its own
    model's output (its ``evaluate_model`` casts the features to one
    array, which a dict of two inputs is not)."""
    batches = [_batch(20), _batch(21)]
    for b in batches:
        b["labels"] = b["labels"]["out"]
    ev = evaluate_model(_port(), ckpt.variables_from_numpy(variables),
                        batches, num_classes=VOCAB, output_name="out")
    jev = jax_eval.Evaluation(VOCAB)
    for b in batches:
        jev.eval_time_series(jnp.asarray(b["labels"]), jax_model.output(
            variables, b["features"])["out"])
    np.testing.assert_array_equal(ev.confusion(), jev.confusion())
    assert int(ev.confusion().sum()) == 2 * N * T


def _probs(model, variables, feats):
    """The served function: {"tokens", "qpos"} → [n, T, vocab]."""
    return model.output(variables, feats)["out"]


def test_served_seq2seq_answers_like_output(variables):
    """Served by ModelServer → ModelRegistry → ParallelInference (batched,
    buckets up to 4 rows) with a dict input spec: int token ids and float
    query carriers, as JSON from concurrent clients, against ``output``;
    ids outside the vocabulary and a missing input are a 400."""
    model = _port()
    params = ckpt.variables_from_numpy(variables)
    reg = ModelRegistry()
    reg.register("seq2seq", partial(_probs, model), params,
                 input_spec={"tokens": spec((T,), np.int32, high=VOCAB),
                             "qpos": spec((T, HIDDEN), np.float32)},
                 mode="batched", max_batch_size=4, devices=["cpu"])
    srv = ModelServer(reg, port=0)
    srv.start(warm=True)
    try:
        client = ServingClient(srv.url, timeout=60)
        reqs = [_batch(40 + i, 1 + i % 3)["features"] for i in range(6)]
        with ThreadPoolExecutor(3) as pool:
            resps = list(pool.map(lambda r: client.predict("seq2seq", {
                "tokens": r["tokens"].tolist(),
                "qpos": r["qpos"].tolist()}), reqs))
        with pytest.raises(BadRequestError):
            client.predict("seq2seq", {"tokens": [[VOCAB] * T],
                                       "qpos": np.zeros((1, T, HIDDEN))
                                       .tolist()})
        with pytest.raises(BadRequestError):
            client.predict("seq2seq", {"tokens": [[2] * T]})
    finally:
        srv.stop()
    for req, resp in zip(reqs, resps):
        got = np.asarray(resp["outputs"], np.float32)
        want = _probs(model, params, req)
        assert got.shape == (req["tokens"].shape[0], T, VOCAB)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)


def test_trainer_fit_takes_dict_features_and_the_loss_falls(variables):
    """``Trainer.fit`` on the example's batch layout (features a dict of
    int tokens and float carriers, labels one-hot by output name): 40
    full-batch steps at 64 sequences move the loss well down."""
    trainer = Trainer(_port())
    ts = trainer.init_state(variables)
    batch = _batch(50, 64)
    losses = []

    class Record(TrainingListener):
        def on_iteration(self, epoch, step, ts, metrics):
            losses.append(float(metrics["total_loss"]))
            return False

    ts = trainer.fit(ts, [batch], epochs=40, listeners=[Record()])
    assert ts.step == 40 and len(losses) == 40
    assert np.all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0], (losses[0], losses[-1])
