"""The port's training surface against the JAX package's, on the CPU.

Updaters, schedules, gradient normalization, ``Bert.loss_fn`` and
``Trainer`` steps of a small BERT. Every input (params, gradients,
batches, weights) is made from a seed with numpy, or by the JAX package's
init, and handed to both packages. Dropout is 0 wherever the two are
compared: their generators draw different masks from one seed.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.bert import bert_tiny as jax_bert_tiny
from deeplearning4j_tpu.models.bert import make_mlm_batch as jax_make_batch
from deeplearning4j_tpu.nn.config import (
    NeuralNetConfiguration as JaxNetConfig,
)
from deeplearning4j_tpu.train import schedules as jax_schedules
from deeplearning4j_tpu.train import updaters as jax_updaters
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.trainer import (
    _normalize_gradients as jax_normalize,
)
from deeplearning4j_tpu_torch.models.bert import bert_tiny, make_mlm_batch
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.train import schedules, updaters
from deeplearning4j_tpu_torch.train.listeners import ScoreIterationListener
from deeplearning4j_tpu_torch.train.trainer import (
    Trainer,
    _normalize_gradients,
    batch_to_device,
)
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

UPDATERS = ["Sgd", "Nesterovs", "Adam", "AdamW", "AMSGrad", "Nadam",
            "AdaMax", "AdaGrad", "AdaDelta", "RmsProp", "NoOp"]
SCHEDULES = [
    ("FixedSchedule", {"value": 0.05}),
    ("ExponentialSchedule", {"initial": 0.1, "gamma": 0.99}),
    ("InverseSchedule", {"initial": 0.1, "gamma": 0.01, "power": 0.75}),
    ("PolySchedule", {"initial": 0.1, "power": 2.0, "max_steps": 500}),
    ("SigmoidSchedule", {"initial": 0.1, "gamma": 0.02, "step_center": 50}),
    ("StepSchedule", {"initial": 0.1, "decay": 0.5, "step_size": 10}),
    ("MapSchedule", {"values": {10: 0.05, 100: 0.01}, "initial": 0.1}),
    ("WarmupCosineSchedule", {"peak": 0.1, "warmup_steps": 10,
                              "total_steps": 500, "end_value": 0.001}),
]
NORMALIZATIONS = ["clip_value", "clip_l2_global", "clip_l2_per_param",
                  "renormalize_l2_per_layer"]
# a BERT small enough for the CPU: 2 layers, width 64, 2 heads of 32
TINY = dict(hidden=64, num_layers=2, num_heads=2, intermediate=128,
            vocab_size=128, max_position=32, dropout=0.0,
            attention_dropout=0.0)
N, T, P = 8, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"dense": {"W": scale * r.standard_normal((3, 4)),
                      "b": scale * r.standard_normal((4,))},
            "out": {"W": scale * r.standard_normal((4, 2))}}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _to_np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


def _assert_trees_close(got, want, **tol):
    got, want = _to_np(got), _to_np(want)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **tol)


# -- updaters and schedules ----------------------------------------------------

@pytest.mark.parametrize("name", UPDATERS)
def test_updater_matches_jax_over_three_steps(name):
    """Updates, updater state and params after each of three steps on fixed
    gradients. Float32, same formulas in the same order; the scalar
    powers of the bias corrections may differ by an ulp."""
    jinit, jupdate = getattr(jax_updaters, name)().make()
    tinit, tupdate = getattr(updaters, name)().make()
    jp = _f32(_np_tree(0))
    tp = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
          for k, v in jp.items()}
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g = _f32(_np_tree(10 + step, scale=0.5))
        ju, js = jupdate(g, js, jp, jnp.int32(step))
        tu, ts = tupdate({k: {n: torch.from_numpy(a) for n, a in v.items()}
                          for k, v in g.items()}, ts, tp, step)
        jp = jax_updaters.apply_updates(jp, ju)
        tp = updaters.apply_updates(tp, tu)
        for got, want in ((tu, ju), (ts, js), (tp, jp)):
            _assert_trees_close(got, want, rtol=2e-6, atol=1e-9)


def test_updater_configs_cross_as_json():
    from deeplearning4j_tpu.nn.config import config_from_json as jax_from
    from deeplearning4j_tpu.nn.config import config_to_json as jax_to
    from deeplearning4j_tpu_torch.nn.config import (
        config_from_json,
        config_to_json,
    )

    for name in UPDATERS:
        cfg = config_from_json(jax_to(getattr(jax_updaters, name)()))
        assert type(cfg) is getattr(updaters, name)
        assert type(jax_from(config_to_json(cfg))) is getattr(jax_updaters,
                                                              name)
    adam = updaters.resolve_updater("adam", learning_rate=0.5)
    assert isinstance(adam, updaters.Adam) and adam.lr == 0.5


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, kw):
    """float32 on both sides (numpy here, XLA there)."""
    jsched = getattr(jax_schedules, name)(**kw)
    tsched = getattr(schedules, name)(**kw)
    for step in (0, 1, 10, 100, 1000):
        want = float(jsched(jnp.int32(step)))
        assert tsched(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_schedule_drives_the_updater_rate():
    _, tupdate = updaters.Sgd(lr=schedules.StepSchedule(
        initial=1.0, decay=0.5, step_size=2)).make()
    g = {"w": torch.ones(2)}
    rates = [-float(tupdate(g, (), g, s)[0]["w"][0]) for s in range(5)]
    assert rates == [1.0, 1.0, 0.5, 0.5, 0.25]


@pytest.mark.parametrize("mode", NORMALIZATIONS)
def test_gradient_normalization_matches_jax(mode):
    g = _f32(_np_tree(3, scale=2.0))
    want = jax_normalize(g, JaxNetConfig(
        gradient_normalization=mode, gradient_normalization_threshold=0.7))
    got = _normalize_gradients(
        {k: {n: torch.from_numpy(a) for n, a in v.items()}
         for k, v in g.items()},
        NeuralNetConfiguration(gradient_normalization=mode,
                               gradient_normalization_threshold=0.7))
    _assert_trees_close(got, want, rtol=1e-6, atol=1e-7)


# -- Bert.loss_fn and Trainer steps of a small BERT ---------------------------

def _batches(n, gathered=True):
    return [make_mlm_batch(100 + i, N, T, TINY["vocab_size"], pad_frac=0.25,
                           max_predictions=P if gathered else None)
            for i in range(n)]


def _jax_model(updater, **kw):
    return jax_bert_tiny(**{**TINY, **kw}, net=JaxNetConfig(updater=updater))


def _port_model(updater, **kw):
    return bert_tiny(device="cpu", **{**TINY, **kw},
                     net=NeuralNetConfiguration(updater=updater))


@pytest.fixture(scope="module")
def init_vars():
    """The JAX package's init of the small BERT, as numpy."""
    return jax.tree_util.tree_map(np.asarray,
                                  _jax_model(None).init(seed=3))


def _jax_steps(init_vars, batches, updater, **kw):
    """The JAX package's Trainer, one jitted step per batch → (final
    params as numpy, per-step losses)."""
    trainer = JaxTrainer(_jax_model(updater), **kw)
    ts = trainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, init_vars))
    losses = []
    for b in batches:
        ts, metrics = trainer.train_step(ts, b)
        losses.append(float(metrics["total_loss"]))
    return jax.tree_util.tree_map(np.asarray, ts.params), losses


def _port_fit(init_vars, batches, updater, model=None, **kw):
    trainer = Trainer(model or _port_model(updater), **kw)
    ts = trainer.init_state(init_vars)
    score = ScoreIterationListener(every=1, stream=io.StringIO())
    ts = trainer.fit(ts, batches, listeners=[score])
    return ts, score.history


def test_make_mlm_batch_is_the_jax_packages_batch():
    for kw in ({}, {"pad_frac": 0.3, "max_predictions": 5}):
        got = make_mlm_batch(7, 4, 32, 500, **kw)
        want = jax_make_batch(7, 4, 32, 500, **kw)
        for n, w in flatten_with_names(want):
            np.testing.assert_array_equal(dict(flatten_with_names(got))[n],
                                          w)


@pytest.mark.parametrize("gathered", [False, True], ids=["dense", "gathered"])
def test_loss_fn_matches_jax(init_vars, gathered):
    batch = _batches(1, gathered)[0]
    jm = _jax_model(None)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    want, (_, jmetrics) = jax.jit(lambda p, b: jm.loss_fn(p, {}, b))(
        jax.tree_util.tree_map(jnp.asarray, init_vars["params"]), jb)
    model = _port_model(None)
    got, (state, metrics) = model.loss_fn(
        batch_to_device(init_vars["params"], "cpu"), {},
        batch_to_device(batch, "cpu"))
    assert state == {}
    assert set(metrics) == set(jmetrics) == {"mlm_loss", "nsp_loss", "loss"}
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]),
                                                  rel=1e-6)


def test_first_step_gradients_match_jax(init_vars):
    """float32, two post-LN layers; per-leaf max abs difference against a
    small fraction of that leaf's largest gradient, with a floor of 1e-8:
    the key biases' gradients are 0 in exact arithmetic (softmax ignores a
    shift of a whole row) and rounding noise of order 1e-10 here."""
    batch = _batches(1)[0]
    jm = _jax_model(None)
    jgrads = jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, {}, b)[0]))(
        jax.tree_util.tree_map(jnp.asarray, init_vars["params"]),
        jax.tree_util.tree_map(jnp.asarray, batch))
    trainer = Trainer(_port_model(None))
    _, _, _, grads = trainer._grad_of(
        batch_to_device(init_vars["params"], "cpu"), {},
        batch_to_device(batch, "cpu"), None)
    got, want = _to_np(grads), _to_np(jgrads)
    assert got.keys() == want.keys()
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                      1e-4), n


def test_three_sgd_steps_match_jax(init_vars):
    batches = _batches(3)
    want, wlosses = _jax_steps(init_vars, batches, jax_updaters.Sgd(0.5))
    ts, losses = _port_fit(init_vars, batches, updaters.Sgd(0.5))
    assert ts.step == 3
    np.testing.assert_allclose(losses, wlosses, rtol=1e-5)
    # float32 forward/backward sum-order differences, times lr, three times
    _assert_trees_close(ts.params, want, rtol=0, atol=2e-5)


def test_three_adam_steps_of_fit_match_jax_losses(init_vars):
    """Adam maps a gradient entry that differs in sign at 1e-9 to ±lr, so
    params are held to lr; the losses of the three steps to 1e-5."""
    batches = _batches(3)
    lr = 1e-3
    want, wlosses = _jax_steps(init_vars, batches, jax_updaters.Adam(lr))
    ts, losses = _port_fit(init_vars, batches, updaters.Adam(lr))
    np.testing.assert_allclose(losses, wlosses, rtol=1e-5)
    _assert_trees_close(ts.params, want, rtol=0, atol=2 * lr)
    assert set(k for k, _ in flatten_with_names(ts.opt_state)) == {
        f"{m}/{n}" for m in ("m", "v")
        for n, _ in flatten_with_names(ts.params)}


def test_grad_accum_matches_jax(init_vars):
    batches = _batches(1)
    want, wlosses = _jax_steps(init_vars, batches, jax_updaters.Sgd(0.5),
                               grad_accum=2)
    ts, losses = _port_fit(init_vars, batches, updaters.Sgd(0.5),
                           grad_accum=2)
    np.testing.assert_allclose(losses, wlosses, rtol=1e-5)
    _assert_trees_close(ts.params, want, rtol=0, atol=2e-5)


def test_frozen_embeddings_stay_bit_equal(init_vars):
    ts, _ = _port_fit(init_vars, _batches(2), updaters.AdamW(1e-2),
                      frozen_layers=["embeddings"])
    got = _to_np(ts.params)
    for n, w in flatten_with_names(init_vars["params"]):
        if n.startswith("embeddings/"):
            np.testing.assert_array_equal(got[n], w, err_msg=n)
        else:
            assert not np.array_equal(got[n], w), n
    assert all(float(np.abs(np.asarray(m)).max()) == 0.0
               for n, m in flatten_with_names(ts.opt_state)
               if "/embeddings/" in f"/{n}")


def test_mixed_precision_matches_jax(init_vars):
    """bf16 compute on both sides, float32 master params and updater state.
    The two round activations and gradients to bf16 (eps 2^-8) at other
    places: losses agree to 2e-2, and after two SGD steps every leaf to 5%
    of its own movement plus 1e-4 (for the key biases, whose exact gradient
    is 0 and whose movement is rounding noise)."""
    batches = _batches(2)
    jm = _jax_model(jax_updaters.Sgd(0.5))
    jm.net.mixed_precision = True
    jtrainer = JaxTrainer(jm)
    jts = jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray, init_vars))
    jlosses = []
    for b in batches:
        jts, m = jtrainer.train_step(jts, b)
        jlosses.append(float(m["total_loss"]))
    model = _port_model(updaters.Sgd(0.5))
    model.net.mixed_precision = True
    ts, losses = _port_fit(init_vars, batches, None, model=model)
    assert all(p.dtype == torch.float32
               for _, p in flatten_with_names(ts.params))
    assert all(m.dtype == torch.float32 for _, m in
               flatten_with_names(ts.opt_state))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    _, fp32_losses = _port_fit(init_vars, batches, updaters.Sgd(0.5))
    assert losses != fp32_losses  # the bf16 path really ran
    got, want = _to_np(ts.params), _to_np(jts.params)
    start = dict(flatten_with_names(init_vars["params"]))
    for n, w in want.items():
        moved = np.abs(w - start[n]).max()
        assert np.abs(got[n] - w).max() <= 0.05 * moved + 1e-4, n


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_grads_equal_plain_grads(init_vars, dropout):
    """Recomputation in backward replays the step's generator, so even
    with dropout the gradients are those of the plain forward."""
    batch = batch_to_device(_batches(1)[0], "cpu")
    params = batch_to_device(init_vars["params"], "cpu")
    out = []
    for remat in (False, True):
        trainer = Trainer(_port_model(
            None, remat=remat, dropout=dropout, attention_dropout=dropout))
        gen = torch.Generator().manual_seed(11)
        loss, _, _, grads = trainer._grad_of(params, {}, batch, gen)
        out.append((float(loss), _to_np(grads)))
    assert out[0][0] == out[1][0]
    for n in out[0][1]:
        np.testing.assert_allclose(out[1][1][n], out[0][1][n], rtol=0,
                                   atol=1e-7, err_msg=n)


def test_dropout_changes_the_loss_and_follows_the_seed(init_vars):
    batch = batch_to_device(_batches(1)[0], "cpu")
    params = batch_to_device(init_vars["params"], "cpu")
    model = _port_model(None, dropout=0.1, attention_dropout=0.1)

    def loss(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return float(model.loss_fn(params, {}, batch, generator=gen)[0])

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    assert loss(None) != loss(1)


def test_listeners_record_and_print(init_vars, tmp_path):
    from deeplearning4j_tpu_torch.train.listeners import (
        JsonlMetricsListener,
        PerformanceListener,
    )

    out = io.StringIO()
    path = tmp_path / "metrics.jsonl"
    trainer = Trainer(_port_model(updaters.Sgd(0.1)), grad_metrics=True,
                      extra_metrics=lambda params, batch: {
                          "w_norm": torch.linalg.norm(params["mlm"]["W"])})
    ts = trainer.fit(trainer.init_state(init_vars), _batches(3), listeners=[
        JsonlMetricsListener(str(path)), PerformanceListener(every=1,
                                                             stream=out)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3] and ts.step == 3
    assert {"total_loss", "mlm_loss", "nsp_loss", "batch_size", "w_norm",
            "grad_norm/layer_0", "grad_norm/embeddings"} <= set(recs[0])
    assert recs[0]["batch_size"] == N
    assert out.getvalue().count("samples/sec") == 2  # the first is not timed


def test_as_batch_dict_takes_dicts_tuples_and_datasets():
    from types import SimpleNamespace

    from deeplearning4j_tpu_torch.data.dataset import as_batch_dict

    x, y, m = np.zeros((2, 3)), np.ones(2), np.ones((2, 3))
    assert as_batch_dict({"features": x})["features"] is x
    assert as_batch_dict((x, y)) == {"features": x, "labels": y}
    d = as_batch_dict(SimpleNamespace(features=x, labels=y, labels_mask=m))
    assert d["mask"] is m and d["labels"] is y
    with pytest.raises(TypeError):
        as_batch_dict(x)


def test_steps_and_epochs_of_fit():
    """``steps_per_epoch`` cuts each epoch; a listener can stop the fit."""
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    class StopAt(TrainingListener):
        def on_iteration(self, epoch, step, ts, metrics):
            return step == 5

    trainer = Trainer(_port_model(updaters.NoOp()))
    ts = trainer.init_state()
    ts = trainer.fit(ts, _batches(3), epochs=2, steps_per_epoch=2)
    assert ts.step == 4
    ts = trainer.fit(ts, _batches(3), epochs=5, listeners=[StopAt()])
    assert ts.step == 5
