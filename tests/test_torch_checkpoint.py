"""Training checkpoints cross between the port and the JAX package.

A checkpoint written by either package's ``save_checkpoint`` restores in
the other's ``restore_checkpoint``: the same directory layout, leaf names,
SHA-256 manifest, and the TrainState rng as threefry key data. The small
BERT's weights come from the JAX package's init; batches from a seed.
Dropout is 0: the two packages draw different masks from one seed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.bert import bert_tiny as jax_bert_tiny
from deeplearning4j_tpu.nn.config import (
    NeuralNetConfiguration as JaxNetConfig,
)
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.models.bert import bert_tiny, make_mlm_batch
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.train.listeners import CheckpointListener
from deeplearning4j_tpu_torch.train.trainer import RngKey, Trainer
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

TINY = dict(hidden=64, num_layers=2, num_heads=2, intermediate=128,
            vocab_size=128, max_position=32, dropout=0.0,
            attention_dropout=0.0)
LR = 1e-3
SEED = 21


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batches(n):
    return [make_mlm_batch(300 + i, 8, 16, TINY["vocab_size"], pad_frac=0.25,
                           max_predictions=4) for i in range(n)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's Trainer: init, two Adam steps, and the state after
    the first (what a checkpoint taken there holds)."""
    model = jax_bert_tiny(**TINY, net=JaxNetConfig(seed=SEED,
                                                   updater=JaxAdam(LR)))
    trainer = JaxTrainer(model)
    init = jax.tree_util.tree_map(np.asarray, model.init(seed=3))
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, init))
    losses, states = [], []
    for b in _batches(2):
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        # copies: the next step donates this state's buffers
        states.append(jax.tree_util.tree_map(
            lambda x: jax.random.wrap_key_data(np.array(
                jax.random.key_data(x))) if jax.dtypes.issubdtype(
                x.dtype, jax.dtypes.prng_key) else np.array(x), ts))
    return model, trainer, init, states, losses


def _port_trainer():
    return Trainer(bert_tiny(device="cpu", **TINY, net=NeuralNetConfiguration(
        seed=SEED, updater=Adam(LR))))


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


def test_jax_checkpoint_restores_in_the_port_and_trains_on(jax_run,
                                                            tmp_path):
    model, _, init, states, losses = jax_run
    path = jax_ckpt.save_checkpoint(tmp_path, states[0], model=model)
    assert ckpt.latest_checkpoint(tmp_path) == path
    trainer = _port_trainer()
    ts = ckpt.restore_checkpoint(path, trainer.init_state(init))
    assert ts.step == 1 and ts.rng == RngKey(SEED)
    want = _np({"params": states[0].params, "opt": states[0].opt_state})
    got = _np({"params": ts.params, "opt": ts.opt_state})
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    # the next step: its loss is a function of the restored params alone
    ts, metrics = trainer.train_step(ts, _batches(2)[1])
    assert ts.step == 2
    assert float(metrics["total_loss"]) == pytest.approx(losses[1], rel=1e-5)
    # Adam maps a gradient entry that differs in sign at 1e-9 to ±lr
    got, want = _np(ts.params), _np(states[1].params)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=2 * LR,
                                   err_msg=n)


def test_port_checkpoint_restores_in_jax(jax_run, tmp_path):
    model, jtrainer, init, states, _ = jax_run
    trainer = _port_trainer()
    ts = trainer.fit(trainer.init_state(init), _batches(1), listeners=[
        CheckpointListener(str(tmp_path), every_epochs=1,
                           model=trainer.model)])
    path = jax_ckpt.latest_checkpoint(tmp_path)
    assert path is not None and path.endswith("checkpoint_1_epoch0")
    assert jax_ckpt.verify_checkpoint(path, deep=True) == (True, "ok")
    template = jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray, init))
    restored = jax_ckpt.restore_checkpoint(path, template)
    assert int(restored.step) == 1
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored.rng)),
        np.asarray(jax.random.key_data(jax.random.key(SEED))))
    got = _np({"params": restored.params, "opt": restored.opt_state})
    want = _np({"params": ts.params, "opt": ts.opt_state})
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    # the config travels too: the JAX package rebuilds the model from it
    cfg = jax_ckpt.load_model_config(path)
    assert cfg.hidden == TINY["hidden"] and cfg.net.updater.lr == LR
    # and the JAX package trains on from it
    _, m = jtrainer.train_step(restored, _batches(2)[1])
    assert np.isfinite(float(m["total_loss"]))


def test_restore_checks_every_digest(jax_run, tmp_path):
    _, _, init, _, _ = jax_run
    trainer = _port_trainer()
    ts = trainer.init_state(init)
    path = ckpt.save_checkpoint(tmp_path, ts)
    man = tmp_path / "checkpoint_0" / "manifest.json"
    doc = json.loads(man.read_text())
    doc["arrays"]["opt_state/m/mlm/b"]["sha256"] = "0" * 64
    man.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="opt_state/m/mlm/b"):
        ckpt.restore_checkpoint(path, ts)


def test_rotation_keeps_the_last_checkpoints(jax_run, tmp_path):
    _, _, init, _, _ = jax_run
    trainer = _port_trainer()
    ts = trainer.fit(trainer.init_state(init), _batches(3), listeners=[
        CheckpointListener(str(tmp_path), every_epochs=None, every_iters=1,
                           keep_last=2)])
    names = [c["name"] for c in json.loads(
        (tmp_path / "checkpoint_index.json").read_text())["checkpoints"]]
    assert names == ["checkpoint_2_iter2", "checkpoint_3_iter3"]
    assert not (tmp_path / "checkpoint_1_iter1").exists()
    back = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path), ts)
    assert back.step == 3
    for n, a in _np(ts).items():
        np.testing.assert_array_equal(_np(back)[n], a, err_msg=n)


def test_rng_key_data_is_jax_random_key_data():
    for seed in (0, 12345, 2**31 - 1, 2**32 - 1, -3, 2**33 + 5):
        for impl in ("threefry2x32", "rbg"):
            key = jax.random.key(seed, impl=impl)
            assert str(jax.random.key_impl(key)) == impl
            want = np.asarray(jax.random.key_data(key))
            np.testing.assert_array_equal(RngKey(seed, impl).key_data(),
                                          want)
            assert RngKey.from_key_data(want, impl) == RngKey(seed, impl)
    with pytest.raises(ValueError, match="unsafe_rbg"):
        RngKey.from_key_data(np.zeros(4, np.uint32), "unsafe_rbg")
    with pytest.raises(ValueError, match="uint32\\[4\\]"):
        RngKey.from_key_data(np.zeros(2, np.uint32), "rbg")
    with pytest.raises(ValueError, match="halves"):
        RngKey.from_key_data(np.array([0, 1, 0, 2], np.uint32), "rbg")
