"""The port's advanced zoo (NASNet-A, Inception-ResNet-v1) against the JAX package's, on the CPU.

Both models at the JAX zoo tests' sizes (``tests/test_zoo.py``): NASNet
``penultimate_filters=48, cells_per_stack=1`` at 32², Inception-ResNet-v1
``width=8, blocks_a=1, blocks_b=1`` at 64², 5 classes, dropout 0. Each is
built in both packages, fed the JAX package's variables drawn with numpy
from a seed (``test_torch_zoo_cnn._variables``: biases and BatchNorm
running state moved off their initial values) and the same seeded batch
of 4. Held: the eval-mode forward to TOL of its max; the train-mode loss
to TOL relative, the BatchNorm state to TOL of max(1, |JAX|) and every
gradient leaf to TOL of the largest gradient of the model; one Adam step
of the Trainer against the JAX package's (an entry whose gradient is at
rounding level may move the other way: 2·lr, at most MAX_SIGN_FLIPS of
the entries beyond TOL_ADAM). At full size: the configs, ``shapes``,
variable trees and parameter counts (NASNet-A Mobile 4,165,560; the
FaceNet backbone 3,303,040) are the JAX package's.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn.model import GraphModel
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names
from test_torch_zoo_cnn import _batch, _np, _variables

TOL = 1e-5
LR = 1e-3
TOL_ADAM = 1e-5
MAX_SIGN_FLIPS = 0.002

SMALL = {
    "nasnet": dict(num_classes=5, input_shape=(32, 32, 3),
                   penultimate_filters=48, cells_per_stack=1, dropout=0.0),
    "inception_resnet_v1": dict(num_classes=5, width=8, blocks_a=1,
                                blocks_b=1, input_shape=(64, 64, 3),
                                dropout=0.0),
}
# the configurations the card runs (chip_smoke.py's nasnet_* and facenet_*)
FULL = {
    "nasnet": (dict(penultimate_filters=1056, cells_per_stack=4,
                    stem_filters=32), 4_165_560),
    "inception_resnet_v1": (dict(width=32, blocks_a=5, blocks_b=10,
                                 embedding=128), 3_303_040),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(name, **extra):
    kw = dict(SMALL[name], **extra)
    return jax_zoo.get_model(name, **kw), zoo.get_model(name, device="cpu",
                                                        **kw)


@pytest.mark.parametrize("name", list(SMALL))
def test_config_order_and_forward_match_jax(name):
    jmodel, model = _pair(name)
    assert nnconfig.config_to_dict(model.config) == nnconfig.config_to_dict(
        nnconfig.config_from_json(jmodel.config.to_json()))
    assert model.order == jmodel.order
    assert model.shapes == jmodel.shapes
    v = _variables(jmodel)
    tv = ckpt.variables_from_numpy(v)
    assert {n: a.shape for n, a in _np(tv).items()} == {
        n: a.shape for n, a in _np(model.init()).items()}
    x = _batch(jmodel.config, 5, 3)["features"]
    want = np.asarray(jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False)[0]["output"])(v, x))
    got = model.output_single(tv, x).numpy()
    assert got.shape == want.shape == (4, 5)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("name", list(SMALL))
def test_train_loss_state_and_every_gradient_match_jax(name):
    jmodel, model = _pair(name)
    v = _variables(jmodel)
    batch = _batch(jmodel.config, 5, 4)
    (jloss, (jstate, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jmodel.loss_fn(p, s, b), has_aux=True))(
        v["params"], v["state"], batch)
    tv = ckpt.variables_from_numpy(v)
    loss, state, _, grads = Trainer(model)._grad_of(
        tv["params"], tv["state"], batch_to_device(batch, "cpu"), None)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    got, want = _np(state), _np(jstate)
    assert got.keys() == want.keys()
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL * max(1.0, np.abs(w).max()), n
    got, want = _np(grads), _np(jgrads)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL * top, n


@pytest.mark.parametrize("name", list(SMALL))
def test_one_adam_step_matches_the_jax_trainer(name):
    jmodel = jax_zoo.get_model(name, **SMALL[name], updater=JaxAdam(LR))
    model = zoo.get_model(name, device="cpu", **SMALL[name], updater=Adam(LR))
    v = _variables(jmodel)
    batch = _batch(jmodel.config, 5, 6)
    jtrainer = JaxTrainer(jmodel)
    jts, jm = jtrainer.train_step(
        jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray, v)), batch)
    trainer = Trainer(model)
    ts, m = trainer.train_step(trainer.init_state(v), batch)
    assert ts.step == 1
    assert float(m["total_loss"]) == pytest.approx(float(jm["total_loss"]),
                                                   rel=TOL)
    got, want = _np(ts.params), _np(jax.device_get(jts.params))
    flips = total = 0
    for n, w in want.items():
        err = np.abs(got[n] - w)
        assert err.max() <= 2 * LR, n
        flips += int((err > TOL_ADAM).sum())
        total += w.size
    assert flips <= MAX_SIGN_FLIPS * total, (flips, total)
    got, want = _np(ts.model_state), _np(jax.device_get(jts.model_state))
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL * max(1.0, np.abs(w).max()), n


@pytest.mark.parametrize("name", list(FULL))
def test_full_size_shapes_variables_and_counts_are_the_jax_packages(name):
    kw, n_params = FULL[name]
    jmodel = jax_zoo.get_model(name, **kw)
    model = zoo.get_model(name, device="cpu", **kw)
    assert model.shapes == jmodel.shapes
    assert nnconfig.config_to_dict(model.config) == nnconfig.config_to_dict(
        nnconfig.config_from_json(jmodel.config.to_json()))
    want = {n: (tuple(a.shape), str(a.dtype)) for n, a in flatten_with_names(
        jax.eval_shape(lambda: jmodel.init(seed=0)))}
    v = model.init()
    got = {n: (tuple(a.shape), str(a.dtype)[len("torch."):])
           for n, a in flatten_with_names(v)}
    assert got == want
    assert model.num_params(v) == n_params


def test_facenet_embedding_graph_matches_jax_and_cannot_be_fitted():
    """``num_classes=0``: the linear bottleneck (dropout 0) answers the JAX
    package's embeddings; fitting it directly raises the JAX package's
    TypeError, in ``loss_fn`` and through the Trainer."""
    kw = dict(SMALL["inception_resnet_v1"], num_classes=0, embedding=16)
    jmodel = jax_zoo.get_model("inception_resnet_v1", **kw)
    model = zoo.get_model("inception_resnet_v1", device="cpu", **kw)
    assert model.config.outputs == jmodel.config.outputs == ["bottleneck"]
    v = _variables(jmodel)
    x = _batch(jmodel.config, 5, 7)["features"]
    want = np.asarray(jmodel.output_single(v, x))
    got = model.output_single(ckpt.variables_from_numpy(v), x).numpy()
    assert got.shape == want.shape == (4, 16)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    batch = {"features": x, "labels": np.zeros((4, 16), np.float32)}
    with pytest.raises(TypeError, match="cannot be trained directly") as je:
        jmodel.loss_fn(v["params"], v["state"], batch)
    tv = ckpt.variables_from_numpy(v)
    with pytest.raises(TypeError) as te:
        model.loss_fn(tv["params"], tv["state"],
                      batch_to_device(batch, "cpu"))
    assert str(te.value) == str(je.value)
    trainer = Trainer(model)
    with pytest.raises(TypeError, match="cannot be trained directly"):
        trainer.train_step(trainer.init_state(tv), batch)


def test_summary_is_the_jax_packages():
    jmodel, model = _pair("inception_resnet_v1")
    v = _variables(jmodel)
    assert model.summary(ckpt.variables_from_numpy(v)) == jmodel.summary(v)


def test_entries_run_on_the_card_unless_asked():
    with mock.patch("torch.cuda.is_available", return_value=False):
        for name in ("nasnet", "inception_resnet_v1"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                zoo.get_model(name, **SMALL[name])
            model = zoo.get_model(name, device="cpu", **SMALL[name])
            assert isinstance(model, GraphModel)
            assert model.device.type == "cpu"
    assert set(zoo.ZOO) == set(jax_zoo.ZOO)
