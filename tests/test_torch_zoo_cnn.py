"""The port's CNN zoo entries against the JAX package's, on the CPU.

AlexNet, VGG16, VGG19, SimpleCNN, Darknet19, SqueezeNet, U-Net and
Xception at the JAX zoo tests' sizes (``tests/test_zoo.py``), each built
in both packages from the same config JSON, fed the JAX package's
variables (biases and BatchNorm running state moved off their initial
values) and the
same seeded batch of 4: the forward to 1e-5 of the output's max, the
loss (Dropout off: no generator) to 1e-5 relative, and the port's loss to
1e-5 of the same model's in float64 (at a batch of 2 Darknet19's last
BatchNorms see 8 values a channel, and the JAX package's float32 loss is
1.1e-5 off float64 there, the port's 1.7e-6). U-Net at 32×32,
``base_filters=4``, ``depth=2``: every gradient (1e-4 of each leaf's
max), two Adam steps of the Trainer against the JAX package's, and
checkpoints across both ways. Xception's one-step gradient check is
``slow`` (by relative L2 error, beside the port's float64 copy: see
``_gradient_check``); tier-1 holds the gradients of its stem and first
entry block, cut from each package's own ``xception_config``, per leaf. ``summary()`` equals the
JAX string. Full-size variable trees against ``jax.eval_shape`` of the
JAX init. Tiny-YOLO and YOLOv2 at 64² with 4 classes (a 2×2 grid) take
dense grid labels of 1–3 boxes an image from ``make_yolo_labels``
(``tests/test_torch_yolo.py`` holds the rest of the YOLO family).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.nn.model import GraphModel as JaxGraphModel
from deeplearning4j_tpu.nn.model import SequentialModel as JaxSequentialModel
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.nn.model import GraphModel, SequentialModel
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names, tree_map

TOL = 1e-5
TOL_GRAD = 1e-4
N = 4
LR = 1e-3

# name → (zoo kwargs, number of classes); the JAX zoo tests' sizes, VGG19
# at VGG16's
ZOO_CASES = {
    "alexnet": (dict(num_classes=4, input_shape=(63, 63, 3)), 4),
    "vgg16": (dict(num_classes=4, input_shape=(32, 32, 3)), 4),
    "vgg19": (dict(num_classes=4, input_shape=(32, 32, 3)), 4),
    "simplecnn": (dict(num_classes=3, input_shape=(24, 24, 3)), 3),
    "darknet19": (dict(num_classes=6, input_shape=(64, 64, 3)), 6),
    "squeezenet": (dict(num_classes=7, input_shape=(64, 64, 3)), 7),
    "xception": (dict(num_classes=5, input_shape=(71, 71, 3)), 5),
    "unet": (dict(input_shape=(32, 32, 3), base_filters=4, depth=2), 1),
    "tiny_yolo": (dict(num_classes=4, input_shape=(64, 64, 3)), 4),
    "yolo2": (dict(num_classes=4, input_shape=(64, 64, 3)), 4),
}
UNET = ZOO_CASES["unet"][0]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a,
                          np.float32)
            for n, a in flatten_with_names(tree)}


def _close(got, want, tol=TOL):
    assert got.keys() == want.keys()
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        assert np.abs(got[n] - w).max() <= tol * max(
            float(np.abs(w).max()), 1e-30), n


def _grads_close(got, want):
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        scale = max(np.abs(w).max(), 1e-4 * top)
        assert np.abs(got[n] - w).max() <= TOL_GRAD * scale, n


def _jax_model(cfg):
    return (JaxGraphModel if isinstance(cfg, jax_config.GraphConfig)
            else JaxSequentialModel)(cfg)


def _port_model(jmodel):
    """The port's model from the JAX model's config JSON."""
    cfg = nnconfig.config_from_json(jmodel.config.to_json())
    cls = (GraphModel if isinstance(cfg, nnconfig.GraphConfig)
           else SequentialModel)
    return cls(cfg, device="cpu")


def _variables(jmodel, seed=1):
    """The JAX package's variables tree (names and shapes from
    ``jax.eval_shape`` of its init) drawn with numpy from the seed: He
    normal weights over the fan-in, gamma near 1, beta, biases and
    running means near 0, running variances in [1, 2). (Nonzero biases:
    a zero bias after a dead ReLU gives logits of exactly 0, where the
    two packages' binary cross-entropy gradients part by design,
    ``test_torch_conv_layers.py::test_bce_gradient_at_a_zero_logit``.)"""
    shapes = jax.eval_shape(lambda: jmodel.init(seed=seed))
    r = np.random.default_rng(seed)

    def draw(key, shape):
        z = r.standard_normal(shape)
        if key in ("W", "dW", "pW"):
            return z * np.sqrt(2.0 / np.prod(shape[:-1]))
        if key == "gamma":
            return 1.0 + 0.1 * z
        if key == "var":
            return 1.0 + r.random(shape)
        return (0.1 if key == "mean" else 0.05) * z

    return {part: {layer: {k: draw(k, a.shape).astype(np.float32)
                           for k, a in leaves.items()}
                   for layer, leaves in shapes[part].items()}
            for part in ("params", "state")}


def _input_shape(cfg):
    if isinstance(cfg, (jax_config.GraphConfig, nnconfig.GraphConfig)):
        return tuple(cfg.input_shapes["input"])
    return tuple(cfg.input_shape)


def _output_layer(cfg):
    if isinstance(cfg, (jax_config.GraphConfig, nnconfig.GraphConfig)):
        return cfg.vertices[cfg.outputs[0]].layer
    return cfg.layers[-1]


def _is_yolo(cfg):
    return type(_output_layer(cfg)).__name__ == "Yolo2OutputLayer"


def _yolo_labels(r, n, shape, n_out):
    """Dense grid labels of 1–3 boxes an image (w, h in [0.1, 0.4] of the
    image, centres inside it) on the stride-32 grid."""
    objects = [[(float(r.uniform(0.05, 0.95)), float(r.uniform(0.05, 0.95)),
                 float(r.uniform(0.1, 0.4)), float(r.uniform(0.1, 0.4)),
                 int(r.integers(0, n_out)))
                for _ in range(int(r.integers(1, 4)))] for _ in range(n)]
    return zoo.make_yolo_labels(objects, grid=(shape[0] // 32,
                                               shape[1] // 32),
                                num_classes=n_out)


def _batch(cfg, n_out, seed, n=N):
    r = np.random.default_rng(seed)
    shape = _input_shape(cfg)
    x = r.standard_normal((n, *shape)).astype(np.float32)
    if _is_yolo(cfg):
        y = _yolo_labels(r, n, shape, n_out)
    elif n_out == 1:  # U-Net: a binary mask per pixel
        y = (r.random((n, *shape[:2], 1)) < 0.4).astype(np.float32)
    else:
        y = np.eye(n_out, dtype=np.float32)[r.integers(0, n_out, n)]
    return {"features": x, "labels": y}


def _out_shape(cfg, n_out, n=N):
    shape = _input_shape(cfg)
    if _is_yolo(cfg):
        return (n, shape[0] // 32, shape[1] // 32,
                len(_output_layer(cfg).anchors), 5 + n_out)
    return (n, *shape[:2], 1) if n_out == 1 else (n, n_out)


def _single(out):
    """The one output of a model (a graph's by its name)."""
    return next(iter(out.values())) if isinstance(out, dict) else out


def _output(model, variables, x):
    return _single(model.output(variables, x))


def _jax_output(jmodel, variables, x):
    return _single(jmodel.apply(variables, x, train=False)[0])


# YOLOv2's float32 loss is held apart, through its feature map
# (tests/test_torch_yolo.py::test_yolo2_forward_train_features_and_loss_match_jax)
@pytest.mark.parametrize("name", [n for n in ZOO_CASES if n != "yolo2"])
def test_zoo_entry_forward_and_loss_match_jax(name):
    kw, n_out = ZOO_CASES[name]
    jmodel = jax_zoo.get_model(name, **kw)
    model = zoo.get_model(name, device="cpu", **kw)
    assert nnconfig.config_to_dict(_port_model(jmodel).config) == \
        nnconfig.config_to_dict(model.config)
    assert (model.order if hasattr(model, "order") else model.layer_names) \
        == (jmodel.order if hasattr(jmodel, "order") else jmodel.layer_names)
    v = _variables(jmodel)
    tv = ckpt.variables_from_numpy(v)
    assert {n: a.shape for n, a in _np(tv).items()} == {
        n: a.shape for n, a in _np(model.init()).items()}
    batch = _batch(jmodel.config, n_out, 3)
    want = np.asarray(jax.jit(lambda v, x: _jax_output(jmodel, v, x))(
        v, batch["features"]))
    got = _output(model, tv, batch["features"]).numpy()
    assert got.shape == want.shape == _out_shape(jmodel.config, n_out)
    _close({"out": got}, {"out": want})
    jloss = jax.jit(lambda v, b: jmodel.loss_fn(v["params"], v["state"],
                                                b)[0])(v, batch)
    with torch.no_grad():
        loss = model.loss_fn(tv["params"], tv["state"],
                             batch_to_device(batch, "cpu"))[0]
        v64 = tree_map(torch.Tensor.double, tv)
        loss64 = model.loss_fn(v64["params"], v64["state"], tree_map(
            torch.Tensor.double, batch_to_device(batch, "cpu")))[0]
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    assert float(loss) == pytest.approx(float(loss64), rel=TOL)


@pytest.mark.parametrize("name,n_params", [
    ("xception", 22_855_952), ("unet", 7_846_657), ("squeezenet", 1_235_496),
    ("darknet19", 20_842_376), ("simplecnn", 608_090),
    ("tiny_yolo", 15_861_773), ("yolo2", 67_445_065)])
def test_full_size_variables_are_the_jax_packages(name, n_params):
    want = jax.eval_shape(lambda: jax_zoo.get_model(name).init())
    want = {n: (tuple(a.shape), str(a.dtype))
            for n, a in flatten_with_names(want)}
    model = zoo.get_model(name, device="cpu")
    v = model.init()
    got = {n: (tuple(a.shape), str(a.dtype)[len("torch."):])
           for n, a in flatten_with_names(v)}
    assert got == want
    assert model.num_params(v) == n_params


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "vgg19"])
def test_large_classic_parameter_counts(name):
    """AlexNet 62,378,344, VGG16 138,357,544, VGG19 143,667,240 at full
    size, from the layers' shapes (no draw)."""
    want = {"alexnet": 62_378_344, "vgg16": 138_357_544,
            "vgg19": 143_667_240}[name]
    model = zoo.get_model(name, device="cpu")
    total = 0
    for i, (lname, layer) in enumerate(model.named_layers()):
        cin, cout = model.shapes[i][-1], model.shapes[i + 1][-1]
        if isinstance(layer, layers.Conv2D):
            total += layer.kernel ** 2 * cin * cout + cout
        elif isinstance(layer, layers.Dense):
            total += cin * cout + cout
    jmodel = jax_zoo.get_model(name)
    assert model.shapes == jmodel.shapes
    assert total == want == jmodel.num_params(jax.eval_shape(jmodel.init))


@pytest.mark.parametrize("name", ["unet", "squeezenet", "tiny_yolo",
                                  "yolo2"])
def test_summary_is_the_jax_packages(name):
    kw, _ = ZOO_CASES[name]
    jmodel = jax_zoo.get_model(name, **kw)
    v = _variables(jmodel)
    model = zoo.get_model(name, device="cpu", **kw)
    assert model.summary(ckpt.variables_from_numpy(v)) == jmodel.summary(v)
    assert model.summary() == jmodel.summary()


def test_sequential_summary_is_the_jax_packages():
    kw, _ = ZOO_CASES["simplecnn"]
    jmodel = jax_zoo.get_model("simplecnn", **kw)
    v = _variables(jmodel)
    model = zoo.get_model("simplecnn", device="cpu", **kw)
    assert model.summary(ckpt.variables_from_numpy(v)) == jmodel.summary(v)
    v = model.init()
    assert model.summary(v).endswith(f"total params: {model.num_params(v)}")


# --- U-Net: gradients, Adam, checkpoints ------------------------------------


@pytest.fixture(scope="module")
def unet_jax():
    return JaxGraphModel(jax_zoo.unet_config(**UNET, updater=JaxAdam(LR)))


@pytest.fixture(scope="module")
def unet_vars(unet_jax):
    return _variables(unet_jax)


def _unet_port():
    return GraphModel(zoo.unet_config(**UNET, updater=Adam(LR)),
                      device="cpu")


def _unet_batch(seed):
    return _batch(zoo.unet_config(**UNET), 1, seed, n=4)


@pytest.mark.parametrize("masked", [False, True])
def test_unet_loss_and_every_gradient_match_jax(unet_jax, unet_vars,
                                                masked):
    batch = _unet_batch(4)
    if masked:
        batch["mask"] = (np.random.default_rng(5).random((4, 32, 32)) <
                         0.6).astype(np.float32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, s, b: unet_jax.loss_fn(p, s, b), has_aux=True))(
        unet_vars["params"], unet_vars["state"], batch)
    trainer = Trainer(_unet_port())
    tv = ckpt.variables_from_numpy(unet_vars)
    loss, _, _, grads = trainer._grad_of(
        tv["params"], tv["state"], batch_to_device(batch, "cpu"), None)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    _grads_close(_np(grads), _np(jgrads))


@pytest.fixture(scope="module")
def unet_two_steps(unet_jax, unet_vars):
    trainer = JaxTrainer(unet_jax)
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, unet_vars))
    states, losses = [], []
    for b in (_unet_batch(6), _unet_batch(7)):
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        states.append(jax.tree_util.tree_map(
            lambda x: jax.random.wrap_key_data(np.array(
                jax.random.key_data(x))) if jax.dtypes.issubdtype(
                x.dtype, jax.dtypes.prng_key) else np.array(x), ts))
    return trainer, states, losses


# Adam moves an entry by about lr·sign(g) on its first steps, so an entry
# whose gradient is at rounding level may differ by up to 2·lr; at most
# MAX_SIGN_FLIPS of the entries may differ by more than TOL_ADAM.
TOL_ADAM = 1e-5
MAX_SIGN_FLIPS = 0.002


def test_unet_two_adam_steps_match_the_jax_trainer(unet_vars,
                                                   unet_two_steps):
    _, states, jlosses = unet_two_steps
    trainer = Trainer(_unet_port())
    ts = trainer.init_state(unet_vars)
    for k, b in enumerate((_unet_batch(6), _unet_batch(7))):
        ts, m = trainer.train_step(ts, b)
        assert ts.step == k + 1
        assert float(m["total_loss"]) == pytest.approx(jlosses[k], rel=TOL)
        got, want = _np(ts.params), _np(states[k].params)
        flips = total = 0
        for n, w in want.items():
            err = np.abs(got[n] - w)
            assert err.max() <= 2 * LR, (k, n)
            flips += int((err > TOL_ADAM).sum())
            total += w.size
        assert flips <= MAX_SIGN_FLIPS * total, (k, flips, total)


def test_unet_checkpoints_cross_both_ways(unet_jax, unet_vars,
                                          unet_two_steps, tmp_path):
    jtrainer, states, jlosses = unet_two_steps
    path = jax_ckpt.save_checkpoint(tmp_path / "jax", states[0],
                                    model=unet_jax)
    trainer = Trainer(_unet_port())
    ts = ckpt.restore_checkpoint(path, trainer.init_state(unet_vars))
    want = _np({"p": states[0].params, "o": states[0].opt_state})
    got = _np({"p": ts.params, "o": ts.opt_state})
    assert ts.step == 1 and got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    _, m = trainer.train_step(ts, _unet_batch(7))
    assert float(m["total_loss"]) == pytest.approx(jlosses[1], rel=TOL)
    out = ckpt.save_checkpoint(tmp_path / "port", ts, model=trainer.model)
    template = jtrainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, unet_vars))
    restored = jax_ckpt.restore_checkpoint(out, template)
    back = _np({"p": restored.params, "o": restored.opt_state})
    for n in got:
        np.testing.assert_array_equal(back[n], got[n], err_msg=n)
    cfg = jax_ckpt.load_model_config(out)
    assert list(cfg.vertices) == list(unet_jax.config.vertices)
    assert type(cfg.vertices["output"].layer).__name__ == "PixelOutput"


# --- Xception gradients --------------------------------------------------


def _entry_cut(cfg, pkg_config, pkg_layers, num_classes):
    """The stem and first entry block of an ``xception_config``, with a
    pooled softmax head on ``e1_add``."""
    v = {n: vx for n, vx in cfg.vertices.items()
         if n.startswith(("stem", "e1_"))}
    v["gap"] = pkg_config.GraphVertex(
        kind="layer", inputs=["e1_add"],
        layer=pkg_layers.GlobalPooling(pool_type="avg"))
    v["output"] = pkg_config.GraphVertex(
        kind="layer", inputs=["gap"],
        layer=pkg_layers.OutputLayer(units=num_classes))
    return pkg_config.GraphConfig(net=cfg.net, inputs=cfg.inputs,
                                  input_shapes=cfg.input_shapes,
                                  vertices=v, outputs=["output"])


def _gradient_check(jmodel, model, n_out, seed, per_leaf_max=True):
    """Loss, BatchNorm state and every gradient of one step against the
    JAX package's: the gradients per leaf to TOL_GRAD of its max, or
    (``per_leaf_max=False``, full Xception) by relative L2 error, since
    48 BatchNorm-ReLU layers at a batch of 4 carry float32 rounding into
    whole tenths of a percent of a leaf (the JAX package's own gradients
    lie up to 4.5e-3 from float64 per leaf there, the port's 1.7e-4):
    each leaf to TOL_L2_F64 of the port's float64 copy and to TOL_L2_JAX
    of the JAX package's."""
    v = _variables(jmodel)
    batch = _batch(jmodel.config, n_out, seed)
    (jloss, (jstate, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jmodel.loss_fn(p, s, b), has_aux=True))(
        v["params"], v["state"], batch)
    tv = ckpt.variables_from_numpy(v)
    trainer = Trainer(model)
    loss, state, _, grads = trainer._grad_of(
        tv["params"], tv["state"], batch_to_device(batch, "cpu"), None)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    got, want = _np(state), _np(jstate)
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL * max(1.0, np.abs(w).max())
    if per_leaf_max:
        _grads_close(_np(grads), _np(jgrads))
        return
    v64 = tree_map(torch.Tensor.double, tv)
    _, _, _, g64 = trainer._grad_of(
        v64["params"], v64["state"],
        tree_map(torch.Tensor.double, batch_to_device(batch, "cpu")), None)
    g32, j32 = _np(grads), _np(jgrads)
    for n, w in flatten_with_names(g64):
        w = w.numpy()
        norm = max(np.linalg.norm(w), 1e-30)
        assert np.linalg.norm(g32[n] - w) / norm <= TOL_L2_F64, n
        assert np.linalg.norm(g32[n] - j32[n]) / norm <= TOL_L2_JAX, n


TOL_L2_F64 = 1e-3
TOL_L2_JAX = 1e-2


def test_xception_entry_block_gradients_match_jax():
    """Tier-1's Xception gradient check: the stem (two conv + BatchNorm
    relu) and the first entry block (two separable convs, the SAME max
    pool, the 1×1 stride-2 shortcut and the add) at 71×71."""
    kw = ZOO_CASES["xception"][0]
    jcfg = _entry_cut(jax_zoo.xception_config(**kw), jax_config, jax_layers,
                      5)
    cfg = _entry_cut(zoo.xception_config(**kw), nnconfig, layers, 5)
    assert nnconfig.config_to_dict(cfg) == nnconfig.config_to_dict(
        nnconfig.config_from_json(jcfg.to_json()))
    _gradient_check(JaxGraphModel(jcfg), GraphModel(cfg, device="cpu"), 5, 8)


@pytest.mark.slow
def test_xception_one_step_gradients_match_jax():
    kw = ZOO_CASES["xception"][0]
    _gradient_check(jax_zoo.get_model("xception", **kw),
                    zoo.get_model("xception", device="cpu", **kw), 5, 9,
                    per_leaf_max=False)


def test_served_unet_answers_masks_like_output_single(unet_vars):
    """A rank-4 output served by ModelServer → ModelRegistry →
    ParallelInference (batched, buckets up to 4 rows) to concurrent
    clients: each mask [n, 32, 32, 1] against ``output_single``."""
    from concurrent.futures import ThreadPoolExecutor

    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    model = _unet_port()
    params = ckpt.variables_from_numpy(unet_vars)
    reg = ModelRegistry()
    reg.register("unet", lambda v, x: model.output_single(v, x), params,
                 input_spec=spec((32, 32, 3), np.float32), mode="batched",
                 max_batch_size=4, devices=["cpu"])
    srv = ModelServer(reg, port=0)
    srv.start(warm=True)
    try:
        client = ServingClient(srv.url, timeout=60)
        reqs = [_unet_batch(40 + i)["features"][:1 + i % 3]
                for i in range(6)]
        with ThreadPoolExecutor(3) as pool:
            resps = list(pool.map(
                lambda r: client.predict("unet", r.tolist()), reqs))
    finally:
        srv.stop()
    for req, resp in zip(reqs, resps):
        got = np.asarray(resp["outputs"], np.float32)
        assert got.shape == (req.shape[0], 32, 32, 1)
        want = model.output_single(params, req).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
