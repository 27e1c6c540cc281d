"""ResNet (``GraphModel`` of conv, BatchNorm and add vertices) in the port against the JAX package, on the CPU.

A small ResNet, ``resnet_config(blocks=(1, 1), input_shape=(32, 32, 3),
num_classes=10)`` (every vertex kind and layer of ResNet-50, the stride-2
stages and projections included), built in both packages from the same
numpy variables (the JAX package's init, BatchNorm running state moved off
its initial values) and fed the same batches: the ``GraphConfig`` JSON
both ways, the forward in training and inference, the loss, every
gradient and the BatchNorm state, two Adam steps of the Trainer, mixed
precision, checkpoints across, and the model served by ``ModelServer``.
Full ResNet-50: the variables tree's names, shapes and count against
``jax.eval_shape`` of the JAX init. Tolerances: float32 on both sides,
sums in another order — outputs and the loss to 1e-5, each gradient leaf
to 1e-4 of its max |gradient|, BatchNorm state to 1e-5 of max(1, |JAX|).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import resnet as jax_resnet
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.nn.model import GraphModel as JaxGraphModel
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.models.zoo import get_model
from deeplearning4j_tpu_torch.models.zoo.resnet import resnet_config
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.nn.model import GraphModel
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

SMALL = dict(blocks=(1, 1), input_shape=(32, 32, 3), num_classes=10)
N = 4
LR = 1e-3
TOL = 1e-5
TOL_GRAD = 1e-4
# bf16 compute against float32 / against the JAX package's bf16: the loss
# of a freshly initialised net moves by a few bf16 ulps
TOL_MIXED_REL = 2e-2


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
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(got[n] - w).max() <= tol * scale, n


def _batch(seed):
    r = np.random.default_rng(seed)
    return {"features": r.standard_normal((N, 32, 32, 3), dtype=np.float32),
            "labels": np.eye(10, dtype=np.float32)[r.integers(0, 10, N)]}


def _port(**kw):
    return GraphModel(resnet_config(**SMALL, **kw), device="cpu")


@pytest.fixture(scope="module")
def jax_model():
    return JaxGraphModel(jax_resnet.resnet_config(**SMALL,
                                                  updater=JaxAdam(LR)))


@pytest.fixture(scope="module")
def variables(jax_model):
    """The JAX package's init as numpy, with running statistics that are
    not the initial zeros and ones (so inference reads them)."""
    v = jax.tree_util.tree_map(np.array, jax.jit(
        lambda: jax_model.init(seed=1))())
    r = np.random.default_rng(2)
    for s in v["state"].values():
        s["mean"] = (0.1 * r.standard_normal(s["mean"].shape)).astype(
            np.float32)
        s["var"] = (1.0 + r.random(s["var"].shape)).astype(np.float32)
    return v


def test_graph_config_json_order_and_shapes_cross_both_ways(jax_model):
    model = _port(updater=Adam(LR))
    assert model.order == jax_model.order
    assert model.shapes == {k: tuple(s) for k, s in jax_model.shapes.items()}
    assert model.shapes["stem_pool"] == (8, 8, 64)
    assert model.shapes["s1b0_relu"] == (4, 4, 512)
    back = nnconfig.GraphConfig.from_json(jax_model.config.to_json())
    assert nnconfig.config_to_dict(back) == nnconfig.config_to_dict(
        model.config)
    jcfg = jax_config.GraphConfig.from_json(model.config.to_json())
    assert jax_config.config_to_dict(jcfg) == jax_config.config_to_dict(
        jax_model.config)
    assert JaxGraphModel(jcfg).order == model.order
    want = {n: a.shape for n, a in flatten_with_names(
        jax.eval_shape(jax_model.init))}
    v = model.init()
    got = {n: tuple(a.shape) for n, a in flatten_with_names(v)}
    assert got == want
    assert all(a.dtype == torch.float32
               for _, a in flatten_with_names(v["state"]))


def test_full_resnet50_variables_are_the_jax_packages():
    want = jax.eval_shape(
        lambda: jax_resnet.resnet50(num_classes=1000).init())
    want = {n: (tuple(a.shape), str(a.dtype))
            for n, a in flatten_with_names(want)}
    model = get_model("resnet50", device="cpu")
    v = model.init()
    got = {n: (tuple(a.shape), str(a.dtype)[len("torch."):])
           for n, a in flatten_with_names(v)}
    assert got == want
    assert model.num_params(v) == 25_557_032
    assert {"params/stem_conv/W", "params/s0b0_a_bn/gamma",
            "state/s3b2_c_bn/var", "params/output/W"} <= set(got)
    assert model.shapes["output"] == (1000,)
    # He init over the HWIO fan-in, as the net's weight_init names
    w = v["params"]["s2b0_b_conv"]["W"]
    assert abs(float(w.std()) / np.sqrt(2 / (9 * 256)) - 1) < 0.02


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(jax_model, variables, train):
    batch = _batch(3)
    model = _port()
    tv = ckpt.variables_from_numpy(variables)
    out, new_state = jax.jit(lambda v, x: jax_model.apply(
        v, x, train=train))(variables, batch["features"])
    got, got_state = model.apply(tv, torch.from_numpy(batch["features"]),
                                 train=train)
    assert got.keys() == {"output"}
    _close(_np(got), _np(out))
    _close(_np(got_state), _np(new_state))
    if not train:
        single = model.output_single(tv, batch["features"])
        np.testing.assert_allclose(single.numpy(),
                                   np.asarray(out["output"]), atol=TOL)
        acts, _ = model.feed_forward(tv, torch.from_numpy(
            batch["features"]))
        assert tuple(acts["s0b0_add"].shape) == (N, 8, 8, 256)


def test_loss_every_gradient_and_bn_state_match_jax(jax_model, variables):
    batch = _batch(4)
    (jloss, (jstate, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jax_model.loss_fn(p, s, b), has_aux=True))(
        variables["params"], variables["state"], batch)
    trainer = Trainer(_port())
    tv = ckpt.variables_from_numpy(variables)
    loss, state, metrics, grads = trainer._grad_of(
        tv["params"], tv["state"], batch_to_device(batch, "cpu"), None)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    assert float(metrics["loss/output"]) == pytest.approx(
        float(jmetrics["loss/output"]), rel=TOL)
    assert all(not a.requires_grad for _, a in flatten_with_names(state))
    _close(_np(state), _np(jstate))
    got, want = _np(grads), _np(jgrads)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        scale = max(np.abs(w).max(), 1e-4 * top)
        assert np.abs(got[n] - w).max() <= TOL_GRAD * scale, n


@pytest.fixture(scope="module")
def jax_two_steps(jax_model, variables):
    """The JAX package's Trainer, two jitted Adam steps: copies of the
    state after each and the losses."""
    trainer = JaxTrainer(jax_model)
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
    states, losses = [], []
    for b in (_batch(6), _batch(7)):
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        states.append(jax.tree_util.tree_map(
            lambda x: jax.random.wrap_key_data(np.array(
                jax.random.key_data(x))) if jax.dtypes.issubdtype(
                x.dtype, jax.dtypes.prng_key) else np.array(x), ts))
    return trainer, states, losses


# Adam moves an entry by about lr·sign(g) on its first steps, so an entry
# whose gradient is at rounding level may differ by up to 2·lr (as in the
# char-RNN tests); at most MAX_SIGN_FLIPS of the entries may differ by
# more than TOL_ADAM. Such a flip changes the next step's activations, and
# BatchNorm carries that into every statistic, so each step starts from
# the JAX package's state before it (restored from its checkpoint).
TOL_ADAM = 1e-5
MAX_SIGN_FLIPS = 0.002


def test_two_adam_steps_match_the_jax_trainer(jax_model, variables,
                                              jax_two_steps, tmp_path):
    _, states, jlosses = jax_two_steps
    trainer = Trainer(_port(updater=Adam(LR)))
    ts = trainer.init_state(variables)
    for k, b in enumerate((_batch(6), _batch(7))):
        if k:
            ts = ckpt.restore_checkpoint(jax_ckpt.save_checkpoint(
                tmp_path / str(k), states[k - 1], model=jax_model), ts)
        ts, m = trainer.train_step(ts, b)
        assert ts.step == k + 1
        assert float(m["total_loss"]) == pytest.approx(jlosses[k], rel=TOL)
        _close(_np(ts.model_state), _np(states[k].model_state))
        got, want = _np(ts.params), _np(states[k].params)
        assert got.keys() == want.keys()
        flips = total = 0
        for n, w in want.items():
            err = np.abs(got[n] - w)
            assert err.max() <= 2 * LR, (k, n)
            flips += int((err > TOL_ADAM).sum())
            total += w.size
        assert flips <= MAX_SIGN_FLIPS * total, (k, flips, total)


def test_checkpoints_cross_both_ways(jax_model, variables, jax_two_steps,
                                     tmp_path):
    jtrainer, states, jlosses = jax_two_steps
    path = jax_ckpt.save_checkpoint(tmp_path / "jax", states[0],
                                    model=jax_model)
    trainer = Trainer(_port(updater=Adam(LR)))
    ts = ckpt.restore_checkpoint(path, trainer.init_state(variables))
    want = _np({"p": states[0].params, "s": states[0].model_state,
                "o": states[0].opt_state})
    got = _np({"p": ts.params, "s": ts.model_state, "o": ts.opt_state})
    assert ts.step == 1 and got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    _, m = trainer.train_step(ts, _batch(7))
    assert float(m["total_loss"]) == pytest.approx(jlosses[1], rel=TOL)
    served = ckpt.load_inference_variables(path, trainer.model)
    for n, a in _np(served["state"]).items():
        np.testing.assert_array_equal(a, want[f"s/{n}"], err_msg=n)
    out = ckpt.save_checkpoint(tmp_path / "port", ts, model=trainer.model)
    template = jtrainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, variables))
    restored = jax_ckpt.restore_checkpoint(out, template)
    back = _np({"p": restored.params, "s": restored.model_state,
                "o": restored.opt_state})
    for n in got:
        np.testing.assert_array_equal(back[n], got[n], err_msg=n)
    cfg = jax_ckpt.load_model_config(out)
    assert list(cfg.vertices) == list(jax_model.config.vertices)


def test_mixed_precision_keeps_float32_state_and_tracks_jax(jax_model,
                                                            variables):
    """bf16 compute: params and features cast, BatchNorm's running
    statistics float32, computed in float32 from the bf16 activation;
    the loss against the JAX package's mixed-precision step."""
    jcfg = jax_resnet.resnet_config(**SMALL, updater=JaxAdam(LR))
    jcfg.net.mixed_precision = True
    jtrainer = JaxTrainer(JaxGraphModel(jcfg))
    jts = jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
    jts, jm = jtrainer.train_step(jts, _batch(8))
    model = _port(updater=Adam(LR))
    model.net.mixed_precision = True
    trainer = Trainer(model)
    ts = trainer.init_state(variables)
    ts, m = trainer.train_step(ts, _batch(8))
    assert all(a.dtype == torch.float32
               for _, a in flatten_with_names((ts.params, ts.model_state)))
    assert float(m["total_loss"]) == pytest.approx(
        float(jm["total_loss"]), rel=TOL_MIXED_REL)
    got, want = _np(ts.model_state), _np(jts.model_state)
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL_MIXED_REL * max(
            1.0, np.abs(w).max()), n


@pytest.mark.parametrize("kind", ["add", "subtract", "mul", "average", "max",
                                  "min", "merge"])
def test_merge_vertices_match_jax(kind):
    def cfg(pkg_config, pkg_layers):
        v = {"a": pkg_config.GraphVertex(
                kind="layer", inputs=["x"],
                layer=pkg_layers.Dense(units=6, activation="tanh")),
             "b": pkg_config.GraphVertex(
                kind="layer", inputs=["x"],
                layer=pkg_layers.Dense(units=6, activation="relu")),
             "m": pkg_config.GraphVertex(kind=kind, inputs=["a", "b"]),
             "out": pkg_config.GraphVertex(
                kind="layer", inputs=["m"],
                layer=pkg_layers.OutputLayer(units=3))}
        return pkg_config.GraphConfig(
            net=pkg_config.NeuralNetConfiguration(seed=0), inputs=["x"],
            input_shapes={"x": (5,)}, vertices=v, outputs=["out"])

    jm = JaxGraphModel(cfg(jax_config, jax_layers))
    pm = GraphModel(cfg(nnconfig, layers), device="cpu")
    assert pm.shapes == {k: tuple(s) for k, s in jm.shapes.items()}
    v = jax.tree_util.tree_map(np.array, jm.init())
    x = np.random.default_rng(9).standard_normal((4, 5), dtype=np.float32)
    want = np.asarray(jm.output_single(v, x))
    got = pm.output_single(ckpt.variables_from_numpy(v), x)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("kind", ["subset", "l2norm", "reshape",
                                  "last_timestep", "scale"])
def test_unported_vertex_kinds_are_refused_by_name(kind):
    """These arg-taking kinds, once refused, now build and answer like the
    JAX package's (every kind: tests/test_torch_attention_layers.py); an
    unknown kind is refused by name, and a layer vertex with two inputs
    whose layer is single-input is refused."""
    args = {"subset": {"from": 1, "to": 3}, "l2norm": {},
            "reshape": {"shape": [5, 1]}, "last_timestep": {},
            "scale": {"factor": 2.5}}[kind]
    shape = (4, 5) if kind == "last_timestep" else (5,)

    def cfg(pkg_config, pkg_layers, vkind=kind):
        v = {"a": pkg_config.GraphVertex(kind=vkind, inputs=["x"],
                                         args=args),
             "out": pkg_config.GraphVertex(
                 kind="layer", inputs=["a"],
                 layer=pkg_layers.OutputLayer(units=3))}
        return pkg_config.GraphConfig(
            net=pkg_config.NeuralNetConfiguration(seed=0), inputs=["x"],
            input_shapes={"x": shape}, vertices=v, outputs=["out"])

    jm = JaxGraphModel(cfg(jax_config, jax_layers))
    pm = GraphModel(cfg(nnconfig, layers), device="cpu")
    assert pm.shapes == {k: tuple(s) for k, s in jm.shapes.items()}
    v = jax.tree_util.tree_map(np.array, jm.init())
    x = np.random.default_rng(9).standard_normal((4, *shape),
                                                 dtype=np.float32)
    np.testing.assert_allclose(
        pm.output_single(ckpt.variables_from_numpy(v), x).numpy(),
        np.asarray(jm.output_single(v, x)), atol=TOL)
    with pytest.raises(ValueError, match="'nonsense'"):
        GraphModel(cfg(nnconfig, layers, "nonsense"), device="cpu")
    bad = cfg(nnconfig, layers)
    bad.vertices["a"] = nnconfig.GraphVertex(kind="layer", inputs=["x", "x"],
                                             layer=layers.Dense(units=3))
    with pytest.raises(ValueError, match="multi-input"):
        GraphModel(bad, device="cpu")


def _probs(model, variables, images):
    """The served function: NHWC float images → softmax probabilities."""
    return model.output_single(variables, images)


def test_served_resnet_answers_like_output(variables):
    """Served by ModelServer → ModelRegistry → ParallelInference (batched,
    buckets up to 4 rows) to concurrent clients, against ``output``."""
    model = _port()
    params = ckpt.variables_from_numpy(variables)
    reg = ModelRegistry()
    reg.register("resnet", functools.partial(_probs, model), params,
                 input_spec=spec((32, 32, 3), np.float32), mode="batched",
                 max_batch_size=4, devices=["cpu"])
    srv = ModelServer(reg, port=0)
    srv.start(warm=True)
    try:
        client = ServingClient(srv.url, timeout=60)
        reqs = [np.random.default_rng(30 + i).standard_normal(
            (1 + i % 2, 32, 32, 3), dtype=np.float32) for i in range(8)]
        with ThreadPoolExecutor(4) as pool:
            resps = list(pool.map(
                lambda r: client.predict("resnet", r.tolist()), reqs))
    finally:
        srv.stop()
    for req, resp in zip(reqs, resps):
        got = np.asarray(resp["outputs"], np.float32)
        want = model.output_single(params, req)
        assert got.shape == (req.shape[0], 10)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
