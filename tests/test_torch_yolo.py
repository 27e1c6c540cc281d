"""The port's YOLO family against the JAX package's, on the CPU.

``deeplearning4j_tpu_torch/models/zoo/yolo.py`` held against
``deeplearning4j_tpu/models/zoo/yolo.py`` from seeded numpy inputs:

- ``Yolo2OutputLayer``: ``apply``, ``compute_loss`` (plain mean, with
  ``mask``, with ``weights``) and the loss's gradient with respect to the
  feature map, to 1e-5 of the largest value; the wh logits set to exactly
  ±8 at every object cell, where ``jnp.clip``'s gradient is 0.5 (the
  port's ``minimum(maximum(·))``, not ``torch.clamp``'s 1), entry for
  entry; an empty grid is the no-object term alone.
- ``decode_predictions`` where scores tie exactly (the planted box of
  ``tests/test_yolo.py``, every other cell at −8; class logits drawn from
  a few whole vectors) and on random maps: every position's box, score
  and class the JAX package's (``jax.lax.top_k`` puts the lower index
  first among ties).
- ``non_max_suppression`` equal to the JAX package's and to a numpy
  brute-force greedy sweep in stable score order, tied scores included.
- ``make_yolo_labels``: a centre at 1.0, two objects in one cell.
- The zoo entries: config JSON both ways; YOLOv2 at 64² (2×2 grid, 4
  classes): the forward (inference BatchNorm) to 1e-5 of its max, the
  train-mode feature map (``head_out``) against the port's float64 copy
  beside the JAX package's own float32 error, and the loss from each
  package's feature map through the other's layer (see
  ``test_yolo2_forward_train_features_and_loss_match_jax``); Tiny-YOLO at
  64²: every gradient leaf, two Adam steps of the ``Trainer`` against the
  JAX package's, checkpoints across both ways and a served Tiny-YOLO
  answering like ``output``. ``tests/test_torch_zoo_cnn.py`` holds the
  rest (``ZOO_CASES``: forward and loss, ``summary()``, full-size
  variable trees).
"""

from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo_cnn import (
    LR,
    MAX_SIGN_FLIPS,
    TOL_ADAM,
    ZOO_CASES,
    _batch,
    _gradient_check,
    _np,
    _variables,
)

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.models.zoo import yolo as jyolo
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.nn.model import GraphModel as JaxGraphModel
from deeplearning4j_tpu.nn.model import SequentialModel as JaxSequentialModel
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.zoo import yolo
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn.model import GraphModel, SequentialModel
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import tree_map

TOL = 1e-5
C = 4          # classes
B = len(yolo.TINY_YOLO_ANCHORS)
GRID = (4, 5)  # the layer tests' grid (rows, columns)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _objects(r, n, k_max=3):
    """1–k_max boxes an image: (cx, cy, w, h, cls), w and h in [0.1, 0.4]."""
    return [[(float(r.uniform(0.05, 0.95)), float(r.uniform(0.05, 0.95)),
              float(r.uniform(0.1, 0.4)), float(r.uniform(0.1, 0.4)),
              int(r.integers(0, C)))
             for _ in range(int(r.integers(1, k_max + 1)))] for _ in range(n)]


def _labels(seed, n=3):
    r = np.random.default_rng(seed)
    return yolo.make_yolo_labels(_objects(r, n), grid=GRID, num_classes=C)


def _features(seed, n=3, scale=2.0):
    r = np.random.default_rng(seed)
    return (scale * r.standard_normal((n, *GRID, B * (5 + C)))).astype(
        np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(float(np.abs(want).max()),
                                                 1e-30)


def _jax_loss_and_grad(layer, x, labels, **kw):
    kw = {k: jnp.asarray(v) for k, v in kw.items()}
    return jax.jit(jax.value_and_grad(
        lambda x: layer.compute_loss({}, {}, x, jnp.asarray(labels), **kw)))(
        jnp.asarray(x))


def _port_loss_and_grad(layer, x, labels, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    loss = layer.compute_loss({}, {}, xt, torch.from_numpy(labels),
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    grad, = torch.autograd.grad(loss, xt)
    return float(loss.detach()), grad.numpy()


# --- the output layer ------------------------------------------------------


@pytest.mark.parametrize("weighting", ["none", "mask", "weights"])
def test_layer_apply_loss_and_gradient_match_jax(weighting):
    jl = jyolo.Yolo2OutputLayer(num_classes=C)
    tl = yolo.Yolo2OutputLayer(num_classes=C)
    x, labels = _features(1), _labels(2)
    kw = {"none": {}, "mask": {"mask": np.array([1, 0, 1], np.float32)},
          "weights": {"weights": np.array([0.5, 2.0, 1.0], np.float32)}
          }[weighting]
    want = np.asarray(jax.jit(lambda x: jl.apply({}, {}, x)[0])(x))
    got = tl.apply({}, {}, torch.from_numpy(x))[0].numpy()
    assert got.shape == (3, *GRID, B, 5 + C)
    _close(got, want)
    jloss, jgrad = _jax_loss_and_grad(jl, x, labels, **kw)
    loss, grad = _port_loss_and_grad(tl, x, labels, **kw)
    assert loss == pytest.approx(float(jloss), rel=TOL)
    _close(grad, jgrad)


def test_gradient_at_the_clip_bounds_is_jnp_clips():
    """Every object cell's wh logits at exactly +8 and −8 (all anchors,
    so the responsible one too): ``jnp.clip``'s gradient there is half
    the unclipped one, entry for entry in both packages."""
    jl = jyolo.Yolo2OutputLayer(num_classes=C)
    tl = yolo.Yolo2OutputLayer(num_classes=C)
    labels = _labels(3)
    x = _features(4).reshape(3, *GRID, B, 5 + C)
    cells = labels[..., 0] > 0
    x[cells, :, 2] = 8.0
    x[cells, :, 3] = -8.0
    x = x.reshape(3, *GRID, B * (5 + C))
    _, jgrad = _jax_loss_and_grad(jl, x, labels)
    _, grad = _port_loss_and_grad(tl, x, labels)
    _close(grad, jgrad)
    at = np.zeros((3, *GRID, B, 5 + C), bool)
    at[cells, :, 2:4] = True
    at = at.reshape(x.shape)
    jg, g = np.asarray(jgrad)[at], grad[at]
    assert np.count_nonzero(jg) >= np.count_nonzero(cells)
    np.testing.assert_allclose(g, jg, rtol=TOL, atol=0)
    # the same loss through torch.clamp passes twice the gradient there
    with mock.patch.object(yolo, "_clip", lambda v, lo, hi: torch.clamp(
            v, lo, hi)):
        _, clamped = _port_loss_and_grad(tl, x, labels)
    np.testing.assert_allclose(clamped[at], 2 * jg, rtol=TOL, atol=0)


def test_empty_grid_is_the_no_object_term():
    tl = yolo.Yolo2OutputLayer(num_classes=C)
    jl = jyolo.Yolo2OutputLayer(num_classes=C)
    x = np.zeros((1, 2, 2, B * (5 + C)), np.float32)
    labels = np.zeros((1, 2, 2, 5 + C), np.float32)
    want = 0.5 * 0.25 * (2 * 2 * B)   # λ_noobj · sigmoid(0)² · cells · B
    got = float(tl.compute_loss({}, {}, torch.from_numpy(x),
                                torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=TOL)
    assert got == pytest.approx(float(jl.compute_loss(
        {}, {}, jnp.asarray(x), jnp.asarray(labels))), rel=TOL)


def test_output_shape_asserts_the_channels():
    layer = yolo.Yolo2OutputLayer(num_classes=C)
    assert layer.output_shape((2, 3, B * (5 + C))) == (2, 3, B, 5 + C)
    with pytest.raises(AssertionError, match="feature channels"):
        layer.output_shape((2, 3, B * (5 + C) + 1))
    assert layer.init(None, (2, 3, B * (5 + C)), torch.float32) == ({}, {})


# --- decode and NMS ---------------------------------------------------------


def _planted(gh=2, gw=2):
    """tests/test_yolo.py's planted box: cell (1, 0), anchor 2, class 3,
    every other logit −8 (all other scores tie exactly)."""
    feat = np.full((1, gh, gw, B, 5 + C), -8.0, np.float32)
    feat[0, 1, 0, 2, 0:4] = 0.0
    feat[0, 1, 0, 2, 4] = 8.0
    feat[0, 1, 0, 2, 5 + 3] = 8.0
    return feat.reshape(1, gh, gw, B * (5 + C))


def _tied(seed, n=3):
    """Feature maps whose scores tie often and exactly: each (cell,
    anchor) takes its confidence logit from 3 values and its class
    logits from 3 whole vectors."""
    r = np.random.default_rng(seed)
    x = _features(seed, n).reshape(n, *GRID, B, 5 + C)
    x[..., 4] = r.choice([-1.0, 0.5, 2.0], size=x.shape[:-1])
    vectors = r.standard_normal((3, C)).astype(np.float32)
    x[..., 5:] = vectors[r.integers(0, 3, size=x.shape[:-1])]
    return x.reshape(n, *GRID, B * (5 + C))


def _decode_both(x, top_k):
    jl = jyolo.Yolo2OutputLayer(num_classes=C)
    tl = yolo.Yolo2OutputLayer(num_classes=C)
    jdec = jax.jit(lambda x: jl.apply({}, {}, x)[0])(x)
    want = [np.asarray(a) for a in jax.jit(
        lambda d: jyolo.decode_predictions(d, top_k=top_k))(jdec)]
    tdec = tl.apply({}, {}, torch.from_numpy(x))[0]
    got = [a.numpy() for a in yolo.decode_predictions(tdec, top_k=top_k)]
    return got, want


def _assert_decode_equal(got, want):
    (boxes, scores, classes), (jboxes, jscores, jclasses) = got, want
    assert classes.dtype == jclasses.dtype == np.int32
    np.testing.assert_array_equal(classes, jclasses)
    np.testing.assert_allclose(boxes, jboxes, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scores, jscores, rtol=1e-6, atol=0)


@pytest.mark.parametrize("top_k", [3, 20])
def test_decode_keeps_the_jax_order_under_exact_ties(top_k):
    got, want = _decode_both(_planted(), top_k)
    _assert_decode_equal(got, want)
    boxes, scores, classes = got
    assert scores.shape == (1, top_k) and scores[0, 0] > 0.9
    assert classes[0, 0] == 3
    assert np.all(scores[0, 1:] == scores[0, 1])   # the ties
    aw, ah = yolo.TINY_YOLO_ANCHORS[2]
    x1, y1, x2, y2 = boxes[0, 0]
    np.testing.assert_allclose([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                                y2 - y1], [0.25, 0.75, aw / 2, ah / 2],
                               rtol=1e-5)


@pytest.mark.parametrize("seed,tied", [(5, False), (6, False), (7, True),
                                       (8, True)])
def test_decode_random_maps_match_jax(seed, tied):
    x = _tied(seed) if tied else _features(seed)
    got, want = _decode_both(x, 20)
    _assert_decode_equal(got, want)
    if tied:
        assert any(len(set(row)) < len(row) for row in got[1].tolist())


def _np_nms(bx, sc, thr):
    """Greedy NMS in stable descending-score order, box by box."""
    k = len(sc)
    keep, kept = np.zeros(k, np.float32), []
    for i in np.argsort(-sc, kind="stable"):
        ok = True
        for j in kept:
            xx1, yy1 = max(bx[i, 0], bx[j, 0]), max(bx[i, 1], bx[j, 1])
            xx2, yy2 = min(bx[i, 2], bx[j, 2]), min(bx[i, 3], bx[j, 3])
            inter = max(0, xx2 - xx1) * max(0, yy2 - yy1)
            a_i = (bx[i, 2] - bx[i, 0]) * (bx[i, 3] - bx[i, 1])
            a_j = (bx[j, 2] - bx[j, 0]) * (bx[j, 3] - bx[j, 1])
            if inter / max(a_i + a_j - inter, 1e-9) > thr:
                ok = False
                break
        if ok:
            keep[i] = 1
            kept.append(i)
    return keep


@pytest.mark.parametrize("tied", [False, True])
def test_nms_matches_jax_and_a_brute_force(tied):
    r = np.random.default_rng(9)
    n, k = 3, 16
    centres = r.uniform(0.3, 0.7, (n, k, 2))
    sizes = r.uniform(0.1, 0.3, (n, k, 2))
    boxes = np.concatenate([centres - sizes / 2, centres + sizes / 2],
                           -1).astype(np.float32)
    scores = (r.integers(1, 4, (n, k)) / 4 if tied else
              r.uniform(0.1, 1.0, (n, k))).astype(np.float32)
    want = np.asarray(jax.jit(lambda b, s: jyolo.non_max_suppression(
        b, s, iou_threshold=0.45))(boxes, scores))
    got = yolo.non_max_suppression(torch.from_numpy(boxes),
                                   torch.from_numpy(scores),
                                   iou_threshold=0.45).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(n):
        np.testing.assert_array_equal(got[i], _np_nms(boxes[i], scores[i],
                                                      0.45))
    assert 0 < got.sum() < n * k


def test_nms_of_decoded_boxes_matches_jax():
    got, want = _decode_both(_tied(10), 20)
    keep = yolo.non_max_suppression(torch.from_numpy(got[0]),
                                    torch.from_numpy(got[1])).numpy()
    jkeep = np.asarray(jyolo.non_max_suppression(jnp.asarray(want[0]),
                                                 jnp.asarray(want[1])))
    np.testing.assert_array_equal(keep, jkeep)


def test_make_yolo_labels_match_jax():
    objects = [[(1.0, 1.0, 0.3, 0.2, 1), (0.2, 0.2, 0.1, 0.1, 0),
                (0.21, 0.22, 0.2, 0.3, 2)],          # two in one cell
               [], [(0.5, 0.0, 0.4, 0.4, 3)]] + [
        o for o in _objects(np.random.default_rng(11), 3)]
    got = yolo.make_yolo_labels(objects, grid=GRID, num_classes=C)
    want = jyolo.make_yolo_labels(objects, grid=GRID, num_classes=C)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[0, GRID[0] - 1, GRID[1] - 1, 0] == 1.0   # cx = cy = 1.0
    assert got[0, 0, 1, 5:].tolist() == [1.0, 0.0, 1.0, 0.0]


# --- the zoo entries --------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("tiny_yolo", {}), ("yolo2", {}),
    ("tiny_yolo", ZOO_CASES["tiny_yolo"][0]),
    ("yolo2", dict(num_classes=7, input_shape=(96, 128, 3),
                   anchors=((1.0, 2.0), (3.0, 1.5))))])
def test_configs_cross_both_ways(name, kw):
    jcfg = getattr(jax_zoo, f"{name}_config")(**kw)
    cfg = getattr(zoo, f"{name}_config")(**kw)
    assert nnconfig.config_to_dict(nnconfig.config_from_json(
        jcfg.to_json())) == nnconfig.config_to_dict(cfg)
    back = jax_config.config_from_json(cfg.to_json())
    assert jax_config.config_to_dict(back) == jax_config.config_to_dict(jcfg)
    model = (GraphModel if name == "yolo2" else SequentialModel)(
        nnconfig.config_from_json(jcfg.to_json()), device="cpu")
    jmodel = (JaxGraphModel if name == "yolo2" else JaxSequentialModel)(jcfg)
    assert model.shapes == jmodel.shapes


def test_entries_run_on_the_card_unless_asked():
    with mock.patch("torch.cuda.is_available", return_value=False):
        for name in ("tiny_yolo", "yolo2"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                zoo.get_model(name)
            assert zoo.get_model(name, device="cpu").device.type == "cpu"
    assert set(jax_zoo.ZOO) == set(zoo.ZOO)


YOLO2_SMALL = dict(num_classes=C, input_shape=(64, 64, 3))


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_yolo2_forward_train_features_and_loss_match_jax():
    """YOLOv2 at 64²: the reorg/route graph's forward (inference
    BatchNorm) to 1e-5 of its max; one training forward (batch
    statistics) to the feature map the YOLO layer reads (``head_out``)
    against the port's float64 copy, no further from it than the JAX
    package's own float32 forward (or 1e-5 of its max); the loss from each
    package's feature map through the other package's layer to 1e-5.

    The two packages' training forwards are not held to each other at
    1e-5: 23 BatchNorms on batch statistics of 16–64 values a channel (the
    one-pass E[x²] − mean² of the JAX package) carry float32 rounding into
    whole 1e-5s of the feature map's max. The JAX package's own float32
    ``head_out`` lies 6.0e-5 of its max from the float64 copy here (its
    ``head2_bn`` 1.7e-4), the port's 2.7e-5; the loss, through ``exp`` of
    the wh logits, 4e-6–4.7e-5 relative for the JAX package over 64², 96²
    and 128² (the port's 1e-6–1.8e-5)."""
    jmodel = jax_zoo.get_model("yolo2", **YOLO2_SMALL)
    model = zoo.get_model("yolo2", device="cpu", **YOLO2_SMALL)
    v = _variables(jmodel)
    tv = ckpt.variables_from_numpy(v)
    batch = _batch(jmodel.config, C, 3)
    x = batch["features"]
    want = np.asarray(jax.jit(lambda v, x: jmodel.output_single(v, x))(v, x))
    got = model.output_single(tv, x).numpy()
    assert got.shape == (4, 2, 2, 5, 5 + C)
    _close(got, want)

    jfeat = np.array(jax.jit(lambda v, x: jmodel.feed_forward(
        v, x, train=True)[0]["head_out"])(v, x))
    with torch.no_grad():
        feat = model.feed_forward(tv, torch.from_numpy(x),
                                  train=True)[0]["head_out"]
        v64 = tree_map(torch.Tensor.double, tv)
        feat64 = model.feed_forward(v64, torch.from_numpy(x).double(),
                                    train=True)[0]["head_out"].numpy()
    assert _max_rel(feat.numpy(), feat64) <= max(TOL, _max_rel(jfeat,
                                                                feat64))

    jlayer = jmodel.config.vertices["yolo"].layer
    layer = model.config.vertices["yolo"].layer
    labels = batch["labels"]
    jloss = jax.jit(lambda f: jlayer.compute_loss({}, {}, f, labels))
    assert float(layer.compute_loss({}, {}, torch.from_numpy(jfeat),
                                    torch.from_numpy(labels))) == \
        pytest.approx(float(jloss(jfeat)), rel=TOL)
    loss_own = float(layer.compute_loss({}, {}, feat,
                                        torch.from_numpy(labels)))
    assert float(jloss(feat.numpy())) == pytest.approx(loss_own, rel=TOL)
    with torch.no_grad():
        loss = model.loss_fn(tv["params"], tv["state"],
                             batch_to_device(batch, "cpu"))[0]
    assert float(loss) == pytest.approx(loss_own, rel=1e-6)


TINY = ZOO_CASES["tiny_yolo"][0]


def test_tiny_yolo_every_gradient_leaf_matches_jax():
    _gradient_check(jax_zoo.get_model("tiny_yolo", **TINY),
                    zoo.get_model("tiny_yolo", device="cpu", **TINY), C, 8)


@pytest.fixture(scope="module")
def tiny_jax():
    return JaxSequentialModel(jax_zoo.tiny_yolo_config(
        **TINY, updater=JaxAdam(LR)))


@pytest.fixture(scope="module")
def tiny_vars(tiny_jax):
    return _variables(tiny_jax)


def _tiny_port():
    return SequentialModel(zoo.tiny_yolo_config(**TINY, updater=Adam(LR)),
                           device="cpu")


def _tiny_batch(seed):
    return _batch(zoo.tiny_yolo_config(**TINY), C, seed)


@pytest.fixture(scope="module")
def tiny_two_steps(tiny_jax, tiny_vars):
    trainer = JaxTrainer(tiny_jax)
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, tiny_vars))
    states, losses = [], []
    for b in (_tiny_batch(6), _tiny_batch(7)):
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        states.append(jax.tree_util.tree_map(
            lambda x: jax.random.wrap_key_data(np.array(
                jax.random.key_data(x))) if jax.dtypes.issubdtype(
                x.dtype, jax.dtypes.prng_key) else np.array(x), ts))
    return trainer, states, losses


def test_tiny_yolo_two_adam_steps_match_the_jax_trainer(tiny_jax, tiny_vars,
                                                        tiny_two_steps,
                                                        tmp_path):
    """Each step from the JAX package's state before it: the first from
    the shared init, the second from the JAX package's first step (params,
    BatchNorm state, Adam moments) restored from its checkpoint. Run on
    from its own first step, each package's second-batch loss (~19,000:
    Adam's first step moves every weight by lr, and the wh logits go
    through exp) parts by 1e-3 relative, through the weights whose
    rounding-level gradients flip sign (0.12% of them, under
    MAX_SIGN_FLIPS)."""
    _, states, jlosses = tiny_two_steps
    trainer = Trainer(_tiny_port())
    first = jax_ckpt.save_checkpoint(tmp_path / "jax", states[0],
                                     model=tiny_jax)
    starts = (trainer.init_state(tiny_vars),
              ckpt.restore_checkpoint(first, trainer.init_state(tiny_vars)))
    for k, (ts, b) in enumerate(zip(starts, (_tiny_batch(6),
                                             _tiny_batch(7)))):
        ts, m = trainer.train_step(ts, b)
        assert ts.step == k + 1
        assert float(m["total_loss"]) == pytest.approx(jlosses[k], rel=TOL)
        got, want = _np(ts.params), _np(states[k].params)
        flips = total = 0
        for n, w in want.items():
            err = np.abs(got[n] - w)
            # 2·lr: a sign flip of a rounding-level gradient (and the
            # rounding of the parameter, a BatchNorm gamma near 1)
            assert err.max() <= 2 * LR + TOL_ADAM, (k, n)
            flips += int((err > TOL_ADAM).sum())
            total += w.size
        assert flips <= MAX_SIGN_FLIPS * total, (k, flips, total)
        state, jstate = _np(ts.model_state), _np(states[k].model_state)
        for n, w in jstate.items():
            assert np.abs(state[n] - w).max() <= TOL * max(
                1.0, np.abs(w).max()), (k, n)


def test_tiny_yolo_checkpoints_cross_both_ways(tiny_jax, tiny_vars,
                                               tiny_two_steps, tmp_path):
    jtrainer, states, jlosses = tiny_two_steps
    path = jax_ckpt.save_checkpoint(tmp_path / "jax", states[0],
                                    model=tiny_jax)
    trainer = Trainer(_tiny_port())
    ts = ckpt.restore_checkpoint(path, trainer.init_state(tiny_vars))
    want = _np({"p": states[0].params, "s": states[0].model_state,
                "o": states[0].opt_state})
    got = _np({"p": ts.params, "s": ts.model_state, "o": ts.opt_state})
    assert ts.step == 1 and got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    _, m = trainer.train_step(ts, _tiny_batch(7))
    assert float(m["total_loss"]) == pytest.approx(jlosses[1], rel=TOL)
    out = ckpt.save_checkpoint(tmp_path / "port", ts, model=trainer.model)
    template = jtrainer.init_state(
        jax.tree_util.tree_map(jnp.asarray, tiny_vars))
    restored = jax_ckpt.restore_checkpoint(out, template)
    back = _np({"p": restored.params, "s": restored.model_state,
                "o": restored.opt_state})
    for n in got:
        np.testing.assert_array_equal(back[n], got[n], err_msg=n)
    cfg = jax_ckpt.load_model_config(out)
    assert type(cfg.layers[-1]).__name__ == "Yolo2OutputLayer"
    assert [list(a) for a in cfg.layers[-1].anchors] == [
        list(a) for a in yolo.TINY_YOLO_ANCHORS]


def test_served_tiny_yolo_answers_like_output(tiny_vars):
    """A rank-5 output ([n, 2, 2, 5, 9]) served by ModelServer →
    ModelRegistry → ParallelInference (buckets up to 4 rows) to 3
    concurrent clients, each answer against ``output`` on its request;
    decode and NMS of the answers equal the JAX package's."""
    from deeplearning4j_tpu_torch.serving import (
        ModelRegistry,
        ModelServer,
        ServingClient,
        spec,
    )

    model = _tiny_port()
    params = ckpt.variables_from_numpy(tiny_vars)
    reg = ModelRegistry()
    reg.register("tiny_yolo", lambda v, x: model.output(v, x), params,
                 input_spec=spec((64, 64, 3), np.float32), mode="batched",
                 max_batch_size=4, devices=["cpu"])
    srv = ModelServer(reg, port=0)
    srv.start(warm=True)
    try:
        client = ServingClient(srv.url, timeout=60)
        reqs = [_tiny_batch(40 + i)["features"][:1 + i % 3]
                for i in range(6)]
        with ThreadPoolExecutor(3) as pool:
            resps = list(pool.map(
                lambda r: client.predict("tiny_yolo", r.tolist()), reqs))
    finally:
        srv.stop()
    for req, resp in zip(reqs, resps):
        got = np.asarray(resp["outputs"], np.float32)
        assert got.shape == (req.shape[0], 2, 2, B, 5 + C)
        want = model.output(params, req).numpy()
        # wh is in grid units (anchors × exp): 1e-5 of max(1, |value|)
        assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0,
                                                             np.abs(want)))
        boxes, scores, _ = yolo.decode_predictions(torch.from_numpy(got),
                                                   top_k=10)
        jboxes, jscores, _ = jyolo.decode_predictions(jnp.asarray(got),
                                                      top_k=10)
        np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            yolo.non_max_suppression(boxes, scores).numpy(),
            np.asarray(jyolo.non_max_suppression(jboxes, jscores)))
