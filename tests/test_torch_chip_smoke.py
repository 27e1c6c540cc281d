"""``chip_smoke.py``'s profiler bookkeeping on the CPU, on made-up traces.

``_window_start`` finds where the traced calls begin in a trace's kernel
records: past the TRACE_EDGE_S pause that opens the recording window,
where a trace kept records of the warm-up call before it. It must drop
those records and nothing else, so that a launch count over the expected
one still fails the card run.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PAUSE_US = chip_smoke.TRACE_EDGE_S * 1e6


def _trace(per_call, calls, warmup_records=0, inner_pause_us=0.0):
    """(start µs, end µs, name) records: ``warmup_records`` kernels, the
    window's opening pause, then ``calls`` calls of ``per_call`` 10-µs
    kernels 5 µs apart, with ``inner_pause_us`` of host time after each
    call's first kernel."""
    out, t = [], 0.0
    for k in range(warmup_records):
        out.append((t, t + 10.0, f"warm_{k}"))
        t += 15.0
    t += PAUSE_US
    for c in range(calls):
        for k in range(per_call):
            out.append((t, t + 10.0, f"kernel_{k}"))
            t += 15.0
            if k == 0:
                t += inner_pause_us
    return out


@pytest.mark.parametrize("per_call,calls,warmup,inner,want", [
    (1, 5, 0, 0.0, 0),            # a clean trace: nothing to drop
    (1, 5, 1, 0.0, 1),            # the warm-up's sweep kept: dropped
    (100, 5, 7, 0.0, 7),          # a few of a step-kernel warm-up's
    (100, 5, 100, 0.0, 100),      # the whole warm-up call
    (1, 5, 2, 0.0, 0),            # more than one call's worth: kept
    (3, 5, 0, PAUSE_US, 0),       # a pause inside the function
    (3, 5, 1, PAUSE_US, 0),       # ... which also hides the opening one
])
def test_window_start_drops_only_the_warm_up_records(per_call, calls, warmup,
                                                     inner, want):
    records = sorted(_trace(per_call, calls, warmup, inner))
    start = chip_smoke._window_start(records, calls)
    assert start == want
    if want:
        assert all(n.startswith("warm_") for _, _, n in records[:start])
        assert not any(n.startswith("warm_") for _, _, n in records[start:])


# --- the CNN phases' host-side helpers ------------------------------------

import numpy as np  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_disc_batch_is_one_disc_a_picture_from_the_seed():
    b = chip_smoke._disc_batch(6, 64, 7)
    again = chip_smoke._disc_batch(6, 64, 7)
    np.testing.assert_array_equal(b["features"], again["features"])
    x, y = b["features"], b["labels"]
    assert x.shape == (6, 64, 64, 3) and y.shape == (6, 64, 64, 1)
    assert x.dtype == y.dtype == np.float32
    assert set(np.unique(y)) == {0.0, 1.0}
    for m in y[..., 0]:
        rows, cols = np.nonzero(m)
        # one whole disc inside the picture, its radius in [64/16, 64/4)
        r = (rows.max() - rows.min() + 1) / 2
        assert 4 - 1 <= r <= 16 + 1
        assert abs((cols.max() - cols.min() + 1) / 2 - r) <= 1
        assert abs(m.sum() / (np.pi * r * r) - 1) < 0.25
    inside = (x - chip_smoke.DISC_SHIFT * y)[y[..., 0] > 0]
    assert abs(inside.mean()) < 0.1 and abs(x[y[..., 0] > 0].mean()
                                            - chip_smoke.DISC_SHIFT) < 0.1
    assert not np.array_equal(chip_smoke._disc_batch(6, 64, 8)["labels"], y)


def test_request_mixes_and_image_batches():
    sizes = [chip_smoke._xception_request(i).shape for i in range(4)]
    assert sizes == [(1, 299, 299, 3), (2, 299, 299, 3)] * 2
    assert [chip_smoke._unet_request(i).shape[0] for i in range(8)] == [
        1, 2, 3, 4] * 2
    np.testing.assert_array_equal(chip_smoke._unet_request(5),
                                  chip_smoke._unet_request(5))
    assert chip_smoke._unet_request(5).shape[1:] == (128, 128, 3)
    # _resnet_batches is _image_batches at 224 (the same draws as before)
    r = np.random.default_rng(chip_smoke.SEED)
    first = chip_smoke._image_batches(1, 2, 224, 1000)[0]
    np.testing.assert_array_equal(first["features"], r.normal(
        size=(2, 224, 224, 3)).astype(np.float32))
    assert first["labels"].argmax(-1).tolist() == r.integers(
        0, 1000, 2).tolist()


def test_served_output_checks():
    req = np.zeros((3, 8, 8, 3), np.float32)
    probs = np.full((3, 10), 0.1)
    assert chip_smoke._softmax_rows(10)(probs, req)
    assert not chip_smoke._softmax_rows(10)(probs * 2, req)
    assert not chip_smoke._softmax_rows(5)(probs, req)
    masks = np.full((3, 8, 8, 1), 0.5)
    assert chip_smoke._masks(masks, req)
    assert not chip_smoke._masks(masks + 0.6, req)
    assert not chip_smoke._masks(masks[:2], req)


def test_xception_depthwise_groups():
    from deeplearning4j_tpu_torch.models.zoo import xception

    groups = chip_smoke._depthwise_groups(xception(device="cpu"))
    assert sum(len(v) for v in groups.values()) == 34
    assert {k[0]: len(v) for k, v in groups.items()} == {
        (150, 150, 64): 1, (150, 150, 128): 1, (75, 75, 128): 1,
        (75, 75, 256): 1, (38, 38, 256): 1, (38, 38, 728): 1,
        (19, 19, 728): 26, (10, 10, 1024): 1, (10, 10, 1536): 1}
    assert all(k[1:] == (3, 1, 1) for k in groups)


def test_zoo_cases_are_the_zoo_defaults():
    from deeplearning4j_tpu_torch.models.zoo import get_model

    got = {n: chip_smoke._zoo_case(get_model(n, device="cpu"))
           for n in chip_smoke.ZOO_CNN}
    assert got == {"alexnet": (224, 1000), "vgg16": (224, 1000),
                   "vgg19": (224, 1000), "simplecnn": (48, 10),
                   "darknet19": (224, 1000), "squeezenet": (224, 1000)}
    assert set(chip_smoke.ZOO_PER_LEAF) <= set(chip_smoke.ZOO_CNN)
    assert not {"simplecnn", "darknet19"} & set(chip_smoke.ZOO_PER_LEAF)


@pytest.mark.parametrize("per_leaf_max", [True, False])
def test_float64_copy_check_shares_dropout_masks(per_leaf_max):
    """``_vs_float64`` on the CPU at a small SimpleCNN (BatchNorm and
    Dropout): the same masks in both copies hold the float32 step to its
    float64 copy; other masks would not."""
    from deeplearning4j_tpu_torch.models.zoo import simplecnn
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
    from deeplearning4j_tpu_torch.train.updaters import Adam

    model = simplecnn(device="cpu", num_classes=3, input_shape=(12, 12, 3),
                      updater=Adam(1e-3))
    trainer = Trainer(model)
    ts = trainer.init_state()
    batch = batch_to_device(chip_smoke._image_batches(1, 8, 12, 3)[0], "cpu")
    out = chip_smoke._vs_float64("cpu", trainer, ts, batch,
                                 per_leaf_max=per_leaf_max, dropout_seed=3)
    assert out["loss_rel"] <= chip_smoke.TOL_LOSS_REL
    off, _, _ = chip_smoke._grads_by_name(trainer, ts.params, ts.model_state,
                                          batch)
    other, _, _ = chip_smoke._grads_by_name(trainer, ts.params,
                                            ts.model_state, batch, 4)
    assert len({round(v, 6) for v in (off, other, out["loss_float32"])}) == 3


def test_conv_layer_cases_cover_the_slice():
    from deeplearning4j_tpu_torch.nn.layers import conv

    ported = {"Conv1D", "Conv3D", "Deconv2D", "DepthwiseConv2D",
              "SeparableConv2D", "Upsampling2D", "ZeroPadding2D",
              "Cropping2D", "SpaceToDepth", "Pooling1D", "ZeroPadding1D",
              "Cropping1D", "Upsampling1D", "Deconv3D", "Pooling3D",
              "Upsampling3D", "ZeroPadding3D", "Cropping3D", "DepthToSpace",
              "LocallyConnected2D", "LocallyConnected1D"}
    assert ported <= {n for n in vars(conv) if not n.startswith("_")}
    assert {c[0] for c in chip_smoke.CONV_LAYER_CASES} == ported | {
        "LayerNorm", "LocalResponseNormalization", "Dropout", "PixelOutput"}


@pytest.mark.parametrize("case", chip_smoke.CONV_LAYER_CASES,
                         ids=lambda c: c[0])
def test_layer_vs_float64_on_the_cpu(case):
    name, kw, shape = case
    row = chip_smoke._layer_vs_float64(name, kw, shape, torch.device("cpu"))
    assert row["device"] == "cpu"
    assert row["max_err"] <= chip_smoke.TOL_LAYER_F64, row["errors"]
    assert "dx" in row["errors"]


# --- the next-frame ConvLSTM phases' helpers --------------------------------

def test_movies_are_seeded_and_the_target_is_the_next_frame():
    x, y = chip_smoke.generate_movies(6, seed=3)
    again = chip_smoke.generate_movies(6, seed=3)
    np.testing.assert_array_equal(x, again[0])
    np.testing.assert_array_equal(y, again[1])
    assert not np.array_equal(chip_smoke.generate_movies(6, seed=4)[0], x)
    assert x.shape == y.shape == (6, 15, 40, 40, 1)
    assert x.dtype == y.dtype == np.float32
    assert set(np.unique(y)) <= {0.0, 1.0} and y.max() == 1.0
    # the ±0.1 noise rings: values off {0, 1} in the inputs only
    assert np.any((x != 0) & (x != 1)) and x.max() <= 1.0
    # frame t + 1 of the input, its noise thresholded away, is target t
    np.testing.assert_array_equal((x[:, 1:] > 0.5).astype(np.float32),
                                  y[:, :-1])
    # squares of side 4 or 6 that move at most a pixel a frame
    moved = np.abs(y[:, 1:] - y[:, :-1]).sum(axis=(2, 3, 4))
    assert moved.max() <= 2 * 7 * 2 * 6


def test_next_frame_config_is_the_examples_model_and_crosses_to_jax():
    import jax

    from deeplearning4j_tpu.nn.config import SequentialConfig as JaxSeqConfig
    from deeplearning4j_tpu.nn.model import SequentialModel as JaxModel
    from deeplearning4j_tpu.train import updaters  # noqa: F401 (registers)
    from deeplearning4j_tpu_torch.nn.model import SequentialModel

    cfg = chip_smoke.next_frame_config()
    model = SequentialModel(cfg, device="cpu")
    assert model.num_params(model.init()) == chip_smoke.CONVLSTM_PARAMS
    assert [type(l).__name__ for l in model.layers] == [
        "ConvLSTM2D", "BatchNorm"] * 4 + ["Conv3D", "LossLayer"]
    assert model.shapes[0] == model.shapes[-1] == (15, 40, 40, 1)
    assert type(cfg.net.updater).__name__ == "AdaDelta"
    assert (cfg.net.updater.rho, cfg.net.updater.eps) == (0.95, 1e-7)
    jm = JaxModel(JaxSeqConfig.from_json(cfg.to_json()))
    assert [tuple(s) for s in jm.shapes] == model.shapes
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(
        jax.eval_shape(jm.init)["params"]))
    assert n_jax == chip_smoke.CONVLSTM_PARAMS


@pytest.fixture(scope="module")
def tiny_next_frame():
    from deeplearning4j_tpu_torch.nn.model import SequentialModel
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device

    model = SequentialModel(chip_smoke.next_frame_config(
        t=5, filters=3, depth=2), device="cpu")
    trainer = Trainer(model)
    x, y = chip_smoke.generate_movies(2, seed=11)
    batch = batch_to_device({"features": x[:, :5], "labels": y[:, :5]},
                            "cpu")
    return model, trainer, trainer.init_state(), batch


def test_next_frame_float64_check_on_the_cpu(tiny_next_frame):
    _, trainer, ts, batch = tiny_next_frame
    out = chip_smoke._vs_float64("cpu", trainer, ts, batch,
                                 per_leaf_max=True)
    assert out["loss_rel"] <= chip_smoke.TOL_LOSS_REL
    assert out["worst_grad_frac"] <= chip_smoke.TOL_GRAD_FRAC
    assert 0 < out["state_err"] <= chip_smoke.TOL_STATE


def test_next_frame_tbptt_windows_against_float64_on_the_cpu(
        tiny_next_frame):
    """The TBPTT phase's checks at a tiny size: each window in float32 and
    in the float64 copy from one state (and the two run apart), and one
    window over the whole movie against the standard step, bit for bit."""
    from deeplearning4j_tpu_torch.train.trainer import Trainer
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    model, _, ts, batch = tiny_next_frame
    trainer = Trainer(chip_smoke._with_tbptt(model, 2))
    windows = chip_smoke._tbptt_windows(batch, 2)
    assert [w["features"].shape[1] for w in windows] == [2, 2, 1]
    ts64 = chip_smoke._float64_state(ts)
    assert all(a.dtype == torch.float64 for a in tree_leaves(
        (ts64.params, ts64.model_state, ts64.opt_state)))
    out = chip_smoke._windows_vs_float64(trainer, ts, windows)
    for key in ("loss_rel", "carry_err_frac", "apart_loss_rel",
                "apart_carry_err_frac"):
        assert len(out[key]) == 3 and all(0 < x for x in out[key]), key
    assert max(out["loss_rel"] + out["apart_loss_rel"]) <= \
        chip_smoke.TOL_LOSS_REL
    assert max(out["carry_err_frac"]) <= chip_smoke.TOL_CARRY
    # the first window starts from one state in both readings
    assert out["carry_err_frac"][0] == out["apart_carry_err_frac"][0]
    _, losses, _ = chip_smoke._run_windows(trainer, ts, windows)
    assert out["losses"] == losses
    whole = Trainer(chip_smoke._with_tbptt(model, 5))
    ts_w, wm = whole._fit_tbptt_batch(ts, batch)
    ts_s, _ = Trainer(model).train_step(ts, batch)
    assert len(wm) == 1
    for a, b in zip(tree_leaves((ts_w.params, ts_w.model_state)),
                    tree_leaves((ts_s.params, ts_s.model_state))):
        assert torch.equal(a, b)


def test_next_frame_rollout_behind_the_server_on_the_cpu(tiny_next_frame):
    """The example's rollout through ModelServer (an entry a track length)
    against the float64 copy's, and the served-output check."""
    model, trainer, ts, _ = tiny_next_frame
    variables = trainer.variables(ts)
    movie = chip_smoke.generate_movies(1, seed=12)[0][0]
    got, seconds = chip_smoke._rollout("cpu", torch.device("cpu"), model,
                                       variables, movie)
    assert got.shape == (chip_smoke.ROLLOUT_NEW, 40, 40, 1) and seconds > 0
    want = chip_smoke._rollout_direct(model, chip_smoke._float64_copy(
        variables), movie, torch.float64)
    assert want.dtype == np.float64
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= chip_smoke.TOL_ROLLOUT * np.abs(
            w).max()
    # the first predicted frame is the plain forward's last on 7 frames
    first = chip_smoke._sequential_output(model)(
        variables, movie[None, :chip_smoke.ROLLOUT_SEEN])[0, -1]
    np.testing.assert_array_equal(got[0], first.numpy())
    req = chip_smoke._movie_request(1)
    assert req.shape == (2, 15, 40, 40, 1)
    assert chip_smoke._movie_request(0).shape[0] == 1
    assert chip_smoke._frames(np.full(req.shape, 0.5), req)
    assert not chip_smoke._frames(np.full(req.shape, 1.5), req)
    assert not chip_smoke._frames(np.full(req.shape, 0.5)[:1], req)


def test_convlstm_ab_nhwc_carry_variant_is_the_same_function():
    """``convlstm_ab.py`` times the port's ConvLSTM2D forward against one
    with an NHWC carry: both compute the same outputs and carries."""
    import convlstm_ab
    from deeplearning4j_tpu_torch.nn import layers

    layer = layers.ConvLSTM2D(filters=3, kernel=(3, 2), padding="SAME")
    params, _ = layer.init(torch.Generator().manual_seed(0), (4, 6, 7, 2),
                           torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, 6, 7, 2)).astype(np.float32))
    state = tuple(torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, 6, 7, 3)).astype(np.float32)) for s in (1, 2))
    for init in (None, state):
        got, (h, c) = layer._forward(params, x, init)
        want, (hw, cw) = convlstm_ab.forward_nhwc_carry(layer, params, x,
                                                        init)
        for a, b in ((got, want), (h, hw), (c, cw)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# --- the YOLO phases' host-side helpers -------------------------------------


def test_box_batch_is_seeded_and_labelled_on_the_stride_32_grid():
    b = chip_smoke._box_batch(5, 96, 7, 3)
    again = chip_smoke._box_batch(5, 96, 7, 3)
    np.testing.assert_array_equal(b["features"], again["features"])
    x, y, objects = b["features"], b["labels"], b["objects"]
    assert x.shape == (5, 96, 96, 3) and x.dtype == np.float32
    assert y.shape == (5, 3, 3, 5 + 7) and y.dtype == np.float32
    assert [len(o) for o in objects] and all(1 <= len(o) <= 3
                                             for o in objects)
    from deeplearning4j_tpu_torch.models.zoo.yolo import make_yolo_labels

    np.testing.assert_array_equal(y, make_yolo_labels(objects, grid=(3, 3),
                                                      num_classes=7))
    r = np.random.default_rng(3)
    noise = r.normal(size=x.shape).astype(np.float32)
    for i, objs in enumerate(objects):
        cells = {(min(int(cy * 3), 2), min(int(cx * 3), 2))
                 for cx, cy, _, _, _ in objs}
        assert int(y[i, ..., 0].sum()) == len(cells)
        for cx, cy, w, h, cls in objs:
            assert 0.1 <= w <= 0.4 and 0.1 <= h <= 0.4 and 0 <= cls < 7
            assert w / 2 <= cx <= 1 - w / 2 and h / 2 <= cy <= 1 - h / 2
            # the shift sits on the class's channel inside the box
            row, col = int(cy * 96), int(cx * 96)
            assert x[i, row, col, cls % 3] - noise[i, row, col, cls % 3] \
                >= chip_smoke.DISC_SHIFT
    assert [chip_smoke._yolo_request(i).shape[0] for i in range(4)] == [
        1, 2, 1, 2]
    assert chip_smoke._yolo_request(1).shape[1:] == (608, 608, 3)


def _decoded(seed, n=3, grid=3, classes=6, tied=False):
    from deeplearning4j_tpu_torch.models.zoo.yolo import (
        YOLO2_ANCHORS,
        Yolo2OutputLayer,
    )

    r = np.random.default_rng(seed)
    x = (2 * r.standard_normal((n, grid, grid, 5, 5 + classes))).astype(
        np.float32)
    if tied:   # a few confidences and whole class vectors: exact ties
        x[..., 4] = r.choice([-1.0, 0.5], size=x.shape[:-1])
        vecs = r.standard_normal((2, classes)).astype(np.float32)
        x[..., 5:] = vecs[r.integers(0, 2, size=x.shape[:-1])]
    layer = Yolo2OutputLayer(anchors=YOLO2_ANCHORS, num_classes=classes)
    return layer.apply({}, {}, torch.from_numpy(
        x.reshape(n, grid, grid, -1)))[0].numpy()


def test_yolo_grid_check():
    out = _decoded(1)
    req = np.zeros((3, 96, 96, 3), np.float32)
    check = chip_smoke._yolo_grids(3, 5, 6)
    assert check(out, req)
    assert not chip_smoke._yolo_grids(3, 5, 7)(out, req)
    assert not check(out[:2], req)
    for channel, value in ((0, 1.5), (3, 0.0), (4, -0.1), (6, 0.9)):
        bad = out.copy()
        bad[0, 0, 0, 0, channel] = value
        assert not check(bad, req), channel


@pytest.mark.parametrize("tied", [False, True])
def test_detections_cpu_against_cpu_and_numpy(tied):
    det = chip_smoke._detections(_decoded(2, tied=tied), torch.device("cpu"))
    assert det["ok"], det
    assert all(det["equal"].values())
    assert (det["tied_scores"] > 0) == tied
    assert 0 < det["kept_per_image"] <= chip_smoke.YOLO_TOP_K


def test_numpy_decode_and_nms_are_the_jax_packages():
    import jax.numpy as jnp

    from deeplearning4j_tpu.models.zoo import yolo as jyolo

    import jax

    decoded = _decoded(4, tied=True)
    boxes, scores, classes = chip_smoke._decode_numpy(decoded, 20)
    jboxes, jscores, jclasses = jax.jit(lambda d: jyolo.decode_predictions(
        d, top_k=20))(jnp.asarray(decoded))
    np.testing.assert_array_equal(classes, np.asarray(jclasses))
    np.testing.assert_allclose(boxes, np.asarray(jboxes), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-6)
    np.testing.assert_array_equal(
        chip_smoke._nms_numpy(boxes, scores),
        np.asarray(jax.jit(jyolo.non_max_suppression)(boxes, scores)))


def test_planted_box_on_the_cpu():
    planted = chip_smoke._planted_box(torch.device("cpu"))
    assert planted["ok"], planted
    assert planted["class"] == 3 and planted["decode"]["tied_scores"] > 0


@pytest.fixture(scope="module")
def small_yolos():
    """YOLOv2 and Tiny-YOLO at 64² with 4 classes on the CPU, their
    trainers and init states, and two batches of synthetic boxes."""
    from deeplearning4j_tpu_torch.models.zoo.yolo import tiny_yolo, yolo2
    from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device

    batches = [batch_to_device({k: v for k, v in chip_smoke._box_batch(
        2, 64, 4, s).items() if k != "objects"}, "cpu") for s in (0, 1)]
    out = {}
    for name, build in (("yolo2", yolo2), ("tiny_yolo", tiny_yolo)):
        model = build(device="cpu", num_classes=4, input_shape=(64, 64, 3),
                      seed=chip_smoke.SEED)
        trainer = Trainer(model)
        out[name] = (model, trainer, trainer.init_state(), batches)
    return out


@pytest.mark.parametrize("name", [pytest.param("yolo2", marks=pytest.mark.slow),
                                  "tiny_yolo"])
def test_yolo_float64_check_in_parts_on_the_cpu(small_yolos, name):
    model, trainer, ts, batches = small_yolos[name]
    f64 = chip_smoke._vs_float64(name, trainer, ts, batches[0],
                                 per_leaf_max=False, gate_loss=False)
    assert f64["noise_loss_rel"] < 1e-5
    parts = chip_smoke._yolo_loss_parts(name, model, ts, batches[0])
    assert parts["feature_err_frac"] <= chip_smoke.TOL_ZOO_OUT
    assert parts["layer_loss_rel"] <= chip_smoke.TOL_LOSS_REL
    feat, layer = chip_smoke._head_input(
        model, trainer.variables(ts), batches[0]["features"])
    assert type(layer).__name__ == "Yolo2OutputLayer"
    assert feat.shape == (2, 2, 2, 5 * 9)
    # the layer's loss of that map is the model's training loss
    assert float(layer.compute_loss({}, {}, feat, batches[0]["labels"])) \
        == pytest.approx(f64["loss_float32"], rel=1e-6)


def test_mixed_vs_float32_by_batch_on_the_cpu(small_yolos):
    from deeplearning4j_tpu_torch.models.zoo.yolo import yolo2
    from deeplearning4j_tpu_torch.train.trainer import Trainer

    model, _, ts, batches = small_yolos["yolo2"]
    mp = yolo2(device="cpu", num_classes=4, input_shape=(64, 64, 3))
    mp.net.mixed_precision = True
    rel = chip_smoke._mixed_vs_float32(model, Trainer(mp), ts, batches)
    assert len(rel) == 2 and all(0 < r < 0.5 for r in rel)


def test_served_grid_errors():
    out = _decoded(3)
    req = np.zeros((3, 96, 96, 3), np.float32)
    forward = lambda v, x: torch.from_numpy(out)  # noqa: E731
    errs = chip_smoke._served_grid_errors([out], [req], forward, None, 8)
    assert errs == {"max_abs_err_bounded": 0.0, "max_rel_err_wh": 0.0,
                    "matched_buckets": {4: 1},
                    "alone_max_abs_err_bounded": 0.0,
                    "alone_max_rel_err_wh": 0.0}
    bad = out.copy()
    bad[0, 0, 0, 0, 2] *= 1 + 1e-3
    bad[1, 0, 0, 0, 5] += 1e-4
    errs = chip_smoke._served_grid_errors([bad], [req], forward, None, 8)
    assert errs["max_rel_err_wh"] == pytest.approx(1e-3, rel=1e-3)
    assert errs["max_abs_err_bounded"] == pytest.approx(1e-4, rel=1e-2)


def test_served_grid_errors_match_the_servers_bucket():
    """A forward whose rounding depends on the batch size (cuDNN picks its
    algorithm by shape): the served grid is held at the bucket the server
    ran, and the request alone is reported apart."""
    out = _decoded(1, n=1)
    req = np.zeros((1, 96, 96, 3), np.float32)

    def forward(v, x):
        y = out.copy()
        if x.shape[0] != 4:
            y[..., 2:4] *= 1 + 1e-4
            y[..., 4] += 2e-5
        return torch.from_numpy(np.repeat(y, x.shape[0], 0))

    errs = chip_smoke._served_grid_errors([out], [req], forward, None, 8)
    assert errs["matched_buckets"] == {4: 1}
    assert errs["max_abs_err_bounded"] == errs["max_rel_err_wh"] == 0.0
    assert errs["alone_max_abs_err_bounded"] == pytest.approx(2e-5, rel=1e-2)
    assert errs["alone_max_rel_err_wh"] == pytest.approx(1e-4, rel=1e-2)
