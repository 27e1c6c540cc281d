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
