"""CNN ops (↔ deeplearning4j_tpu/ops/cnn.py): 2-D convolution and pooling.

The JAX package's signatures and layouts: activations NHWC by default
(``data_format="NCHW"`` too), conv weights HWIO ``[kh, kw, Cin/groups,
Cout]``. Inside, a logical NHWC tensor goes to ``F.conv2d`` /
``F.max_pool2d`` as ``x.permute(0, 3, 1, 2)``, which is a ``channels_last``
view of the same memory (no copy), and the result is permuted back; the
weight goes in as ``w.permute(3, 2, 0, 1)`` (OIHW). On the card the conv
is cuDNN's, as the JAX package leaves it to XLA: no kernel of this module
is written by hand.

Padding follows XLA, not PyTorch: ``"SAME"`` gives ``ceil(in / stride)``
outputs and pads ``total = max((out - 1)·s + (k - 1)·d + 1 - in, 0)``,
``total // 2`` before and the rest after, so with a stride above 1 it can
be asymmetric (ResNet-50's 7×7/2 stem on 224 pads (2, 3)). Asymmetric
padding is applied with ``F.pad``: zeros for convs and sums, −inf for max
pooling. An average over ``"SAME"`` or explicit padding divides by the
count of real elements in each window, as the JAX package does.

Not ported yet (ROADMAP queue 1 item 3): conv1d/conv3d, deconv2d/3d,
depthwise and separable convs, ``extract_patches2d``, the 3-D pools and
the space/batch reshuffles.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IntOr2 = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntOr2, n: int = 2):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    if len(t) != n:
        raise ValueError(f"expected {n}-tuple, got {t}")
    return t


def _same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding, spatial, kernel, stride, dilation):
    """'SAME' | 'VALID' | int | (ph, pw) → [(top, bottom), (left, right)]."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0), (0, 0)]
        if mode == "SAME":
            return [_same_pads(n, k, s, d) for n, k, s, d in
                    zip(spatial, kernel, stride, dilation)]
        raise ValueError(f"unknown padding {padding!r}")
    return [(p, p) for p in _pair(padding)]


def _nchw(x, data_format: str):
    """The NCHW view the torch ops take (a ``channels_last`` view of an
    NHWC tensor); raises on a layout other than NHWC / NCHW."""
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2)
    if data_format == "NCHW":
        return x
    raise ValueError(f"data_format {data_format!r}; valid: NHWC|NCHW")


def _back(y, data_format: str):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d(
    x,
    w,
    b=None,
    *,
    stride: IntOr2 = 1,
    padding="SAME",
    dilation: IntOr2 = 1,
    feature_group_count: int = 1,
    data_format: str = "NHWC",
    preferred_element_type=None,
):
    """2-D convolution. x: [N,H,W,C] (NHWC) or [N,C,H,W]; w: [kh, kw,
    Cin/groups, Cout] (HWIO). ``preferred_element_type`` (a torch dtype)
    computes in that dtype: bf16 inputs with float32 give the float32
    accumulation unrounded."""
    if preferred_element_type is not None:
        x, w = x.to(preferred_element_type), w.to(preferred_element_type)
        b = None if b is None else b.to(preferred_element_type)
    stride, dilation = _pair(stride), _pair(dilation)
    xc = _nchw(x, data_format)
    (top, bottom), (left, right) = _pads(padding, xc.shape[2:], w.shape[:2],
                                         stride, dilation)
    if top == bottom and left == right:
        pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride, pad, dilation,
                 feature_group_count)
    return _back(y, data_format)


# --- pooling -----------------------------------------------------------


def _pool(x, init, op, window, stride, padding, data_format="NHWC"):
    """Reduce each window with ``op``: ``"max"`` or ``"add"`` (the JAX
    package passes ``lax.max`` / ``lax.add``); padding is filled with
    ``init`` (−inf for max, 0 for a sum)."""
    implicit = {"max": -float("inf"), "add": 0.0}
    if op not in implicit:
        raise ValueError(f"unknown pooling op {op!r}; valid: max|add")
    window, stride = _pair(window), _pair(stride)
    xc = _nchw(x, data_format)
    (top, bottom), (left, right) = _pads(padding, xc.shape[2:], window,
                                         stride, (1, 1))
    pad = (top, left)
    # torch pools pad symmetrically, by at most half the window, with the
    # op's own fill value (-inf for max, 0 for a sum)
    if (top != bottom or left != right or 2 * top > window[0]
            or 2 * left > window[1]
            or (pad != (0, 0) and init != implicit[op])):
        xc = F.pad(xc, (left, right, top, bottom), value=init)
        pad = 0
    if op == "max":
        y = F.max_pool2d(xc, window, stride, pad)
    else:
        y = F.avg_pool2d(xc, window, stride, pad, count_include_pad=True,
                         divisor_override=1)
    return _back(y, data_format)


def max_pool2d(x, window=2, stride=None, padding="VALID",
               data_format="NHWC"):
    stride = stride if stride is not None else window
    if not x.is_floating_point():
        raise TypeError(f"max_pool2d takes floating inputs, got {x.dtype}")
    return _pool(x, -float("inf"), "max", window, stride, padding,
                 data_format)


def avg_pool2d(x, window=2, stride=None, padding="VALID",
               data_format="NHWC"):
    """Window mean; over padding (``"SAME"`` or explicit), the sum over
    the window's real elements divided by their count."""
    stride = stride if stride is not None else window
    summed = _pool(x, 0.0, "add", window, stride, padding, data_format)
    if isinstance(padding, str) and padding.upper() == "VALID":
        w = _pair(window)
        return summed / (w[0] * w[1])
    spatial = (x.shape[1:3] if data_format == "NHWC" else x.shape[2:])
    ones_shape = ((1, *spatial, 1) if data_format == "NHWC"
                  else (1, 1, *spatial))
    counts = _pool(x.new_ones(ones_shape), 0.0, "add", window, stride,
                   padding, data_format)
    return summed / counts


def pnorm_pool2d(x, p=2, window=2, stride=None, padding="VALID",
                 data_format="NHWC"):
    """(Σ |x|^p)^(1/p) over each window (↔ PoolingType.PNORM)."""
    stride = stride if stride is not None else window
    summed = _pool(torch.pow(torch.abs(x), p), 0.0, "add", window, stride,
                   padding, data_format)
    return torch.pow(summed, 1.0 / p)


def global_avg_pool(x, data_format="NHWC", keepdims=False):
    dims = (1, 2) if data_format == "NHWC" else (2, 3)
    return torch.mean(x, dim=dims, keepdim=keepdims)


def global_max_pool(x, data_format="NHWC", keepdims=False):
    dims = (1, 2) if data_format == "NHWC" else (2, 3)
    return torch.amax(x, dim=dims, keepdim=keepdims)
