"""CNN ops (↔ deeplearning4j_tpu/ops/cnn.py): convolutions, pooling, patches and reshuffles.

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

Two places where the torch op computes another function than the JAX
package's, and what is done about it:

- ``deconv2d``/``deconv3d``: ``lax.conv_transpose`` without
  ``transpose_kernel`` correlates the stride-dilated input with the kernel
  as it is (not flipped), padded by XLA's transpose rule
  (``_transpose_pads``); ``F.conv_transpose2d`` is the gradient of a conv,
  which flips it. So the port hands ``F.conv_transpose*`` the kernel
  flipped, I and O swapped, with no padding (the full correlation), then
  crops or zero-pads the result to XLA's padding.
- ``avg_pool3d`` divides by the whole window even over padding, as the
  JAX package's does (``avg_pool2d`` counts the real elements only).

The patch ops keep two orders, as the JAX package does:
``extract_patches2d`` is C-major (C·kh·kw, ``F.unfold``'s order, which
``LocallyConnected1D/2D`` weights are laid out in), ``im2col`` kh·kw·C.
The space/batch reshuffles are the JAX package's reshapes and transposes
of the NHWC tensor, so the packed channel is (bh, bw, c), not
``F.pixel_unshuffle``'s (c, bh, bw).
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
    """'SAME' | 'VALID' | int | per-dim ints → [(before, after)] per
    spatial dim (as many as ``spatial`` has)."""
    n = len(spatial)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * n
        if mode == "SAME":
            return [_same_pads(size, k, s, d) for size, k, s, d in
                    zip(spatial, kernel, stride, dilation)]
        raise ValueError(f"unknown padding {padding!r}")
    return [(p, p) for p in _pair(padding, n)]


def _torch_pads(pads):
    """[(before, after)] per spatial dim → ``F.pad``'s order (last dim
    first)."""
    return tuple(v for pair in reversed(pads) for v in pair)


def _conv_nd(xc, w_oi, b, stride, pads, dilation, groups=1):
    """``F.conv{1,2,3}d`` of a channels-first tensor with per-dim
    (before, after) padding: symmetric padding goes to the conv, anything
    else through ``F.pad`` first."""
    conv = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[xc.ndim]
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, _torch_pads(pads))
        pad = 0
    return conv(xc, w_oi, b, stride, pad, dilation, groups)


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
    pads = _pads(padding, xc.shape[2:], w.shape[:2], stride, dilation)
    y = _conv_nd(xc, w.permute(3, 2, 0, 1), b, stride, pads, dilation,
                 feature_group_count)
    return _back(y, data_format)


def conv1d(x, w, b=None, *, stride=1, padding="SAME", dilation=1,
           data_format="NWC"):
    """1-D convolution. x: [N,W,C] (NWC) or [N,C,W]; w: [k, Cin, Cout]."""
    if data_format not in ("NWC", "NCW"):
        raise ValueError(f"data_format {data_format!r}; valid: NWC|NCW")
    xc = x.permute(0, 2, 1) if data_format == "NWC" else x
    pads = _pads(padding, xc.shape[2:], w.shape[:1], (stride,), (dilation,))
    y = _conv_nd(xc, w.permute(2, 1, 0), b, (stride,), pads, (dilation,))
    return y.permute(0, 2, 1) if data_format == "NWC" else y


def _ncdhw(x, data_format):
    if data_format == "NDHWC":
        return x.permute(0, 4, 1, 2, 3)
    if data_format == "NCDHW":
        return x
    raise ValueError(f"data_format {data_format!r}; valid: NDHWC|NCDHW")


def _back3d(y, data_format):
    return y.permute(0, 2, 3, 4, 1) if data_format == "NDHWC" else y


def conv3d(x, w, b=None, *, stride=1, padding="SAME", dilation=1,
           data_format="NDHWC"):
    """3-D convolution. x: [N,D,H,W,C] (NDHWC) or [N,C,D,H,W]; w: [kd, kh,
    kw, Cin, Cout]."""
    stride, dilation = _pair(stride, 3), _pair(dilation, 3)
    xc = _ncdhw(x, data_format)
    pads = _pads(padding, xc.shape[2:], w.shape[:3], stride, dilation)
    y = _conv_nd(xc, w.permute(4, 3, 0, 1, 2), b, stride, pads, dilation)
    return _back3d(y, data_format)


def _transpose_pads(k, s, padding):
    """XLA's padding of the stride-dilated input of a transposed conv
    (``lax.conv_transpose``'s rule) for one dim: (before, after). A string
    names the forward conv's padding; explicit ints pad the dilated input
    as they are."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "SAME":
            total = k + s - 2
            before = k - 1 if s > k - 1 else -(-total // 2)
        elif mode == "VALID":
            total = k + s - 2 + max(k - s, 0)
            before = k - 1
        else:
            raise ValueError(f"unknown padding {padding!r}")
        return before, total - before
    return padding


def _deconv(xc, w, stride, padding):
    """The JAX package's transposed conv of a channels-first tensor: the
    correlation of the stride-dilated input, padded by
    ``_transpose_pads``, with the unflipped kernel ``w`` ([k..., I, O]).
    ``F.conv_transpose*`` with the kernel flipped (and I, O in its order)
    and no padding is that correlation over padding k − 1 on each side;
    the result is then cropped (negative pad) or zero-padded to the
    wanted padding."""
    nd = xc.ndim - 2
    kernel = w.shape[:nd]
    if isinstance(padding, str):
        pads = [_transpose_pads(k, s, padding)
                for k, s in zip(kernel, stride)]
    else:
        pads = [(p, p) for p in _pair(padding, nd)]
    perm = (nd, nd + 1, *range(nd))  # [k..., I, O] → [I, O, k...]
    wt = w.flip(tuple(range(nd))).permute(*perm)
    convt = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
             3: F.conv_transpose3d}[nd]
    y = convt(xc, wt, None, stride)
    edge = _torch_pads([(lo - (k - 1), hi - (k - 1))
                        for (lo, hi), k in zip(pads, kernel)])
    return F.pad(y, edge) if any(edge) else y


def deconv2d(x, w, b=None, *, stride=1, padding="SAME", data_format="NHWC"):
    """Transposed 2-D conv as ``lax.conv_transpose`` computes it (the
    kernel not flipped). x: [N,H,W,C]; w: [kh, kw, C, F] (HWIO)."""
    y = _deconv(_nchw(x, data_format), w, _pair(stride), padding)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return _back(y, data_format)


def deconv3d(x, w, b=None, *, stride=1, padding="SAME", data_format="NDHWC"):
    """Transposed 3-D conv (x: [N,D,H,W,C], w: [kd, kh, kw, C, F])."""
    y = _deconv(_ncdhw(x, data_format), w, _pair(stride, 3), padding)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1, 1)
    return _back3d(y, data_format)


def extract_patches2d(x, kernel, *, stride=1, padding="VALID", dilation=1):
    """[N,H,W,C] → [N,OH,OW,C·kh·kw] sliding-window patches, the channel
    C-major (``lax.conv_general_dilated_patches``' order, and
    ``F.unfold``'s)."""
    kernel, stride, dilation = _pair(kernel), _pair(stride), _pair(dilation)
    xc = x.permute(0, 3, 1, 2)
    pads = _pads(padding, xc.shape[2:], kernel, stride, dilation)
    if any(_torch_pads(pads)):
        xc = F.pad(xc, _torch_pads(pads))
    oh, ow = (
        (n - (k - 1) * d - 1) // s + 1
        for n, k, s, d in zip(xc.shape[2:], kernel, stride, dilation))
    cols = F.unfold(xc, kernel, dilation=dilation, stride=stride)
    return cols.reshape(x.shape[0], -1, oh, ow).permute(0, 2, 3, 1)


def depthwise_conv2d(x, w, b=None, *, stride=1, padding="SAME", dilation=1,
                     data_format="NHWC"):
    """Depthwise conv: w [kh, kw, C, mult] as HWIO [kh, kw, 1, C·mult]
    with C groups, so output channel c·mult + m is input channel c's m-th
    filter."""
    c = x.shape[-1] if data_format == "NHWC" else x.shape[1]
    kh, kw, cin, mult = w.shape
    if cin != c:
        raise ValueError(f"depthwise weight channel dim {cin} != input "
                         f"channels {c}")
    return conv2d(x, w.reshape(kh, kw, 1, cin * mult), b, stride=stride,
                  padding=padding, dilation=dilation, feature_group_count=c,
                  data_format=data_format)


def separable_conv2d(x, dw, pw, b=None, *, stride=1, padding="SAME",
                     data_format="NHWC"):
    """Depthwise conv (``dw``, strided, no bias) then the 1×1 pointwise
    conv (``pw`` [1, 1, C·mult, F]) with the bias."""
    y = depthwise_conv2d(x, dw, None, stride=stride, padding=padding,
                         data_format=data_format)
    return conv2d(y, pw, b, stride=1, padding="SAME", data_format=data_format)


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


def _pool3d(x, fill, window, stride, padding):
    """The 3-D window reduction's input: NDHWC → NCDHW, padded by XLA's
    rule with ``fill``."""
    window = _pair(window, 3)
    stride = _pair(stride if stride is not None else window, 3)
    xc = x.permute(0, 4, 1, 2, 3)
    pads = _pads(padding, xc.shape[2:], window, stride, (1, 1, 1))
    if any(_torch_pads(pads)):
        xc = F.pad(xc, _torch_pads(pads), value=fill)
    return xc, window, stride


def max_pool3d(x, window=2, stride=None, padding="VALID"):
    """Window max over [N,D,H,W,C]; padding counts as −inf."""
    xc, window, stride = _pool3d(x, -float("inf"), window, stride, padding)
    return F.max_pool3d(xc, window, stride).permute(0, 2, 3, 4, 1)


def avg_pool3d(x, window=2, stride=None, padding="VALID"):
    """Window sum over [N,D,H,W,C] divided by the whole window's size,
    padding included (the JAX package's rule, unlike ``avg_pool2d``)."""
    xc, window, stride = _pool3d(x, 0.0, window, stride, padding)
    return F.avg_pool3d(xc, window, stride).permute(0, 2, 3, 4, 1)


# --- resolution reshuffles -------------------------------------------------


def upsampling2d(x, scale=2, data_format="NHWC"):
    """Nearest-neighbour upsampling: each pixel repeated (sh, sw) times."""
    sh, sw = _pair(scale)
    h_axis = 1 if data_format == "NHWC" else 2
    return x.repeat_interleave(sh, dim=h_axis).repeat_interleave(
        sw, dim=h_axis + 1)


def space_to_depth(x, block_size, data_format="NHWC"):
    """[N,H,W,C] → [N,H/b,W/b,b·b·C], the packed channel (bh, bw, c)."""
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, c * b * b)


def depth_to_space(x, block_size, data_format="NHWC"):
    """The inverse of ``space_to_depth``."""
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * b, w * b, c // (b * b))


def space_to_batch(x, block_size, paddings=((0, 0), (0, 0))):
    """Zero-pad H and W, then move each (bh, bw) offset into the batch:
    [N,H,W,C] → [b·b·N, H/b, W/b, C], batch index (bh·b + bw)·N + n."""
    b = block_size
    x = F.pad(x, (0, 0, *paddings[1], *paddings[0]))
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c).permute(2, 4, 0, 1, 3, 5)
    return x.reshape(n * b * b, h // b, w // b, c)


def batch_to_space(x, block_size, crops=((0, 0), (0, 0))):
    """The inverse of ``space_to_batch``, then the crops."""
    b = block_size
    nb, h, w, c = x.shape
    n = nb // (b * b)
    x = x.reshape(b, b, n, h, w, c).permute(2, 3, 0, 4, 1, 5)
    x = x.reshape(n, h * b, w * b, c)
    return x[:, crops[0][0]:x.shape[1] - crops[0][1],
             crops[1][0]:x.shape[2] - crops[1][1], :]


def im2col(x, kernel, stride=1, padding=0, dilation=1):
    """[N,H,W,C] → [N,OH,OW,kh·kw·C] patches, kernel-position major
    (the JAX package's order; ``extract_patches2d`` is C-major)."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    x = F.pad(x, (0, 0, pw, pw, ph, ph))
    n, h, w, c = x.shape
    oh = (h - (kh - 1) * dh - 1) // sh + 1
    ow = (w - (kw - 1) * dw - 1) // sw + 1
    patches = [x[:, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                 j * dw:j * dw + (ow - 1) * sw + 1:sw, :]
               for i in range(kh) for j in range(kw)]
    return torch.cat(patches, dim=-1)
