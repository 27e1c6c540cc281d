"""ONNX model import → SameDiff program (↔ deeplearning4j_tpu/modelimport/onnx.py).

ref: nd4j/samediff-import-onnx (OpMappingRegistry over ONNX NodeProto) —
the same per-op mapper registry as ``modelimport/tf.py``, reading the
model through the port's own wire codec (``onnx_proto``: ``struct`` and
``numpy`` only, so neither ``onnx`` nor protobuf is needed).
``import_onnx_model`` builds a SameDiff on ``device`` (the first CUDA card
unless the caller asks for another); initializers become CONSTANTs there
(``convert_to_variable`` promotes them for fine-tuning).

Layout: ONNX is NCHW and the imported graph stays NCHW (the torch convs
and pools take it as it is).

Policy (the JAX package's): strict refusal — an op or attribute
combination outside the mapped surface raises ``ONNXImportError`` rather
than importing a wrong graph; the port raises it for the same graphs.

The ``onnximport.*`` ops below are the JAX package's, in torch, each
giving what the JAX op gives:

- ``conv`` and the pools pad explicitly where the padding is asymmetric
  (``auto_pad=SAME_UPPER`` or uneven ``pads``); a max pool pads with −inf,
  an average pool divides by the window or by the real elements under it
  (``count_include_pad``).
- ``gather`` takes ``jnp.take``'s rule (``samediff._gather``), ``top_k``
  and ``argmax`` keep the lower index first among tied values (a stable
  sort; ``torch.topk`` on the card promises no order), ``mod`` is the
  floor or C remainder, ``resize_linear_half_pixel`` is
  ``jax.image.resize(..., antialias=False)``'s weight matrix per axis.
- ``lstm`` and ``gru`` run the hand sweeps (``kernels/lstm_scan.lstm``,
  ``kernels/gru_scan.gru``: ``lstm_fwd``/``lstm_bwd`` and
  ``gru_fwd``/``gru_bwd`` on a CUDA tensor, their plain versions on the
  CPU) after reordering ONNX's gate blocks as the JAX op does (iofc → ifgo,
  zrh → rzn); a reversed direction runs on the time-flipped input and its
  outputs are flipped back, so each stays at its own time index.
- 64-bit values follow the JAX package's x64-off rule: shapes and indices
  come out as int32.

Control flow: If → ``SameDiff.cond``, Loop and Scan → ``SameDiff.while_loop``
(the JAX package's carries: counter, condition, loop vars, captures, dense
scan accumulators). A Loop whose trip count is known on the host and whose
condition provably stays true is written in counter form, so the port runs
it on the static route (``samediff._while_static_trip``: no host read of
the trip count on a call, differentiable).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.autodiff.samediff import (
    SameDiff,
    SDVariable,
    VariableType,
    _canon,
    _expand_dims,
    _gather as _take,
    _index,
    _prod,
    matmul,
    promote,
    register_op,
    torch_dtype,
    where,
)
from deeplearning4j_tpu_torch.kernels import gru_scan, lstm_scan
from deeplearning4j_tpu_torch.modelimport.onnx_proto import (
    ATTR_TENSOR,
    GraphProto,
    ModelProto,
    NodeProto,
    TENSOR_DTYPES,
    TensorProto,
)
from deeplearning4j_tpu_torch.modelimport.tf import (
    _cumsum as _tf_cumsum,
    _einsum as _tf_einsum,
    _fill,
    _list_get,
    _list_set,
)
from deeplearning4j_tpu_torch.ops import cnn as ops_cnn
from deeplearning4j_tpu_torch.ops import math as ops_math
from deeplearning4j_tpu_torch.ops.rnn import LSTMState


class ONNXImportError(Exception):
    pass


# --- torch ops the mappers target (registered under onnximport.*) ---------


def _reverse_axes(x):
    return x.permute(*reversed(range(x.dim())))


def _gemm_op(a, b, c=None, alpha=1.0, beta=1.0, trans_a=0, trans_b=0):
    if trans_a:
        a = _reverse_axes(a)
    if trans_b:
        b = _reverse_axes(b)
    y = alpha * matmul(a, b)
    if c is not None:
        y = y + beta * c
    return y


def _explicit_pads(pads, nd):
    return [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]


def _conv_op(x, w, b=None, strides=(1, 1), pads=None, dilations=(1, 1),
          group=1, auto_pad="NOTSET"):
    nd = x.dim() - 2
    if nd not in (1, 2, 3):
        raise NotImplementedError(f"Conv rank {x.dim()}")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        # XLA's SAME puts the odd pad at the end: SAME_UPPER
        if auto_pad == "SAME_LOWER":
            raise NotImplementedError("auto_pad=SAME_LOWER")
        padding = ops_cnn._pads("SAME", x.shape[2:], w.shape[2:], strides,
                                dilations)
    elif auto_pad == "VALID" or pads is None:
        padding = [(0, 0)] * nd
    else:
        padding = _explicit_pads(pads, nd)
    x, w = promote(x, w)
    y = ops_cnn._conv_nd(x, w, None, tuple(strides), padding,
                         tuple(dilations), group)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * nd)
    return y


def _pool_padding(x, kernel_shape, strides, pads, auto_pad):
    nd = len(kernel_shape)
    if auto_pad == "SAME_UPPER":
        return ops_cnn._pads("SAME", x.shape[2:], kernel_shape, strides,
                             (1,) * nd)
    if auto_pad == "SAME_LOWER":
        raise NotImplementedError("auto_pad=SAME_LOWER")
    if pads is None:
        return [(0, 0)] * nd
    return _explicit_pads(pads, nd)


def _window_sum(x, kernel_shape, strides):
    """The sum of each window (no padding) of NC* ``x``."""
    nd = len(kernel_shape)
    if nd == 1:  # avg_pool1d has no divisor_override
        return F.avg_pool2d(x.unsqueeze(2), (1, kernel_shape[0]),
                            (1, strides[0]), divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return pool(x.contiguous(), tuple(kernel_shape), tuple(strides),
                divisor_override=1)


def _max_pool_op(x, kernel_shape, strides=None, pads=None, auto_pad="NOTSET"):
    nd = len(kernel_shape)
    strides = tuple(strides) if strides else tuple(kernel_shape)
    padding = _pool_padding(x, kernel_shape, strides, pads, auto_pad)
    if any(lo or hi for lo, hi in padding):
        x = F.pad(x, ops_cnn._torch_pads(padding), value=-math.inf)
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
    return pool(x, tuple(kernel_shape), strides)


def _average_pool(x, kernel_shape, strides=None, pads=None,
                  count_include_pad=0, auto_pad="NOTSET"):
    strides = tuple(strides) if strides else tuple(kernel_shape)
    padding = _pool_padding(x, kernel_shape, strides, pads, auto_pad)
    pad = ops_cnn._torch_pads(padding)
    summed = _window_sum(F.pad(x, pad), kernel_shape, strides)
    if count_include_pad:
        # the kernel's size, however the padding was expressed
        return summed / float(np.prod(kernel_shape))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return summed / _window_sum(F.pad(ones, pad), kernel_shape, strides)


def _spatial(x):
    return tuple(range(2, x.dim()))


def _batch_norm(x, scale, bias, mean, var, epsilon=1e-5):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = scale.reshape(shape) * torch.rsqrt(var.reshape(shape) + epsilon)
    return x * inv + (bias.reshape(shape) - mean.reshape(shape) * inv)


def _moments(x, axes):
    """``jnp.mean`` and ``jnp.var`` (the mean of the squared deviations)."""
    mean = torch.mean(x, dim=axes, keepdim=True)
    c = x - mean
    return mean, torch.mean(c * c, dim=axes, keepdim=True)


def _layer_norm(x, scale, bias=None, axis=-1, epsilon=1e-5):
    mean, var = _moments(x, tuple(range(axis % x.dim(), x.dim())))
    y = (x - mean) * torch.rsqrt(var + epsilon) * scale
    if bias is not None:
        y = y + bias
    return y


def _reshape_op(x, shape, allowzero=0):
    shape = list(shape)
    for i, d in enumerate(shape):
        if d == 0 and not allowzero:
            shape[i] = x.shape[i]
    return x.reshape(shape)


def _flatten_op(x, axis=1):
    if axis < 0:
        axis += x.dim()  # ONNX: a negative axis counts from the rank
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


def _slice_op(x, starts, ends, axes=None, steps=None):
    axes = list(range(len(starts))) if axes is None else list(axes)
    steps = [1] * len(starts) if steps is None else list(steps)
    idx = [slice(None)] * x.dim()
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % x.dim()
        dim = x.shape[ax]
        # ONNX clamps out-of-range ends (INT_MAX is idiomatic)
        st, en = min(int(st), dim), min(int(en), dim)
        idx[ax] = slice(st, en, int(sp))
    return _index(x, tuple(idx))


def _pad_index(n, lo, hi, mode):
    i = np.arange(-lo, n + hi)
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    i = np.abs(i)  # reflect, as jnp.pad: the edge is not repeated
    return np.where(i >= n, 2 * (n - 1) - i, i)


def _pad_op(x, pads, constant_value=0.0, mode="constant"):
    nd = x.dim()
    widths = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    if mode == "constant":
        return F.pad(x, ops_cnn._torch_pads(widths), value=constant_value)
    if mode not in ("reflect", "edge"):
        raise NotImplementedError(f"Pad mode {mode}")
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            idx = torch.as_tensor(_pad_index(x.shape[d], lo, hi, mode),
                                  device=x.device)
            x = torch.index_select(x, d, idx)
    return x


def _axes(x, axes):
    return tuple(range(x.dim())) if axes is None else axes


def _reduce_op(kind):
    def f(x, axes=None, keepdims=1, noop_with_empty_axes=0):
        if axes is None or len(axes) == 0:
            # ONNX: empty or absent axes reduce every dim, unless
            # noop_with_empty_axes=1 (then the identity)
            if noop_with_empty_axes:
                return x
            axes = None
        dims = _axes(x, None if axes is None else
                     tuple(int(a) for a in axes))
        kd = bool(keepdims)
        if kind == "mean":
            if not (x.is_floating_point() or x.is_complex()):
                x = x.to(torch.float32)
            return torch.mean(x, dim=dims, keepdim=kd)
        if kind == "sum":
            return torch.sum(x, dim=dims, keepdim=kd)
        if kind == "max":
            return torch.amax(x, dim=dims, keepdim=kd)
        if kind == "min":
            return torch.amin(x, dim=dims, keepdim=kd)
        return _prod(x, dims, kd)

    return f


def _cast_op(x, to):
    if to not in TENSOR_DTYPES:
        raise NotImplementedError(f"Cast to ONNX dtype {to}")
    return x.to(_canon(torch_dtype(TENSOR_DTYPES[to])))


def _lrn_op(x, size, alpha=1e-4, beta=0.75, bias=1.0):
    # ONNX LRN: across channels (axis 1), a window of `size` centred
    half_lo = (size - 1) // 2
    half_hi = size - 1 - half_lo
    sq = F.pad(x * x, (0, 0) * (x.dim() - 2) + (half_lo, half_hi))
    c = x.shape[1]
    acc = sq[:, 0:c]
    for j in range(1, size):
        acc = acc + sq[:, j:j + c]
    return x / torch.pow(bias + (alpha / size) * acc, beta)


def _clip_op(x, lo=None, hi=None):
    if lo is None and hi is None:
        return x
    return torch.clamp(x, min=lo, max=hi)


def _squeeze_op(x, axes=None):
    if axes is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=tuple(int(a) for a in axes))


def _where(c, a, b):
    a, b = promote(a, b)
    return where(c, a, b)


def _expand_op(x, shape):
    return torch.broadcast_to(
        x, torch.broadcast_shapes(tuple(x.shape), tuple(int(d)
                                                        for d in shape)))


def _mod_op(a, b, fmod=0):
    a, b = promote(a, b)
    return torch.fmod(a, b) if fmod else torch.remainder(a, b)


def _is_inf_op(x, detect_negative=1, detect_positive=1):
    pos = torch.isposinf(x) if detect_positive else torch.zeros_like(
        x, dtype=torch.bool)
    neg = torch.isneginf(x) if detect_negative else torch.zeros_like(
        x, dtype=torch.bool)
    return pos | neg


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _arg_extreme(kind):
    fn = torch.argmax if kind == "max" else torch.argmin

    def f(x, axis=0, keepdims=1):
        # the first of tied values, as jnp.argmax / jnp.argmin
        return fn(x, dim=axis, keepdim=bool(keepdims))

    return f


def _top_k(x, k, axis=-1, largest=1, sorted=1):  # noqa: A002
    """``lax.top_k``: descending, and the lower index first among tied
    values (a stable sort; ``torch.topk`` on CUDA promises no order).
    ``sorted`` is ignored: the result is always sorted, as in the JAX op."""
    last = axis % x.dim() == x.dim() - 1
    if not last:
        x = torch.movedim(x, axis, -1)
    key = x if largest else -x
    vals, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :int(k)], idx[..., :int(k)]
    if not largest:
        vals = -vals
    if not last:
        vals = torch.movedim(vals, -1, axis)
        idx = torch.movedim(idx, -1, axis)
    return vals, idx


def _one_hot_op(indices, values, *, depth, axis=-1):
    off, on = values[0], values[1]
    idx = indices.to(torch.int32)
    idx = torch.where(idx < 0, idx + int(depth), idx)  # ONNX wraps negatives
    oh = ops_math.one_hot(idx, int(depth), axis=axis)
    return oh * (on - off) + off


def _reduce_ext_op(kind):
    def f(x, axes=None, keepdims=1, noop_with_empty_axes=0):
        if axes is None or len(axes) == 0:
            if noop_with_empty_axes:
                return x
            dims = _axes(x, None)
        else:
            dims = tuple(int(a) for a in axes)
        kd = bool(keepdims)
        if kind == "l1":
            return torch.sum(torch.abs(x), dim=dims, keepdim=kd)
        if kind == "l2":
            return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=kd))
        if kind == "log_sum":
            return torch.log(torch.sum(x, dim=dims, keepdim=kd))
        if kind == "log_sum_exp":
            return torch.logsumexp(x, dim=dims, keepdim=kd)
        if kind == "sum_square":
            return torch.sum(x * x, dim=dims, keepdim=kd)
        raise ValueError(kind)

    return f


def _depth_to_space_op(x, blocksize, mode="DCR"):
    n, c, h, w = x.shape
    b = blocksize
    if mode == "DCR":
        y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        y = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, c // (b * b), h * b, w * b)


def _space_to_depth_op(x, blocksize):
    n, c, h, w = x.shape
    b = blocksize
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


def _conv_transpose_op(x, w, b=None, strides=(1, 1), pads=None, group=1):
    """``lax.conv_transpose(transpose_kernel=True)`` with the ONNX weight
    [Cin, Cout/g, *k] as its OIHW kernel and ``pads`` as the padding of
    the stride-dilated input, as the JAX op calls it. ``F.conv_transpose``
    with that weight is the same correlation over a padding of k − 1 on
    each side; the result is then cropped or zero-padded to ``pads``."""
    nd = x.dim() - 2
    if group != 1:
        raise NotImplementedError("ConvTranspose group != 1")
    if nd not in (2, 3):
        raise NotImplementedError(f"ConvTranspose rank {x.dim()}")
    pads = [(0, 0)] * nd if pads is None else _explicit_pads(pads, nd)
    x, w = promote(x, w)
    convt = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    y = convt(x, w, None, tuple(strides))
    kernel = w.shape[2:]
    edge = ops_cnn._torch_pads([(lo - (k - 1), hi - (k - 1))
                                for (lo, hi), k in zip(pads, kernel)])
    if any(edge):
        y = F.pad(y, edge)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * nd)
    return y


def _instance_norm_op(x, scale, bias, epsilon=1e-5):
    mean, var = _moments(x, _spatial(x))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + epsilon) * scale.reshape(shape)
            + bias.reshape(shape))


def _group_norm_op(x, scale, bias, num_groups, epsilon=1e-5):
    n, c = x.shape[:2]
    g = int(num_groups)

    def per_channel(p):
        # Opset 21: scale/bias per channel [C]; opset 18: per group [G],
        # each group's value over its C/G channels
        if p.shape[0] == c:
            return p
        if p.shape[0] == g:
            return torch.repeat_interleave(p, c // g)
        raise ValueError(
            f"GroupNormalization: scale/bias length {p.shape[0]} matches "
            f"neither channels ({c}) nor num_groups ({g})")

    y = x.reshape(n, g, c // g, *x.shape[2:])
    mean, var = _moments(y, tuple(range(2, y.dim())))
    y = ((y - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (y * per_channel(scale).reshape(shape)
            + per_channel(bias).reshape(shape))


def _split_op(x, axis=0, split_sizes=None, num_outputs=None):
    if split_sizes is None:
        # Split-18 on an uneven axis: chunks of ceil(dim / k), the last
        # smaller
        k = int(num_outputs)
        dim = x.shape[axis]
        chunk = -(-dim // k)
        split_sizes = [chunk] * (k - 1) + [dim - chunk * (k - 1)]
        if split_sizes[-1] <= 0:
            raise ValueError(
                f"Split: num_outputs={k} too large for axis dim {dim}")
    idxs = np.cumsum(split_sizes)[:-1].tolist()
    return tuple(torch.tensor_split(x, idxs, dim=axis))


def _gather_elements_op(x, idx, axis=0):
    """``jnp.take_along_axis``: a negative index counts from the end."""
    n = x.shape[axis]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))
    return torch.gather(x, axis, idx)


def _trilu_op(x, k=0, upper=1):
    return torch.triu(x, int(k)) if upper else torch.tril(x, int(k))


def _resize_nearest_int(x, scales):
    # an integer-factor nearest with asymmetric coordinates is a repeat
    for ax, s in enumerate(scales):
        if s != 1:
            x = torch.repeat_interleave(x, int(s), dim=ax)
    return x


def _linear_weights(in_size, out_size):
    """``jax.image.resize``'s linear weights for one axis without
    antialiasing (its ``compute_weight_mat``, float32): [in, out], a
    triangle kernel at the half-pixel sample positions, renormalized over
    the input samples it reaches, zero for a sample outside
    [-0.5, in - 0.5]."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.0) * inv_scale - f32(0.5))
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - dist)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_linear_half_pixel(x, out_shape):
    """``jax.image.resize(x, out_shape, "linear", antialias=False)``: each
    axis whose size changes contracted with its weight matrix."""
    y = x
    for ax, (n_in, n_out) in enumerate(zip(x.shape, out_shape)):
        if int(n_in) == int(n_out):
            continue
        w = torch.as_tensor(_linear_weights(int(n_in), int(n_out)),
                            device=x.device).to(y.dtype)
        y = torch.movedim(torch.tensordot(torch.movedim(y, ax, -1), w,
                                          dims=([y.dim() - 1], [0])), -1, ax)
    return y


# -- the recurrent ops: the hand sweeps --------------------------------------

_IOFC_TO_IFGO = (0, 2, 3, 1)   # ONNX LSTM gate blocks → the sweeps' order
_ZRH_TO_RZN = (1, 0, 2)        # ONNX GRU gate blocks → the sweeps' order


def _blocks(a, order, h):
    """``a``'s row blocks of ``h`` rows in ``order`` (the JAX op's
    ``jnp.take`` of a permuted arange; here one concatenation of slices,
    with no index tensor to copy to the device)."""
    return torch.cat([a[k * h:(k + 1) * h] for k in order])


def _time_major(fn, x_tm, reverse, *args, **kw):
    """Run ``fn`` (an [N,T,...] sweep) on time-major ``x_tm``; a reversed
    direction runs on the time-flipped input and its outputs come back
    flipped, each at its own time index (``lax.scan(reverse=True)``)."""
    x = x_tm.transpose(0, 1)
    if reverse:
        x = torch.flip(x, (1,))
    ys, state = fn(x, *args, **kw)
    if reverse:
        ys = torch.flip(ys, (1,))
    return ys.transpose(0, 1), state


def _lstm_direction(x_tm, w, r, wb, h0, c0, hidden, reverse):
    """One ONNX LSTM direction: x_tm [T,N,In]; w [4H,In], r [4H,H], b [4H]
    in ONNX's iofc gate blocks. Returns (ys [T,N,H], hT, cT)."""
    t_len, n = x_tm.shape[:2]
    if x_tm.device.type == "meta":  # shape inference: no sweep to run
        ys = torch.empty((t_len, n, hidden), dtype=x_tm.dtype, device="meta")
        return ys, ys[0], ys[0]
    w_x = _blocks(w, _IOFC_TO_IFGO, hidden).t()      # [In, 4H]
    w_h = _blocks(r, _IOFC_TO_IFGO, hidden).t()      # [H, 4H]
    b = (torch.zeros(4 * hidden, dtype=w.dtype, device=w.device)
         if wb is None else _blocks(wb, _IOFC_TO_IFGO, hidden))
    init = None
    if h0 is not None or c0 is not None:
        ref = h0 if h0 is not None else c0
        init = LSTMState(torch.zeros_like(ref) if h0 is None else h0,
                         torch.zeros_like(ref) if c0 is None else c0)
    ys, st = _time_major(lstm_scan.lstm, x_tm, reverse, w_x, w_h, b,
                         init_state=init)
    return ys, st.h, st.c


def _lstm_op(*ins, hidden_size, direction="forward", present=()):
    """ONNX LSTM, layout=0: x [T,N,In], w [D,4H,In], r [D,4H,H], b [D,8H].
    Default activations only. Y [T,D,N,H], Y_h/Y_c [D,N,H]. ``present``
    names the optional inputs that follow x/w/r (ONNX leaves gaps with
    empty input names)."""
    it = iter(ins)
    x, w, r = next(it), next(it), next(it)
    b = next(it) if "b" in present else None
    h0 = next(it) if "h0" in present else None
    c0 = next(it) if "c0" in present else None
    hidden = int(hidden_size)
    outs = []
    for d in range(2 if direction == "bidirectional" else 1):
        wb = None if b is None else b[d, :4 * hidden] + b[d, 4 * hidden:]
        outs.append(_lstm_direction(
            x, w[d], r[d], wb, None if h0 is None else h0[d],
            None if c0 is None else c0[d], hidden,
            direction == "reverse" or d == 1))
    return (torch.stack([o[0] for o in outs], dim=1),
            torch.stack([o[1] for o in outs], dim=0),
            torch.stack([o[2] for o in outs], dim=0))


def _gru_op(*ins, hidden_size, direction="forward", present=()):
    """ONNX GRU, layout=0, linear_before_reset=0, Rb_h zero (checked at
    import): x [T,N,In], w [D,3H,In], r [D,3H,H], b [D,6H]. Y [T,D,N,H],
    Y_h [D,N,H]. Computes r ⊙ (h·R_h), the JAX op's cell."""
    it = iter(ins)
    x, w, r = next(it), next(it), next(it)
    b = next(it) if "b" in present else None
    h0 = next(it) if "h0" in present else None
    hidden = int(hidden_size)
    t_len, n = x.shape[:2]
    ys_all, h_all = [], []
    for d in range(2 if direction == "bidirectional" else 1):
        if x.device.type == "meta":
            ys = torch.empty((t_len, n, hidden), dtype=x.dtype,
                             device="meta")
            ys_all.append(ys)
            h_all.append(ys[0])
            continue
        w_x = _blocks(w[d], _ZRH_TO_RZN, hidden).t()
        w_h = _blocks(r[d], _ZRH_TO_RZN, hidden).t()
        bb = None
        if b is not None:
            wb, rb = b[d, :3 * hidden], b[d, 3 * hidden:]
            rb = _blocks(rb, _ZRH_TO_RZN, hidden)
            bb = _blocks(wb, _ZRH_TO_RZN, hidden) + torch.cat(
                [rb[:2 * hidden], torch.zeros_like(rb[:hidden])])
        ys, h_t = _time_major(gru_scan.gru, x,
                              direction == "reverse" or d == 1, w_x, w_h, bb,
                              init_h=None if h0 is None else h0[d])
        ys_all.append(ys)
        h_all.append(h_t)
    return torch.stack(ys_all, dim=1), torch.stack(h_all, dim=0)


_ONNXIMPORT_OPS = {
    "gemm": _gemm_op, "conv": _conv_op, "max_pool": _max_pool_op,
    "average_pool": _average_pool,
    "global_average_pool": lambda x: torch.mean(x, dim=_spatial(x),
                                                keepdim=True),
    "batch_norm": _batch_norm, "layer_norm": _layer_norm,
    "reshape": _reshape_op, "flatten": _flatten_op, "slice": _slice_op,
    "pad": _pad_op, "cast": _cast_op,
    "hard_sigmoid": lambda x, alpha=0.2, beta=0.5: torch.clamp(
        alpha * x + beta, 0.0, 1.0),
    "lrn": _lrn_op,
    "reduce_mean": _reduce_op("mean"), "reduce_sum": _reduce_op("sum"),
    "reduce_max": _reduce_op("max"), "reduce_min": _reduce_op("min"),
    "reduce_prod": _reduce_op("prod"),
    "matmul": matmul,
    "transpose": lambda x, perm=None: x.permute(
        *(perm if perm is not None else reversed(range(x.dim())))),
    "concat": lambda *xs, axis: torch.cat(promote(*xs), dim=axis),
    "softmax": lambda x, axis=-1: torch.softmax(x, dim=axis),
    "log_softmax": lambda x, axis=-1: torch.log_softmax(x, dim=axis),
    "leaky_relu": lambda x, alpha=0.01: torch.where(x >= 0, x, alpha * x),
    "elu": lambda x, alpha=1.0: torch.where(
        x >= 0, x, alpha * (torch.exp(x) - 1)),
    "clip": _clip_op,
    "gather": lambda x, idx, axis=0: _take(x, idx, axis),
    "unsqueeze": lambda x, axes: _expand_dims(x, tuple(int(a) for a in axes)),
    "squeeze": _squeeze_op,
    "where": _where,
    "erf": torch.erf,
    "gelu": lambda x, approximate=True: F.gelu(
        x, approximate="tanh" if approximate else "none"),
    "prelu": lambda x, slope: torch.where(x >= 0, x, slope * x),
    "expand": _expand_op,
    # the breadth extension: recurrent ops, resize, normalizations,
    # multi-output split/topk, extended reductions
    "mod": _mod_op, "is_inf": _is_inf_op,
    "thresholded_relu": lambda x, alpha=1.0: torch.where(
        x > alpha, x, torch.zeros_like(x)),
    "celu": lambda x, alpha=1.0: torch.clamp(x, min=0.0) + torch.clamp(
        alpha * (torch.exp(x / alpha) - 1.0), max=0.0),
    "shrink": lambda x, bias=0.0, lambd=0.5: torch.where(
        x < -lambd, x + bias,
        torch.where(x > lambd, x - bias, torch.zeros_like(x))),
    "hard_swish": lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "argmax": _arg_extreme("max"), "argmin": _arg_extreme("min"),
    "top_k": _top_k, "one_hot": _one_hot_op,
    "cumsum": lambda x, axis, exclusive=0, reverse=0: _tf_cumsum(
        x, int(axis), bool(exclusive), bool(reverse)),
    "einsum": lambda *xs, equation: _tf_einsum(*xs, equation=equation),
    "reduce_l1": _reduce_ext_op("l1"), "reduce_l2": _reduce_ext_op("l2"),
    "reduce_log_sum": _reduce_ext_op("log_sum"),
    "reduce_log_sum_exp": _reduce_ext_op("log_sum_exp"),
    "reduce_sum_square": _reduce_ext_op("sum_square"),
    "depth_to_space": _depth_to_space_op,
    "space_to_depth": _space_to_depth_op,
    "global_max_pool": lambda x: torch.amax(x, dim=_spatial(x),
                                            keepdim=True),
    "conv_transpose": _conv_transpose_op,
    "instance_norm": _instance_norm_op, "group_norm": _group_norm_op,
    "split": _split_op, "gather_elements": _gather_elements_op,
    "trilu": _trilu_op,
    "resize_nearest_int": _resize_nearest_int,
    "resize_linear_half_pixel": _resize_linear_half_pixel,
    "lstm": _lstm_op, "gru": _gru_op,
    "tile": lambda x, repeats: torch.tile(x, tuple(int(r) for r in repeats)),
    # Loop/Scan accumulation: a dense [T, ...] tensor, written and read at
    # a device-side index (no host read)
    "list_set": _list_set,
    "list_get": _list_get,
    "flip0": lambda x: torch.flip(x, (0,)),
    "scalar_bool": lambda x: x.reshape(()).to(torch.bool),
    "fill": _fill,
}


def ensure_onnximport_ops():
    """Register the onnximport.* ops (idempotent). They are registered when
    this module is imported; a SameDiff replaying a loaded graph that holds
    them imports it on demand."""
    for name, fn in _ONNXIMPORT_OPS.items():
        register_op(f"onnximport.{name}", fn)


ensure_onnximport_ops()


def _held(t: TensorProto, arr: np.ndarray):
    """An initializer's value as the graph holds it: the numpy array, but
    a bfloat16 tensor (decoded to float32 by the codec) as bfloat16."""
    if TENSOR_DTYPES.get(t.data_type) == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16)
    return arr


# --- mapper registry -------------------------------------------------------

# mapper(importer, node) -> SDVariable | tuple
ONNX_OP_MAPPERS: Dict[str, Callable] = {}


def onnx_op(*names):
    def deco(fn):
        for n in names:
            ONNX_OP_MAPPERS[n] = fn
        return fn

    return deco


def _simple(op_name):
    """Mapper for ops taking ONNX inputs positionally with no attrs."""

    def mapper(imp: "_GraphImporter", node: NodeProto):
        ins = [imp.tensor(r) for r in node.input if r]
        return imp.sd._record(op_name, ins, {
            "__argspec__": ["var"] * len(ins), "__posattrs__": []})

    return mapper


for onnx_name, our_op in {
    "Add": "add", "Sub": "sub", "Mul": "mul", "Div": "div", "Pow": "pow",
    "Neg": "neg", "Abs": "abs", "Exp": "exp", "Log": "log", "Sqrt": "sqrt",
    "Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
    "Softplus": "softplus", "Erf": "onnximport.erf",
    "Min": "minimum", "Max": "maximum",
    "Equal": "eq", "Greater": "gt", "GreaterOrEqual": "gte",
    "Less": "lt", "LessOrEqual": "lte",
    "Where": "onnximport.where", "MatMul": "onnximport.matmul",
    "PRelu": "onnximport.prelu",
    "Floor": "math.floor", "Ceil": "math.ceil", "Round": "math.round",
    "Sin": "math.sin", "Cos": "math.cos", "Sign": "math.sign",
}.items():
    ONNX_OP_MAPPERS[onnx_name] = _simple(our_op)


def _rec(imp, op, ins, **attrs):
    return imp.sd._record(op, ins, {
        "__argspec__": ["var"] * len(ins), "__posattrs__": [], **attrs})


@onnx_op("Gemm")
def _gemm(imp, node):
    a = node.attrs()
    ins = [imp.tensor(r) for r in node.input if r]
    return _rec(imp, "onnximport.gemm", ins,
                alpha=a.get("alpha", 1.0), beta=a.get("beta", 1.0),
                trans_a=a.get("transA", 0), trans_b=a.get("transB", 0))


@onnx_op("Conv")
def _conv(imp, node):
    a = node.attrs()
    ins = [imp.tensor(r) for r in node.input if r]
    if "kernel_shape" in a:
        nd = len(a["kernel_shape"])
    else:
        # kernel_shape is optional in ONNX; spatial rank comes from the
        # weight tensor [O, I/g, *kernel].
        w_shape = ins[1].shape
        if w_shape is None:
            raise ONNXImportError(
                f"Conv {node.name!r}: no kernel_shape attr and weight "
                "shape unknown")
        nd = len(w_shape) - 2
    return _rec(imp, "onnximport.conv", ins,
                strides=a.get("strides", [1] * nd),
                pads=a.get("pads"), dilations=a.get("dilations", [1] * nd),
                group=a.get("group", 1),
                auto_pad=a.get("auto_pad", "NOTSET"))


@onnx_op("MaxPool")
def _max_pool(imp, node):
    a = node.attrs()
    if a.get("ceil_mode", 0):
        raise ONNXImportError("MaxPool ceil_mode=1 unsupported")
    if len(node.output) > 1 and node.output[1]:
        raise ONNXImportError("MaxPool Indices output unsupported")
    return _rec(imp, "onnximport.max_pool", [imp.tensor(node.input[0])],
                kernel_shape=a["kernel_shape"], strides=a.get("strides"),
                pads=a.get("pads"), auto_pad=a.get("auto_pad", "NOTSET"))


@onnx_op("AveragePool")
def _avg_pool(imp, node):
    a = node.attrs()
    if a.get("ceil_mode", 0):
        raise ONNXImportError("AveragePool ceil_mode=1 unsupported")
    return _rec(imp, "onnximport.average_pool", [imp.tensor(node.input[0])],
                kernel_shape=a["kernel_shape"], strides=a.get("strides"),
                pads=a.get("pads"),
                count_include_pad=a.get("count_include_pad", 0),
                auto_pad=a.get("auto_pad", "NOTSET"))


@onnx_op("GlobalAveragePool")
def _gap(imp, node):
    return _rec(imp, "onnximport.global_average_pool",
                [imp.tensor(node.input[0])])


@onnx_op("BatchNormalization")
def _bn(imp, node):
    a = node.attrs()
    if a.get("training_mode", 0):
        raise ONNXImportError("BatchNormalization training_mode=1 unsupported")
    ins = [imp.tensor(r) for r in node.input[:5]]
    return _rec(imp, "onnximport.batch_norm", ins,
                epsilon=a.get("epsilon", 1e-5))


@onnx_op("LayerNormalization")
def _ln(imp, node):
    a = node.attrs()
    ins = [imp.tensor(r) for r in node.input if r]
    return _rec(imp, "onnximport.layer_norm", ins,
                axis=a.get("axis", -1), epsilon=a.get("epsilon", 1e-5))


@onnx_op("Reshape")
def _reshape(imp, node):
    shape = [int(v) for v in imp.const_value(node.input[1]).reshape(-1)]
    return _rec(imp, "onnximport.reshape", [imp.tensor(node.input[0])],
                shape=shape, allowzero=node.attrs().get("allowzero", 0))


@onnx_op("Flatten")
def _flatten(imp, node):
    return _rec(imp, "onnximport.flatten", [imp.tensor(node.input[0])],
                axis=node.attrs().get("axis", 1))


@onnx_op("Transpose")
def _transpose(imp, node):
    return _rec(imp, "onnximport.transpose", [imp.tensor(node.input[0])],
                perm=node.attrs().get("perm"))


@onnx_op("Concat")
def _concat(imp, node):
    ins = [imp.tensor(r) for r in node.input]
    return _rec(imp, "onnximport.concat", ins, axis=node.attrs()["axis"])


@onnx_op("Softmax")
def _softmax(imp, node):
    return _rec(imp, "onnximport.softmax", [imp.tensor(node.input[0])],
                axis=node.attrs().get("axis", -1))


@onnx_op("LogSoftmax")
def _log_softmax(imp, node):
    return _rec(imp, "onnximport.log_softmax", [imp.tensor(node.input[0])],
                axis=node.attrs().get("axis", -1))


@onnx_op("LeakyRelu")
def _leaky(imp, node):
    return _rec(imp, "onnximport.leaky_relu", [imp.tensor(node.input[0])],
                alpha=node.attrs().get("alpha", 0.01))


@onnx_op("Elu")
def _elu(imp, node):
    return _rec(imp, "onnximport.elu", [imp.tensor(node.input[0])],
                alpha=node.attrs().get("alpha", 1.0))


@onnx_op("HardSigmoid")
def _hard_sigmoid(imp, node):
    a = node.attrs()
    return _rec(imp, "onnximport.hard_sigmoid", [imp.tensor(node.input[0])],
                alpha=a.get("alpha", 0.2), beta=a.get("beta", 0.5))


@onnx_op("LRN")
def _lrn(imp, node):
    a = node.attrs()
    return _rec(imp, "onnximport.lrn", [imp.tensor(node.input[0])],
                size=a["size"], alpha=a.get("alpha", 1e-4),
                beta=a.get("beta", 0.75), bias=a.get("bias", 1.0))


@onnx_op("Clip")
def _clip(imp, node):
    a = node.attrs()
    lo = a.get("min")
    hi = a.get("max")
    if len(node.input) > 1 and node.input[1]:
        lo = float(imp.const_value(node.input[1]))
    if len(node.input) > 2 and node.input[2]:
        hi = float(imp.const_value(node.input[2]))
    return _rec(imp, "onnximport.clip", [imp.tensor(node.input[0])],
                lo=lo, hi=hi)


@onnx_op("Gather")
def _gather(imp, node):
    ins = [imp.tensor(node.input[0]), imp.tensor(node.input[1])]
    return _rec(imp, "onnximport.gather", ins,
                axis=node.attrs().get("axis", 0))


def _axes_attr_or_input(imp, node, idx=1):
    axes = node.attrs().get("axes")
    if axes is None and len(node.input) > idx and node.input[idx]:
        axes = [int(v) for v in imp.const_value(node.input[idx]).reshape(-1)]
    return axes


@onnx_op("Unsqueeze")
def _unsqueeze(imp, node):
    axes = _axes_attr_or_input(imp, node)
    if axes is None:
        raise ONNXImportError("Unsqueeze needs axes")
    return _rec(imp, "onnximport.unsqueeze", [imp.tensor(node.input[0])],
                axes=axes)


@onnx_op("Squeeze")
def _squeeze(imp, node):
    return _rec(imp, "onnximport.squeeze", [imp.tensor(node.input[0])],
                axes=_axes_attr_or_input(imp, node))


@onnx_op("Slice")
def _slice(imp, node):
    a = node.attrs()
    if "starts" in a:  # opset < 10: attributes
        starts, ends = a["starts"], a["ends"]
        axes, steps = a.get("axes"), None
    else:
        starts = [int(v) for v in imp.const_value(node.input[1]).reshape(-1)]
        ends = [int(v) for v in imp.const_value(node.input[2]).reshape(-1)]
        axes = steps = None
        if len(node.input) > 3 and node.input[3]:
            axes = [int(v) for v in imp.const_value(node.input[3]).reshape(-1)]
        if len(node.input) > 4 and node.input[4]:
            steps = [int(v) for v in imp.const_value(node.input[4]).reshape(-1)]
    return _rec(imp, "onnximport.slice", [imp.tensor(node.input[0])],
                starts=list(starts), ends=list(ends), axes=axes, steps=steps)


@onnx_op("Pad")
def _pad(imp, node):
    a = node.attrs()
    mode = a.get("mode", "constant")
    if "pads" in a:  # opset < 11
        pads = a["pads"]
        cval = a.get("value", 0.0)
    else:
        pads = [int(v) for v in imp.const_value(node.input[1]).reshape(-1)]
        cval = 0.0
        if len(node.input) > 2 and node.input[2]:
            cval = float(imp.const_value(node.input[2]))
    return _rec(imp, "onnximport.pad", [imp.tensor(node.input[0])],
                pads=list(pads), constant_value=cval, mode=mode)


@onnx_op("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd")
def _reduce(imp, node):
    kind = node.op_type[len("Reduce"):].lower()
    a = node.attrs()
    axes = _axes_attr_or_input(imp, node)
    return _rec(imp, f"onnximport.reduce_{kind}", [imp.tensor(node.input[0])],
                axes=axes, keepdims=a.get("keepdims", 1),
                noop_with_empty_axes=a.get("noop_with_empty_axes", 0))


@onnx_op("Cast")
def _cast(imp, node):
    return _rec(imp, "onnximport.cast", [imp.tensor(node.input[0])],
                to=node.attrs()["to"])


@onnx_op("Expand")
def _expand(imp, node):
    shape = [int(v) for v in imp.const_value(node.input[1]).reshape(-1)]
    return _rec(imp, "onnximport.expand", [imp.tensor(node.input[0])],
                shape=shape)


@onnx_op("Gelu")
def _gelu(imp, node):
    approximate = node.attrs().get("approximate", "none")
    return _rec(imp, "onnximport.gelu", [imp.tensor(node.input[0])],
                approximate=approximate == "tanh")


@onnx_op("Shape")
def _shape(imp, node):
    v = imp.tensor(node.input[0])
    if v.shape is None or any(d is None for d in v.shape):
        raise ONNXImportError(
            f"Shape of {node.input[0]!r} is not fully static at import")
    arr = np.asarray(v.shape, np.int64)
    name = imp.fresh_const_name(node.name or "shape")
    imp.consts[node.output[0]] = arr
    return imp.sd.constant(name, arr)


@onnx_op("Constant")
def _constant(imp, node):
    a = {at.name: at for at in node.attribute}
    if "value" in a and a["value"].type == ATTR_TENSOR:
        arr = a["value"].t.to_numpy()
    elif "value_float" in a:
        arr = np.asarray(a["value_float"].f, np.float32)
    elif "value_int" in a:
        arr = np.asarray(a["value_int"].i, np.int64)
    elif "value_floats" in a:
        arr = np.asarray(list(a["value_floats"].floats), np.float32)
    elif "value_ints" in a:
        arr = np.asarray(list(a["value_ints"].ints), np.int64)
    else:
        raise ONNXImportError(f"Constant node {node.name!r}: no value attr")
    imp.consts[node.output[0]] = arr
    return imp.sd.constant(imp.fresh_const_name(node.name or "const"), arr)


# --- round-4 breadth mappers ----------------------------------------------

for onnx_name, our_op in {
    "Tan": "math.tan", "Asin": "math.asin", "Acos": "math.acos",
    "Atan": "math.atan", "Sinh": "math.sinh", "Cosh": "math.cosh",
    "Asinh": "math.asinh", "Acosh": "math.acosh", "Atanh": "math.atanh",
    "Reciprocal": "math.reciprocal", "Not": "math.logical_not",
    "And": "math.logical_and", "Or": "math.logical_or",
    "Xor": "math.logical_xor", "IsNaN": "math.is_nan",
    "Selu": "selu", "Softsign": "softsign",
    "Mish": "onnximport.mish", "HardSwish": "onnximport.hard_swish",
    "GlobalMaxPool": "onnximport.global_max_pool",
}.items():
    ONNX_OP_MAPPERS[onnx_name] = _simple(our_op)


@onnx_op("Mod")
def _mod(imp, node):
    ins = [imp.tensor(r) for r in node.input]
    return _rec(imp, "onnximport.mod", ins,
                fmod=node.attrs().get("fmod", 0))


@onnx_op("IsInf")
def _is_inf(imp, node):
    a = node.attrs()
    return _rec(imp, "onnximport.is_inf", [imp.tensor(node.input[0])],
                detect_negative=a.get("detect_negative", 1),
                detect_positive=a.get("detect_positive", 1))


@onnx_op("ThresholdedRelu")
def _thresholded_relu(imp, node):
    return _rec(imp, "onnximport.thresholded_relu",
                [imp.tensor(node.input[0])],
                alpha=node.attrs().get("alpha", 1.0))


@onnx_op("Celu")
def _celu(imp, node):
    return _rec(imp, "onnximport.celu", [imp.tensor(node.input[0])],
                alpha=node.attrs().get("alpha", 1.0))


@onnx_op("Shrink")
def _shrink(imp, node):
    a = node.attrs()
    return _rec(imp, "onnximport.shrink", [imp.tensor(node.input[0])],
                bias=a.get("bias", 0.0), lambd=a.get("lambd", 0.5))


@onnx_op("ArgMax", "ArgMin")
def _argextreme(imp, node):
    a = node.attrs()
    if a.get("select_last_index", 0):
        raise ONNXImportError(f"{node.op_type} select_last_index unsupported")
    op = "onnximport.argmax" if node.op_type == "ArgMax" else "onnximport.argmin"
    return _rec(imp, op, [imp.tensor(node.input[0])],
                axis=a.get("axis", 0), keepdims=a.get("keepdims", 1))


@onnx_op("TopK")
def _topk(imp, node):
    a = node.attrs()
    k = int(imp.const_value(node.input[1]).reshape(-1)[0])
    return _rec(imp, "onnximport.top_k", [imp.tensor(node.input[0])],
                k=k, axis=a.get("axis", -1), largest=a.get("largest", 1),
                sorted=a.get("sorted", 1))


@onnx_op("OneHot")
def _one_hot(imp, node):
    depth = int(imp.const_value(node.input[1]).reshape(-1)[0])
    ins = [imp.tensor(node.input[0]), imp.tensor(node.input[2])]
    return imp.sd._record("onnximport.one_hot", ins, {
        "__argspec__": ["var", "var"], "__posattrs__": [],
        "depth": depth, "axis": node.attrs().get("axis", -1)})


@onnx_op("Range")
def _range(imp, node):
    start, limit, delta = (imp.const_value(r).reshape(()) for r in node.input)
    arr = np.arange(start, limit, delta)
    imp.consts[node.output[0]] = arr
    return imp.sd.constant(imp.fresh_const_name(node.name or "range"), arr)


@onnx_op("ConstantOfShape")
def _const_of_shape(imp, node):
    shape = [int(v) for v in imp.const_value(node.input[0]).reshape(-1)]
    a = {at.name: at for at in node.attribute}
    if "value" in a and a["value"].type == ATTR_TENSOR:
        fill = a["value"].t.to_numpy().reshape(-1)[0]
    else:
        fill = np.float32(0.0)
    arr = np.full(shape, fill)
    imp.consts[node.output[0]] = arr
    return imp.sd.constant(imp.fresh_const_name(node.name or "cofs"), arr)


@onnx_op("CumSum")
def _cumsum(imp, node):
    a = node.attrs()
    axis = int(imp.const_value(node.input[1]).reshape(-1)[0])
    return _rec(imp, "onnximport.cumsum", [imp.tensor(node.input[0])],
                axis=axis, exclusive=a.get("exclusive", 0),
                reverse=a.get("reverse", 0))


@onnx_op("Einsum")
def _einsum(imp, node):
    ins = [imp.tensor(r) for r in node.input]
    return _rec(imp, "onnximport.einsum", ins,
                equation=node.attrs()["equation"])


@onnx_op("ReduceL1", "ReduceL2", "ReduceLogSum", "ReduceLogSumExp",
         "ReduceSumSquare")
def _reduce_ext(imp, node):
    kind = {"ReduceL1": "l1", "ReduceL2": "l2", "ReduceLogSum": "log_sum",
            "ReduceLogSumExp": "log_sum_exp",
            "ReduceSumSquare": "sum_square"}[node.op_type]
    a = node.attrs()
    axes = _axes_attr_or_input(imp, node)
    return _rec(imp, f"onnximport.reduce_{kind}", [imp.tensor(node.input[0])],
                axes=axes, keepdims=a.get("keepdims", 1),
                noop_with_empty_axes=a.get("noop_with_empty_axes", 0))


@onnx_op("DepthToSpace")
def _depth_to_space(imp, node):
    a = node.attrs()
    return _rec(imp, "onnximport.depth_to_space", [imp.tensor(node.input[0])],
                blocksize=a["blocksize"], mode=a.get("mode", "DCR"))


@onnx_op("SpaceToDepth")
def _space_to_depth(imp, node):
    return _rec(imp, "onnximport.space_to_depth", [imp.tensor(node.input[0])],
                blocksize=node.attrs()["blocksize"])


@onnx_op("ConvTranspose")
def _conv_transpose(imp, node):
    a = node.attrs()
    if a.get("auto_pad", "NOTSET") != "NOTSET":
        raise ONNXImportError("ConvTranspose auto_pad unsupported")
    if any(a.get("output_padding", [])):
        raise ONNXImportError("ConvTranspose output_padding unsupported")
    if "output_shape" in a:
        raise ONNXImportError("ConvTranspose output_shape unsupported")
    if a.get("group", 1) != 1:
        raise ONNXImportError("ConvTranspose group != 1 unsupported")
    if any(d != 1 for d in a.get("dilations", [])):
        # the conv_transpose op runs undilated; importing would
        # silently produce wrong activations AND a wrong output shape.
        raise ONNXImportError("ConvTranspose dilations != 1 unsupported")
    ins = [imp.tensor(r) for r in node.input if r]
    w_shape = ins[1].shape
    nd = (len(a["kernel_shape"]) if "kernel_shape" in a
          else len(w_shape) - 2 if w_shape else 2)
    if nd not in (2, 3):
        raise ONNXImportError(f"ConvTranspose spatial rank {nd} unsupported")
    return _rec(imp, "onnximport.conv_transpose", ins,
                strides=a.get("strides", [1] * nd), pads=a.get("pads"),
                group=1)


@onnx_op("InstanceNormalization")
def _instance_norm(imp, node):
    ins = [imp.tensor(r) for r in node.input[:3]]
    return _rec(imp, "onnximport.instance_norm", ins,
                epsilon=node.attrs().get("epsilon", 1e-5))


@onnx_op("GroupNormalization")
def _group_norm(imp, node):
    a = node.attrs()
    ins = [imp.tensor(r) for r in node.input[:3]]
    return _rec(imp, "onnximport.group_norm", ins,
                num_groups=a["num_groups"], epsilon=a.get("epsilon", 1e-5))


@onnx_op("Split")
def _split(imp, node):
    a = node.attrs()
    split_sizes = a.get("split")
    if split_sizes is None and len(node.input) > 1 and node.input[1]:
        split_sizes = [int(v)
                       for v in imp.const_value(node.input[1]).reshape(-1)]
    x = imp.tensor(node.input[0])
    axis = a.get("axis", 0)
    k = a.get("num_outputs", len(node.output))
    # Validate HERE, where the static dim is known and the error names the
    # node — a raise inside the op fn is swallowed by _infer's eval_shape
    # guard, which records ONE output for the node and crashes downstream
    # with a confusing output-binding error.
    if split_sizes is None and x.shape is not None:
        dim = x.shape[axis if axis >= 0 else axis + len(x.shape)]
        if dim is not None:
            chunk = -(-int(dim) // int(k))
            if int(dim) - chunk * (int(k) - 1) <= 0:
                raise ONNXImportError(
                    f"Split node '{node.name}': num_outputs={k} too large "
                    f"for axis dim {dim}")
    return _rec(imp, "onnximport.split", [x],
                axis=axis, split_sizes=split_sizes, num_outputs=k)


@onnx_op("Tile")
def _tile(imp, node):
    repeats = [int(v) for v in imp.const_value(node.input[1]).reshape(-1)]
    return _rec(imp, "onnximport.tile", [imp.tensor(node.input[0])],
                repeats=repeats)


@onnx_op("GatherElements")
def _gather_elements(imp, node):
    ins = [imp.tensor(node.input[0]), imp.tensor(node.input[1])]
    return _rec(imp, "onnximport.gather_elements", ins,
                axis=node.attrs().get("axis", 0))


@onnx_op("Trilu")
def _trilu(imp, node):
    k = 0
    if len(node.input) > 1 and node.input[1]:
        k = int(imp.const_value(node.input[1]).reshape(-1)[0])
    return _rec(imp, "onnximport.trilu", [imp.tensor(node.input[0])],
                k=k, upper=node.attrs().get("upper", 1))


def _resize_scales_sizes(imp, node, x):
    """Resolve (scales, out_shape) from a Resize/Upsample node's inputs."""
    scales = sizes = None
    # Resize inputs: X, roi, scales, sizes (any of roi/scales empty).
    if node.op_type == "Upsample":
        if len(node.input) > 1 and node.input[1]:
            scales = [float(v)
                      for v in imp.const_value(node.input[1]).reshape(-1)]
        else:
            scales = list(node.attrs().get("scales", []))
    else:
        if len(node.input) > 2 and node.input[2]:
            scales = [float(v)
                      for v in imp.const_value(node.input[2]).reshape(-1)]
        if len(node.input) > 3 and node.input[3]:
            sizes = [int(v)
                     for v in imp.const_value(node.input[3]).reshape(-1)]
    if scales is not None and len(scales) == 0:
        scales = None
    if scales is None and sizes is None:
        raise ONNXImportError(f"{node.op_type}: needs scales or sizes")
    if x.shape is None or any(d is None for d in x.shape):
        # both conversions below need concrete dims
        raise ONNXImportError(
            f"{node.op_type}: input shape must be fully static at import "
            f"(got {x.shape})")
    if sizes is None:
        # Spec: output_size = floor(input_size * scale) — round() would
        # disagree with onnxruntime on fractional scales (5 * 1.5 -> 7,
        # not 8). The epsilon must be RELATIVE: scales arrive float32
        # (~1e-7 ulp), so an intended-integer product reads d*(1 - 1e-7)
        # and a d-independent 1e-9 cannot lift it back over the floor.
        sizes = [int(math.floor(d * s * (1 + 1e-6) + 1e-9))
                 for d, s in zip(x.shape, scales)]
    if scales is None:
        scales = [o / d for o, d in zip(sizes, x.shape)]
    return scales, sizes


@onnx_op("Resize", "Upsample")
def _resize(imp, node):
    a = node.attrs()
    mode = a.get("mode", "nearest")
    coord = a.get("coordinate_transformation_mode",
                  "asymmetric" if node.op_type == "Upsample" else "half_pixel")
    x = imp.tensor(node.input[0])
    scales, sizes = _resize_scales_sizes(imp, node, x)
    if mode == "nearest":
        # exact only for integer upscale factors with asymmetric coords +
        # floor rounding (the classic Upsample) — the repeat identity
        if coord not in ("asymmetric",):
            raise ONNXImportError(
                f"Resize nearest with coordinate mode {coord!r} unsupported "
                "(asymmetric only)")
        if a.get("nearest_mode", "round_prefer_floor") not in (
                "floor", "round_prefer_floor"):
            raise ONNXImportError("Resize nearest_mode unsupported")
        if any(abs(s - round(s)) > 1e-6 or s < 1 for s in scales):
            raise ONNXImportError(
                f"Resize nearest with non-integer scales {scales} unsupported")
        return _rec(imp, "onnximport.resize_nearest_int", [x],
                    scales=[int(round(s)) for s in scales])
    if mode == "linear":
        if coord != "half_pixel":
            raise ONNXImportError(
                f"Resize linear with coordinate mode {coord!r} unsupported "
                "(half_pixel only)")
        return _rec(imp, "onnximport.resize_linear_half_pixel", [x],
                    out_shape=sizes)
    raise ONNXImportError(f"Resize mode {mode!r} unsupported")


def _rnn_common(imp, node, n_gates):
    a = node.attrs()
    if a.get("layout", 0) != 0:
        raise ONNXImportError(f"{node.op_type} layout=1 unsupported")
    if "activations" in a:
        defaults = {2: [b"Sigmoid", b"Tanh"],
                    3: [b"Sigmoid", b"Tanh", b"Tanh"]}[n_gates]
        acts = [v if isinstance(v, bytes) else v.encode()
                for v in a["activations"]]
        dirs = 2 if a.get("direction", "forward") == "bidirectional" else 1
        if acts != defaults * dirs:
            raise ONNXImportError(
                f"{node.op_type} non-default activations {acts} unsupported")
    if "clip" in a:
        raise ONNXImportError(f"{node.op_type} clip unsupported")
    if len(node.input) > 4 and node.input[4]:
        raise ONNXImportError(
            f"{node.op_type} sequence_lens input unsupported")
    direction = a.get("direction", "forward")
    if direction not in ("forward", "reverse", "bidirectional"):
        raise ONNXImportError(f"{node.op_type} direction {direction!r}")
    return a, direction


@onnx_op("LSTM")
def _lstm(imp, node):
    a, direction = _rnn_common(imp, node, n_gates=3)
    if a.get("input_forget", 0):
        raise ONNXImportError("LSTM input_forget unsupported")
    if len(node.input) > 7 and node.input[7]:
        raise ONNXImportError("LSTM peephole input P unsupported")
    ins = [imp.tensor(node.input[i]) for i in range(3)]
    present = []
    for idx, tag in ((3, "b"), (5, "h0"), (6, "c0")):
        if len(node.input) > idx and node.input[idx]:
            ins.append(imp.tensor(node.input[idx]))
            present.append(tag)
    return _rec(imp, "onnximport.lstm", ins,
                hidden_size=a["hidden_size"], direction=direction,
                present=present)


@onnx_op("GRU")
def _gru(imp, node):
    a, direction = _rnn_common(imp, node, n_gates=2)
    if a.get("linear_before_reset", 0):
        raise ONNXImportError("GRU linear_before_reset=1 unsupported")
    H = a["hidden_size"]
    ins = [imp.tensor(node.input[i]) for i in range(3)]
    present = []
    if len(node.input) > 3 and node.input[3]:
        # our gru_cell adds the candidate bias OUTSIDE the reset gate; that
        # matches ONNX linear_before_reset=0 only when Rb_h == 0 — verify
        # on the host-known initializer rather than import wrong math
        bval = imp.consts.get(node.input[3])
        if bval is None:
            raise ONNXImportError("GRU bias must be an initializer")
        if np.any(bval[:, 5 * H:6 * H] != 0):
            raise ONNXImportError(
                "GRU with nonzero recurrent candidate bias Rb_h is "
                "unsupported (linear_before_reset=0 semantics differ)")
        ins.append(imp.tensor(node.input[3]))
        present.append("b")
    if len(node.input) > 5 and node.input[5]:
        ins.append(imp.tensor(node.input[5]))
        present.append("h0")
    return _rec(imp, "onnximport.gru", ins,
                hidden_size=H, direction=direction, present=present)


@onnx_op("Dropout")
def _dropout(imp, node):
    # Inference import: identity (mask output unsupported).
    if len(node.output) > 1 and node.output[1]:
        raise ONNXImportError("Dropout mask output unsupported")
    return imp.tensor(node.input[0])


@onnx_op("Identity")
def _identity(imp, node):
    v = imp.tensor(node.input[0])
    if node.input[0] in imp.consts:
        imp.consts[node.output[0]] = imp.consts[node.input[0]]
    return v


def _make_scan_accumulators(imp, bsd, iter_ph, trip, scan_out_vars,
                            node_name):
    """Preallocated dense accumulators for per-iteration scan outputs
    (shared by Loop and Scan): an outer lazy fill [trip, *elem] per
    output, a body-side placeholder, and a list_set write at the carry's
    iteration index. Returns (outer accs, body output names)."""
    accs, acc_body_outs = [], []
    for sv in scan_out_vars:
        if sv.shape is None or any(d in (None, -1)
                                   for d in (sv.shape or ())):
            raise ONNXImportError(
                f"{node_name!r}: scan output {sv.name!r} has unknown "
                f"shape {sv.shape}; cannot preallocate")
        acc_shape = (trip, *[int(d) for d in sv.shape])
        acc_dtype = str(np.dtype(sv.dtype or "float32"))
        # lazy fill, not a dense zeros constant — no O(T·elem) zero bytes
        # in the graph or its serializations
        acc_zero = imp.sd.constant(
            imp.fresh_const_name(f"{node_name}_acc_zero"),
            np.zeros((), acc_dtype))
        accs.append(imp.sd._record("onnximport.fill", [acc_zero], {
            "__argspec__": ["attr", "var"],
            "__posattrs__": [list(acc_shape)]}))
        acc_ph = bsd.placeholder(
            f"__{node_name}_acc{len(acc_body_outs)}", acc_shape, acc_dtype)
        acc_body_outs.append(bsd._record(
            "onnximport.list_set", [acc_ph, iter_ph, sv], {}).name)
    return accs, acc_body_outs


@onnx_op("If")
def _if_onnx(imp, node):
    """ONNX If → SameDiff.cond. Branch subgraphs take no
    declared inputs; everything they read is implicit capture, which
    becomes the cond's operand list (union of both branches, fixed
    order, host-known captures inlined as constants)."""
    a = node.attrs()
    then_g, else_g = a.get("then_branch"), a.get("else_branch")
    if not isinstance(then_g, GraphProto) or not isinstance(else_g, GraphProto):
        raise ONNXImportError(
            f"If {node.name!r}: then_branch/else_branch graph attrs missing")
    if len(then_g.output) != len(else_g.output):
        raise ONNXImportError(
            f"If {node.name!r}: branches disagree on output count "
            f"({len(then_g.output)} vs {len(else_g.output)})")
    pred = _rec(imp, "onnximport.scalar_bool", [imp.tensor(node.input[0])])
    all_caps, var_caps = _union_captures(imp, [then_g, else_g])
    t_sub = _import_onnx_subgraph(imp, then_g, [], all_caps, var_caps).sd
    f_sub = _import_onnx_subgraph(imp, else_g, [], all_caps, var_caps).sd
    return imp.sd.cond(pred, t_sub, f_sub,
                       [imp.tensor(c) for c in var_caps])


@onnx_op("Loop")
def _loop_onnx(imp, node):
    """ONNX Loop → SameDiff.while_loop.

    Loop(M?, cond?, v_1..N) with body (iter, cond_in, v_1..N) ->
    (cond_out, v_1..N_out, scan_1..K). The carry is
    (i, cond, v..., captures..., scan accumulators...); captures ride as
    pass-through loop vars (loop-invariant), scan outputs accumulate via
    list_set into a preallocated [M, ...] tensor.

    Scan outputs need the dense preallocation, so K > 0 additionally
    requires a host-known trip count M and an effectively-constant-true
    loop condition (the standard for-loop export shape); ONNX's
    dynamic-length scan semantics have no static-shape equivalent and are
    refused otherwise, as the JAX package refuses them.
    """
    a = node.attrs()
    body = a.get("body")
    if not isinstance(body, GraphProto):
        raise ONNXImportError(f"Loop {node.name!r}: body graph attr missing")
    m_ref = node.input[0] if len(node.input) > 0 else ""
    c_ref = node.input[1] if len(node.input) > 1 else ""
    v_inits = [imp.tensor(r) for r in node.input[2:]]
    n_v = len(v_inits)
    if len(body.input) != 2 + n_v:
        raise ONNXImportError(
            f"Loop {node.name!r}: body takes {len(body.input)} inputs, "
            f"expected {2 + n_v}")
    n_scan = len(body.output) - 1 - n_v
    if n_scan < 0:
        raise ONNXImportError(
            f"Loop {node.name!r}: body yields {len(body.output)} outputs "
            f"for {n_v} loop vars")

    sd = imp.sd
    zero = sd.constant(imp.fresh_const_name(f"{node.name}_i0"),
                       np.zeros((), np.int32))
    has_m = bool(m_ref)
    m_var = imp.tensor(m_ref) if has_m else None
    m_const = None
    if has_m and m_ref in imp.consts:
        m_const = int(np.asarray(imp.consts[m_ref]).reshape(()))
    if c_ref:
        cond0 = _rec(imp, "onnximport.scalar_bool", [imp.tensor(c_ref)])
    else:
        cond0 = sd.constant(imp.fresh_const_name(f"{node.name}_true"),
                            np.asarray(True))
    if has_m:
        # first-iteration gate: run iff cond0 AND 0 < M
        cond0 = _rec(imp, "math.logical_and", [
            cond0, _rec(imp, "lt", [zero, m_var])])
    # a while_loop cond must be a SCALAR bool; scalar initializers can
    # decode as shape-(1,) tensors, which would poison the whole carry
    cond0 = _rec(imp, "onnximport.scalar_bool", [cond0])

    all_caps, var_caps = _union_captures(imp, [body])
    # iter/cond/v placeholders take the INIT vars' shapes; the body's
    # declared input value-infos are usually shapeless in real exports
    class _Spec:
        def __init__(self, shape, dtype):
            self.shape, self.dtype = shape, dtype

    declared = [_Spec((), "int32"), _Spec((), "bool")] + [
        _Spec(v.shape, v.dtype or "float32") for v in v_inits]
    simp = _import_onnx_subgraph(imp, body, declared, all_caps, var_caps)
    bsd = simp.sd
    iter_ph = bsd._vars[body.input[0].name]
    cond_out = bsd._vars[bsd.branch_outputs[0]]
    v_outs = list(bsd.branch_outputs[1:1 + n_v])
    scan_outs = [bsd._vars[n] for n in bsd.branch_outputs[1 + n_v:]]

    # placeholder DECLARATION order defines the positional carry mapping
    # (_as_branch_fn): [i, cond, v..., caps...] are declared by the
    # subgraph import; M (if any) must come before the accumulators
    m_ph = bsd.placeholder(f"__{node.name}_M", (), "int32") if has_m else None

    # for-loop certification: constant-true initial cond AND a body that
    # provably keeps it true (constant or cond passthrough). Required for
    # scan outputs (an early data-dependent exit would shorten the scan
    # dimension — no static-shape equivalent); when it holds with a
    # host-constant M, the cond graph is emitted in counter form
    # (i < M) so samediff's scan-lowering makes the loop differentiable.
    cond0_true = not c_ref or (
        c_ref in imp.consts
        and bool(np.asarray(imp.consts[c_ref]).reshape(())))
    cond_is_pass = cond_out.name == body.input[1].name
    cond_is_const_true = (
        cond_out.var_type == VariableType.CONSTANT
        and bool(bsd._values[cond_out.name].reshape(()).item()))
    for_loop = (m_const is not None and cond0_true
                and (cond_is_pass or cond_is_const_true))

    # scan accumulators: preallocated dense arrays, written at carry's i
    accs = []
    acc_body_outs = []
    if n_scan:
        if m_const is None:
            raise ONNXImportError(
                f"Loop {node.name!r}: scan outputs need a host-constant "
                "trip count M (dynamic-length scans have no static shape)")
        if not cond0_true:
            raise ONNXImportError(
                f"Loop {node.name!r}: scan outputs require a constant-true "
                "initial condition (for-loop form)")
        if not (cond_is_pass or cond_is_const_true):
            raise ONNXImportError(
                f"Loop {node.name!r}: scan outputs require a for-loop body "
                "(cond_out must be constant true or the cond passthrough); "
                f"got computed condition {cond_out.name!r}")
        accs, acc_body_outs = _make_scan_accumulators(
            imp, bsd, iter_ph, m_const, scan_outs, node.name)

    # body-side: i+1 and the next-iteration condition
    bsd_one = bsd.constant("__loop_one", np.ones((), np.int32))
    new_i = bsd._record("add", [iter_ph, bsd_one], {})
    cond_next = bsd._record("onnximport.scalar_bool", [cond_out], {})
    if has_m:
        cond_next = bsd._record("math.logical_and", [
            cond_next, bsd._record("lt", [new_i, m_ph], {})], {})
        cond_next = bsd._record("onnximport.scalar_bool", [cond_next], {})
    bsd.branch_outputs = (
        [new_i.name, cond_next.name] + v_outs
        + list(var_caps) + ([m_ph.name] if has_m else []) + acc_body_outs)

    # cond graph: counter form (i < M) for certified for-loops — the
    # samediff replay detects it and takes the static route (no host
    # read, differentiable); otherwise a pass-through read of the carried
    # bool (one condition read an iteration)
    csd = SameDiff.create(sd.device)
    ci = csd.placeholder("__i", (), "int32")
    c_ph = csd.placeholder("__cond", (), "bool")
    for i, v in enumerate(v_inits):
        csd.placeholder(f"__v{i}", v.shape, v.dtype or "float32")
    for i, c in enumerate(var_caps):
        cv = imp.tensor(c)
        csd.placeholder(f"__c{i}", cv.shape, cv.dtype or "float32")
    if has_m:
        csd.placeholder("__M", (), "int32")
    for i, acc in enumerate(accs):
        csd.placeholder(f"__a{i}", acc.shape, acc.dtype)
    if for_loop:
        bound = csd.constant("__M_const", np.asarray(m_const, np.int32))
        csd.branch_outputs = [csd._record("lt", [ci, bound], {}).name]
    else:
        csd.branch_outputs = [c_ph.name]

    m_scalar = None
    if has_m:
        m_scalar = sd._record("reshape", [sd._record(
            "cast", [m_var], {"dtype": "int32"})], {"shape": []})
    inits = ([zero, cond0] + v_inits
             + [imp.tensor(c) for c in var_caps]
             + ([m_scalar] if has_m else []) + accs)
    res = sd.while_loop(csd, bsd, inits)
    res = res if isinstance(res, tuple) else (res,)
    v_finals = tuple(res[2:2 + n_v])
    scan_finals = tuple(res[2 + n_v + len(var_caps) + (1 if has_m else 0):])
    return v_finals + scan_finals


@onnx_op("Scan")
def _scan_onnx(imp, node):
    """ONNX Scan → while_loop over a STATIC trip count (the scan-input
    length — known at import, unlike Loop's M), so the static route:
    carry (i, states..., captures..., scan-inputs..., accumulators...),
    per-step elements read with list_get, outputs accumulated with
    list_set. Reverse directions flip at the boundary.
    scan axes other than 0 are refused (transpose before/after instead).
    """
    a = node.attrs()
    body = a.get("body")
    if not isinstance(body, GraphProto):
        raise ONNXImportError(f"Scan {node.name!r}: body graph attr missing")
    k = int(a.get("num_scan_inputs", 0))
    n_states = len(node.input) - k
    if k < 1 or n_states < 0:
        raise ONNXImportError(
            f"Scan {node.name!r}: num_scan_inputs={k} with "
            f"{len(node.input)} inputs")
    if len(body.input) != n_states + k:
        raise ONNXImportError(
            f"Scan {node.name!r}: body takes {len(body.input)} inputs, "
            f"expected {n_states + k}")
    n_scan_out = len(body.output) - n_states
    if n_scan_out < 0:
        raise ONNXImportError(
            f"Scan {node.name!r}: body yields {len(body.output)} outputs "
            f"for {n_states} states")
    for key in ("scan_input_axes", "scan_output_axes"):
        axes = a.get(key)
        if axes and any(int(x) != 0 for x in axes):
            raise ONNXImportError(
                f"Scan {node.name!r}: {key}={axes} unsupported (axis 0 "
                "only; transpose around the Scan instead)")
    in_dirs = [int(d) for d in (a.get("scan_input_directions")
                                or [0] * k)]
    out_dirs = [int(d) for d in (a.get("scan_output_directions")
                                 or [0] * n_scan_out)]
    if len(in_dirs) != k or len(out_dirs) != n_scan_out:
        raise ONNXImportError(
            f"Scan {node.name!r}: directions length mismatch "
            f"(inputs {len(in_dirs)}/{k}, outputs "
            f"{len(out_dirs)}/{n_scan_out})")

    sd = imp.sd
    state_inits = [imp.tensor(r) for r in node.input[:n_states]]
    scan_ins = [imp.tensor(r) for r in node.input[n_states:]]
    trip = None
    for v in scan_ins:
        if not v.shape or v.shape[0] in (None, -1):
            raise ONNXImportError(
                f"Scan {node.name!r}: scan input {v.name!r} needs a "
                f"static leading dim, got shape {v.shape}")
        if trip is None:
            trip = int(v.shape[0])
        elif int(v.shape[0]) != trip:
            raise ONNXImportError(
                f"Scan {node.name!r}: scan inputs disagree on length "
                f"({trip} vs {v.shape[0]})")
    scan_ins = [
        _rec(imp, "onnximport.flip0", [v]) if d == 1 else v
        for v, d in zip(scan_ins, in_dirs)]

    all_caps, var_caps = _union_captures(imp, [body])
    # body subgraph, assembled manually: the declared scan-element inputs
    # are COMPUTED (list_get at i), not placeholders, so the carry is
    # [i, states..., captures..., full scan inputs..., accumulators...]
    sub = SameDiff.create(sd.device)
    simp = _GraphImporter(body, {}, sub)
    i_ph = sub.placeholder(f"__{node.name}_i", (), "int32")
    for vi, v in zip(body.input[:n_states], state_inits):
        simp.vars[vi.name] = sub.placeholder(
            vi.name, v.shape, v.dtype or "float32")
    for c in var_caps:
        v = imp.tensor(c)
        simp.vars[c] = sub.placeholder(c, v.shape, v.dtype or "float32")
    scanin_phs = []
    for j, v in enumerate(scan_ins):
        ph = sub.placeholder(f"__{node.name}_xs{j}", v.shape,
                             v.dtype or "float32")
        scanin_phs.append(ph)
    for vi, ph in zip(body.input[n_states:], scanin_phs):
        simp.vars[vi.name] = sub._record(
            "onnximport.list_get", [ph, i_ph], {})
    _seed_subgraph_constants(imp, simp, body, all_caps)
    simp._process_nodes()
    state_out_names = [simp.tensor(o.name).name
                       for o in body.output[:n_states]]
    scan_out_vars = [simp.tensor(o.name)
                     for o in body.output[n_states:]]

    accs, acc_body_outs = _make_scan_accumulators(
        imp, sub, i_ph, trip, scan_out_vars, node.name)

    one = sub.constant(f"__{node.name}_one", np.ones((), np.int32))
    new_i = sub._record("add", [i_ph, one], {})
    sub.branch_outputs = (
        [new_i.name] + state_out_names + list(var_caps)
        + [ph.name for ph in scanin_phs] + acc_body_outs)

    csd = SameDiff.create(sd.device)
    ci = csd.placeholder("__i", (), "int32")
    for j, v in enumerate(state_inits):
        csd.placeholder(f"__s{j}", v.shape, v.dtype or "float32")
    for j, c in enumerate(var_caps):
        cv = imp.tensor(c)
        csd.placeholder(f"__c{j}", cv.shape, cv.dtype or "float32")
    for j, v in enumerate(scan_ins):
        csd.placeholder(f"__x{j}", v.shape, v.dtype or "float32")
    for j, acc in enumerate(accs):
        csd.placeholder(f"__a{j}", acc.shape, acc.dtype)
    trip_c = csd.constant("__trip", np.asarray(trip, np.int32))
    csd.branch_outputs = [csd._record("lt", [ci, trip_c], {}).name]

    zero = sd.constant(imp.fresh_const_name(f"{node.name}_i0"),
                       np.zeros((), np.int32))
    inits = ([zero] + state_inits + [imp.tensor(c) for c in var_caps]
             + scan_ins + accs)
    res = sd.while_loop(csd, sub, inits)
    res = res if isinstance(res, tuple) else (res,)
    states_final = list(res[1:1 + n_states])
    accs_final = list(res[1 + n_states + len(var_caps) + k:])
    accs_final = [
        _rec(imp, "onnximport.flip0", [v]) if d == 1 else v
        for v, d in zip(accs_final, out_dirs)]
    return tuple(states_final + accs_final)


# --- host constant folding --------------------------------------------------
# Real exporters (torch.onnx above all) compute shape arguments with small
# on-graph arithmetic chains: Shape → Gather → Unsqueeze → Concat/Mul feeds
# a Reshape or an LSTM initial-state ConstantOfShape. Shape/Constant already
# land in imp.consts; these folders propagate host values through the
# arithmetic so downstream const_value() lookups succeed. Folding is
# best-effort and does not replace the emitted graph ops — it only records
# the host value alongside.


def _fold_axes(node, arrs, key="axes"):
    """axes from attr (opset<13) or trailing const input (opset>=13)."""
    a = node.attrs()
    if key in a:
        ax = a[key]
        return [int(v) for v in (ax if isinstance(ax, (list, tuple)) else [ax])]
    if len(arrs) > 1:
        return [int(v) for v in np.asarray(arrs[1]).reshape(-1)]
    return None


def _fold_cast(node, arrs):
    to = TENSOR_DTYPES.get(int(node.attrs().get("to", 1)))
    return arrs[0].astype(np.dtype(to))


def _fold_div(node, arrs):
    a, b = arrs[0], arrs[1]
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        # ONNX integer Div truncates toward zero (shape math is positive,
        # where trunc == floor)
        return (np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))).astype(
            np.asarray(a).dtype)
    return a / b


def _fold_slice(node, arrs):
    x = arrs[0]
    starts = np.asarray(arrs[1]).reshape(-1)
    ends = np.asarray(arrs[2]).reshape(-1)
    axes = (np.asarray(arrs[3]).reshape(-1) if len(arrs) > 3
            else np.arange(len(starts)))
    steps = (np.asarray(arrs[4]).reshape(-1) if len(arrs) > 4
             else np.ones(len(starts), np.int64))
    sl = [slice(None)] * x.ndim
    for s, e, ax, st in zip(starts, ends, axes, steps):
        sl[int(ax)] = slice(int(s), int(e), int(st))
    return x[tuple(sl)]


def _fold_unsqueeze(node, arrs):
    out = arrs[0]
    axes = _fold_axes(node, arrs) or []
    # ONNX negative axes are relative to the OUTPUT rank (input rank +
    # len(axes));
    # normalize before sorting or multiple negative axes land wrong
    out_rank = out.ndim + len(axes)
    for ax in sorted(a + out_rank if a < 0 else a for a in axes):
        out = np.expand_dims(out, int(ax))
    return out


def _fold_squeeze(node, arrs):
    axes = _fold_axes(node, arrs)
    if axes is None:
        return np.squeeze(arrs[0])
    return np.squeeze(arrs[0], axis=tuple(int(a) for a in axes))


def _fold_reduce_prod(node, arrs):
    axes = _fold_axes(node, arrs)
    # "empty axes" = absent attr/input OR an empty axes tensor (opset-18
    # allows both spellings; the runtime reduce_op honors len()==0 too)
    if not axes and node.attrs().get("noop_with_empty_axes", 0):
        return arrs[0]
    return np.prod(arrs[0], axis=(tuple(axes) if axes else None),
                   keepdims=bool(node.attrs().get("keepdims", 1)))


_HOST_FOLDABLE = {
    "Gather": lambda n, a: np.take(a[0], a[1].astype(np.int64),
                                   axis=int(n.attrs().get("axis", 0))),
    "Concat": lambda n, a: np.concatenate(
        [np.atleast_1d(x) for x in a], axis=int(n.attrs().get("axis", 0))),
    "Unsqueeze": _fold_unsqueeze,
    "Squeeze": _fold_squeeze,
    "Add": lambda n, a: a[0] + a[1],
    "Sub": lambda n, a: a[0] - a[1],
    "Mul": lambda n, a: a[0] * a[1],
    "Div": _fold_div,
    "Neg": lambda n, a: -a[0],
    "Cast": _fold_cast,
    "Slice": _fold_slice,
    "ReduceProd": _fold_reduce_prod,
    "Reshape": lambda n, a: a[0].reshape(
        [int(v) for v in np.asarray(a[1]).reshape(-1)]),
    # boolean shape-select chains (torch exports Where/Equal around
    # dynamic-vs-static dims in e.g. HF attention-mask expansion)
    "Equal": lambda n, a: a[0] == a[1],
    "Greater": lambda n, a: a[0] > a[1],
    "Less": lambda n, a: a[0] < a[1],
    "Not": lambda n, a: ~a[0].astype(bool),
    "Where": lambda n, a: np.where(a[0].astype(bool), a[1], a[2]),
    "Expand": lambda n, a: np.broadcast_to(
        a[0], np.broadcast_shapes(
            a[0].shape, tuple(int(v) for v in np.asarray(a[1]).reshape(-1)))),
    "Min": lambda n, a: np.minimum.reduce(a),
    "Max": lambda n, a: np.maximum.reduce(a),
}


# --- the importer ----------------------------------------------------------


class _GraphImporter:
    """Walks GraphProto nodes, emitting SameDiff ops via the registry
    (↔ samediff-import-onnx's OnnxFrameworkImporter)."""

    def __init__(self, graph: GraphProto, input_shapes: Dict[str, Tuple],
                 sd: SameDiff):
        self.g = graph
        self.sd = sd
        self.input_shapes = input_shapes
        self.vars: Dict[str, Any] = {}   # onnx value name -> SDVariable
        self.consts: Dict[str, np.ndarray] = {}

    def tensor(self, ref: str) -> SDVariable:
        v = self.vars.get(ref)
        if v is None:
            raise ONNXImportError(f"value {ref!r} produced by unknown node")
        return v

    def const_value(self, ref: str) -> np.ndarray:
        if ref not in self.consts:
            raise ONNXImportError(
                f"op needs host-known constant for {ref!r} (shapes/axes/pads "
                "must be initializers or Constant nodes)")
        return self.consts[ref]

    def _try_fold(self, node) -> None:
        """Best-effort host evaluation when every input is host-known (see
        _HOST_FOLDABLE above); failures leave the graph untouched."""
        fold = _HOST_FOLDABLE.get(node.op_type)
        if fold is None or node.output[0] in self.consts:
            return
        if not all(r in self.consts for r in node.input if r):
            return
        # Shape-math tensors are tiny; a cap keeps weight-sized initializer
        # chains (Cast/Mul over multi-MB arrays) from being host-evaluated
        # and duplicated into self.consts for no consumer.
        if any(self.consts[r].size > 4096 for r in node.input if r):
            return
        try:
            self.consts[node.output[0]] = np.asarray(
                fold(node, [self.consts[r] for r in node.input if r]))
        except Exception:  # noqa: BLE001 - folding is advisory only
            pass

    def fresh_const_name(self, base: str) -> str:
        name = base or "const"
        i = 0
        while name in self.sd._vars:
            i += 1
            name = f"{base}__{i}"
        return name

    def run(self, outputs: Sequence[str]) -> Dict[str, str]:
        init_names = set()
        for t in self.g.initializer:
            arr = t.to_numpy()
            self.consts[t.name] = arr
            self.vars[t.name] = self.sd.constant(
                self.fresh_const_name(t.name), _held(t, arr))
            init_names.add(t.name)

        for vi in self.g.input:
            if vi.name in init_names:
                continue
            shape = self.input_shapes.get(vi.name)
            if shape is None:
                if vi.type is None or vi.type.shape is None:
                    raise ONNXImportError(
                        f"graph input {vi.name!r} needs an input_shapes entry")
                shape = tuple(d if isinstance(d, int) and d > 0 else None
                              for d in vi.type.shape.dims)
            dtype = TENSOR_DTYPES.get(
                vi.type.elem_type if vi.type else 1, "float32")
            self.vars[vi.name] = self.sd.placeholder(vi.name, shape, dtype)

        self._process_nodes()
        return {out: self.tensor(out).name for out in outputs}

    def _process_nodes(self) -> None:
        for node in self.g.node:
            if node.domain not in ("", "ai.onnx"):
                raise ONNXImportError(
                    f"unsupported op domain {node.domain!r} ({node.op_type})")
            mapper = ONNX_OP_MAPPERS.get(node.op_type)
            if mapper is None:
                raise ONNXImportError(
                    f"no mapper for ONNX op {node.op_type!r} (node "
                    f"{node.name!r}); supported: {sorted(ONNX_OP_MAPPERS)}")
            result = mapper(self, node)
            outs = result if isinstance(result, tuple) else (result,)
            for ref, var in zip(node.output, outs):
                if ref:
                    self.vars[ref] = var
            self._try_fold(node)


# --- control flow (If / Loop) ----------------------------------------------
#
# ONNX subgraphs (If branches, Loop bodies) reference outer-scope values BY
# NAME (implicit capture) — unlike TF FunctionDefs, which take explicit
# args. Raising onto samediff.cond / samediff.while_loop therefore turns
# every captured name into a branch placeholder (or an inlined constant,
# when the outer value is host-known) bound positionally at the call site.
# Loop becomes a while_loop with carry (i, cond, loop-vars, captures,
# scan accumulators); scan outputs use the dense-accumulator pattern
# (list_set into a preallocated [M, ...] tensor at a device-side index —
# the representation the TF TensorList import uses).


def _graph_captures(graph: GraphProto) -> list:
    """Names a subgraph reads from the enclosing scope, in discovery
    order — including reads made by nested subgraphs (a nested If inside
    a Loop body captures through BOTH levels unless produced locally)."""
    produced = {t.name for t in graph.initializer}
    produced |= {vi.name for vi in graph.input}
    caps, seen = [], set()
    for node in graph.node:
        for ref in node.input:
            if ref and ref not in produced and ref not in seen:
                seen.add(ref)
                caps.append(ref)
        for a in node.attribute:
            if a.g is not None:
                for c in _graph_captures(a.g):
                    if c not in produced and c not in seen:
                        seen.add(c)
                        caps.append(c)
        produced |= {o for o in node.output if o}
    # A declared output can name an outer value directly (a passthrough
    # branch with no Identity node) — that read is a capture too
    for o in graph.output:
        if o.name and o.name not in produced and o.name not in seen:
            seen.add(o.name)
            caps.append(o.name)
    return caps


def _union_captures(imp: "_GraphImporter", graphs) -> Tuple[list, list]:
    """(all_caps, var_caps): ordered union of the graphs' captures; the
    var_caps subset is NOT host-known in the outer scope and must ride as
    placeholders/loop carry (host-known captures inline as constants so
    shape/axis consumers keep working)."""
    caps, seen = [], set()
    for g in graphs:
        for c in _graph_captures(g):
            if c not in seen:
                seen.add(c)
                caps.append(c)
    var_caps = [c for c in caps if c not in imp.consts]
    for c in var_caps:
        imp.tensor(c)  # fail early with the standard unknown-value error
    return caps, var_caps


def _import_onnx_subgraph(imp: "_GraphImporter", graph: GraphProto,
                          declared_vars, all_caps, var_caps):
    """Import a branch/body GraphProto into a fresh SameDiff.

    Placeholder declaration order (positional contract with
    _as_branch_fn): graph.input (bound to declared_vars' shapes/dtypes)
    first, then var_caps. Host-known captures become subgraph constants.
    branch_outputs = the graph's declared outputs. Returns the importer
    (callers may need to record extra ops, e.g. Loop's accumulators).
    """
    if len(declared_vars) != len(graph.input):
        raise ONNXImportError(
            f"subgraph {graph.name!r} takes {len(graph.input)} inputs, "
            f"got {len(declared_vars)}")
    sub = SameDiff.create(imp.sd.device)
    simp = _GraphImporter(graph, {}, sub)
    for vi, v in zip(graph.input, declared_vars):
        simp.vars[vi.name] = sub.placeholder(
            vi.name, getattr(v, "shape", None),
            getattr(v, "dtype", None) or "float32")
    for c in var_caps:
        v = imp.tensor(c)
        simp.vars[c] = sub.placeholder(c, v.shape, v.dtype or "float32")
    _seed_subgraph_constants(imp, simp, graph, all_caps)
    simp._process_nodes()
    sub.branch_outputs = [simp.tensor(o.name).name for o in graph.output]
    return simp


def _seed_subgraph_constants(imp, simp, graph, all_caps) -> None:
    """Inline host-known outer captures + the subgraph's own initializers
    as constants of the sub-SameDiff (keeps const_value() working for
    shape/axis consumers inside branch bodies)."""
    for c in all_caps:
        if c in imp.consts:
            arr = imp.consts[c]
            simp.consts[c] = arr
            simp.vars[c] = simp.sd.constant(simp.fresh_const_name(c), arr)
    for t in graph.initializer:
        if t.name in simp.vars:
            # an initializer sharing a declared input's name is that
            # input's DEFAULT value (ONNX default-value form) — the bound
            # placeholder must win or the carried value is silently
            # ignored (mirrors init_names handling in run())
            continue
        arr = t.to_numpy()
        simp.consts[t.name] = arr
        simp.vars[t.name] = simp.sd.constant(
            simp.fresh_const_name(t.name), _held(t, arr))


def import_onnx_model(
    model,
    inputs: Optional[Dict[str, Tuple]] = None,
    outputs: Optional[Sequence[str]] = None,
    *,
    device=None,
) -> Tuple[SameDiff, Dict[str, str], Dict[str, str]]:
    """Import an ONNX model (a path, the serialized bytes, or a decoded
    ``onnx_proto.ModelProto``) into a SameDiff on ``device`` (the first
    CUDA card by default).

    inputs: optional {graph_input_name: shape} overriding/providing input
    shapes (None dims allowed for batch). outputs: graph value names to
    expose; default = the graph's declared outputs.

    Returns (sd, input_map, output_map): ONNX value names → SameDiff
    variable names. Mirrors ``modelimport.tf.import_tf_graph``.
    """
    if isinstance(model, (str, bytes)):
        if isinstance(model, str):
            with open(model, "rb") as f:
                model = f.read()
        model = ModelProto.decode(model)
    if model.graph is None:
        raise ONNXImportError("model has no graph")
    g = model.graph
    if outputs is None:
        outputs = [v.name for v in g.output]
    sd = SameDiff.create(device)
    imp = _GraphImporter(g, dict(inputs or {}), sd)
    out_map = imp.run(list(outputs))
    init_names = {t.name for t in g.initializer}
    in_map = {v.name: v.name for v in g.input if v.name not in init_names}
    return sd, in_map, out_map
