"""Convolution, pooling and reshaping layers (↔ deeplearning4j_tpu/nn/layers/conv.py).

Every layer of the JAX module, with its fields, ``@class`` names and
shape arithmetic, so its config JSON loads here. Activations are NHWC
``[N, H, W, C]`` (``[N, T, C]`` in 1-D, ``[N, D, H, W, C]`` in 3-D) at
every layer boundary and conv weights ``[k..., Cin, Cout]`` under the
names "W" and "b" ("dW"/"pW" for the separable conv's two kernels), so
variables and checkpoints carry across unchanged; ``ops/cnn.py`` hands
the torch ops ``channels_last`` views.

``Deconv2D``/``Deconv3D`` keep the JAX ``output_shape``: under VALID
padding it declares ``(h − 1)·s + k``, while the transposed conv computes
``h·s + max(k − s, 0)``; the two part when k < s (ROADMAP §3, "Differences
by design"). ``apply`` computes what the JAX ``apply`` computes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_config
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.ops import cnn as opscnn


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_out(size, k, s, pad_mode, p=0, d=1):
    if pad_mode == "SAME":
        return -(-size // s)
    eff = (k - 1) * d + 1
    return (size + 2 * p - eff) // s + 1


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _bias(filters, use_bias, dtype, shape=None):
    """The params' "b" entry, zeros of ``shape`` (default (filters,))."""
    if not use_bias:
        return {}
    return {"b": torch.zeros(shape or (filters,), dtype=dtype)}


def _resolve_pad(padding):
    """'same'/'valid'/int/(ph,pw) → (mode, (ph,pw))."""
    if isinstance(padding, str):
        return padding.upper(), (0, 0)
    return "EXPLICIT", _pair(padding)


@register_config
@dataclass
class Conv2D(LayerConfig):
    """↔ ConvolutionLayer (2D). Input [N,H,W,C], weights [kh,kw,Cin,Cout]."""

    filters: int = 0
    kernel: Union[int, Sequence[int]] = 3
    stride: Union[int, Sequence[int]] = 1
    padding: Union[str, int, Sequence[int]] = "SAME"
    dilation: Union[int, Sequence[int]] = 1
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True
    groups: int = 1

    def output_shape(self, input_shape):
        h, w, c = input_shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        mode, (ph, pw) = _resolve_pad(self.padding)
        if mode == "VALID":
            ph = pw = 0
        oh = _conv_out(h, kh, sh, mode, ph, dh)
        ow = _conv_out(w, kw, sw, mode, pw, dw)
        return (oh, ow, self.filters)

    def init(self, generator, input_shape, dtype):
        c = input_shape[-1]
        kh, kw = _pair(self.kernel)
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": w_init((kh, kw, c // self.groups, self.filters),
                              generator, dtype)}
        if self.use_bias:
            params["b"] = torch.zeros((self.filters,), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        mode, p = _resolve_pad(self.padding)
        pad = mode if mode != "EXPLICIT" else p
        y = opscnn.conv2d(
            x, params["W"], params.get("b"),
            stride=self.stride, padding=pad, dilation=self.dilation,
            feature_group_count=self.groups,
        )
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class Conv1D(LayerConfig):
    """↔ Convolution1DLayer. Input [N,T,C], weights [k,Cin,Cout]."""

    filters: int = 0
    kernel: int = 3
    stride: int = 1
    padding: Union[str, int] = "SAME"
    dilation: int = 1
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        t, c = input_shape
        if isinstance(self.padding, str):
            mode, p = self.padding.upper(), 0
        else:
            mode, p = "EXPLICIT", self.padding
        return (_conv_out(t, self.kernel, self.stride, mode, p,
                          self.dilation), self.filters)

    def init(self, generator, input_shape, dtype):
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": w_init((self.kernel, input_shape[-1], self.filters),
                              generator, dtype)}
        params.update(_bias(self.filters, self.use_bias, dtype))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        y = opscnn.conv1d(x, params["W"], params.get("b"),
                          stride=self.stride, padding=self.padding,
                          dilation=self.dilation)
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class Conv3D(LayerConfig):
    """↔ Convolution3D. Input [N,D,H,W,C], weights [kd,kh,kw,Cin,Cout]."""

    filters: int = 0
    kernel: Union[int, Sequence[int]] = 3
    stride: Union[int, Sequence[int]] = 1
    padding: str = "SAME"
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        *dhw, _ = input_shape
        dims = tuple(_conv_out(n, k, s, self.padding.upper()) for n, k, s
                     in zip(dhw, _triple(self.kernel), _triple(self.stride)))
        return (*dims, self.filters)

    def init(self, generator, input_shape, dtype):
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": w_init((*_triple(self.kernel), input_shape[-1],
                               self.filters), generator, dtype)}
        params.update(_bias(self.filters, self.use_bias, dtype))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        y = opscnn.conv3d(x, params["W"], params.get("b"),
                          stride=self.stride, padding=self.padding)
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class Deconv2D(LayerConfig):
    """↔ Deconvolution2D (transposed conv). Weights [kh,kw,Cin,F]."""

    filters: int = 0
    kernel: Union[int, Sequence[int]] = 2
    stride: Union[int, Sequence[int]] = 2
    padding: str = "SAME"
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        sh, sw = _pair(self.stride)
        kh, kw = _pair(self.kernel)
        if self.padding.upper() == "SAME":
            return (h * sh, w * sw, self.filters)
        return ((h - 1) * sh + kh, (w - 1) * sw + kw, self.filters)

    def init(self, generator, input_shape, dtype):
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": w_init((*_pair(self.kernel), input_shape[-1],
                               self.filters), generator, dtype)}
        params.update(_bias(self.filters, self.use_bias, dtype))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        y = opscnn.deconv2d(x, params["W"], params.get("b"),
                            stride=self.stride, padding=self.padding)
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class DepthwiseConv2D(LayerConfig):
    """↔ DepthwiseConvolution2D. Weights [kh,kw,C,mult], output channels
    C·mult."""

    depth_multiplier: int = 1
    kernel: Union[int, Sequence[int]] = 3
    stride: Union[int, Sequence[int]] = 1
    padding: str = "SAME"
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        h, w, c = input_shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        mode = self.padding.upper()
        return (_conv_out(h, kh, sh, mode), _conv_out(w, kw, sw, mode),
                c * self.depth_multiplier)

    def init(self, generator, input_shape, dtype):
        c = input_shape[-1]
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": w_init((*_pair(self.kernel), c,
                               self.depth_multiplier), generator, dtype)}
        params.update(_bias(c * self.depth_multiplier, self.use_bias, dtype))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        y = opscnn.depthwise_conv2d(x, params["W"], params.get("b"),
                                    stride=self.stride, padding=self.padding)
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class SeparableConv2D(LayerConfig):
    """↔ SeparableConvolution2D: depthwise "dW" [kh,kw,C,mult], then the
    pointwise "pW" [1,1,C·mult,F] and "b"."""

    filters: int = 0
    kernel: Union[int, Sequence[int]] = 3
    stride: Union[int, Sequence[int]] = 1
    padding: str = "SAME"
    depth_multiplier: int = 1
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        mode = self.padding.upper()
        return (_conv_out(h, kh, sh, mode), _conv_out(w, kw, sw, mode),
                self.filters)

    def init(self, generator, input_shape, dtype):
        c = input_shape[-1]
        m = self.depth_multiplier
        w_init = get_initializer(self.weight_init or "relu")
        params = {
            "dW": w_init((*_pair(self.kernel), c, m), generator, dtype),
            "pW": w_init((1, 1, c * m, self.filters), generator, dtype),
        }
        params.update(_bias(self.filters, self.use_bias, dtype))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        y = opscnn.separable_conv2d(x, params["dW"], params["pW"],
                                    params.get("b"), stride=self.stride,
                                    padding=self.padding)
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class Pooling2D(LayerConfig):
    """↔ SubsamplingLayer (PoolingType MAX/AVG/PNORM/SUM)."""

    pool_type: str = "max"  # 'max' | 'avg' | 'pnorm' | 'sum'
    window: Union[int, Sequence[int]] = 2
    stride: Optional[Union[int, Sequence[int]]] = None
    padding: Union[str, int] = "VALID"
    pnorm: int = 2

    def output_shape(self, input_shape):
        h, w, c = input_shape
        kh, kw = _pair(self.window)
        s = self.stride if self.stride is not None else self.window
        sh, sw = _pair(s)
        mode, (ph, pw) = _resolve_pad(self.padding)
        if mode != "SAME":
            mode = "VALID"  # explicit padding: the VALID formula with p
        return (_conv_out(h, kh, sh, mode, ph), _conv_out(w, kw, sw, mode, pw),
                c)

    def apply(self, params, state, x, *, train=False, generator=None):
        stride = self.stride if self.stride is not None else self.window
        if self.pool_type == "max":
            return opscnn.max_pool2d(x, self.window, stride,
                                     self.padding), state
        if self.pool_type == "avg":
            return opscnn.avg_pool2d(x, self.window, stride,
                                     self.padding), state
        if self.pool_type == "pnorm":
            return opscnn.pnorm_pool2d(x, self.pnorm, self.window, stride,
                                       self.padding), state
        if self.pool_type == "sum":
            return opscnn._pool(x, 0.0, "add", self.window, stride,
                                self.padding), state
        raise ValueError(f"unknown pool type {self.pool_type}")


@register_config
@dataclass
class GlobalPooling(LayerConfig):
    """↔ GlobalPoolingLayer (avg/max/sum over the spatial or time dims);
    ``keepdims`` keeps the pooled axes as size-1 dims."""

    pool_type: str = "avg"
    keepdims: bool = False

    def output_shape(self, input_shape):
        if self.keepdims:
            return (*(1,) * (len(input_shape) - 1), input_shape[-1])
        return (input_shape[-1],)

    def apply(self, params, state, x, *, train=False, generator=None):
        dims = tuple(range(1, x.ndim - 1))
        if self.pool_type == "avg":
            return torch.mean(x, dim=dims, keepdim=self.keepdims), state
        if self.pool_type == "max":
            return torch.amax(x, dim=dims, keepdim=self.keepdims), state
        if self.pool_type == "sum":
            return torch.sum(x, dim=dims, keepdim=self.keepdims), state
        raise ValueError(f"unknown pool type {self.pool_type}")


@register_config
@dataclass
class Upsampling2D(LayerConfig):
    """↔ Upsampling2D (nearest-neighbour)."""

    scale: Union[int, Sequence[int]] = 2

    def output_shape(self, input_shape):
        h, w, c = input_shape
        sh, sw = _pair(self.scale)
        return (h * sh, w * sw, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        return opscnn.upsampling2d(x, self.scale), state


@register_config
@dataclass
class ZeroPadding2D(LayerConfig):
    """↔ ZeroPaddingLayer: (top, bottom, left, right)."""

    padding: Sequence[int] = (1, 1, 1, 1)

    def output_shape(self, input_shape):
        h, w, c = input_shape
        t, b, l, r = self.padding
        return (h + t + b, w + l + r, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        t, b, l, r = self.padding
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_config
@dataclass
class Cropping2D(LayerConfig):
    """↔ Cropping2D: (top, bottom, left, right)."""

    cropping: Sequence[int] = (0, 0, 0, 0)

    def output_shape(self, input_shape):
        h, w, c = input_shape
        t, b, l, r = self.cropping
        return (h - t - b, w - l - r, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        t, b, l, r = self.cropping
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :], state


@register_config
@dataclass
class SpaceToDepth(LayerConfig):
    """↔ SpaceToDepthLayer (``ops/cnn.space_to_depth``)."""

    block_size: int = 2

    def output_shape(self, input_shape):
        h, w, c = input_shape
        b = self.block_size
        return (h // b, w // b, c * b * b)

    def apply(self, params, state, x, *, train=False, generator=None):
        return opscnn.space_to_depth(x, self.block_size), state


@register_config
@dataclass
class Pooling1D(LayerConfig):
    """↔ Subsampling1DLayer: max or avg pooling over the time axis of
    [N, T, C], as the 2-D pools of [N, T, 1, C]."""

    pool_type: str = "max"
    window: int = 2
    stride: Optional[int] = None
    padding: str = "VALID"

    def output_shape(self, input_shape):
        t, c = input_shape
        s = self.stride if self.stride is not None else self.window
        return (_conv_out(t, self.window, s, self.padding.upper()), c)

    def apply(self, params, state, x, *, train=False, generator=None):
        stride = self.stride if self.stride is not None else self.window
        y = x[:, :, None, :]
        if self.pool_type == "max":
            y = opscnn.max_pool2d(y, (self.window, 1), (stride, 1),
                                  self.padding)
        elif self.pool_type == "avg":
            y = opscnn.avg_pool2d(y, (self.window, 1), (stride, 1),
                                  self.padding)
        else:
            raise ValueError(f"unknown pool type {self.pool_type}")
        return y[:, :, 0, :], state


def _lo_hi(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@register_config
@dataclass
class ZeroPadding1D(LayerConfig):
    """↔ ZeroPadding1DLayer: pad the time axis of [N, T, C]."""

    padding: Union[int, Sequence[int]] = 1

    def output_shape(self, input_shape):
        t, c = input_shape
        lo, hi = _lo_hi(self.padding)
        return (t + lo + hi, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        lo, hi = _lo_hi(self.padding)
        return F.pad(x, (0, 0, lo, hi)), state


@register_config
@dataclass
class Cropping1D(LayerConfig):
    """↔ Cropping1D: crop the time axis of [N, T, C]."""

    cropping: Union[int, Sequence[int]] = 1

    def output_shape(self, input_shape):
        t, ch = input_shape
        lo, hi = _lo_hi(self.cropping)
        return (t - lo - hi, ch)

    def apply(self, params, state, x, *, train=False, generator=None):
        lo, hi = _lo_hi(self.cropping)
        return x[:, lo:x.shape[1] - hi, :], state


@register_config
@dataclass
class Upsampling1D(LayerConfig):
    """↔ Upsampling1D: each timestep repeated ``size`` times."""

    size: int = 2

    def output_shape(self, input_shape):
        t, c = input_shape
        return (t * self.size, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        return x.repeat_interleave(self.size, dim=1), state


@register_config
@dataclass
class Deconv3D(LayerConfig):
    """↔ Deconvolution3D (transposed 3-D conv). Input [N,D,H,W,C]."""

    filters: int = 0
    kernel: Union[int, Sequence[int]] = 2
    stride: Union[int, Sequence[int]] = 2
    padding: str = "SAME"
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        *dhw, _ = input_shape
        k, s = _triple(self.kernel), _triple(self.stride)
        if self.padding.upper() == "SAME":
            dims = tuple(n * ss for n, ss in zip(dhw, s))
        else:
            dims = tuple((n - 1) * ss + kk for n, ss, kk in zip(dhw, s, k))
        return (*dims, self.filters)

    def init(self, generator, input_shape, dtype):
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": w_init((*_triple(self.kernel), input_shape[-1],
                               self.filters), generator, dtype)}
        params.update(_bias(self.filters, self.use_bias, dtype))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        y = opscnn.deconv3d(x, params["W"], params.get("b"),
                            stride=self.stride, padding=self.padding)
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class Pooling3D(LayerConfig):
    """↔ Subsampling3DLayer (MAX/AVG over [N,D,H,W,C])."""

    pool_type: str = "max"
    window: Union[int, Sequence[int]] = 2
    stride: Optional[Union[int, Sequence[int]]] = None
    padding: str = "VALID"

    def output_shape(self, input_shape):
        *dhw, c = input_shape
        k = _triple(self.window)
        s = _triple(self.stride if self.stride is not None else self.window)
        mode = self.padding.upper()
        return (*(_conv_out(n, kk, ss, mode)
                  for n, kk, ss in zip(dhw, k, s)), c)

    def apply(self, params, state, x, *, train=False, generator=None):
        stride = self.stride if self.stride is not None else self.window
        if self.pool_type == "max":
            return opscnn.max_pool3d(x, self.window, stride,
                                     self.padding), state
        if self.pool_type == "avg":
            return opscnn.avg_pool3d(x, self.window, stride,
                                     self.padding), state
        raise ValueError(f"unknown pool type {self.pool_type}")


@register_config
@dataclass
class Upsampling3D(LayerConfig):
    """↔ Upsampling3D (nearest-neighbour on [N,D,H,W,C])."""

    scale: Union[int, Sequence[int]] = 2

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        sd, sh, sw = _triple(self.scale)
        return (d * sd, h * sh, w * sw, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        for dim, s in enumerate(_triple(self.scale), start=1):
            x = x.repeat_interleave(s, dim=dim)
        return x, state


@register_config
@dataclass
class ZeroPadding3D(LayerConfig):
    """↔ ZeroPadding3DLayer: (d_lo, d_hi, h_lo, h_hi, w_lo, w_hi)."""

    padding: Sequence[int] = (1, 1, 1, 1, 1, 1)

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        dl, dh, hl, hh, wl, wh = self.padding
        return (d + dl + dh, h + hl + hh, w + wl + wh, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        dl, dh, hl, hh, wl, wh = self.padding
        return F.pad(x, (0, 0, wl, wh, hl, hh, dl, dh)), state


@register_config
@dataclass
class Cropping3D(LayerConfig):
    """↔ Cropping3D: (d_lo, d_hi, h_lo, h_hi, w_lo, w_hi)."""

    cropping: Sequence[int] = (0, 0, 0, 0, 0, 0)

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        dl, dh, hl, hh, wl, wh = self.cropping
        return (d - dl - dh, h - hl - hh, w - wl - wh, c)

    def apply(self, params, state, x, *, train=False, generator=None):
        dl, dh, hl, hh, wl, wh = self.cropping
        return x[:, dl:x.shape[1] - dh, hl:x.shape[2] - hh,
                 wl:x.shape[3] - wh, :], state


@register_config
@dataclass
class DepthToSpace(LayerConfig):
    """↔ DepthToSpace, the inverse of ``SpaceToDepth``."""

    block_size: int = 2

    def output_shape(self, input_shape):
        h, w, c = input_shape
        b = self.block_size
        return (h * b, w * b, c // (b * b))

    def apply(self, params, state, x, *, train=False, generator=None):
        return opscnn.depth_to_space(x, self.block_size), state


def _unshared_weights(w_init, patch, positions, filters, generator, dtype):
    """Per-position weights [*positions, patch, filters], drawn as a
    [patch, positions·filters] matrix so the initializer's fan-in is the
    patch size (as a conv's), then laid out by position."""
    n = math.prod(positions)
    w = w_init((patch, n * filters), generator, dtype)
    w = w.reshape(patch, *positions, filters)
    return w.permute(*range(1, len(positions) + 1), 0,
                     len(positions) + 1).contiguous()


@register_config
@dataclass
class LocallyConnected2D(LayerConfig):
    """↔ LocallyConnected2D: a conv's geometry with UNSHARED weights, one
    [C·kh·kw, F] matrix per output position: W [OH, OW, C·kh·kw, F] (the
    patch C-major, ``ops/cnn.extract_patches2d``), b [OH, OW, F]; one
    batched product over all positions."""

    filters: int = 0
    kernel: Union[int, Sequence[int]] = 3
    stride: Union[int, Sequence[int]] = 1
    padding: str = "VALID"
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        mode = self.padding.upper()
        return (_conv_out(h, kh, sh, mode), _conv_out(w, kw, sw, mode),
                self.filters)

    def init(self, generator, input_shape, dtype):
        kh, kw = _pair(self.kernel)
        oh, ow, _ = self.output_shape(input_shape)
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": _unshared_weights(w_init, input_shape[-1] * kh * kw,
                                         (oh, ow), self.filters, generator,
                                         dtype)}
        params.update(_bias(self.filters, self.use_bias, dtype,
                            (oh, ow, self.filters)))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        patches = opscnn.extract_patches2d(x, self.kernel,
                                           stride=self.stride,
                                           padding=self.padding)
        y = torch.einsum("nhwk,hwkf->nhwf", patches, params["W"])
        if self.use_bias:
            y = y + params["b"][None]
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class LocallyConnected1D(LayerConfig):
    """↔ LocallyConnected1D: unshared weights over the time axis of
    [N,T,C]: W [OT, C·k, F], b [OT, F]."""

    filters: int = 0
    kernel: int = 3
    stride: int = 1
    padding: str = "VALID"
    activation: str = "identity"
    weight_init: Optional[str] = None
    use_bias: bool = True

    def output_shape(self, input_shape):
        t, _ = input_shape
        return (_conv_out(t, self.kernel, self.stride, self.padding.upper()),
                self.filters)

    def init(self, generator, input_shape, dtype):
        ot, _ = self.output_shape(input_shape)
        w_init = get_initializer(self.weight_init or "relu")
        params = {"W": _unshared_weights(w_init, input_shape[-1] * self.kernel,
                                         (ot,), self.filters, generator,
                                         dtype)}
        params.update(_bias(self.filters, self.use_bias, dtype,
                            (ot, self.filters)))
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        patches = opscnn.extract_patches2d(
            x[:, :, None, :], (self.kernel, 1), stride=(self.stride, 1),
            padding=self.padding)[:, :, 0, :]
        y = torch.einsum("ntk,tkf->ntf", patches, params["W"])
        if self.use_bias:
            y = y + params["b"][None]
        return get_activation(self.activation)(y), state
