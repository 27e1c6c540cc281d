"""Convolution and pooling layers (↔ deeplearning4j_tpu/nn/layers/conv.py): ``Conv2D``, ``Pooling2D``, ``GlobalPooling``.

The JAX package's fields, ``@class`` names and shape arithmetic, so its
config JSON loads here. Activations are NHWC ``[N, H, W, C]`` at every
layer boundary and conv weights HWIO ``[kh, kw, Cin/groups, Cout]`` under
the names "W" and "b", so variables and checkpoints carry across
unchanged; ``ops/cnn.py`` hands the torch ops ``channels_last`` views.

Not ported yet (ROADMAP queue 1 item 4): Conv1D, Conv3D, Deconv2D/3D,
DepthwiseConv2D, SeparableConv2D, Upsampling2D, ZeroPadding2D,
Cropping2D, SpaceToDepth and LocallyConnected2D.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

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
