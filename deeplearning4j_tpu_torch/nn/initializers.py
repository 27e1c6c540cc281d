"""Weight initializers (↔ deeplearning4j_tpu/nn/initializers.py).

Drawn from a ``torch.Generator``. The distributions are the JAX
package's; the numbers are not (jax and torch generators differ), so
parity tests copy variables across instead of comparing fresh inits.
Draws happen on the generator's device (the CPU for the port's models),
so one seed gives the same weights whatever device they end up on.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _fans(shape):
    """fan_in/fan_out for dense [in,out] and conv [k..., in, out] weights."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def xavier(shape, generator: torch.Generator, dtype=torch.float32):
    """Glorot normal: N(0, 2/(fan_in+fan_out)) (ref: WeightInitXavier)."""
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def relu(shape, generator: torch.Generator, dtype=torch.float32):
    """He normal: N(0, 2/fan_in) (ref: WeightInit.RELU)."""
    fan_in, _ = _fans(shape)
    std = math.sqrt(2.0 / fan_in)
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def relu_uniform(shape, generator: torch.Generator, dtype=torch.float32):
    """He uniform: U(-a, a) with a = sqrt(6/fan_in)."""
    fan_in, _ = _fans(shape)
    a = math.sqrt(6.0 / fan_in)
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * a) * u - a


def truncated_normal(shape, generator: torch.Generator, std=1.0,
                     dtype=torch.float32):
    """``std * jax.random.truncated_normal(key, -2, 2, shape)``: a standard
    normal cut at ±2, then scaled."""
    out = torch.empty(shape, dtype=dtype)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return std * out


def normal(stddev=1.0, mean=0.0):
    """``mean + stddev * N(0, 1)``."""
    def init(shape, generator: torch.Generator, dtype=torch.float32):
        return mean + stddev * torch.randn(shape, generator=generator,
                                           dtype=dtype)

    return init


INITIALIZERS: dict[str, Callable] = {
    "xavier": xavier,
    "glorot_normal": xavier,
    "normal": normal(0.01),
    "relu": relu,
    "he_normal": relu,
    "relu_uniform": relu_uniform,
    "he_uniform": relu_uniform,
}


def get_initializer(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    try:
        return INITIALIZERS[name_or_fn.lower()]
    except KeyError:
        raise ValueError(
            f"unknown weight init '{name_or_fn}'; available: "
            f"{sorted(INITIALIZERS)}") from None
