"""NN ops (↔ deeplearning4j_tpu/ops/nn.py) — the ones the ported models use.

Layouts and numerics follow the JAX package:

- ``linear`` weights are ``[in, out]`` and applied as ``x @ W + b``;
- ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default; torch's
  default is the exact erf form);
- ``layer_norm`` uses the population variance;
- ``batch_norm_inference`` is the scale/offset form
  ``x·(γ·rsqrt(var+eps)) + (β − mean·γ·rsqrt(var+eps))``;
- ``embedding_lookup`` raises on an out-of-range id, where ``jnp.take``
  clamps it (a CUDA gather with a bad index would poison the context);
- ``dropout`` draws its mask from an explicit ``torch.Generator`` (on the
  tensor's device) where the JAX version takes a key; the two give
  different masks from the same seed, the same inverted scaling ``x/keep``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

relu = torch.relu
tanh = torch.tanh
sigmoid = torch.sigmoid


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0):
    return F.elu(x, alpha)


def thresholded_relu(x, theta=1.0):
    return torch.where(x > theta, x, 0.0)


def softmax(x):
    """Over the last axis (``jax.nn.softmax``'s default)."""
    return torch.softmax(x, dim=-1)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def layer_norm(x, gamma=None, beta=None, eps=1e-5):
    """Over the last axis, population variance (``jnp.var``)."""
    return F.layer_norm(x, x.shape[-1:], gamma, beta, eps)


def batch_norm_inference(x, mean, var, gamma, beta, eps=1e-5,
                         channel_axis=-1):
    """Normalize with running statistics over ``channel_axis``."""
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    mean, var = mean.reshape(shape), var.reshape(shape)
    scale = torch.rsqrt(var + eps)
    if gamma is not None:
        scale = gamma.reshape(shape) * scale
    offset = -mean * scale
    if beta is not None:
        offset = beta.reshape(shape) + offset
    return x * scale + offset


def linear(x, w, b=None):
    """``x @ w + b`` with ``w`` laid out ``[in, out]``."""
    return F.linear(x, w.t(), b)


def safe_sq_norm(x, axis=-1, keepdims=True, eps=1e-8):
    """Sum of squares over ``axis`` clamped at eps²: ``x·rsqrt(...)`` has
    finite gradients at x = 0, where a plain norm's are NaN."""
    return torch.clamp(torch.sum(torch.square(x), dim=axis,
                                 keepdim=keepdims), min=eps * eps)


def embedding_lookup(table, ids):
    """Rows of ``table`` [V, E] for integer ``ids`` (any shape)."""
    ids = ids.long()
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        if int(lo) < 0 or int(hi) >= table.shape[0]:
            raise IndexError(
                f"embedding ids must lie in [0, {table.shape[0]}), got "
                f"[{int(lo)}, {int(hi)}]")
    return F.embedding(ids, table)


def dropout(x, rate, generator, deterministic=False):
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1/keep``; a no-op when ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)
