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
- ``lrn`` is TensorFlow's form over the last (channel) axis of NHWC:
  ``x / (bias + alpha·Σ x²)^beta`` over 2·depth_radius + 1 channels,
  alpha not divided by the window (``F.local_response_norm`` averages,
  over NCHW: another function);
- the random ops (``dropout``, ``alpha_dropout``, ``gaussian_dropout``,
  ``gaussian_noise``) draw from an explicit ``torch.Generator`` (on the
  tensor's device) where the JAX versions take a key; the two give
  different draws from the same seed, from the same distributions. The
  draws are float32 whatever the activation's dtype, so a float64 copy
  of a model sees the same mask from the same generator state.
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


def lrn(x, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    """Local response normalization over the last (channel) axis."""
    sq = F.pad(torch.square(x), (depth_radius, depth_radius))
    window = sq.unfold(-1, 2 * depth_radius + 1, 1).sum(-1)
    return x / torch.pow(bias + alpha * window, beta)


def _keep_mask(x, keep, generator):
    return torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep


def _normal(x, generator):
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32).to(x.dtype)


def dropout(x, rate, generator, deterministic=False):
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1/keep``; a no-op when ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(_keep_mask(x, keep, generator), x / keep, 0.0)


def alpha_dropout(x, rate, generator, deterministic=False):
    """SELU-preserving dropout (ref: DL4J AlphaDropout): dropped elements
    become SELU's negative saturation, then an affine map restores the
    mean and variance."""
    if deterministic or rate == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - rate
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    return a * torch.where(_keep_mask(x, keep, generator), x, alpha_p) + b


def gaussian_dropout(x, rate, generator, deterministic=False):
    """Multiplicative N(1, rate/(1 − rate)) noise."""
    if deterministic or rate == 0.0:
        return x
    stddev = (rate / (1.0 - rate)) ** 0.5
    return x * (1.0 + stddev * _normal(x, generator))


def gaussian_noise(x, stddev, generator, deterministic=False):
    """Additive N(0, stddev²) noise."""
    if deterministic or stddev == 0.0:
        return x
    return x + stddev * _normal(x, generator)
