"""NN ops (↔ deeplearning4j_tpu/ops/nn.py): activations, normalization, dropout, linear and embedding.

Layouts and numerics follow the JAX package:

- each activation computes the JAX op's own definition in plain torch
  ops, with its gradient at the kinks: ``relu6`` (``F.relu6``) passes
  none at 0 and 6, as ``jax.nn.relu6``'s custom JVP; ``hard_sigmoid`` is
  ``relu6(x + 3) / 6`` (``jax.nn.hard_sigmoid``, not Keras 2's
  ``0.2·x + 0.5``); ``hard_tanh`` is the JAX ``where`` chain, whose
  gradient at ±1 is 1 (``F.hardtanh``'s is 0); ``softplus`` is
  ``logaddexp(x, 0)`` (``F.softplus`` switches to ``x`` above 20);
  ``rectified_tanh``'s ``maximum`` splits the gradient at 0, as
  ``jnp.maximum`` does;
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

# SELU's constants, as jax.nn.selu writes them
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def relu6(x):
    """min(max(x, 0), 6); no gradient at 0 and 6."""
    return F.relu6(x)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0):
    return F.elu(x, alpha)


def selu(x):
    return _SELU_SCALE * elu(x, _SELU_ALPHA)


def softplus(x):
    """log(1 + eˣ) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def soft_sign(x):
    return x / (torch.abs(x) + 1)


def silu(x):
    return x * torch.sigmoid(x)


swish = silu


def mish(x):
    return x * torch.tanh(softplus(x))


def hard_sigmoid(x):
    """relu6(x + 3) / 6."""
    return relu6(x + 3.0) / 6.0


def hard_tanh(x):
    """−1 below −1, 1 above 1, x between (gradient 1 at ±1)."""
    return torch.where(x > 1, 1.0, torch.where(x < -1, -1.0, x))


def hard_swish(x):
    return x * relu6(x + 3.0) / 6.0


def thresholded_relu(x, theta=1.0):
    return torch.where(x > theta, x, 0.0)


def rational_tanh(x):
    """libnd4j's RationalTanh: 1.7159·ta(2x/3), ta(y) = sign(y)·(1 −
    1/(1 + |y| + y² + 1.41645·y⁴))."""
    y = 2.0 * x / 3.0
    ay = torch.abs(y)
    ta = torch.sign(y) * (1.0 - 1.0 / (1.0 + ay + y * y + 1.41645 * y ** 4))
    return 1.7159 * ta


def rectified_tanh(x):
    return torch.maximum(torch.tanh(x), torch.zeros_like(x))


def cube(x):
    return x * x * x


def softmax(x):
    """Over the last axis (``jax.nn.softmax``'s default)."""
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    """Over the last axis (``jax.nn.log_softmax``'s default)."""
    return torch.log_softmax(x, dim=-1)


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


def l2_normalize(x, axis=-1, eps=1e-12):
    """``x · rsqrt(max(Σ x², eps))`` over ``axis`` (↔ the JAX package's
    ``ops/nn.l2_normalize``). ``torch.maximum`` splits the gradient at a
    tie as ``jnp.maximum`` does; at x = 0 the gradient is rsqrt(eps)."""
    sq = torch.sum(torch.square(x), dim=axis, keepdim=True)
    return x * torch.rsqrt(torch.maximum(sq, sq.new_tensor(eps)))


def embedding_lookup(table, ids):
    """Rows of ``table`` [V, E] for integer ``ids`` (any shape); a
    ``meta`` tensor (shape inference) holds no ids to check."""
    ids = ids.long()
    if ids.numel() and ids.device.type != "meta":
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
