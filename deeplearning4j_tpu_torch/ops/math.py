"""Math ops (↔ deeplearning4j_tpu/ops/math.py) — the clipping that gradient
normalization uses, and the elementwise ops that the TF and ONNX importers
record (``math.sign`` … ``math.one_hot``, the trigonometric and logical
families) and ``SDVariable.norm2`` calls. Each follows its ``jnp``
counterpart: rounding is half to even, ``sign`` keeps a NaN, and
``reciprocal`` of an integer is a float."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.utils.pytree import tree_leaves, tree_map

floor = torch.floor
ceil = torch.ceil
round = torch.round  # noqa: A001 - half to even, as jnp.round
sin = torch.sin
cos = torch.cos
tan = torch.tan
asin = torch.asin
acos = torch.acos
atan = torch.atan
sinh = torch.sinh
cosh = torch.cosh
asinh = torch.asinh
acosh = torch.acosh
atanh = torch.atanh
reciprocal = torch.reciprocal  # an integer input gives a float, as jnp
logical_and = torch.logical_and
logical_or = torch.logical_or
logical_not = torch.logical_not
logical_xor = torch.logical_xor
is_nan = torch.isnan


def sign(x):
    """``jnp.sign``: a NaN stays NaN (``torch.sign`` gives 0)."""
    s = torch.sign(x)
    return torch.where(torch.isnan(x), x, s) if x.is_floating_point() else s


def norm2(x, axis=None, keepdims=False):
    dims = tuple(range(x.dim())) if axis is None else axis
    return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=keepdims))


def one_hot(indices, depth, dtype=torch.float32, axis=-1, on_value=1.0,
            off_value=0.0):
    """↔ ``jax.nn.one_hot``: an id outside [0, depth) gives a row of zeros
    (``F.one_hot`` would raise)."""
    classes = torch.arange(depth, device=indices.device)
    oh = (indices[..., None] == classes).to(dtype)
    if axis != -1:
        oh = torch.movedim(oh, -1, axis)
    if on_value != 1.0 or off_value != 0.0:
        oh = oh * (on_value - off_value) + off_value
    return oh


def clip_by_norm(x, max_norm, axes=None):
    """↔ ClipByNorm: scale ``x`` so its L2 norm over ``axes`` (all when
    None) is at most ``max_norm``."""
    dims = tuple(range(x.dim())) if axes is None else axes
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return x * scale


def clip_by_global_norm(tree, max_norm):
    """↔ ClipByGlobalNorm: scale every leaf by one factor so the norm over
    all leaves is at most ``max_norm``. Returns (clipped tree, norm)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                           for g in tree_leaves(tree)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, tree), gnorm
