"""Math ops (↔ deeplearning4j_tpu/ops/math.py) — the clipping that gradient
normalization uses."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.utils.pytree import tree_leaves, tree_map


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
