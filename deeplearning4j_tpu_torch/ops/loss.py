"""Loss ops (↔ deeplearning4j_tpu/ops/loss.py) — the ones the ported models call.

Same conventions as the JAX package: a classification loss takes
pre-activation logits (fused log-softmax), returns per-example values and
reduces them with ``reduction`` ('mean' | 'sum' | 'none'), optionally
weighted. Losses are registered by the JAX package's names
(``get_loss("mcxent")``); the rest of its registry comes with the layers
that need it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOSS_REGISTRY = {}


def register_loss(name):
    def deco(fn):
        LOSS_REGISTRY[name.lower()] = fn
        return fn

    return deco


def get_loss(name: str):
    try:
        return LOSS_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown loss '{name}'; available: {sorted(LOSS_REGISTRY)}"
        ) from None


def _reduce(val, reduction, weights=None):
    if weights is not None:
        val = val * weights
    if reduction == "mean":
        if weights is not None:
            return torch.sum(val) / torch.clamp(torch.sum(weights), min=1e-12)
        return torch.mean(val)
    if reduction == "sum":
        return torch.sum(val)
    if reduction == "none":
        return val
    raise ValueError(f"unknown reduction {reduction}")


@register_loss("mcxent")
@register_loss("softmax_cross_entropy")
def softmax_cross_entropy(logits, labels, weights=None, reduction="mean",
                          label_smoothing=0.0):
    """Multi-class cross-entropy of ``logits`` [..., C] against one-hot (or
    dense) ``labels`` [..., C] (ref: LossMCXENT)."""
    if label_smoothing > 0.0:
        k = logits.shape[-1]
        labels = labels * (1.0 - label_smoothing) + label_smoothing / k
    ce = -torch.sum(labels * F.log_softmax(logits, dim=-1), dim=-1)
    return _reduce(ce, reduction, weights)


@register_loss("sparse_softmax_cross_entropy")
def sparse_softmax_cross_entropy(logits, label_ids, weights=None,
                                 reduction="mean"):
    """Cross-entropy of ``logits`` [..., C] against integer class ids [...]."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, label_ids.long()[..., None])[..., 0]
    return _reduce(ce, reduction, weights)
