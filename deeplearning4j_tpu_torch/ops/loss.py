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
    """Cross-entropy of ``logits`` [..., C] against integer class ids [...].

    Ids outside [0, C) raise a ``RuntimeError`` ("out of bounds") on any
    device, checked before the gather with one host sync: on a CUDA
    tensor the gather itself would fail by a device-side assert, which
    breaks the CUDA context for the rest of the process. (The JAX
    package's ``take_along_axis`` reads −1 as the last class and gives
    NaN for an id ≥ C.)"""
    ids = label_ids.long()
    n_classes = logits.shape[-1]
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        if int(lo) < 0 or int(hi) >= n_classes:
            raise RuntimeError(
                f"class ids out of bounds: must lie in [0, {n_classes}), "
                f"got [{int(lo)}, {int(hi)}]")
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, ids[..., None])[..., 0]
    return _reduce(ce, reduction, weights)


@register_loss("xent")
@register_loss("binary_cross_entropy")
def binary_cross_entropy(logits, labels, weights=None, reduction="mean",
                         eps=1e-7):
    """Binary cross-entropy on logits, the sigmoid fused (ref:
    LossBinaryXENT), summed over the last axis. The JAX package writes
    max(l, 0) − l·y + log1p(exp(−|l|)); ``F.binary_cross_entropy_with_logits``
    is the same value, and its gradient σ(l) − y holds at l = 0 too, where
    that expression's would follow the op's tie rule (torch's ``clamp``
    passes 1, JAX's ``maximum`` 0.5, the right value)."""
    ce = F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype),
                                            reduction="none")
    return _reduce(torch.sum(ce, dim=-1), reduction, weights)


@register_loss("binary_cross_entropy_probs")
def binary_cross_entropy_probs(probs, labels, weights=None,
                               reduction="mean", eps=1e-7):
    """Binary cross-entropy on probabilities clipped to [eps, 1 − eps]."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    ce = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _reduce(torch.sum(ce, dim=-1), reduction, weights)


@register_loss("mse")
def mse(pred, target, weights=None, reduction="mean"):
    """Mean squared error over the last axis per example (ref: LossMSE)."""
    v = torch.mean(torch.square(pred - target), dim=-1)
    return _reduce(v, reduction, weights)
