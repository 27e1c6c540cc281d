"""Loss ops (↔ deeplearning4j_tpu/ops/loss.py) — the one ``Bert.loss_fn`` calls.

Same conventions as the JAX package: a classification loss takes
pre-activation logits (fused log-softmax), returns per-example values and
reduces them with ``reduction`` ('mean' | 'sum' | 'none'), optionally
weighted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def sparse_softmax_cross_entropy(logits, label_ids, weights=None,
                                 reduction="mean"):
    """Cross-entropy of ``logits`` [..., C] against integer class ids [...]."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, label_ids.long()[..., None])[..., 0]
    return _reduce(ce, reduction, weights)
