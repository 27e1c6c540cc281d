"""Weight noise / DropConnect (↔ deeplearning4j_tpu/nn/weightnoise.py).

A layer config may carry a ``weight_noise`` transform; at each training
forward pass the model container applies it to the layer's param dict
right before ``layer.apply`` (and before the output layer's loss).
Inference uses the raw weights; params are never mutated.

Noise is drawn from an explicit ``torch.Generator`` (on the params'
device) where the JAX package folds a key; the two give different draws
from one seed, from the same distributions. Weight keys: every param whose
name is not a bias, norm scale or peephole, unless ``apply_to_bias``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.config import register_config

# The params exempt from noise and from l1/l2 (nn/model.py's _NO_REG_KEYS)
NON_WEIGHT_KEYS = frozenset({"b", "beta", "gamma", "pI", "pF", "pO",
                             "alpha", "mean", "var"})


def _is_weight(key: str, apply_to_bias: bool) -> bool:
    return apply_to_bias or key not in NON_WEIGHT_KEYS


@register_config
@dataclass
class DropConnect:
    """↔ weightnoise.DropConnect(weightRetainProb): each weight is kept
    with probability ``p`` and scaled by ``1/p``."""

    p: float = 0.5  # retain probability
    apply_to_bias: bool = False

    def transform(self, params, generator, train: bool):
        if not train or self.p >= 1.0:
            return params
        out = {}
        for k, w in sorted(params.items()):
            if _is_weight(k, self.apply_to_bias):
                keep = torch.rand(w.shape, generator=generator,
                                  device=w.device) < self.p
                out[k] = torch.where(keep, w / self.p, 0.0).to(w.dtype)
            else:
                out[k] = w
        return out


@register_config
@dataclass
class WeightNoise:
    """↔ weightnoise.WeightNoise: Gaussian N(mean, std) noise added
    (``additive``) or multiplied as ``w * (1 + n)`` onto the weights."""

    mean: float = 0.0
    std: float = 0.1
    additive: bool = True
    apply_to_bias: bool = False

    def transform(self, params, generator, train: bool):
        if not train or (self.std == 0.0 and self.mean == 0.0):
            return params
        out = {}
        for k, w in sorted(params.items()):
            if _is_weight(k, self.apply_to_bias):
                n = (self.mean + self.std * torch.randn(
                    w.shape, generator=generator, device=w.device)).to(w.dtype)
                out[k] = w + n if self.additive else w * (1.0 + n)
            else:
                out[k] = w
        return out


def apply_weight_noise(layer, params, generator, train: bool):
    """Container hook: ``layer.weight_noise`` applied to its params when
    training with a generator; otherwise the params as they are."""
    wn = getattr(layer, "weight_noise", None)
    if wn is None or not train or generator is None or not params:
        return params
    return wn.transform(params, generator, train)
