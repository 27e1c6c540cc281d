"""Weight constraints (↔ deeplearning4j_tpu/nn/constraints.py).

A layer config may carry ``constraints`` (one constraint or a list).
After every updater step the Trainer projects the layer's weights back
into each constraint's feasible set (``constrain_params``): a max-norm
clip, a unit-norm rescale, a min/max-norm pull, non-negativity. Biases,
norm scales and peepholes are left alone unless ``apply_to_bias``; a
constraint with ``keys`` touches only the params of those names.

Norms are taken over ``axis``; None means every axis but the last, the
norm per output neuron of an [in, out] kernel and of an HWIO conv kernel.
The classes and fields are the JAX package's, so a config JSON with
constraints loads in either package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.config import register_config
from deeplearning4j_tpu_torch.nn.weightnoise import NON_WEIGHT_KEYS

_EPS = 1e-12


def _axes(w, axis):
    if axis is None:
        return tuple(range(w.ndim - 1)) or (0,)
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _norms(w, axis):
    return torch.sqrt(torch.sum(torch.square(w), dim=_axes(w, axis),
                                keepdim=True))


@register_config
@dataclass
class MaxNorm:
    """↔ MaxNormConstraint: any per-neuron norm above ``max_norm`` is
    scaled down onto the sphere."""

    max_norm: float = 2.0
    axis: Optional[int] = None
    apply_to_bias: bool = False
    keys: Optional[tuple] = None  # restrict to these param names

    def project(self, w):
        n = _norms(w, self.axis)
        scale = torch.clamp(self.max_norm / torch.clamp(n, min=_EPS),
                            max=1.0)
        return (w * scale).to(w.dtype)


@register_config
@dataclass
class MinMaxNorm:
    """↔ MinMaxNormConstraint: norms pulled into [min_norm, max_norm] at
    ``rate`` (1 is the hard projection)."""

    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0
    axis: Optional[int] = None
    apply_to_bias: bool = False
    keys: Optional[tuple] = None

    def project(self, w):
        n = _norms(w, self.axis)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * n
        return (w * (target / torch.clamp(n, min=_EPS))).to(w.dtype)


@register_config
@dataclass
class UnitNorm:
    """↔ UnitNormConstraint: each neuron renormalised to norm 1."""

    axis: Optional[int] = None
    apply_to_bias: bool = False
    keys: Optional[tuple] = None

    def project(self, w):
        return (w / torch.clamp(_norms(w, self.axis), min=_EPS)).to(w.dtype)


@register_config
@dataclass
class NonNegative:
    """↔ NonNegativeConstraint: clamped below at 0."""

    apply_to_bias: bool = False
    keys: Optional[tuple] = None

    def project(self, w):
        return torch.clamp(w, min=0.0)


def constrain_params(layers_named, params):
    """Every constrained layer's params projected; a new params dict that
    shares the unconstrained subtrees. ``layers_named``: (name,
    layer_config) pairs."""
    out = dict(params)
    for name, layer in layers_named:
        cons = getattr(layer, "constraints", None)
        if not cons or name not in out:
            continue
        if not isinstance(cons, (list, tuple)):
            cons = [cons]
        lp = dict(out[name])
        for k, w in lp.items():
            for c in cons:
                keys = getattr(c, "keys", None)
                if keys is not None:
                    if k not in keys:
                        continue
                elif k in NON_WEIGHT_KEYS and not c.apply_to_bias:
                    continue
                w = c.project(w)
            lp[k] = w
        out[name] = lp
    return out
