"""Normalization layers (↔ deeplearning4j_tpu/nn/layers/norm.py): ``BatchNorm``.

BatchNorm keeps its running statistics as layer *state* ("mean", "var",
float32 under float32 and bf16 compute), its scale and shift as params
("gamma", "beta"), under the JAX package's names. Training computes the
statistics in one float32 pass over the activation and updates the running
values with DL4J's ``decay`` convention; both are written as plain tensor
ops because ``F.batch_norm(training=True)`` computes another function (its
momentum is ``1 - decay`` and its running variance is the unbiased one).

Not ported yet (ROADMAP queue 1 item 5): ``LayerNorm`` as a layer and
``LocalResponseNormalization``; cross-replica statistics (``axis_name``)
wait for the distributed slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_config
from deeplearning4j_tpu_torch.ops import nn as opsnn


@register_config
@dataclass
class BatchNorm(LayerConfig):
    """↔ BatchNormalization: normalizes over every axis but the last
    (features of [N,F], channels of [N,H,W,C]). ``momentum`` is the
    reference's ``decay``: running = decay·running + (1 − decay)·batch."""

    momentum: float = 0.9
    eps: float = 1e-5
    use_gamma_beta: bool = True
    activation: str = "identity"
    axis_name: Optional[str] = None  # mesh axis for cross-replica stats

    def init(self, generator, input_shape, dtype):
        c = input_shape[-1]
        params = {}
        if self.use_gamma_beta:
            params = {"gamma": torch.ones((c,), dtype=dtype),
                      "beta": torch.zeros((c,), dtype=dtype)}
        state = {"mean": torch.zeros((c,), dtype=torch.float32),
                 "var": torch.ones((c,), dtype=torch.float32)}
        return params, state

    def apply(self, params, state, x, *, train=False, generator=None):
        gamma, beta = params.get("gamma"), params.get("beta")
        if train:
            if self.axis_name is not None:
                raise NotImplementedError(
                    f"BatchNorm(axis_name={self.axis_name!r}): cross-replica "
                    "statistics are not ported yet (ROADMAP queue 1 item 8)")
            dims = tuple(range(x.ndim - 1))
            # statistics in float32 (float64 for a float64 activation)
            # from the compute-dtype activation: the mean and E[x²] are
            # one pass each, var = E[x²] − mean²
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = torch.mean(xf, dim=dims)
            ex2 = torch.mean(torch.square(xf), dim=dims)
            var = torch.clamp(ex2 - torch.square(mean), min=0.0)
            m = self.momentum
            new_state = {"mean": m * state["mean"] + (1 - m) * mean,
                         "var": m * state["var"] + (1 - m) * var}
            y = (x - mean.to(x.dtype)) * torch.rsqrt(var + self.eps).to(
                x.dtype)
            if gamma is not None:
                y = y * gamma + beta
            return get_activation(self.activation)(y), new_state
        y = opsnn.batch_norm_inference(
            x, state["mean"].to(x.dtype), state["var"].to(x.dtype),
            gamma, beta, eps=self.eps)
        return get_activation(self.activation)(y), state
