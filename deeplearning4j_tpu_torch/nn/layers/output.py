"""Output layers (↔ deeplearning4j_tpu/nn/layers/output.py): ``OutputLayer``, ``RnnOutputLayer``, ``LossLayer``, ``RnnLossLayer``, ``CnnLossLayer``, ``CenterLossOutputLayer``.

An output layer is a dense layer fused with a loss: ``apply`` gives the
activations (``output()``), ``compute_loss(params, state, x, labels, *,
mask, weights)`` the scalar training loss, on pre-activation logits where
the (loss, activation) pair fuses (softmax cross-entropy), as in the JAX
package. A loss layer is the same without params: its input is the
pre-activation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_config
from deeplearning4j_tpu_torch.nn.layers.core import Dense
from deeplearning4j_tpu_torch.ops import loss as losses
from deeplearning4j_tpu_torch.ops import nn as opsnn

# (loss, activation) pairs whose loss takes logits and fuses the activation
_LOGIT_LOSSES = {
    ("mcxent", "softmax"),
    ("softmax_cross_entropy", "softmax"),
    ("negativeloglikelihood", "softmax"),
    ("nll", "softmax"),
    ("xent", "sigmoid"),
    ("binary_cross_entropy", "sigmoid"),
}


def _masked_mean_loss(loss_name, activation, x, labels, *, mask=None,
                      weights=None):
    """Per-element loss → weighted / masked mean. ``x`` holds
    pre-activations; per-element losses keep the leading dims ([N,T] for
    sequences). ``weights`` right-broadcasts (per-example [N] or
    per-element); ``mask`` excludes elements and normalizes by the count
    that survives, broadcast to the per-element shape."""
    fn = losses.get_loss(loss_name)
    use_logits = (loss_name.lower(), activation.lower()) in _LOGIT_LOSSES
    target = x if use_logits else get_activation(activation)(x)
    per = fn(target, labels, reduction="none")
    if weights is not None:
        w = weights
        while w.ndim < per.ndim:
            w = w[..., None]
        per = per * w
    if mask is not None:
        per = per * mask
        n = torch.sum(torch.broadcast_to(mask, per.shape))
        return torch.sum(per) / torch.clamp(n, min=1.0)
    return torch.mean(per)


@register_config
@dataclass
class OutputLayer(Dense):
    """↔ OutputLayer: Dense + activation + loss (reference defaults:
    softmax activation, MCXENT loss). ``mask`` (else ``weights``) weights
    the per-example losses of the mean."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def compute_loss(self, params, state, x, labels, *, mask=None,
                     weights=None):
        pre = opsnn.linear(x, params["W"], params.get("b"))
        fn = losses.get_loss(self.loss)
        w = mask if mask is not None else weights
        if (self.loss.lower(), self.activation.lower()) in _LOGIT_LOSSES:
            return fn(pre, labels, weights=w)
        return fn(get_activation(self.activation)(pre), labels, weights=w)


@register_config
@dataclass
class CenterLossOutputLayer(Dense):
    """↔ CenterLossOutputLayer: softmax CE + λ·½‖f − c_y‖² (Wen et al.
    2016, FaceNet-style training). The class centers are an ordinary
    trainable param ``centers`` [units, in_features], zero at init: the
    gradient of the center term w.r.t. c_y is λ·(c_y − f), so an SGD step
    on it is the reference's moving-average center update with α = lr·λ.
    ``alpha`` is kept for the config's JSON; ``lambda_`` weighs the term.
    Under a mask (else weights) the center term is Σ d·w / max(Σ w, 1),
    so padded rows pull no center. ``c_y = labels @ centers`` computes in
    the wider of the two dtypes, as JAX promotes bf16 centers against
    float32 labels."""

    loss: str = "mcxent"
    activation: str = "softmax"
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init(self, generator, input_shape, dtype):
        params, state = super().init(generator, input_shape, dtype)
        params["centers"] = torch.zeros((self.units, int(input_shape[-1])),
                                        dtype=dtype)
        return params, state

    def compute_loss(self, params, state, x, labels, *, mask=None,
                     weights=None):
        pre = opsnn.linear(x, params["W"], params.get("b"))
        fn = losses.get_loss(self.loss)
        w = mask if mask is not None else weights
        if (self.loss.lower(), self.activation.lower()) in _LOGIT_LOSSES:
            ce = fn(pre, labels, weights=w)
        else:
            ce = fn(get_activation(self.activation)(pre), labels, weights=w)
        centers = params["centers"]
        dtype = torch.promote_types(labels.dtype, centers.dtype)
        cy = labels.to(dtype) @ centers.to(dtype)
        d = 0.5 * torch.sum((x - cy) ** 2, dim=-1)  # [N]
        if w is not None:
            d = d * w
            center = torch.sum(d) / torch.clamp(torch.sum(w), min=1.0)
        else:
            center = torch.mean(d)
        return ce + self.lambda_ * center


@register_config
@dataclass
class RnnOutputLayer(Dense):
    """↔ RnnOutputLayer: per-timestep dense + loss over [N,T,F] input;
    ``mask`` [N,T] excludes padded steps from the loss."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def compute_loss(self, params, state, x, labels, *, mask=None,
                     weights=None):
        pre = opsnn.linear(x, params["W"], params.get("b"))
        return _masked_mean_loss(self.loss, self.activation, pre, labels,
                                 mask=mask, weights=weights)


@register_config
@dataclass
class LossLayer(LayerConfig):
    """↔ LossLayer: activation + loss, no params; ``mask`` (else
    ``weights``) weights the per-example losses of the mean."""

    activation: str = "identity"
    loss: str = "mse"

    def apply(self, params, state, x, *, train=False, generator=None):
        return get_activation(self.activation)(x), state

    def compute_loss(self, params, state, x, labels, *, mask=None,
                     weights=None):
        fn = losses.get_loss(self.loss)
        w = mask if mask is not None else weights
        if (self.loss.lower(), self.activation.lower()) in _LOGIT_LOSSES:
            return fn(x, labels, weights=w)
        return fn(get_activation(self.activation)(x), labels, weights=w)


@register_config
@dataclass
class RnnLossLayer(LayerConfig):
    """↔ RnnLossLayer: per-timestep activation + loss over [N,T,F], no
    params; ``mask`` [N,T] excludes padded steps."""

    activation: str = "identity"
    loss: str = "mcxent"

    def apply(self, params, state, x, *, train=False, generator=None):
        return get_activation(self.activation)(x), state

    def compute_loss(self, params, state, x, labels, *, mask=None,
                     weights=None):
        return _masked_mean_loss(self.loss, self.activation, x, labels,
                                 mask=mask, weights=weights)


@register_config
@dataclass
class CnnLossLayer(RnnLossLayer):
    """↔ CnnLossLayer: per-pixel activation + loss over [N,H,W,C], no
    params; ``mask`` [N,H,W] (or broadcastable) excludes pixels."""
