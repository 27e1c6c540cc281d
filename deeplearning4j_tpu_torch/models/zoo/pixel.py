"""Per-pixel output head for segmentation models (↔ deeplearning4j_tpu/models/zoo/pixel.py).

``PixelOutput`` is the reference UNet's final 1×1 conv fused with its
CnnLossLayer: sigmoid and binary cross-entropy for one class, softmax and
cross-entropy over the channels for more. "W" [1, 1, C, classes] and "b"
[classes], as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_config
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.ops import cnn as opscnn
from deeplearning4j_tpu_torch.ops import loss as losses
from deeplearning4j_tpu_torch.ops import nn as opsnn


@register_config
@dataclass
class PixelOutput(LayerConfig):
    """1×1 conv to ``num_classes`` channels + per-pixel loss. Labels: a
    binary mask [N,H,W,1] (or [N,H,W]) for one class, one-hot [N,H,W,C]
    for more. ``mask`` [N,H,W] gives the mean over the pixels it keeps."""

    num_classes: int = 1

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        return (h, w, self.num_classes)

    def init(self, generator, input_shape, dtype):
        w_init = get_initializer("xavier")
        return {"W": w_init((1, 1, input_shape[-1], self.num_classes),
                            generator, dtype),
                "b": torch.zeros((self.num_classes,), dtype=dtype)}, {}

    def _logits(self, params, x):
        return opscnn.conv2d(x, params["W"], params.get("b"), stride=1,
                             padding="SAME")

    def apply(self, params, state, x, *, train=False, generator=None):
        logits = self._logits(params, x)
        if self.num_classes == 1:
            return opsnn.sigmoid(logits), state
        return opsnn.softmax(logits), state

    def compute_loss(self, params, state, x, labels, *, mask=None,
                     weights=None):
        logits = self._logits(params, x)
        if self.num_classes == 1:
            y = labels if labels.ndim == 4 else labels[..., None]
            per = losses.binary_cross_entropy(logits, y, reduction="none")
        else:
            per = losses.softmax_cross_entropy(logits, labels,
                                               reduction="none")
        if mask is not None:
            per = per * mask
            return torch.sum(per) / torch.clamp(torch.sum(mask), min=1.0)
        return torch.mean(per)
