"""Core feed-forward layers (↔ deeplearning4j_tpu/nn/layers/core.py): ``Dense``, ``Embedding``, ``ActivationLayer``, ``Flatten``.

Param names follow the reference: ``Dense`` "W" [in, out] and "b" [out],
applied as ``x @ W + b`` then the activation; ``Embedding`` "W" [vocab,
units], a gather of rows by integer id. ``Flatten`` flattens the logical
NHWC activation in (H, W, C) order, so a dense layer's weights carry across
from the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_config
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.ops import nn as opsnn


@register_config
@dataclass
class Dense(LayerConfig):
    """Fully connected layer (↔ DenseLayer: x·W + b, then activation)."""

    units: int = 0
    activation: str = "identity"
    weight_init: Optional[str] = None  # None → net default
    use_bias: bool = True

    def output_shape(self, input_shape):
        return (*input_shape[:-1], self.units)

    def init(self, generator, input_shape, dtype):
        w_init = get_initializer(self.weight_init or "xavier")
        params = {"W": w_init((input_shape[-1], self.units), generator,
                              dtype)}
        if self.use_bias:
            params["b"] = torch.zeros((self.units,), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        y = opsnn.linear(x, params["W"], params.get("b"))
        return get_activation(self.activation)(y), state


@register_config
@dataclass
class Embedding(LayerConfig):
    """↔ EmbeddingLayer / EmbeddingSequenceLayer: integer ids of any shape
    → their rows of "W" [vocab_size, units] (``ops/nn.embedding_lookup``,
    which raises on an id out of range)."""

    vocab_size: int = 0
    units: int = 0
    weight_init: Optional[str] = None

    def output_shape(self, input_shape):
        return (*input_shape, self.units)

    def init(self, generator, input_shape, dtype):
        w_init = get_initializer(self.weight_init or "normal")
        return {"W": w_init((self.vocab_size, self.units), generator,
                            dtype)}, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        return opsnn.embedding_lookup(params["W"], x), state


@register_config
@dataclass
class ActivationLayer(LayerConfig):
    """↔ ActivationLayer: an activation with no params. ``alpha``
    parameterizes leakyrelu's slope, elu's alpha and thresholdedrelu's
    theta; None keeps each function's default."""

    activation: str = "relu"
    alpha: Optional[float] = None

    def apply(self, params, state, x, *, train=False, generator=None):
        if self.alpha is not None:
            name = self.activation.lower()
            if name == "leakyrelu":
                return opsnn.leaky_relu(x, self.alpha), state
            if name == "elu":
                return opsnn.elu(x, self.alpha), state
            if name == "thresholdedrelu":
                return opsnn.thresholded_relu(x, self.alpha), state
            raise ValueError(f"activation {name!r} takes no alpha")
        return get_activation(self.activation)(x), state


@register_config
@dataclass
class Flatten(LayerConfig):
    """↔ CnnToFeedForwardPreProcessor: flatten the trailing dims."""

    def output_shape(self, input_shape):
        return (math.prod(input_shape),)

    def apply(self, params, state, x, *, train=False, generator=None):
        return x.reshape(x.shape[0], -1), state
