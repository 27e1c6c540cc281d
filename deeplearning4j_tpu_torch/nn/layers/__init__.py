"""Layers (↔ deeplearning4j_tpu.nn.layers)."""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    SelfAttention,
    TransformerEncoderBlock,
)

__all__ = ["SelfAttention", "TransformerEncoderBlock"]
