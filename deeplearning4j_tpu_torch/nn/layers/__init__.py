"""Layers (↔ deeplearning4j_tpu.nn.layers)."""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    SelfAttention,
    TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.nn.layers.core import Dense, Embedding
from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GRU,
    LSTM,
    GravesLSTM,
)

__all__ = ["GRU", "LSTM", "Dense", "Embedding", "GravesLSTM",
           "RnnOutputLayer", "SelfAttention", "TransformerEncoderBlock"]
