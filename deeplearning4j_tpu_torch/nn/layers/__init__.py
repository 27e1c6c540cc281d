"""Layers (↔ deeplearning4j_tpu.nn.layers)."""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    SelfAttention,
    TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.nn.layers.core import Dense
from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM, GravesLSTM

__all__ = ["LSTM", "Dense", "GravesLSTM", "RnnOutputLayer", "SelfAttention",
           "TransformerEncoderBlock"]
