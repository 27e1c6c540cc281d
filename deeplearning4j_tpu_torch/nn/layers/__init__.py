"""Layers (↔ deeplearning4j_tpu.nn.layers)."""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    SelfAttention,
    TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (
    Conv2D,
    GlobalPooling,
    Pooling2D,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    ActivationLayer,
    Dense,
    Embedding,
    Flatten,
)
from deeplearning4j_tpu_torch.nn.layers.norm import BatchNorm
from deeplearning4j_tpu_torch.nn.layers.output import (
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GRU,
    LSTM,
    GravesLSTM,
)

__all__ = ["GRU", "LSTM", "ActivationLayer", "BatchNorm", "Conv2D", "Dense",
           "Embedding", "Flatten", "GlobalPooling", "GravesLSTM",
           "OutputLayer", "Pooling2D", "RnnOutputLayer", "SelfAttention",
           "TransformerEncoderBlock"]
