"""Layers (↔ deeplearning4j_tpu.nn.layers).

Importing this package registers every layer config, and the weight
constraints a layer may carry (``nn/constraints.py``), for
``config_from_dict``.
"""

from deeplearning4j_tpu_torch.nn import constraints  # noqa: F401

from deeplearning4j_tpu_torch.nn.layers.attention import (
    CrossAttention,
    LearnedSelfAttention,
    PositionalEmbedding,
    RecurrentAttention,
    SelfAttention,
    SelfAttentionModule,
    TransformerEncoderBlock,
    TransformerEncoderBlockModule,
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
    Bidirectional,
    GravesLSTM,
    LastTimeStep,
    SimpleRnn,
    graves_bidirectional_lstm,
)

__all__ = ["GRU", "LSTM", "ActivationLayer", "BatchNorm", "Bidirectional",
           "Conv2D", "CrossAttention", "Dense", "Embedding", "Flatten",
           "GlobalPooling", "GravesLSTM", "LastTimeStep",
           "LearnedSelfAttention", "OutputLayer", "Pooling2D",
           "PositionalEmbedding", "RecurrentAttention", "RnnOutputLayer",
           "SelfAttention", "SelfAttentionModule", "SimpleRnn",
           "TransformerEncoderBlock", "TransformerEncoderBlockModule",
           "graves_bidirectional_lstm"]
