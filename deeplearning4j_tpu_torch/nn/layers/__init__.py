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
    Conv1D,
    Conv2D,
    Conv3D,
    Cropping1D,
    Cropping2D,
    Cropping3D,
    Deconv2D,
    Deconv3D,
    DepthToSpace,
    DepthwiseConv2D,
    GlobalPooling,
    LocallyConnected1D,
    LocallyConnected2D,
    Pooling1D,
    Pooling2D,
    Pooling3D,
    SeparableConv2D,
    SpaceToDepth,
    Upsampling1D,
    Upsampling2D,
    Upsampling3D,
    ZeroPadding1D,
    ZeroPadding2D,
    ZeroPadding3D,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    ActivationLayer,
    Dense,
    Dropout,
    Embedding,
    Flatten,
)
from deeplearning4j_tpu_torch.nn.layers.norm import (
    BatchNorm,
    LayerNorm,
    LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.output import (
    CnnLossLayer,
    LossLayer,
    OutputLayer,
    RnnLossLayer,
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
           "CnnLossLayer", "Conv1D", "Conv2D", "Conv3D", "Cropping1D",
           "Cropping2D", "Cropping3D", "CrossAttention", "Deconv2D",
           "Deconv3D", "Dense", "DepthToSpace", "DepthwiseConv2D",
           "Dropout", "Embedding", "Flatten", "GlobalPooling", "GravesLSTM",
           "LastTimeStep", "LayerNorm", "LearnedSelfAttention",
           "LocalResponseNormalization", "LocallyConnected1D",
           "LocallyConnected2D", "LossLayer", "OutputLayer", "Pooling1D",
           "Pooling2D", "Pooling3D", "PositionalEmbedding",
           "RecurrentAttention", "RnnLossLayer", "RnnOutputLayer",
           "SelfAttention", "SelfAttentionModule", "SeparableConv2D",
           "SimpleRnn", "SpaceToDepth", "TransformerEncoderBlock",
           "TransformerEncoderBlockModule", "Upsampling1D", "Upsampling2D",
           "Upsampling3D", "ZeroPadding1D", "ZeroPadding2D", "ZeroPadding3D",
           "graves_bidirectional_lstm"]
