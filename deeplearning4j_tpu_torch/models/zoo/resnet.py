"""ResNet family (↔ deeplearning4j_tpu/models/zoo/resnet.py, DL4J zoo ResNet50).

A ``GraphConfig`` of the JAX package's vertices and names: 7×7/2 stem
conv + BatchNorm(relu) → 3×3/2 SAME max pool → stages of bottleneck
blocks (1×1 f → 3×3 f (stride 2 on a stage's first block past the
first) → 1×1 4f, a projection shortcut on each stage's first block, an
``add`` vertex and a relu) → global average pool → softmax output.
Vertex names (``stem_conv``, ``s0b0_a_bn``, ``s3b2_relu``, ``output``) are
the variables' and checkpoints' names in both packages. Convs run through
cuDNN on the card (``ops/cnn.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence

from deeplearning4j_tpu_torch.nn.config import (
    GraphConfig,
    GraphVertex,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNorm,
    Conv2D,
    GlobalPooling,
    OutputLayer,
    Pooling2D,
)
from deeplearning4j_tpu_torch.nn.model import GraphModel


def _conv_bn(vertices: Dict[str, GraphVertex], name: str, inp: str, *,
             filters: int, kernel, stride=1, activation: str = "relu",
             padding="SAME") -> str:
    """conv → bn(+act) pair; returns the output vertex name."""
    vertices[f"{name}_conv"] = GraphVertex(
        kind="layer", inputs=[inp],
        layer=Conv2D(filters=filters, kernel=kernel, stride=stride,
                     padding=padding, use_bias=False),
    )
    vertices[f"{name}_bn"] = GraphVertex(
        kind="layer", inputs=[f"{name}_conv"],
        layer=BatchNorm(activation=activation),
    )
    return f"{name}_bn"


def _bottleneck(vertices: Dict[str, GraphVertex], name: str, inp: str, *,
                filters: int, stride: int, project: bool) -> str:
    """1x1 → 3x3 → 1x1(4f) bottleneck with identity/projection shortcut."""
    a = _conv_bn(vertices, f"{name}_a", inp, filters=filters, kernel=1,
                 stride=1)
    b = _conv_bn(vertices, f"{name}_b", a, filters=filters, kernel=3,
                 stride=stride)
    c = _conv_bn(vertices, f"{name}_c", b, filters=4 * filters, kernel=1,
                 stride=1, activation="identity")
    if project:
        short = _conv_bn(vertices, f"{name}_proj", inp, filters=4 * filters,
                         kernel=1, stride=stride, activation="identity")
    else:
        short = inp
    vertices[f"{name}_add"] = GraphVertex(kind="add", inputs=[c, short])
    vertices[f"{name}_relu"] = GraphVertex(
        kind="layer", inputs=[f"{name}_add"],
        layer=ActivationLayer(activation="relu"))
    return f"{name}_relu"


def resnet_config(
    *,
    blocks: Sequence[int] = (3, 4, 6, 3),
    num_classes: int = 1000,
    input_shape=(224, 224, 3),
    updater=None,
    seed: int = 12345,
    dtype: str = "float32",
) -> GraphConfig:
    net = NeuralNetConfiguration(seed=seed, updater=updater, dtype=dtype,
                                 weight_init="relu")
    v: Dict[str, GraphVertex] = {}
    x = _conv_bn(v, "stem", "input", filters=64, kernel=7, stride=2)
    v["stem_pool"] = GraphVertex(
        kind="layer", inputs=[x],
        layer=Pooling2D(pool_type="max", window=3, stride=2, padding="SAME"),
    )
    x = "stem_pool"
    for stage, n_blocks in enumerate(blocks):
        filters = 64 * (2 ** stage)
        for block in range(n_blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            x = _bottleneck(v, f"s{stage}b{block}", x, filters=filters,
                            stride=stride, project=(block == 0))
    v["avgpool"] = GraphVertex(
        kind="layer", inputs=[x], layer=GlobalPooling(pool_type="avg"))
    v["output"] = GraphVertex(
        kind="layer", inputs=["avgpool"],
        layer=OutputLayer(units=num_classes, activation="softmax",
                          loss="mcxent"))
    return GraphConfig(net=net, inputs=["input"],
                       input_shapes={"input": tuple(input_shape)},
                       vertices=v, outputs=["output"])


def resnet50(device=None, **kw) -> GraphModel:
    return GraphModel(resnet_config(blocks=(3, 4, 6, 3), **kw), device=device)


def resnet101(device=None, **kw) -> GraphModel:
    return GraphModel(resnet_config(blocks=(3, 4, 23, 3), **kw),
                      device=device)


def resnet152(device=None, **kw) -> GraphModel:
    return GraphModel(resnet_config(blocks=(3, 8, 36, 3), **kw),
                      device=device)
