"""Advanced zoo DAGs (↔ deeplearning4j_tpu/models/zoo/advanced.py): Inception-ResNet-v1 and NASNet-A.

Both are ``GraphConfig`` DAGs with the JAX package's vertex names, layers
and order, so configs, variables and checkpoints cross both ways:
scaled-residual inception branches (Szegedy et al. 2016; the FaceNet
backbone, ending in a linear 128-d bottleneck when ``num_classes=0``),
and NASNet-A's two-input cells (h, h_prev) of separable-conv, pool and
identity pairs (Zoph et al. 2018). Filter counts are parametric, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict

from deeplearning4j_tpu_torch.models.zoo.graphs import _layer
from deeplearning4j_tpu_torch.nn.config import (
    GraphConfig,
    GraphVertex,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    GlobalPooling,
    OutputLayer,
    Pooling2D,
    SeparableConv2D,
)
from deeplearning4j_tpu_torch.nn.model import GraphModel


def _merge(v, name, inputs, kind="merge"):
    v[name] = GraphVertex(kind=kind, inputs=list(inputs))
    return name


def _scaled_residual(v, name, inp, branch, factor):
    """x + factor · branch: the Inception-ResNet residual scaling."""
    v[f"{name}_scl"] = GraphVertex(kind="scale", inputs=[branch],
                                   args={"factor": factor})
    return _merge(v, name, [inp, f"{name}_scl"], kind="add")


def _cb(v, name, inp, filters, kernel, stride=1, *, act="relu",
        padding="SAME"):
    """Bias-free conv → BatchNorm carrying the activation."""
    c = _layer(v, f"{name}_c", inp,
               Conv2D(filters=filters, kernel=kernel, stride=stride,
                      padding=padding, use_bias=False))
    return _layer(v, f"{name}_bn", c, BatchNorm(activation=act))


# --- Inception-ResNet-v1 ----------------------------------------------------


def _ir_block_a(v, name, inp, w):
    """35×35 Inception-ResNet-A: 1×1 / 1×1-3×3 / 1×1-3×3-3×3 branches, a
    linear 1×1 projection with a bias, residual scaled by 0.17."""
    b0 = _cb(v, f"{name}_b0", inp, w, 1)
    b1 = _cb(v, f"{name}_b1b", _cb(v, f"{name}_b1a", inp, w, 1), w, 3)
    b2a = _cb(v, f"{name}_b2a", inp, w, 1)
    b2 = _cb(v, f"{name}_b2c", _cb(v, f"{name}_b2b", b2a, w, 3), w, 3)
    cat = _merge(v, f"{name}_cat", [b0, b1, b2])
    up = _layer(v, f"{name}_up", cat, Conv2D(filters=4 * w, kernel=1))
    add = _scaled_residual(v, f"{name}_add", inp, up, 0.17)
    return _layer(v, f"{name}_relu", add, ActivationLayer(activation="relu"))


def _ir_block_b(v, name, inp, w, channels):
    """17×17 Inception-ResNet-B: 1×1 / 1×1-1×7-7×1 branches, residual
    scaled by 0.10."""
    b0 = _cb(v, f"{name}_b0", inp, w, 1)
    b1a = _cb(v, f"{name}_b1a", inp, w, 1)
    b1b = _cb(v, f"{name}_b1b", b1a, w, (1, 7))
    b1 = _cb(v, f"{name}_b1c", b1b, w, (7, 1))
    cat = _merge(v, f"{name}_cat", [b0, b1])
    up = _layer(v, f"{name}_up", cat, Conv2D(filters=channels, kernel=1))
    add = _scaled_residual(v, f"{name}_add", inp, up, 0.10)
    return _layer(v, f"{name}_relu", add, ActivationLayer(activation="relu"))


def _ir_reduction_a(v, name, inp, w):
    """Reduction-A: max pool, strided 3×3 and 1×1-strided 3×3, concat
    in that order."""
    p = _layer(v, f"{name}_pool", inp,
               Pooling2D(pool_type="max", window=3, stride=2, padding="SAME"))
    c = _cb(v, f"{name}_c", inp, 2 * w, 3, stride=2)
    d = _cb(v, f"{name}_d2", _cb(v, f"{name}_d1", inp, w, 1), 2 * w, 3,
            stride=2)
    return _merge(v, f"{name}_cat", [p, c, d])


def inception_resnet_v1_config(
    *, num_classes: int = 0, embedding: int = 128, width: int = 32,
    blocks_a: int = 3, blocks_b: int = 5, input_shape=(160, 160, 3),
    updater=None, dropout: float = 0.2, seed: int = 12345,
) -> GraphConfig:
    """↔ zoo InceptionResNetV1 (FaceNet): stem → A-blocks → Reduction-A →
    B-blocks → global average pool → a linear ``embedding``-d
    ``bottleneck`` (``num_classes=0``) or a softmax ``output`` head. The
    reference zoo has width 32, 5 A and 10 B blocks and a C tower, which
    the JAX package has not.

    The bottleneck graph is an inference and transfer surface: fitting it
    directly raises ``TypeError``. To train it, add a loss head with
    ``train.transfer.GraphTransferLearning`` (an ``l2norm`` vertex and a
    ``CenterLossOutputLayer``, the FaceNet recipe) and strip it after."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="relu")
    v: Dict[str, GraphVertex] = {}
    w = width

    x = _cb(v, "stem1", "input", w, 3, stride=2)
    x = _cb(v, "stem2", x, w, 3)
    x = _cb(v, "stem3", x, 2 * w, 3)
    x = _layer(v, "stem_pool", x,
               Pooling2D(pool_type="max", window=3, stride=2, padding="SAME"))
    x = _cb(v, "stem4", x, 2 * w + w // 2, 1)
    x = _cb(v, "stem5", x, 4 * w, 3)
    # the A tower's input width equals the A projection's (4w)
    for i in range(blocks_a):
        x = _ir_block_a(v, f"a{i}", x, w)
    x = _ir_reduction_a(v, "red_a", x, 4 * w)
    channels_b = 4 * w + 2 * (2 * 4 * w)  # pool + conv + double-conv branches
    for i in range(blocks_b):
        x = _ir_block_b(v, f"b{i}", x, 2 * w, channels_b)

    x = _layer(v, "avgpool", x, GlobalPooling(pool_type="avg"))
    if dropout:
        x = _layer(v, "drop", x, Dropout(rate=dropout))
    if num_classes:
        v["output"] = GraphVertex(
            kind="layer", inputs=[x],
            layer=OutputLayer(units=num_classes, activation="softmax",
                              loss="mcxent"))
        outputs = ["output"]
    else:
        x = _layer(v, "bottleneck", x, Dense(units=embedding,
                                             activation="identity"))
        outputs = [x]
    return GraphConfig(net=net, inputs=["input"],
                       input_shapes={"input": tuple(input_shape)},
                       vertices=v, outputs=outputs)


def inception_resnet_v1(device=None, **kw) -> GraphModel:
    return GraphModel(inception_resnet_v1_config(**kw), device=device)


# --- NASNet-A ---------------------------------------------------------------


def _sep_block(v, name, inp, filters, kernel, stride=1):
    """NASNet separable block: relu → sepconv → bn, twice (the stride on
    the first)."""
    a = _layer(v, f"{name}_r1", inp, ActivationLayer(activation="relu"))
    a = _layer(v, f"{name}_s1", a,
               SeparableConv2D(filters=filters, kernel=kernel, stride=stride,
                               padding="SAME", use_bias=False))
    a = _layer(v, f"{name}_bn1", a, BatchNorm())
    b = _layer(v, f"{name}_r2", a, ActivationLayer(activation="relu"))
    b = _layer(v, f"{name}_s2", b,
               SeparableConv2D(filters=filters, kernel=kernel, stride=1,
                               padding="SAME", use_bias=False))
    return _layer(v, f"{name}_bn2", b, BatchNorm())


def _fit(v, name, inp, filters, stride=1):
    """relu → 1×1 (optionally strided) conv → bn, so a cell's two inputs
    agree in shape and width (NASNet's squeeze/adjust blocks)."""
    a = _layer(v, f"{name}_r", inp, ActivationLayer(activation="relu"))
    a = _layer(v, f"{name}_c", a,
               Conv2D(filters=filters, kernel=1, stride=stride,
                      use_bias=False))
    return _layer(v, f"{name}_bn", a, BatchNorm())


def _normal_cell(v, name, h, h_prev, filters):
    """NASNet-A normal cell: 5 pairwise-add blocks over (h, h_prev),
    concatenated b1..b5 → (cell output, the fitted h as the next
    h_prev)."""
    h = _fit(v, f"{name}_fit_h", h, filters)
    p = _fit(v, f"{name}_fit_p", h_prev, filters)
    b1 = _merge(v, f"{name}_b1", [
        _sep_block(v, f"{name}_b1l", h, filters, 3), h], kind="add")
    b2 = _merge(v, f"{name}_b2", [
        _sep_block(v, f"{name}_b2l", p, filters, 3),
        _sep_block(v, f"{name}_b2r", h, filters, 5)], kind="add")
    b3 = _merge(v, f"{name}_b3", [
        _layer(v, f"{name}_b3l", p,
               Pooling2D(pool_type="avg", window=3, stride=1,
                         padding="SAME")), p], kind="add")
    b4 = _merge(v, f"{name}_b4", [
        _sep_block(v, f"{name}_b4l", p, filters, 5),
        _sep_block(v, f"{name}_b4r", p, filters, 3)], kind="add")
    b5 = _merge(v, f"{name}_b5", [
        _layer(v, f"{name}_b5l", h,
               Pooling2D(pool_type="avg", window=3, stride=1,
                         padding="SAME")), h], kind="add")
    out = _merge(v, f"{name}_out", [b1, b2, b3, b4, b5])
    return out, h


def _reduction_cell(v, name, h, h_prev, filters):
    """NASNet-A reduction cell: h_prev feeds the sep7×7 / sep5×5
    right-hand branches of blocks 1-3, everything strided to /2; the
    output concatenates b1, b3, b4, and the next h_prev is the fitted h
    projected at stride 2 (not the cell output)."""
    h = _fit(v, f"{name}_fit_h", h, filters)
    p = _fit(v, f"{name}_fit_p", h_prev, filters)
    b1 = _merge(v, f"{name}_b1", [
        _sep_block(v, f"{name}_b1l", h, filters, 5, stride=2),
        _sep_block(v, f"{name}_b1r", p, filters, 7, stride=2)], kind="add")
    b2 = _merge(v, f"{name}_b2", [
        _layer(v, f"{name}_b2l", h,
               Pooling2D(pool_type="max", window=3, stride=2,
                         padding="SAME")),
        _sep_block(v, f"{name}_b2r", p, filters, 7, stride=2)], kind="add")
    b3 = _merge(v, f"{name}_b3", [
        _layer(v, f"{name}_b3l", h,
               Pooling2D(pool_type="avg", window=3, stride=2,
                         padding="SAME")),
        _sep_block(v, f"{name}_b3r", p, filters, 5, stride=2)], kind="add")
    b4 = _merge(v, f"{name}_b4", [
        _layer(v, f"{name}_b4l", b1,
               Pooling2D(pool_type="max", window=3, stride=1,
                         padding="SAME")), b2], kind="add")
    out = _merge(v, f"{name}_out", [b1, b3, b4])
    hp = _fit(v, f"{name}_fit_hp", h, filters, stride=2)
    return out, hp


def nasnet_config(*, num_classes: int = 1000, input_shape=(224, 224, 3),
                  penultimate_filters: int = 176, cells_per_stack: int = 2,
                  stem_filters: int = 32, updater=None, dropout: float = 0.5,
                  seed: int = 12345) -> GraphConfig:
    """↔ zoo NASNet (NASNet-A). The mobile reference config (NASNet-A
    4@1056) is ``penultimate_filters=1056, cells_per_stack=4``, stem 32
    (4,165,560 parameters at 224², 1000 classes); the defaults are the
    JAX package's narrower ones, with the same cell topology."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="relu")
    v: Dict[str, GraphVertex] = {}
    f = penultimate_filters // 24  # NASNet's filter-scaling convention

    x = _cb(v, "stem", "input", stem_filters, 3, stride=2, act="identity")
    h, p = x, x
    for i in range(cells_per_stack):
        h, p = _normal_cell(v, f"n1_{i}", h, p, f)
    h, p = _reduction_cell(v, "r1", h, p, 2 * f)
    for i in range(cells_per_stack):
        h, p = _normal_cell(v, f"n2_{i}", h, p, 2 * f)
    h, p = _reduction_cell(v, "r2", h, p, 4 * f)
    for i in range(cells_per_stack):
        h, p = _normal_cell(v, f"n3_{i}", h, p, 4 * f)

    x = _layer(v, "final_relu", h, ActivationLayer(activation="relu"))
    x = _layer(v, "gap", x, GlobalPooling(pool_type="avg"))
    if dropout:
        x = _layer(v, "drop", x, Dropout(rate=dropout))
    v["output"] = GraphVertex(
        kind="layer", inputs=[x],
        layer=OutputLayer(units=num_classes, activation="softmax",
                          loss="mcxent"))
    return GraphConfig(net=net, inputs=["input"],
                       input_shapes={"input": tuple(input_shape)},
                       vertices=v, outputs=["output"])


def nasnet(device=None, **kw) -> GraphModel:
    return GraphModel(nasnet_config(**kw), device=device)
