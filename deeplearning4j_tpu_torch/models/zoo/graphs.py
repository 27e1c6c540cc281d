"""DAG zoo entries (↔ deeplearning4j_tpu/models/zoo/graphs.py): SqueezeNet, U-Net, Xception.

Each a ``GraphConfig`` DAG with the JAX package's vertex names, layers
and order, so configs, variables and checkpoints cross both ways: fire
modules with concatenated expands (SqueezeNet v1.1), an encoder-decoder
with skip concatenations and a per-pixel head (U-Net), separable-conv
towers with 1×1-conv shortcuts (Xception, 34 ``SeparableConv2D``).
"""

from __future__ import annotations

from typing import Dict

from deeplearning4j_tpu_torch.models.zoo.pixel import PixelOutput
from deeplearning4j_tpu_torch.nn.config import (
    GraphConfig,
    GraphVertex,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNorm,
    Conv2D,
    Dropout,
    GlobalPooling,
    LossLayer,
    OutputLayer,
    Pooling2D,
    SeparableConv2D,
    Upsampling2D,
)
from deeplearning4j_tpu_torch.nn.model import GraphModel


def _layer(v: Dict[str, GraphVertex], name: str, inp: str, layer) -> str:
    v[name] = GraphVertex(kind="layer", inputs=[inp], layer=layer)
    return name


def _graph(net, v, input_shape) -> GraphConfig:
    return GraphConfig(net=net, inputs=["input"],
                       input_shapes={"input": tuple(input_shape)},
                       vertices=v, outputs=["output"])


# --- SqueezeNet -------------------------------------------------------------


def _fire(v, name, inp, *, squeeze, expand):
    s = _layer(v, f"{name}_sq", inp,
               Conv2D(filters=squeeze, kernel=1, activation="relu"))
    e1 = _layer(v, f"{name}_e1", s,
                Conv2D(filters=expand, kernel=1, activation="relu"))
    e3 = _layer(v, f"{name}_e3", s,
                Conv2D(filters=expand, kernel=3, activation="relu"))
    v[f"{name}_cat"] = GraphVertex(kind="merge", inputs=[e1, e3])
    return f"{name}_cat"


def squeezenet_config(*, num_classes: int = 1000, input_shape=(224, 224, 3),
                      updater=None, seed: int = 12345) -> GraphConfig:
    """↔ zoo SqueezeNet v1.1 (fire modules, conv10 head, global avg
    pool, a parameter-free softmax loss head)."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="relu")
    v: Dict[str, GraphVertex] = {}
    x = _layer(v, "stem", "input",
               Conv2D(filters=64, kernel=3, stride=2, activation="relu"))
    x = _layer(v, "pool1", x, Pooling2D(pool_type="max", window=3, stride=2))
    x = _fire(v, "fire2", x, squeeze=16, expand=64)
    x = _fire(v, "fire3", x, squeeze=16, expand=64)
    x = _layer(v, "pool3", x, Pooling2D(pool_type="max", window=3, stride=2))
    x = _fire(v, "fire4", x, squeeze=32, expand=128)
    x = _fire(v, "fire5", x, squeeze=32, expand=128)
    x = _layer(v, "pool5", x, Pooling2D(pool_type="max", window=3, stride=2))
    x = _fire(v, "fire6", x, squeeze=48, expand=192)
    x = _fire(v, "fire7", x, squeeze=48, expand=192)
    x = _fire(v, "fire8", x, squeeze=64, expand=256)
    x = _fire(v, "fire9", x, squeeze=64, expand=256)
    x = _layer(v, "drop9", x, Dropout(rate=0.5))
    x = _layer(v, "conv10", x,
               Conv2D(filters=num_classes, kernel=1, activation="relu"))
    x = _layer(v, "gap", x, GlobalPooling(pool_type="avg"))
    _layer(v, "output", x, LossLayer(activation="softmax", loss="mcxent"))
    return _graph(net, v, input_shape)


# --- U-Net ------------------------------------------------------------------


def unet_config(*, num_classes: int = 1, input_shape=(128, 128, 3),
                base_filters: int = 32, depth: int = 4, updater=None,
                seed: int = 12345) -> GraphConfig:
    """↔ zoo UNet: ``depth`` double-conv encoder stages (filters
    base·2^d) with max pools, a middle double conv, nearest upsampling
    and skip concatenations back up, then ``PixelOutput`` (one class:
    sigmoid / binary cross-entropy; more: softmax per pixel)."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="relu")
    v: Dict[str, GraphVertex] = {}

    def double_conv(name, inp, filters):
        a = _layer(v, f"{name}_c1", inp,
                   Conv2D(filters=filters, kernel=3, activation="relu"))
        return _layer(v, f"{name}_c2", a,
                      Conv2D(filters=filters, kernel=3, activation="relu"))

    skips = []
    x = "input"
    for d in range(depth):
        x = double_conv(f"enc{d}", x, base_filters * (2 ** d))
        skips.append(x)
        x = _layer(v, f"down{d}", x, Pooling2D(pool_type="max", window=2))
    x = double_conv("mid", x, base_filters * (2 ** depth))
    for d in reversed(range(depth)):
        x = _layer(v, f"up{d}", x, Upsampling2D(scale=2))
        v[f"cat{d}"] = GraphVertex(kind="merge", inputs=[x, skips[d]])
        x = double_conv(f"dec{d}", f"cat{d}", base_filters * (2 ** d))
    _layer(v, "output", x, PixelOutput(num_classes=num_classes))
    return _graph(net, v, input_shape)


# --- Xception ---------------------------------------------------------------


def xception_config(*, num_classes: int = 1000, input_shape=(299, 299, 3),
                    updater=None, seed: int = 12345) -> GraphConfig:
    """↔ zoo Xception: a two-conv stem, three entry blocks, eight middle
    blocks and the exit flow of separable convs with BatchNorm, residual
    adds over 1×1 stride-2 conv shortcuts, global average pool, softmax."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="relu")
    v: Dict[str, GraphVertex] = {}

    def sep_bn(name, inp, filters, activation_first=True):
        src = inp
        if activation_first:
            src = _layer(v, f"{name}_act", src,
                         ActivationLayer(activation="relu"))
        c = _layer(v, f"{name}_sep", src,
                   SeparableConv2D(filters=filters, kernel=3,
                                   use_bias=False))
        return _layer(v, f"{name}_bn", c, BatchNorm())

    def conv_bn(name, inp, filters, kernel, stride):
        c = _layer(v, f"{name}_conv", inp,
                   Conv2D(filters=filters, kernel=kernel, stride=stride,
                          use_bias=False))
        return _layer(v, f"{name}_bn", c, BatchNorm(activation="relu"))

    def shortcut_add(name, main, inp, filters):
        p = _layer(v, f"{name}_pool", main,
                   Pooling2D(pool_type="max", window=3, stride=2,
                             padding="SAME"))
        sc = _layer(v, f"{name}_short", inp,
                    Conv2D(filters=filters, kernel=1, stride=2,
                           use_bias=False))
        sb = _layer(v, f"{name}_shortbn", sc, BatchNorm())
        v[f"{name}_add"] = GraphVertex(kind="add", inputs=[p, sb])
        return f"{name}_add"

    x = conv_bn("stem1", "input", 32, 3, 2)
    x = conv_bn("stem2", x, 64, 3, 1)

    for name, filters, first_act in (("e1", 128, False), ("e2", 256, True),
                                     ("e3", 728, True)):
        a = sep_bn(f"{name}_s1", x, filters, activation_first=first_act)
        b = sep_bn(f"{name}_s2", a, filters)
        x = shortcut_add(name, b, x, filters)

    for i in range(8):
        a = sep_bn(f"m{i}_s1", x, 728)
        b = sep_bn(f"m{i}_s2", a, 728)
        c = sep_bn(f"m{i}_s3", b, 728)
        v[f"m{i}_add"] = GraphVertex(kind="add", inputs=[c, x])
        x = f"m{i}_add"

    a = sep_bn("x1_s1", x, 728)
    b = sep_bn("x1_s2", a, 1024)
    x = shortcut_add("x1", b, x, 1024)
    c = _layer(v, "x2_sep", x,
               SeparableConv2D(filters=1536, kernel=3, use_bias=False))
    c = _layer(v, "x2_bn", c, BatchNorm(activation="relu"))
    c = _layer(v, "x3_sep", c,
               SeparableConv2D(filters=2048, kernel=3, use_bias=False))
    c = _layer(v, "x3_bn", c, BatchNorm(activation="relu"))
    g = _layer(v, "gap", c, GlobalPooling(pool_type="avg"))
    _layer(v, "output", g, OutputLayer(units=num_classes,
                                       activation="softmax", loss="mcxent"))
    return _graph(net, v, input_shape)


def squeezenet(device=None, **kw) -> GraphModel:
    return GraphModel(squeezenet_config(**kw), device=device)


def unet(device=None, **kw) -> GraphModel:
    return GraphModel(unet_config(**kw), device=device)


def xception(device=None, **kw) -> GraphModel:
    return GraphModel(xception_config(**kw), device=device)
