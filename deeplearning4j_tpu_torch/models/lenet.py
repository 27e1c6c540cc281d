"""LeNet-5 (↔ deeplearning4j_tpu/models/lenet.py, DL4J zoo LeNet).

conv5×5×20 → maxpool 2 → conv5×5×50 → maxpool 2 → dense 500 (relu) →
softmax 10, on NHWC [N, 28, 28, 1] images; the layer names and weights
are the JAX package's (``0_conv2d`` … ``6_outputlayer``).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.config import (
    NeuralNetConfiguration,
    SequentialConfig,
)
from deeplearning4j_tpu_torch.nn.layers import (
    Conv2D,
    Dense,
    Flatten,
    OutputLayer,
    Pooling2D,
)
from deeplearning4j_tpu_torch.nn.model import SequentialModel
from deeplearning4j_tpu_torch.train.updaters import Adam


def lenet_config(
    *,
    num_classes: int = 10,
    input_shape=(28, 28, 1),
    updater=None,
    seed: int = 12345,
) -> SequentialConfig:
    net = NeuralNetConfiguration(
        seed=seed,
        updater=updater if updater is not None else Adam(1e-3),
        weight_init="xavier",
    )
    layers = [
        Conv2D(filters=20, kernel=5, stride=1, padding="SAME",
               activation="relu"),
        Pooling2D(pool_type="max", window=2),
        Conv2D(filters=50, kernel=5, stride=1, padding="SAME",
               activation="relu"),
        Pooling2D(pool_type="max", window=2),
        Flatten(),
        Dense(units=500, activation="relu"),
        OutputLayer(units=num_classes, activation="softmax", loss="mcxent"),
    ]
    return SequentialConfig(net=net, layers=layers, input_shape=input_shape)


def lenet(device=None, **kw) -> SequentialModel:
    return SequentialModel(lenet_config(**kw), device=device)
