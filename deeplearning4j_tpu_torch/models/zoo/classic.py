"""Classic sequential zoo entries (↔ deeplearning4j_tpu/models/zoo/classic.py).

The CNNs (↔ zoo AlexNet, VGG16, VGG19, SimpleCNN, Darknet19) as
``SequentialConfig`` factories with the JAX package's layers and order,
and the char-RNN: ``text_generation_lstm`` (↔ zoo TextGenerationLSTM),
two LSTM (default: GravesLSTM) layers and a per-step softmax output, with
``next_char_probs``, the forward a text-generation server runs.
"""

from __future__ import annotations

import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.config import (
    NeuralNetConfiguration,
    SequentialConfig,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LSTM,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Flatten,
    GlobalPooling,
    GravesLSTM,
    LocalResponseNormalization,
    LossLayer,
    OutputLayer,
    Pooling2D,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.model import SequentialModel
from deeplearning4j_tpu_torch.utils.pytree import tree_leaves


def _cnn_net(seed, updater):
    return NeuralNetConfiguration(seed=seed, updater=updater,
                                  weight_init="relu")


def _classifier_head(num_classes):
    """Flatten, two Dense(4096) with Dropout(0.5), softmax output."""
    return [
        Flatten(),
        Dense(units=4096, activation="relu"),
        Dropout(rate=0.5),
        Dense(units=4096, activation="relu"),
        Dropout(rate=0.5),
        OutputLayer(units=num_classes, activation="softmax", loss="mcxent"),
    ]


def alexnet_config(*, num_classes: int = 1000, input_shape=(224, 224, 3),
                   updater=None, seed: int = 12345) -> SequentialConfig:
    """↔ zoo AlexNet (one tower, with LRN, as in the reference zoo)."""
    layers = [
        Conv2D(filters=96, kernel=11, stride=4, padding="SAME",
               activation="relu"),
        LocalResponseNormalization(),
        Pooling2D(pool_type="max", window=3, stride=2),
        Conv2D(filters=256, kernel=5, stride=1, padding="SAME",
               activation="relu"),
        LocalResponseNormalization(),
        Pooling2D(pool_type="max", window=3, stride=2),
        Conv2D(filters=384, kernel=3, activation="relu"),
        Conv2D(filters=384, kernel=3, activation="relu"),
        Conv2D(filters=256, kernel=3, activation="relu"),
        Pooling2D(pool_type="max", window=3, stride=2),
        *_classifier_head(num_classes),
    ]
    return SequentialConfig(net=_cnn_net(seed, updater), layers=layers,
                            input_shape=input_shape)


def _vgg_config(spec, num_classes, input_shape, updater, seed):
    layers = []
    for n_convs, filters in spec:
        layers += [Conv2D(filters=filters, kernel=3, padding="SAME",
                          activation="relu") for _ in range(n_convs)]
        layers.append(Pooling2D(pool_type="max", window=2, stride=2))
    return SequentialConfig(net=_cnn_net(seed, updater),
                            layers=layers + _classifier_head(num_classes),
                            input_shape=input_shape)


def vgg16_config(*, num_classes: int = 1000, input_shape=(224, 224, 3),
                 updater=None, seed: int = 12345) -> SequentialConfig:
    """↔ zoo VGG16."""
    return _vgg_config([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)],
                       num_classes, input_shape, updater, seed)


def vgg19_config(*, num_classes: int = 1000, input_shape=(224, 224, 3),
                 updater=None, seed: int = 12345) -> SequentialConfig:
    """↔ zoo VGG19."""
    return _vgg_config([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)],
                       num_classes, input_shape, updater, seed)


def simplecnn_config(*, num_classes: int = 10, input_shape=(48, 48, 3),
                     updater=None, seed: int = 12345) -> SequentialConfig:
    """↔ zoo SimpleCNN (a small conv/BatchNorm stack)."""
    layers = []
    for filters in (16, 32):
        layers += [Conv2D(filters=filters, kernel=3, activation="relu"),
                   BatchNorm(),
                   Conv2D(filters=filters, kernel=3, activation="relu"),
                   BatchNorm(),
                   Pooling2D(pool_type="max", window=2)]
    layers += [
        Flatten(),
        Dense(units=128, activation="relu"),
        Dropout(rate=0.5),
        OutputLayer(units=num_classes, activation="softmax", loss="mcxent"),
    ]
    return SequentialConfig(net=_cnn_net(seed, updater), layers=layers,
                            input_shape=input_shape)


def darknet19_config(*, num_classes: int = 1000, input_shape=(224, 224, 3),
                     updater=None, seed: int = 12345) -> SequentialConfig:
    """↔ zoo Darknet19: conv + BatchNorm(leakyrelu) stacks, a 1×1 conv to
    the classes, global average pool, a parameter-free softmax head."""
    def cb(filters, kernel):
        return [Conv2D(filters=filters, kernel=kernel, use_bias=False),
                BatchNorm(activation="leakyrelu")]

    pool = [Pooling2D(pool_type="max", window=2)]
    layers = cb(32, 3) + pool + cb(64, 3) + pool
    layers += cb(128, 3) + cb(64, 1) + cb(128, 3) + pool
    layers += cb(256, 3) + cb(128, 1) + cb(256, 3) + pool
    layers += cb(512, 3) + cb(256, 1) + cb(512, 3) + cb(256, 1) + cb(512, 3)
    layers += pool
    layers += (cb(1024, 3) + cb(512, 1) + cb(1024, 3) + cb(512, 1)
               + cb(1024, 3))
    layers += [
        Conv2D(filters=num_classes, kernel=1),
        GlobalPooling(pool_type="avg"),
        LossLayer(activation="softmax", loss="mcxent"),
    ]
    return SequentialConfig(net=_cnn_net(seed, updater), layers=layers,
                            input_shape=input_shape)


def text_generation_lstm_config(*, vocab_size: int = 77, hidden: int = 256,
                                seq_len: int = 64, updater=None,
                                seed: int = 12345, graves: bool = True,
                                backend: str = "pallas") -> SequentialConfig:
    """Char-RNN config. Input: one-hot chars [N, T, vocab]; output: the
    next-char softmax at every step. ``backend="pallas"`` (the port's
    default) and ``"xla"`` (the JAX package's) run the LSTM layers through
    the fused sweeps (the CUDA kernels on the card); ``"plain"`` through
    the eager ``ops/rnn.lstm`` loop, the reference path."""
    net = NeuralNetConfiguration(seed=seed, updater=updater,
                                 weight_init="xavier")
    lstm_cls = GravesLSTM if graves else LSTM
    layers = [
        lstm_cls(units=hidden, activation="tanh", backend=backend),
        lstm_cls(units=hidden, activation="tanh", backend=backend),
        RnnOutputLayer(units=vocab_size, activation="softmax", loss="mcxent"),
    ]
    return SequentialConfig(net=net, layers=layers,
                            input_shape=(seq_len, vocab_size))


def alexnet(device=None, **kw) -> SequentialModel:
    return SequentialModel(alexnet_config(**kw), device=device)


def vgg16(device=None, **kw) -> SequentialModel:
    return SequentialModel(vgg16_config(**kw), device=device)


def vgg19(device=None, **kw) -> SequentialModel:
    return SequentialModel(vgg19_config(**kw), device=device)


def simplecnn(device=None, **kw) -> SequentialModel:
    return SequentialModel(simplecnn_config(**kw), device=device)


def darknet19(device=None, **kw) -> SequentialModel:
    return SequentialModel(darknet19_config(**kw), device=device)


def text_generation_lstm(device=None, **kw) -> SequentialModel:
    return SequentialModel(text_generation_lstm_config(**kw), device=device)


def next_char_probs(model: SequentialModel, variables, char_ids):
    """The char-RNN's serving forward: int char ids [rows, T] → the
    next-char probabilities after the last step [rows, vocab]. The ids are
    one-hot encoded on their own device (the card, when served there);
    ``ParallelInference`` calls it as ``partial(next_char_probs, model)``."""
    vocab = model.config.input_shape[-1]
    dtype = tree_leaves(variables["params"])[0].dtype
    onehot = F.one_hot(char_ids.long(), vocab).to(dtype)
    return model.output(variables, onehot)[:, -1, :]
