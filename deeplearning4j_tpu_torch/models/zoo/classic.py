"""Classic sequential zoo entries (↔ deeplearning4j_tpu/models/zoo/classic.py).

So far the char-RNN: ``text_generation_lstm`` (↔ zoo TextGenerationLSTM),
two LSTM (default: GravesLSTM) layers and a per-step softmax output, and
``next_char_probs``, the forward a text-generation server runs. The CNN
entries come with the convolution layers.
"""

from __future__ import annotations

import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.config import (
    NeuralNetConfiguration,
    SequentialConfig,
)
from deeplearning4j_tpu_torch.nn.layers import LSTM, GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.model import SequentialModel
from deeplearning4j_tpu_torch.utils.pytree import tree_leaves


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
