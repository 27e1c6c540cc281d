"""Activation registry (↔ deeplearning4j_tpu/nn/activations.py).

The JAX registry's 26 names, each resolved to the port's op of the same
definition (``ops/nn.py``); names are case-insensitive. ``softmax`` and
``log_softmax`` are over the last axis; ``leakyrelu02`` is Keras'
``leaky_relu`` activation string (slope 0.2), ``exp`` its
``exponential``.
"""

from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.ops import nn as opsnn

ACTIVATIONS: dict[str, Callable] = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": opsnn.relu,
    "relu6": opsnn.relu6,
    "sigmoid": opsnn.sigmoid,
    "tanh": opsnn.tanh,
    "softmax": opsnn.softmax,
    "log_softmax": opsnn.log_softmax,
    "softplus": opsnn.softplus,
    "softsign": opsnn.soft_sign,
    "elu": opsnn.elu,
    "selu": opsnn.selu,
    "gelu": opsnn.gelu,
    "silu": opsnn.silu,
    "swish": opsnn.swish,
    "mish": opsnn.mish,
    "hardsigmoid": opsnn.hard_sigmoid,
    "hardtanh": opsnn.hard_tanh,
    "leakyrelu": opsnn.leaky_relu,
    "hardswish": opsnn.hard_swish,
    "exp": torch.exp,
    "leakyrelu02": lambda x: opsnn.leaky_relu(x, 0.2),
    "thresholdedrelu": opsnn.thresholded_relu,
    "rationaltanh": opsnn.rational_tanh,
    "rectifiedtanh": opsnn.rectified_tanh,
    "cube": opsnn.cube,
}


def get_activation(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    try:
        return ACTIVATIONS[name_or_fn.lower()]
    except KeyError:
        raise ValueError(
            f"unknown activation '{name_or_fn}'; available: "
            f"{sorted(ACTIVATIONS)}") from None
