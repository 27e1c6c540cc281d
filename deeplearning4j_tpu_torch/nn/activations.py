"""Activation registry (↔ deeplearning4j_tpu/nn/activations.py).

The names the ported models use; the rest of the JAX registry comes with
the layers that need it. ``softmax`` is over the last axis.
"""

from __future__ import annotations

from typing import Callable

from deeplearning4j_tpu_torch.ops import nn as opsnn

ACTIVATIONS: dict[str, Callable] = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": opsnn.relu,
    "tanh": opsnn.tanh,
    "gelu": opsnn.gelu,
    "sigmoid": opsnn.sigmoid,
    "softmax": opsnn.softmax,
    "leakyrelu": opsnn.leaky_relu,
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
