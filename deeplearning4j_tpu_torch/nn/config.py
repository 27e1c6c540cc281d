"""Configuration-as-data with JSON round-trip (↔ deeplearning4j_tpu/nn/config.py).

Same format as the JAX package: dataclasses registered by class name,
serialized with an ``"@class"`` discriminator. The ``@class`` names and the
fields are the JAX package's, so a config JSON written by either package
loads in the other (``models.bert.BertConfig`` is the one the port has so
far, with its ``NeuralNetConfiguration`` and ``Adam`` updater).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

CONFIG_REGISTRY: Dict[str, type] = {}


def register_config(cls):
    """Class decorator: make a dataclass JSON round-trippable by name."""
    CONFIG_REGISTRY[cls.__name__] = cls
    return cls


def config_to_dict(obj: Any) -> Any:
    """Recursively convert a config object to JSON-able primitives."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {"@class": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = config_to_dict(getattr(obj, f.name))
        return d
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    return obj


def config_from_dict(d: Any) -> Any:
    """Inverse of config_to_dict (lists stay lists; configs by @class).
    Unknown fields are dropped, as in the JAX package (forward compat)."""
    if isinstance(d, dict):
        if "@class" in d:
            cls = CONFIG_REGISTRY.get(d["@class"])
            if cls is None:
                raise ValueError(f"unknown config class '{d['@class']}'")
            names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: config_from_dict(v) for k, v in d.items()
                      if k != "@class" and k in names}
            return cls(**kwargs)
        return {k: config_from_dict(v) for k, v in d.items()}
    if isinstance(d, list):
        return [config_from_dict(v) for v in d]
    return d


def config_to_json(obj: Any, **kw) -> str:
    return json.dumps(config_to_dict(obj), indent=kw.pop("indent", 2), **kw)


def config_from_json(s: str) -> Any:
    return config_from_dict(json.loads(s))


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string → torch dtype (the names the JAX package uses)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype '{name}'; the port supports "
            f"{sorted(_DTYPES)}") from None


@register_config
@dataclass
class NeuralNetConfiguration:
    """Global hyperparameters; fields as in the JAX package so its JSON
    loads here. The port reads ``seed`` (parameter init) and ``dtype``; the
    training fields are carried for the Trainer slice."""

    seed: int = 12345
    updater: Any = None
    weight_init: str = "xavier"
    dtype: str = "float32"
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    l1: float = 0.0
    l2: float = 0.0
    mixed_precision: bool = False
    rng_impl: Optional[str] = None
    backprop_type: str = "standard"
    tbptt_length: int = 0
