"""Configuration-as-data with JSON round-trip (↔ deeplearning4j_tpu/nn/config.py).

Same format as the JAX package: dataclasses registered by class name,
serialized with an ``"@class"`` discriminator. The ``@class`` names and the
fields are the JAX package's, so a config JSON written by either package
loads in the other: ``models.bert.BertConfig``, and ``SequentialConfig``
with the layer configs of ``nn/layers`` (a layer config is a value with
``init``/``apply`` methods, as in the JAX package), each with its
``NeuralNetConfiguration`` and updater, and ``GraphConfig`` with its
``GraphVertex`` DAG (``nn.model.GraphModel``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


@dataclass
class LayerConfig:
    """Base for all layer configs (↔ org.deeplearning4j.nn.conf.layers.Layer).

    A layer config is a value; its runtime behaviour is
    ``init(generator, input_shape, dtype) -> (params, state)`` and
    ``apply(params, state, x, *, train, generator) -> (y, new_state)``
    over dicts of tensors. Shapes exclude the batch dimension. The
    keyword-only fields are the JAX package's: per-layer l1/l2 (None
    inherits the net's), dtype, a train-time ``weight_noise`` transform
    (``nn/weightnoise.py``) and ``constraints`` (``nn/constraints.py``,
    projected by the Trainer after every update).
    """

    name: Optional[str] = field(default=None, kw_only=True)
    l1: Optional[float] = field(default=None, kw_only=True)
    l2: Optional[float] = field(default=None, kw_only=True)
    dtype: Optional[str] = field(default=None, kw_only=True)
    weight_noise: Optional[Any] = field(default=None, kw_only=True)
    constraints: Optional[Any] = field(default=None, kw_only=True)

    def output_shape(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(input_shape)

    def init(self, generator, input_shape, dtype):
        return {}, {}

    def apply(self, params, state, x, *, train: bool = False,
              generator=None):
        raise NotImplementedError


@register_config
@dataclass
class SequentialConfig:
    """↔ MultiLayerConfiguration: global conf + ordered layer stack + input
    shape (without the batch dim)."""

    net: NeuralNetConfiguration
    layers: List[Any]
    input_shape: Sequence[int]

    def to_json(self) -> str:
        return config_to_json(self)

    @staticmethod
    def from_json(s: str) -> "SequentialConfig":
        cfg = config_from_json(s)
        if not isinstance(cfg, SequentialConfig):
            raise TypeError(f"expected SequentialConfig, got {type(cfg)}")
        return cfg


@register_config
@dataclass
class GraphVertex:
    """One vertex of a DAG network (↔ org.deeplearning4j.nn.conf.graph.*).

    kind: 'layer' (wraps a LayerConfig; several inputs go to a
    multi-input layer), 'merge' (concat on the feature axis), 'add' /
    'mul' / 'average' / 'max' / 'min' / 'subtract' (ElementWiseVertex
    ops), and the arg-taking kinds ('scale', 'shift', 'subset', 'stack',
    'unstack', 'l2norm', 'reshape', 'last_timestep',
    'duplicate_to_timeseries', 'reverse_timeseries'); ``args`` carries
    each kind's parameters.
    """

    kind: str
    inputs: List[str]
    layer: Any = None  # LayerConfig when kind == 'layer'
    args: Dict[str, Any] = field(default_factory=dict)


@register_config
@dataclass
class GraphConfig:
    """↔ ComputationGraphConfiguration: a named-vertex DAG with explicit
    network inputs and outputs."""

    net: NeuralNetConfiguration
    inputs: List[str]
    input_shapes: Dict[str, Sequence[int]]
    vertices: Dict[str, GraphVertex]  # name → vertex (insertion order kept)
    outputs: List[str]

    def to_json(self) -> str:
        return config_to_json(self)

    @staticmethod
    def from_json(s: str) -> "GraphConfig":
        cfg = config_from_json(s)
        if not isinstance(cfg, GraphConfig):
            raise TypeError(f"expected GraphConfig, got {type(cfg)}")
        return cfg
