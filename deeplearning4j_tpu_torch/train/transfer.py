"""Transfer learning (↔ deeplearning4j_tpu/train/transfer.py): graph surgery and fine-tune configuration.

ref: org.deeplearning4j.nn.transferlearning.{TransferLearning,
FineTuneConfiguration, TransferLearningHelper}: freeze a feature-extractor
prefix, remove or replace output layers, override training
hyperparameters, and carry pretrained weights into the surgered network.

As in the JAX package, params are a tree keyed by layer (vertex) name,
and freezing is the Trainer's gradient and update mask
(``Trainer(frozen_layers=...)``), not a FrozenLayer wrapper: a frozen
layer's forward still runs in training mode, so its BatchNorm running
statistics move while its params stay bit-equal. The builders return
``(model, variables, frozen names)``; carried leaves are the old
variables' tensors (numpy leaves become tensors) on the new model's
device, fresh ones come from the new model's ``init``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from deeplearning4j_tpu_torch.nn.config import (
    GraphConfig,
    NeuralNetConfiguration,
    SequentialConfig,
)
from deeplearning4j_tpu_torch.nn.model import (
    GraphModel,
    SequentialModel,
    _on_device,
)
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names, tree_map


def _replace_n_out(cfg, n_out: int, weight_init: Optional[str], what: str):
    """nOutReplace's attribute: ``units`` on dense and output layers,
    ``filters`` on conv layers."""
    if hasattr(cfg, "units"):
        kw = {"units": n_out}
    elif hasattr(cfg, "filters"):
        kw = {"filters": n_out}
    else:
        raise ValueError(
            f"{what} ({type(cfg).__name__}) has no output-width attribute "
            "(units/filters)")
    if weight_init is not None and hasattr(cfg, "weight_init"):
        kw["weight_init"] = weight_init
    return dataclasses.replace(cfg, **kw)


def _carry(tree, device):
    return tree_map(lambda a: torch.as_tensor(a, device=device), tree)


def _shapes_match(old, new) -> bool:
    """The same leaf names and shapes (the JAX package compares tree
    structure and leaf shapes)."""
    a, b = flatten_with_names(old), flatten_with_names(new)
    return [n for n, _ in a] == [n for n, _ in b] and all(
        tuple(x.shape) == tuple(y.shape) for (_, x), (_, y) in zip(a, b))


@dataclasses.dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides applied to the surgered net
    (↔ FineTuneConfiguration): only fields that are not None override the
    pretrained model's configuration."""

    updater: Any = None
    seed: Optional[int] = None
    weight_init: Optional[str] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    mixed_precision: Optional[bool] = None

    def apply(self, net: NeuralNetConfiguration) -> NeuralNetConfiguration:
        overrides = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }
        return dataclasses.replace(net, **overrides)


class TransferLearning:
    """Surgery on a trained ``SequentialModel`` (↔
    TransferLearning.Builder)::

        tl = (TransferLearning(model, variables)
              .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-4)))
              .set_feature_extractor("3_dense")     # freeze ≤ this layer
              .remove_last_layers(1)                # pop the old head
              .add_layer(OutputLayer(units=5)))
        new_model, new_vars, frozen = tl.build()
        trainer = Trainer(new_model, frozen_layers=frozen)

    Retained layers carry their weights; new and replaced layers
    initialize fresh.
    """

    def __init__(self, model: SequentialModel, variables: Dict[str, Any]):
        self._model = model
        self._variables = variables
        self._layers: List[Any] = list(model.layers)
        self._keep_names: List[Optional[str]] = list(model.layer_names)
        self._freeze_until: Optional[int] = None
        self._ftc: Optional[FineTuneConfiguration] = None

    def _index_of(self, layer: Union[int, str]) -> int:
        if isinstance(layer, int):
            return layer
        try:
            return self._keep_names.index(layer)
        except ValueError:
            raise ValueError(
                f"layer {layer!r} not found; have {self._keep_names}"
            ) from None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                ) -> "TransferLearning":
        self._ftc = ftc
        return self

    def set_feature_extractor(self, layer: Union[int, str]
                              ) -> "TransferLearning":
        """Freeze every layer up to and including ``layer``
        (↔ setFeatureExtractor)."""
        self._freeze_until = self._index_of(layer)
        return self

    def remove_last_layers(self, n: int = 1) -> "TransferLearning":
        """Pop ``n`` layers off the top (↔ removeOutputLayer /
        removeLayersFromOutput)."""
        if n > len(self._layers):
            raise ValueError(f"cannot remove {n} of {len(self._layers)} layers")
        del self._layers[len(self._layers) - n:]
        del self._keep_names[len(self._keep_names) - n:]
        return self

    def add_layer(self, layer_cfg) -> "TransferLearning":
        """Append a fresh layer (↔ addLayer)."""
        self._layers.append(layer_cfg)
        self._keep_names.append(None)
        return self

    def n_out_replace(self, layer: Union[int, str], n_out: int,
                      weight_init: Optional[str] = None) -> "TransferLearning":
        """Replace a layer's output width and re-initialize it
        (↔ nOutReplace)."""
        i = self._index_of(layer)
        self._layers[i] = _replace_n_out(
            self._layers[i], n_out, weight_init,
            f"layer {self._keep_names[i]!r}")
        self._keep_names[i] = None
        return self

    def build(self, seed: Optional[int] = None):
        """→ (model, variables, frozen layer names)."""
        if not self._layers:
            raise ValueError(
                "surgered network has no layers — remove_last_layers "
                "removed everything; add_layer a new head before build()")
        net = self._model.net
        if self._ftc is not None:
            net = self._ftc.apply(net)
        config = SequentialConfig(
            net=net, layers=list(self._layers),
            input_shape=self._model.config.input_shape,
        )
        new_model = SequentialModel(config, device=self._model.device)
        fresh = new_model.init(seed)

        old_params = self._variables.get("params", {})
        old_state = self._variables.get("state", {})
        params = dict(fresh["params"])
        state = dict(fresh["state"])
        dev = new_model.device
        for new_name, old_name in zip(new_model.layer_names, self._keep_names):
            if old_name is None:
                continue
            if old_name in old_params:
                params[new_name] = _carry(old_params[old_name], dev)
            if old_name in old_state:
                state[new_name] = _carry(old_state[old_name], dev)

        frozen: List[str] = []
        if self._freeze_until is not None:
            frozen = [
                name for i, name in enumerate(new_model.layer_names)
                if i <= self._freeze_until and name in fresh["params"]
            ]
        return new_model, {"params": params, "state": state}, frozen


class GraphTransferLearning:
    """Surgery on a trained ``GraphModel`` (↔
    TransferLearning.GraphBuilder)::

        gtl = (GraphTransferLearning(model, variables)
               .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-4)))
               .set_feature_extractor("pool5")    # freeze it and its ancestors
               .n_out_replace("fc1000", 5))
        new_model, new_vars, frozen = gtl.build()
        trainer = Trainer(new_model, frozen_layers=frozen)

    A vertex whose params no longer fit (downstream of an
    ``n_out_replace``) re-initializes and is not frozen.
    """

    def __init__(self, model: GraphModel, variables: Dict[str, Any]):
        self._model = model
        self._variables = variables
        self._vertices = dict(model.config.vertices)
        self._outputs = list(model.config.outputs)
        self._fresh: set = set()
        self._frontier: List[str] = []
        self._ftc: Optional[FineTuneConfiguration] = None

    def _require(self, name: str):
        if name not in self._vertices:
            raise ValueError(
                f"vertex {name!r} not found; have {list(self._vertices)}")

    def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                ) -> "GraphTransferLearning":
        self._ftc = ftc
        return self

    def set_feature_extractor(self, *vertex_names: str
                              ) -> "GraphTransferLearning":
        """Freeze the named vertices and all their ancestors
        (↔ GraphBuilder.setFeatureExtractor)."""
        for n in vertex_names:
            self._require(n)
        self._frontier = list(vertex_names)
        return self

    def n_out_replace(self, vertex: str, n_out: int,
                      weight_init: Optional[str] = None
                      ) -> "GraphTransferLearning":
        """Replace a layer vertex's output width with a fresh init
        (↔ GraphBuilder.nOutReplace)."""
        self._require(vertex)
        v = self._vertices[vertex]
        if v.kind != "layer":
            raise ValueError(f"vertex {vertex!r} is {v.kind!r}, not a layer")
        self._vertices[vertex] = dataclasses.replace(
            v, layer=_replace_n_out(v.layer, n_out, weight_init,
                                    f"vertex {vertex!r}"))
        self._fresh.add(vertex)
        return self

    def remove_vertex(self, name: str, *, and_descendants: bool = True
                      ) -> "GraphTransferLearning":
        """Drop a vertex and, by default, everything downstream of it
        (↔ GraphBuilder.removeVertexAndConnections). A removal that would
        leave a vertex with a missing input raises and leaves the builder
        as it was."""
        self._require(name)
        doomed = {name}
        if and_descendants:
            changed = True
            while changed:
                changed = False
                for n, v in self._vertices.items():
                    if n not in doomed and any(i in doomed for i in v.inputs):
                        doomed.add(n)
                        changed = True
        dangling = [n for n, v in self._vertices.items()
                    if n not in doomed and any(i in doomed for i in v.inputs)]
        if dangling:
            raise ValueError(
                f"removing {name!r} leaves {dangling} with missing inputs")
        for n in doomed:
            self._vertices.pop(n, None)
        self._outputs = [o for o in self._outputs if o not in doomed]
        return self

    def add_vertex(self, name: str, vertex) -> "GraphTransferLearning":
        """Append a fresh vertex (↔ GraphBuilder.addLayer/addVertex)."""
        if name in self._vertices:
            raise ValueError(f"vertex {name!r} already exists")
        for i in vertex.inputs:
            if i not in self._vertices and i not in self._model.config.inputs:
                raise ValueError(f"vertex {name!r} input {i!r} not found")
        self._vertices[name] = vertex
        self._fresh.add(name)
        return self

    def set_outputs(self, *names: str) -> "GraphTransferLearning":
        for n in names:
            self._require(n)
        self._outputs = list(names)
        return self

    def _ancestors(self, frontier: Sequence[str]) -> set:
        net_inputs = set(self._model.config.inputs)
        seen = set()
        stack = list(frontier)
        while stack:
            n = stack.pop()
            if n in seen or n in net_inputs:
                continue
            seen.add(n)
            v = self._vertices.get(n)
            if v is not None:
                stack.extend(i for i in v.inputs if i not in net_inputs)
        return seen

    def build(self, seed: Optional[int] = None):
        """→ (model, variables, sorted frozen vertex names)."""
        if not self._outputs:
            raise ValueError(
                "surgered graph has no outputs — after removing the old "
                "output vertex, add a new head and name it in set_outputs()")
        net = self._model.net
        if self._ftc is not None:
            net = self._ftc.apply(net)
        config = GraphConfig(
            net=net,
            inputs=list(self._model.config.inputs),
            input_shapes=dict(self._model.config.input_shapes),
            vertices=dict(self._vertices),
            outputs=list(self._outputs),
        )
        new_model = GraphModel(config, device=self._model.device)
        fresh = new_model.init(seed)

        old_params = self._variables.get("params", {})
        old_state = self._variables.get("state", {})
        params = dict(fresh["params"])
        state = dict(fresh["state"])
        refreshed = set(self._fresh)
        dev = new_model.device
        for name in new_model.order:
            if name in self._fresh:
                continue
            # a vertex downstream of an nOutReplace or a removal has a new
            # input width and re-initializes (DL4J's nOutReplace nIn rule)
            if name in old_params:
                if _shapes_match(old_params[name], params[name]):
                    params[name] = _carry(old_params[name], dev)
                else:
                    refreshed.add(name)
                    continue
            # state is carried only where the fresh model has state
            if name in old_state and name in state and _shapes_match(
                    old_state[name], state[name]):
                state[name] = _carry(old_state[name], dev)

        frozen: List[str] = []
        if self._frontier:
            frozen = [n for n in self._ancestors(self._frontier)
                      if n in fresh["params"] and n not in refreshed]
        return new_model, {"params": params, "state": state}, sorted(frozen)


class TransferLearningHelper:
    """Featurize once (↔ TransferLearningHelper): run the frozen prefix of
    a ``SequentialModel`` once per dataset and train only the tail on the
    cached features."""

    def __init__(self, model: SequentialModel, variables: Dict[str, Any],
                 frozen_until: Union[int, str]):
        if isinstance(frozen_until, str):
            frozen_until = model.layer_names.index(frozen_until)
        self._split = frozen_until + 1
        self._model = model
        self._variables = variables

    def featurize(self, x, **kw):
        """The activations at the freeze boundary, on the model's device,
        outside autograd."""
        with torch.no_grad():
            out, _ = self._model.apply(
                self._variables, _on_device(x, self._model.device),
                up_to=self._split, **kw)
        return out

    def unfrozen_graph(self):
        """(model, variables) of the trainable tail, which takes
        featurized inputs."""
        tail_layers = self._model.layers[self._split:]
        tail_names = self._model.layer_names[self._split:]
        config = SequentialConfig(
            net=self._model.net, layers=list(tail_layers),
            input_shape=self._model.shapes[self._split],
        )
        tail = SequentialModel(config, device=self._model.device)
        params, state = {}, {}
        for new_name, old_name in zip(tail.layer_names, tail_names):
            if old_name in self._variables.get("params", {}):
                params[new_name] = self._variables["params"][old_name]
            if old_name in self._variables.get("state", {}):
                state[new_name] = self._variables["state"][old_name]
        return tail, {"params": params, "state": state}
