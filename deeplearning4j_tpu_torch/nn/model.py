"""Model containers (↔ deeplearning4j_tpu/nn/model.py): ``SequentialModel`` and ``GraphModel``.

A model is a config plus pure functions of (variables, batch), as in the
JAX package: ``init`` builds the variables tree, ``apply``/``loss_fn`` run
the layer configs over it. Variables layout, with the JAX package's layer
names (``"0_graveslstm"``, ``"2_rnnoutputlayer"``) and param names, so
variables and checkpoints carry across unchanged::

    {"params": {"<layer_name>": {...}}, "state": {"<layer_name>": {...}}}

The model carries a ``device`` (default: the first CUDA card, see
``runtime.device.default_device``); ``init`` draws on the CPU from a
generator per layer and moves the tree there. Where the JAX package takes
an ``rng``, the port takes a ``torch.Generator`` on that device (weight
noise draws from it). ``loss_fn`` returns ``(loss, (state, metrics))``,
what ``train.trainer.Trainer`` differentiates.

``output`` moves its inputs to the model's device: a model on the card
never computes on the CPU because a caller handed it host arrays.

``SequentialModel.apply_tbptt``/``loss_fn_tbptt`` run one truncated-BPTT
window from the recurrent layers' carries and hand back the final ones
(``train.trainer.Trainer`` drives them under ``backprop_type="tbptt"``);
``GraphModel`` has neither, as in the JAX package.

``summary`` gives the JAX package's table, character for character, for
the same config and variables. Both models resolve every activation and
loss name of their layers when they are built (``_validate_registry_names``),
as the JAX package does, so a typo fails at build with the layer's name.
"""

from __future__ import annotations

import dataclasses
import functools
import graphlib
import operator
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.config import (
    GraphConfig,
    GraphVertex,
    LayerConfig,
    NeuralNetConfiguration,
    SequentialConfig,
    torch_dtype,
)
from deeplearning4j_tpu_torch.nn.weightnoise import (
    NON_WEIGHT_KEYS,
    apply_weight_noise,
)
from deeplearning4j_tpu_torch.ops.nn import safe_sq_norm
from deeplearning4j_tpu_torch.runtime.device import resolve_device
from deeplearning4j_tpu_torch.utils.pytree import tree_leaves, tree_map


def _layer_name(i: int, cfg: LayerConfig) -> str:
    return f"{i}_{cfg.name or type(cfg).__name__.lower()}"


def _validate_registry_names(named_layers):
    """Resolve every activation and loss name at model build: each
    dataclass field whose name ends in ``activation`` (``activation``,
    ``recurrent_activation``, ...), every ``loss``, and the layer a
    wrapper holds one level down (``Bidirectional``'s ``layer``). An
    unknown name raises ``ValueError`` prefixed with the layer's name."""
    from deeplearning4j_tpu_torch.nn.activations import get_activation
    from deeplearning4j_tpu_torch.ops.loss import get_loss

    def resolve(name, get, val):
        try:
            get(val)
        except ValueError as e:
            raise ValueError(f"layer '{name}': {e}") from None

    def check(name, layer):
        fields = ([f.name for f in dataclasses.fields(layer)]
                  if dataclasses.is_dataclass(layer) else
                  ["activation", "loss"])
        for fname in fields:
            val = getattr(layer, fname, None)
            if fname.endswith("activation") and isinstance(val, str):
                resolve(name, get_activation, val)
            elif fname == "loss" and isinstance(val, str):
                resolve(name, get_loss, val)
            elif fname == "layer" and dataclasses.is_dataclass(val):
                check(f"{name}.{type(val).__name__.lower()}", val)

    for name, layer in named_layers:
        check(name, layer)


def _with_net_weight_init(layer: LayerConfig, net: NeuralNetConfiguration):
    """The net's weight_init is the default of layers that set none."""
    if net.weight_init and getattr(layer, "weight_init", "") is None:
        return dataclasses.replace(layer, weight_init=net.weight_init)
    return layer


def _layer_generator(seed: int, i: int) -> torch.Generator:
    """The CPU generator layer (or vertex) ``i`` draws its init from — the
    role of the JAX package's ``fold_in(key(seed), i)``."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, i])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def _on_device(x, device):
    from deeplearning4j_tpu_torch.train.trainer import batch_to_device

    return batch_to_device(x, device)


def _regularization(named_layers, params, net, device):
    """l1/l2 penalties (per-layer value, else the net's) over the
    weights; biases, norm scales and peepholes are exempt."""
    total = None
    for name, layer in named_layers:
        l1 = layer.l1 if layer.l1 is not None else net.l1
        l2 = layer.l2 if layer.l2 is not None else net.l2
        if (not l1 and not l2) or name not in params:
            continue
        for k, p in params[name].items():
            if k in NON_WEIGHT_KEYS:
                continue
            term = 0.0
            if l2:
                term = term + l2 * torch.sum(torch.square(p))
            if l1:
                term = term + l1 * torch.sum(torch.abs(p))
            total = term if total is None else total + term
    if total is None:
        return torch.zeros((), device=device)
    return total


class SequentialModel:
    """↔ MultiLayerNetwork."""

    def __init__(self, config: SequentialConfig, device=None):
        self.config = config
        self.net: NeuralNetConfiguration = config.net
        self.device = resolve_device(device)
        self.layers: List[LayerConfig] = list(config.layers)
        self.layer_names = [_layer_name(i, l)
                            for i, l in enumerate(self.layers)]
        self.shapes = [tuple(config.input_shape)]
        for l in self.layers:
            self.shapes.append(tuple(l.output_shape(self.shapes[-1])))
        _validate_registry_names(self.named_layers())

    # -- construction ------------------------------------------------------

    def init(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """The variables tree on the model's device (↔
        MultiLayerNetwork.init()). Layer i draws from a CPU generator
        seeded from (seed, i), so a seed gives the same weights on every
        device; they are not the JAX package's numbers."""
        seed = self.net.seed if seed is None else seed
        dtype = torch_dtype(self.net.dtype)
        params, state = {}, {}
        for i, (name, layer) in enumerate(zip(self.layer_names,
                                              self.layers)):
            gen = _layer_generator(seed, i)
            ldtype = torch_dtype(layer.dtype) if layer.dtype else dtype
            p, s = _with_net_weight_init(layer, self.net).init(
                gen, self.shapes[i], ldtype)
            if p:
                params[name] = p
            if s:
                state[name] = s
        return tree_map(lambda a: a.to(self.device),
                        {"params": params, "state": state})

    def named_layers(self):
        """(name, layer_config) pairs."""
        return list(zip(self.layer_names, self.layers))

    # -- forward -----------------------------------------------------------

    def _forward_layers(self, variables, x, *, train, generator, up_to,
                        carries=None, tbptt=False, collect=None):
        """The layer loop of apply/apply_tbptt/feed_forward → (x,
        new_state, new_carries). Under ``tbptt`` the recurrent layers run
        ``apply_window`` from ``carries[name]`` (None: zeros) and report
        their final carry, and layers that need the whole sequence are
        refused. ``collect``: optional list each layer's activation is
        appended to."""
        params = variables["params"]
        state = variables["state"]
        new_state = dict(state)
        new_carries = {}
        carries = carries or {}
        n = len(self.layers) if up_to is None else up_to
        for name, layer in zip(self.layer_names[:n], self.layers[:n]):
            if tbptt:
                self._check_tbptt_compatible(layer)
            p = apply_weight_noise(layer, params.get(name, {}), generator,
                                   train)
            if tbptt and hasattr(layer, "apply_window"):
                x, s, carry = layer.apply_window(
                    p, state.get(name, {}), x, carries.get(name),
                    train=train, generator=generator)
                new_carries[name] = carry
            else:
                x, s = layer.apply(p, state.get(name, {}), x, train=train,
                                   generator=generator)
            if s:
                new_state[name] = s
            if collect is not None:
                collect.append(x)
        return x, new_state, new_carries

    @staticmethod
    def _check_tbptt_compatible(layer):
        """↔ the reference's TBPTT restrictions: a layer that reads the
        whole sequence (bidirectional, attention, absolute positions) or
        collapses the time axis (last step, global pooling,
        return_sequences=False) would compute another function window by
        window, so it raises."""
        from deeplearning4j_tpu_torch.nn.layers.attention import (
            CrossAttention,
            PositionalEmbedding,
            RecurrentAttention,
            SelfAttention,
            TransformerEncoderBlock,
        )
        from deeplearning4j_tpu_torch.nn.layers.recurrent import (
            Bidirectional,
            LastTimeStep,
        )

        kind = type(layer).__name__
        if isinstance(layer, Bidirectional):
            raise ValueError(
                "truncated BPTT cannot be used with Bidirectional layers "
                "(the backward direction needs the full sequence)")
        if isinstance(layer, (SelfAttention, CrossAttention,
                              RecurrentAttention, TransformerEncoderBlock)):
            raise ValueError(
                f"truncated BPTT cannot be used with {kind}: attention "
                "reads the full sequence, so per-window application would "
                "silently attend within each window only")
        if isinstance(layer, PositionalEmbedding):
            raise ValueError(
                "truncated BPTT cannot be used with PositionalEmbedding: "
                "absolute positions would restart at 0 in every window")
        if isinstance(layer, LastTimeStep) or kind in ("GlobalPooling",
                                                       "GlobalPooling1D"):
            raise ValueError(
                f"truncated BPTT cannot be used with {kind}: it collapses "
                "the time axis, so each window would train an intermediate "
                "state against the full-sequence target")
        if getattr(layer, "return_sequences", True) is False:
            raise ValueError(
                f"truncated BPTT requires return_sequences=True on {kind} "
                "(per-window last-step outputs are not the sequence output)")

    def apply(self, variables, x, *, train: bool = False, generator=None,
              up_to: Optional[int] = None):
        """Forward pass → (activations, new_state); ``up_to`` stops before
        that layer index (↔ feedForward/feedForwardToLayer)."""
        x, new_state, _ = self._forward_layers(
            variables, x, train=train, generator=generator, up_to=up_to)
        return x, new_state

    def feed_forward(self, variables, x, *, train: bool = False,
                     generator=None):
        """([input, act_0, ..., act_{L-1}], new_state) (↔
        MultiLayerNetwork.feedForward); acts[i+1] is layer i's."""
        collect: list = []
        _, new_state, _ = self._forward_layers(
            variables, x, train=train, generator=generator, up_to=None,
            collect=collect)
        return [x] + collect, new_state

    def apply_tbptt(self, variables, x, carries, *, train: bool = False,
                    generator=None, up_to: Optional[int] = None):
        """One TBPTT window with the recurrent state carried in and out (↔
        rnnActivateUsingStoredState under BackpropType.TruncatedBPTT): the
        recurrent layers start from ``carries[name]`` (None: zeros) →
        (activations, new_state, new_carries), an entry per recurrent
        layer. The caller truncates the gradient at the window's start by
        handing in carries outside the graph (``Trainer`` detaches them).
        """
        return self._forward_layers(variables, x, train=train,
                                    generator=generator, up_to=up_to,
                                    carries=carries, tbptt=True)

    def _output_loss(self, params, state, x, batch, generator):
        """The output layer (weight noise applied) and its compute_loss over
        labels / mask / weights."""
        out_layer = self.layers[-1]
        out_name = self.layer_names[-1]
        if not hasattr(out_layer, "compute_loss"):
            raise TypeError(f"last layer {type(out_layer).__name__} is not "
                            "an output layer")
        out_params = apply_weight_noise(out_layer, params.get(out_name, {}),
                                        generator, True)
        return out_layer.compute_loss(
            out_params, state.get(out_name, {}), x, batch["labels"],
            mask=batch.get("mask"), weights=batch.get("weights"))

    def loss_fn(self, params, state, batch, generator=None):
        """Scalar training loss (↔ computeGradientAndScore's score) of a
        batch dict ('features', 'labels', optional 'mask'/'weights') →
        (loss, (new_state, {"loss", "reg"}))."""
        variables = {"params": params, "state": state}
        x, new_state = self.apply(variables, batch["features"], train=True,
                                  generator=generator,
                                  up_to=len(self.layers) - 1)
        loss = self._output_loss(params, state, x, batch, generator)
        reg = self._regularization(params)
        return loss + reg, (new_state, {"loss": loss.detach(),
                                        "reg": reg.detach()})

    def loss_fn_tbptt(self, params, state, batch, carries, generator=None):
        """``loss_fn`` over one TBPTT window from ``carries`` → (loss,
        (new_state, {"loss", "reg"}, new_carries))."""
        variables = {"params": params, "state": state}
        x, new_state, new_carries = self.apply_tbptt(
            variables, batch["features"], carries, train=True,
            generator=generator, up_to=len(self.layers) - 1)
        loss = self._output_loss(params, state, x, batch, generator)
        reg = self._regularization(params)
        return loss + reg, (new_state, {"loss": loss.detach(),
                                        "reg": reg.detach()}, new_carries)

    def _regularization(self, params):
        return _regularization(self.named_layers(), params, self.net,
                               self.device)

    # -- eager conveniences ------------------------------------------------

    def output(self, variables, x):
        """Inference forward (↔ MultiLayerNetwork.output), under
        ``torch.inference_mode()``: no graph, no training workspace."""
        with torch.inference_mode():
            return self.apply(variables, _on_device(x, self.device),
                              train=False)[0]

    def score(self, variables, batch) -> float:
        """↔ MultiLayerNetwork.score(DataSet): the loss of a DataSet,
        (x, y) tuple or batch dict, moved to the model's device."""
        from deeplearning4j_tpu_torch.data.dataset import as_batch_dict

        batch = _on_device(as_batch_dict(batch), self.device)
        with torch.inference_mode():
            return float(self.loss_fn(variables["params"],
                                      variables["state"], batch)[0])

    def num_params(self, variables) -> int:
        return sum(p.numel() for p in tree_leaves(variables["params"]))

    def summary(self, variables=None) -> str:
        """↔ MultiLayerNetwork.summary(): index, layer class, output shape
        and param count per layer."""
        lines = [f"{'idx':<4}{'layer':<28}{'out shape':<20}{'params':<12}",
                 "=" * 64]
        total = 0
        for i, (name, layer) in enumerate(zip(self.layer_names,
                                              self.layers)):
            n = _param_count(variables, name)
            total += n
            lines.append(f"{i:<4}{type(layer).__name__:<28}"
                         f"{str(self.shapes[i + 1]):<20}{n:<12}")
        lines += ["=" * 64, f"total params: {total}"]
        return "\n".join(lines)


def _param_count(variables, name) -> int:
    if variables is None or name not in variables["params"]:
        return 0
    return sum(p.numel() for p in tree_leaves(variables["params"][name]))


# --- DAG model ---------------------------------------------------------

def _reduce(fn):
    return lambda xs: functools.reduce(fn, xs)


# element-wise vertices (↔ ElementWiseVertex) and 'merge' (↔ MergeVertex)
_MERGE_OPS = {
    "add": _reduce(operator.add),
    "subtract": lambda xs: xs[0] - xs[1],
    "mul": _reduce(operator.mul),
    "average": lambda xs: functools.reduce(operator.add, xs) / len(xs),
    "max": _reduce(torch.maximum),
    "min": _reduce(torch.minimum),
    "merge": lambda xs: torch.cat(xs, dim=-1),
}

def _masked_last_step(x, mask):
    """Each example's last unpadded step: x [N,T,C], mask [N,T]."""
    idx = torch.clamp(torch.sum((mask > 0).to(torch.int32), dim=1) - 1,
                      min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def _unstack(xs, a):
    x, n = xs[0], a["of"]
    if x.shape[0] % n:
        raise ValueError(f"unstack: a batch of {x.shape[0]} does not split "
                         f"into {n} equal parts")
    return torch.split(x, x.shape[0] // n)[a["from"]]


# Arg-taking vertices (↔ the JAX package's _VERTEX_OPS, reference
# *Vertex classes beyond the elementwise set): kind → (apply(xs, args),
# out_shape(in_shapes, args)); shapes are batchless, the batch axis is 0.
_VERTEX_OPS = {
    # ↔ SubsetVertex: feature range [from, to] inclusive on the last axis
    "subset": (
        lambda xs, a: xs[0][..., a["from"]:a["to"] + 1],
        lambda ss, a: (*ss[0][:-1], a["to"] + 1 - a["from"]),
    ),
    # ↔ StackVertex: concatenate along the batch axis
    "stack": (
        lambda xs, a: torch.cat(xs, dim=0),
        lambda ss, a: tuple(ss[0]),
    ),
    # ↔ UnstackVertex(from, stackSize): batch slice ``from`` of ``of``
    "unstack": (
        _unstack,
        lambda ss, a: tuple(ss[0]),
    ),
    # ↔ L2NormalizeVertex: unit norm over the last axis (safe norm)
    "l2norm": (
        lambda xs, a: xs[0] * torch.rsqrt(
            safe_sq_norm(xs[0], eps=a.get("eps", 1e-8))),
        lambda ss, a: tuple(ss[0]),
    ),
    # ↔ ScaleVertex (x * const)
    "scale": (
        lambda xs, a: xs[0] * a.get("factor", 1.0),
        lambda ss, a: tuple(ss[0]),
    ),
    # ↔ ShiftVertex (x + const)
    "shift": (
        lambda xs, a: xs[0] + a["shift"],
        lambda ss, a: tuple(ss[0]),
    ),
    # ↔ ReshapeVertex: batchless target shape
    "reshape": (
        lambda xs, a: xs[0].reshape(xs[0].shape[0], *a["shape"]),
        lambda ss, a: tuple(a["shape"]),
    ),
    # ↔ LastTimeStepVertex: [T, C] → [C]; a second input [N, T] is the
    # mask, and each example's last unpadded step is taken
    "last_timestep": (
        lambda xs, a: (xs[0][:, -1] if len(xs) == 1
                       else _masked_last_step(xs[0], xs[1])),
        lambda ss, a: tuple(ss[0][1:]),
    ),
    # ↔ DuplicateToTimeSeriesVertex: [C] repeated over the second input's
    # time axis → [T, C]
    "duplicate_to_timeseries": (
        lambda xs, a: xs[0][:, None, :].expand(
            xs[0].shape[0], xs[1].shape[1], xs[0].shape[-1]),
        lambda ss, a: (ss[1][0], ss[0][-1]),
    ),
    # ↔ ReverseTimeSeriesVertex: flip the time axis
    "reverse_timeseries": (
        lambda xs, a: torch.flip(xs[0], dims=(1,)),
        lambda ss, a: tuple(ss[0]),
    ),
}


class GraphModel:
    """↔ ComputationGraph: a named-vertex DAG of layer, merge,
    element-wise and arg-taking vertices (``_VERTEX_OPS``), visited in the
    JAX package's topological order (the same ``graphlib`` order, so
    vertex ``i`` seeds its init alike). A layer vertex with several inputs
    hands them all to a multi-input layer (``CrossAttention``) through its
    ``init_multi``/``apply_multi``/``output_shape_multi``.

    Variables are named by vertex (``{"params": {"stem_conv": {...}},
    "state": {"stem_bn": {...}}}``), as in the JAX package. ``apply``
    takes a dict of inputs by name (or one array for a single-input graph)
    and returns ``({output name: activation}, new_state)``.
    """

    def __init__(self, config: GraphConfig, device=None):
        self.config = config
        self.net: NeuralNetConfiguration = config.net
        self.device = resolve_device(device)
        ts = graphlib.TopologicalSorter(
            {name: set(v.inputs) - set(config.inputs)
             for name, v in config.vertices.items()})
        self.order = [n for n in ts.static_order() if n in config.vertices]
        self.shapes: Dict[str, Tuple[int, ...]] = {
            k: tuple(v) for k, v in config.input_shapes.items()}
        for name in self.order:
            v = config.vertices[name]
            self.shapes[name] = self._vertex_out_shape(
                name, v, [self.shapes[i] for i in v.inputs])
        _validate_registry_names(self.named_layers())

    @staticmethod
    def _is_multi(v: GraphVertex) -> bool:
        """True when a layer vertex hands all its inputs to its layer
        (the multi-input protocol). A layer declaring ``apply_multi`` must
        also declare ``init_multi`` and ``output_shape_multi``; a layer
        vertex with several inputs whose layer has no protocol is refused
        rather than dropping inputs 1..n."""
        if v.kind != "layer" or len(v.inputs) <= 1:
            return False
        if not hasattr(v.layer, "apply_multi"):
            raise ValueError(
                f"layer vertex with {len(v.inputs)} inputs requires a "
                f"multi-input layer (apply_multi), but "
                f"{type(v.layer).__name__} is single-input — merge the "
                "inputs with a 'merge'/elementwise vertex first")
        missing = [m for m in ("init_multi", "output_shape_multi")
                   if not hasattr(v.layer, m)]
        if missing:
            raise TypeError(
                f"{type(v.layer).__name__} declares apply_multi but lacks "
                f"{missing}: the multi-input protocol is all-or-nothing")
        return True

    def _vertex_out_shape(self, name: str, v: GraphVertex, in_shapes):
        if v.kind == "layer":
            if self._is_multi(v):
                return tuple(v.layer.output_shape_multi(in_shapes))
            return tuple(v.layer.output_shape(in_shapes[0]))
        if v.kind == "merge":
            feat = sum(s[-1] for s in in_shapes)
            return (*in_shapes[0][:-1], feat)
        if v.kind in _MERGE_OPS:
            return tuple(in_shapes[0])
        if v.kind in _VERTEX_OPS:
            return tuple(_VERTEX_OPS[v.kind][1](in_shapes, v.args))
        raise ValueError(f"unknown vertex kind {v.kind!r} ({name!r})")

    def named_layers(self):
        """(name, layer_config) pairs of the layer vertices."""
        return [(n, self.config.vertices[n].layer) for n in self.order
                if self.config.vertices[n].kind == "layer"]

    # -- construction ------------------------------------------------------

    def init(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """The variables tree on the model's device; vertex ``i`` of the
        topological order draws from a CPU generator seeded from (seed,
        i). The numbers are not the JAX package's."""
        seed = self.net.seed if seed is None else seed
        dtype = torch_dtype(self.net.dtype)
        params, state = {}, {}
        for i, name in enumerate(self.order):
            v = self.config.vertices[name]
            if v.kind != "layer":
                continue
            layer = _with_net_weight_init(v.layer, self.net)
            gen = _layer_generator(seed, i)
            if self._is_multi(v):
                p, s = layer.init_multi(
                    gen, [self.shapes[inp] for inp in v.inputs], dtype)
            else:
                p, s = layer.init(gen, self.shapes[v.inputs[0]], dtype)
            if p:
                params[name] = p
            if s:
                state[name] = s
        return tree_map(lambda a: a.to(self.device),
                        {"params": params, "state": state})

    # -- forward -----------------------------------------------------------

    def _forward_values(self, variables, inputs, *, train, generator,
                        exclude):
        if not isinstance(inputs, dict):
            inputs = {self.config.inputs[0]: inputs}
        params, state = variables["params"], variables["state"]
        values = dict(inputs)
        new_state = dict(state)
        for name in self.order:
            if name in exclude:
                continue
            v = self.config.vertices[name]
            xs = [values[inp] for inp in v.inputs]
            if v.kind == "layer":
                p = apply_weight_noise(v.layer, params.get(name, {}),
                                       generator, train)
                if self._is_multi(v):
                    y, s = v.layer.apply_multi(p, state.get(name, {}), xs,
                                               train=train,
                                               generator=generator)
                else:
                    y, s = v.layer.apply(p, state.get(name, {}), xs[0],
                                         train=train, generator=generator)
                if s:
                    new_state[name] = s
            elif v.kind in _MERGE_OPS:
                y = _MERGE_OPS[v.kind](xs)
            else:
                y = _VERTEX_OPS[v.kind][0](xs, v.args)
            values[name] = y
        return values, new_state

    def apply(self, variables, inputs, *, train: bool = False,
              generator=None):
        """Forward pass → ({output name: activation}, new_state)."""
        values, new_state = self._forward_values(
            variables, inputs, train=train, generator=generator,
            exclude=set())
        return ({o: values[o] for o in self.config.outputs if o in values},
                new_state)

    def feed_forward(self, variables, inputs, *, train: bool = False,
                     generator=None):
        """Every vertex's activation (↔ ComputationGraph.feedForward):
        ({input name: x, vertex name: activation}, new_state)."""
        return self._forward_values(variables, inputs, train=train,
                                    generator=generator, exclude=set())

    def loss_fn(self, params, state, batch, generator=None):
        """Sum of the output layers' losses (↔ ComputationGraph's score)
        → (loss, (new_state, metrics)). ``batch["labels"]`` is one array
        for a single output, else a dict by output name."""
        variables = {"params": params, "state": state}
        out_names = list(self.config.outputs)
        values, new_state = self._forward_values(
            variables, batch["features"], train=True, generator=generator,
            exclude=set(out_names))
        labels = batch["labels"]
        if not isinstance(labels, dict):
            labels = {out_names[0]: labels}
        total = None
        metrics = {}
        for name in out_names:
            v = self.config.vertices[name]
            if not hasattr(v.layer, "compute_loss"):
                raise TypeError(
                    f"output vertex {name!r} ({type(v.layer).__name__}) is "
                    "not an output layer — inference-only heads (e.g. an "
                    "embedding bottleneck) cannot be trained directly; add "
                    "a loss head for training")
            out_params = apply_weight_noise(v.layer, params.get(name, {}),
                                            generator, True)
            loss = v.layer.compute_loss(
                out_params, state.get(name, {}), values[v.inputs[0]],
                labels[name], mask=batch.get("mask"),
                weights=batch.get("weights"))
            total = loss if total is None else total + loss
            metrics[f"loss/{name}"] = loss.detach()
        metrics["loss"] = total.detach()
        return total + self._regularization(params), (new_state, metrics)

    def _regularization(self, params):
        return _regularization(self.named_layers(), params, self.net,
                               self.device)

    # -- eager conveniences ------------------------------------------------

    def output(self, variables, inputs):
        """Inference forward → {output name: activation}, under
        ``torch.inference_mode()``, the inputs moved to the model's
        device."""
        with torch.inference_mode():
            return self.apply(variables, _on_device(inputs, self.device),
                              train=False)[0]

    def output_single(self, variables, inputs):
        """↔ ComputationGraph.outputSingle: the one output of a
        single-output graph."""
        if len(self.config.outputs) != 1:
            raise ValueError(
                f"output_single on a graph with outputs "
                f"{self.config.outputs}; use output() for multi-output")
        return self.output(variables, inputs)[self.config.outputs[0]]

    def num_params(self, variables) -> int:
        return sum(p.numel() for p in tree_leaves(variables["params"]))

    def summary(self, variables=None) -> str:
        """↔ ComputationGraph.summary(): the inputs, then every vertex in
        topological order: kind, inputs, output shape, param count."""
        lines = [f"{'vertex':<20}{'kind':<18}{'inputs':<24}"
                 f"{'out shape':<16}{'params':<10}", "=" * 88]
        for name in self.config.inputs:
            lines.append(f"{name:<20}{'input':<18}{'-':<24}"
                         f"{str(self.shapes[name]):<16}{0:<10}")
        total = 0
        for name in self.order:
            v = self.config.vertices[name]
            kind = type(v.layer).__name__ if v.kind == "layer" else v.kind
            n = _param_count(variables, name)
            total += n
            lines.append(f"{name:<20}{kind:<18}{','.join(v.inputs):<24}"
                         f"{str(self.shapes[name]):<16}{n:<10}")
        lines += ["=" * 88, f"total params: {total}   outputs: "
                            f"{', '.join(self.config.outputs)}"]
        return "\n".join(lines)
