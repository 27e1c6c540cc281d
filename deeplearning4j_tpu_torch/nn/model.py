"""Sequential model container (↔ deeplearning4j_tpu/nn/model.py: ``SequentialModel``).

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

Not ported yet: ``apply_tbptt``/``loss_fn_tbptt`` (truncated BPTT),
``summary``, and ``GraphModel``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.config import (
    LayerConfig,
    NeuralNetConfiguration,
    SequentialConfig,
    torch_dtype,
)
from deeplearning4j_tpu_torch.nn.weightnoise import (
    NON_WEIGHT_KEYS,
    apply_weight_noise,
)
from deeplearning4j_tpu_torch.runtime.device import resolve_device
from deeplearning4j_tpu_torch.utils.pytree import tree_leaves, tree_map


def _layer_name(i: int, cfg: LayerConfig) -> str:
    return f"{i}_{cfg.name or type(cfg).__name__.lower()}"


def _with_net_weight_init(layer: LayerConfig, net: NeuralNetConfiguration):
    """The net's weight_init is the default of layers that set none."""
    if net.weight_init and getattr(layer, "weight_init", "") is None:
        return dataclasses.replace(layer, weight_init=net.weight_init)
    return layer


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
            gen_seed = np.random.SeedSequence([seed & 0xFFFFFFFF, i])
            gen = torch.Generator().manual_seed(
                int(gen_seed.generate_state(1, np.uint64)[0]))
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
                        collect=None):
        """The layer loop of apply/feed_forward; ``collect``: optional list
        each layer's activation is appended to."""
        params = variables["params"]
        state = variables["state"]
        new_state = dict(state)
        n = len(self.layers) if up_to is None else up_to
        for name, layer in zip(self.layer_names[:n], self.layers[:n]):
            p = apply_weight_noise(layer, params.get(name, {}), generator,
                                   train)
            x, s = layer.apply(p, state.get(name, {}), x, train=train,
                               generator=generator)
            if s:
                new_state[name] = s
            if collect is not None:
                collect.append(x)
        return x, new_state

    def apply(self, variables, x, *, train: bool = False, generator=None,
              up_to: Optional[int] = None):
        """Forward pass → (activations, new_state); ``up_to`` stops before
        that layer index (↔ feedForward/feedForwardToLayer)."""
        return self._forward_layers(variables, x, train=train,
                                    generator=generator, up_to=up_to)

    def feed_forward(self, variables, x, *, train: bool = False,
                     generator=None):
        """([input, act_0, ..., act_{L-1}], new_state) (↔
        MultiLayerNetwork.feedForward); acts[i+1] is layer i's."""
        collect: list = []
        _, new_state = self._forward_layers(variables, x, train=train,
                                            generator=generator, up_to=None,
                                            collect=collect)
        return [x] + collect, new_state

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

    def _regularization(self, params):
        """l1/l2 penalties (per-layer value, else the net's) over the
        weights; biases, norm scales and peepholes are exempt."""
        total = None
        for name, layer in zip(self.layer_names, self.layers):
            l1 = layer.l1 if layer.l1 is not None else self.net.l1
            l2 = layer.l2 if layer.l2 is not None else self.net.l2
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
            return torch.zeros((), device=self.device)
        return total

    # -- eager conveniences ------------------------------------------------

    def output(self, variables, x):
        """Inference forward (↔ MultiLayerNetwork.output), under
        ``torch.inference_mode()``: no graph, no training workspace."""
        with torch.inference_mode():
            return self.apply(variables, x, train=False)[0]

    def score(self, variables, batch) -> float:
        """↔ MultiLayerNetwork.score(DataSet): the loss of a DataSet,
        (x, y) tuple or batch dict, moved to the model's device."""
        from deeplearning4j_tpu_torch.data.dataset import as_batch_dict
        from deeplearning4j_tpu_torch.train.trainer import batch_to_device

        batch = batch_to_device(as_batch_dict(batch), self.device)
        with torch.inference_mode():
            return float(self.loss_fn(variables["params"],
                                      variables["state"], batch)[0])

    def num_params(self, variables) -> int:
        return sum(p.numel() for p in tree_leaves(variables["params"]))
