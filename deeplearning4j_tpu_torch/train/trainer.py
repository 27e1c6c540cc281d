"""Training driver (↔ deeplearning4j_tpu/train/trainer.py).

The JAX package compiles one program per step; the port runs the same step
eagerly: forward and backward through the model's ``loss_fn`` (the flash
kernels on the card), then the JAX package's gradient handling in the same
order — freeze mask, gradient normalization, updater, freeze mask again —
over trees of tensors named as the JAX package names them.

``TrainState`` holds params, model_state, opt_state, step and rng, as in
the JAX package. Its ``rng`` is an :class:`RngKey`, a seed from which a
``torch.Generator`` on the model's device is derived for every step (and
every microbatch under ``grad_accum``); a checkpoint stores it as the key
data ``jax.random.key(seed, impl=net.rng_impl)`` holds (threefry2x32 or
rbg), so either package restores the other's checkpoints. The two packages draw different dropout
masks from one seed.

Not ported (ROADMAP): meshes and sharding, ``check_nan``,
``make_chained_step``, truncated BPTT and weight constraints (the Trainer
raises on a config that sets either), ``step_flops``, and the telemetry, incident, fault-injection, heartbeat, compile-cache and
auto-prefetch hooks of ``fit``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import as_batch_dict
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.ops import math as opsmath
from deeplearning4j_tpu_torch.train.updaters import (
    apply_updates,
    resolve_updater,
)
from deeplearning4j_tpu_torch.utils.pytree import (
    flatten_with_names,
    register_dataclass,
    tree_leaves,
    tree_map,
    tree_map_with_names,
)

_U32 = 0xFFFFFFFF
THREEFRY = "threefry2x32"
RBG = "rbg"
# uint32 words of key data per impl: threefry's (hi, lo) of the seed; rbg's
# the same pair twice (jax.random.key(7, impl="rbg") holds [0, 7, 0, 7])
_KEY_WORDS = {THREEFRY: 2, RBG: 4}


@dataclasses.dataclass(frozen=True)
class RngKey:
    """The training rng: a seed, normalised to 32 bits as the JAX package's
    ``jax.random.key(seed, impl=...)`` keeps it (without 64-bit mode a key
    holds ``[0, seed mod 2**32]``), and the key impl a checkpoint records
    (``net.rng_impl``: threefry2x32 by default, or rbg). The impl changes
    only the key data written; dropout draws from the seed either way."""

    seed: int
    impl: str = THREEFRY

    def __post_init__(self):
        object.__setattr__(self, "seed", int(self.seed) & _U32)
        if self.impl not in _KEY_WORDS:
            raise ValueError(f"the port keys rngs as {sorted(_KEY_WORDS)}, "
                             f"not {self.impl!r}")

    def generator(self, device, *counters: int) -> torch.Generator:
        """A generator on ``device`` seeded from (seed, *counters) — the
        role of the JAX package's ``fold_in(rng, step)``."""
        state = np.random.SeedSequence([self.seed, *counters])
        seed = int(state.generate_state(1, np.uint64)[0])
        return torch.Generator(device=torch.device(device)).manual_seed(seed)

    def key_data(self) -> np.ndarray:
        """The uint32 key data of ``jax.random.key(seed, impl=impl)``."""
        pair = [self.seed >> 32, self.seed & _U32]
        return np.array(pair * (_KEY_WORDS[self.impl] // 2), np.uint32)

    @classmethod
    def from_key_data(cls, data, impl: Optional[str]) -> "RngKey":
        impl = THREEFRY if impl is None else impl
        if impl not in _KEY_WORDS:
            raise ValueError(f"the port restores {sorted(_KEY_WORDS)} keys "
                             f"only, not {impl!r}")
        data = np.asarray(data, np.uint32).reshape(-1)
        words = _KEY_WORDS[impl]
        if data.shape != (words,):
            raise ValueError(f"{impl} key data must be uint32[{words}], got "
                             f"{data.shape}")
        if impl == RBG and not np.array_equal(data[:2], data[2:]):
            raise ValueError(f"rbg key data {data.tolist()} is not a seed's "
                             "(its two halves differ)")
        return cls((int(data[0]) << 32) | int(data[1]), impl)


@register_dataclass
@dataclasses.dataclass
class TrainState:
    """Complete training state: the JAX package's fields and leaf names
    (``params/...``, ``model_state/...``, ``opt_state/...``, ``step``,
    ``rng``). ``step`` is a Python int."""

    params: Any
    model_state: Any
    opt_state: Any
    step: int
    rng: RngKey


def _normalize_gradients(grads, net: NeuralNetConfiguration):
    """↔ GradientNormalization enum handling in BaseLayer.update."""
    mode = net.gradient_normalization
    thr = net.gradient_normalization_threshold
    if mode is None:
        return grads
    if mode == "clip_value":
        return tree_map(lambda g: torch.clamp(g, -thr, thr), grads)
    if mode == "clip_l2_global":
        clipped, _ = opsmath.clip_by_global_norm(grads, thr)
        return clipped
    if mode == "clip_l2_per_param":
        return tree_map(lambda g: opsmath.clip_by_norm(g, thr), grads)
    if mode == "renormalize_l2_per_layer":
        return tree_map(lambda g: g / torch.clamp(
            torch.sqrt(torch.sum(torch.square(g))), min=1e-12), grads)
    raise ValueError(f"unknown gradient normalization {mode}")


def _as_tensor(a) -> torch.Tensor:
    """A tensor as it is; anything else (numpy, also read-only) copied."""
    return a if torch.is_tensor(a) else torch.tensor(np.asarray(a))


def batch_to_device(batch, device):
    """A batch tree of numpy arrays (or tensors) → tensors on ``device``,
    dtypes kept."""
    return tree_map(lambda a: _as_tensor(a).to(device), batch)


def _to_bf16(tree):
    return tree_map(lambda a: a.to(torch.bfloat16)
                    if torch.is_tensor(a) and a.dtype == torch.float32
                    else a, tree)


def _first_dim(batch) -> int:
    return tree_leaves(batch["features"])[0].shape[0]


def _refuse_unported(model) -> None:
    """Raise on settings the JAX package's Trainer honours and the port
    does not run yet (ROADMAP queue 1 items 2 and 7), so that a config
    loaded from the JAX package's JSON never trains a different function
    without a word."""
    bt = getattr(model.net, "backprop_type", "standard")
    if bt != "standard":
        raise NotImplementedError(
            f"backprop_type={bt!r}: the port trains with standard backprop "
            "only; truncated BPTT (Trainer.make_tbptt_step) is not ported "
            "yet (ROADMAP queue 1 item 7)")
    named = model.named_layers() if hasattr(model, "named_layers") else []
    constrained = [n for n, l in named if getattr(l, "constraints", None)]
    if constrained:
        raise NotImplementedError(
            f"layers {constrained} set weight constraints, which the port's "
            "Trainer does not apply yet (nn/constraints.py, ROADMAP queue 1 "
            "item 4)")


class Trainer:
    """Runs the train step of a model on the model's device.

    model: anything with ``.net``, ``.device``, ``.init(seed)`` and
    ``.loss_fn(params, state, batch, generator) -> (loss, (state, metrics))``
    (``models.bert.Bert``, ``nn.model.SequentialModel``,
    ``nn.model.GraphModel``).

    ``frozen_layers``: top-level param-tree keys excluded from training.
    Their gradients are zeroed before the updater (moments stay zero) and
    their updates after it (decoupled weight decay cannot move them).

    ``grad_accum``: the batch's leading dim splits into that many
    microbatches, run one after another; the update sees their gradient
    mean, weighted by ``model.loss_weight(microbatch)`` where the model
    has one. A batch that does not split evenly runs unsplit.

    ``net.mixed_precision``: bf16 compute with float32 master params and
    updater state. The cast sits inside the differentiated function, so
    gradients come back float32. Only params and features are cast: layer
    state (BatchNorm's running statistics) stays float32, and BatchNorm
    computes its batch statistics in float32 from the bf16 activation.
    The state a step returns is detached from the graph.
    """

    def __init__(
        self,
        model,
        *,
        extra_metrics: Optional[Callable] = None,
        frozen_layers: Optional[Sequence[str]] = None,
        grad_accum: int = 1,
        grad_metrics: bool = False,
    ):
        self.model = model
        self.net: NeuralNetConfiguration = model.net
        _refuse_unported(model)
        self.device = model.device
        self.frozen_layers = frozenset(frozen_layers or ())
        self._upd_init, self._upd_update = resolve_updater(
            self.net.updater).make()
        self._extra_metrics = extra_metrics
        self._mixed = bool(getattr(self.net, "mixed_precision", False))
        if not isinstance(grad_accum, int) or grad_accum < 1:
            raise ValueError(
                f"grad_accum must be an int >= 1, got {grad_accum!r}")
        self.grad_accum = grad_accum
        self.grad_metrics = bool(grad_metrics)

    # -- one step -----------------------------------------------------------

    def _cast_batch(self, batch):
        if self._mixed:
            return dict(batch, features=_to_bf16(batch["features"]))
        return batch

    def _grad_of(self, params, model_state, batch, generator):
        """Loss and gradients of every param leaf (float32 leaves; the
        mixed-precision cast is inside the differentiated function)."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        compute = _to_bf16(leaves) if self._mixed else leaves
        loss, (new_state, metrics) = self.model.loss_fn(
            compute, model_state, batch, generator=generator)
        named = flatten_with_names(leaves)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        by_name = {n: torch.zeros_like(p) if g is None else g
                   for (n, p), g in zip(named, grads)}
        # layer state (BatchNorm's running statistics) leaves the graph
        new_state = tree_map(torch.Tensor.detach, new_state)
        return (loss.detach(), new_state, metrics,
                tree_map_with_names(lambda n, _: by_name[n], leaves))

    def train_step(self, ts: TrainState, batch):
        """One update from ``batch`` → (new TrainState, metrics)."""
        batch = self._cast_batch(batch_to_device(as_batch_dict(batch),
                                                 self.device))
        k = self.grad_accum
        n0 = _first_dim(batch)
        if k == 1 or n0 % k:
            gen = ts.rng.generator(self.device, ts.step)
            loss, new_state, metrics, grads = self._grad_of(
                ts.params, ts.model_state, batch, gen)
            return self._finish_step(ts, grads, new_state, metrics, loss,
                                     batch)
        weight_of = getattr(self.model, "loss_weight", None)
        size = n0 // k
        model_state = ts.model_state
        gsum = msum = loss_sum = None
        wsum = 0.0
        for i in range(k):
            mb = tree_map(lambda a: a[i * size:(i + 1) * size], batch)
            gen = ts.rng.generator(self.device, ts.step, i)
            loss, model_state, metrics, grads = self._grad_of(
                ts.params, model_state, mb, gen)
            w = float(weight_of(mb)) if weight_of is not None else 1.0
            if gsum is None:
                gsum = tree_map(lambda g: w * g, grads)
                msum = {n: w * m for n, m in metrics.items()}
                loss_sum = w * loss
            else:
                gsum = tree_map(lambda s, g: s + w * g, gsum, grads)
                msum = {n: msum[n] + w * m for n, m in metrics.items()}
                loss_sum = loss_sum + w * loss
            wsum += w
        denom = max(wsum, 1e-12)
        return self._finish_step(
            ts, tree_map(lambda g: g / denom, gsum), model_state,
            {n: m / denom for n, m in msum.items()}, loss_sum / denom, batch)

    @torch.no_grad()
    def _finish_step(self, ts: TrainState, grads, new_model_state, metrics,
                     loss, batch):
        """Freeze-mask, normalize, updater, metric assembly, new state —
        the JAX package's ``_finish_step``."""
        raw_grad_norms = {}
        if self.grad_metrics:
            # raw per-layer norms, before freeze-masking and clipping
            for lname, g in grads.items():
                sq = sum(torch.sum(torch.square(leaf))
                         for leaf in tree_leaves(g))
                raw_grad_norms[f"grad_norm/{lname}"] = torch.sqrt(sq)
        grads = self._mask_frozen(grads)
        grads = _normalize_gradients(grads, self.net)
        updates, new_opt = self._upd_update(grads, ts.opt_state, ts.params,
                                            ts.step)
        updates = self._mask_frozen(updates)
        new_params = apply_updates(ts.params, updates)
        metrics = dict(metrics)
        metrics["total_loss"] = loss
        metrics["batch_size"] = _first_dim(batch)
        metrics.update(raw_grad_norms)
        if self._extra_metrics is not None:
            metrics.update(self._extra_metrics(new_params, batch))
        new_ts = TrainState(params=new_params, model_state=new_model_state,
                            opt_state=new_opt, step=ts.step + 1, rng=ts.rng)
        return new_ts, metrics

    def _mask_frozen(self, tree):
        if not self.frozen_layers:
            return tree
        return {k: (tree_map(torch.zeros_like, v)
                    if k in self.frozen_layers else v)
                for k, v in tree.items()}

    # -- state construction -------------------------------------------------

    def init_state(self, variables=None,
                   seed: Optional[int] = None) -> TrainState:
        """A fresh TrainState from ``variables`` (tensors or numpy arrays,
        JAX names; default: ``model.init(seed)``), copied onto the model's
        device; the model's own parameters are not trained in place."""
        if variables is None:
            variables = self.model.init(seed)
        seed = self.net.seed if seed is None else seed

        def own(a):
            return _as_tensor(a).detach().to(self.device, copy=True)

        params = tree_map(own, variables["params"])
        return TrainState(params=params,
                          model_state=tree_map(own,
                                               variables.get("state", {})),
                          opt_state=self._upd_init(params), step=0,
                          rng=RngKey(seed, self.net.rng_impl or THREEFRY))

    def variables(self, ts: TrainState):
        return {"params": ts.params, "state": ts.model_state}

    # -- fit loop (↔ MultiLayerNetwork.fit(DataSetIterator)) ----------------

    def fit(self, ts: TrainState, data: Iterable, *, epochs: int = 1,
            listeners: Optional[List] = None,
            steps_per_epoch: Optional[int] = None) -> TrainState:
        listeners = listeners or []
        for lst in listeners:
            lst.on_fit_start(self, ts)
        stop = False
        host_step = ts.step
        # on_fit_end runs even when a step raises: listeners hold resources
        try:
            for epoch in range(epochs):
                for lst in listeners:
                    lst.on_epoch_start(epoch)
                n = 0
                for batch in data:
                    ts, metrics = self.train_step(ts, batch)
                    n += 1
                    host_step += 1
                    for lst in listeners:
                        if lst.on_iteration(epoch, host_step, ts, metrics):
                            stop = True
                    if steps_per_epoch is not None and n >= steps_per_epoch:
                        break
                    if stop:
                        break
                for lst in listeners:
                    if lst.on_epoch_end(epoch, ts):
                        stop = True
                if hasattr(data, "reset"):
                    data.reset()
                if stop:
                    break
        finally:
            for lst in listeners:
                lst.on_fit_end(self, ts)
        return ts
