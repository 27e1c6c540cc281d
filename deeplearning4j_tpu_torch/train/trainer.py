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

Truncated BPTT (``net.backprop_type="tbptt"``, ``net.tbptt_length``): a
batch of long sequences [N, T, ...] is cut along time into windows of
``tbptt_length`` steps and a shorter tail; each window is one update, run
by ``loss_fn_tbptt`` from the recurrent carries the window before it left
(detached there: the gradient stops at the window's start) and counted as
one iteration by ``fit``. Layer weight constraints (``nn/constraints.py``)
are projected after every update, that of each window included.

Not ported (ROADMAP queue 1 item 2): meshes and sharding, ``check_nan``,
``make_chained_step``, ``step_flops``, and the telemetry, incident,
fault-injection, heartbeat, compile-cache and auto-prefetch hooks of
``fit``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import as_batch_dict
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.constraints import constrain_params
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


def _shape(v):
    """A tensor's shape as the tuple the JAX package prints; None for a
    value without one."""
    shape = getattr(v, "shape", None)
    return None if shape is None else tuple(shape)


def _is_time_distributed(key: str, v, t: int) -> bool:
    """Which batch entries a TBPTT batch splits along time: features and
    labels of rank >= 3 [N, T, ...], mask and weights of rank 2 [N, T].
    Labels [N, C] with C == T are not split (full-sequence targets are
    refused by ``_fit_tbptt_batch`` instead)."""
    if key in ("features", "labels"):
        return hasattr(v, "ndim") and v.ndim >= 3 and v.shape[1] == t
    if key in ("mask", "weights"):
        return hasattr(v, "ndim") and v.ndim == 2 and v.shape[1] == t
    return False


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
        bt = getattr(self.net, "backprop_type", "standard")
        if bt not in ("standard", "tbptt"):
            raise ValueError(
                f"unknown backprop_type {bt!r}: expected 'standard' or "
                "'tbptt' (↔ BackpropType.{Standard,TruncatedBPTT})")
        self.device = model.device
        self.frozen_layers = frozenset(frozen_layers or ())
        self._upd_init, self._upd_update = resolve_updater(
            self.net.updater).make()
        self._extra_metrics = extra_metrics
        self._mixed = bool(getattr(self.net, "mixed_precision", False))
        if not isinstance(grad_accum, int) or grad_accum < 1:
            raise ValueError(
                f"grad_accum must be an int >= 1, got {grad_accum!r}")
        if grad_accum > 1 and bt == "tbptt":
            raise ValueError(
                "grad_accum is not supported with backprop_type='tbptt' "
                "(windows already bound the per-update memory; accumulate "
                "by widening tbptt_length instead)")
        self.grad_accum = grad_accum
        # the layers whose weights are projected after every update
        named = (model.named_layers() if hasattr(model, "named_layers")
                 else [])
        self._constrained_layers = [(n, l) for n, l in named
                                    if getattr(l, "constraints", None)]
        self.grad_metrics = bool(grad_metrics)

    # -- one step -----------------------------------------------------------

    def _cast_batch(self, batch):
        if self._mixed:
            return dict(batch, features=_to_bf16(batch["features"]))
        return batch

    def _leaves(self, params):
        """(float32 leaves that require grad, the tree the model computes
        with): the mixed-precision cast sits inside the differentiated
        function, so gradients come back float32."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        return leaves, (_to_bf16(leaves) if self._mixed else leaves)

    @staticmethod
    def _grads(loss, leaves):
        """d loss / d every leaf, a tree like ``leaves`` (zeros where the
        loss does not reach)."""
        named = flatten_with_names(leaves)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        by_name = {n: torch.zeros_like(p) if g is None else g
                   for (n, p), g in zip(named, grads)}
        return tree_map_with_names(lambda n, _: by_name[n], leaves)

    def _grad_of(self, params, model_state, batch, generator):
        """Loss and gradients of every param leaf (float32 leaves; the
        mixed-precision cast is inside the differentiated function)."""
        leaves, compute = self._leaves(params)
        loss, (new_state, metrics) = self.model.loss_fn(
            compute, model_state, batch, generator=generator)
        grads = self._grads(loss, leaves)
        # layer state (BatchNorm's running statistics) leaves the graph
        new_state = tree_map(torch.Tensor.detach, new_state)
        return loss.detach(), new_state, metrics, grads

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
        if self._constrained_layers:
            new_params = constrain_params(self._constrained_layers,
                                          new_params)
        metrics = dict(metrics)
        metrics["total_loss"] = loss
        metrics["batch_size"] = _first_dim(batch)
        metrics.update(raw_grad_norms)
        if self._extra_metrics is not None:
            metrics.update(self._extra_metrics(new_params, batch))
        new_ts = TrainState(params=new_params, model_state=new_model_state,
                            opt_state=new_opt, step=ts.step + 1, rng=ts.rng)
        return new_ts, metrics

    # -- truncated BPTT (↔ BackpropType.TruncatedBPTT) ------------------------

    def _tbptt_window_step(self, ts: TrainState, batch, carries):
        """One TBPTT window → (new TrainState, the final carries,
        metrics): the loss over the window from ``carries``, detached so
        that the gradient stops at the window's start, and one update.
        Dropout draws from (rng, step), as a standard step's."""
        gen = ts.rng.generator(self.device, ts.step)
        batch = self._cast_batch(batch)
        carries = tree_map(torch.Tensor.detach, carries)
        leaves, compute = self._leaves(ts.params)
        loss, (new_state, metrics, new_carries) = self.model.loss_fn_tbptt(
            compute, ts.model_state, batch, carries, generator=gen)
        grads = self._grads(loss, leaves)
        new_state = tree_map(torch.Tensor.detach, new_state)
        new_carries = tree_map(torch.Tensor.detach, new_carries)
        new_ts, metrics = self._finish_step(ts, grads, new_state, metrics,
                                            loss.detach(), batch)
        return new_ts, new_carries, metrics

    def _zero_carries(self, ts: TrainState, x_window):
        """Zero carries of every recurrent layer for a window of
        ``x_window``'s batch, in the dtype the window computes in (bf16
        under mixed precision, as the JAX package derives them from the
        bf16 forward)."""
        n = tree_leaves(x_window)[0].shape[0]
        params = _to_bf16(ts.params) if self._mixed else ts.params
        out = {}
        for name, layer in self.model.named_layers():
            if hasattr(layer, "apply_window"):
                p = params.get(name, {})
                out[name] = layer.init_carry(p, n, p["RW"].dtype)
        return out

    def make_tbptt_step(self, n_windows: int, window_len: int):
        """``prog(ts, batch) -> (ts, per-window metrics, carries)``: the
        ``n_windows`` windows of ``window_len`` steps of a batch whose time
        axes are exactly ``n_windows * window_len`` long, one update each,
        from zero carries. The metrics are a list of the step's metric
        dicts, one per window (the JAX package stacks them into arrays of
        one compiled scan; here the windows run one after another). The
        carries let a caller run a shorter tail through
        ``train_step_tbptt``."""
        span = n_windows * window_len

        def program(ts: TrainState, batch):
            batch = batch_to_device(as_batch_dict(batch), self.device)
            t_len = tree_leaves(batch["features"])[0].shape[1]
            if t_len != span:
                raise ValueError(
                    f"make_tbptt_step({n_windows}, {window_len}) takes "
                    f"sequences of {span} steps, got {t_len}")
            timed = {k for k, v in batch.items()
                     if _is_time_distributed(k, v, span)}
            carries, metrics = None, []
            for w in range(n_windows):
                lo, hi = w * window_len, (w + 1) * window_len
                wb = {k: v[:, lo:hi] if k in timed else v
                      for k, v in batch.items()}
                if carries is None:
                    carries = self._zero_carries(ts, wb["features"])
                ts, carries, m = self._tbptt_window_step(ts, wb, carries)
                metrics.append(m)
            return ts, metrics, carries

        return program

    def train_step_tbptt(self, ts: TrainState, batch, carries):
        """One TBPTT window from ``carries`` → (ts, final carries,
        metrics): the tail window of a batch, and the building block a
        caller can drive directly."""
        batch = batch_to_device(as_batch_dict(batch), self.device)
        return self._tbptt_window_step(ts, batch, carries)

    def _fit_tbptt_batch(self, ts: TrainState, batch):
        """One batch of long sequences by truncated BPTT: the full windows
        (``make_tbptt_step``), then any shorter tail from the carries they
        leave (the reference trains the tail window too) → (ts, [metrics
        of each window])."""
        if not hasattr(self.model, "loss_fn_tbptt"):
            raise ValueError(
                "backprop_type='tbptt' requires a model with TBPTT support "
                f"(SequentialModel); {type(self.model).__name__} has none")
        length = int(self.net.tbptt_length)
        if length <= 0:
            raise ValueError("backprop_type='tbptt' requires tbptt_length>0")
        batch = batch_to_device(as_batch_dict(batch), self.device)
        feats = batch["features"]
        if not (hasattr(feats, "ndim") and feats.ndim >= 3):
            raise ValueError(
                "TBPTT needs sequence features [N, T, ...]; got shape "
                f"{_shape(feats)}")
        t_total = feats.shape[1]
        labels = batch.get("labels")
        if labels is not None and not _is_time_distributed(
                "labels", labels, t_total):
            raise ValueError(
                "TBPTT requires per-timestep labels [N, T, ...] matching the "
                f"feature time axis (T={t_total}); got labels shape "
                f"{_shape(labels)} — full-sequence targets "
                "cannot be trained per truncated window")
        n_w, rem = divmod(t_total, length)
        span = n_w * length

        def time_slice(lo, hi):
            return {k: v[:, lo:hi] if _is_time_distributed(k, v, t_total)
                    else v for k, v in batch.items()}

        wmetrics, carries = [], None
        if n_w:
            ts, wmetrics, carries = self.make_tbptt_step(n_w, length)(
                ts, time_slice(0, span))
        if rem:
            tail = time_slice(span, t_total)
            if carries is None:
                carries = self._zero_carries(ts, tail["features"])
            ts, _, metrics = self.train_step_tbptt(ts, tail, carries)
            wmetrics.append(metrics)
        return ts, wmetrics

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
        tbptt = getattr(self.net, "backprop_type", "standard") == "tbptt"
        # on_fit_end runs even when a step raises: listeners hold resources
        try:
            for epoch in range(epochs):
                for lst in listeners:
                    lst.on_epoch_start(epoch)
                n = 0
                for batch in data:
                    if tbptt:
                        # every window is an iteration (the reference fires
                        # iterationDone once per window)
                        ts, wmetrics = self._fit_tbptt_batch(ts, batch)
                    else:
                        ts, metrics = self.train_step(ts, batch)
                        wmetrics = [metrics]
                    n += 1
                    for wm in wmetrics:
                        host_step += 1
                        for lst in listeners:
                            if lst.on_iteration(epoch, host_step, ts, wm):
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
