"""Placement plans (↔ deeplearning4j_tpu/parallel/specs.py).

The JAX package's placement policy, with its names and rules: a plan is a
tree of :class:`~deeplearning4j_tpu_torch.runtime.device.NamedSharding`
that ``Trainer(mesh=..., state_sharding=..., batch_sharding=...)``
executes (``parallel/data_parallel.py``).

- data parallel (ParallelWrapper, gradient sharing, parameter averaging)
  → replicated state, batch split over the data-like axes; the trainer
  all-reduces gradients (and BatchNorm's statistics).
- FSDP (ZeRO-3) → each param large enough, and the optimizer state that
  mirrors it, split along one dim over the ``fsdp`` axis (the dim the JAX
  rule picks); the trainer all-gathers params for the step and
  reduce-scatters gradients to the shards.

Not ported yet (ROADMAP queue 1 item 8): ``tensor_parallel_plan``,
``TP_RULES`` and ``expert_parallel_plan``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from deeplearning4j_tpu_torch.runtime.device import (
    FSDP_AXIS,
    NamedSharding,
    PartitionSpec as P,
    data_like_axes,
    mesh_shape,
)
from deeplearning4j_tpu_torch.utils.pytree import (
    flatten_with_names,
    tree_map,
    unflatten,
)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_spec(mesh) -> NamedSharding:
    """Shard the leading (batch) dim over all data-like axes present."""
    axes = data_like_axes(mesh)
    return NamedSharding(mesh, P(axes if axes else None))


def data_parallel_plan(mesh):
    """Replicated state, batch-sharded data → (state_sharding,
    batch_sharding) for ``Trainer``."""
    return replicated(mesh), batch_spec(mesh)


def _fsdp_spec_for(shape, fsdp_size: int, min_shard_elems: int) -> P:
    """Shard the largest divisible dim on the fsdp axis; tiny params stay
    replicated (sharding a 10-element bias costs more in collectives than
    it saves)."""
    if not shape or int(np.prod(shape)) < min_shard_elems:
        return P()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
            spec = [None] * len(shape)
            spec[i] = FSDP_AXIS
            return P(*spec)
    return P()


def fsdp_plan(mesh, params_template: Any, *, min_shard_elems: int = 1024):
    """ZeRO-3: a per-leaf param sharding tree (leaves: anything with a
    ``shape``, ``meta`` tensors too) → (params_sharding_tree,
    batch_sharding). The optimizer state mirrors it
    (:func:`train_state_sharding`)."""
    fsdp_size = mesh_shape(mesh).get(FSDP_AXIS, 1)
    if fsdp_size == 1:
        return tree_map(lambda _: replicated(mesh), params_template), \
            batch_spec(mesh)
    shardings = tree_map(
        lambda p: NamedSharding(mesh, _fsdp_spec_for(
            tuple(p.shape), fsdp_size, min_shard_elems)),
        params_template)
    return shardings, batch_spec(mesh)


def train_state_sharding(mesh, ts_template, params_sharding=None):
    """A sharding tree matching a TrainState: params follow
    ``params_sharding`` (default: everything replicated, returned as one
    sharding), each params-shaped optimizer-state tree mirrors them,
    model_state, step and rng are replicated."""
    rep = replicated(mesh)
    if params_sharding is None:
        return rep

    from deeplearning4j_tpu_torch.train.trainer import TrainState

    ps = [sh for _, sh in flatten_with_names(params_sharding)]

    def mirror(tree):
        named = flatten_with_names(tree)
        if len(named) == len(ps):
            return unflatten((n, sh) for (n, _), sh in zip(named, ps))
        return tree_map(lambda _: rep, tree)

    if isinstance(ts_template.opt_state, dict):
        opt_sh = {k: mirror(v) for k, v in ts_template.opt_state.items()}
    else:
        opt_sh = tree_map(lambda _: rep, ts_template.opt_state)
    return TrainState(params=params_sharding,
                      model_state=tree_map(lambda _: rep,
                                           ts_template.model_state),
                      opt_state=opt_sh, step=rep, rng=rep)
