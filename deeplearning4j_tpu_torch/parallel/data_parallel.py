"""Data-parallel and FSDP execution of a placement plan: the collectives the trainer writes out.

The JAX package pjits one step over a mesh and XLA inserts the collectives;
in the port every rank runs the single-device step on its rows of the
global batch and :class:`DataParallel` does what XLA would:

- **Rows.** Rank r's rows of global microbatch j are
  ``[j·n/k + r·n/(k·P), j·n/k + (r+1)·n/(k·P))`` for ``grad_accum`` k over
  P ranks, so microbatch j is the JAX package's ``reshape(k, n/k, ...)``
  row j whatever the rank count. A batch is either the global batch on
  every rank or a dict of ``DTensor`` sharded on dim 0
  (``ShardedDataSetIterator``); a global batch the ranks do not divide
  raises ``ValueError``, as ``jax.device_put`` refuses it.
- **Gradients.** Each rank differentiates ``w_r · loss_r`` (``w_r`` its
  rows' ``model.loss_weight``, else 1), so BatchNorm's all-reduce in the
  backward carries the other ranks' terms with their weights. The
  gradients and ``[Σ w·loss, Σ w, Σ w·metric...]`` are then reduced in
  coalesced buckets of at most :data:`BUCKET_BYTES` (all-reduce for
  replicated leaves; reduce-scatter over ``fsdp`` and all-reduce over
  ``data`` for sharded ones) and divided by the global ``Σ w``: the
  global weighted mean, exactly the JAX package's step.
- **FSDP (ZeRO-3).** Sharded leaves of the state are ``DTensor``s that
  hold this rank's shard; the step all-gathers full params in buckets,
  and the updater runs on the shards (every updater is elementwise).

The collectives run at world size 1 too. Every one is a sum
(``ReduceOp.SUM``) on every backend; the division by ``Σ w`` is the
trainer's.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from deeplearning4j_tpu_torch.runtime import distributed
from deeplearning4j_tpu_torch.runtime.device import (
    FSDP_AXIS,
    NamedSharding,
    batch_sharding as default_batch_sharding,
    mesh_shape,
)
from deeplearning4j_tpu_torch.utils.pytree import (
    flatten_with_names,
    tree_leaves,
    tree_map,
    tree_map_with_names,
)

# DistributedDataParallel's default bucket size
BUCKET_BYTES = 25 * 2 ** 20


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in runs of one dtype of at most
    :data:`BUCKET_BYTES` each (a larger tensor is a bucket of its own)."""
    out: List[List[int]] = []
    size, dtype = 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if not out or t.dtype != dtype or size + nbytes > BUCKET_BYTES:
            out.append([])
            size, dtype = 0, t.dtype
        out[-1].append(i)
        size += nbytes
    return out


def leaf_sq_sums(tree) -> Dict[str, torch.Tensor]:
    """Each leaf's sum of squares, by name."""
    return {n: torch.sum(torch.square(g))
            for n, g in flatten_with_names(tree)}


def _row_sharded(v) -> bool:
    return isinstance(v, DTensor) and all(
        isinstance(p, Shard) and p.dim == 0 for p in v.placements)


class DataParallel:
    """One mesh and plan's collectives for the ``Trainer``."""

    def __init__(self, mesh, state_sharding=None, batch_sharding=None):
        if not dist.is_initialized() or mesh.size() != dist.get_world_size():
            raise ValueError(
                "Trainer(mesh=...) runs a mesh over every rank of the "
                "process group (build_mesh / global_mesh)")
        names = tuple(mesh.mesh_dim_names)
        batch_sharding = batch_sharding or default_batch_sharding(mesh)
        axes = batch_sharding.spec.axes_of(0)
        if set(axes) != set(names):
            raise NotImplementedError(
                f"a batch split over {axes} of mesh axes {names}: the port "
                "splits the batch over every axis of the mesh")
        self.mesh = mesh
        self.axes = axes
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        shape = mesh_shape(mesh)
        self.fsdp_size = shape.get(FSDP_AXIS, 1)
        self.fsdp_group = (mesh.get_group(FSDP_AXIS) if FSDP_AXIS in names
                           else None)
        self.fsdp_index = (mesh.get_local_rank(FSDP_AXIS)
                           if FSDP_AXIS in names else 0)
        self.data_group = (mesh.get_group("data")
                           if shape.get("data", 1) > 1 and self.fsdp_group
                           is not None else None)
        self.state_sharding = (None if isinstance(state_sharding,
                                                  NamedSharding)
                               else state_sharding)
        # tensor dim each sharded param leaf is split along, by name
        self.param_dims: Dict[str, int] = {}
        if self.state_sharding is not None:
            for tree in (self.state_sharding.params,
                         self.state_sharding.opt_state):
                for n, sh in flatten_with_names(tree):
                    if any(a != FSDP_AXIS for d in range(len(sh.spec))
                           for a in sh.spec.axes_of(d)):
                        raise NotImplementedError(
                            f"{n}: state split over {sh.spec}; the port "
                            f"shards state over {FSDP_AXIS!r} only")
            for n, sh in flatten_with_names(self.state_sharding.params):
                d = sh.shard_dim(FSDP_AXIS)
                if d is not None and self.fsdp_size > 1:
                    self.param_dims[n] = d
        self.fsdp = bool(self.param_dims)

    # -- state ----------------------------------------------------------------

    def _shard(self, leaf, sh):
        if not torch.is_tensor(leaf) or isinstance(leaf, DTensor):
            return leaf
        d = sh.shard_dim(FSDP_AXIS)
        if d is None or self.fsdp_size == 1:
            return leaf
        if leaf.shape[d] % self.fsdp_size:
            raise ValueError(f"dim {d} of a {tuple(leaf.shape)} leaf does "
                             f"not split over fsdp={self.fsdp_size}")
        local = leaf.chunk(self.fsdp_size, dim=d)[self.fsdp_index]
        return DTensor.from_local(local.contiguous(), self.mesh,
                                  sh.placements(), run_check=False)

    def shard_state(self, ts):
        """``ts`` with every leaf the plan shards replaced by a ``DTensor``
        holding this rank's shard (no communication)."""
        if not self.fsdp:
            return ts
        return tree_map(self._shard, ts, self.state_sharding)

    @staticmethod
    def local(tree):
        """Every ``DTensor`` leaf → its local shard."""
        return tree_map(lambda x: x.to_local() if isinstance(x, DTensor)
                        else x, tree)

    @staticmethod
    def like(tree, template):
        """Local shards → ``DTensor``s placed as ``template``'s leaves."""
        return tree_map(lambda x, t: DTensor.from_local(
            x, t.device_mesh, t.placements, run_check=False)
            if isinstance(t, DTensor) else x, tree, template)

    @staticmethod
    def full(tree):
        """Every ``DTensor`` leaf gathered whole (a collective)."""
        return tree_map(distributed.full_tensor, tree)

    def full_params(self, params):
        """The full params for a step: sharded leaves all-gathered over
        ``fsdp`` in buckets (one collective a bucket)."""
        if not self.fsdp:
            return params
        named = flatten_with_names(params)
        shards = [(n, x.to_local()) for n, x in named
                  if n in self.param_dims]
        full = {}
        p = self.fsdp_size
        for bucket in _buckets([t for _, t in shards]):
            parts = [shards[i] for i in bucket]
            flat = torch.cat([t.reshape(-1) for _, t in parts])
            out = flat.new_empty(p * flat.numel())
            dist.all_gather_into_tensor(out, flat, group=self.fsdp_group)
            out = out.view(p, -1)
            off = 0
            for n, t in parts:
                pieces = out[:, off:off + t.numel()].reshape(p, *t.shape)
                full[n] = torch.cat(list(pieces.unbind(0)),
                                    dim=self.param_dims[n])
                off += t.numel()
        return tree_map_with_names(lambda n, x: full.get(n, x), params)

    # -- rows -----------------------------------------------------------------

    def global_rows(self, batch) -> int:
        return tree_leaves(batch["features"])[0].shape[0]

    def local_rows(self, batch, k: int) -> list:
        """This rank's rows of each of the ``k`` global microbatches."""
        n = self.global_rows(batch)
        if n % self.world:
            raise ValueError(
                f"global batch {n} not divisible by the {self.world} ranks "
                f"of mesh axes {self.axes}")
        if (n // k) % self.world:
            raise ValueError(
                f"microbatch {n // k} (grad_accum={k}) not divisible by the "
                f"{self.world} ranks of mesh axes {self.axes}")
        if k == 1 and all(_row_sharded(v) for v in tree_leaves(batch)):
            return [tree_map(lambda v: v.to_local(), batch)]
        whole = tree_map(distributed.full_tensor, batch)
        size = n // k // self.world
        return [tree_map(lambda v, j=j: v[j * (n // k) + self.rank * size:
                                           j * (n // k) + (self.rank + 1)
                                           * size], whole)
                for j in range(k)]

    # -- reductions -----------------------------------------------------------

    def reduce(self, grads, scalars: List[torch.Tensor]):
        """(gradient tree, float32 scalars) summed over the ranks, in
        buckets: replicated leaves whole, sharded leaves to this rank's
        shard. Returns the sums (gradients: this rank's shard of them)."""
        named = flatten_with_names(grads)
        out: Dict[str, torch.Tensor] = {}
        items = [(n, g) for n, g in named if n not in self.param_dims]
        items.append(("", torch.stack(scalars).to(torch.float32)))
        for bucket in _buckets([g for _, g in items]):
            parts = [items[i] for i in bucket]
            flat = torch.cat([g.reshape(-1) for _, g in parts])
            dist.all_reduce(flat)
            off = 0
            for n, g in parts:
                out[n] = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
        sharded = [(n, g) for n, g in named if n in self.param_dims]
        p = self.fsdp_size
        for bucket in _buckets([g for _, g in sharded]):
            parts = [sharded[i] for i in bucket]
            rows = torch.cat([torch.stack([c.reshape(-1) for c in g.chunk(
                p, dim=self.param_dims[n])]) for n, g in parts], dim=1)
            shard = rows.new_empty(rows.shape[1])
            dist.reduce_scatter_tensor(shard, rows.reshape(-1),
                                       group=self.fsdp_group)
            if self.data_group is not None:
                dist.all_reduce(shard, group=self.data_group)
            off = 0
            for n, g in parts:
                shape = list(g.shape)
                shape[self.param_dims[n]] //= p
                out[n] = shard[off:off + g.numel() // p].view(shape)
                off += g.numel() // p
        reduced = tree_map_with_names(lambda n, _: out[n], grads)
        return reduced, list(out[""].unbind(0))

    def leaf_sq_sums(self, grads) -> Dict[str, torch.Tensor]:
        """Each gradient leaf's full sum of squares by name: a sharded
        leaf's shards' sums all-reduced over ``fsdp`` (one collective)."""
        sums = leaf_sq_sums(grads)
        sharded = [n for n in sums if n in self.param_dims]
        if sharded:
            part = torch.stack([sums[n] for n in sharded])
            dist.all_reduce(part, group=self.fsdp_group)
            sums.update(zip(sharded, part.unbind(0)))
        return sums
