"""Process bootstrap and host collectives over torch.distributed (↔ deeplearning4j_tpu/runtime/distributed.py).

The JAX package bootstraps with ``jax.distributed.initialize`` and lets XLA
insert the data-plane collectives; the port joins a ``torch.distributed``
process group, one process (rank) a device, and its trainer writes the
collectives out (``parallel/data_parallel.py``).

- :func:`initialize` — explicit arguments, the ``DL4J_TPU_COORDINATOR_*``
  variables with the supervisor's ``DL4J_TPU_WORKER_ID`` /
  ``DL4J_TPU_NUM_WORKERS``, or torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` / ``MASTER_ADDR`` (the counterpart of the JAX package's
  cluster auto-detection). Rank r runs on ``cuda:{LOCAL_RANK}`` over NCCL
  unless the caller asks for ``device="cpu"`` (gloo) or names another
  backend; nothing falls back from NCCL to gloo, or from the card to the
  CPU, on its own. With nothing set it is a no-op, as in the JAX package;
  :func:`ensure_process_group` (``build_mesh``) then makes a group of
  world size 1, so one process runs the same collectives as many.
- :func:`barrier`, :func:`broadcast_host_data`, :func:`checkpoint_sync`
  run over the process group's key-value store under a deadline
  (``timeout_s``, else ``DL4J_TPU_COLLECTIVE_TIMEOUT_S``, default 300 s,
  <= 0 disables): a dead peer raises :class:`CollectiveTimeout`; it does
  not hang.
- The cluster trace ids (:func:`establish_cluster_trace`,
  :func:`step_trace_id`, ...) derive the JAX package's ids from the same
  cluster id.
- :func:`replica_context` / :func:`replica_group` tell BatchNorm which
  ranks share its batch statistics, and :func:`all_reduce_sum` is the
  all-reduce whose backward all-reduces the gradient.

Not ported yet (ROADMAP queue 1 item 12): the ``collective.stall`` fault
point, the collective spans and the crash report a timeout writes.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import pickle
import time
import uuid
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.runtime.device import (
    MeshSpec,
    build_mesh,
    default_device,
)

# the supervisor-armed coordination endpoint: a host:port address (or any
# torch init URL, e.g. file:///path), or a bare port implying 127.0.0.1
ENV_COORDINATOR_ADDRESS = "DL4J_TPU_COORDINATOR_ADDRESS"
ENV_COORDINATOR_PORT = "DL4J_TPU_COORDINATOR_PORT"
ENV_COLLECTIVE_TIMEOUT = "DL4J_TPU_COLLECTIVE_TIMEOUT_S"
DEFAULT_COLLECTIVE_TIMEOUT_S = 300.0
_POLL_S = 0.005


class CollectiveTimeout(RuntimeError):
    """A host collective exceeded its deadline — the cluster is stalled
    (↔ deeplearning4j_tpu/resilience/cluster.py). Carries the operation
    name, the deadline, the crash-report path and the peers known dead
    (neither is written by the port yet)."""

    def __init__(self, msg: str, *, op: str = "", timeout_s: float = 0.0,
                 crash_report: Optional[str] = None,
                 dead: Optional[List[int]] = None):
        super().__init__(msg)
        self.op = op
        self.timeout_s = timeout_s
        self.crash_report = crash_report
        self.dead = list(dead or [])


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name) or default)
    except ValueError:
        return default


def worker_identity() -> Dict[str, int]:
    """This process's supervisor-provided identity (↔
    observability/federation.py): zeros and ones when not under a
    supervisor; junk degrades to the defaults."""
    return {
        "worker_id": _env_int("DL4J_TPU_WORKER_ID", 0),
        "num_workers": _env_int("DL4J_TPU_NUM_WORKERS", 1),
        "generation": _env_int("DL4J_TPU_GENERATION", 1),
    }


def default_collective_timeout_s() -> Optional[float]:
    """``DL4J_TPU_COLLECTIVE_TIMEOUT_S`` seconds (<= 0: no deadline),
    300 by default."""
    raw = os.environ.get(ENV_COLLECTIVE_TIMEOUT)
    if raw is None:
        return DEFAULT_COLLECTIVE_TIMEOUT_S
    try:
        val = float(raw)
    except ValueError:
        return DEFAULT_COLLECTIVE_TIMEOUT_S
    return val if val > 0 else None


# -- bootstrap ----------------------------------------------------------------

# the device this process computes on, set where the process group is made
_DEVICE: Optional[torch.device] = None


def _coordinator_from_env() -> Optional[str]:
    addr = os.environ.get(ENV_COORDINATOR_ADDRESS)
    if addr:
        return addr
    port = os.environ.get(ENV_COORDINATOR_PORT)
    return f"127.0.0.1:{port}" if port else None


def _rank_device(device, local_index: int) -> torch.device:
    """``None`` → the card ``cuda:{local_index}`` (raises without CUDA);
    anything else as given."""
    if device is not None:
        return torch.device(device)
    default_device()
    return torch.device("cuda", local_index)


def _group_timeout() -> datetime.timedelta:
    t = default_collective_timeout_s()
    return datetime.timedelta(seconds=t if t is not None else 1800.0)


def _join(backend, dev: torch.device, **kwargs) -> None:
    global _DEVICE
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, timeout=_group_timeout(), **kwargs)
    _DEVICE = dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *,
               device=None, backend: Optional[str] = None) -> None:
    """Join the process group (↔ ``jax.distributed.initialize``).

    ``coordinator_address`` (else ``DL4J_TPU_COORDINATOR_ADDRESS`` /
    ``_PORT``) is ``host:port`` or a torch init URL (``file:///path``);
    ``num_processes`` / ``process_id`` default to the supervisor's
    ``DL4J_TPU_NUM_WORKERS`` / ``DL4J_TPU_WORKER_ID``. Without either,
    torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
    are read (``env://``); without those it does nothing. The device is
    ``cuda:{LOCAL_RANK}`` (``local_device_ids[0]`` when given) over NCCL;
    ``device="cpu"`` selects gloo; ``backend`` overrides the choice (gloo
    over CUDA tensors is how two ranks share one card). Idempotent."""
    if dist.is_initialized():
        return
    env = os.environ
    addr = coordinator_address or _coordinator_from_env()
    if addr is None and num_processes is None:
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                      "MASTER_PORT")):
            return  # one process: nothing to join
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", 0))
        _join(backend, _rank_device(device, local), init_method="env://",
              rank=rank, world_size=world)
        return
    if addr is None:
        raise ValueError(
            f"initialize(num_processes={num_processes}) needs a coordinator "
            f"address (argument, {ENV_COORDINATOR_ADDRESS} or "
            f"{ENV_COORDINATOR_PORT})")
    ident = worker_identity()
    world = ident["num_workers"] if num_processes is None else num_processes
    rank = ident["worker_id"] if process_id is None else process_id
    if local_device_ids:
        local = int(local_device_ids[0])
    else:
        local = _env_int("LOCAL_RANK",
                         rank % max(1, torch.cuda.device_count()))
    init_method = addr if "://" in addr else f"tcp://{addr}"
    _join(backend, _rank_device(device, local), init_method=init_method,
          rank=rank, world_size=world)


def initialize_from_env() -> dict:
    """Bootstrap a supervised worker from the supervisor's environment:
    identity from ``DL4J_TPU_WORKER_ID`` / ``DL4J_TPU_NUM_WORKERS``, the
    coordinator from ``DL4J_TPU_COORDINATOR_ADDRESS`` or ``_PORT``. A
    one-worker generation joins nothing. Returns the identity."""
    ident = worker_identity()
    if ident["num_workers"] > 1:
        addr = _coordinator_from_env()
        if addr is None:
            raise RuntimeError(
                f"initialize_from_env: {ident['num_workers']}-worker "
                f"generation but neither {ENV_COORDINATOR_ADDRESS} nor "
                f"{ENV_COORDINATOR_PORT} is set — the supervisor's "
                "on_generation hook must mint the coordinator endpoint "
                "per generation")
        initialize(addr, num_processes=ident["num_workers"],
                   process_id=ident["worker_id"])
    return ident


def ensure_process_group(device=None) -> None:
    """A process group of world size 1 on ``device`` (None: the card over
    NCCL; "cpu": gloo) unless one exists (↔ ``init_device_mesh``)."""
    if dist.is_initialized():
        return
    _join(None, _rank_device(device, 0), store=dist.HashStore(), rank=0,
          world_size=1)


def shutdown() -> None:
    """Leave the process group (↔ ``jax.distributed.shutdown``); the
    cluster trace id goes with it."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
    _GENERATIONS.clear()
    reset_cluster_trace()


def rank_device() -> torch.device:
    """The device this process computes on (the process group's)."""
    if _DEVICE is None:
        raise RuntimeError("no process group: call initialize() or "
                           "build_mesh() first")
    return _DEVICE


def device_type() -> str:
    return rank_device().type


def is_multiprocess() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices() -> List[torch.device]:
    """This process's device (one a rank)."""
    return [rank_device() if _DEVICE is not None else default_device()]


def global_mesh(spec: Optional[MeshSpec] = None, device=None):
    """A mesh over every rank (the data axis absorbs them by default)."""
    return build_mesh(spec or MeshSpec(), device=device)


# -- cluster trace context ------------------------------------------------------
#
# A correlation id minted at rank 0 and broadcast to every rank, from which
# each step's trace id and root span id derive with no communication.

_CLUSTER_TRACE_ID: Optional[str] = None
_CURRENT_STEP = 0
_ID_PREFIX = uuid.uuid4().hex[:8]


def establish_cluster_trace(timeout_s: Optional[float] = None
                            ) -> Optional[str]:
    """Agree on one cluster-wide trace id: rank 0 mints it, every rank
    receives it by :func:`broadcast_host_data`. Idempotent."""
    global _CLUSTER_TRACE_ID
    if _CLUSTER_TRACE_ID is not None:
        return _CLUSTER_TRACE_ID
    tid = f"{_ID_PREFIX}{uuid.uuid4().int & 0xFFFFFFFF:08x}"
    if is_multiprocess():
        tid = broadcast_host_data(tid, timeout_s=timeout_s)
    _CLUSTER_TRACE_ID = tid
    return tid


def cluster_trace_id() -> Optional[str]:
    return _CLUSTER_TRACE_ID


def reset_cluster_trace() -> None:
    global _CLUSTER_TRACE_ID
    _CLUSTER_TRACE_ID = None


def note_step(step: int) -> None:
    """Record the training loop's current optimizer step."""
    global _CURRENT_STEP
    _CURRENT_STEP = int(step)


def current_step() -> int:
    return _CURRENT_STEP


def step_trace_id(step: Optional[int] = None) -> Optional[str]:
    """The cluster prefix + ``s`` + the step as 8 hex digits, the same on
    every rank; None until a cluster trace is established."""
    if _CLUSTER_TRACE_ID is None:
        return None
    s = _CURRENT_STEP if step is None else int(step)
    return f"{_CLUSTER_TRACE_ID[:8]}s{s & 0xFFFFFFFF:08x}"


def step_root_span_id(step: Optional[int] = None) -> Optional[str]:
    """The step's root span id (the ``r`` marker)."""
    if _CLUSTER_TRACE_ID is None:
        return None
    s = _CURRENT_STEP if step is None else int(step)
    return f"{_CLUSTER_TRACE_ID[:8]}r{s & 0xFFFFFFFF:08x}"


# -- deadline-guarded host collectives (over the group's key-value store) ----

# how many times each (op, name) ran here: every rank calls host
# collectives in the same order, so the counts name the same store keys
_GENERATIONS: Counter = Counter()


def _store():
    return dist.distributed_c10d._get_default_store()


def _key(op: str) -> str:
    _GENERATIONS[op] += 1
    return f"dl4j/{op}/{_GENERATIONS[op]}"


def _await(ready, op: str, timeout_s: Optional[float]) -> None:
    t = default_collective_timeout_s() if timeout_s is None else timeout_s
    deadline = None if t is None or t <= 0 else time.monotonic() + t
    while not ready():
        if deadline is not None and time.monotonic() > deadline:
            raise CollectiveTimeout(
                f"{op}: not every rank arrived within {t} s", op=op,
                timeout_s=float(t))
        time.sleep(_POLL_S)


def barrier(name: str = "barrier",
            timeout_s: Optional[float] = None) -> None:
    """Every rank waits here for every other; a peer that does not come
    raises :class:`CollectiveTimeout` after the deadline."""
    if not is_multiprocess():
        return
    op = f"barrier:{name}"
    key, store, world = _key(op), _store(), process_count()
    store.add(key, 1)
    _await(lambda: store.add(key, 0) >= world, op, timeout_s)


def broadcast_host_data(value, is_source: Optional[bool] = None,
                        timeout_s: Optional[float] = None):
    """Rank 0's (or the ``is_source`` rank's) host value on every rank,
    under the :func:`barrier` deadline. The value travels pickled between
    the job's own ranks."""
    if not is_multiprocess():
        return value
    op = "broadcast_host_data"
    key, store = _key(op), _store()
    source = process_index() == 0 if is_source is None else is_source
    if source:
        store.set(key, pickle.dumps(value))
        return value
    _await(lambda: store.check([key]), op, timeout_s)
    return pickle.loads(store.get(key))


def checkpoint_sync(name: str = "checkpoint",
                    timeout_s: Optional[float] = None) -> None:
    """The checkpoint rendezvous: every rank reaches the save/restore
    point before any goes on (:func:`barrier` under its own name)."""
    barrier(f"checkpoint:{name}", timeout_s=timeout_s)


def host_local_to_global(arrays, mesh, pspecs):
    """This rank's rows → one global ``DTensor`` a leaf, sharded as
    ``pspecs`` says (a ``NamedSharding`` a leaf, or one for all), on this
    rank's device (↔ a global ``jax.Array`` from host-local shards)."""
    from torch.distributed.tensor import DTensor

    from deeplearning4j_tpu_torch.utils.pytree import tree_map

    dev = rank_device()

    def one(a, sh):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return DTensor.from_local(t.to(dev), mesh, sh.placements(),
                                  run_check=False)

    if not isinstance(pspecs, dict):
        return tree_map(lambda a: one(a, pspecs), arrays)
    return tree_map(one, arrays, pspecs)


def full_tensor(x):
    """The whole tensor a ``DTensor`` (each placement ``Shard(d)`` or
    ``Replicate()``) holds a shard of, gathered with
    ``all_gather_into_tensor`` over each sharded mesh dim, the last first
    (a gloo rank on CUDA tensors died with SIGSEGV where
    ``DTensor.full_tensor`` gathered its shards; this call ran). Other
    tensors as given."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    t, mesh = x.to_local(), x.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if not isinstance(p, Shard):
            continue
        n = mesh.size(i)
        out = t.new_empty((n * t.numel(),))
        dist.all_gather_into_tensor(out, t.contiguous().reshape(-1),
                                    group=mesh.get_group(i))
        t = torch.cat(list(out.view(n, *t.shape).unbind(0)), dim=p.dim)
    return t


# -- the replicas a layer's statistics span -----------------------------------

_REPLICAS: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_replicas", default=None)


@contextlib.contextmanager
def replica_context(mesh):
    """Within it, :func:`replica_group` names the ranks of ``mesh`` that
    split one batch (the trainer's data-parallel forward; the trainer runs
    meshes that cover every rank, all of whose axes split the batch)."""
    token = _REPLICAS.set(mesh)
    try:
        yield
    finally:
        _REPLICAS.reset(token)


def replica_group(axis_name: Optional[str] = None):
    """The process group a layer's batch statistics reduce over: every
    rank, or only mesh axis ``axis_name`` (a dropped trivial axis: this
    rank alone, None). Outside :func:`replica_context` None, and a named
    axis raises, as an unbound axis name does in JAX."""
    mesh = _REPLICAS.get()
    if mesh is None:
        if axis_name is not None:
            raise ValueError(
                f"axis name {axis_name!r} is bound only in a data-parallel "
                "step (Trainer(mesh=...))")
        return None
    if axis_name is None:
        return dist.group.WORLD
    if axis_name not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(axis_name)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` forward; the gradient summed over it backward
    (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable (the backward
    all-reduces the gradient)."""
    return _AllReduceSum.apply(x, group)
