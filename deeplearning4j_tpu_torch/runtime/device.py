"""Device discovery and meshes for NVIDIA cards (↔ deeplearning4j_tpu/runtime/device.py).

The JAX package enumerates PJRT devices; the port enumerates CUDA cards
through PyTorch. Entry points (``Bert``, ``ParallelInference``, the serving
registry) resolve ``device=None`` through :func:`default_device`, which
returns the first card and raises when there is none: the port never falls
back to the CPU on its own. Callers that want the CPU say so
(``device="cpu"``), as the tests do.

Meshes: one device a process (rank), so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks, laid out in
row-major rank order as ``np.reshape`` lays out the JAX package's device
array, with the JAX package's axis names (``data``, ``fsdp``, ...).
:class:`NamedSharding` and :class:`PartitionSpec` keep the JAX package's
placement vocabulary; ``NamedSharding.placements()`` is the DTensor
placement list it stands for. Only the ``data`` and ``fsdp`` axes run:
a mesh whose ``model``, ``seq``, ``stage`` or ``expert`` axis is larger
than 1 raises ``NotImplementedError`` (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import math
import subprocess
from typing import List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"

ALL_AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS,
            EXPERT_AXIS)
# the axes the port's meshes run; the others wait for ROADMAP item 8
PORTED_AXES = (DATA_AXIS, FSDP_AXIS)

HOPPER_CAPABILITY = (9, 0)


def default_device() -> torch.device:
    """The first CUDA card; raises when CUDA is unavailable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: deeplearning4j_tpu_torch runs on an "
            "NVIDIA card by default. Pass device='cpu' explicitly to run "
            "on the CPU.")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``None`` → :func:`default_device`; anything else → ``torch.device``."""
    return default_device() if device is None else torch.device(device)


def devices() -> List[torch.device]:
    """Every CUDA card (↔ ``jax.devices()``); raises when there is none."""
    default_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def require_hopper(device=None) -> torch.device:
    """The resolved device, or a RuntimeError if it is not a compute
    capability 9.0 card, H100 or H200 (the hand kernels are compiled for
    ``sm_90a`` only)."""
    dev = resolve_device(device)
    cap = (torch.cuda.get_device_capability(dev)
           if dev.type == "cuda" else None)
    if cap != HOPPER_CAPABILITY:
        raise RuntimeError(
            f"{dev} has compute capability {cap}; the port's kernels are "
            f"built for sm_90a and need {HOPPER_CAPABILITY}")
    return dev


def nvidia_smi_name_power() -> List[str]:
    """One line per card, exactly as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def describe(device=None) -> dict:
    """Name, capability and power limit of one card — the label every
    measurement the port records is written beside."""
    dev = resolve_device(device)
    idx = dev.index or 0
    smi: Optional[str] = None
    lines = nvidia_smi_name_power()
    if idx < len(lines):
        smi = lines[idx]
    return {
        "device": str(dev),
        "name": torch.cuda.get_device_name(dev),
        "capability": list(torch.cuda.get_device_capability(dev)),
        "nvidia_smi": smi,
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


# -- meshes (↔ jax.sharding.Mesh / NamedSharding / PartitionSpec) -----------


class PartitionSpec(tuple):
    """↔ ``jax.sharding.PartitionSpec``: one entry per tensor dim, each
    None (replicated), a mesh axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes_of(self, dim: int) -> tuple:
        """The mesh axes tensor dim ``dim`` is split over."""
        if dim >= len(self) or self[dim] is None:
            return ()
        entry = self[dim]
        return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """↔ ``jax.sharding.NamedSharding``: a mesh and a PartitionSpec."""

    mesh: object
    spec: PartitionSpec = PartitionSpec()

    def shard_dim(self, axis: str) -> Optional[int]:
        """The tensor dim split over mesh axis ``axis``, or None."""
        for d in range(len(self.spec)):
            if axis in self.spec.axes_of(d):
                return d
        return None

    def placements(self) -> list:
        """The DTensor placements, one per mesh dim: ``Shard(d)`` where
        the spec splits tensor dim d over that axis, else
        ``Replicate()``. A dim split over several axes is split in the
        spec's order, which for the data-like axes is the mesh's."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            d = self.shard_dim(name)
            out.append(Replicate() if d is None else Shard(d))
        return out


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: axis name → size. Size -1 means 'absorb remainder'.

    Example: ``MeshSpec(data=-1, fsdp=2)`` on 8 ranks → mesh (4, 2) with
    axes ("data", "fsdp")."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    stage: int = 1
    expert: int = 1

    def resolve(self, n_devices: Optional[int] = None) -> dict:
        """Axis sizes over ``n_devices`` (default: every rank); the JAX
        package's errors."""
        if n_devices is None:
            from deeplearning4j_tpu_torch.runtime import distributed

            n_devices = distributed.process_count()
        n = n_devices
        sizes = {
            DATA_AXIS: self.data,
            FSDP_AXIS: self.fsdp,
            MODEL_AXIS: self.model,
            SEQ_AXIS: self.seq,
            STAGE_AXIS: self.stage,
            EXPERT_AXIS: self.expert,
        }
        wildcard = [k for k, v in sizes.items() if v == -1]
        if len(wildcard) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wildcard:
            if n % fixed != 0:
                raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
            sizes[wildcard[0]] = n // fixed
        elif fixed != n:
            raise ValueError(f"mesh {sizes} wants {fixed} devices, have {n}")
        return sizes


def build_mesh(spec: Optional[MeshSpec] = None, *,
               devices_: Optional[Sequence[int]] = None,
               drop_trivial_axes: bool = True, device=None):
    """A ``DeviceMesh`` over the ranks ``devices_`` (default: every rank),
    one device a rank, row-major in rank order. Axes of size 1 are dropped
    by default (``{"data": 1}`` when none is left). Without a process
    group, one of world size 1 is created on ``device`` (None: the card,
    over NCCL; "cpu": gloo), as ``init_device_mesh`` does, so a
    single-process mesh runs the same collectives as a larger one."""
    from torch.distributed.device_mesh import DeviceMesh

    from deeplearning4j_tpu_torch.runtime import distributed

    spec = spec or MeshSpec()
    ranks = (list(devices_) if devices_ is not None
             else list(range(distributed.process_count())))
    sizes = spec.resolve(len(ranks))
    wide = [a for a in ALL_AXES if a not in PORTED_AXES and sizes[a] > 1]
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} are not ported yet: the port's meshes run "
            f"{PORTED_AXES} only (ROADMAP queue 1 item 8)")
    distributed.ensure_process_group(device)
    if drop_trivial_axes:
        sizes = {k: v for k, v in sizes.items() if v > 1}
        if not sizes:
            sizes = {DATA_AXIS: 1}
    layout = np.asarray(ranks).reshape(tuple(sizes.values()))
    return DeviceMesh(distributed.device_type(), torch.as_tensor(layout),
                      mesh_dim_names=tuple(sizes))


def single_device_mesh(device=None):
    """A one-rank ``data`` mesh (world size 1)."""
    return build_mesh(MeshSpec(data=1), device=device)


def mesh_shape(mesh) -> dict:
    """axis name → size (↔ ``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def data_like_axes(mesh) -> tuple:
    """Mesh axes the batch dimension shards over (single source of truth
    for specs.batch_spec / batch_sharding)."""
    return tuple(a for a in (DATA_AXIS, FSDP_AXIS)
                 if a in mesh.mesh_dim_names)


def batch_sharding(mesh) -> NamedSharding:
    """Shard leading (batch) dim over every data-like axis present."""
    axes = data_like_axes(mesh)
    if not axes:
        return NamedSharding(mesh, PartitionSpec())
    return NamedSharding(mesh, PartitionSpec(axes))
