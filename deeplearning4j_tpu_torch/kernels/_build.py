"""Build and load the CUDA kernels (route: nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<digest>.so``
at the root of the checkout, then loaded with ``ctypes``. The digest covers
the source, every header in ``csrc/`` (``*.cuh``, which the sources
include) and the flags, so an edited source or header is rebuilt and a
stale library is never loaded. Nothing is compiled or loaded at import time:
the CPU tests import this module on a host without ``nvcc``. The
helpers at the end are the checks every ctypes wrapper makes.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
under ``/usr/local/cuda``. Each source has its own lock, so several
sources build at once from several threads (``chip_smoke.py`` starts one
``nvcc`` per source together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class Built(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already on disk
    log: str        # nvcc/ptxas output (registers, shared memory, spills)


_lock = threading.Lock()  # guards _name_locks and _libs; never held over nvcc
_name_locks: Dict[str, threading.Lock] = {}
_built: Dict[str, Built] = {}  # written under the source's own lock
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (tried $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are compiled from source at first use")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``csrc/<name>.cu`` builds to: ``lib<name>-<digest>.so``, the
    digest over the source, every ``*.cuh`` beside it (by name and
    content) and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _built:
            return _built[name]
        src = CSRC / f"{name}.cu"
        out = library_path(name)
        if out.exists():
            _built[name] = Built(out, 0.0, "")
            return _built[name]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.monotonic()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.monotonic() - t0
        log = (res.stdout + res.stderr).strip()
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {res.returncode}):"
                f"\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        _built[name] = Built(out, seconds, log)
        return _built[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build(name).path
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


# -- what every ctypes wrapper checks -----------------------------------------

def check_f32(device, **tensors):
    """Each tensor (None allowed) a contiguous float32 CUDA tensor on
    ``device`` of the given shape: ``name=(tensor, shape)``."""
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def raise_on(lib, name, rc):
    """Raise unless the C entry point returned 0 (its cudaError_t)."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.dl4j_cuda_error_string(rc).decode()})")


def ptr(t):
    """The device pointer of ``t``, or None (NULL) for None."""
    return None if t is None else t.data_ptr()
