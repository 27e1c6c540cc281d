"""Device discovery for NVIDIA cards (↔ deeplearning4j_tpu/runtime/device.py).

The JAX package enumerates PJRT devices; the port enumerates CUDA cards
through PyTorch. Entry points (``Bert``, ``ParallelInference``, the serving
registry) resolve ``device=None`` through :func:`default_device`, which
returns the first card and raises when there is none: the port never falls
back to the CPU on its own. Callers that want the CPU say so
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional

import torch

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
