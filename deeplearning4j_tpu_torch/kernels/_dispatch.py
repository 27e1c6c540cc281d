"""Kernel dispatch policy and launch counts (↔ deeplearning4j_tpu/kernels/_dispatch.py).

The policy is the tensor's device and nothing else: a CUDA tensor goes to
the hand kernel (which launches or raises), a CPU tensor to the kernel's
plain PyTorch version. There is no switch that sends a CUDA tensor to the
plain version. The JAX package's ``flash_min_seq``/``flash_block_sizes``
were TPU v5e measurements and are not carried over.

Every kernel wrapper adds one to its launch count where it launches, so a
run can show that its path really went through the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

_lock = threading.Lock()
_launches: Dict[str, int] = {}


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (hand kernel), False for a CPU tensor
    (plain version); any other device has neither and raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain path for device {t.device}")


def count_launch(name: str) -> None:
    with _lock:
        _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel name since the last reset."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()
