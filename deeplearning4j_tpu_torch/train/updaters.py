"""Updater configs (↔ deeplearning4j_tpu/train/updaters.py).

Only the ``Adam`` config so far: it is the updater a ``BertConfig`` carries
by default, so its JSON must round-trip between the packages. The update
rules come with the Trainer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from deeplearning4j_tpu_torch.nn.config import register_config


@register_config
@dataclass
class Adam:
    """↔ Adam (bias-corrected first/second moments); config fields only."""

    lr: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
