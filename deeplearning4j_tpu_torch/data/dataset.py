"""Minibatch containers (↔ deeplearning4j_tpu/data/dataset.py): ``DataSet`` and ``as_batch_dict``, what ``fit`` calls.

A ``DataSet`` is a tree node (``utils.pytree.register_dataclass``), so
``batch_to_device`` and ``tree_map`` walk its arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.utils.pytree import register_dataclass


@register_dataclass
@dataclasses.dataclass
class DataSet:
    """↔ org.nd4j.linalg.dataset.DataSet (features, labels + masks)."""

    features: Any
    labels: Any
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    @property
    def num_examples(self) -> int:
        return self.features.shape[0]

    def as_dict(self) -> Dict[str, Any]:
        d = {"features": self.features, "labels": self.labels}
        if self.labels_mask is not None:
            d["mask"] = self.labels_mask
        return d

    def split(self, n: int):
        """Split into n equal shards along the batch (host side)."""
        fs = np.array_split(np.asarray(self.features), n)
        ls = np.array_split(np.asarray(self.labels), n)
        return [DataSet(f, l) for f, l in zip(fs, ls)]


def as_batch_dict(batch) -> Dict[str, Any]:
    """Coerce DataSet-likes (``features``/``labels``/``labels_mask``),
    (x, y) tuples, or ready dicts into the batch dict the loss functions
    consume."""
    if isinstance(batch, dict):
        return batch
    if hasattr(batch, "features") and hasattr(batch, "labels"):
        d = {"features": batch.features, "labels": batch.labels}
        mask = getattr(batch, "labels_mask", None)
        if mask is not None:
            d["mask"] = mask
        return d
    if isinstance(batch, (tuple, list)) and len(batch) == 2:
        return {"features": batch[0], "labels": batch[1]}
    raise TypeError(f"cannot interpret batch of type {type(batch)}")
