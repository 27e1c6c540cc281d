"""Minibatch coercion (↔ deeplearning4j_tpu/data/dataset.py) — what ``fit`` calls."""

from __future__ import annotations

from typing import Any, Dict


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
