"""Warmup: drive every batch bucket once before serving (↔ deeplearning4j_tpu/serving/warmup.py).

In batched mode ``ParallelInference`` pads coalesced batches to power-of-
two row buckets capped at ``max_batch_size``. Warmup pushes one zero batch
of each bucket through the replica set before the model is marked ready,
so the first user request of each shape finds the kernels built and the
CUDA caching allocator primed.

Input specs give per-example shapes (no batch dim): one :class:`Spec` for
array-feature models, a dict of them for dict-feature models (BERT's
``{token_ids, segment_ids, mask}``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np


class Spec(NamedTuple):
    """Per-example input spec leaf (↔ ``jax.ShapeDtypeStruct``).
    ``high``: for integer inputs such as token ids, the exclusive upper
    bound of valid values (ids must lie in ``[0, high)``); None = any."""

    shape: tuple
    dtype: np.dtype
    high: Optional[int] = None


def spec(shape: Sequence[int], dtype=np.float32,
         high: Optional[int] = None) -> Spec:
    """Per-example input spec leaf (shape WITHOUT the batch dim)."""
    return Spec(tuple(shape), np.dtype(dtype), high)


def map_spec(fn, input_spec):
    """Apply ``fn`` to each :class:`Spec` of an input spec (one, or a dict)."""
    if isinstance(input_spec, Spec):
        return fn(input_spec)
    return {k: map_spec(fn, v) for k, v in input_spec.items()}


def bucket_sizes(max_batch: int, mode: str = "batched", *,
                 lo: int = 1) -> List[int]:
    """Row counts whose buckets cover all batched traffic: powers of two
    from ``lo`` below ``max_batch`` plus ``max_batch`` itself. Instant
    mode pads nothing, so only batch=1 is predictably warmable. ``lo`` is
    the smallest bucket: the generation engine's KV and prompt buckets
    floor it so that short prompts share one shape."""
    if mode == "instant":
        return [1]
    if lo >= max_batch:
        return [max_batch]
    sizes, b = [], lo
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def zeros_batch(input_spec: Any, rows: int):
    """A ``rows``-example all-zeros batch matching the input spec."""
    return map_spec(
        lambda s: np.zeros((rows,) + tuple(s.shape), s.dtype), input_spec)


def warmup_inference(pi, input_spec: Any, sizes: Sequence[int], *,
                     progress: Optional[Any] = None) -> Dict[int, float]:
    """Push one zero batch per bucket through ``pi``; returns
    {rows: seconds}. Sequential on purpose: concurrent warmup requests
    would coalesce into one batch and skip buckets. ``progress`` is an
    optional ``(rows, seconds)`` callback fired after each bucket (the
    ``/readyz`` warmup-progress body reads it)."""
    stats: Dict[int, float] = {}
    for rows in sizes:
        t0 = time.monotonic()
        pi.output(zeros_batch(input_spec, rows))
        stats[rows] = time.monotonic() - t0
        if progress is not None:
            progress(rows, stats[rows])
    return stats
