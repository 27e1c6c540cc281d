"""Model registry (↔ deeplearning4j_tpu/serving/registry.py).

One ``ModelRegistry`` holds named entries; each ``ModelEntry`` owns the
``ParallelInference`` replica set of its deployed version and turns
JSON-decoded request inputs into feature arrays that match its input spec.

Not yet ported: hot-swap deploy/rollback, brownout fallbacks, the warmup
manifest and checkpoint registration.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.serving.errors import (
    BadRequestError,
    ModelNotFoundError,
    NotReadyError,
)
from deeplearning4j_tpu_torch.serving.warmup import (
    Spec,
    bucket_sizes,
    warmup_inference,
)


class ModelEntry:
    """One named model: its replica set, version and batch counts."""

    def __init__(self, name: str, forward: Callable[[Any, Any], Any],
                 input_spec: Any, *, mode: str = "batched",
                 max_batch_size: int = 32, queue_limit: int = 256,
                 devices: Optional[Sequence] = None):
        self.name = name
        self.forward = forward
        self.input_spec = input_spec
        self.mode = mode
        self.max_batch_size = max_batch_size
        self.queue_limit = queue_limit
        self.devices = devices
        self.version = ""
        self.warmed = False
        self._pi: Optional[ParallelInference] = None
        self._stats_lock = threading.Lock()
        self._batches = 0
        self._rows = 0

    def _deploy(self, variables, version: str):
        self._pi = ParallelInference(
            self.forward, variables, devices=self.devices, mode=self.mode,
            max_batch_size=self.max_batch_size, queue_limit=self.queue_limit,
            on_batch=self._on_batch)
        self.version = version

    def _on_batch(self, rows: int):
        with self._stats_lock:
            self._batches += 1
            self._rows += rows

    def batch_stats(self) -> Dict[str, int]:
        """Device batches dispatched and real (unpadded) rows served,
        warmup included."""
        with self._stats_lock:
            return {"batches": self._batches, "rows": self._rows}

    def warm(self) -> Dict[int, float]:
        """Drive every batch bucket once (expects no concurrent traffic on
        this entry: a live request coalescing with a warmup batch would
        move it into another bucket)."""
        if self._pi is None:
            raise NotReadyError(f"model '{self.name}' is shut down")
        stats = warmup_inference(self._pi, self.input_spec, bucket_sizes(
            self.max_batch_size, self.mode))
        self.warmed = True
        return stats

    # -- serving -----------------------------------------------------------

    def predict_versioned(self, features, timeout: Optional[float] = None,
                          deadline: Optional[float] = None
                          ) -> Tuple[Any, str]:
        """Serve one request; returns ``(outputs, version)``."""
        pi = self._pi
        if pi is None:
            raise NotReadyError(f"model '{self.name}' is shut down")
        return pi.output(features, timeout=timeout,
                         deadline=deadline), self.version

    def parse_inputs(self, inputs):
        """JSON-decoded inputs → feature arrays matching the input spec.

        Array-spec models take a nested list; dict-spec models an object
        with exactly the spec's keys. Rejected with a 400: wrong keys or
        shapes, disagreeing batch sizes, a batch over ``max_batch_size`` in
        batched mode, and integer values outside a spec's ``[0, high)``
        (token ids outside the vocab)."""
        if isinstance(self.input_spec, dict):
            if not isinstance(inputs, dict):
                raise BadRequestError(
                    f"model '{self.name}' takes a dict of inputs "
                    f"{sorted(self.input_spec)}")
            extra = set(inputs) - set(self.input_spec)
            if extra:
                raise BadRequestError(f"unknown inputs {sorted(extra)}; "
                                      f"expected {sorted(self.input_spec)}")
            out, rows = {}, None
            for key, s in self.input_spec.items():
                if key not in inputs:
                    raise BadRequestError(f"missing input '{key}'")
                out[key] = self._coerce(inputs[key], s, key)
                n = out[key].shape[0]
                if rows is not None and n != rows:
                    raise BadRequestError(
                        f"inputs disagree on batch size ({rows} vs {n})")
                rows = n
            self._check_rows(rows)
            return out
        arr = self._coerce(inputs, self.input_spec, "inputs")
        self._check_rows(arr.shape[0])
        return arr

    def _check_rows(self, rows: int):
        if rows == 0:
            raise BadRequestError("a request needs at least one row")
        if self.mode == "batched" and rows > self.max_batch_size:
            raise BadRequestError(
                f"batch of {rows} rows exceeds this model's "
                f"max_batch_size={self.max_batch_size}; split the request")

    @staticmethod
    def _coerce(value, s: Spec, label: str) -> np.ndarray:
        try:
            arr = np.asarray(value, dtype=s.dtype)
            arr = arr.reshape((-1,) + tuple(s.shape))
        except Exception as e:  # noqa: BLE001 — anything here is the client's
            raise BadRequestError(
                f"{label}: cannot coerce to shape (N, "
                f"{', '.join(map(str, s.shape))}) {s.dtype.name}: "
                f"{e}") from None
        if s.high is not None and arr.size and (
                arr.min() < 0 or arr.max() >= s.high):
            raise BadRequestError(
                f"{label}: values must lie in [0, {s.high}), got "
                f"[{arr.min()}, {arr.max()}]")
        return arr

    def describe(self) -> dict:
        return {"name": self.name, "version": self.version,
                "versions": [self.version] if self.version else [],
                "warmed": self.warmed, "mode": self.mode,
                "max_batch_size": self.max_batch_size,
                **self.batch_stats()}

    def shutdown(self):
        pi, self._pi = self._pi, None
        if pi is not None:
            pi.shutdown()


class ModelRegistry:
    def __init__(self):
        self._entries: Dict[str, ModelEntry] = {}
        self._lock = threading.Lock()

    def register(self, name: str, forward: Callable[[Any, Any], Any],
                 variables: Any, *, input_spec: Any, version: str = "v1",
                 mode: str = "batched", max_batch_size: int = 32,
                 queue_limit: int = 256,
                 devices: Optional[Sequence] = None) -> ModelEntry:
        """Create an entry serving ``variables`` as its first version.
        ``devices=None`` serves on every CUDA card."""
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model '{name}' already registered")
        entry = ModelEntry(name, forward, input_spec, mode=mode,
                           max_batch_size=max_batch_size,
                           queue_limit=queue_limit, devices=devices)
        entry._deploy(variables, version)
        with self._lock:
            if name in self._entries:  # lost a register-register race
                entry.shutdown()
                raise ValueError(f"model '{name}' already registered")
            self._entries[name] = entry
        return entry

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise ModelNotFoundError(f"no model named '{name}'")
        return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def entries(self) -> List[ModelEntry]:
        with self._lock:
            return [self._entries[n] for n in sorted(self._entries)]

    def describe(self) -> List[dict]:
        return [e.describe() for e in self.entries()]

    def shutdown_all(self):
        for entry in self.entries():
            entry.shutdown()

