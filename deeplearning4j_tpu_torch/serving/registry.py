"""Model registry (↔ deeplearning4j_tpu/serving/registry.py).

One ``ModelRegistry`` holds named entries; each ``ModelEntry`` owns the
``ParallelInference`` replica set of its deployed version and turns
JSON-decoded request inputs into feature arrays that match its input spec.

Every dispatched batch calls back into the registry: the serving bundle
(``attach_metrics``) records its occupancy and device latency, a warmup
manifest (``attach_manifest``, serving/warmstart.py) notes its bucket for
live batches only (warmup's own batches run before the entry is warmed),
and a bucket outside the warmed set counts once into
``warmup_recompiles_after_warm_total{plane="predict"}``.
``ModelEntry.warm(sizes=)`` warms the manifest's buckets where the
server's warm plan restricts it.

Not yet ported: hot-swap deploy/rollback, brownout fallbacks and
checkpoint registration (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.observability.flightrecorder import record_event
from deeplearning4j_tpu_torch.observability.metrics import (
    warmstart_metrics_or_none,
)
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

    def __init__(self, registry: "ModelRegistry", name: str,
                 forward: Callable[[Any, Any], Any], input_spec: Any, *,
                 mode: str = "batched", max_batch_size: int = 32,
                 queue_limit: int = 256,
                 devices: Optional[Sequence] = None):
        self._registry = registry
        self.name = name
        self.forward = forward
        self.input_spec = input_spec
        self.mode = mode
        self.max_batch_size = max_batch_size
        self.queue_limit = queue_limit
        self.devices = devices
        self.version = ""
        self.warmed = False
        # the buckets the last warm() ran: a live batch outside this set
        # is a shape first run after warm
        self.warmed_buckets: set = set()
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

    def _on_batch(self, n_requests: int, rows: int, bucket: int,
                  seconds: float):
        with self._stats_lock:
            self._batches += 1
            self._rows += rows
        self._registry._record_batch(self.name, n_requests, rows, bucket,
                                     seconds)

    def batch_stats(self) -> Dict[str, int]:
        """Device batches dispatched and real (unpadded) rows served,
        warmup included."""
        with self._stats_lock:
            return {"batches": self._batches, "rows": self._rows}

    def _manifest_warm_sizes(self) -> List[int]:
        """Manifest-restricted buckets when traffic data exists, the full
        vocabulary otherwise (observed buckets outside the vocabulary are
        dropped; none left means the full set)."""
        manifest = self._registry._warm_manifest
        all_sizes = bucket_sizes(self.max_batch_size, self.mode)
        if manifest is not None:
            observed = manifest.predict_buckets(self.name)
            if observed:
                sizes = [s for s in all_sizes if s in set(observed)]
                if sizes:
                    return sizes
        return all_sizes

    def warm(self, sizes: Optional[Sequence[int]] = None, progress=None,
             source: str = "full") -> Dict[int, float]:
        """Drive batch buckets once: ``sizes`` (e.g. a warmup manifest's
        observed buckets) or the full vocabulary. ``progress`` is an
        optional ``(rows, seconds)`` callback a bucket; ``source`` labels
        ``warmup_shapes_total`` (manifest | full). Expects no concurrent
        traffic on this entry: a live request coalescing with a warmup
        batch would move it into another bucket."""
        if self._pi is None:
            raise NotReadyError(f"model '{self.name}' is shut down")
        if sizes is None:
            sizes = bucket_sizes(self.max_batch_size, self.mode)
        wm = warmstart_metrics_or_none()

        def note(rows, seconds):
            if wm is not None:
                wm.warmup_shapes_total.inc(plane="predict", source=source)
                wm.warmup_seconds.observe(seconds, plane="predict")
            if progress is not None:
                progress(rows, seconds)

        stats = warmup_inference(self._pi, self.input_spec, sizes,
                                 progress=note)
        self.warmed = True
        self.warmed_buckets = set(sizes)
        self._registry._record_ready(self.name, True)
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
        self._metrics = None
        self._warm_manifest = None

    def attach_metrics(self, metrics):
        """Wire a ``ServingMetrics`` bundle: every dispatched batch
        records its occupancy and device latency."""
        self._metrics = metrics

    def attach_manifest(self, manifest):
        """Wire a :class:`~deeplearning4j_tpu_torch.serving.warmstart.
        WarmupManifest`: every live batch's bucket feeds the traffic mix
        the next restart warms against."""
        self._warm_manifest = manifest

    def _record_batch(self, name: str, n_requests: int, rows: int,
                      bucket: int, seconds: float):
        m = self._metrics
        if m is not None:
            m.batch_occupancy.observe(rows / max(bucket, 1), model=name)
            m.device_latency.observe(seconds, model=name)
        with self._lock:
            entry = self._entries.get(name)
        wm = self._warm_manifest
        if wm is not None and (entry is None or entry.warmed):
            # live traffic only: warmup's own zero batches run before the
            # entry is warmed, and noting them would teach the manifest
            # the full vocabulary
            try:
                wm.note_batch(name, bucket)
            except Exception:  # noqa: BLE001 — recording traffic never
                pass           # fails serving
        if entry is not None and entry.warmed and entry.warmed_buckets \
                and bucket not in entry.warmed_buckets:
            # a bucket first run after warm, counted once
            entry.warmed_buckets.add(bucket)
            wsm = warmstart_metrics_or_none()
            if wsm is not None:
                wsm.recompiles_after_warm_total.inc(plane="predict")
            record_event("serving.recompile_after_warm", model=name,
                         bucket=bucket)

    def _record_ready(self, name: str, ready: bool):
        m = self._metrics
        if m is not None:
            m.model_ready.set(1.0 if ready else 0.0, model=name)

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
        entry = ModelEntry(self, name, forward, input_spec, mode=mode,
                           max_batch_size=max_batch_size,
                           queue_limit=queue_limit, devices=devices)
        entry._deploy(variables, version)
        with self._lock:
            if name in self._entries:  # lost a register-register race
                entry.shutdown()
                raise ValueError(f"model '{name}' already registered")
            self._entries[name] = entry
        self._record_ready(name, False)
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

