"""Traffic-derived warmup manifests: restart warm for exactly the shapes
live traffic uses (↔ deeplearning4j_tpu/serving/warmstart.py).

The predict and generation planes see every shape live traffic uses: the
predict plane's padded batch buckets (``ModelRegistry``'s batch hook),
the generation engine's prompt buckets and (slot bucket, kv bucket)
decode pairs. :class:`WarmupManifest` records that mix into a bounded,
atomically rewritten JSON file; a restarted ``ModelServer`` warms exactly
the manifest's shapes before ``/readyz`` flips, instead of the whole
bucket vocabulary. The port runs every shape eagerly, so warming a shape
runs it once (the caching allocator primed, the kernels' libraries
loaded) where the JAX package compiles it.

Manifest anatomy (``warmup_manifest.json``; the JAX package's format 1,
so a file written by either package loads in the other)::

    {"format": 1, "written": <unix>, "entries": [
      {"plane": "predict",            "model": "bert", "shape": [8],
       "count": 4131, "last_seen": <unix>},
      {"plane": "generation.prefill", "model": "gpt",  "shape": [16], ...},
      {"plane": "generation.decode",  "model": "gpt",  "shape": [2, 64], ...}]}

Bounded: at ``max_entries`` distinct (plane, model, shape) keys the
least recently seen entry is evicted. Rewrites are a tmp sibling and
``os.replace``: a kill mid-write leaves the previous complete manifest,
and a torn file loads as empty.

A manifest with no entries for a model changes nothing: warmup falls
back to the full bucket vocabulary. A manifest that under-covers shifted
traffic shows as ``warmup_recompiles_after_warm_total`` (a shape first
run after warm, the eager counterpart of a compile after warmup).

``resolve_warmup_manifest(None)`` reads ``DL4J_TPU_WARMUP_MANIFEST``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ENV_WARMUP_MANIFEST = "DL4J_TPU_WARMUP_MANIFEST"

PLANE_PREDICT = "predict"
PLANE_PREFILL = "generation.prefill"
PLANE_DECODE = "generation.decode"

_FORMAT = 1


def _metrics():
    from deeplearning4j_tpu_torch.observability.metrics import (
        warmstart_metrics_or_none,
    )

    return warmstart_metrics_or_none()


class WarmupManifest:
    """Bounded live record of the (plane, model, shape) traffic mix.

    Thread-safe: ``note_*`` fire from serving worker threads (once per
    dispatched batch / decode step, not per request). A NEW shape saves
    synchronously (bounded by ``max_entries`` total over the process's
    life — restart robustness wants it on disk before a crash can lose
    it); the periodic count-refresh rewrite (every ``autosave_every``
    notes) runs on a one-shot background thread so the decode/dispatch
    hot path never waits on file IO beyond a dict update.
    """

    def __init__(self, path: Optional[str | Path] = None, *,
                 max_entries: int = 256, autosave_every: int = 64,
                 min_save_interval_s: float = 10.0):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.path = Path(path) if path is not None else None
        self.max_entries = int(max_entries)
        self.autosave_every = max(1, int(autosave_every))
        # periodic (count-refresh) rewrites are additionally time-
        # floored: a stable shape set under steady traffic must not
        # rewrite an unchanged-but-for-counts file several times a
        # second forever. New-shape saves ignore the floor — durability
        # of a first sighting is the manifest's whole job.
        self.min_save_interval_s = float(min_save_interval_s)
        self._lock = threading.Lock()
        # (plane, model, shape-tuple) -> {"count": int, "last_seen": float}
        self._entries: Dict[Tuple[str, str, Tuple[int, ...]], dict] = {}
        self._notes_since_save = 0
        self._save_inflight = False
        self._last_save_t = 0.0
        if self.path is not None and self.path.is_file():
            self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self):
        try:
            doc = json.loads(self.path.read_text())
            rows = doc.get("entries", [])
        except Exception:  # noqa: BLE001 — a torn manifest = empty: the
            return         # live mix re-derives it within minutes
        for row in rows:
            try:
                key = (str(row["plane"]), str(row["model"]),
                       tuple(int(x) for x in row["shape"]))
                self._entries[key] = {
                    "count": int(row.get("count", 1)),
                    "last_seen": float(row.get("last_seen", 0.0))}
            except Exception:  # noqa: BLE001 — skip malformed rows
                continue
        self._evict_to_cap()

    def _evict_to_cap(self):
        while len(self._entries) > self.max_entries:
            oldest = min(self._entries,
                         key=lambda k: self._entries[k]["last_seen"])
            del self._entries[oldest]

    def save(self) -> bool:
        """Atomic rewrite; returns False (and stays quiet) when no path
        is configured or the write fails — recording traffic must never
        fail serving."""
        if self.path is None:
            return False
        with self._lock:
            rows = [{"plane": p, "model": m, "shape": list(s),
                     "count": rec["count"], "last_seen": rec["last_seen"]}
                    for (p, m, s), rec in sorted(self._entries.items())]
            self._notes_since_save = 0
            self._last_save_t = time.monotonic()
        try:
            from deeplearning4j_tpu_torch.serde.checkpoint import (
                atomic_write_text,
            )

            self.path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_text(self.path, json.dumps(
                {"format": _FORMAT, "written": time.time(),
                 "entries": rows}, indent=2))
        except Exception:  # noqa: BLE001
            return False
        wm = _metrics()
        if wm is not None:
            wm.manifest_writes_total.inc()
        return True

    # -- recording -----------------------------------------------------------

    def _note(self, plane: str, model: str, shape: Tuple[int, ...]):
        with self._lock:
            rec = self._entries.get((plane, model, shape))
            fresh = rec is None
            if fresh:
                rec = self._entries[(plane, model, shape)] = {
                    "count": 0, "last_seen": time.time()}
                self._evict_to_cap()
            rec["count"] += 1
            rec["last_seen"] = time.time()
            self._notes_since_save += 1
            periodic = self._notes_since_save >= self.autosave_every
            n_entries = len(self._entries)
        wm = _metrics()
        if wm is not None:
            wm.manifest_entries.set(float(n_entries))
        if fresh:
            self.save()
        elif periodic:
            self._autosave()

    def _autosave(self):
        """Periodic rewrite off the caller's (hot) thread; at most one
        in flight and at most one per ``min_save_interval_s`` — a slow
        disk costs one parked daemon thread, never a stalled decode
        step, and a stable shape set never causes a rewrite storm."""
        if self.path is None:
            return
        with self._lock:
            if self._save_inflight or (
                    time.monotonic() - self._last_save_t
                    < self.min_save_interval_s):
                return
            self._save_inflight = True

        def run():
            try:
                self.save()
            finally:
                with self._lock:
                    self._save_inflight = False

        threading.Thread(target=run, daemon=True,
                         name="warmup-manifest-save").start()

    def note_batch(self, model: str, bucket: int):
        """One dispatched predict-plane batch landed in ``bucket``."""
        self._note(PLANE_PREDICT, model, (int(bucket),))

    def note_prefill(self, model: str, bucket: int):
        self._note(PLANE_PREFILL, model, (int(bucket),))

    def note_decode(self, model: str, slot_bucket: int, kv_bucket: int):
        self._note(PLANE_DECODE, model,
                   (int(slot_bucket), int(kv_bucket)))

    # -- consumption ---------------------------------------------------------

    def _shapes(self, plane: str, model: str) -> List[Tuple[int, ...]]:
        with self._lock:
            return sorted(s for (p, m, s) in self._entries
                          if p == plane and m == model)

    def predict_buckets(self, model: str) -> Optional[List[int]]:
        """Observed predict buckets for ``model``, ascending; None when
        the manifest has nothing for it (caller falls back to the full
        bucket vocabulary)."""
        shapes = self._shapes(PLANE_PREDICT, model)
        return [s[0] for s in shapes] if shapes else None

    def prefill_buckets(self, model: str) -> Optional[List[int]]:
        shapes = self._shapes(PLANE_PREFILL, model)
        return [s[0] for s in shapes] if shapes else None

    def decode_pairs(self, model: str) -> Optional[List[Tuple[int, int]]]:
        shapes = self._shapes(PLANE_DECODE, model)
        return [(s[0], s[1]) for s in shapes] if shapes else None

    def entries(self) -> List[dict]:
        with self._lock:
            return [{"plane": p, "model": m, "shape": list(s),
                     "count": rec["count"], "last_seen": rec["last_seen"]}
                    for (p, m, s), rec in sorted(self._entries.items())]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def describe(self) -> dict:
        return {"path": str(self.path) if self.path is not None else None,
                "entries": len(self), "max_entries": self.max_entries}


def resolve_warmup_manifest(manifest=None) -> Optional[WarmupManifest]:
    """``None`` → ``DL4J_TPU_WARMUP_MANIFEST`` env (or None when unset),
    a path → a manifest over it, a ``WarmupManifest`` → itself,
    ``False`` → explicitly disabled."""
    if manifest is False:
        return None
    if isinstance(manifest, WarmupManifest):
        return manifest
    if manifest is None:
        manifest = os.environ.get(ENV_WARMUP_MANIFEST) or None
        if manifest is None:
            return None
    return WarmupManifest(manifest)


class WarmupProgress:
    """Shared warmup progress the ``/readyz`` 503 body reports:
    ``{warmed: k, total: n, retry_after_ms}``. ``retry_after_ms`` is
    remaining-shapes x a per-shape EWMA of what warming has cost so far
    (a conservative 250 ms/shape before the first sample)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0
        self.warmed = 0
        self._ewma_s: Optional[float] = None
        self.active = False

    def begin(self, total: int):
        with self._lock:
            self.total = int(total)
            self.warmed = 0
            self._ewma_s = None
            self.active = True

    def note(self, seconds: float):
        with self._lock:
            self.warmed += 1
            s = max(0.0, float(seconds))
            self._ewma_s = s if self._ewma_s is None else \
                0.5 * self._ewma_s + 0.5 * s

    def finish(self):
        with self._lock:
            self.active = False

    def snapshot(self) -> dict:
        with self._lock:
            remaining = max(0, self.total - self.warmed)
            per_shape = self._ewma_s if self._ewma_s is not None else 0.25
            return {
                "warmed": self.warmed,
                "total": self.total,
                "retry_after_ms": round(min(
                    120000.0, max(50.0, remaining * per_shape * 1000.0)),
                    1),
            }
