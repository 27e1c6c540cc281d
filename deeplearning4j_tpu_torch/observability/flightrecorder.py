"""Black-box flight recorder: the last N seconds of *events*, always on
(↔ deeplearning4j_tpu/observability/flightrecorder.py, stdlib only).

A bounded, thread-safe ring of structured events that the serving layers
feed (generation joins, warmups and shapes first run after warm; prefix
slab inserts and evictions; server warmup completion), plus compact
registry snapshots, so the timeline around an incident can be read from
the ring alone. ``ModelServer`` serves it at ``GET
/debug/flightrecorder?seconds=N``.

``record_event`` is one dict build and a deque append under a lock.
``set_recording(False)`` is the recorder's own kill switch, apart from
``metrics.set_enabled``.

Stdlib only; imports nothing but ``observability.metrics``, lazily, for
snapshots.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

DEFAULT_CAPACITY = 4096
# cap on distinct series a registry snapshot event may carry — a snapshot
# must stay one compact ring entry, not a full scrape
SNAPSHOT_SERIES_CAP = 256


def _identity_fields() -> dict:
    """Worker identity stamped onto every event envelope when this
    process runs under a cluster supervisor (``DL4J_TPU_WORKER_ID``
    armed) — merged cluster dossiers attribute events without guessing
    which ring they came from. Empty (no extra keys) standalone."""
    wid = os.environ.get("DL4J_TPU_WORKER_ID")
    if wid is None:
        return {}
    try:
        return {"worker": int(wid),
                "generation": int(
                    os.environ.get("DL4J_TPU_GENERATION", "1") or 1)}
    except ValueError:
        return {}


class FlightRecorder:
    """Bounded ring of ``{"t", "kind", "data"}`` events, oldest evicted.

    ``data`` is nested (never merged into the envelope) so producer keys
    can never clobber ``t``/``kind``. Eviction is counted
    (``dropped_total``) — a dump that lost history says so.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()

    def record(self, kind: str, /, **data) -> dict:
        """Append one event; returns it (already enveloped). ``kind`` is
        positional-only so a producer may carry ``kind``/``t`` keys in
        its data payload. Under a cluster supervisor the envelope also
        carries ``worker``/``generation`` (identity lives in the
        envelope, not ``data``, so producer keys can't clobber it)."""
        ev = {"t": time.time(), "kind": kind,
              **_identity_fields(), "data": data}
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)
        return ev

    @property
    def dropped_total(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self, *, last_seconds: Optional[float] = None,
               kinds: Optional[Iterable[str]] = None,
               max_events: Optional[int] = None) -> List[dict]:
        """Snapshot of the ring, oldest first, optionally windowed to the
        trailing ``last_seconds``, filtered to ``kinds``, and capped to
        the NEWEST ``max_events`` (the incident pipeline bounds its
        bundle artifact with this — when history is cut, it is the old
        end that goes)."""
        with self._lock:
            snap = list(self._events)
        if last_seconds is not None:
            cutoff = time.time() - last_seconds
            snap = [e for e in snap if e["t"] >= cutoff]
        if kinds is not None:
            want = set(kinds)
            snap = [e for e in snap if e["kind"] in want]
        if max_events is not None and len(snap) > max_events:
            snap = snap[-max_events:]
        return snap

    def dump(self, last_seconds: Optional[float] = None,
             kinds: Optional[Iterable[str]] = None,
             max_events: Optional[int] = None) -> dict:
        """The black-box dump: JSON-serializable, self-describing."""
        evs = self.events(last_seconds=last_seconds, kinds=kinds,
                          max_events=max_events)
        out = {
            "capacity": self.capacity,
            "dropped_total": self.dropped_total,
            "window_seconds": last_seconds,
            "count": len(evs),
            "events": evs,
        }
        ident = _identity_fields()
        if ident:
            try:
                nw = int(os.environ.get("DL4J_TPU_NUM_WORKERS", "1") or 1)
            except ValueError:
                nw = 1
            out["worker_identity"] = dict(ident, num_workers=nw)
        return out

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0

    # -- periodic registry snapshots ----------------------------------------

    def snapshot_registries(self, registries=None) -> dict:
        """Record one compact ``metrics.snapshot`` event: every counter /
        gauge family summed over its label sets (histograms contribute
        their ``_count``). The SLO evaluator calls this each tick, so the
        ring carries a coarse metric timeline between discrete events."""
        from deeplearning4j_tpu_torch.observability import metrics as _m

        if registries is None:
            registries = [_m.default_registry()]
        series: Dict[str, float] = {}
        for reg in registries:
            for inst in reg.instruments():
                if len(series) >= SNAPSHOT_SERIES_CAP:
                    break
                doc = inst.to_json()
                if doc["type"] in ("counter", "gauge"):
                    series[doc["name"]] = float(
                        sum(s["value"] for s in doc["samples"]))
                elif doc["type"] == "histogram":
                    series[doc["name"] + "_count"] = float(
                        sum(s["count"] for s in doc["samples"]))
        return self.record("metrics.snapshot", series=series,
                           truncated=len(series) >= SNAPSHOT_SERIES_CAP)


# -- process-global recorder --------------------------------------------------

_RECORDER = FlightRecorder()
_RECORDING = True


def get_flight_recorder() -> FlightRecorder:
    """The process-global ring every built-in producer feeds."""
    return _RECORDER


def set_flight_recorder(rec: Optional[FlightRecorder]) -> FlightRecorder:
    """Swap the global recorder (tests); None installs a fresh ring."""
    global _RECORDER
    _RECORDER = rec if rec is not None else FlightRecorder()
    return _RECORDER


def set_recording(flag: bool):
    """Recorder kill switch (independent of ``metrics.set_enabled`` so the
    bench can price the recorder alone)."""
    global _RECORDING
    _RECORDING = bool(flag)


def recording_enabled() -> bool:
    return _RECORDING


def record_event(kind: str, /, **data) -> Optional[dict]:
    """The one-liner producers call; no-op (returns None) when recording
    is switched off."""
    if not _RECORDING:
        return None
    return _RECORDER.record(kind, **data)
