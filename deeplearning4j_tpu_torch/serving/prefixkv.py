"""Prefix-KV reuse: shared immutable KV slabs for common prompt prefixes
(↔ deeplearning4j_tpu/serving/prefixkv.py).

Shared-system-prompt traffic pays the same prefill over and over: every
request whose prompt starts with the deployment's preamble recomputes
that preamble's K/V before its first token. After a normal prefill the
generation engine captures the slot's KV columns for the longest
prompt-bucket-aligned prefix and publishes them here as an immutable
slab; a later request whose prompt starts with the same tokens *grafts*
the slab into its decode slot (one copy per layer's K and V) and feeds
only its suffix through the warmed single-row decode step.

What it costs today: on an H100 a hit is slower to its first token
than a miss, and shared-prompt traffic is served slower with the store
than without it (``chip_smoke.py``'s ``gpt_prefix_serve`` times both on
the same requests). The graft itself is cheap; the suffix feed is one
eager, host-bound decode step a token, where a miss prefills its whole
prompt at once. The decode-step CUDA graph (ROADMAP queue 1 item 1) is
what would make a graft pay.

Where the slabs live: on the engine's device (the card on the main
path), as clones of the slot's slab row, so a graft is a device-to-device
copy. The JAX package keeps host copies; the same bytes (per layer, K and
V of shape ``(heads, P, head_dim)`` in the slab's dtype) count against
``max_bytes`` either way.

Copy-on-extend for free: slot rows are per-request copies, so decode
writes land in the slot, never in the shared slab.

Sharing scope: slabs are keyed by (engine version, exact prefix tokens)
and shared across tenants: a hit requires knowing the tokens.

Pin/refcount: a graft in flight holds a pin; eviction (byte-bound LRU)
skips pinned entries, so a slab is never dropped mid-graft. The store's
lock is a ``threading.Lock`` where the JAX package takes
``analysis.lockcheck.make_lock`` (the sanitizer is ROADMAP queue 1
item 12).

Environment: ``DL4J_TPU_PREFIX_CACHE`` (on when 1/true/yes/on) and
``DL4J_TPU_PREFIX_CACHE_MAX_BYTES``, read by :func:`resolve_prefix_store`
when the engine is given ``prefix_cache=None``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.observability.flightrecorder import record_event
from deeplearning4j_tpu_torch.serving.cache import CacheMetrics

ENV_PREFIX_CACHE = "DL4J_TPU_PREFIX_CACHE"
ENV_PREFIX_CACHE_MAX_BYTES = "DL4J_TPU_PREFIX_CACHE_MAX_BYTES"

DEFAULT_PREFIX_MAX_BYTES = 256 << 20


def _digest(version: str, tokens: np.ndarray) -> str:
    h = hashlib.sha256(version.encode())
    h.update(np.ascontiguousarray(tokens, dtype=np.int64).tobytes())
    return h.hexdigest()


class PrefixEntry:
    """One immutable prefix slab: per-layer ``(k, v)`` tensors (or arrays)
    of shape ``(heads, P, head_dim)`` plus the exact token ids (kept so a
    digest collision can never graft the wrong prefix)."""

    __slots__ = ("key", "tokens", "kvs", "nbytes", "refs", "hits")

    def __init__(self, key: str, tokens: np.ndarray,
                 kvs: List[Tuple[np.ndarray, np.ndarray]]):
        self.key = key
        self.tokens = tokens
        self.kvs = kvs
        self.nbytes = int(sum(k.nbytes + v.nbytes for k, v in kvs))
        self.refs = 0
        self.hits = 0

    @property
    def length(self) -> int:
        return int(self.tokens.size)


class PrefixKVStore:
    """Refcounted, byte-bounded LRU store of shared prefix KV slabs."""

    def __init__(self, *, max_bytes: int = DEFAULT_PREFIX_MAX_BYTES,
                 min_tokens: int = 8, model: str = "model",
                 metrics: Optional[CacheMetrics] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if min_tokens < 1:
            raise ValueError(f"min_tokens must be >= 1, got {min_tokens}")
        self.max_bytes = int(max_bytes)
        self.min_tokens = int(min_tokens)
        self.model = model
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._insertions = 0
        self._evictions = 0

    def attach_metrics(self, metrics: CacheMetrics) -> None:
        self._metrics = metrics

    # -- lookup / pin ---------------------------------------------------------

    def acquire(self, version: str, prompt: np.ndarray,
                lengths: Sequence[int]) -> Optional[PrefixEntry]:
        """The longest stored prefix of ``prompt`` among the candidate
        ``lengths`` (the engine's prompt buckets), pinned. Candidates
        must leave at least one suffix token (the forced-decode feed
        needs an input token to produce the first sample's logits).
        Caller MUST :meth:`release` the returned entry."""
        prompt = np.asarray(prompt)
        entry = None
        for p in sorted(set(lengths), reverse=True):
            if p >= prompt.size or p < self.min_tokens:
                continue
            key = _digest(version, prompt[:p])
            with self._lock:
                e = self._entries.get(key)
                if e is not None and np.array_equal(
                        e.tokens, prompt[:p].astype(np.int64)):
                    e.refs += 1
                    e.hits += 1
                    self._hits += 1
                    self._entries.move_to_end(key)
                    entry = e
            if entry is not None:
                break
        m = self._metrics
        if entry is None:
            with self._lock:
                self._misses += 1
            if m is not None:
                m.prefix_requests_total.inc(model=self.model,
                                            outcome="miss")
            return None
        if m is not None:
            m.prefix_requests_total.inc(model=self.model, outcome="hit")
            m.prefix_tokens_reused_total.inc(entry.length,
                                             model=self.model)
        return entry

    def release(self, entry: PrefixEntry) -> None:
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    # -- insertion / eviction -------------------------------------------------

    def insert(self, version: str, tokens: np.ndarray,
               kvs: List[Tuple[np.ndarray, np.ndarray]]) -> bool:
        """Publish one prefix slab (idempotent — a concurrent insert of
        the same prefix keeps the first copy). Evicts LRU *unpinned*
        entries past the byte bound; a slab larger than the whole
        bound is refused."""
        tokens = np.asarray(tokens, dtype=np.int64)
        if tokens.size < self.min_tokens:
            return False
        key = _digest(version, tokens)
        entry = PrefixEntry(key, tokens, kvs)
        if entry.nbytes > self.max_bytes:
            return False
        evicted = 0
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self._insertions += 1
            while self._bytes > self.max_bytes:
                victim_key = next(
                    (k for k, e in self._entries.items() if e.refs == 0),
                    None)
                if victim_key is None:
                    break  # everything pinned: over-budget until release
                victim = self._entries.pop(victim_key)
                self._bytes -= victim.nbytes
                evicted += 1
            self._evictions += evicted
            self._report_locked()
        m = self._metrics
        if m is not None:
            m.prefix_insertions_total.inc(model=self.model)
            if evicted:
                m.prefix_evictions_total.inc(evicted, model=self.model,
                                             reason="lru")
        record_event("cache.prefix_insert", model=self.model,
                     tokens=entry.length, bytes=entry.nbytes)
        if evicted:
            record_event("cache.prefix_evict", model=self.model,
                         evicted=evicted, reason="lru")
        return True

    def has(self, version: str, tokens: np.ndarray) -> bool:
        key = _digest(version, np.asarray(tokens, dtype=np.int64))
        with self._lock:
            return key in self._entries

    def purge(self) -> int:
        with self._lock:
            n = len(self._entries)
            # pinned entries survive a purge: a graft in flight reads
            # its slab after this call returns
            doomed = [k for k, e in self._entries.items() if e.refs == 0]
            for k in doomed:
                self._bytes -= self._entries.pop(k).nbytes
            self._evictions += len(doomed)
            self._report_locked()
        m = self._metrics
        if m is not None and doomed:
            m.prefix_evictions_total.inc(len(doomed), model=self.model,
                                         reason="purge")
        if doomed:
            record_event("cache.prefix_evict", model=self.model,
                         evicted=len(doomed), reason="purge")
        return len(doomed) if n else 0

    def _report_locked(self) -> None:
        m = self._metrics
        if m is not None:
            m.prefix_entries.set(len(self._entries), model=self.model)
            m.prefix_bytes.set(self._bytes, model=self.model)

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def describe(self) -> dict:
        with self._lock:
            return {
                "model": self.model,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "min_tokens": self.min_tokens,
                "pinned": sum(1 for e in self._entries.values()
                              if e.refs > 0),
                "hits": self._hits,
                "misses": self._misses,
                "insertions": self._insertions,
                "evictions": self._evictions,
                "prefix_lengths": sorted(
                    {e.length for e in self._entries.values()}),
            }


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


def resolve_prefix_store(arg, *, model: str = "model",
                         metrics: Optional[CacheMetrics] = None,
                         ) -> Optional[PrefixKVStore]:
    """Engine-side construction policy: ``False`` disables, an instance
    passes through, ``True`` builds a default, ``None`` defers to the
    ``DL4J_TPU_PREFIX_CACHE`` env knob (byte bound from
    ``DL4J_TPU_PREFIX_CACHE_MAX_BYTES``). Default OFF: the engine warms
    the graft of every prompt bucket when a store is attached, so a
    store is an explicit opt-in."""
    if arg is False:
        return None
    if isinstance(arg, PrefixKVStore):
        if arg._metrics is None and metrics is not None:
            arg.attach_metrics(metrics)
        return arg
    if arg is None and not _env_flag(ENV_PREFIX_CACHE):
        return None
    if arg is not None and arg is not True:
        raise TypeError(
            "prefix_cache must be None, a bool, or a PrefixKVStore, "
            f"got {type(arg).__name__}")
    max_bytes = int(os.environ.get(ENV_PREFIX_CACHE_MAX_BYTES,
                                   DEFAULT_PREFIX_MAX_BYTES))
    return PrefixKVStore(max_bytes=max_bytes, model=model,
                         metrics=metrics)
