"""The caching tier's instrument bundle (↔ deeplearning4j_tpu/serving/cache.py).

Only :class:`CacheMetrics` is ported, with the JAX package's
``cache_prefix_*`` families and label sets, through which the prefix-KV
store (serving/prefixkv.py) reports. The exact-match response cache
(``ResponseCache``) keys its entries by model version and registry epoch
and is invalidated on deploy and rollback; it comes with the registry's
hot-swap (ROADMAP queue 1 item 9), and its ``cache_*`` families with it.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry


class CacheMetrics:
    """The cache tier's instrument bundle: the prefix-KV families,
    labelled by model (engine route names — a bounded, operator-chosen
    set)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        r = self.registry
        self.prefix_requests_total = r.counter(
            "cache_prefix_requests_total",
            "Prefix-KV lookups at generation prefill, by outcome "
            "(hit = a shared prefix slab was grafted instead of a "
            "full prefill).", ("model", "outcome"))
        self.prefix_insertions_total = r.counter(
            "cache_prefix_insertions_total",
            "Prefix KV slabs captured from completed prefills.",
            ("model",))
        self.prefix_evictions_total = r.counter(
            "cache_prefix_evictions_total",
            "Prefix slabs dropped, by reason (lru = byte bound; "
            "pinned entries are never evicted).", ("model", "reason"))
        self.prefix_entries = r.gauge(
            "cache_prefix_entries",
            "Prefix KV slabs currently held.", ("model",))
        self.prefix_bytes = r.gauge(
            "cache_prefix_bytes",
            "Bytes of shared prefix KV slabs.", ("model",))
        self.prefix_tokens_reused_total = r.counter(
            "cache_prefix_tokens_reused_total",
            "Prompt tokens whose prefill was skipped by grafting a "
            "shared prefix slab (the prefill-FLOP savings signal).",
            ("model",))


__all__ = ["CacheMetrics"]
