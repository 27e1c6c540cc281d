"""The serving instrument bundle (↔ deeplearning4j_tpu/serving/metrics.py).

:class:`ServingMetrics` with the families and label sets of the JAX
package's that the port's server, registry and generation engine feed; the instruments themselves live in
``observability/metrics.py`` and are re-exported here, with the caching
tier's :class:`~deeplearning4j_tpu_torch.serving.cache.CacheMetrics`.

``ServingMetrics`` defaults to its own registry (a process can run
several ``ModelServer``s and each counts its own traffic); the server's
``GET /metrics`` renders this bundle together with the process-global
default registry. The families of planes not ported yet (admission and
overload, tenants, brownout, deadlines, circuit breakers, worker
respawns; ROADMAP queue 1 item 9) come with those planes; each family
that is here renders as the JAX package's.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.observability.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    OCCUPANCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    render_json_multi,
    render_text_multi,
)
from deeplearning4j_tpu_torch.serving.cache import CacheMetrics  # noqa: F401

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "OCCUPANCY_BUCKETS",
    "CacheMetrics",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ServingMetrics",
    "default_registry",
    "render_json_multi",
    "render_text_multi",
]


class ServingMetrics:
    """The serving subsystem's instrument bundle, on one registry."""

    def __init__(self, registry: MetricsRegistry = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self.requests_total = r.counter(
            "serving_requests_total",
            "Requests by model and HTTP status code.", ("model", "code"))
        self.request_latency = r.histogram(
            "serving_request_latency_seconds",
            "End-to-end request latency (parse to response body).",
            ("model",))
        self.device_latency = r.histogram(
            "serving_device_latency_seconds",
            "On-device batch dispatch latency (measured in the "
            "ParallelInference worker).", ("model",))
        self.batch_occupancy = r.histogram(
            "serving_batch_occupancy",
            "rows/padded-bucket-rows per dispatched device batch "
            "(1.0 = no padding waste).", ("model",),
            buckets=OCCUPANCY_BUCKETS)
        self.shed_total = r.counter(
            "serving_shed_total",
            "Requests rejected without being served.", ("model", "reason"))
        self.model_ready = r.gauge(
            "serving_model_ready",
            "1 once the model's batch buckets are pre-compiled.", ("model",))
        # -- generative serving (serving/generation.py) --
        self.generation_requests_total = r.counter(
            "generation_requests_total",
            "Generation requests by model and outcome (completed | "
            "preempted | failed | shed | deadline | cancelled — "
            "cancelled means the CLIENT disconnected mid-stream and "
            "deliberately does not count against the generation-"
            "availability rule; deadline is the server missing the "
            "request's deadline and does).",
            ("model", "outcome"))
        self.generation_tokens_total = r.counter(
            "generation_tokens_total",
            "Tokens streamed to clients (prefill first-tokens plus "
            "decode-step tokens).", ("model",))
        self.generation_ttft = r.histogram(
            "generation_ttft_seconds",
            "Time-to-first-token: submit to the prefill-sampled first "
            "token entering the stream. Buckets carry OpenMetrics "
            "exemplars (the request's correlation id) under the "
            "negotiated openmetrics-text rendering.", ("model",))
        self.generation_latency = r.histogram(
            "generation_latency_seconds",
            "End-to-end generation stream latency: submit to the "
            "terminal outcome (completed/preempted/failed/deadline; "
            "client cancels excluded — the server never finished that "
            "stream). Buckets carry correlation-id exemplars under the "
            "OpenMetrics rendering.", ("model",))
        self.generation_decode_steps_total = r.counter(
            "generation_decode_steps_total",
            "Iteration-level decode steps dispatched (each serves every "
            "active slot once).", ("model",))
        self.generation_slot_occupancy = r.histogram(
            "generation_slot_occupancy",
            "active-slots/slot-bucket per dispatched decode step "
            "(1.0 = no padded slots).", ("model",),
            buckets=OCCUPANCY_BUCKETS)
        self.generation_active_slots = r.gauge(
            "generation_active_slots",
            "Sequences currently holding a decode slot.", ("model",))
        self.generation_queue_depth = r.gauge(
            "generation_queue_depth",
            "Generation requests waiting for a decode slot.", ("model",))
        self.generation_slot_limit = r.gauge(
            "generation_slot_limit",
            "Effective decode-slot cap (num_slots clamped by the AIMD "
            "overload limit).", ("model",))
        self.generation_preemptions_total = r.counter(
            "generation_preemptions_total",
            "Decode slots preempted, by the priority class of the "
            "victim.", ("model", "priority"))
        self.generation_kv_bytes = r.gauge(
            "generation_kv_bytes",
            "Bytes preallocated in the bucketed KV slab pool.",
            ("model",))
        self.generation_max_new_tokens = r.gauge(
            "generation_max_new_tokens",
            "Current effective max_new_tokens cap (shrunk by the "
            "generation brownout rung under overload).", ("model",))
    def render_text(self, *, openmetrics: bool = False) -> str:
        return self.registry.render_text(openmetrics=openmetrics)

    def render_json(self) -> dict:
        return self.registry.render_json()
