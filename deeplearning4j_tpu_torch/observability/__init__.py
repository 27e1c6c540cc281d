"""Telemetry core (↔ deeplearning4j_tpu.observability): what is ported.

- ``metrics``: Counter/Gauge/Histogram on a process-global default
  registry with Prometheus text, OpenMetrics and JSON exposition, and the
  lazy warmstart bundle (in the module); one scrape of a running ``ModelServer`` renders
  its serving bundle together with the default registry.
- ``flightrecorder``: the black-box ring of structured events the serving
  layers feed, served at ``GET /debug/flightrecorder``.

Not ported yet (ROADMAP queue 1 item 12): tracing, the request ledger,
the runtime collectors, SLO rules, the sentinel, incidents, federation,
and the training, resilience, checkpoint and sanitizer bundles.
"""

from deeplearning4j_tpu_torch.observability.flightrecorder import (
    FlightRecorder,
    get_flight_recorder,
    record_event,
    recording_enabled,
    set_flight_recorder,
    set_recording,
)
from deeplearning4j_tpu_torch.observability.metrics import (
    COMPILE_BUCKETS,
    CONTENT_TYPE_OPENMETRICS,
    CONTENT_TYPE_TEXT,
    DEFAULT_LATENCY_BUCKETS,
    OCCUPANCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    enabled,
    render_json_multi,
    render_text_multi,
    reset_default_registry,
    set_enabled,
    wants_openmetrics,
)

__all__ = [
    "COMPILE_BUCKETS",
    "CONTENT_TYPE_OPENMETRICS",
    "CONTENT_TYPE_TEXT",
    "DEFAULT_LATENCY_BUCKETS",
    "OCCUPANCY_BUCKETS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "enabled",
    "get_flight_recorder",
    "record_event",
    "recording_enabled",
    "render_json_multi",
    "render_text_multi",
    "reset_default_registry",
    "set_enabled",
    "set_flight_recorder",
    "set_recording",
    "wants_openmetrics",
]
