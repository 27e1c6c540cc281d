"""Shared metrics core: Counter / Gauge / Histogram on one registry
(↔ deeplearning4j_tpu/observability/metrics.py, stdlib only).

A copy of the JAX package's module, so that a scrape reads the same from
either package: the same families, label sets, HELP texts and exposition
(the same instrument operations render byte-identical Prometheus text).
Every layer feeds ONE process-global default registry; ``ModelServer``'s
``GET /metrics`` renders its serving bundle together with it.

Exposition follows the Prometheus text format: ``# HELP``/``# TYPE``
headers (HELP text escaped: backslash and newline), cumulative
``_bucket{le=...}`` series, ``_sum``/``_count``. A JSON twin serves
scripts and tests. Exemplars (kept per histogram bucket by
``observe(..., exemplar_trace_id=)``) appear only in the JSON twin and in
the OpenMetrics rendering a client negotiates via ``Accept:
application/openmetrics-text``, never in the classic text format, whose
grammar forbids them.

Registration is strict: a second instrument under an already-reserved
name (a histogram's derived ``_bucket``/``_sum``/``_count`` names
included) raises, naming the prior owner.

Thread-safety: every mutation takes the instrument's lock.
``set_enabled(False)`` is the kill switch the instrumented paths consult.

Of the JAX package's bundles only ``WarmstartMetrics`` is here, with the
warmup and manifest families that serving/warmstart.py,
serving/registry.py and serving/generation.py feed. The training,
resilience, checkpoint and sanitizer bundles, and the compile-cache
families, come with the layers that feed them (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_INF = float("inf")

# Latency buckets spanning sub-ms host overhead to multi-second cold paths.
DEFAULT_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                           0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# rows/bucket of a dispatched device batch — 1.0 means no padding waste.
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# XLA compiles: tens of ms (cache hit) to minutes (cold BERT via a relay).
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0)

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Content types the /metrics endpoints negotiate between. Exemplars are
# an *OpenMetrics* construct: a classic-format parser treats the
# mid-line '#' as garbage and rejects the whole scrape, so the default
# (classic) rendering NEVER carries them — a client opts in via
# ``Accept: application/openmetrics-text`` and gets the exemplar
# suffixes plus the mandatory ``# EOF`` trailer.
CONTENT_TYPE_TEXT = "text/plain; version=0.0.4"
CONTENT_TYPE_OPENMETRICS = ("application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")


def wants_openmetrics(accept: Optional[str]) -> bool:
    """Did the request's Accept header negotiate OpenMetrics?

    Deliberately conservative: OpenMetrics only when the client asks
    for it WITHOUT also accepting the classic text format. A stock
    Prometheus server (>= 2.49) advertises both media types with
    q-values and reliably parses classic, so it gets the classic
    document — serving a type the client listed is valid content
    negotiation, and this hand-rolled OpenMetrics variant is
    "OpenMetrics-style" (counter families keep their ``_total`` names)
    rather than strictly spec-compliant, so it is reserved for clients
    that explicitly ask for it alone (curl, tests, exemplar-aware
    tooling). Media types compare case-insensitively (RFC 9110)."""
    accept = (accept or "").lower()
    if "application/openmetrics-text" not in accept:
        return False
    return "text/plain" not in accept


def _fmt(v: float) -> str:
    f = float(v)
    # NaN/±Inf are legal Prometheus sample values; crashing on them here
    # would poison EVERY future scrape of the registry over one bad
    # observation (f == int(f) raises on non-finite floats).
    if f != f:
        return "NaN"
    if f == _INF:
        return "+Inf"
    if f == -_INF:
        return "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc_label(v) -> str:
    """Label-value escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(v) -> str:
    """HELP-text escaping per the exposition format: backslash and
    newline only (quotes are legal in help text)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._data: Dict[Tuple[str, ...], object] = {}

    def sample_names(self) -> Tuple[str, ...]:
        """Every exposition sample-line name this instrument owns — the
        registry reserves all of them to reject cross-family collisions."""
        return (self.name,)

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if not labels and not self.labelnames:
            return ()  # fast path: label-less hot-loop instruments
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [f'{k}="{_esc_label(v)}"'
                 for k, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def remove(self, **labels) -> bool:
        """Drop one label series from the family (e.g. the federation
        layer pruning a departed worker's gauges when the cohort
        shrinks); returns True when the series existed."""
        key = self._key(labels)
        with self._lock:
            return self._data.pop(key, None) is not None


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        key = self._key(labels)
        with self._lock:
            self._data[key] = self._data.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._data.get(self._key(labels), 0.0))

    def render(self, *, openmetrics: bool = False) -> List[str]:
        with self._lock:
            return [f"{self.name}{self._label_str(k)} {_fmt(v)}"
                    for k, v in sorted(self._data.items())]

    def to_json(self) -> dict:
        with self._lock:
            samples = [{"labels": dict(zip(self.labelnames, k)), "value": v}
                       for k, v in sorted(self._data.items())]
        return {"name": self.name, "type": self.kind, "help": self.help,
                "samples": samples}


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            self._data[key] = float(value)

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets)) + (_INF,)

    def sample_names(self) -> Tuple[str, ...]:
        return (self.name, f"{self.name}_bucket", f"{self.name}_sum",
                f"{self.name}_count")

    def observe(self, value: float, *, exemplar_trace_id: Optional[str] = None,
                **labels):
        """Record one observation. ``exemplar_trace_id`` (OpenMetrics-
        style exemplars) keeps the LAST exemplar per bucket — a slow
        bucket in the scrape links straight to a trace id that actually
        landed in it (the serving path passes the request's correlation
        id)."""
        key = self._key(labels)
        with self._lock:
            st = self._data.get(key)
            if st is None:
                st = self._data[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0, "n": 0}
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["counts"][i] += 1
                    if exemplar_trace_id is not None:
                        st.setdefault("exemplars", {})[i] = (
                            str(exemplar_trace_id), float(value),
                            time.time())
                    break
            st["sum"] += float(value)
            st["n"] += 1

    def summary(self, **labels) -> Dict[str, float]:
        """{'count', 'sum', 'mean'} for one label set (0s when unseen)."""
        with self._lock:
            st = self._data.get(self._key(labels))
            if st is None:
                return {"count": 0, "sum": 0.0, "mean": 0.0}
            return {"count": st["n"], "sum": st["sum"],
                    "mean": st["sum"] / st["n"] if st["n"] else 0.0}

    def render(self, *, openmetrics: bool = False) -> List[str]:
        lines = []
        with self._lock:
            for key, st in sorted(self._data.items()):
                cum = 0
                exemplars = st.get("exemplars", {}) if openmetrics else {}
                for i, (b, c) in enumerate(zip(self.buckets, st["counts"])):
                    cum += c
                    le = 'le="%s"' % _fmt(b)
                    line = f"{self.name}_bucket{self._label_str(key, le)} {cum}"
                    ex = exemplars.get(i)
                    if ex is not None:
                        # OpenMetrics exemplar suffix on the bucket the
                        # observation landed in:
                        #   ... # {trace_id="<id>"} <value> <timestamp>
                        # (only under the negotiated OpenMetrics format —
                        # a classic parser errors on the mid-line '#')
                        tid, val, ts = ex
                        line += (f' # {{trace_id="{_esc_label(tid)}"}} '
                                 f"{_fmt(val)} {repr(round(ts, 3))}")
                    lines.append(line)
                lines.append(f"{self.name}_sum{self._label_str(key)} "
                             f"{_fmt(st['sum'])}")
                lines.append(f"{self.name}_count{self._label_str(key)} "
                             f"{st['n']}")
        return lines

    def to_json(self) -> dict:
        with self._lock:
            samples = []
            for key, st in sorted(self._data.items()):
                cum, bucket_map = 0, {}
                for b, c in zip(self.buckets, st["counts"]):
                    cum += c
                    bucket_map[_fmt(b)] = cum
                sample = {"labels": dict(zip(self.labelnames, key)),
                          "sum": st["sum"], "count": st["n"],
                          "buckets": bucket_map}
                if st.get("exemplars"):
                    sample["exemplars"] = {
                        _fmt(self.buckets[i]): {"trace_id": tid,
                                                "value": val, "t": ts}
                        for i, (tid, val, ts)
                        in sorted(st["exemplars"].items())}
                samples.append(sample)
        return {"name": self.name, "type": self.kind, "help": self.help,
                "samples": samples}


class MetricsRegistry:
    """A set of named instruments rendered together.

    ``namespace=`` on the constructors prefixes the metric name
    (``counter("steps_total", ..., namespace="train")`` registers
    ``train_steps_total``) — the one-registry-many-subsystems
    convention that keeps family names collision-free by layer.
    """

    def __init__(self):
        self._instruments: List[_Instrument] = []
        # every sample-line name any instrument exposes -> owning family
        self._reserved: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _add(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            for n in inst.sample_names():
                owner = self._reserved.get(n)
                if owner is not None:
                    raise ValueError(
                        f"duplicate metric registration: {inst.kind} "
                        f"{inst.name!r} would expose sample name {n!r}, "
                        f"already owned by instrument {owner!r} — metric "
                        "names must be unique per registry")
            for n in inst.sample_names():
                self._reserved[n] = inst.name
            self._instruments.append(inst)
        return inst

    @staticmethod
    def _full_name(name: str, namespace: Optional[str]) -> str:
        return f"{namespace}_{name}" if namespace else name

    def counter(self, name, help, labelnames=(), *,
                namespace: Optional[str] = None) -> Counter:
        return self._add(Counter(self._full_name(name, namespace), help,
                                 labelnames))

    def gauge(self, name, help, labelnames=(), *,
              namespace: Optional[str] = None) -> Gauge:
        return self._add(Gauge(self._full_name(name, namespace), help,
                               labelnames))

    def histogram(self, name, help, labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS, *,
                  namespace: Optional[str] = None) -> Histogram:
        return self._add(Histogram(self._full_name(name, namespace), help,
                                   labelnames, buckets))

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments)

    def names(self) -> List[str]:
        return [i.name for i in self.instruments()]

    def render_text(self, *, openmetrics: bool = False) -> str:
        return render_text_multi([self], openmetrics=openmetrics)

    def render_json(self) -> dict:
        return render_json_multi([self])


def render_text_multi(registries: Sequence[MetricsRegistry], *,
                      openmetrics: bool = False) -> str:
    """One exposition document over several registries (first wins on a
    family-name collision — how the serving bundle's private registry and
    the process default merge into one scrape).

    ``openmetrics=True`` renders the negotiated OpenMetrics variant:
    histogram buckets carry their exemplar suffixes and the document
    ends with the mandatory ``# EOF`` marker. The default (classic
    ``text/plain; version=0.0.4``) document never carries exemplars —
    they are invalid in that grammar and would fail the whole scrape.
    """
    out: List[str] = []
    seen = set()
    for reg in registries:
        for inst in reg.instruments():
            if inst.name in seen:
                continue
            seen.add(inst.name)
            out.append(f"# HELP {inst.name} {_esc_help(inst.help)}")
            out.append(f"# TYPE {inst.name} {inst.kind}")
            out.extend(inst.render(openmetrics=openmetrics))
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def render_json_multi(registries: Sequence[MetricsRegistry]) -> dict:
    out, seen = [], set()
    for reg in registries:
        for inst in reg.instruments():
            if inst.name in seen:
                continue
            seen.add(inst.name)
            out.append(inst.to_json())
    return {"metrics": out}


# -- process-global default registry ----------------------------------------

_DEFAULT = MetricsRegistry()
_BUNDLES: Dict[str, object] = {}
_RESET_HOOKS: List[Callable[[], None]] = []
_ENABLED = True
_state_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-global registry every built-in collector feeds; the
    ``/metrics`` endpoint renders it alongside the server's own bundle."""
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Replace the global registry with a fresh one (tests/bench): bundle
    singletons are dropped and re-create lazily on the new registry."""
    global _DEFAULT
    with _state_lock:
        _DEFAULT = MetricsRegistry()
        _BUNDLES.clear()
    for hook in list(_RESET_HOOKS):
        hook()
    return _DEFAULT


def register_reset_hook(fn: Callable[[], None]):
    """Run ``fn`` on every ``reset_default_registry`` (lets runtime.py
    drop its collector singleton without an import cycle)."""
    _RESET_HOOKS.append(fn)


def set_enabled(flag: bool):
    """Master switch for the built-in hot-path instrumentation."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def _bundle(key: str, factory):
    b = _BUNDLES.get(key)
    if b is None:
        with _state_lock:
            b = _BUNDLES.get(key)
            if b is None:
                b = _BUNDLES[key] = factory(_DEFAULT)
    return b


# -- built-in bundles (lazy singletons on the default registry) -------------


class WarmstartMetrics:
    """Cold-start robustness instruments: the traffic-derived warmup
    manifests (serving/warmstart.py) and the warm they drive.
    Process-global, as the JAX package's."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else default_registry()
        self.registry = r
        self.warmup_shapes_total = r.counter(
            "warmup_shapes_total",
            "Shapes AOT-compiled during warmup, by serving plane and "
            "shape source (manifest = the traffic-derived warmup "
            "manifest chose it, full = the closed bucket vocabulary).",
            ("plane", "source"))
        self.warmup_seconds = r.histogram(
            "warmup_seconds",
            "Per-shape warmup latency (compile + first dispatch).",
            ("plane",))
        self.manifest_entries = r.gauge(
            "warmup_manifest_entries",
            "Distinct (plane, model, shape) entries in the live warmup "
            "manifest.")
        self.manifest_writes_total = r.counter(
            "warmup_manifest_writes_total",
            "Atomic rewrites of the warmup-manifest file.")
        self.recompiles_after_warm_total = r.counter(
            "warmup_recompiles_after_warm_total",
            "Compiles observed AFTER a plane declared itself warm — "
            "the exact stall warmup exists to kill; the sentinel's "
            "recompile_after_warmup detector and the recompile-after-"
            "warmup burn-rate rule both gate this staying at zero.",
            ("plane",))


def get_warmstart_metrics() -> WarmstartMetrics:
    return _bundle("warmstart", WarmstartMetrics)


def warmstart_metrics_or_none() -> Optional[WarmstartMetrics]:
    """The warmstart bundle gated on the kill switch — the ONE guard
    every producer (registry, generation engine, warmup manifest)
    shares, so the telemetry-off contract lives here and not in three
    drifting copies."""
    return get_warmstart_metrics() if _ENABLED else None
