"""The port's metrics plane on the CPU, held against the JAX package.

The same instrument operations render byte-identical Prometheus text and
equal JSON in both packages (the registries, the serving, cache and
warmstart bundles, escaping, non-finite values, exemplars under the
negotiated OpenMetrics format), and registration is as strict. Then a
``GET /metrics`` scrape of the port's ``ModelServer`` after predict and
prefix-hit generate traffic parses, and its ``generation_ttft`` count
and prefix hit counter equal the engine's own counts; ``/debug/
generation`` and ``/debug/flightrecorder`` answer.
"""

import json
import re
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from deeplearning4j_tpu.observability import flightrecorder as jfr
from deeplearning4j_tpu.observability import metrics as jom
from deeplearning4j_tpu.serving.cache import CacheMetrics as JaxCacheMetrics
from deeplearning4j_tpu.serving.metrics import (
    ServingMetrics as JaxServingMetrics,
)
from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
from deeplearning4j_tpu_torch.observability import flightrecorder as fr
from deeplearning4j_tpu_torch.observability import metrics as om
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.serving import (
    GenerationEngine,
    ModelRegistry,
    ModelServer,
    ServingClient,
    spec,
)
from deeplearning4j_tpu_torch.serving.cache import CacheMetrics
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ops(mod):
    """One sequence of instrument operations on a fresh registry of the
    package ``mod`` (its observability.metrics)."""
    r = mod.MetricsRegistry()
    c = r.counter("requests_total", 'Requests "served"\\n by code.',
                  ("model", "code"), namespace="demo")
    g = r.gauge("queue_depth", "Queue depth.")
    h = r.histogram("latency_seconds", "Latency.", ("model",))
    o = r.histogram("occupancy", "Rows over bucket.", ("model",),
                    buckets=mod.OCCUPANCY_BUCKETS)
    c.inc(model='bert"x', code="200")
    c.inc(3, model="bert\\y\nz", code="503")
    g.set(7)
    g.dec(2.5)
    g.inc()
    for v, tid in ((0.0004, "a"), (0.03, None), (7.0, "b"), (100.0, None),
                   (float("nan"), None)):
        h.observe(v, model="gpt", exemplar_trace_id=tid)
    o.observe(0.5, model="gpt")
    o.observe(1.0, model="gpt")
    r.gauge("weird", "Non-finite values.").set(float("inf"))
    return r


def _strip_exemplar_time(text):
    return re.sub(r"(# \{trace_id=\"[^\"]*\"\} \S+) \S+", r"\1 T", text)


def _json_without_time(doc):
    for fam in doc["metrics"]:
        for s in fam["samples"]:
            for ex in s.get("exemplars", {}).values():
                ex.pop("t")
    return json.loads(json.dumps(doc, default=str).replace("NaN", '"NaN"'))


def test_the_same_operations_render_the_same_exposition():
    jr, tr = _ops(jom), _ops(om)
    assert tr.render_text() == jr.render_text()
    assert "# {" not in tr.render_text()  # no exemplar in the classic text
    assert _strip_exemplar_time(tr.render_text(openmetrics=True)) == \
        _strip_exemplar_time(jr.render_text(openmetrics=True))
    assert tr.render_text(openmetrics=True).endswith("# EOF\n")
    assert _json_without_time(tr.render_json()) == \
        _json_without_time(jr.render_json())
    assert om.render_text_multi([tr, om.MetricsRegistry()]) == \
        jom.render_text_multi([jr, jom.MetricsRegistry()])


def _shared_families(jreg, treg):
    """The instruments of the JAX registry ``jreg`` that the port's
    ``treg`` also registers, as a registry to render: the JAX bundles
    also carry the families of planes the port has not yet."""
    names = set(treg.names())
    assert names <= set(jreg.names())
    return SimpleNamespace(instruments=lambda: [
        i for i in jreg.instruments() if i.name in names])


def test_the_bundles_render_the_same_families():
    """ServingMetrics with the cache families on its registry, and the
    warmstart bundle, fed the same way in both packages: each family the
    port registers renders as the JAX package's."""
    out = []
    for metrics_mod, serving_cls, cache_cls in (
            (jom, JaxServingMetrics, JaxCacheMetrics),
            (om, ServingMetrics, CacheMetrics)):
        s = serving_cls()
        cm = cache_cls(s.registry)
        s.generation_ttft.observe(0.02, model="gpt")
        s.generation_tokens_total.inc(5, model="gpt")
        s.shed_total.inc(model="bert", reason="queue_full")
        s.batch_occupancy.observe(0.75, model="bert")
        cm.prefix_requests_total.inc(model="gpt", outcome="hit")
        cm.prefix_bytes.set(1 << 20, model="gpt")
        w = metrics_mod.WarmstartMetrics(metrics_mod.MetricsRegistry())
        w.warmup_shapes_total.inc(plane="generation", source="manifest")
        w.recompiles_after_warm_total.inc(plane="predict")
        out.append((s.registry, w.registry))
    (js, jw), (ts, tw) = out
    for jreg, treg in ((js, ts), (jw, tw)):
        shared = _shared_families(jreg, treg)
        assert treg.render_text() == jom.render_text_multi([shared])
        assert treg.render_json() == jom.render_json_multi([shared])
    assert {"generation_ttft_seconds", "serving_shed_total",
            "cache_prefix_requests_total"} <= set(ts.names())
    assert {"warmup_shapes_total",
            "warmup_recompiles_after_warm_total"} <= set(tw.names())


def test_registration_is_strict_and_negotiation_is_the_same():
    for mod in (jom, om):
        r = mod.MetricsRegistry()
        r.histogram("lat", "h")
        with pytest.raises(ValueError, match="duplicate"):
            r.counter("lat_count", "c")
        with pytest.raises(ValueError):
            r.counter("bad name", "c")
    for accept in (None, "text/plain", "application/openmetrics-text",
                   "application/openmetrics-text; version=1.0.0, "
                   "text/plain;q=0.5", "APPLICATION/OPENMETRICS-TEXT"):
        assert om.wants_openmetrics(accept) == jom.wants_openmetrics(accept)


def test_flight_recorder_dumps_the_same_events():
    dumps = []
    for mod in (jfr, fr):
        rec = mod.FlightRecorder(capacity=2)
        rec.record("generation.join", req=1, kind="x")
        rec.record("generation.leave", req=1)
        rec.record("generation.join", req=2)
        d = rec.dump()
        for e in d["events"]:
            e.pop("t")
        dumps.append(d)
    assert dumps[0] == dumps[1]
    assert dumps[1]["dropped_total"] == 1 and dumps[1]["count"] == 2


# -- /metrics of the port's server ----------------------------------------------

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse(text):
    """A Prometheus text document → {(name, frozenset(labels)): value};
    raises on a line that is neither a comment nor a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"not a sample line: {line!r}")
        labels = frozenset(_LABEL.findall(m.group(3) or ""))
        out[(m.group(1), labels)] = float(m.group(4))
    return out


def _nsp(v, x):
    return torch.zeros((x.shape[0], 2)) + v["p"]


@pytest.fixture(scope="module")
def served():
    # a fresh ring: another file's engines in this process name theirs
    # "gpt" too
    fr.set_flight_recorder(None)
    jm = jax_gpt_tiny()
    jv = jax.tree_util.tree_map(np.asarray, jm.init(seed=2))
    tm = gpt_tiny(device="cpu")
    tm.load_variables(variables_from_numpy(jv))
    reg = ModelRegistry()
    reg.register("clf", _nsp, {"p": torch.tensor(0.5)},
                 input_spec=spec((4,)), max_batch_size=4, devices=["cpu"])
    engine = GenerationEngine(tm, tm.variables(), num_slots=2, max_len=32,
                              max_new_tokens=3, min_prompt_bucket=8,
                              temperature=0.0, prefix_cache=True)
    srv = ModelServer(reg, port=0, generators={"gpt": engine},
                      warmup_manifest=False)
    srv.start(warm=True)
    try:
        yield srv, engine, ServingClient(srv.url, timeout=60)
    finally:
        srv.stop()


def test_a_scrape_after_traffic_agrees_with_the_engine(served):
    srv, engine, client = served
    r = np.random.default_rng(9)
    shared = r.integers(0, 128, 8)
    for n in (2, 3, 1, 4):
        prompt = np.concatenate([shared, r.integers(0, 128, n)])
        assert client.generate_tokens("gpt", prompt)["n_tokens"] == 3
    client.predict("clf", np.zeros((3, 4), np.float32))
    text = client.metrics_text()
    samples = _parse(text)
    model = frozenset({("model", "gpt")})
    ttft_count = samples[("generation_ttft_seconds_count", model)]
    streams = [e for e in fr.get_flight_recorder().events(
        kinds=["generation.join"]) if e["data"]["model"] == "gpt"]
    assert ttft_count == len(streams) == 4
    d = engine.prefix_cache.describe()
    hit = frozenset({("model", "gpt"), ("outcome", "hit")})
    miss = frozenset({("model", "gpt"), ("outcome", "miss")})
    assert samples[("cache_prefix_requests_total", hit)] == d["hits"] == 3
    assert samples[("cache_prefix_requests_total", miss)] == d["misses"]
    assert samples[("cache_prefix_bytes", model)] == d["bytes"] > 0
    assert samples[("generation_tokens_total", model)] == 12
    assert samples[("generation_kv_bytes", model)] == engine.kv_bytes
    assert samples[("serving_requests_total", frozenset(
        {("model", "clf"), ("code", "200")}))] == 1
    assert samples[("serving_model_ready",
                    frozenset({("model", "clf")}))] == 1
    # the default registry rides the same scrape
    assert "warmup_shapes_total" in text
    assert client.metrics_json()["metrics"]
    req = urllib.request.Request(
        srv.url + "/metrics",
        headers={"Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(req) as resp:
        assert "openmetrics" in resp.headers["Content-Type"]
        assert resp.read().decode().endswith("# EOF\n")


def test_debug_routes_answer(served):
    srv, engine, client = served
    with urllib.request.urlopen(srv.url + "/debug/generation") as resp:
        body = json.loads(resp.read())
    assert body["engines"]["gpt"]["prefix_cache"]["model"] == "gpt"
    with urllib.request.urlopen(
            srv.url + "/debug/flightrecorder?seconds=3600") as resp:
        dump = json.loads(resp.read())
    kinds = {e["kind"] for e in dump["events"]}
    assert "generation.warmup" in kinds
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(srv.url + "/debug/flightrecorder?seconds=x")
    assert e.value.code == 400
