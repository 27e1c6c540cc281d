"""The port's warm start on the CPU, held against the JAX package.

``WarmupManifest``: the JAX package's file format 1 (a file written by
either package loads in the other), bounded LRU entries, atomic saves, a
torn file loading as empty, a save on a new shape. The same traffic
(predict batches through ``ModelRegistry``, prefill buckets and decode
pairs through ``GenerationEngine``) gives equal entries in both packages.
A manifest-restricted warm runs only the observed shapes, and the next
shape outside them counts one ``warmup_recompiles_after_warm_total``.
Both packages' ``ModelServer`` answer ``/readyz`` with a 503 progress
body while ``start(warm_async=True)`` warms, shed predicts meanwhile,
then turn 200.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.serving import ModelServer as JaxServer
from deeplearning4j_tpu.serving import NotReadyError as JaxNotReady
from deeplearning4j_tpu.serving import ServingClient as JaxClient
from deeplearning4j_tpu.serving import WarmupManifest as JaxManifest
from deeplearning4j_tpu.serving import spec as jax_spec
from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
from deeplearning4j_tpu_torch.observability import flightrecorder as fr
from deeplearning4j_tpu_torch.observability import metrics as om
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.serving import (
    GenerationEngine,
    ModelRegistry,
    ModelServer,
    NotReadyError,
    ServingClient,
    WarmupManifest,
    resolve_warmup_manifest,
    spec,
)
from deeplearning4j_tpu_torch.serving.warmstart import ENV_WARMUP_MANIFEST

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    om.reset_default_registry()
    fr.set_flight_recorder(None)
    yield
    om.reset_default_registry()
    fr.set_flight_recorder(None)


def _wm():
    return om.get_warmstart_metrics()


def _rows(m):
    return [(e["plane"], e["model"], e["shape"], e["count"])
            for e in m.entries()]


# -- the manifest ------------------------------------------------------------


def test_note_save_load_roundtrip(tmp_path):
    p = tmp_path / "wm.json"
    m = WarmupManifest(p, autosave_every=10_000)
    m.note_batch("bert", 8)
    m.note_batch("bert", 8)
    m.note_prefill("gpt", 16)
    m.note_decode("gpt", 2, 64)
    assert m.save()
    assert not list(tmp_path.glob("*.tmp"))  # atomic, no litter
    m2 = WarmupManifest(p)
    assert m2.predict_buckets("bert") == [8]
    assert m2.prefill_buckets("gpt") == [16]
    assert m2.decode_pairs("gpt") == [(2, 64)]
    assert m2.predict_buckets("nope") is None
    assert _rows(m2) == _rows(m)
    assert _wm().manifest_writes_total.value() >= 1.0
    assert m2.describe() == {"path": str(p), "entries": 3,
                             "max_entries": 256}


def test_bounded_lru_eviction():
    m = WarmupManifest(max_entries=3)
    for b in (1, 2, 4, 8):
        m.note_batch("m", b)
        time.sleep(0.002)  # distinct last_seen stamps
    assert len(m) == 3
    assert m.predict_buckets("m") == [2, 4, 8]  # bucket 1 was oldest


def test_torn_file_loads_as_empty(tmp_path):
    p = tmp_path / "wm.json"
    p.write_text('{"entries": [{"plane": "predi')
    assert len(WarmupManifest(p)) == 0
    assert len(JaxManifest(p)) == 0


def test_autosave_on_new_shape(tmp_path):
    p = tmp_path / "wm.json"
    m = WarmupManifest(p)
    m.note_batch("m", 4)  # a new shape saves at once
    assert json.loads(p.read_text())["entries"][0]["shape"] == [4]


def test_resolver_contract(tmp_path, monkeypatch):
    monkeypatch.delenv(ENV_WARMUP_MANIFEST, raising=False)
    assert resolve_warmup_manifest(None) is None
    assert resolve_warmup_manifest(False) is None
    m = WarmupManifest()
    assert resolve_warmup_manifest(m) is m
    assert resolve_warmup_manifest(str(tmp_path / "a.json")).path == \
        tmp_path / "a.json"
    monkeypatch.setenv(ENV_WARMUP_MANIFEST, str(tmp_path / "b.json"))
    assert resolve_warmup_manifest(None).path == tmp_path / "b.json"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_written_by_either_package_loads_in_the_other(tmp_path,
                                                             writer):
    p = tmp_path / "wm.json"
    first, second = ((JaxManifest, WarmupManifest) if writer == "jax"
                     else (WarmupManifest, JaxManifest))
    m = first(p, autosave_every=10_000)
    for _ in range(3):
        m.note_batch("bert", 4)
    m.note_batch("bert", 8)
    m.note_prefill("gpt", 16)
    m.note_decode("gpt", 1, 32)
    assert m.save()
    back = second(p)
    assert _rows(back) == _rows(m)
    assert back.predict_buckets("bert") == [4, 8]
    assert back.decode_pairs("gpt") == [(1, 32)]


# -- the same traffic in both packages ------------------------------------------


@pytest.fixture(scope="module")
def gpt_models():
    jm = jax_gpt_tiny()
    jv = jax.tree_util.tree_map(np.asarray, jm.init(seed=3))
    tm = gpt_tiny(device="cpu")
    tm.load_variables(variables_from_numpy(jv))
    return jm, jv, tm


def _engine_kw(**kw):
    return dict(dict(name="gpt", num_slots=2, max_len=32, max_new_tokens=4,
                     min_kv_bucket=16, min_prompt_bucket=8,
                     temperature=0.0, seed=0), **kw)


def _drive(engine, prompts, max_steps=100):
    streams = [engine.submit(p) for p in prompts]
    for _ in range(max_steps):
        engine._admit()
        engine._decode_once()
        if not engine._waiting and all(s is None for s in engine._slots):
            return [s.result(timeout=10)["tokens"] for s in streams]
    raise AssertionError("the engine did not finish its requests")


def _scale_jax(v, x):
    return jnp.zeros((x.shape[0], 1), jnp.float32) + v["scale"]


def _scale_torch(v, x):
    return torch.zeros((x.shape[0], 1)) + v["scale"]


def test_the_same_traffic_gives_equal_manifest_entries(gpt_models):
    jm, jv, tm = gpt_models
    jman, tman = JaxManifest(), WarmupManifest()
    # generation: prompts of buckets 8 and 16, two slots
    prompts = [np.arange(1, 4), np.arange(5, 17), np.arange(20, 29)]
    jeng = JaxEngine(jm, jv, **_engine_kw())
    jeng.attach_manifest(jman)
    teng = GenerationEngine(tm, tm.variables(), **_engine_kw())
    teng.attach_manifest(tman)
    assert _drive(teng, prompts) == _drive(jeng, prompts)
    # predict: live batches of 1, 3 and 2 rows (buckets 1, 4, 2) after a
    # warm whose own batches are not noted
    jreg, treg = JaxRegistry(), ModelRegistry()
    jreg.attach_manifest(jman)
    treg.attach_manifest(tman)
    je = jreg.register("scale", _scale_jax, {"scale": np.float32(1.0)},
                       input_spec=jax_spec((4,)), max_batch_size=8)
    te = treg.register("scale", _scale_torch, {"scale": torch.tensor(1.0)},
                       input_spec=spec((4,)), max_batch_size=8,
                       devices=["cpu"])
    try:
        je.warm()
        te.warm()
        for n in (1, 3, 2, 3):
            x = np.zeros((n, 4), np.float32)
            je.predict(x)
            te.predict_versioned(x)
    finally:
        jreg.shutdown_all()
        treg.shutdown_all()
    rows = _rows(tman)
    assert rows == _rows(jman)
    assert ("predict", "scale", [4], 2) in rows
    assert {r[0] for r in rows} == {"predict", "generation.prefill",
                                    "generation.decode"}


def test_manifest_plan_restricts_and_falls_back(gpt_models):
    _, _, tm = gpt_models
    eng = GenerationEngine(tm, tm.variables(), **_engine_kw())
    full_pairs = [(b, kv) for b in eng.slot_buckets for kv in eng.kv_buckets]
    assert eng.manifest_warm_plan(None) == (list(eng.prompt_buckets),
                                            full_pairs)
    m = WarmupManifest()
    m.note_prefill("gpt", eng.prompt_buckets[0])
    m.note_decode("gpt", eng.slot_buckets[0], eng.kv_buckets[0])
    assert eng.manifest_warm_plan(m) == (
        [eng.prompt_buckets[0]], [(eng.slot_buckets[0], eng.kv_buckets[0])])
    stale = WarmupManifest()
    stale.note_prefill("gpt", 999)
    stale.note_decode("gpt", 999, 999)
    assert eng.manifest_warm_plan(stale) == (list(eng.prompt_buckets),
                                             full_pairs)


def test_restricted_engine_warm_counts_the_next_unobserved_shape(
        gpt_models):
    _, _, tm = gpt_models
    eng = GenerationEngine(tm, tm.variables(), **_engine_kw())
    m = WarmupManifest()
    m.note_prefill("gpt", eng.prompt_buckets[0])  # the smallest bucket
    for kv in eng.kv_buckets:
        m.note_decode("gpt", eng.slot_buckets[0], kv)
    eng.attach_manifest(m)
    p_list, pairs = eng.manifest_warm_plan()
    eng.warm(prompt_buckets=p_list, decode_pairs=pairs, source="manifest")
    assert eng.describe()["shapes_run"] == len(p_list) + len(pairs)
    assert _wm().warmup_shapes_total.value(
        plane="generation", source="manifest") == len(p_list) + len(pairs)
    _drive(eng, [[1, 2, 3]])  # the warmed prompt bucket, one slot
    assert eng.shapes_after_warm == 0
    assert _wm().recompiles_after_warm_total.value(plane="generation") == 0
    _drive(eng, [list(range(eng.prompt_buckets[0] + 1))])  # bucket 16
    assert eng.shapes_after_warm == 1
    assert _wm().recompiles_after_warm_total.value(plane="generation") == 1
    assert len(m.prefill_buckets("gpt")) == 2  # the live mix noted it
    evs = fr.get_flight_recorder().events(kinds=["generation.compile"])
    assert [(e["data"]["kind"], e["data"]["key"]) for e in evs] == [
        ("prefill", str(eng.prompt_buckets[1]))]


def test_restricted_predict_warm_counts_a_new_bucket_once():
    m = WarmupManifest()
    m.note_batch("scale", 2)
    reg = ModelRegistry()
    reg.register("scale", _scale_torch, {"scale": torch.tensor(1.0)},
                 input_spec=spec((4,)), max_batch_size=8, devices=["cpu"])
    srv = ModelServer(reg, port=0, warmup_manifest=m)
    try:
        srv.start(warm=True)
        entry = reg.get("scale")
        assert entry.warmed_buckets == {2}
        assert _wm().warmup_shapes_total.value(
            plane="predict", source="manifest") == 1
        c = ServingClient(srv.url)
        c.predict("scale", np.zeros((2, 4), np.float32))
        assert _wm().recompiles_after_warm_total.value(plane="predict") == 0
        c.predict("scale", np.zeros((3, 4), np.float32))  # bucket 4
        c.predict("scale", np.zeros((3, 4), np.float32))
        assert _wm().recompiles_after_warm_total.value(plane="predict") == 1
        evs = fr.get_flight_recorder().events(
            kinds=["serving.recompile_after_warm"])
        assert [e["data"]["bucket"] for e in evs] == [4]
    finally:
        srv.stop()


def test_live_traffic_is_saved_on_stop_and_a_restart_warms_it(
        tmp_path, gpt_models):
    _, _, tm = gpt_models
    p = tmp_path / "wm.json"

    def server():
        reg = ModelRegistry()
        reg.register("scale", _scale_torch, {"scale": torch.tensor(1.0)},
                     input_spec=spec((4,)), max_batch_size=8,
                     devices=["cpu"])
        eng = GenerationEngine(tm, tm.variables(), **_engine_kw())
        return ModelServer(reg, port=0, warmup_manifest=str(p),
                           generators={"gpt": eng}), reg, eng

    srv, _, eng = server()
    with_full = len(eng.prompt_buckets) + \
        len(eng.slot_buckets) * len(eng.kv_buckets)
    srv.start(warm=True)
    try:
        c = ServingClient(srv.url)
        c.predict("scale", np.zeros((3, 4), np.float32))  # bucket 4
        assert len(c.generate_tokens("gpt", [4, 5, 6])["tokens"]) == 4
    finally:
        srv.stop()
    doc = json.loads(p.read_text())
    assert doc["format"] == 1
    rows = {(e["plane"], tuple(e["shape"])) for e in doc["entries"]}
    assert ("predict", (4,)) in rows and ("generation.prefill", (8,)) in rows
    srv2, reg2, eng2 = server()
    srv2.start(warm=True)
    try:
        assert reg2.get("scale").warmed_buckets == {4}
        p_list, pairs = eng2.manifest_warm_plan()
        assert eng2.describe()["shapes_run"] == len(p_list) + len(pairs) \
            < with_full
        c = ServingClient(srv2.url)
        c.predict("scale", np.zeros((3, 4), np.float32))
        assert len(c.generate_tokens("gpt", [4, 5, 6])["tokens"]) == 4
        assert eng2.shapes_after_warm == 0
        assert _wm().recompiles_after_warm_total.value(plane="predict") == 0
    finally:
        srv2.stop()


# -- /readyz while warming, in both packages -----------------------------------


def _slow_jax(v, x):
    time.sleep(0.12)  # trace-time cost: every bucket's compile pays it
    return jnp.zeros((x.shape[0], 1), jnp.float32) + v["scale"]


def _slow_torch(v, x):
    time.sleep(0.12)  # every eager run pays it, a warm batch included
    return torch.zeros((x.shape[0], 1)) + v["scale"]


def _poll_warming(url, predict):
    """Poll /readyz until 200; returns (the last progress body and its
    Retry-After, the error a predict made while warming raised, the 200
    body)."""
    saw, shed = None, None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url + "/readyz") as r:
                return saw, shed, json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            if body.get("total"):
                saw = (body, e.headers.get("Retry-After"))
                if shed is None:
                    try:
                        predict()
                        shed = False
                    except Exception as err:  # noqa: BLE001 — asserted
                        shed = err
        time.sleep(0.01)
    raise AssertionError("/readyz never turned 200")


def _check_progress(saw, shed, body, exc_type):
    assert body["ready"] is True and "warmed" not in body
    assert saw is not None, "never saw a warming progress body"
    prog, retry_after = saw
    assert 0 <= prog["warmed"] < prog["total"]
    assert prog["retry_after_ms"] >= 50.0
    assert retry_after is not None and int(retry_after) >= 1
    assert isinstance(shed, exc_type) and shed.retryable
    return prog


def test_readyz_reports_warm_progress_then_200_in_both_packages(
        gpt_models):
    x = np.zeros((1, 4), np.float32)
    jreg = JaxRegistry()
    jreg.register("scale", _slow_jax, {"scale": np.float32(1.0)},
                  input_spec=jax_spec((4,)), max_batch_size=8)
    jsrv = JaxServer(jreg, port=0, sentinel=False, slo_interval_s=3600.0,
                     warmup_manifest=False, compile_cache=False)
    jsrv.start(warm=True, warm_async=True)
    try:
        jprog = _check_progress(*_poll_warming(
            jsrv.url, lambda: JaxClient(jsrv.url).predict("scale", x)),
            JaxNotReady)
    finally:
        jsrv.stop()

    _, _, tm = gpt_models
    treg = ModelRegistry()
    treg.register("scale", _slow_torch, {"scale": torch.tensor(1.0)},
                  input_spec=spec((4,)), max_batch_size=8, devices=["cpu"])
    eng = GenerationEngine(tm, tm.variables(), **_engine_kw())
    tsrv = ModelServer(treg, port=0, generators={"gpt": eng})
    tsrv.start(warm=True, warm_async=True)
    gen_shed = []
    try:
        def predict():
            # the engine warms after the model: both shed while it warms
            try:
                ServingClient(tsrv.url).generate_tokens("gpt", [1, 2])
            except NotReadyError as e:
                gen_shed.append(e)
            ServingClient(tsrv.url).predict("scale", x)

        tprog = _check_progress(*_poll_warming(tsrv.url, predict),
                                NotReadyError)
        # the same body, with the port server's generator beside
        assert set(tprog) - {"generators"} == set(jprog)
        assert tprog["total"] == 4 + len(eng.prompt_buckets) + \
            len(eng.slot_buckets) * len(eng.kv_buckets)
        assert gen_shed and gen_shed[0].retryable
        out = ServingClient(tsrv.url).predict(
            "scale", np.zeros((2, 4), np.float32))
        assert out["outputs"] == [[1.0], [1.0]]
        assert ServingClient(tsrv.url).generate_tokens(
            "gpt", [1, 2])["n_tokens"] == 4
    finally:
        tsrv.stop()
    assert not any(th.name == "server-warmup" and th.is_alive()
                   for th in threading.enumerate())
