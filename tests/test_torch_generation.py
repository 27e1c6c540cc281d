"""The port's generation serving on the CPU: ``GenerationEngine`` behind
``ModelServer``'s ``:generate`` route, and ``ServingClient.generate``.

A gpt_tiny initialised by the JAX package and carried across as numpy.
Greedy tokens are held against the JAX package's ``Gpt.generate``. The
scheduler tests drive the engine's steps directly (``_admit``,
``_decode_once``) without its thread; the HTTP tests wait only on
results, with generous timeouts, and never on the order in which threads
arrive.
"""

import http.client
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.serving import (
    BadRequestError,
    DeadlineExceededError,
    GenerationEngine,
    ModelNotFoundError,
    ModelServer,
    NotReadyError,
    QueueFullError,
    ServingClient,
    SlotPreemptedError,
)
from deeplearning4j_tpu_torch.serving.warmup import bucket_sizes

VOCAB, MAX_LEN = 128, 48
WAIT_S = 60.0  # a generous bound on any one result


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt_tiny()
    jv = jax.tree_util.tree_map(np.asarray, jm.init(seed=5))
    tm = gpt_tiny(device="cpu")
    tm.load_variables(variables_from_numpy(jv))
    return jm, jv, tm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _jax_greedy(jm, jv, prompt, n):
    return np.asarray(jm.generate(jv, jnp.asarray(prompt[None]), n_steps=n,
                                  rng=jax.random.key(0),
                                  temperature=0.0))[0].tolist()


def _engine(tm, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("min_prompt_bucket", 4)
    kw.setdefault("temperature", 0.0)
    return GenerationEngine(tm, tm.variables(), **kw)


def _run_to_end(engine, max_steps=200):
    """The scheduler's loop body, on this thread, until nothing is left."""
    for _ in range(max_steps):
        engine._admit()
        engine._decode_once()
        if not engine._waiting and all(s is None for s in engine._slots):
            return
    raise AssertionError("the engine did not finish its requests")


def test_bucket_sizes_take_a_floor():
    assert bucket_sizes(48, lo=8) == [8, 16, 32, 48]
    assert bucket_sizes(47, lo=4) == [4, 8, 16, 32, 47]
    assert bucket_sizes(6, lo=8) == [6]
    assert bucket_sizes(8) == [1, 2, 4, 8]


def test_mixed_prompts_in_one_decode_batch_equal_jax_greedy(models):
    """Four prompts of different lengths (and prompt buckets) prefill,
    then share every decode step: each stream's tokens equal the JAX
    package's greedy generate of its prompt alone."""
    jm, jv, tm = models
    engine = _engine(tm)
    prompts = [_prompt(20 + i, n) for i, n in enumerate((3, 9, 17, 1))]
    streams = [engine.submit(p) for p in prompts]
    engine._admit()
    assert [s.slot for s in streams] == [0, 1, 2, 3]
    assert [s.pos for s in streams] == [3, 9, 17, 1]
    _run_to_end(engine)
    assert engine.steps == 5  # 6 tokens: one from prefill, 5 decoded
    for p, s in zip(prompts, streams):
        res = s.result(timeout=WAIT_S)
        assert res["finish_reason"] == "length"
        assert res["tokens"] == _jax_greedy(jm, jv, p, 6)
    d = engine.describe()
    assert d["active"] == d["waiting"] == 0
    assert d["active_rows_total"] == d["bucket_rows_total"] == 4 * 5


def test_padded_rows_write_only_the_scratch_row(models):
    """Three live slots in a bucket of four: the pad row writes the
    scratch row, never a slot's; the free slot's slab row stays zero and
    a live row holds nothing past its position and its prompt bucket
    (prefill writes the whole bucket; the padded columns are dead)."""
    jm, jv, tm = models
    engine = _engine(tm, max_new_tokens=4)
    prompts = [_prompt(30 + i, n) for i, n in enumerate((5, 2, 11))]
    streams = [engine.submit(p) for p in prompts]
    engine._admit()
    engine._decode_once()
    engine._decode_once()
    scratch = engine.num_slots
    for ks in engine._kslabs + engine._vslabs:
        assert torch.count_nonzero(ks[3]) == 0       # the free slot
        assert torch.count_nonzero(ks[scratch]) > 0  # pad writes land here
        for s in streams:
            bucket = min(b for b in engine.prompt_buckets
                         if b >= s.prompt_len)
            end = max(s.pos, bucket)
            assert torch.count_nonzero(ks[s.slot, :, :end]) > 0
            assert torch.count_nonzero(ks[s.slot, :, end:]) == 0
    _run_to_end(engine)
    for p, s in zip(prompts, streams):
        assert s.result(timeout=WAIT_S)["tokens"] == _jax_greedy(jm, jv, p,
                                                                  4)


def test_prefill_bucket_padding_stays_dead(models):
    """A prompt of 5 in a bucket of 8: prefill writes K/V for the padded
    positions too, and decode masks them by position, so the tokens equal
    the unpadded greedy run."""
    jm, jv, tm = models
    engine = _engine(tm, min_prompt_bucket=8, max_new_tokens=5)
    p = _prompt(40, 5)
    s = engine.submit(p)
    engine._admit()
    assert torch.count_nonzero(engine._kslabs[0][s.slot, :, 5:8]) > 0
    _run_to_end(engine)
    assert s.result(timeout=WAIT_S)["tokens"] == _jax_greedy(jm, jv, p, 5)


def test_eos_finishes_the_stream(models):
    jm, jv, tm = models
    p = _prompt(50, 6)
    greedy = _jax_greedy(jm, jv, p, 6)
    eos = greedy[2]
    k = greedy.index(eos)
    engine = _engine(tm)
    s = engine.submit(p, eos_id=eos)
    _run_to_end(engine)
    res = s.result(timeout=WAIT_S)
    assert res == {"tokens": greedy[:k + 1], "finish_reason": "eos"}


def test_cancel_frees_the_slot_and_stops_the_stream(models):
    _, _, tm = models
    engine = _engine(tm, max_new_tokens=20)
    keep, gone = engine.submit(_prompt(60, 4)), engine.submit(_prompt(61, 7))
    engine._admit()
    engine._decode_once()
    gone.cancel()
    assert engine._slots[gone.slot] is None and gone.finish_reason == \
        "cancelled"
    n_before = gone.generated
    _run_to_end(engine)
    assert gone.generated == n_before
    assert len(keep.result(timeout=WAIT_S)["tokens"]) == 20
    gone.cancel()  # idempotent


def test_critical_request_preempts_the_newest_batch_slot(models):
    jm, jv, tm = models
    engine = _engine(tm, num_slots=2, max_new_tokens=5)
    old = engine.submit(_prompt(70, 3), priority="batch")
    new = engine.submit(_prompt(71, 3), priority="batch")
    engine._admit()
    engine._decode_once()
    p = _prompt(72, 4)
    urgent = engine.submit(p, priority="critical")
    engine._admit()
    assert urgent.slot == new.slot and new.finish_reason == "preempted"
    with pytest.raises(SlotPreemptedError) as err:
        new.result(timeout=WAIT_S)
    assert err.value.retryable and err.value.retry_after_ms > 0
    _run_to_end(engine)
    assert urgent.result(timeout=WAIT_S)["tokens"] == _jax_greedy(jm, jv, p,
                                                                  5)
    assert len(old.result(timeout=WAIT_S)["tokens"]) == 5


def test_sampled_streams_follow_the_engine_seed(models):
    """Sampled rows share decode steps with a greedy one; the draws come
    from the engine's generator, so one seed gives the same tokens."""
    jm, jv, tm = models

    def run(seed):
        engine = _engine(tm, seed=seed, max_new_tokens=8)
        streams = [engine.submit(_prompt(90 + i, 5), temperature=t)
                   for i, t in enumerate((0.9, 0.0, 1.3))]
        _run_to_end(engine)
        return [s.result(timeout=WAIT_S)["tokens"] for s in streams]

    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c
    assert a[1] == c[1] == _jax_greedy(jm, jv, _prompt(91, 5), 8)
    assert all(0 <= t < VOCAB for toks in a for t in toks)


def test_a_full_queue_sheds_and_stop_fails_what_is_left(models):
    _, _, tm = models
    engine = _engine(tm, num_slots=1, max_waiting=2)
    first, second = engine.submit([1, 2]), engine.submit([3])
    with pytest.raises(QueueFullError) as err:
        engine.submit([4])
    assert err.value.retryable and err.value.retry_after_ms > 0
    engine._admit()  # first takes the slot, second waits
    engine.stop()
    for s in (first, second):
        with pytest.raises(NotReadyError):
            s.result(timeout=WAIT_S)
    with pytest.raises(NotReadyError, match="draining"):
        engine.submit([5])


def test_drain_lets_the_active_streams_finish(models):
    jm, jv, tm = models
    engine = _engine(tm).start()
    try:
        p = _prompt(65, 5)
        with pytest.raises(RuntimeError, match="before start"):
            engine.warm()
        s = engine.submit(p)
        assert engine.drain(timeout=WAIT_S)
        with pytest.raises(NotReadyError):
            engine.submit(p)
        assert s.result(timeout=WAIT_S)["tokens"] == _jax_greedy(jm, jv, p,
                                                                  6)
    finally:
        engine.stop()
    assert not engine.running


def test_a_failed_step_fails_the_active_streams_and_serving_goes_on(
        models, monkeypatch):
    jm, jv, tm = models
    engine = _engine(tm, max_new_tokens=3)
    s = engine.submit(_prompt(66, 4))
    engine._admit()
    def broken(*a):
        raise RuntimeError("x")

    monkeypatch.setattr(engine, "run_decode", broken)
    with pytest.raises(RuntimeError) as err:  # what the loop catches
        engine._decode_once()
    engine._fail_active(err.value)
    with pytest.raises(RuntimeError, match="generation step failed"):
        s.result(timeout=WAIT_S)
    monkeypatch.undo()
    p = _prompt(67, 4)
    again = engine.submit(p)
    _run_to_end(engine)
    assert again.result(timeout=WAIT_S)["tokens"] == _jax_greedy(jm, jv, p,
                                                                 3)


def test_constructor_refuses_what_is_not_ported(models):
    _, _, tm = models
    for kw, item in ((dict(prefix_cache=object()), "item 6"),
                     (dict(metrics=object()), "item 9"),
                     (dict(brownout_max_new_tokens=2), "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            _engine(tm, **kw)
    with pytest.raises(ValueError, match="max_len"):
        _engine(tm, max_len=65)
    with pytest.raises(ValueError, match="num_slots"):
        _engine(tm, num_slots=0)


# -- behind ModelServer --------------------------------------------------------

@pytest.fixture(scope="module")
def served(models):
    jm, jv, tm = models
    engine = GenerationEngine(tm, tm.variables(), num_slots=3,
                              max_len=MAX_LEN, max_new_tokens=6,
                              temperature=0.0)
    server = ModelServer(port=0, generators={"gpt": engine})
    server.start(warm=True)
    try:
        yield server, engine, ServingClient(server.url, timeout=WAIT_S)
    finally:
        server.stop()


def test_readyz_is_503_until_the_generator_is_warm(models):
    _, _, tm = models
    engine = _engine(tm, num_slots=1, max_len=16)
    server = ModelServer(port=0, generators={"gpt": engine})
    server.start(warm=False)
    try:
        client = ServingClient(server.url, timeout=WAIT_S)
        body = client.ready()
        assert not body["ready"] and body["generators"] == {"gpt": False}
        assert not engine.running  # an unwarmed engine gets no scheduler
        engine.warm()
        assert client.ready()["ready"]
    finally:
        server.stop()


def test_readyz_waits_for_every_generator(served):
    server, engine, client = served
    body = client.ready()
    assert body["ready"] and body["generators"] == {"gpt": True}
    d = engine.describe()
    assert d["shapes_run"] == (len(engine.prompt_buckets)
                               + len(engine.slot_buckets)
                               * len(engine.kv_buckets))


def test_streamed_and_collected_generation_equal_jax_greedy(models, served):
    jm, jv, _ = models
    _, engine, client = served
    p = _prompt(80, 7)
    want = _jax_greedy(jm, jv, p, 6)
    assert list(client.generate("gpt", p)) == want
    res = client.generate_tokens("gpt", p, max_new_tokens=4)
    assert res == {"model": "gpt", "version": "v1", "tokens": want[:4],
                   "n_tokens": 4, "finish_reason": "length"}
    assert list(client.generate("gpt", p, eos_id=want[1],
                                priority="critical")) == \
        want[:want.index(want[1]) + 1]
    assert engine.describe()["shapes_after_warm"] == 0


def test_raw_stream_is_chunked_ndjson(served):
    server, _, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.request("POST", "/v1/models/gpt:generate",
                     body=json.dumps({"prompt": [5, 9, 2],
                                      "max_new_tokens": 3}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        assert resp.getheader("Transfer-Encoding") == "chunked"
        lines = [json.loads(x) for x in resp.read().splitlines()]
    finally:
        conn.close()
    assert [set(x) for x in lines[:3]] == [{"token"}] * 3
    assert lines[3] == {"done": True, "n_tokens": 3,
                        "finish_reason": "length"}


BAD_BODIES = [
    ({"max_new_tokens": 3}, "prompt"),
    ({"prompt": [1, 2], "max_new_tokens": "5"}, "max_new_tokens"),
    ({"prompt": [1, 2], "max_new_tokens": 0}, "max_new_tokens"),
    ({"prompt": [1, 2], "temperature": "hot"}, "temperature"),
    ({"prompt": [1, 2], "temperature": -1.0}, "temperature"),
    ({"prompt": [1, 2], "eos_id": 1.5}, "eos_id"),
    ({"prompt": [1, 2], "eos_id": VOCAB}, "eos_id"),
    ({"prompt": [1, 2], "deadline_ms": -1}, "deadline_ms"),
    ({"prompt": [1, 2], "stream": "yes"}, "stream"),
    ({"prompt": []}, "at least one"),
    ({"prompt": [1.5, 2]}, "whole numbers"),
    ({"prompt": [1, VOCAB]}, "token ids"),
    ({"prompt": list(range(MAX_LEN))}, "max prompt"),
    ({"prompt": "abc"}, "integers"),
]


@pytest.mark.parametrize("body,match", BAD_BODIES)
def test_bad_requests_are_400s_before_any_submit(served, body, match):
    server, engine, _ = served
    before = next(engine._seq)
    status, out, stream = server.handle_generate("gpt", body)
    assert (status, stream) == (400, None)
    assert out["error"]["code"] == "INVALID_ARGUMENT"
    assert match in out["error"]["message"]
    assert next(engine._seq) == before + 1  # no request was queued


def test_client_raises_typed_errors(served):
    _, _, client = served
    with pytest.raises(BadRequestError, match="X-Priority"):
        client.generate("gpt", [1, 2], priority="bogus")
    with pytest.raises(ModelNotFoundError):
        client.generate_tokens("nope", [1, 2])
    with pytest.raises(BadRequestError, match="temperature"):
        client.generate_tokens("gpt", [1, 2], temperature=-2.0)


def test_the_deadline_bounds_the_whole_stream(served, monkeypatch):
    """Decode slowed to 50 ms a step: a 40-token stream cannot finish in
    1 s. Streamed, it ends with a terminal DEADLINE_EXCEEDED line after
    the tokens it had; collected, the request is a 504. Either way the
    slot is freed."""
    server, engine, client = served
    real_decode = engine.run_decode

    def slow_decode(*a, **kw):
        time.sleep(0.05)
        return real_decode(*a, **kw)

    monkeypatch.setattr(engine, "run_decode", slow_decode)
    monkeypatch.setattr(engine, "default_max_new_tokens", 40)
    got = []
    with pytest.raises(DeadlineExceededError):
        for tok in client.generate("gpt", [4, 2], max_new_tokens=40,
                                   deadline_ms=1000):
            got.append(tok)
    assert 0 < len(got) < 40
    with pytest.raises(DeadlineExceededError):
        client.generate_tokens("gpt", [4, 2], max_new_tokens=40,
                               deadline_ms=1000)
    deadline = time.monotonic() + WAIT_S
    while engine.describe()["active"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine.describe()["active"] == 0


def test_hanging_up_mid_stream_frees_the_slot(served, monkeypatch):
    """Each decode step is slowed to 30 ms, so a 40-token stream lasts
    over a second; the client reads one line and closes. The server's
    next writes fail, it cancels the request, and the slot is free long
    before the stream would have ended."""
    server, engine, _ = served
    streams = []
    real_submit, real_decode = engine.submit, engine.run_decode

    def submit(*a, **kw):
        streams.append(real_submit(*a, **kw))
        return streams[-1]

    def slow_decode(*a, **kw):
        time.sleep(0.03)
        return real_decode(*a, **kw)

    monkeypatch.setattr(engine, "submit", submit)
    monkeypatch.setattr(engine, "run_decode", slow_decode)
    monkeypatch.setattr(engine, "default_max_new_tokens", 40)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    conn.request("POST", "/v1/models/gpt:generate",
                 body=json.dumps({"prompt": [3, 1], "max_new_tokens": 40}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert "token" in json.loads(resp.readline())
    resp.close()  # the socket closes with its last file object
    conn.close()
    deadline = time.monotonic() + WAIT_S
    while streams[0].finish_reason is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert streams[0].finish_reason == "cancelled"
    assert streams[0].generated < 40
    assert all(s is None for s in engine._slots)
