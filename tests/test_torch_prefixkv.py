"""The port's prefix-KV reuse on the CPU, held against the JAX package.

The store, one operation at a time: the same sequence of insert /
acquire / release / purge / has goes to the JAX package's
``PrefixKVStore`` (numpy slabs) and the port's (torch slabs); every
result, every acquired length, ``describe()`` and the ``cache_prefix_*``
exposition must be equal. The cases mirror tests/test_prefixkv.py.

The engine: a gpt_tiny initialised by the JAX package and carried across
as numpy, in both packages' ``GenerationEngine`` with
``prefix_cache=True``, on prompts that share a prefix of one prompt
bucket plus distinct suffixes. Greedy tokens, hits and misses must equal
the JAX engine's, and the tokens the port's engine without a store; the
slab row a graft and its suffix feeds wrote must equal the row a normal
prefill wrote. Both engines are driven by their scheduler's steps
(``_admit``/``_decode_once``) without the thread.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from deeplearning4j_tpu.observability.metrics import (
    MetricsRegistry as JaxMetricsRegistry,
)
from deeplearning4j_tpu.observability.metrics import (
    render_text_multi as jax_render_text_multi,
)
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving.cache import CacheMetrics as JaxCacheMetrics
from deeplearning4j_tpu.serving.prefixkv import (
    PrefixKVStore as JaxStore,
)
from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
from deeplearning4j_tpu_torch.observability.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.serving import GenerationEngine
from deeplearning4j_tpu_torch.serving.cache import CacheMetrics
from deeplearning4j_tpu_torch.serving.prefixkv import (
    ENV_PREFIX_CACHE,
    ENV_PREFIX_CACHE_MAX_BYTES,
    PrefixKVStore,
    resolve_prefix_store,
)

BUCKETS = (4, 8, 16)
HEADS, HEAD_DIM, LAYERS = 2, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _kvs_np(p, fill):
    return [(np.full((HEADS, p, HEAD_DIM), fill, np.float32),
             np.full((HEADS, p, HEAD_DIM), -fill, np.float32))
            for _ in range(LAYERS)]


def _kvs_torch(p, fill):
    return [(torch.from_numpy(k), torch.from_numpy(v))
            for k, v in _kvs_np(p, fill)]


SLAB_BYTES = sum(k.nbytes + v.nbytes for k, v in _kvs_np(8, 1.0))


def _prompt(*parts):
    return np.concatenate([np.asarray(p, np.int64) for p in parts])


# (store kwargs, ops). An op is ("insert", version, tokens, fill),
# ("acquire", version, prompt, lengths), ("release", i) of the i-th
# acquired entry, ("purge",) or ("has", version, tokens).
A, B, C = np.arange(8), np.arange(100, 108), np.arange(200, 208)
CASES = {
    "insert_then_acquire_pins_and_verifies": ({}, [
        ("insert", "v1", A, 1.0),
        ("acquire", "v1", _prompt(A, [99]), BUCKETS),
        ("release", 0)]),
    "strict_prefix_required": ({}, [
        ("insert", "v1", A, 1.0),
        ("acquire", "v1", A, BUCKETS)]),
    "longest_candidate_wins": ({}, [
        ("insert", "v1", np.arange(4), 1.0),
        ("insert", "v1", A, 1.0),
        ("acquire", "v1", _prompt(A, [7]), BUCKETS),
        ("release", 0)]),
    "token_mismatch_never_serves": ({}, [
        ("insert", "v1", A, 1.0),
        ("acquire", "v1", _prompt(np.arange(7), [42, 3]), BUCKETS)]),
    "version_scoped": ({}, [
        ("insert", "v1", A, 1.0),
        ("acquire", "v2", _prompt(A, [1]), BUCKETS),
        ("acquire", "v1", _prompt(A, [1]), BUCKETS),
        ("release", 0)]),
    "min_tokens_floor": ({"min_tokens": 8}, [
        ("insert", "v1", np.arange(4), 1.0),
        ("insert", "v1", A, 1.0),
        ("acquire", "v1", np.arange(9), (4, 8)),
        ("release", 0)]),
    "insert_idempotent": ({}, [
        ("insert", "v1", A, 1.0),
        ("insert", "v1", A, 2.0),
        ("acquire", "v1", np.arange(9), BUCKETS),
        ("release", 0)]),
    "pinned_entries_never_evict": ({"max_bytes": SLAB_BYTES * 2}, [
        ("insert", "v1", A, 1.0),
        ("acquire", "v1", _prompt(A, [1]), BUCKETS),
        ("insert", "v1", B, 1.0),
        ("insert", "v1", C, 1.0),
        ("has", "v1", A),
        ("has", "v1", B),
        ("release", 0),
        ("insert", "v1", np.arange(300, 308), 1.0),
        ("has", "v1", A)]),
    "oversize_slab_refused": ({"max_bytes": 64}, [
        ("insert", "v1", A, 1.0)]),
    "purge_skips_pinned": ({}, [
        ("insert", "v1", A, 1.0),
        ("insert", "v1", np.arange(50, 58), 1.0),
        ("acquire", "v1", _prompt(A, [1]), BUCKETS),
        ("purge",),
        ("has", "v1", A),
        ("release", 0),
        ("purge",)]),
}


def _run(store, ops, kvs):
    out, held = [], []
    for op in ops:
        if op[0] == "insert":
            out.append(store.insert(op[1], op[2], kvs(len(op[2]), op[3])))
        elif op[0] == "acquire":
            e = store.acquire(op[1], op[2], op[3])
            if e is not None:
                held.append(e)
                first = e.kvs[0][0]
                out.append((e.length, e.refs, float(first[0, 0, 0]),
                            tuple(first.shape)))
            else:
                out.append(None)
        elif op[0] == "release":
            store.release(held[op[1]])
            out.append(held[op[1]].refs)
        elif op[0] == "purge":
            out.append(store.purge())
        else:
            out.append(store.has(op[1], op[2]))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_store_operations_equal_jax(case):
    kw, ops = CASES[case]
    kw = dict(dict(max_bytes=1 << 20, min_tokens=4, model="gpt"), **kw)
    jreg, treg = JaxMetricsRegistry(), MetricsRegistry()
    jstore = JaxStore(metrics=JaxCacheMetrics(jreg), **kw)
    tstore = PrefixKVStore(metrics=CacheMetrics(treg), **kw)
    assert _run(tstore, ops, _kvs_torch) == _run(jstore, ops, _kvs_np)
    assert tstore.describe() == jstore.describe()
    assert tstore.bytes == jstore.bytes and len(tstore) == len(jstore)
    # the JAX bundle also registers the response cache's families
    names = set(treg.names())
    assert names <= set(jreg.names())
    shared = SimpleNamespace(instruments=lambda: [
        i for i in jreg.instruments() if i.name in names])
    assert treg.render_text() == jax_render_text_multi([shared])


def test_resolver_contract(monkeypatch):
    monkeypatch.delenv(ENV_PREFIX_CACHE, raising=False)
    assert resolve_prefix_store(False, model="m") is None
    assert resolve_prefix_store(None, model="m") is None
    s = PrefixKVStore(model="gpt")
    assert resolve_prefix_store(s, model="m") is s
    m = CacheMetrics()
    assert resolve_prefix_store(s, model="m", metrics=m)._metrics is m
    built = resolve_prefix_store(True, model="m")
    assert isinstance(built, PrefixKVStore) and built.model == "m"
    monkeypatch.setenv(ENV_PREFIX_CACHE, "on")
    monkeypatch.setenv(ENV_PREFIX_CACHE_MAX_BYTES, "4096")
    env = resolve_prefix_store(None, model="m")
    assert env.max_bytes == 4096
    with pytest.raises(TypeError):
        resolve_prefix_store(42, model="m")
    with pytest.raises(ValueError):
        PrefixKVStore(max_bytes=0)
    with pytest.raises(ValueError):
        PrefixKVStore(min_tokens=0)


# -- the engine ------------------------------------------------------------------

VOCAB, MAX_LEN, NEW = 128, 32, 4
PREFIX = 8  # one prompt bucket: buckets 8, 16, 31 at max_len 32


@pytest.fixture(scope="module")
def models():
    jm = jax_gpt_tiny()
    jv = jax.tree_util.tree_map(np.asarray, jm.init(seed=7))
    tm = gpt_tiny(device="cpu")
    tm.load_variables(variables_from_numpy(jv))
    return jm, jv, tm


def _kw(**kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("max_new_tokens", NEW)
    kw.setdefault("min_prompt_bucket", 8)
    kw.setdefault("min_kv_bucket", 8)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("name", "gpt")
    return kw


def _prompts():
    """One shared prefix of a prompt bucket and distinct suffixes of 1-5
    ids (prompt bucket 16): the first prompt publishes, the rest hit."""
    r = np.random.default_rng(31)
    shared = r.integers(0, VOCAB, PREFIX)
    return [np.concatenate([shared, r.integers(0, VOCAB, n)]).astype(np.int32)
            for n in (3, 1, 5, 2)]


def _drive(engine, prompts, max_steps=100):
    """Submit every prompt, then run the scheduler's loop body on this
    thread until nothing is left; returns the streams."""
    streams = [engine.submit(p) for p in prompts]
    for _ in range(max_steps):
        engine._admit()
        engine._decode_once()
        if not engine._waiting and all(s is None for s in engine._slots):
            return streams
    raise AssertionError("the engine did not finish its requests")


@pytest.fixture(scope="module")
def runs(models):
    jm, jv, tm = models
    prompts = _prompts()
    jeng = JaxEngine(jm, jv, prefix_cache=True, **_kw())
    jstreams = _drive(jeng, prompts)
    teng = GenerationEngine(tm, tm.variables(), prefix_cache=True, **_kw())
    tstreams = _drive(teng, prompts)
    plain = GenerationEngine(tm, tm.variables(), prefix_cache=False, **_kw())
    pstreams = _drive(plain, prompts)
    return prompts, (jeng, jstreams), (teng, tstreams), (plain, pstreams)


def test_prefix_hits_give_the_jax_engine_greedy_tokens(runs):
    prompts, (jeng, js), (teng, ts), (_, ps) = runs
    want = [s.result(timeout=10)["tokens"] for s in js]
    assert [s.result(timeout=10)["tokens"] for s in ts] == want
    assert [s.result(timeout=10)["tokens"] for s in ps] == want
    assert all(len(w) == NEW for w in want)
    jd = jeng.prefix_cache.describe()
    td = teng.prefix_cache.describe()
    assert (td["hits"], td["misses"]) == (jd["hits"], jd["misses"]) == (3, 1)
    assert td == jd
    assert td["prefix_lengths"] == [PREFIX]
    assert [s.prefix_len for s in ts] == [0, PREFIX, PREFIX, PREFIX]
    d = teng.describe()
    assert d["prefix_cache"] == td
    # the grafts and the suffix feeds ran at shapes the engine knows
    assert ("graft", PREFIX) in teng._shapes


def test_graft_row_equals_a_normal_prefill_row(runs):
    """The first t0 KV columns of a hit's slot row (the graft and its
    suffix feeds) against the same prompt prefilled normally."""
    prompts, _, (teng, ts), (plain, ps) = runs
    for s, q in zip(ts[1:], ps[1:]):
        n = s.prompt_len
        for got_slabs, want_slabs in ((teng._kslabs, plain._kslabs),
                                      (teng._vslabs, plain._vslabs)):
            for g, w in zip(got_slabs, want_slabs):
                got, want = g[s.slot, :, :n], w[q.slot, :, :n]
                scale = float(want.abs().max())
                assert float((got - want).abs().max()) <= 1e-5 * scale


def test_a_full_prompt_length_slab_is_never_published(models):
    """A prompt exactly one bucket long publishes the bucket below it,
    never its own length; a prompt of the smallest bucket publishes
    nothing."""
    _, _, tm = models
    engine = GenerationEngine(tm, tm.variables(), prefix_cache=True,
                              **_kw())
    r = np.random.default_rng(5)
    _drive(engine, [r.integers(0, VOCAB, 16).astype(np.int32),
                    r.integers(0, VOCAB, 8).astype(np.int32)])
    d = engine.prefix_cache.describe()
    assert d["prefix_lengths"] == [8] and d["insertions"] == 1


def test_warm_runs_the_graft_of_every_prompt_bucket(models):
    _, _, tm = models
    engine = GenerationEngine(tm, tm.variables(), prefix_cache=True,
                              **_kw(num_slots=2))
    stats = engine.warm()
    assert sorted(stats["graft"], key=int) == [
        str(p) for p in engine.prompt_buckets]
    _drive(engine, _prompts()[:3])
    assert engine.describe()["shapes_after_warm"] == 0
    assert engine.prefix_cache.describe()["hits"] == 2
