"""The port's GPT against the JAX package's, on the CPU.

A gpt_tiny (2 layers, width 64, 2 heads, vocab 128, 64 positions) is
initialised by the JAX package and carried across as numpy
(``Gpt.load_variables``); both packages then run the same ids, masks and
caches, made from a seed with numpy. Dropout is 0 wherever the two are
compared: their generators draw different masks from one seed. Float32 on
both sides; matmuls and layer norms sum in another order.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.gpt import GptConfig as JaxGptConfig
from deeplearning4j_tpu.models.gpt import _truncate_logits as jax_truncate
from deeplearning4j_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from deeplearning4j_tpu.nn.config import (
    NeuralNetConfiguration as JaxNetConfig,
)
from deeplearning4j_tpu.nn.config import config_from_json as jax_from_json
from deeplearning4j_tpu.nn.config import config_to_json as jax_to_json
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig,
    _truncate_logits,
    gpt_long,
    gpt_tiny,
)
from deeplearning4j_tpu_torch.nn.config import (
    NeuralNetConfiguration,
    config_from_json,
    config_to_json,
)
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.train.trainer import RngKey, Trainer
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

VOCAB, N, T = 128, 4, 16
LR = 1e-3
SEED = 17
ATOL_LOGITS = 1e-5
RTOL_LOSS = 1e-6
GRAD_FRAC = 1e-5
ATOL_DECODE = 1e-5
# softmax ignores a shift of a whole row of scores, so the key biases'
# gradients are 0 in exact arithmetic: float32 rounding noise (~1e-9 of
# a largest gradient of ~0.2 here) on both sides
ZERO_GRAD = 1e-6


def _exactly_zero_grad(name):
    return name.endswith("attention/bk")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _net(mixed=False, jax_side=False):
    if jax_side:
        return JaxNetConfig(seed=SEED, updater=JaxAdam(LR), rng_impl="rbg",
                            mixed_precision=mixed)
    return NeuralNetConfiguration(seed=SEED, updater=Adam(LR),
                                  rng_impl="rbg", mixed_precision=mixed)


@pytest.fixture(scope="module")
def pair():
    jm = jax_gpt_tiny(net=_net(jax_side=True))
    jv = jax.tree_util.tree_map(np.asarray, jm.init(seed=3))
    tm = gpt_tiny(device="cpu", net=_net())
    tm.load_variables(variables_from_numpy(jv))
    return jm, jv, tm


def _ids(seed, n=N, t=T):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t)).astype(
        np.int32)


def _batch(seed, masked=True, labels=False):
    r = np.random.default_rng(seed)
    ids = r.integers(0, VOCAB, (N, T)).astype(np.int32)
    feats = {"token_ids": ids}
    if masked:
        lengths = np.array([T, 11, 5, 1])
        feats["mask"] = (np.arange(T)[None, :] < lengths[:, None]).astype(
            np.float32)
    batch = {"features": feats}
    if labels:
        batch["labels"] = r.integers(0, VOCAB, (N, T - 1)).astype(np.int32)
    return batch


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


# -- forward, loss, gradients ------------------------------------------------

def test_variable_names_and_shapes_match(pair):
    _, jv, tm = pair
    want = {n: a.shape for n, a in flatten_with_names(jv["params"])}
    got = {n: tuple(t.shape)
           for n, t in flatten_with_names(tm.variables()["params"])}
    assert got == want
    assert tm.num_params() == sum(int(np.prod(s)) for s in want.values())


@pytest.mark.parametrize("masked", [False, True])
def test_apply_logits_match_jax(pair, masked):
    jm, jv, tm = pair
    feats = _batch(1, masked=masked)["features"]
    want, _ = jax.jit(jm.apply)(jv, jax.tree_util.tree_map(jnp.asarray,
                                                           feats))
    with torch.inference_mode():
        got, state = tm.apply(tm.variables(), _t(feats))
    assert state == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_LOGITS)


@pytest.mark.parametrize("case", ["plain", "masked", "labels"])
def test_loss_fn_matches_jax(pair, case):
    jm, jv, tm = pair
    batch = _batch(2, masked=case != "plain", labels=case == "labels")
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    want, (_, jmetrics) = jax.jit(jm.loss_fn)(jv["params"], {}, jb)
    with torch.inference_mode():
        got, (state, metrics) = tm.loss_fn(tm.variables()["params"], {},
                                           _t(batch))
    assert state == {}
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_LOSS)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=RTOL_LOSS)


def test_loss_weight_is_exact(pair):
    jm, _, tm = pair
    for masked in (False, True):
        batch = _batch(3, masked=masked)
        want = float(jm.loss_weight(jax.tree_util.tree_map(jnp.asarray,
                                                           batch)))
        assert float(tm.loss_weight(_t(batch))) == want
    empty = _batch(3)
    empty["features"]["mask"][:] = 0.0
    assert float(tm.loss_weight(_t(empty))) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_every_gradient_matches_jax(pair, masked):
    """The tied ``embeddings/word`` gets gradient from the lookup and the
    head. Each leaf to GRAD_FRAC of its largest entry; the key biases,
    whose gradient is 0 in exact arithmetic, to ZERO_GRAD of the model's
    largest gradient on both sides."""
    jm, jv, tm = pair
    batch = _batch(4, masked=masked)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jgrads = jax.jit(jax.grad(lambda p: jm.loss_fn(p, {}, jb)[0]))(
        jv["params"])
    trainer = Trainer(tm)
    loss, _, _, grads = trainer._grad_of(_t(jv["params"]), {}, _t(batch),
                                         None)
    got, want = _np(grads), _np(jgrads)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        if _exactly_zero_grad(n):
            assert max(np.abs(got[n]).max(), np.abs(w).max()) \
                <= ZERO_GRAD * top, n
        else:
            assert np.abs(got[n] - w).max() <= GRAD_FRAC * np.abs(w).max(), n


@pytest.fixture(scope="module")
def jax_two_steps(pair):
    """The JAX package's Trainer (Adam, rng_impl="rbg"): two steps from
    the shared init, with copies of each state and each step's grads."""
    jm, jv, _ = pair
    trainer = JaxTrainer(jm)
    ts = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, jv))
    grad = jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, {}, b)[0]))
    states, losses, grads = [], [], []
    for b in (_batch(6), _batch(7)):
        grads.append(_np(grad(ts.params, jax.tree_util.tree_map(
            jnp.asarray, b))))
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        # copies: the next step donates this state's buffers
        states.append(jax.tree_util.tree_map(
            lambda x: jax.random.wrap_key_data(
                np.array(jax.random.key_data(x)),
                impl=str(jax.random.key_impl(x)))
            if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
            else np.array(x), ts))
    return trainer, states, losses, grads


# Adam's first steps move an entry by about lr·sign(g): an entry whose
# gradient is ~0 moves by up to ±lr on a rounding-level difference in g.
# The key biases (gradient 0 in exact arithmetic) and entries whose JAX
# gradient is under GRAD_FLOOR of its leaf's largest in any step so far
# are held to 2·lr a step instead of TOL_ADAM_PARAM; at most MAX_EXEMPT of
# all entries may be.
GRAD_FLOOR = 1e-5
TOL_ADAM_PARAM = 1e-6
MAX_EXEMPT = 0.02


def test_two_adam_steps_match_the_jax_trainer(pair, jax_two_steps):
    _, jv, _ = pair
    _, states, jlosses, jgrads = jax_two_steps
    trainer = Trainer(gpt_tiny(device="cpu", net=_net()))
    ts = trainer.init_state(jv)
    assert ts.rng == RngKey(SEED, "rbg")
    losses, exempt = [], {}
    for k, b in enumerate((_batch(6), _batch(7))):
        ts, m = trainer.train_step(ts, b)
        losses.append(float(m["total_loss"]))
        got, want = _np(ts.params), _np(states[k].params)
        assert got.keys() == want.keys() == jgrads[k].keys()
        n_exempt = n_all = 0
        for n, w in want.items():
            g = np.abs(jgrads[k][n])
            # an entry whose gradient is exactly 0 (a position no batch
            # reaches) does not move on either side: it stays held
            low = (g < GRAD_FLOOR * g.max()) & (g > 0)
            exempt[n] = exempt.get(n, False) | low | _exactly_zero_grad(n)
            err = np.abs(got[n] - w)
            assert err[~exempt[n]].max(initial=0) <= TOL_ADAM_PARAM, (k, n)
            assert err.max() <= 2 * (k + 1) * LR, (k, n)
            n_exempt += int(exempt[n].sum())
            n_all += w.size
        assert n_exempt <= MAX_EXEMPT * n_all, (k, n_exempt, n_all)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_rbg_checkpoints_cross_both_ways(pair, jax_two_steps, tmp_path):
    """A JAX checkpoint whose rng is an rbg key restores in the port
    bit-equal, key impl included, and the port's goes back the same way."""
    jm, jv, _ = pair
    jtrainer, states, jlosses, _ = jax_two_steps
    assert str(jax.random.key_impl(states[0].rng)) == "rbg"
    path = jax_ckpt.save_checkpoint(tmp_path / "jax", states[0], model=jm)
    trainer = Trainer(gpt_tiny(device="cpu", net=_net()))
    ts = ckpt.restore_checkpoint(path, trainer.init_state(jv))
    assert ts.step == 1 and ts.rng == RngKey(SEED, "rbg")
    np.testing.assert_array_equal(
        ts.rng.key_data(), np.asarray(jax.random.key_data(states[0].rng)))
    want = _np({"p": states[0].params, "o": states[0].opt_state})
    got = _np({"p": ts.params, "o": ts.opt_state})
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    _, m = trainer.train_step(ts, _batch(7))
    assert float(m["total_loss"]) == pytest.approx(jlosses[1], rel=1e-5)
    out = ckpt.save_checkpoint(tmp_path / "port", ts, model=trainer.model)
    assert jax_ckpt.verify_checkpoint(out, deep=True) == (True, "ok")
    template = jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray, jv))
    back = jax_ckpt.restore_checkpoint(out, template)
    assert str(jax.random.key_impl(back.rng)) == "rbg"
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(back.rng)),
        np.asarray(jax.random.key_data(states[0].rng)))
    for n, a in _np({"p": back.params, "o": back.opt_state}).items():
        np.testing.assert_array_equal(a, got[n], err_msg=n)
    assert jax_ckpt.load_model_config(out).net.rng_impl == "rbg"


def test_mixed_precision_loss_matches_jax(pair):
    """bf16 compute with float32 master params on both sides: the first
    step's loss agrees to bf16's resolution (the two round the logits and
    log-softmax at the same points, in another summation order)."""
    jm, jv, _ = pair
    jmix = jax_gpt_tiny(net=_net(mixed=True, jax_side=True))
    jtr = JaxTrainer(jmix)
    jts = jtr.init_state(jax.tree_util.tree_map(jnp.asarray, jv))
    _, jm_metrics = jtr.train_step(jts, _batch(8))
    trainer = Trainer(gpt_tiny(device="cpu", net=_net(mixed=True)))
    _, metrics = trainer.train_step(trainer.init_state(jv), _batch(8))
    assert metrics["total_loss"].dtype == torch.float32
    np.testing.assert_allclose(float(metrics["total_loss"]),
                               float(jm_metrics["total_loss"]), rtol=2e-2)


# -- the KV-cache decoder ------------------------------------------------------

def test_decode_step_matches_the_full_forward_at_every_position(pair):
    jm, jv, tm = pair
    ids = _ids(9, n=3, t=20)
    want, _ = jax.jit(jm.apply)(jv, jnp.asarray(ids))
    params = tm.variables()["params"]
    with torch.inference_mode():
        full, _ = tm.apply(tm.variables(), torch.from_numpy(ids))
        caches = tm.init_cache(3, 24)
        for t in range(ids.shape[1]):
            lg, caches = tm.decode_step(params, caches,
                                        torch.from_numpy(ids[:, t]), t)
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                       rtol=0, atol=ATOL_DECODE, err_msg=t)
            np.testing.assert_allclose(lg.numpy(), np.asarray(want[:, t]),
                                       rtol=0, atol=ATOL_DECODE, err_msg=t)


def test_decode_step_slots_matches_jax(pair):
    """Rows at their own positions, over caches holding earlier K/V
    (random, from a seed): logits and every written cache to 1e-5."""
    jm, jv, tm = pair
    r = np.random.default_rng(10)
    n, L, h, hd = 4, 12, 2, 32
    caches = [{"k": r.standard_normal((n, h, L, hd)).astype(np.float32),
               "v": r.standard_normal((n, h, L, hd)).astype(np.float32)}
              for _ in range(2)]
    ids = r.integers(0, VOCAB, n).astype(np.int32)
    pos = np.array([0, 5, 11, 3], np.int32)
    want_lg, want_c = jax.jit(jm.decode_step_slots)(
        jv["params"], jax.tree_util.tree_map(jnp.asarray, caches),
        jnp.asarray(ids), jnp.asarray(pos))
    with torch.inference_mode():
        got_lg, got_c = tm.decode_step_slots(
            tm.variables()["params"],
            jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                   caches),
            torch.from_numpy(ids), torch.from_numpy(pos))
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), rtol=0,
                               atol=ATOL_DECODE)
    for g, w in zip(got_c, want_c):
        for k in ("k", "v"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=ATOL_DECODE)


def test_prefill_chunk_matches_jax(pair):
    jm, jv, tm = pair
    ids = _ids(11, n=2, t=9)
    want_lg, want_kv = jax.jit(jm.prefill_chunk)(jv["params"],
                                                 jnp.asarray(ids))
    with torch.inference_mode():
        got_lg, got_kv = tm.prefill_chunk(tm.variables()["params"],
                                          torch.from_numpy(ids))
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), rtol=0,
                               atol=ATOL_DECODE)
    for g, w in zip(got_kv, want_kv):
        for k in ("k", "v"):
            assert g[k].shape == (2, 2, 9, 32)
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=ATOL_DECODE)


# -- generation ------------------------------------------------------------------

def test_greedy_generate_equals_jax(pair):
    jm, jv, tm = pair
    prime = _ids(12, n=3, t=6)
    want = jm.generate(jv, jnp.asarray(prime), n_steps=10,
                       rng=jax.random.key(0), temperature=0.0)
    got = tm.generate(tm.variables(), prime, n_steps=10, temperature=0.0,
                      max_len=20)
    assert got.dtype == torch.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_follows_its_generator(pair):
    _, _, tm = pair
    prime = _ids(13, n=2, t=4)

    def run(seed, **kw):
        return tm.generate(tm.variables(), prime, n_steps=8, rng=seed,
                           temperature=0.9, **kw).numpy()

    np.testing.assert_array_equal(run(5), run(5))
    assert not np.array_equal(run(5), run(6))
    assert run(5, top_k=1).tolist() == tm.generate(
        tm.variables(), prime, n_steps=8, temperature=0.0).tolist()
    out = run(7, top_k=4, top_p=0.8)
    assert out.min() >= 0 and out.max() < VOCAB


@pytest.mark.parametrize("eos,penalty", [(None, 0.0), (None, 0.7),
                                         ("greedy", 0.0), ("greedy", 0.7)])
def test_beam_search_equals_jax(pair, eos, penalty):
    jm, jv, tm = pair
    prime = _ids(14, n=2, t=5)
    if eos == "greedy":
        # a token greedy decoding emits early, so that beams do finish
        eos = int(tm.generate(tm.variables(), prime, n_steps=3,
                              temperature=0.0)[0, 1])
    want_s, want_sc = jm.beam_search(jv, jnp.asarray(prime), n_steps=7,
                                     beam_size=3, eos_id=eos,
                                     length_penalty=penalty)
    got_s, got_sc = tm.beam_search(tm.variables(), prime, n_steps=7,
                                   beam_size=3, eos_id=eos,
                                   length_penalty=penalty)
    assert got_s.dtype == torch.int32 and got_s.shape == (2, 3, 7)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("top_k,top_p", [(1, None), (5, None), (None, 0.5),
                                         (None, 0.9), (7, 0.6)])
def test_truncate_logits_masks_equal_jax(top_k, top_p):
    lg = np.random.default_rng(15).standard_normal((4, VOCAB)).astype(
        np.float32) * 3
    want = np.asarray(jax_truncate(jnp.asarray(lg), top_k, top_p))
    got = _truncate_logits(torch.from_numpy(lg), top_k, top_p).numpy()
    neg = np.finfo(np.float32).min
    np.testing.assert_array_equal(got == neg, want == neg)
    np.testing.assert_array_equal(got, want)


BAD_GENERATE = [
    dict(n_steps=10, max_len=8),            # max_len < prime + n_steps
    dict(n_steps=70),                       # beyond max_position 64
    dict(n_steps=4, top_k=0),
    dict(n_steps=4, top_p=0.0),
    dict(n_steps=4, top_p=1.5),
]
BAD_BEAM = [
    dict(n_steps=10, max_len=8),
    dict(n_steps=70),
    dict(n_steps=4, beam_size=0),
    dict(n_steps=4, beam_size=VOCAB + 1),
    dict(n_steps=0),
    dict(n_steps=4, length_penalty=-0.5),
]


@pytest.mark.parametrize("kw", BAD_GENERATE + [dict(kw, beam=True)
                                               for kw in BAD_BEAM])
def test_argument_checks_raise_where_jax_does(pair, kw):
    jm, jv, tm = pair
    kw = dict(kw)
    beam = kw.pop("beam", False)
    prime = _ids(16, n=1, t=4)
    if beam:
        calls = (lambda: jm.beam_search(jv, jnp.asarray(prime), **kw),
                 lambda: tm.beam_search(tm.variables(), prime, **kw))
    else:
        calls = (lambda: jm.generate(jv, jnp.asarray(prime),
                                     rng=jax.random.key(0), **kw),
                 lambda: tm.generate(tm.variables(), prime, rng=0, **kw))
    for call in calls:
        with pytest.raises(ValueError):
            call()


# -- config ------------------------------------------------------------------------

def test_config_json_crosses_both_ways():
    cfg = JaxGptConfig(hidden=96, num_layers=3, num_heads=4,
                       max_position=512, net=JaxNetConfig(
                           updater=JaxAdam(1e-4), mixed_precision=True,
                           rng_impl="rbg"))
    port = config_from_json(jax_to_json(cfg))
    assert isinstance(port, GptConfig)
    assert (port.hidden, port.num_layers, port.num_heads,
            port.max_position) == (96, 3, 4, 512)
    assert port.net.rng_impl == "rbg" and port.net.mixed_precision
    assert port.net.updater.lr == 1e-4
    back = jax_from_json(config_to_json(port))
    assert json.loads(jax_to_json(back)) == json.loads(jax_to_json(cfg))


def test_gpt_long_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 8"):
        gpt_long(device="cpu", hidden=64, num_layers=1, num_heads=2,
                 vocab_size=VOCAB, max_position=128)
