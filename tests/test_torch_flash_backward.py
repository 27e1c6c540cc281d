"""The port's attention backward against the JAX package's Pallas kernels.

The JAX side differentiates its own ``flash_attention`` as its tests run it
on the CPU (``DL4J_TPU_FORCE_PALLAS=1``: the two backward Pallas kernels in
interpret mode), with small explicit blocks so several q and kv blocks are
crossed. The port's side is what a CPU tensor runs: ``reference_attention_bwd``
from the saved LSE, reached through the autograd ``flash_attention``. The
inputs and the output cotangent are made from a seed with numpy and handed
to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention,
)
from deeplearning4j_tpu_torch.kernels import _dispatch
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention,
    reference_attention,
    reference_attention_bwd,
    reference_attention_lse,
)

# fp32 on both sides; the Pallas kernels sum blockwise over 8-query and
# 16-key blocks, the plain version over whole rows: a few ulp of gradients
# of order 1-10.
ATOL = 1e-4

# (name, B, H, T, S, D, causal, key lengths per batch row; None = no mask)
CASES = [
    ("no_mask", 2, 2, 24, 24, 32, False, None),
    ("padded_keys", 2, 2, 24, 40, 64, False, [40, 17]),
    ("causal_t_eq_s", 2, 2, 32, 32, 32, True, None),
    ("causal_t_lt_s", 2, 2, 16, 40, 64, True, None),
    ("causal_padded", 2, 2, 40, 40, 64, True, [33, 40]),
    ("zero_mask_row", 3, 2, 24, 24, 64, False, [24, 0, 11]),
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(b, h, t, s, d, lengths, seed):
    r = np.random.default_rng(seed)
    q, g = (r.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(2))
    k, v = (r.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(2))
    mask = None
    if lengths is not None:
        mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
            np.float32)
    return q, k, v, g, mask


def _port_grads(q, k, v, g, mask, causal):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(
        *leaves, causal=causal,
        key_mask=None if mask is None else torch.from_numpy(mask))
    return [x.numpy() for x in torch.autograd.grad(out, leaves,
                                                   torch.from_numpy(g))]


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's Pallas backward for every case, computed once."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DL4J_TPU_FORCE_PALLAS", "1")
    try:
        out = {}
        for name, b, h, t, s, d, causal, lengths in CASES:
            q, k, v, g, mask = _inputs(b, h, t, s, d, lengths, len(name))

            @jax.jit  # one compiled program: faster than eager interpret
            def grads(q, k, v, g, km, causal=causal):
                _, vjp = jax.vjp(lambda *qkv: jax_flash_attention(
                    *qkv, causal=causal, key_mask=km, block_q=8,
                    block_k=16), q, k, v)
                return vjp(g)

            out[name] = [np.asarray(x) for x in grads(
                q, k, v, g, None if mask is None else jnp.asarray(mask))]
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_jax_pallas_kernels(case, jax_grads):
    name, b, h, t, s, d, causal, lengths = case
    q, k, v, g, mask = _inputs(b, h, t, s, d, lengths, len(name))
    want = jax_grads[name]
    _dispatch.reset_launch_counts()
    got = _port_grads(q, k, v, g, mask, causal)
    assert _dispatch.launch_counts() == {}  # CPU tensors: plain versions
    # both backwards give 0 on fully-masked rows, so every row compares
    for which, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=ATOL, err_msg=which)
    # and the plain backward called directly, from the plain forward's LSE
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = reference_attention_lse(tq, tk, tv, causal=causal,
                                       key_mask=tm)
    direct = reference_attention_bwd(tq, tk, tv, tm, out, lse, tg,
                                     causal=causal)
    for a, w in zip(direct, got):
        np.testing.assert_array_equal(a.numpy(), w)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_autograd_of_reference(case):
    name, b, h, t, s, d, causal, lengths = case
    q, k, v, g, mask = _inputs(b, h, t, s, d, lengths, len(name))
    got = _port_grads(q, k, v, g, mask, causal)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref = reference_attention(
        *leaves, causal=causal,
        key_mask=None if mask is None else torch.from_numpy(mask))
    want = torch.autograd.grad(ref, leaves, torch.from_numpy(g))
    # rows whose keys are all masked differ by design: the reference's
    # uniform attention there has gradients, the flash backward gives 0
    live = (np.ones(b, bool) if lengths is None
            else np.asarray(lengths) > 0)
    for which, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a[live], w.numpy()[live], atol=ATOL,
                                   err_msg=which)


# bf16 inputs: (name, B, H, T, S, D, causal, key lengths per batch row)
BF16_CASES = [
    ("padded_keys", 2, 2, 32, 48, 64, False, [48, 20]),
    ("causal_padded", 2, 2, 40, 40, 64, True, [33, 40]),
    ("zero_mask_row_d32", 3, 2, 24, 24, 32, False, [24, 0, 11]),
]


@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_backward_rounds_p_and_ds_as_the_pallas_kernels(case,
                                                            monkeypatch):
    """bf16 inputs: the JAX package's Pallas backward (interpret mode; off
    the TPU ``_matmul_dtype`` keeps bf16, so P and dS enter their products
    in bf16) against the port's plain backward, both from the JAX
    forward's output and LSE. Each gradient is within 1 bf16 ulp of its
    largest magnitude (2^-7 of it) everywhere, and at most 0.1% of its
    elements differ by more than 1/64 of that ulp: the two sum in float32
    in another order, which may flip a final rounding. Feeding P and dS
    to the products in float32 instead (the plain backward before it
    rounded them) puts 17-26% of the elements beyond that."""
    monkeypatch.setenv("DL4J_TPU_FORCE_PALLAS", "1")
    name, b, h, t, s, d, causal, lengths = case
    q, k, v, g, mask = _inputs(b, h, t, s, d, lengths, len(name))
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    jm = jnp.asarray(mask)
    scale = d ** -0.5
    out, lse = jax_fa._flash_fwd(jq, jk, jv, jm, causal=causal, scale=scale,
                                 block_q=8, block_k=16, save_lse=True)
    want = jax_fa._flash_bwd_impl(jq, jk, jv, jm, out, lse, jg,
                                  causal=causal, scale=scale, block_q=8,
                                  block_k=16)

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    got = reference_attention_bwd(
        bf16(jq), bf16(jk), bf16(jv), torch.from_numpy(mask), bf16(out),
        torch.from_numpy(np.array(lse[:, :t, 0])), bf16(jg), causal=causal)
    for which, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, which
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        err = np.abs(a - w)
        assert err.max() <= ulp, (which, err.max(), ulp)
        assert np.mean(err > ulp / 64) <= 1e-3, (which, np.mean(err > 0))


def test_fully_masked_rows_get_zero_grads():
    q, k, v, g, mask = _inputs(3, 2, 16, 16, 32, [16, 0, 5], seed=9)
    dq, dk, dv = _port_grads(q, k, v, g, mask, causal=False)
    for x in (dq, dk, dv):
        assert np.all(x[1] == 0.0) and np.all(np.isfinite(x))
    # masked keys of live rows get dK = dV = 0 too
    assert np.all(dk[2, :, 5:] == 0.0) and np.all(dv[2, :, 5:] == 0.0)


def test_lse_matches_logsumexp_of_scores():
    q, k, v, _, mask = _inputs(2, 2, 8, 12, 32, [12, 3], seed=4)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    out, lse = reference_attention_lse(tq, tk, tv, key_mask=tm)
    torch.testing.assert_close(out, reference_attention(tq, tk, tv,
                                                        key_mask=tm))
    s = np.einsum("bhtd,bhsd->bhts", q, k) / np.sqrt(32)
    s = np.where(mask[:, None, None, :] > 0, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want.reshape(4, 8), rtol=1e-5)


def test_inference_mode_keeps_the_forward_only_path():
    q, k, v, _, mask = _inputs(1, 2, 8, 8, 32, [8], seed=3)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.inference_mode():
        out = flash_attention(*leaves, key_mask=torch.from_numpy(mask))
    assert out.grad_fn is None
    torch.testing.assert_close(out, reference_attention(
        *[x.detach() for x in leaves], key_mask=torch.from_numpy(mask)))


def test_cuda_wrapper_refuses_cpu_tensors():
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda,
    )

    q, k, v, g, mask = _inputs(1, 2, 8, 8, 32, [8], seed=5)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = reference_attention_lse(tq, tk, tv)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(tq, tk, tv, None, out, lse, tg)
