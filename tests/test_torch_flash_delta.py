"""The flash backward's delta = rowsum(dO·O), the port's plain version.

``reference_delta`` is the plain twin of the ``flash_bwd_delta`` kernel
(``csrc/flash_bwd.cu``; held against it on the card in
test_torch_flash_bwd_cuda.py). Here it is held against the JAX package's
expression (``_flash_bwd_impl``: ``jnp.sum(out.astype(f32) *
g.astype(f32), axis=-1)``), jitted, on the same seeded numpy inputs, and
``reference_attention_bwd``, which now reads it, against the backward as
it was written before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels.flash_attention import (
    reference_attention_bwd,
    reference_attention_lse,
    reference_delta,
)

# both sides multiply the same float32 values (bf16 x bf16 is exact in
# float32) and sum D products in float32 in their own order: a few ulp
# of the row's sum of |products|
TOL_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@jax.jit
def _jax_delta(out, g):
    # deeplearning4j_tpu/kernels/flash_attention.py _flash_bwd_impl's sum
    return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32), axis=-1)


def _rows(b, h, t, d, seed):
    """out and g [b, h, t, d] float32 from a seed; row (0, 0, 1) of out
    all zeros (a row whose delta is exactly 0)."""
    r = np.random.default_rng(seed)
    out, g = (r.standard_normal((b, h, t, d)).astype(np.float32)
              for _ in range(2))
    out[0, 0, 1] = 0.0
    return out, g


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_delta_matches_the_jax_expression(dtype, d):
    b, h, t = 2, 3, 17
    out, g = _rows(b, h, t, d, seed=d)
    tdt = getattr(torch, dtype)
    out_t, g_t = (torch.from_numpy(x).to(tdt) for x in (out, g))
    got = reference_delta(out_t, g_t)
    assert got.dtype == torch.float32 and got.shape == (b * h, t)
    want = np.asarray(_jax_delta(jnp.asarray(out, getattr(jnp, dtype)),
                                 jnp.asarray(g, getattr(jnp, dtype))))
    want = want.reshape(b * h, t)
    # the same float32 inputs on both sides (bf16 rounds to nearest even
    # in both frameworks)
    mag = (out_t.float() * g_t.float()).abs().sum(-1).reshape(b * h, t)
    err = np.abs(got.numpy() - want)
    assert (err <= TOL_REL * mag.numpy()).all(), float(err.max())
    assert got[0, 1].item() == 0.0 and want[0, 1] == 0.0


def _bwd_before(q, k, v, key_mask, out, lse, g, *, causal=False):
    """``reference_attention_bwd`` as it was written before it read
    ``reference_delta``: the same function, delta summed in place."""
    d = q.shape[-1]
    scale = d ** -0.5
    b, h, t, _ = q.shape
    s_len = k.shape[2]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    keep = torch.ones((1, 1, t, s_len), dtype=torch.bool)
    if key_mask is not None:
        keep = keep & (key_mask[:, None, None, :] > 0)
    if causal:
        keep = keep & (torch.arange(t)[:, None] + (s_len - t)
                       >= torch.arange(s_len)[None, :])
    s = torch.where(keep, s, -1e30)
    lse = torch.clamp(lse.reshape(b, h, t, 1), min=-1e20)
    p = torch.exp(s - lse)
    delta = torch.sum(out.float() * gf, dim=-1, keepdim=True)
    dp = torch.einsum("bhtd,bhsd->bhts", gf, vf)
    ds = p * (dp - delta) * scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bhts,bhtd->bhsd", p, gf)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_attention_bwd_is_unchanged(dtype, causal):
    b, h, t, s, d = 2, 2, 12, 20, 32
    r = np.random.default_rng(7)
    q, g = (r.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(2))
    k, v = (r.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(2))
    tdt = getattr(torch, dtype)
    q, g, k, v = (torch.from_numpy(x).to(tdt) for x in (q, g, k, v))
    mask = (torch.arange(s)[None, :] < torch.tensor([s, 0])[:, None]).float()
    out, lse = reference_attention_lse(q, k, v, causal=causal, key_mask=mask)
    got = reference_attention_bwd(q, k, v, mask, out, lse, g, causal=causal)
    want = _bwd_before(q, k, v, mask, out, lse, g, causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, w), name
