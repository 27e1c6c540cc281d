"""The port's attention against the JAX package's Pallas flash kernel.

The JAX side runs its own kernel as its tests run it on the CPU
(``DL4J_TPU_FORCE_PALLAS=1``: interpret mode), with small explicit blocks so
several q and kv blocks are crossed; the port's side is its plain version
(``reference_attention``, ``reference_attention_lse``), which is what a CPU
tensor dispatches to. The inputs are made from a seed with numpy and handed
to both, in float32 and in bfloat16.
"""

import subprocess
import sys

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
    reference_attention_lse,
)

# fp32 on both sides; the kernel's blockwise online softmax sums in another
# order than one softmax over the row: a few ulp of values of order 1.
ATOL = 2e-5

# (name, B, H, T, S, D, causal, key lengths per batch row; None = no mask)
CASES = [
    ("no_mask", 2, 2, 24, 24, 32, False, None),
    ("padded_keys", 2, 2, 24, 40, 64, False, [40, 17]),
    ("causal_t_eq_s", 2, 2, 32, 32, 32, True, None),
    ("causal_t_lt_s", 2, 2, 16, 40, 64, True, None),
    ("causal_padded", 2, 2, 40, 40, 64, True, [33, 40]),
    ("zero_mask_row", 3, 2, 24, 24, 64, False, [24, 0, 11]),
]

# bf16 inputs on both sides, the card's tolerance (chip_smoke.py TOL): both
# score in float32, but the plain version rounds the normalised p to bf16
# before its second matmul and the Pallas kernel the unnormalised p (its
# l sums the float32 p), and both round the output: measured on this host
# at most 0.0156, 2 bf16 ulp of outputs up to 3.
ATOL_BF16 = 3e-2
BF16_CASES = [
    ("padded_keys_d32", 2, 2, 24, 40, 32, False, [40, 17]),
    ("causal_t_lt_s_d64", 2, 2, 16, 40, 64, True, None),
    ("zero_mask_row_d128", 3, 2, 24, 24, 128, False, [24, 0, 11]),
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
    q = r.standard_normal((b, h, t, d)).astype(np.float32)
    k = r.standard_normal((b, h, s, d)).astype(np.float32)
    v = r.standard_normal((b, h, s, d)).astype(np.float32)
    mask = None
    if lengths is not None:
        mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
            np.float32)
    return q, k, v, mask


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_jax_pallas_kernel(case, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FORCE_PALLAS", "1")
    name, b, h, t, s, d, causal, lengths = case
    q, k, v, mask = _inputs(b, h, t, s, d, lengths, seed=len(name))
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        key_mask=None if mask is None else jnp.asarray(mask),
        block_q=8, block_k=16))
    _dispatch.reset_launch_counts()
    got = reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        key_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    # Fully-masked rows differ by design (kernel 0, reference uniform);
    # they are the batch rows whose key mask is all zero.
    live = (np.ones(b, bool) if lengths is None
            else np.asarray(lengths) > 0)
    np.testing.assert_allclose(got[live], want[live], atol=ATOL)
    if not live.all():
        assert np.all(want[~live] == 0.0)  # the kernel's 0 on dead rows
    assert _dispatch.launch_counts() == {}


@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_reference_matches_jax_pallas_kernel(case, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FORCE_PALLAS", "1")
    name, b, h, t, s, d, causal, lengths = case
    q, k, v, mask = _inputs(b, h, t, s, d, lengths, seed=len(name))
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)),
        causal=causal, key_mask=None if mask is None else jnp.asarray(mask),
        block_q=8, block_k=16).astype(jnp.float32))
    got = reference_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=causal,
        key_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    live = (np.ones(b, bool) if lengths is None
            else np.asarray(lengths) > 0)
    np.testing.assert_allclose(got.float().numpy()[live], want[live],
                               atol=ATOL_BF16)
    if not live.all():
        assert np.all(want[~live] == 0.0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_lse_matches_jax_pallas_lse(case, monkeypatch):
    """The row log-sum-exp the backward reads: the plain version's against
    the one the Pallas kernel saves (about -1e30 on both sides for the
    rows whose keys are all masked)."""
    monkeypatch.setenv("DL4J_TPU_FORCE_PALLAS", "1")
    name, b, h, t, s, d, causal, lengths = case
    q, k, v, mask = _inputs(b, h, t, s, d, lengths, seed=len(name))
    _, lse = jax_fa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal,
        scale=d ** -0.5, block_q=8, block_k=16, save_lse=True)
    want = np.asarray(lse[:, :t, 0])
    _, got = reference_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        key_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (b * h, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_cpu_tensor_runs_plain_version_and_counts_no_launch():
    q, k, v, mask = _inputs(2, 2, 16, 16, 32, [16, 5], seed=7)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    _dispatch.reset_launch_counts()
    got = flash_attention(tq, tk, tv, key_mask=tm)
    want = reference_attention(tq, tk, tv, key_mask=tm)
    assert torch.equal(got, want)
    assert _dispatch.launch_counts() == {}


def test_bias_on_cpu_is_the_plain_version():
    q, k, v, _ = _inputs(1, 2, 8, 8, 32, None, seed=8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    bias = torch.zeros(1, 2, 8, 8)
    bias[..., 3] = -1e30
    got = flash_attention(tq, tk, tv, bias=bias)
    mask = torch.ones(1, 8)
    mask[0, 3] = 0
    torch.testing.assert_close(
        got, reference_attention(tq, tk, tv, key_mask=mask))


def test_module_imports_without_nvcc_or_card():
    code = (
        "import os, shutil; "
        "os.environ['PATH'] = ''; os.environ.pop('CUDA_HOME', None); "
        "import deeplearning4j_tpu_torch.kernels.flash_attention as fa; "
        "from deeplearning4j_tpu_torch.kernels import _build; "
        "assert not _build._libs and not _build._built; "
        "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
