"""The port's CUDA flash-attention forward kernels on the card.

Marked ``cuda``: each test needs an NVIDIA Hopper card and skips without
one (the kernel has no CPU or interpret mode; its CPU-side twin, the plain
version, is held against the JAX package in test_torch_flash_attention.py).
On a host with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_flash_cuda.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _dispatch
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_cuda,
    reference_attention,
    reference_attention_lse,
)
from deeplearning4j_tpu_torch.models.bert import bert_tiny
from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod

pytestmark = pytest.mark.cuda

# kernel vs plain version on the card: float32 — the kernel's products are
# 3xTF32 (each operand split into two TF32 parts that keep about 21 of its
# 24 bits) and it sums blockwise in another order (a few ulp of O(1)
# values); bfloat16 — both round the
# probabilities to bf16 before the second matmul, but at another point:
# the plain version the normalised p, the kernel (tensor cores) the
# unnormalised p as the Pallas kernel does; the plain version also rounds
# the scores to bf16, and both round the output (eps 2^-8).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the row LSE against the plain one of the inputs in float32, rows that
# see a key: the bf16 kernel's bf16 x bf16 products are exact in float32
TOL_LSE = 1e-4
# the float32 kernel against a float64 evaluation of the same inputs,
# entry by entry, as a fraction of max(1, |float64|): float32-grade, the
# gate of the float32 backward (test_torch_flash_bwd_cuda.py); a single
# TF32 pass (about 1e-3) would not pass
TOL_FP32_GRADE = 1e-5
# bf16 gradients through the three kernels vs the float32 plain path, max
# |difference| / max(1, max |plain|): P, dS, O and each gradient rounded
# to bf16 (chip_smoke.py TOL_BWD)
TOL_BWD = 1e-2

# (B, H, T, S, D, dtype, causal, key lengths per batch row)
CASES = {
    "padded_fp32": (3, 4, 128, 128, 64, torch.float32, False, [128, 37, 0]),
    "padded_bf16": (3, 4, 128, 128, 64, torch.bfloat16, False, [128, 37, 0]),
    "causal_t_lt_s_d32": (2, 2, 50, 130, 32, torch.float32, True, None),
    "ragged_d128": (2, 2, 70, 90, 128, torch.bfloat16, True, [90, 41]),
    # the bf16 kernel's branches: each head size, ragged T and S (not
    # multiples of 64), causal with T < S, a batch row with every key
    # masked, 64-key tiles whose keys are all masked (row 1: keys 40-199
    # of 200), and five key tiles in one row (S = 300)
    "ragged_d32_dead_row_bf16": (2, 3, 70, 100, 32, torch.bfloat16, False,
                                 [100, 0]),
    "causal_t_lt_s_bf16": (2, 3, 64, 130, 64, torch.bfloat16, True, None),
    "causal_t_lt_s_d128_bf16": (1, 2, 70, 200, 128, torch.bfloat16, True,
                                [200]),
    "ragged_d128_bf16": (2, 2, 130, 100, 128, torch.bfloat16, False,
                         [100, 37]),
    "masked_key_tiles_bf16": (2, 2, 100, 200, 64, torch.bfloat16, False,
                              [200, 40]),
    "five_key_tiles_d128_bf16": (2, 2, 130, 300, 128, torch.bfloat16, False,
                                 [300, 129]),
    # the same edges of the float32 kernel's 64-row tiles: T and S not
    # multiples of 64, 64-key tiles whose keys are all masked (row 1: keys
    # 40-199 of 200), a batch row with every key masked at D = 32, causal
    # with T < S at D = 64 and D = 128
    "ragged_t130_d128_fp32": (2, 2, 130, 100, 128, torch.float32, False,
                              [100, 37]),
    "masked_key_tiles_fp32": (2, 2, 100, 200, 64, torch.float32, False,
                              [200, 40]),
    "ragged_d32_dead_row_fp32": (2, 3, 70, 100, 32, torch.float32, False,
                                 [100, 0]),
    "causal_t_lt_s_fp32": (2, 3, 64, 130, 64, torch.float32, True, None),
    "causal_t_lt_s_d128_fp32": (1, 2, 70, 200, 128, torch.float32, True,
                                [200]),
    # BERT's longest sequences (phase 2, T = 512): eight key tiles summed
    # into each output row
    "long_t512_fp32": (2, 2, 512, 512, 64, torch.float32, False, [512, 300]),
    # GPT-2-small's causal attention (12 heads of 64): the training shape
    # (batch 8 x 512, eight 64-row tiles, the early loop end and the
    # diagonal tiles' masks over all of them), a ragged causal batch with
    # a dead row, and GPT-2's context of 1024 (the length from which the
    # JAX package runs its Pallas kernel)
    "gpt_causal_t512_fp32": (8, 12, 512, 512, 64, torch.float32, True, None),
    "gpt_causal_t512_bf16": (8, 12, 512, 512, 64, torch.bfloat16, True,
                             None),
    "gpt_causal_ragged_t512_fp32": (4, 12, 512, 512, 64, torch.float32,
                                    True, [512, 377, 63, 0]),
    "gpt_causal_ragged_t512_bf16": (4, 12, 512, 512, 64, torch.bfloat16,
                                    True, [512, 377, 63, 0]),
    "gpt_causal_t1024_fp32": (4, 12, 1024, 1024, 64, torch.float32, True,
                              None),
    "gpt_causal_t1024_bf16": (4, 12, 1024, 1024, 64, torch.bfloat16, True,
                              None),
}
# a single query tile of 1 or 4 rows (LearnedSelfAttention's few learned
# queries; the rest of the tile dead) against one key tile (S = 64) or
# three, the last ragged (S = 130); causal aligns the few queries to the
# last keys
CASES.update({
    f"t{t}_s{s}{'_causal' if causal else ''}_{tag}":
        (2, 3, t, s, 64, dtype, causal, None)
    for t in (1, 4) for s in (64, 130) for causal in (False, True)
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))})
BF16_CASES = sorted(c for c in CASES if CASES[c][5] == torch.bfloat16)
FP32_CASES = sorted(c for c in CASES if CASES[c][5] == torch.float32)
# head sizes the kernels lack, run zero-padded to the next kernel size by
# flash_attention (pad_head): the seq2seq example's CrossAttention (1024
# sequences x 4 heads of 16, T = S = 10), and D = 48 with masked keys
PADDED_CASES = {
    "seq2seq_d16_fp32": (1024, 4, 10, 10, 16, torch.float32, False, None),
    "seq2seq_d16_bf16": (1024, 4, 10, 10, 16, torch.bfloat16, False, None),
    "d48_padded_fp32": (2, 3, 70, 100, 48, torch.float32, False, [100, 41]),
    "d48_causal_bf16": (2, 3, 70, 100, 48, torch.bfloat16, True, [100, 41]),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel has no "
                    "CPU mode")
    from deeplearning4j_tpu_torch.runtime.device import require_hopper

    torch.backends.cuda.matmul.allow_tf32 = False
    return require_hopper()


def _inputs(dev, b, h, t, s, d, dtype, lengths):
    g = torch.Generator().manual_seed(b * t + s + d)
    q, k, v = (torch.randn((b, h, n, d), generator=g).to(dev, dtype)
               for n in (t, s, s))
    mask = None
    if lengths is not None:
        mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]
                ).to(dev, torch.float32)
    return q, k, v, mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(dev, case):
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask = _inputs(dev, b, h, t, s, d, dtype, lengths)
    _dispatch.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, key_mask=mask)
    assert _dispatch.launch_counts() == {"flash_fwd": 1}
    want = reference_attention(q, k, v, causal=causal, key_mask=mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    live = (torch.tensor(lengths) > 0 if lengths is not None
            else torch.ones(b, dtype=torch.bool)).to(dev)
    err = (got.float() - want.float())[live].abs().max().item()
    assert err <= TOL[dtype], err
    assert (got[~live] == 0).all()  # fully-masked rows: 0, never NaN


def _keep(dev, b, t, s, causal, mask):
    """[B, 1, T, S] bool: the pairs the masks leave visible."""
    keep = torch.ones((b, 1, t, s), dtype=torch.bool, device=dev)
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    if causal:
        keep = keep & (torch.arange(t, device=dev)[:, None] + (s - t)
                       >= torch.arange(s, device=dev)[None, :])
    return keep


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_lse_matches_plain_lse(dev, case):
    """The row LSE the backward reads, against the plain version's of the
    inputs in float32; rows that see no key at about -7e29 (the backward
    clamps at -1e20). The output is the one written without the LSE."""
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask = _inputs(dev, b, h, t, s, d, dtype, lengths)
    out, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                    return_lse=True)
    _, want = reference_attention_lse(q.float(), k.float(), v.float(),
                                      causal=causal, key_mask=mask)
    torch.cuda.synchronize()
    assert lse.shape == (b * h, t) and lse.dtype == torch.float32
    rows = _keep(dev, b, t, s, causal, mask).any(-1).expand(b, h, t)
    rows = rows.reshape(b * h, t)
    err = (lse - want)[rows].abs()
    assert bool((err <= TOL_LSE * want[rows].abs().clamp(min=1.0)).all()), \
        err.max().item()
    assert bool((lse[~rows] <= -1e20).all())
    assert torch.equal(out, flash_attention_cuda(q, k, v, mask,
                                                 causal=causal))


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernel_error_is_of_the_order_of_sdpa(dev, case):
    """The bf16 kernel's error against the plain version of the inputs in
    float32, beside that of PyTorch's own bf16 attention
    (``scaled_dot_product_attention`` with the same key and bottom-right
    causal mask), over the rows that see a key: at most 4x SDPA's, or one
    bf16 ulp (2^-7) of max(1, max |plain|)."""
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask = _inputs(dev, b, h, t, s, d, dtype, lengths)
    got = flash_attention_cuda(q, k, v, mask, causal=causal)
    want = reference_attention(q.float(), k.float(), v.float(),
                               causal=causal, key_mask=mask)
    keep = _keep(dev, b, t, s, causal, mask)
    rows = keep.any(-1, keepdim=True)  # [b, 1, t, 1]
    # rows that see no key would be NaN in SDPA: let them see everything
    # and drop them below
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=keep | ~rows)
    torch.cuda.synchronize()
    live = rows.expand(-1, h, -1, d)
    err = (got.float() - want)[live].abs().max().item()
    lib_err = (sdpa.float() - want)[live].abs().max().item()
    ref = max(1.0, want.abs().max().item())
    assert err <= max(4 * lib_err, 2 ** -7 * ref), (err, lib_err)


def _fwd_float64(q, k, v, mask, causal):
    """The forward written out again in float64 from the same inputs →
    (O, LSE [B·H, T] in natural log, the [B, 1, T, 1] bool of the rows
    that see a key). Rows that see no key get uniform attention here and
    are left out by the callers."""
    b, h, t, d = q.shape
    s = k.shape[2]
    keep = _keep(q.device, b, t, s, causal, mask)
    rows = keep.any(-1, keepdim=True)
    scores = torch.einsum("bhtd,bhsd->bhts", q.double(), k.double())
    scores = (scores * d ** -0.5).masked_fill(~(keep | ~rows),
                                              float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", torch.exp(scores - lse[..., None]),
                       v.double())
    return out, lse.reshape(b * h, t), rows


@pytest.mark.parametrize("case", FP32_CASES)
def test_fp32_forward_is_float32_grade(dev, case, record_property):
    """The float32 kernel (3xTF32 products on the tensor cores) against a
    float64 evaluation of the same inputs: O and the row LSE within
    TOL_FP32_GRADE of max(1, |float64|), entry by entry, over the rows that
    see a key; rows that see none give 0 and an LSE of at most -1e20.
    SDPA's float32 forward (the same key and bottom-right causal mask)
    against the same float64 values is recorded beside the kernel's."""
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask = _inputs(dev, b, h, t, s, d, dtype, lengths)
    got, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                    return_lse=True)
    want, want_lse, rows = _fwd_float64(q, k, v, mask, causal)
    keep = _keep(dev, b, t, s, causal, mask)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=keep | ~rows)
    torch.cuda.synchronize()
    live = rows.expand(-1, h, -1, d)
    live_lse = rows[..., 0].expand(b, h, t).reshape(b * h, t)
    errs = {}
    for name, a, w, m in (("out", got, want, live),
                          ("lse", lse, want_lse, live_lse),
                          ("sdpa_out", sdpa, want, live)):
        diff = (a.double() - w)[m].abs()
        errs[name] = (diff / w[m].abs().clamp(min=1.0)).max().item()
        record_property(f"{name}_err", errs[name])
    print(f"{case}: kernel out {errs['out']:.3e} lse {errs['lse']:.3e}, "
          f"sdpa out {errs['sdpa_out']:.3e} (x max(1, |float64|))")
    assert errs["out"] <= TOL_FP32_GRADE, errs
    assert errs["lse"] <= TOL_FP32_GRADE, errs
    assert (got[~live] == 0).all()
    assert bool((lse[~live_lse] <= -1e20).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_kernel_is_deterministic(dev, case):
    """One writer per output element and no atomics: two runs on the same
    inputs give the same bits, output and LSE."""
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask = _inputs(dev, b, h, t, s, d, dtype, lengths)
    first = flash_attention_cuda(q, k, v, mask, causal=causal,
                                 return_lse=True)
    second = flash_attention_cuda(q, k, v, mask, causal=causal,
                                  return_lse=True)
    torch.cuda.synchronize()
    for name, a, c in zip(("out", "lse"), first, second):
        assert torch.equal(a, c), name


def test_bf16_autograd_goes_through_the_three_kernels(dev):
    """bf16 attention with grad: the tensor-core forward's LSE feeds the
    tensor-core backward pair; gradients against autograd of the plain
    version of the inputs in float32."""
    q, k, v, mask = _inputs(dev, 2, 3, 100, 100, 64, torch.bfloat16,
                            [100, 37])
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)
                       ).to(dev, torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    _dispatch.reset_launch_counts()
    out = flash_attention(*leaves, key_mask=mask)
    got = torch.autograd.grad(out, leaves, dout)
    assert _dispatch.launch_counts() == {
        "flash_fwd": 1, "flash_bwd_delta": 1, "flash_bwd_dkv": 1,
        "flash_bwd_dq": 1}
    plain = [x.float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        reference_attention(*plain, key_mask=mask), plain, dout.float())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        ref = max(1.0, w.abs().max().item())
        err = (a.float() - w).abs().max().item()
        assert err <= TOL_BWD * ref, (name, err, ref)


@pytest.mark.parametrize("case", sorted(PADDED_CASES))
def test_padded_head_size_runs_the_kernel(dev, case):
    """A head size the kernels lack runs the forward kernel once on q, k
    and v zero-padded to the next kernel size, with the scale of the
    original D; the output, sliced back to D, against the plain version
    at D."""
    b, h, t, s, d, dtype, causal, lengths = PADDED_CASES[case]
    q, k, v, mask = _inputs(dev, b, h, t, s, d, dtype, lengths)
    _dispatch.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, key_mask=mask)
    assert _dispatch.launch_counts() == {"flash_fwd": 1}
    want = reference_attention(q, k, v, causal=causal, key_mask=mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_call_the_kernel_refuses_raises(dev, dtype, monkeypatch):
    """Past the wrapper's checks, a head size without a kernel is refused
    by the C entry point and raises: never another kernel, never the plain
    version."""
    monkeypatch.setattr(fa, "HEAD_DIMS", fa.HEAD_DIMS + (48,))
    q, k, v, mask = _inputs(dev, 1, 2, 16, 16, 48, dtype, [16])
    _dispatch.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_fwd launch failed"):
        flash_attention(q, k, v, key_mask=mask)
    assert _dispatch.launch_counts() == {}


@pytest.mark.parametrize("bad", ["bias", "head_size_160", "cpu_mask"])
def test_what_the_kernel_does_not_take_raises(dev, bad):
    q, k, v, mask = _inputs(dev, 1, 2, 16, 16, 160 if bad == "head_size_160"
                            else 32, torch.float32, [16])
    _dispatch.reset_launch_counts()
    if bad == "bias":
        with pytest.raises(NotImplementedError):
            flash_attention(q, k, v, bias=torch.zeros(1, 2, 16, 16,
                                                      device=dev))
    elif bad == "head_size_160":
        with pytest.raises(ValueError, match="head size 160 exceeds"):
            flash_attention(q, k, v, key_mask=mask)
    else:
        with pytest.raises(ValueError, match="key_mask"):
            flash_attention(q, k, v, key_mask=mask.cpu())
    assert _dispatch.launch_counts() == {}


def test_bert_encode_launches_once_per_layer(dev, monkeypatch):
    model = bert_tiny(device=dev)
    r = torch.Generator().manual_seed(5)
    feats = {"token_ids": torch.randint(0, 1000, (4, 32), generator=r),
             "segment_ids": torch.zeros(4, 32, dtype=torch.int32),
             "mask": (torch.arange(32)[None, :]
                      < torch.tensor([[32], [20], [7], [1]])).float()}
    feats = {k: t.to(dev) for k, t in feats.items()}
    _dispatch.reset_launch_counts()
    with torch.inference_mode():
        hidden = model(feats)
        assert _dispatch.launch_counts() == {
            "flash_fwd": model.config.num_layers}
        monkeypatch.setattr(attention_mod, "flash_attention",
                            reference_attention)
        plain = model(feats)
    # float32; two post-LN layers pass the kernel's ~1e-6 on
    assert (hidden - plain).abs().max().item() <= 1e-4
