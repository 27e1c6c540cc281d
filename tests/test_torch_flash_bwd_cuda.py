"""The port's CUDA flash-attention backward kernels on the card: the
delta pre-pass ``flash_bwd_delta`` and ``flash_bwd_dkv``/``flash_bwd_dq``.

Marked ``cuda``: each test needs an NVIDIA Hopper card and skips without
one (the kernels have no CPU or interpret mode; their CPU-side twin,
``reference_attention_bwd``, is held against the JAX package in
test_torch_flash_backward.py). On a host with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_flash_bwd_cuda.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _dispatch
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    flash_bwd_delta_cuda,
    reference_attention,
    reference_attention_bwd,
    reference_delta,
)
from deeplearning4j_tpu_torch.models.bert import bert_tiny, make_mlm_batch
from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod
from deeplearning4j_tpu_torch.train.trainer import batch_to_device
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names, unflatten

pytestmark = pytest.mark.cuda

# kernel vs plain backward, max |difference| / max(1, max |plain|): both
# compute in float32 from the same inputs and LSE. float32: the kernels'
# products are 3xTF32 (each operand split into two TF32 parts that keep
# about 21 of its 24 bits, three tensor-core passes summed in float32) and
# their sums run in another order: a few float32 ulp. bfloat16: also the
# final rounding of the gradient to bf16 (eps 2^-8, one ulp either way);
# the bf16 kernels (tensor cores) and the plain version both round P and
# dS to bf16 before their products, which may round differently where the
# two float32 values straddle a rounding boundary.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# (B, H, T, S, D, dtype, causal, key lengths per batch row)
CASES = {
    "padded_fp32": (3, 4, 128, 128, 64, torch.float32, False, [128, 37, 0]),
    "padded_bf16": (3, 4, 128, 128, 64, torch.bfloat16, False, [128, 37, 0]),
    "causal_fp32": (2, 3, 96, 96, 64, torch.float32, True, None),
    "causal_t_lt_s_d32": (2, 2, 50, 130, 32, torch.float32, True, None),
    "causal_padded_d32_bf16": (2, 2, 70, 70, 32, torch.bfloat16, True,
                               [70, 23]),
    "ragged_d128": (2, 2, 70, 90, 128, torch.float32, False, [90, 41]),
    "causal_ragged_d128_bf16": (2, 2, 100, 100, 128, torch.bfloat16, True,
                                [100, 61]),
    # the bf16 kernels' branches: each head size, ragged T and S (not
    # multiples of 64), causal with T < S, a batch row with every key
    # masked, and 64-key tiles whose keys are all masked (row 1: keys
    # 60-199 of 200)
    "ragged_d32_dead_row_bf16": (2, 3, 70, 100, 32, torch.bfloat16, False,
                                 [100, 0]),
    "causal_t_lt_s_bf16": (2, 3, 64, 130, 64, torch.bfloat16, True, None),
    "causal_t_lt_s_d128_bf16": (1, 2, 70, 200, 128, torch.bfloat16, True,
                                [200]),
    "ragged_d128_bf16": (2, 2, 130, 100, 128, torch.bfloat16, False,
                         [100, 37]),
    "masked_key_tiles_bf16": (2, 2, 100, 200, 64, torch.bfloat16, False,
                              [200, 60]),
    # the same edges of the float32 kernels' 64-row tiles: T and S not
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
    # BERT's longest sequences (phase 2, T = 512): eight query tiles summed
    # into each key's dK and dV, eight key tiles into each dQ
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
# a single query tile of 1 or 4 rows (the rest of the tile dead) against
# one key tile (S = 64) or three, the last ragged (S = 130); causal aligns
# the few queries to the last keys
CASES.update({
    f"t{t}_s{s}{'_causal' if causal else ''}_{tag}":
        (2, 3, t, s, 64, dtype, causal, None)
    for t in (1, 4) for s in (64, 130) for causal in (False, True)
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))})
BF16_CASES = sorted(c for c in CASES if CASES[c][5] == torch.bfloat16)
FP32_CASES = sorted(c for c in CASES if CASES[c][5] == torch.float32)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernels have no "
                    "CPU mode")
    from deeplearning4j_tpu_torch.runtime.device import require_hopper

    torch.backends.cuda.matmul.allow_tf32 = False
    return require_hopper()


def _inputs(dev, b, h, t, s, d, dtype, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, d), generator=g).to(dev, dtype)
               for n in (t, s, s))
    dout = torch.randn((b, h, t, d), generator=g).to(dev, dtype)
    mask = None
    if lengths is not None:
        mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]
                ).to(dev, torch.float32)
    return q, k, v, mask, dout


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_kernels_match_plain_version(dev, case):
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask, dout = _inputs(dev, b, h, t, s, d, dtype, lengths,
                                  seed=b * t + s + d)
    out, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                    return_lse=True)
    _dispatch.reset_launch_counts()
    got = flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                   causal=causal)
    assert _dispatch.launch_counts() == {
        "flash_bwd_delta": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    want = reference_attention_bwd(q, k, v, mask, out, lse, dout,
                                   causal=causal)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = (a.float() - w.float()).abs().max().item()
        ref = max(1.0, w.float().abs().max().item())
        assert err <= TOL[dtype] * ref, (name, err, ref)
    if lengths is not None:
        dead = torch.tensor(lengths, device=dev) == 0
        for a in got:
            assert (a[dead] == 0).all()  # fully-masked rows: 0, never NaN
        keep = mask[:, None, :, None] > 0
        for a in got[1:]:  # masked keys get dK = dV = 0
            assert (a.masked_fill(keep, 0) == 0).all()


# the delta kernel against reference_delta, per row, as a fraction of the
# row's sum of |O dO|: both multiply the same float32 values (bf16 x bf16
# is exact in float32) and sum D products in float32 in another order
TOL_DELTA = 1e-6


@pytest.mark.parametrize("case", sorted(CASES))
def test_delta_kernel_matches_plain_version(dev, case):
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask, dout = _inputs(dev, b, h, t, s, d, dtype, lengths,
                                  seed=b * t + s + d)
    out = flash_attention_cuda(q, k, v, mask, causal=causal)
    _dispatch.reset_launch_counts()
    got = flash_bwd_delta_cuda(out, dout)
    assert _dispatch.launch_counts() == {"flash_bwd_delta": 1}
    want = reference_delta(out, dout)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b * h, t)
    mag = (out.float() * dout.float()).abs().sum(-1).reshape(b * h, t)
    err = (got - want).abs()
    assert bool((err <= TOL_DELTA * mag).all()), (
        err.max().item(), (err / mag.clamp(min=1e-30)).max().item())


def _sdpa_grads(q, k, v, mask, dout, causal):
    """PyTorch's own attention backward (``scaled_dot_product_attention``
    with the same key and bottom-right causal mask, its own forward) →
    (dq, dk, dv) and, for each, the bool mask of the entries that count:
    dq on rows that see a key, dk and dv on keys some row sees. Rows that
    see no key would be NaN in SDPA: they see everything there and are
    left out (their gradients are 0 in the kernels and the plain
    backward)."""
    b, h, t, d = q.shape
    s = k.shape[2]
    keep = torch.ones((b, 1, t, s), dtype=torch.bool, device=q.device)
    if mask is not None:
        keep = keep & (mask[:, None, None, :] > 0)
    if causal:
        keep = keep & (torch.arange(t, device=q.device)[:, None] + (s - t)
                       >= torch.arange(s, device=q.device)[None, :])
    rows = keep.any(-1, keepdim=True)  # [b, 1, t, 1]: rows that see a key
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=keep | ~rows)
    grads = torch.autograd.grad(sdpa, leaves, dout * rows)
    keys = keep.any(-2)[..., None].expand(-1, h, -1, d)
    return grads, (rows.expand(-1, h, -1, d), keys, keys)


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernel_error_is_of_the_order_of_sdpa(dev, case):
    """The bf16 kernels' error against the plain backward beside that of
    PyTorch's own bf16 attention backward (``scaled_dot_product_attention``
    with the same key and bottom-right causal mask) against the same plain
    version, over the rows that see a key: at most 4x SDPA's, or one bf16
    ulp (2^-7) of max(1, max |plain|)."""
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask, dout = _inputs(dev, b, h, t, s, d, dtype, lengths,
                                  seed=b * t + s + d)
    out, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                    return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                   causal=causal)
    want = reference_attention_bwd(q, k, v, mask, out, lse, dout,
                                   causal=causal)
    sdpa_grads, lives = _sdpa_grads(q, k, v, mask, dout, causal)
    torch.cuda.synchronize()
    for name, a, lib, w, live in zip(("dq", "dk", "dv"), got, sdpa_grads,
                                     want, lives):
        err = (a.float() - w.float())[live].abs().max().item()
        lib_err = (lib.float() - w.float())[live].abs().max().item()
        ref = max(1.0, w.float().abs().max().item())
        assert err <= max(4 * lib_err, 2 ** -7 * ref), (name, err, lib_err)


def _bwd_float64(q, k, v, key_mask, out, lse, g, causal):
    """The backward of ``reference_attention_bwd`` written out again in
    float64, from the same inputs, forward output and LSE: p = exp(s -
    max(lse, -1e20)) (0 where masked), delta = rowsum(dO O), dS = p (dP -
    delta) scale, dV = P^T dO, dK = dS^T Q, dQ = dS K."""
    b, h, t, d = q.shape
    s_len = k.shape[2]
    qd, kd, vd, od, gd = (x.double() for x in (q, k, v, out, g))
    s = torch.einsum("bhtd,bhsd->bhts", qd, kd) * d ** -0.5
    keep = torch.ones((b, 1, t, s_len), dtype=torch.bool, device=q.device)
    if key_mask is not None:
        keep = keep & (key_mask[:, None, None, :] > 0)
    if causal:
        keep = keep & (torch.arange(t, device=q.device)[:, None]
                       + (s_len - t)
                       >= torch.arange(s_len, device=q.device)[None, :])
    lse = torch.clamp(lse.double().reshape(b, h, t, 1), min=-1e20)
    p = torch.where(keep, torch.exp(s - lse), 0.0)
    delta = (od * gd).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhtd,bhsd->bhts", gd, vd) - delta) * d ** -0.5
    return (torch.einsum("bhts,bhsd->bhtd", ds, kd),
            torch.einsum("bhts,bhtd->bhsd", ds, qd),
            torch.einsum("bhts,bhtd->bhsd", p, gd))


@pytest.mark.parametrize("case", FP32_CASES)
def test_fp32_kernels_are_float32_grade(dev, case, record_property):
    """The float32 kernels (3xTF32 products on the tensor cores) against a
    float64 evaluation of the same formula on the same inputs, forward
    output and LSE: within TOL[float32] of max(1, max |float64|). SDPA's
    own float32 backward against the same float64 values (its own
    forward, over the rows and keys that see one another) is recorded
    beside theirs."""
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask, dout = _inputs(dev, b, h, t, s, d, dtype, lengths,
                                  seed=b * t + s + d)
    out, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                    return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                   causal=causal)
    want = _bwd_float64(q, k, v, mask, out, lse, dout, causal)
    sdpa_grads, lives = _sdpa_grads(q, k, v, mask, dout, causal)
    torch.cuda.synchronize()
    for name, a, lib, w, live in zip(("dq", "dk", "dv"), got, sdpa_grads,
                                     want, lives):
        err = (a.double() - w).abs().max().item()
        lib_err = (lib.double() - w)[live].abs().max().item()
        ref = max(1.0, w.abs().max().item())
        record_property(f"{name}_err", err)
        record_property(f"{name}_sdpa_err", lib_err)
        print(f"{case} {name}: kernel {err:.3e}, sdpa {lib_err:.3e}, "
              f"max(1, |float64|) {ref:.3f}")
        assert err <= TOL[dtype] * ref, (name, err, ref, lib_err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_kernels_are_deterministic(dev, case):
    """One writer per gradient element and no atomics: two runs on the
    same inputs give the same bits."""
    b, h, t, s, d, dtype, causal, lengths = CASES[case]
    q, k, v, mask, dout = _inputs(dev, b, h, t, s, d, dtype, lengths,
                                  seed=b * t + s + d)
    out, lse = flash_attention_cuda(q, k, v, mask, causal=causal,
                                    return_lse=True)
    first = flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                     causal=causal)
    second = flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout,
                                      causal=causal)
    torch.cuda.synchronize()
    for name, a, c in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, c), name


def test_autograd_goes_through_the_three_kernels(dev):
    q, k, v, mask, dout = _inputs(dev, 2, 3, 64, 64, 64, torch.float32,
                                  [64, 19], seed=11)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    _dispatch.reset_launch_counts()
    out = flash_attention(*leaves, key_mask=mask)
    got = torch.autograd.grad(out, leaves, dout)
    assert _dispatch.launch_counts() == {
        "flash_fwd": 1, "flash_bwd_delta": 1, "flash_bwd_dkv": 1,
        "flash_bwd_dq": 1}
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        reference_attention(*plain, key_mask=mask), plain, dout)
    for a, w in zip(got, want):
        assert (a - w).abs().max().item() <= 1e-4


# head sizes the kernels lack (b, h, t, s, d, dtype, causal, lengths): the
# seq2seq example's CrossAttention (1024 sequences x 4 heads of 16, T = S
# = 10) and D = 48 with masked keys, zero-padded to 32 and 64
PADDED_CASES = {
    "seq2seq_d16_fp32": (1024, 4, 10, 10, 16, torch.float32, False, None),
    "seq2seq_d16_bf16": (1024, 4, 10, 10, 16, torch.bfloat16, False, None),
    "d48_padded_fp32": (2, 3, 70, 100, 48, torch.float32, False, [100, 41]),
    "d48_causal_bf16": (2, 3, 70, 100, 48, torch.bfloat16, True, [100, 41]),
}


@pytest.mark.parametrize("case", sorted(PADDED_CASES))
def test_padded_head_size_runs_the_three_kernels(dev, case):
    """Autograd through flash_attention at a head size the kernels lack:
    the forward and the three backward kernels run once each on the
    zero-padded tensors, with the scale of the original D, and the
    gradients come back [.., D], against autograd of the plain version of
    the inputs in float32 (TOL of max(1, |plain|))."""
    b, h, t, s, d, dtype, causal, lengths = PADDED_CASES[case]
    q, k, v, mask, dout = _inputs(dev, b, h, t, s, d, dtype, lengths,
                                  seed=13)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    _dispatch.reset_launch_counts()
    out = flash_attention(*leaves, causal=causal, key_mask=mask)
    got = torch.autograd.grad(out, leaves, dout)
    assert _dispatch.launch_counts() == {
        "flash_fwd": 1, "flash_bwd_delta": 1, "flash_bwd_dkv": 1,
        "flash_bwd_dq": 1}
    plain = [x.float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        reference_attention(*plain, causal=causal, key_mask=mask), plain,
        dout.float())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == dtype
        ref = max(1.0, w.abs().max().item())
        err = (a.float() - w).abs().max().item()
        assert err <= TOL[dtype] * ref, (name, err, ref)


def test_bert_tiny_train_step_grads_equal_the_plain_path(dev, monkeypatch):
    model = bert_tiny(device=dev, dropout=0.1, attention_dropout=0.1)
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    batch = batch_to_device(make_mlm_batch(3, 4, 64, 1000, pad_frac=0.3,
                                           max_predictions=10), dev)

    def grads():
        tree = unflatten((n.replace(".", "/"), p) for n, p in params.items())
        gen = torch.Generator(dev).manual_seed(7)  # same dropout masks
        loss, _ = model.loss_fn(tree, {}, batch, generator=gen)
        return loss, torch.autograd.grad(loss, list(params.values()))

    _dispatch.reset_launch_counts()
    loss_k, g_kernel = grads()
    n = model.config.num_layers
    assert _dispatch.launch_counts() == {
        "flash_fwd": n, "flash_bwd_delta": n, "flash_bwd_dkv": n,
        "flash_bwd_dq": n}
    monkeypatch.setattr(attention_mod, "flash_attention", reference_attention)
    loss_p, g_plain = grads()
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    # float32, two layers: the kernels' ~1e-6 relative differences pass
    # through LayerNorm and GELU backward. Each leaf to 1e-3 of its max,
    # that max floored at 1e-4 of the model's largest gradient: the key
    # biases' exact gradient is 0 (softmax ignores a shift of a whole row)
    # and theirs are rounding noise of ~1e-10 on either path.
    top = max(w.abs().max().item() for w in g_plain)
    for name, a, w in zip(params, g_kernel, g_plain):
        scale = max(w.abs().max().item(), 1e-4 * top)
        assert (a - w).abs().max().item() <= 1e-3 * scale, name
    assert np.isfinite(loss_k.item())


def test_remat_replays_the_cuda_generator(dev):
    """With dropout on, a remat step's gradients equal the plain step's:
    the recomputation in backward restores the card's generator state."""
    from deeplearning4j_tpu_torch.train.trainer import Trainer

    batch = batch_to_device(make_mlm_batch(4, 4, 64, 1000, pad_frac=0.3,
                                           max_predictions=10), dev)
    out = []
    for remat in (False, True):
        model = bert_tiny(device=dev, dropout=0.1, attention_dropout=0.1,
                          remat=remat)
        trainer = Trainer(model)
        params = trainer.init_state().params  # the same seed both times
        gen = torch.Generator(dev).manual_seed(5)
        _dispatch.reset_launch_counts()
        loss, _, _, grads = trainer._grad_of(params, {}, batch, gen)
        n = model.config.num_layers
        # remat runs each block's forward twice, so flash_fwd twice
        assert _dispatch.launch_counts() == {
            "flash_fwd": n * (2 if remat else 1), "flash_bwd_delta": n,
            "flash_bwd_dkv": n, "flash_bwd_dq": n}
        out.append((loss.item(), dict(flatten_with_names(grads))))
    assert out[0][0] == out[1][0]  # the same forward, op for op
    # backward sums may be ordered differently by the library; a dropout
    # mask drawn anew would differ by far more than this
    top = max(g.abs().max().item() for g in out[0][1].values())
    for name, g in out[0][1].items():
        diff = (out[1][1][name] - g).abs().max().item()
        assert diff <= 1e-6 * max(g.abs().max().item(), 1e-4 * top), name
