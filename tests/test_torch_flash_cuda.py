"""The port's CUDA flash-attention kernel on the card.

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
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    flash_attention,
    reference_attention,
)
from deeplearning4j_tpu_torch.models.bert import bert_tiny
from deeplearning4j_tpu_torch.nn.layers import attention as attention_mod

pytestmark = pytest.mark.cuda

# kernel vs plain version on the card: float32 sums blockwise in another
# order (a few ulp of O(1) values); bfloat16 — the plain version rounds the
# probabilities to bf16 before its second matmul, the kernel does not.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# (B, H, T, S, D, dtype, causal, key lengths per batch row)
CASES = {
    "padded_fp32": (3, 4, 128, 128, 64, torch.float32, False, [128, 37, 0]),
    "padded_bf16": (3, 4, 128, 128, 64, torch.bfloat16, False, [128, 37, 0]),
    "causal_t_lt_s_d32": (2, 2, 50, 130, 32, torch.float32, True, None),
    "ragged_d128": (2, 2, 70, 90, 128, torch.bfloat16, True, [90, 41]),
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


@pytest.mark.parametrize("bad", ["bias", "head_size_48", "cpu_mask"])
def test_what_the_kernel_does_not_take_raises(dev, bad):
    q, k, v, mask = _inputs(dev, 1, 2, 16, 16, 48 if bad == "head_size_48"
                            else 32, torch.float32, [16])
    _dispatch.reset_launch_counts()
    if bad == "bias":
        with pytest.raises(NotImplementedError):
            flash_attention(q, k, v, bias=torch.zeros(1, 2, 16, 16,
                                                      device=dev))
    elif bad == "head_size_48":
        with pytest.raises(ValueError, match="head size 48"):
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
