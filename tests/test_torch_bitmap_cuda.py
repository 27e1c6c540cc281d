"""The port's CUDA bitmap encode kernel (bitmap_pack) on the card.

Marked ``cuda``: each test needs an NVIDIA Hopper card and skips without
one (the kernel has no CPU or interpret mode; its CPU-side twin,
``reference_bitmap_encode``, and the codec of ``ops/compression.py`` are
held against the JAX package in test_torch_compression.py). On a host
with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_bitmap_cuda.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _dispatch
from deeplearning4j_tpu_torch.kernels.bitmap_pack import (
    bitmap_encode,
    reference_bitmap_encode,
)
from deeplearning4j_tpu_torch.ops import compression

pytestmark = pytest.mark.cuda

THR = 0.7  # leaves all three codes populated in N(0, 1) data


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel has no "
                    "CPU mode")
    from deeplearning4j_tpu_torch.runtime.device import require_hopper

    return require_hopper()


def _grad(dev, shape, seed, dtype=torch.float32):
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    flat = g.reshape(-1)
    if flat.numel() >= 16:
        flat[15] = -2.0  # code 2 in slot 15: a negative word
    return g.to(dev, dtype)


@pytest.mark.parametrize("shape", [(1,), (15,), (16,), (2047,), (2048,),
                                   (2049,), (33, 61), (1 << 20,)],
                         ids=str)
def test_kernel_is_bit_identical_to_the_plain_codec(dev, shape):
    """float32: packed words and residual bit-identical to the codec and
    to the kernel's plain version; decode + residual gives g back."""
    g = _grad(dev, shape, seed=len(shape) * 1000 + shape[0])
    _dispatch.reset_launch_counts()
    packed, resid = bitmap_encode(g, THR)
    assert _dispatch.launch_counts() == {"bitmap_pack": 1}
    for want in (compression.bitmap_encode(g, THR),
                 reference_bitmap_encode(g, THR)):
        assert torch.equal(packed, want[0])
        assert torch.equal(resid.view(torch.int32),
                           want[1].view(torch.int32))
    n = g.numel()
    assert packed.shape == ((n + 15) // 16,) and packed.dtype == torch.int32
    if n >= 16:
        assert int(packed[0]) < 0  # bit 31 set by code 2 in slot 15
    back = compression.bitmap_decode(packed, THR, g.shape) + resid
    # 1 ulp: g = sent + (g - sent), with |sent| = THR rounded
    assert torch.allclose(back, g, rtol=2 ** -23, atol=0)


def test_bf16_gradients_follow_the_plain_versions_rule(dev):
    """bf16: compared and subtracted in float32, the residual rounded
    once, as the Pallas kernel does: bit-identical to
    ``reference_bitmap_encode``; other dtypes are refused."""
    g = _grad(dev, (3, 5000), seed=7, dtype=torch.bfloat16)
    packed, resid = bitmap_encode(g, THR)
    want_p, want_r = reference_bitmap_encode(g, THR)
    assert resid.dtype == torch.bfloat16
    assert torch.equal(packed, want_p)
    assert torch.equal(resid.view(torch.int16), want_r.view(torch.int16))
    with pytest.raises(ValueError, match="bitmap_pack takes"):
        bitmap_encode(g.half(), THR)


def test_non_contiguous_and_misaligned_input(dev):
    base = _grad(dev, (4099,), seed=3)
    for g in (base[3:], base.reshape(1, -1)[:, 1::2]):
        packed, resid = bitmap_encode(g, THR)
        want = compression.bitmap_encode(g.contiguous(), THR)
        assert torch.equal(packed, want[0])
        assert torch.equal(resid, want[1].reshape(g.shape))
