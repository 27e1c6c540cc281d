"""The port's average pools on the card: values and gradients over channels-last memory.

Marked ``cuda``: each test needs an NVIDIA card and skips without one.
On CUDA, ``F.avg_pool2d``'s backward over a channels-last input returns a
wrong gradient (torch 2.11 on an H100: at [4, 176, 28, 28], window 3,
stride 1, it is off by ~1.2 of the gradient's max), which took NASNet-A's
float32 gradients 0.37 (relative L2) away from float64. ``ops/cnn._pool``
pools an NCHW-contiguous copy. Each case here runs the port's pool
on the card, on NHWC-contiguous memory (what the convs hand on), and
holds its output and the gradient into its input against the same op on
the CPU in float64, to TOL of the float64 max. On a host with the card
and without JAX:

    python -m pytest --noconftest tests/test_torch_pool_cuda.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import pytest
import torch

from deeplearning4j_tpu_torch.nn.layers import Pooling1D, Pooling2D
from deeplearning4j_tpu_torch.ops import cnn

pytestmark = pytest.mark.cuda

TOL = 1e-5

# (input NHWC, window, stride, padding): NASNet-A's normal-cell pools
# (3×3 stride 1 SAME at 112² × 44 and 28² × 176), its reduction cells'
# (stride 2 SAME, asymmetric at even sizes), a VALID pool
CASES = {
    "nasnet_normal_112": ((4, 112, 112, 44), 3, 1, "SAME"),
    "nasnet_normal_28": ((4, 28, 28, 176), 3, 1, "SAME"),
    "nasnet_reduction_56": ((4, 56, 56, 88), 3, 2, "SAME"),
    "valid_2x2": ((8, 16, 16, 64), 2, 2, "VALID"),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fault is in CUDA's "
                    "channels-last avg_pool2d backward")
    return torch.device("cuda", 0)


def _frac(got, want):
    return float((got.double().cpu() - want).abs().max()
                 / want.abs().max())


def _value_and_grad(fn, x, ct):
    x = x.clone().requires_grad_()
    y = fn(x)
    return y, torch.autograd.grad(y, x, ct)[0]


@pytest.mark.parametrize("case", list(CASES))
def test_avg_pool_over_channels_last_memory_matches_the_cpu(dev, case):
    shape, window, stride, padding = CASES[case]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g)

    def fn(a):
        return cnn.avg_pool2d(a, window, stride, padding)

    with torch.no_grad():
        ct = torch.randn(fn(x).shape, generator=g)
    want_y, want_g = _value_and_grad(fn, x.double(), ct.double())
    xd = x.to(dev)
    assert xd.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)
    y, grad = _value_and_grad(fn, xd, ct.to(dev))
    assert y.is_contiguous()  # handed back in the input's layout
    assert _frac(y, want_y) <= TOL
    assert _frac(grad, want_g) <= TOL


@pytest.mark.parametrize("layer,shape", [
    (Pooling2D(pool_type="avg", window=3, stride=1, padding="SAME"),
     (4, 28, 28, 176)),
    (Pooling1D(pool_type="avg", window=3, stride=2, padding="SAME"),
     (4, 50, 96)),
])
def test_avg_pooling_layers_on_the_card_match_the_cpu(dev, layer, shape):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g)

    def fn(a):
        return layer.apply({}, {}, a)[0]

    with torch.no_grad():
        ct = torch.randn(fn(x).shape, generator=g)
    want_y, want_g = _value_and_grad(fn, x.double(), ct.double())
    y, grad = _value_and_grad(fn, x.to(dev), ct.to(dev))
    assert _frac(y, want_y) <= TOL
    assert _frac(grad, want_g) <= TOL


def test_avg_pool3d_over_channels_last_memory_matches_the_cpu(dev):
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 8, 12, 12, 48), generator=g)

    def fn(a):
        return cnn.avg_pool3d(a, 2, 2, "VALID")

    with torch.no_grad():
        ct = torch.randn(fn(x).shape, generator=g)
    want_y, want_g = _value_and_grad(fn, x.double(), ct.double())
    y, grad = _value_and_grad(fn, x.to(dev), ct.to(dev))
    assert _frac(y, want_y) <= TOL
    assert _frac(grad, want_g) <= TOL
