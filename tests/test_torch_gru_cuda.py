"""The port's CUDA GRU scan kernels (gru_fwd, gru_bwd) on the card.

Marked ``cuda``: each test needs an NVIDIA Hopper card and skips without
one (the kernels have no CPU or interpret mode; their CPU-side twins,
``reference_gru_fwd``/``reference_gru_bwd``, are held against the JAX
package in test_torch_gru.py). On a host with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_gru_cuda.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _dispatch
from deeplearning4j_tpu_torch.kernels.gru_scan import (
    gru,
    gru_bwd_cuda,
    gru_fwd_cuda,
    reference_gru_bwd,
    reference_gru_fwd,
)
from deeplearning4j_tpu_torch.ops import rnn as opsrnn

pytestmark = pytest.mark.cuda

# kernel vs plain version, float32 on both sides, differing in the order
# of the sums of h·RW (over H terms) and of the carry's product (over 3H)
# and in the kernels' 3xTF32 products (about 21 bits of each operand):
# forward outputs (|h| <= 1) and backward dz̃ and dh0 to 1e-5 of max(1,
# max |plain|); against float64, entry by entry, to 1e-5 of max(1,
# |float64|).
TOL = 1e-5

# (N, T, H, non-zero initial state): chip_smoke.py's four cases at a
# reduced T, and the row tiles 8, 16, 32 and 64 with a ragged N; then the
# edges of the clustered kernels: one row, a ragged m16 tile (17 rows),
# three row tiles (130), H short of a cluster's 64 units (40) or a
# multiple of them (200, the last cluster ragged), and H % 4 != 0 (13, 30:
# rows that 16-byte copies cannot read, the 4-byte edge)
CASES = {
    "train_shape": (64, 20, 1024, False),
    "train_shape_init": (64, 12, 1024, True),
    "serving_n8": (8, 20, 1024, False),
    "untiled_n3_h200": (3, 30, 200, False),
    "n13_h40_init": (13, 9, 40, True),
    "n29_h72": (29, 7, 72, False),
    "n70_h136_init": (70, 5, 136, True),
    "n1_h40": (1, 11, 40, False),
    "n1_h1024_init": (1, 6, 1024, True),
    "n17_h200_init": (17, 9, 200, True),
    "n130_h40": (130, 6, 40, False),
    "n130_h1024_init": (130, 4, 1024, True),
    "n5_h30_init": (5, 7, 30, True),
    "n70_h13": (70, 5, 13, False),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernels have no "
                    "CPU mode")
    from deeplearning4j_tpu_torch.runtime.device import require_hopper

    torch.backends.cuda.matmul.allow_tf32 = False
    return require_hopper()


def _inputs(dev, n, t, h, init, seed):
    """xp_tm, rw, b, h0, gh_tm as float32 CUDA tensors, RW glorot normal
    as the layer draws it."""
    g = torch.Generator().manual_seed(seed)
    out = [torch.randn((t, n, 3 * h), generator=g),
           (2.0 / (4 * h)) ** 0.5 * torch.randn((h, 3 * h), generator=g),
           0.1 * torch.randn((3 * h,), generator=g),
           (torch.tanh(torch.randn((n, h), generator=g)) if init
            else torch.zeros((n, h))),
           torch.randn((t, n, h), generator=g)]
    return [a.to(dev) for a in out]


def _frac_err(a, w):
    return (a - w).abs().max().item() / max(1.0, w.abs().max().item())


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(dev, case):
    n, t, h, init = CASES[case]
    xp, rw, b, h0, gh = _inputs(dev, n, t, h, init, seed=n * t + h)
    _dispatch.reset_launch_counts()
    got = gru_fwd_cuda(xp, rw, b, h0, save_workspace=True)
    plain = gru_fwd_cuda(xp, rw, b, h0)
    want = reference_gru_fwd(xp, rw, b, h0, save_workspace=True)
    torch.cuda.synchronize()
    for name, a, w in zip(("hs", "hT", "gates", "hpn"), got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
        assert _frac_err(a, w) <= TOL, (name, _frac_err(a, w))
    # without the workspace: the same hs and final state
    for a, w in zip(plain, got[:2]):
        assert torch.equal(a, w)
    hs, _, gates, hpn = got
    dxp, dh0 = gru_bwd_cuda(gates, hpn, hs, h0, gh, rw)
    h_prev = torch.cat([h0[None], hs[:-1]])
    wdxp, wdh0 = reference_gru_bwd(gates, hpn, h_prev, gh, rw)
    torch.cuda.synchronize()
    assert _dispatch.launch_counts() == {"gru_fwd": 2, "gru_bwd": 1}
    for name, a, w in (("dxp", dxp, wdxp), ("dh0", dh0, wdh0)):
        assert bool(torch.isfinite(a).all()), name
        assert _frac_err(a, w) <= TOL, (name, _frac_err(a, w))


def _fwd_float64(xp, rw, b, h0):
    """The forward sweep written out again in float64 from the same
    inputs → hs, gates, h·RW_n."""
    xp, rw, b, h = (a.double() for a in (xp, rw, b, h0))
    hd = h.shape[1]
    hs, gates, hpns = [], [], []
    for t in range(xp.shape[0]):
        p = h @ rw
        rz = torch.sigmoid(xp[t, :, :2 * hd] + p[:, :2 * hd] + b[:2 * hd])
        r, z = rz[:, :hd], rz[:, hd:]
        n = torch.tanh(xp[t, :, 2 * hd:] + r * p[:, 2 * hd:] + b[2 * hd:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
        gates.append(torch.cat([r, z, n], dim=1))
        hpns.append(p[:, 2 * hd:])
    return torch.stack(hs), torch.stack(gates), torch.stack(hpns)


def _bwd_float64(gates, hpn, h_prev, gh, rw):
    """The reversed dgrad sweep written out again in float64 from the same
    workspace → dz̃, dh0."""
    gates, hpn, h_prev, gh, rw = (a.double()
                                  for a in (gates, hpn, h_prev, gh, rw))
    hd = rw.shape[0]
    dh = torch.zeros_like(gh[0])
    dxp = torch.empty_like(gates)
    for t in range(gates.shape[0] - 1, -1, -1):
        r, z, n = (gates[t, :, :hd], gates[t, :, hd:2 * hd],
                   gates[t, :, 2 * hd:])
        dh_total = gh[t] + dh
        dn_pre = dh_total * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * hpn[t] * r * (1.0 - r)
        dz_pre = dh_total * (h_prev[t] - n) * z * (1.0 - z)
        dxp[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
        dh = dh_total * z + torch.cat([dr_pre, dz_pre, r * dn_pre],
                                      dim=1) @ rw.t()
    return dxp, dh


def _entry_err(a, w):
    """max over entries of |a - w| / max(1, |w|), w float64."""
    return ((a.double() - w).abs() / w.abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweeps_match_float64(dev, case):
    """Both sweeps against a float64 evaluation of the same inputs (the
    backward fed the kernel's own workspace), entry by entry: float32-grade
    3xTF32 products within TOL of max(1, |float64|)."""
    n, t, h, init = CASES[case]
    xp, rw, b, h0, gh = _inputs(dev, n, t, h, init, seed=n * t + h + 1)
    hs, _, gates, hpn = gru_fwd_cuda(xp, rw, b, h0, save_workspace=True)
    dxp, dh0 = gru_bwd_cuda(gates, hpn, hs, h0, gh, rw)
    whs, wgates, whpn = _fwd_float64(xp, rw, b, h0)
    h_prev = torch.cat([h0[None], hs[:-1]])
    wdxp, wdh0 = _bwd_float64(gates, hpn, h_prev, gh, rw)
    torch.cuda.synchronize()
    for name, a, w in (("hs", hs, whs), ("gates", gates, wgates),
                       ("hpn", hpn, whpn), ("dxp", dxp, wdxp),
                       ("dh0", dh0, wdh0)):
        assert _entry_err(a, w) <= TOL, (name, _entry_err(a, w))


def test_sweeps_are_bit_identical_over_two_runs(dev):
    """One writer per element and no atomics: deterministic sweeps."""
    xp, rw, b, h0, gh = _inputs(dev, 64, 16, 1024, True, seed=3)
    runs = []
    for _ in range(2):
        hs, _, gates, hpn = gru_fwd_cuda(xp, rw, b, h0, save_workspace=True)
        runs.append((hs, gates, hpn) + gru_bwd_cuda(gates, hpn, hs, h0, gh,
                                                    rw))
    for a, w in zip(*runs):
        assert torch.equal(a, w)


def test_autograd_op_matches_ops_rnn_on_the_card(dev):
    """The ``gru`` op, forward and every gradient (x, W, RW, b and the
    initial state), against autograd through the plain ``ops/rnn.gru``
    loop on the same card; one launch of each kernel."""
    r = np.random.default_rng(5)
    n, t, i, h = 6, 30, 11, 72
    arrs = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        r.standard_normal((n, t, i)), 0.2 * r.standard_normal((i, 3 * h)),
        0.2 * r.standard_normal((h, 3 * h)),
        0.1 * r.standard_normal((3 * h,)), np.tanh(r.standard_normal((n, h))))]

    def run(fn):
        leaves = [a.clone().requires_grad_() for a in arrs]
        x, wx, wh, b, h0 = leaves
        out, h_t = fn(x, wx, wh, b, init_h=h0)
        w = torch.cos(torch.arange(out.numel(), device=dev,
                                   dtype=torch.float32)).reshape(out.shape)
        loss = (out * w).sum() + 2 * h_t.sum()
        return out.detach(), torch.autograd.grad(loss, leaves)

    _dispatch.reset_launch_counts()
    out_k, g_k = run(gru)
    assert _dispatch.launch_counts() == {"gru_fwd": 1, "gru_bwd": 1}
    out_p, g_p = run(opsrnn.gru)
    assert (out_k - out_p).abs().max().item() <= TOL
    for name, a, w in zip(("dx", "dW", "dRW", "db", "dh0"), g_k, g_p):
        assert _frac_err(a, w) <= 1e-4, (name, _frac_err(a, w))


def test_inference_writes_no_workspace(dev):
    r = np.random.default_rng(9)
    n, t, i, h = 8, 40, 32, 256
    x, wx, wh, b = (torch.tensor(a, dtype=torch.float32, device=dev)
                    for a in (r.standard_normal((n, t, i)),
                              0.1 * r.standard_normal((i, 3 * h)),
                              0.1 * r.standard_normal((h, 3 * h)),
                              0.1 * r.standard_normal((3 * h,))))
    with torch.inference_mode():
        _dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out, _ = gru(x, wx, wh, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
    assert _dispatch.launch_counts() == {"gru_fwd": 1}
    assert out.shape == (n, t, h)
    # x·W [T,N,3H], hs [T,N,H], the zero h0 and bias, plus 64 KiB of
    # allocator rounding; the workspace (gates [T,N,3H] and h·RW_n
    # [T,N,H], 1.25 MiB here) would not fit
    assert peak <= 4 * (t * n * 4 * h + n * h + 3 * h) + 65536, peak
