"""The port's CUDA LSTM scan kernels (lstm_fwd, lstm_bwd) on the card.

Marked ``cuda``: each test needs an NVIDIA Hopper card and skips without
one (the kernels have no CPU or interpret mode; their CPU-side twins,
``reference_lstm_fwd``/``reference_lstm_bwd``, are held against the JAX
package in test_torch_lstm.py). On a host with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_lstm_cuda.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _dispatch
from deeplearning4j_tpu_torch.kernels.lstm_scan import (
    launch_plan,
    lstm,
    lstm_bwd_cuda,
    lstm_fwd_cuda,
    reference_lstm_bwd,
    reference_lstm_fwd,
    resident_smem_bytes,
    route,
)
from deeplearning4j_tpu_torch.models.zoo.classic import text_generation_lstm
from deeplearning4j_tpu_torch.ops import rnn as opsrnn
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

pytestmark = pytest.mark.cuda

# kernel vs plain version, float32 on both sides, differing only in the
# order of the sums of h·RW (forward) and dz·RWᵀ (backward) over H and 4H
# terms: forward outputs (|h| <= 1, |c| of order 1) to 1e-5 absolute;
# backward dz and the carries to 1e-5 of max(1, max |plain|), carried back
# over up to 256 steps. The resident route's products are 3xTF32 on the
# tensor cores (about 21 bits of each operand); against float64, entry
# by entry, both routes to 1e-5 of max(1, |float64|).
TOL_FWD = 1e-5
TOL_BWD = 1e-5

# (N, T, H, peepholes, forget_bias, non-zero initial state); then the
# edges of the resident route (clusters of 16 blocks, 8 rows a cluster,
# ceil(H / 16) units a block): one row, 17 rows (three row tiles, the last
# ragged), 130 rows (17 clusters, more than the card holds at once), H=13
# (one unit a block, three blocks without one), H=72 and H=88 over 30
# steps (the last block owns no unit and must still keep step with the
# others), H=320 (the most that stays resident) and H=321 (the step route)
CASES = {
    "train_shape_graves": (32, 256, 256, True, 1.0, False),
    "no_peepholes": (32, 64, 256, False, 1.0, False),
    "h200_n3": (3, 50, 200, True, 1.0, False),
    "init_state": (8, 40, 128, True, 0.0, True),
    "ragged_n5_h40": (5, 9, 40, False, 0.0, True),
    "n1_h256": (1, 24, 256, True, 1.0, True),
    "n17_h256": (17, 20, 256, True, 1.0, True),
    "n130_h64": (130, 12, 64, True, 1.0, False),
    "h13_n5": (5, 15, 13, True, 0.0, True),
    "h72_empty_member": (6, 30, 72, True, 1.0, True),
    "h88_empty_member": (6, 30, 88, False, 0.0, True),
    "h320_resident_limit": (9, 12, 320, True, 1.0, True),
    "h321_step_route": (9, 12, 321, True, 1.0, True),
    # the seq2seq example's biLSTM encoder (each direction): 1024 rows in
    # 128 clusters, 2 units a block, no peepholes
    "seq2seq_n1024_t10_h32": (1024, 10, 32, False, 1.0, False),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernels have no "
                    "CPU mode")
    from deeplearning4j_tpu_torch.runtime.device import require_hopper

    torch.backends.cuda.matmul.allow_tf32 = False
    return require_hopper()


def _inputs(dev, n, t, h, peep, init, seed):
    """xp_tm, rw, b, h0, c0, peep, gh_tm, gcT as float32 CUDA tensors."""
    g = torch.Generator().manual_seed(seed)
    xavier = (2.0 / (5 * h)) ** 0.5  # [H, 4H] glorot normal
    out = [torch.randn((t, n, 4 * h), generator=g),
           xavier * torch.randn((h, 4 * h), generator=g),
           0.1 * torch.randn((4 * h,), generator=g)]
    if init:
        out += [torch.tanh(torch.randn((n, h), generator=g)),
                torch.randn((n, h), generator=g)]
    else:
        out += [torch.zeros((n, h)), torch.zeros((n, h))]
    out.append(0.1 * torch.randn((3, h), generator=g) if peep else None)
    out += [torch.randn((t, n, h), generator=g),
            torch.randn((n, h), generator=g)]
    return [None if a is None else a.to(dev) for a in out]


def _max_err(a, w):
    return (a - w).abs().max().item()


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(dev, case):
    n, t, h, use_peep, fb, init = CASES[case]
    xp, rw, b, h0, c0, peep, gh, gcT = _inputs(dev, n, t, h, use_peep, init,
                                               seed=n * t + h)
    _dispatch.reset_launch_counts()
    got = lstm_fwd_cuda(xp, rw, b, h0, c0, peep, fb, save_workspace=True)
    plain = lstm_fwd_cuda(xp, rw, b, h0, c0, peep, fb)
    want = reference_lstm_fwd(xp, rw, b, h0, c0, peep, fb,
                              save_workspace=True)
    torch.cuda.synchronize()
    for name, a, w in zip(("hs", "hT", "cT", "gates", "cs"), got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
        assert _max_err(a, w) <= TOL_FWD, (name, _max_err(a, w))
    # without the workspace: the same hs and final state
    for a, w in zip(plain, got[:3]):
        assert torch.equal(a, w)
    gates, cs = got[3], got[4]
    dxp, dh0, dc0 = lstm_bwd_cuda(gates, cs, c0, gh, gcT, rw, peep)
    c_prev = torch.cat([c0[None], cs[:-1]])
    wdxp, wdh0, wdc0 = reference_lstm_bwd(gates, cs, c_prev, gh, gcT, rw,
                                          peep)
    torch.cuda.synchronize()
    assert _dispatch.launch_counts() == {"lstm_fwd": 2, "lstm_bwd": 1}
    for name, a, w in (("dxp", dxp, wdxp), ("dh0", dh0, wdh0),
                       ("dc0", dc0, wdc0)):
        assert bool(torch.isfinite(a).all()), name
        ref = max(1.0, w.abs().max().item())
        assert _max_err(a, w) <= TOL_BWD * ref, (name, _max_err(a, w), ref)


def _fwd_float64(xp, rw, b, h0, c0, peep, fb):
    """The forward sweep written out again in float64 from the same
    inputs → hs, gates, cell states."""
    xp, rw, b, h, c = (a.double() for a in (xp, rw, b, h0, c0))
    pe = None if peep is None else peep.double()
    hs, gates, cs = [], [], []
    for t in range(xp.shape[0]):
        zi, zf, zg, zo = torch.chunk(xp[t] + h @ rw + b, 4, dim=1)
        if pe is not None:
            zi, zf = zi + pe[0] * c, zf + pe[1] * c
        i, f, g = torch.sigmoid(zi), torch.sigmoid(zf + fb), torch.tanh(zg)
        c = f * c + i * g
        o = torch.sigmoid(zo + (pe[2] * c if pe is not None else 0.0))
        h = o * torch.tanh(c)
        hs.append(h)
        gates.append(torch.cat([i, f, g, o], dim=1))
        cs.append(c)
    return torch.stack(hs), torch.stack(gates), torch.stack(cs)


def _bwd_float64(gates, cs, c0, gh, gcT, rw, peep):
    """The reversed dgrad sweep written out again in float64 from the same
    workspace → dz, dh0, dc0."""
    gates, cs, c0, gh, gcT, rw = (a.double()
                                  for a in (gates, cs, c0, gh, gcT, rw))
    pe = None if peep is None else peep.double()
    dh, dc = torch.zeros_like(gcT), gcT
    dxp = torch.empty_like(gates)
    for t in range(gates.shape[0] - 1, -1, -1):
        i, f, g, o = torch.chunk(gates[t], 4, dim=1)
        c_prev = cs[t - 1] if t > 0 else c0
        dh_total = gh[t] + dh
        tc = torch.tanh(cs[t])
        dzo = dh_total * tc * o * (1.0 - o)
        dc = dc + dh_total * o * (1.0 - tc * tc)
        if pe is not None:
            dc = dc + dzo * pe[2]
        dzi = dc * g * i * (1.0 - i)
        dzf = dc * c_prev * f * (1.0 - f)
        dzg = dc * i * (1.0 - g * g)
        dc_next = dc * f
        if pe is not None:
            dc_next = dc_next + dzi * pe[0] + dzf * pe[1]
        dxp[t] = torch.cat([dzi, dzf, dzg, dzo], dim=1)
        dh = dxp[t] @ rw.t()
        dc = dc_next
    return dxp, dh, dc


def _entry_err(a, w):
    """max over entries of |a - w| / max(1, |w|), w float64."""
    return ((a.double() - w).abs() / w.abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweeps_match_float64(dev, case):
    """Both sweeps against a float64 evaluation of the same inputs (the
    backward fed the kernel's own workspace), entry by entry, within
    TOL_FWD / TOL_BWD of max(1, |float64|)."""
    n, t, h, use_peep, fb, init = CASES[case]
    xp, rw, b, h0, c0, peep, gh, gcT = _inputs(dev, n, t, h, use_peep, init,
                                               seed=n * t + h + 1)
    hs, _, _, gates, cs = lstm_fwd_cuda(xp, rw, b, h0, c0, peep, fb,
                                        save_workspace=True)
    dxp, dh0, dc0 = lstm_bwd_cuda(gates, cs, c0, gh, gcT, rw, peep)
    whs, wgates, wcs = _fwd_float64(xp, rw, b, h0, c0, peep, fb)
    wdxp, wdh0, wdc0 = _bwd_float64(gates, cs, c0, gh, gcT, rw, peep)
    torch.cuda.synchronize()
    for name, a, w in (("hs", hs, whs), ("gates", gates, wgates),
                       ("cs", cs, wcs)):
        assert _entry_err(a, w) <= TOL_FWD, (name, _entry_err(a, w))
    for name, a, w in (("dxp", dxp, wdxp), ("dh0", dh0, wdh0),
                       ("dc0", dc0, wdc0)):
        assert _entry_err(a, w) <= TOL_BWD, (name, _entry_err(a, w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_launch_plan_follows_the_route_rule(dev, case):
    """dl4j_lstm_plan takes the route the wrapper's rule names: on the
    resident route clusters of 16 that the card holds, ceil(H / 16) units
    a block and the shared memory of resident_smem_bytes; on the step
    route 8 x 8 tiles without clusters."""
    n, _, h = CASES[case][:3]
    plan = launch_plan(n, h, dev)
    assert plan["route"] == route(h)
    if plan["route"] == "resident":
        assert (plan["cluster"], plan["row_tile"], plan["units"],
                plan["blocks"]) == (16, 8, -(-h // 16), 16 * -(-n // 8))
        assert (plan["fwd_smem_bytes"],
                plan["bwd_smem_bytes"]) == resident_smem_bytes(h)
        assert plan["fwd_active_clusters"] >= 1
        assert plan["bwd_active_clusters"] >= 1
    else:
        assert (plan["cluster"], plan["units"], plan["blocks"],
                plan["fwd_active_clusters"]) == (
                    1, 8, -(-h // 8) * -(-n // 8), 0)


@pytest.mark.parametrize("case", ["train_shape_graves", "h320_resident_limit",
                                  "h321_step_route"])
def test_kernel_launches_per_call_follow_the_route(dev, case):
    """The profiler's count of the sweeps' kernels in one call of each: one
    persistent kernel on the resident route, T (forward) and T + 1
    (backward) step kernels on the step route. Idle host time at both
    edges of the recording keeps every kernel record in the trace
    (chip_smoke.TRACE_EDGE_S)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    n, t, h, use_peep, fb, init = CASES[case]
    xp, rw, b, h0, c0, peep, gh, gcT = _inputs(dev, n, t, h, use_peep, init,
                                               seed=7)
    _, _, _, gates, cs = lstm_fwd_cuda(xp, rw, b, h0, c0, peep, fb,
                                       save_workspace=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        lstm_fwd_cuda(xp, rw, b, h0, c0, peep, fb, save_workspace=True)
        lstm_bwd_cuda(gates, cs, c0, gh, gcT, rw, peep)
        torch.cuda.synchronize()
        time.sleep(0.1)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    count = {k: sum(k in x for x in names) for k in (
        "lstm_fwd_persistent_kernel", "lstm_bwd_persistent_kernel",
        "lstm_fwd_step_kernel", "lstm_bwd_step_kernel")}
    if route(h) == "resident":
        want = (1, 1, 0, 0)
    else:
        want = (0, 0, t, t + 1)
    assert tuple(count.values()) == want, count


def test_gradients_are_bit_identical_over_two_runs(dev):
    """One writer per element and no atomics: deterministic sweeps."""
    xp, rw, b, h0, c0, peep, gh, gcT = _inputs(dev, 32, 128, 256, True,
                                               True, seed=3)
    runs = []
    for _ in range(2):
        _, _, _, gates, cs = lstm_fwd_cuda(xp, rw, b, h0, c0, peep, 1.0,
                                           save_workspace=True)
        runs.append((gates, cs) + lstm_bwd_cuda(gates, cs, c0, gh, gcT, rw,
                                                peep))
    for a, w in zip(*runs):
        assert torch.equal(a, w)


def _op_inputs(dev, seed, n=6, t=30, i=11, h=72):
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal((n, t, i)), 0.2 * r.standard_normal((i, 4 * h)),
            0.2 * r.standard_normal((h, 4 * h)),
            0.1 * r.standard_normal((4 * h,)),
            0.1 * r.standard_normal((3, h)),
            np.tanh(r.standard_normal((n, h))), r.standard_normal((n, h))]
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


@pytest.mark.parametrize("peep", [True, False], ids=["graves", "plain"])
def test_autograd_op_matches_ops_rnn_on_the_card(dev, peep):
    """The ``lstm`` op, forward and every gradient (x, W, RW, b, the
    peepholes and the initial state), against autograd through the plain
    ``ops/rnn.lstm`` loop on the same card; one launch of each kernel."""
    arrs = _op_inputs(dev, seed=5)

    def run(fn):
        leaves = [a.clone().requires_grad_() for a in arrs]
        x, wx, wh, b, pe, h0, c0 = leaves
        kw = {"peepholes": tuple(pe) if peep else None, "forget_bias": 1.0,
              "init_state": opsrnn.LSTMState(h0, c0)}
        out, st = fn(x, wx, wh, b, **kw)
        w = torch.cos(torch.arange(out.numel(), device=dev,
                                   dtype=torch.float32)).reshape(out.shape)
        loss = (out * w).sum() + 2 * st.h.sum() + 3 * st.c.sum()
        grads = torch.autograd.grad(loss, leaves if peep else
                                    leaves[:4] + leaves[5:])
        return out.detach(), grads

    _dispatch.reset_launch_counts()
    out_k, g_k = run(lstm)
    assert _dispatch.launch_counts() == {"lstm_fwd": 1, "lstm_bwd": 1}
    out_p, g_p = run(lambda x, wx, wh, b, **kw: opsrnn.lstm(
        x, wx, wh, b, kw.pop("init_state"), **kw))
    assert _max_err(out_k, out_p) <= TOL_FWD
    for a, w in zip(g_k, g_p):
        assert _max_err(a, w) <= 1e-4 * max(1.0, w.abs().max().item())


def test_inference_writes_no_workspace(dev):
    arrs = _op_inputs(dev, seed=9)
    x, wx, wh, b = (a.requires_grad_() for a in arrs[:4])
    n, t, i = x.shape
    h = wh.shape[0]
    with torch.inference_mode():
        _dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out, _ = lstm(x, wx, wh, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
    assert _dispatch.launch_counts() == {"lstm_fwd": 1}
    assert out.shape == (n, t, h)
    # a copy of x, x·W [T,N,4H], hs [T,N,H], the cell state and the zero
    # h0/c0 [N,H], plus 64 KiB of allocator rounding; the workspace (gates
    # [T,N,4H] and cell states [T,N,H], 259 KiB here) would not fit
    assert peak <= 4 * (t * n * (i + 5 * h) + 3 * n * h) + 65536, peak


def test_full_width_char_rnn_train_step_matches_the_plain_path(dev):
    """bench_lstm's char-RNN (vocab 77, hidden 256, seq 256, two
    GravesLSTM layers, batch 32): the loss and every gradient through
    lstm_fwd/lstm_bwd against the same model with plain LSTMs (backend
    "plain") on the card — loss to 1e-5 relative, each leaf to 1e-3 of its
    max floored at 1e-4 of the largest, as for BERT — then one Adam step
    of each, params to 2·lr (Adam maps a rounding-level gradient to ±lr)."""
    lr = 1e-3
    models = {b: text_generation_lstm(device=dev, vocab_size=77, hidden=256,
                                      seq_len=256, backend=b, seed=0,
                                      updater=Adam(lr))
              for b in ("pallas", "plain")}
    r = np.random.default_rng(0)
    ids = r.integers(0, 77, (32, 257))
    eye = np.eye(77, dtype=np.float32)
    batch = batch_to_device({"features": eye[ids[:, :-1]],
                             "labels": eye[ids[:, 1:]]}, dev)
    out = {}
    for backend, model in models.items():
        trainer = Trainer(model)
        ts = trainer.init_state()  # the same seed: the same weights
        _dispatch.reset_launch_counts()
        loss, _, _, grads = trainer._grad_of(ts.params, {}, batch, None)
        counts = _dispatch.launch_counts()
        ts, _ = trainer.train_step(ts, batch)
        out[backend] = (loss.item(), dict(flatten_with_names(grads)),
                        dict(flatten_with_names(ts.params)), counts)
    (loss_k, g_k, p_k, counts_k), (loss_p, g_p, p_p, counts_p) = (
        out["pallas"], out["plain"])
    assert counts_k == {"lstm_fwd": 2, "lstm_bwd": 2} and counts_p == {}
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    top = max(g.abs().max().item() for g in g_p.values())
    for name, g in g_p.items():
        scale = max(g.abs().max().item(), 1e-4 * top)
        assert (g_k[name] - g).abs().max().item() <= 1e-3 * scale, name
    for name, p in p_p.items():
        assert (p_k[name] - p).abs().max().item() <= 2 * lr, name
