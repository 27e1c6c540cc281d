"""The port's LSTM scan (plain versions and the autograd op) against the JAX package, on the CPU.

``reference_lstm_fwd``/``reference_lstm_bwd`` against the Pallas kernels
``_lstm_pallas_fwd``/``_lstm_pallas_bwd`` (interpret mode off a TPU); the
port's ``lstm`` op and its gradients against the JAX package's
``lstm_scan.lstm`` forced onto its kernel path; untiled shapes and an
initial state against JAX ``ops/rnn.lstm``, which is what the JAX package
computes for them. Inputs are made from a numpy seed and handed to both.
The CUDA kernels themselves are held against these plain versions on the
card (test_torch_lstm_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import lstm_scan as jax_scan
from deeplearning4j_tpu.ops import rnn as jax_rnn
from deeplearning4j_tpu_torch.kernels import lstm_scan
from deeplearning4j_tpu_torch.ops import rnn as opsrnn

N, T, I, H = 8, 8, 16, 128  # the JAX kernels' tiled shapes
# float32 on both sides, sums in another order (XLA vs torch matmuls):
# forward values of order 1 to 1e-5, dz to 1e-5 of max(1, max |JAX|);
# parameter gradients (sums over T·N of order-1 terms) to 1e-4 of
# max(1, max |JAX|).
TOL_FWD = 1e-5
TOL_GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Keep torch to two intra-op threads: the suite runs beside others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _arrays(seed, n=N, t=T, i=I, h=H):
    """x, w_x, w_h, b, peep [3,H] as float32 numpy, scaled as the JAX
    package's own kernel tests scale them."""
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((n, t, i)), 0.1 * r.standard_normal((i, 4 * h)),
        0.1 * r.standard_normal((h, 4 * h)), 0.1 * r.standard_normal((4 * h,)),
        0.1 * r.standard_normal((3, h)))]


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


SWEEPS = [(True, 1.0), (True, 0.0), (False, 1.0), (False, 0.0)]
SWEEP_IDS = ["graves_fb1", "graves_fb0", "plain_fb1", "plain_fb0"]


@pytest.fixture(scope="module")
def sweep_inputs():
    x, w_x, w_h, b, peep = _arrays(0)
    xp_tm = np.einsum("nti,ih->tnh", x, w_x).astype(np.float32)
    zeros = np.zeros((N, H), np.float32)
    r = np.random.default_rng(1)
    gh = r.standard_normal((T, N, H)).astype(np.float32)
    gcT = r.standard_normal((N, H)).astype(np.float32)
    return xp_tm, w_h, b, zeros, peep, gh, gcT


@pytest.mark.parametrize("use_peep,fb", SWEEPS, ids=SWEEP_IDS)
def test_reference_sweeps_match_the_jax_pallas_kernels(sweep_inputs,
                                                       use_peep, fb):
    xp_tm, w_h, b, zeros, peep, gh, gcT = sweep_inputs
    peep = peep if use_peep else None
    jfwd = jax.jit(lambda xp, rw, b, z, pe: jax_scan._lstm_pallas_fwd(
        xp, rw, b, z, z, None if pe is None else tuple(pe), fb,
        save_workspace=True))(xp_tm, w_h, b, zeros, peep)
    t = [None if a is None else torch.from_numpy(a)
         for a in (xp_tm, w_h, b, zeros, peep)]
    got = lstm_scan.reference_lstm_fwd(t[0], t[1], t[2], t[3], t[3], t[4],
                                       fb, save_workspace=True)
    for name, g, w in zip(("hs", "hT", "cT", "gates", "cs"), got, jfwd):
        _close(g, w, TOL_FWD, name)
    gates, cs = np.array(jfwd[3]), np.array(jfwd[4])  # writable copies
    c_prev = np.concatenate([zeros[None], cs[:-1]])
    jdxp = jax.jit(lambda *a: jax_scan._lstm_pallas_bwd(
        *a[:6], None if a[6] is None else tuple(a[6])))(
        gates, cs, c_prev, gh, gcT, w_h, peep)
    dxp, dh0, dc0 = lstm_scan.reference_lstm_bwd(
        *(None if a is None else torch.from_numpy(a)
          for a in (gates, cs, c_prev, gh, gcT, w_h, peep)))
    _close(dxp, jdxp, TOL_FWD, "dxp")
    # the carries after step 0 are the initial state's gradients: check
    # them against autograd of the plain forward
    h0 = torch.zeros((N, H), requires_grad=True)
    c0 = torch.zeros((N, H), requires_grad=True)
    hs, h_t, c_t = lstm_scan.reference_lstm_fwd(
        t[0], t[1], t[2], h0, c0, t[4], fb)
    gh_t = torch.from_numpy(gh)
    loss = (hs * gh_t).sum() + (c_t * torch.from_numpy(gcT)).sum()
    want_dh0, want_dc0 = torch.autograd.grad(loss, (h0, c0))
    _close(dh0, want_dh0, TOL_FWD, "dh0")
    _close(dc0, want_dc0, TOL_FWD, "dc0")


def _loss(out, final):
    """A loss that weights every output element differently and reads the
    final state, as the JAX package's kernel tests use."""
    w = np.cos(np.arange(np.prod(out.shape))).reshape(out.shape).astype(
        np.float32)
    if torch.is_tensor(out):
        return ((out * torch.from_numpy(w)).sum() + 2.0 * final.h.sum()
                + 3.0 * final.c.sum())
    return (jnp.sum(out * w) + 2.0 * jnp.sum(final.h)
            + 3.0 * jnp.sum(final.c))


def _port_grads(fn, arrays, use_peep, forget_bias, init=None):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    x, w_x, w_h, b, peep = leaves
    state = None
    if init is not None:
        state = opsrnn.LSTMState(*(torch.tensor(a, requires_grad=True)
                                   for a in init))
    out, final = fn(x, w_x, w_h, b, peepholes=tuple(peep) if use_peep
                    else None, forget_bias=forget_bias, init_state=state)
    inputs = leaves + (list(state) if state is not None else [])
    grads = torch.autograd.grad(_loss(out, final), inputs, allow_unused=True)
    return out, final, grads


@pytest.mark.parametrize("use_peep", [True, False], ids=["graves", "plain"])
def test_lstm_op_and_grads_match_the_jax_kernel_path(use_peep, monkeypatch):
    """The op's forward and its gradients to x, W, RW, b and the peepholes
    against the JAX package's ``lstm_scan.lstm`` with its Pallas kernels
    forced on (interpret mode); both take their kernel paths."""
    monkeypatch.setenv("DL4J_TPU_FORCE_PALLAS", "1")
    jax_fell_back = []
    orig = jax_scan.opsrnn.lstm
    monkeypatch.setattr(jax_scan.opsrnn, "lstm", lambda *a, **k: (
        jax_fell_back.append(1), orig(*a, **k))[1])
    sweeps = []
    for name in ("reference_lstm_fwd", "reference_lstm_bwd"):
        fn = getattr(lstm_scan, name)
        monkeypatch.setattr(lstm_scan, name, functools.partial(
            lambda fn, name, *a, **k: (sweeps.append(name), fn(*a, **k))[1],
            fn, name))
    arrays = _arrays(7)
    fb = 1.0

    def jloss(x, w_x, w_h, b, peep):
        out, final = jax_scan.lstm(x, w_x, w_h, b, peepholes=tuple(peep)
                                   if use_peep else None, forget_bias=fb)
        return _loss(out, final), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*arrays)
    out, _, grads = _port_grads(lstm_scan.lstm, arrays, use_peep, fb)
    assert not jax_fell_back, "the JAX reference left its kernel path"
    assert sweeps == ["reference_lstm_fwd", "reference_lstm_bwd"]
    _close(out, jout, TOL_FWD, "out")
    names = ("dx", "dw_x", "dw_h", "db", "dpeep")
    for name, g, w in zip(names, grads, jgrads):
        if name == "dpeep" and not use_peep:
            assert g is None
            continue
        _close(g, w, TOL_GRAD, name)


@pytest.mark.parametrize("use_peep", [True, False], ids=["graves", "plain"])
def test_untiled_shape_and_initial_state_match_jax_ops_rnn(use_peep):
    """N=3, H=40 with a non-zero initial state: the JAX package computes
    these with ``ops/rnn.lstm``; the port's op runs its sweeps, gradients
    to the initial state included."""
    arrays = _arrays(11, n=3, t=6, i=5, h=40)
    r = np.random.default_rng(12)
    init = [np.tanh(r.standard_normal((3, 40))).astype(np.float32),
            r.standard_normal((3, 40)).astype(np.float32)]

    def jloss(x, w_x, w_h, b, peep, h0, c0):
        out, final = jax_rnn.lstm(
            x, w_x, w_h, b, jax_rnn.LSTMState(h0, c0),
            peepholes=tuple(peep) if use_peep else None, forget_bias=1.0)
        return _loss(out, final), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(7)), has_aux=True))(*arrays, *init)
    for fn in (lstm_scan.lstm, opsrnn.lstm):
        out, _, grads = _port_grads(fn, arrays, use_peep, 1.0, init=init)
        _close(out, jout, TOL_FWD, "out")
        for name, g, w in zip(("dx", "dw_x", "dw_h", "db", "dpeep", "dh0",
                               "dc0"), grads, jgrads):
            if name == "dpeep" and not use_peep:
                continue
            _close(g, w, TOL_GRAD, f"{fn.__module__}:{name}")


def test_inference_runs_the_sweep_without_a_workspace(monkeypatch):
    seen = []
    orig = lstm_scan.reference_lstm_fwd
    monkeypatch.setattr(lstm_scan, "reference_lstm_fwd", lambda *a, **k: (
        seen.append(a[7] if len(a) > 7 else k.get("save_workspace")),
        orig(*a, **k))[1])
    x, w_x, w_h, b, _ = (torch.from_numpy(a).requires_grad_()
                         for a in _arrays(3))
    with torch.inference_mode():
        out, final = lstm_scan.lstm(x, w_x, w_h, b, forget_bias=1.0)
    assert seen == [False]
    assert out.shape == (N, T, H) and final.h.shape == (N, H)
    _, _ = lstm_scan.lstm(x, w_x, w_h, b, forget_bias=1.0)
    assert seen == [False, True]


def test_cuda_wrappers_refuse_cpu_tensors():
    xp = torch.zeros((2, 3, 16))
    with pytest.raises(ValueError, match="CUDA"):
        lstm_scan.lstm_fwd_cuda(xp, torch.zeros(4, 16), torch.zeros(16),
                                torch.zeros(3, 4), torch.zeros(3, 4), None,
                                1.0)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_scan.lstm_bwd_cuda(xp, torch.zeros(2, 3, 4), torch.zeros(3, 4),
                                torch.zeros(2, 3, 4), torch.zeros(3, 4),
                                torch.zeros(4, 16), None)


# the card tests' shapes (test_torch_lstm_cuda.py CASES), the char-RNN's
# H=256, and the step route's H=1024 case of chip_smoke.py
ROUTES = {1: "resident", 13: "resident", 40: "resident", 64: "resident",
          128: "resident", 200: "resident", 256: "resident",
          320: "resident", 321: "step", 1024: "step"}


@pytest.mark.parametrize("hidden", sorted(ROUTES))
def test_route_rule_sends_each_width_to_its_route(hidden):
    """The wrapper's mirror of csrc/lstm_scan.cu's Resident::fits: RW
    stays in the clusters' shared memory up to H = 320, and every shape
    above takes the step kernels."""
    assert lstm_scan.route(hidden) == ROUTES[hidden]


def test_route_rule_has_one_threshold_within_a_block():
    """Resident exactly for H <= 320, and every resident width's shared
    memory within a block's 227 KB (the char-RNN's H=256: 148.27 KiB
    forward, 148.02 KiB backward)."""
    widths = range(1, 1201)
    resident = [h for h in widths if lstm_scan.route(h) == "resident"]
    assert resident == list(range(1, 321))
    assert all(max(lstm_scan.resident_smem_bytes(h)) <= lstm_scan.SMEM_LIMIT
               for h in resident)
    assert max(lstm_scan.resident_smem_bytes(321)) > lstm_scan.SMEM_LIMIT
    assert lstm_scan.resident_smem_bytes(256) == (151824, 151568)
