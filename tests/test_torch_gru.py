"""The port's GRU scan (plain versions and the autograd op) against the JAX package, on the CPU.

``reference_gru_fwd``/``reference_gru_bwd`` against the Pallas kernels
``_gru_pallas_fwd``/``_gru_pallas_bwd`` (interpret mode off a TPU); the
port's ``gru`` op and its gradients against the JAX package's
``gru_scan.gru`` forced onto its kernel path; an untiled shape and an
initial state against JAX ``ops/rnn.gru``, which is what the JAX package
computes for them. Inputs are made from a numpy seed and handed to both.
The CUDA kernels themselves are held against these plain versions on the
card (test_torch_gru_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import gru_scan as jax_scan
from deeplearning4j_tpu.ops import rnn as jax_rnn
from deeplearning4j_tpu_torch.kernels import gru_scan
from deeplearning4j_tpu_torch.ops import rnn as opsrnn

N, T, I, H = 8, 6, 16, 128  # the JAX kernels' tiled shapes
# float32 on both sides, sums in another order (XLA vs torch matmuls):
# forward values (|h| <= 1) and dz̃ to 1e-5 of max(1, max |JAX|); parameter
# gradients (sums over T·N of order-1 terms) to 1e-4 of max(1, max |JAX|).
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
    """x, w_x, w_h, b as float32 numpy, scaled as the JAX package's own
    kernel tests scale them."""
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((n, t, i)), 0.1 * r.standard_normal((i, 3 * h)),
        0.1 * r.standard_normal((h, 3 * h)),
        0.1 * r.standard_normal((3 * h,)))]


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


def test_reference_sweeps_match_the_jax_pallas_kernels():
    x, w_x, w_h, b = _arrays(0)
    xp_tm = np.einsum("nti,ih->tnh", x, w_x).astype(np.float32)
    zeros = np.zeros((N, H), np.float32)
    jfwd = jax.jit(lambda xp, rw, b, z: jax_scan._gru_pallas_fwd(
        xp, rw, b, z, save_workspace=True))(xp_tm, w_h, b, zeros)
    got = gru_scan.reference_gru_fwd(*map(torch.from_numpy,
                                          (xp_tm, w_h, b, zeros)),
                                     save_workspace=True)
    for name, g, w in zip(("hs", "hT", "gates", "hpn"), got, jfwd):
        _close(g, w, TOL_FWD, name)
    hs, gates, hpn = (np.array(jfwd[i]) for i in (0, 2, 3))  # writable
    h_prev = np.concatenate([zeros[None], hs[:-1]])
    gh = np.random.default_rng(1).standard_normal((T, N, H)).astype(
        np.float32)
    jdxp = jax.jit(jax_scan._gru_pallas_bwd)(gates, hpn, h_prev, gh, w_h)
    dxp, dh0 = gru_scan.reference_gru_bwd(
        *map(torch.from_numpy, (gates, hpn, h_prev, gh, w_h)))
    _close(dxp, jdxp, TOL_FWD, "dxp")
    # the carry after step 0 is the initial state's gradient: check it
    # against autograd of the plain forward
    h0 = torch.zeros((N, H), requires_grad=True)
    hs_t, _ = gru_scan.reference_gru_fwd(
        torch.from_numpy(xp_tm), torch.from_numpy(w_h), torch.from_numpy(b),
        h0)
    want_dh0, = torch.autograd.grad((hs_t * torch.from_numpy(gh)).sum(), h0)
    _close(dh0, want_dh0, TOL_FWD, "dh0")


def _loss(out, final):
    """A loss that weights every output element differently and reads the
    final state, as the JAX package's kernel tests use."""
    w = np.cos(np.arange(np.prod(out.shape))).reshape(out.shape).astype(
        np.float32)
    if torch.is_tensor(out):
        return (out * torch.from_numpy(w)).sum() + 2.0 * final.sum()
    return jnp.sum(out * w) + 2.0 * jnp.sum(final)


def _port_grads(fn, arrays, init=None):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    h0 = None if init is None else torch.tensor(init, requires_grad=True)
    out, final = fn(*leaves, init_h=h0)
    inputs = leaves + ([h0] if h0 is not None else [])
    return out, torch.autograd.grad(_loss(out, final), inputs)


def test_gru_op_and_grads_match_the_jax_kernel_path(monkeypatch):
    """The op's forward and its gradients to x, W, RW and b, each by name,
    against the JAX package's ``gru_scan.gru`` with its Pallas kernels
    forced on (interpret mode); both take their kernel paths. dRW takes
    the rotated n-columns and db, dx, dW the raw dz̃: swapping them gives
    gradients that are wrong but plausible, hence one check per name."""
    monkeypatch.setenv("DL4J_TPU_FORCE_PALLAS", "1")
    jax_fell_back = []
    orig = jax_scan.opsrnn.gru
    monkeypatch.setattr(jax_scan.opsrnn, "gru", lambda *a, **k: (
        jax_fell_back.append(1), orig(*a, **k))[1])
    sweeps = []
    for name in ("reference_gru_fwd", "reference_gru_bwd"):
        fn = getattr(gru_scan, name)
        monkeypatch.setattr(gru_scan, name, functools.partial(
            lambda fn, name, *a, **k: (sweeps.append(name), fn(*a, **k))[1],
            fn, name))
    arrays = _arrays(7)

    def jloss(x, w_x, w_h, b):
        out, final = jax_scan.gru(x, w_x, w_h, b)
        return _loss(out, final), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*arrays)
    out, grads = _port_grads(gru_scan.gru, arrays)
    assert not jax_fell_back, "the JAX reference left its kernel path"
    assert sweeps == ["reference_gru_fwd", "reference_gru_bwd"]
    _close(out, jout, TOL_FWD, "out")
    dx, dw, drw, db = grads
    jdx, jdw, jdrw, jdb = jgrads
    _close(dx, jdx, TOL_GRAD, "dx")
    _close(dw, jdw, TOL_GRAD, "dW")
    _close(drw, jdrw, TOL_GRAD, "dRW")
    _close(db, jdb, TOL_GRAD, "db")


def test_untiled_shape_and_initial_state_match_jax_ops_rnn():
    """N=3, H=40 with a non-zero initial state: the JAX package computes
    these with ``ops/rnn.gru``; the port's op runs its sweeps, the initial
    state's gradient included, and the port's ``ops/rnn.gru`` loop agrees
    as well."""
    arrays = _arrays(11, n=3, t=6, i=5, h=40)
    init = np.tanh(np.random.default_rng(12).standard_normal(
        (3, 40))).astype(np.float32)

    def jloss(x, w_x, w_h, b, h0):
        out, final = jax_rnn.gru(x, w_x, w_h, b, h0)
        return _loss(out, final), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(*arrays, init)
    for fn in (gru_scan.gru, opsrnn.gru):
        out, grads = _port_grads(fn, arrays, init=init)
        _close(out, jout, TOL_FWD, "out")
        for name, g, w in zip(("dx", "dW", "dRW", "db", "dh0"), grads,
                              jgrads):
            _close(g, w, TOL_GRAD, f"{fn.__module__}:{name}")


def test_reversed_plain_gru_matches_jax():
    x, w_x, w_h, b = _arrays(13, n=2, t=5, i=4, h=24)
    jout, jfinal = jax.jit(functools.partial(jax_rnn.gru, reverse=True))(
        x, w_x, w_h, b)
    out, final = opsrnn.gru(*map(torch.from_numpy, (x, w_x, w_h, b)),
                            reverse=True)
    _close(out, jout, TOL_FWD, "out")
    _close(final, jfinal, TOL_FWD, "final")


def test_inference_runs_the_sweep_without_a_workspace(monkeypatch):
    seen = []
    orig = gru_scan.reference_gru_fwd
    monkeypatch.setattr(gru_scan, "reference_gru_fwd", lambda *a, **k: (
        seen.append(a[4] if len(a) > 4 else k.get("save_workspace")),
        orig(*a, **k))[1])
    x, w_x, w_h, b = (torch.from_numpy(a).requires_grad_()
                      for a in _arrays(3))
    with torch.inference_mode():
        out, final = gru_scan.gru(x, w_x, w_h, b)
    assert seen == [False]
    assert out.shape == (N, T, H) and final.shape == (N, H)
    _, _ = gru_scan.gru(x, w_x, w_h, b)
    assert seen == [False, True]


def test_cuda_wrappers_refuse_cpu_tensors():
    xp = torch.zeros((2, 3, 12))
    with pytest.raises(ValueError, match="CUDA"):
        gru_scan.gru_fwd_cuda(xp, torch.zeros(4, 12), torch.zeros(12),
                              torch.zeros(3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        gru_scan.gru_bwd_cuda(xp, torch.zeros(2, 3, 4), torch.zeros(2, 3, 4),
                              torch.zeros(3, 4), torch.zeros(2, 3, 4),
                              torch.zeros(4, 12))
