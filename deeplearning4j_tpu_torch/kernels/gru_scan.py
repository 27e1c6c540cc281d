"""Fused GRU recurrence, forward and backward (↔ deeplearning4j_tpu/kernels/gru_scan.py).

- :func:`reference_gru_fwd` — the plain PyTorch forward sweep, the math of
  the JAX package's ``_gru_pallas_fwd`` in the same order;
- :func:`reference_gru_bwd` — the plain reversed dgrad sweep of
  ``_gru_pallas_bwd``, which also returns the dh carry left after step 0
  (the gradient of the initial state);
- :func:`gru_fwd_cuda` / :func:`gru_bwd_cuda` — the wrappers of the
  hand-written Hopper kernels of ``csrc/gru_scan.cu``, ``gru_fwd`` and
  ``gru_bwd`` (which replace ``_make_fwd_kernel`` and ``_make_bwd_kernel``:
  3xTF32 products on ``mma.sync``, the reduction split across a
  thread-block cluster, one dependent launch a step);
  :func:`launch_plan` says how they launch for a shape;
- :func:`gru` — the entry point the GRU layer calls. A CUDA tensor
  launches the kernels, a CPU tensor runs the plain versions. With grad
  enabled it goes through ``_GRU`` (a ``torch.autograd.Function``, the JAX
  package's ``_gru_core`` custom VJP): the forward saves the gates and
  h·RW_n, the backward sweeps them and forms the weight, bias and input
  gradients outside the kernel as large products. Without grad (serving
  under ``torch.inference_mode()``) no workspace is written.

Gate order r, z, n; the candidate reads r ⊙ (h·RW_n), the reset applied
after the recurrent product:

    r, z = σ(xp_rz + h·RW_rz + b_rz)
    n    = tanh(xp_n + r ⊙ (h·RW_n) + b_n)
    h'   = (1 − z) ⊙ n + z ⊙ h

Everything inside the sweeps is float32 whatever the input dtype; outputs
come back in ``x``'s dtype. As for the LSTM, the JAX package's kernels
take only the TPU's tiled shapes (N % 8 == 0, H % 128 == 0) and a zero
initial state, and send everything else to ``ops/rnn.gru``; the CUDA
kernels take any N and H and an initial state h0, with its gradient, so
no call on the card goes to the plain scan.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build, _dispatch
from deeplearning4j_tpu_torch.kernels.lstm_scan import _f32, _project

KERNEL = "gru_scan"  # one source, two kernels: gru_fwd, gru_bwd


def _split3(z):
    return torch.chunk(z, 3, dim=-1)


def reference_gru_fwd(xp_tm, rw, b, h0, save_workspace=False):
    """Plain forward sweep; xp_tm [T,N,3H] (``x·W``, time-major), rw
    [H,3H], b [3H], h0 [N,H]. Returns (hs [T,N,H], hT) and, with
    ``save_workspace``, the post-activation gates [T,N,3H] (r, z, n) and
    the candidate's recurrent product h·RW_n [T,N,H]; all float32."""
    rw, b = rw.float(), b.float()
    h = h0.float()
    h_dim = h.shape[-1]
    hs, gates, hpns = [], [], []
    for t in range(xp_tm.shape[0]):
        hproj = h @ rw
        xp = xp_tm[t].float()
        rz = torch.sigmoid(xp[:, :2 * h_dim] + hproj[:, :2 * h_dim]
                           + b[:2 * h_dim])
        r, z = rz[:, :h_dim], rz[:, h_dim:]
        hpn = hproj[:, 2 * h_dim:]
        n = torch.tanh(xp[:, 2 * h_dim:] + r * hpn + b[2 * h_dim:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
        if save_workspace:
            gates.append(torch.cat([r, z, n], dim=1))
            hpns.append(hpn)
    out = (torch.stack(hs), h)
    if save_workspace:
        return out + (torch.stack(gates), torch.stack(hpns))
    return out


def reference_gru_bwd(gates_tm, hpn_tm, h_prev_tm, gh_tm, rw):
    """Plain reversed dgrad sweep → (dxp_tm [T,N,3H], dh0 [N,H]).
    ``dxp_tm`` holds dz̃ = [dr_pre, dz_pre, dn_pre]; the dh carry goes
    through the rotated vector [dr_pre, dz_pre, r ⊙ dn_pre]·RWᵀ. ``gh_tm``
    [T,N,H] is the upstream dL/dh_t with dL/dh_T folded into the last
    step; the carry starts at 0, and the one left after step 0 is dh0."""
    rw = rw.float()
    dh = torch.zeros_like(gh_tm[0], dtype=torch.float32)
    dxp = torch.empty_like(gates_tm, dtype=torch.float32)
    for t in range(gates_tm.shape[0] - 1, -1, -1):
        r, z, n = _split3(gates_tm[t])
        dh_total = gh_tm[t] + dh
        dn = dh_total * (1.0 - z)
        dz = dh_total * (h_prev_tm[t] - n)
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hpn_tm[t]
        dr_pre = dr * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxp[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
        rot = torch.cat([dr_pre, dz_pre, r * dn_pre], dim=1)
        dh = dh_total * z + rot @ rw.t()
    return dxp, dh


# -- the CUDA kernels ---------------------------------------------------------

def _lib():
    lib = _build.load(KERNEL)
    if lib.dl4j_gru_bwd.argtypes is None:
        # argtypes last: another thread that sees them set finds the rest
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_gru_fwd.restype = ctypes.c_int
        lib.dl4j_gru_fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.dl4j_gru_bwd.restype = ctypes.c_int
        lib.dl4j_gru_bwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
    return lib


def gru_fwd_cuda(xp_tm, rw, b, h0, save_workspace=False):
    """Launch ``gru_fwd`` (T step launches from one C call) on the current
    stream; the arguments and results of :func:`reference_gru_fwd`, as
    contiguous float32 CUDA tensors."""
    if not xp_tm.is_cuda:
        raise ValueError("gru_fwd_cuda takes CUDA tensors")
    t_len, n, h3 = xp_tm.shape
    h_dim = h3 // 3
    if t_len < 1 or n < 1 or h_dim < 1 or h3 != 3 * h_dim:
        raise ValueError(f"xp_tm must be [T>=1, N>=1, 3H], got "
                         f"{tuple(xp_tm.shape)}")
    dev = xp_tm.device
    _build.check_f32(dev, xp_tm=(xp_tm, (t_len, n, h3)),
                     rw=(rw, (h_dim, h3)), b=(b, (h3,)), h0=(h0, (n, h_dim)))
    hs = torch.empty((t_len, n, h_dim), dtype=torch.float32, device=dev)
    gates = hpn = None
    if save_workspace:
        gates = torch.empty((t_len, n, h3), dtype=torch.float32, device=dev)
        hpn = torch.empty((t_len, n, h_dim), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.dl4j_gru_fwd(
        dev.index, xp_tm.data_ptr(), rw.data_ptr(), b.data_ptr(),
        h0.data_ptr(), hs.data_ptr(), _build.ptr(gates), _build.ptr(hpn),
        t_len, n, h_dim, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, "gru_fwd", rc)
    _dispatch.count_launch("gru_fwd")
    if save_workspace:
        return hs, hs[-1], gates, hpn
    return hs, hs[-1]


def gru_bwd_cuda(gates_tm, hpn_tm, hs_tm, h0, gh_tm, rw):
    """Launch ``gru_bwd`` (T + 1 step launches from one C call) on the
    current stream → (dxp_tm, dh0). Takes the forward's hs [T,N,H] and h0
    where :func:`reference_gru_bwd` takes h_prev_tm: the kernel reads
    h_{t-1} from them itself."""
    if not gates_tm.is_cuda:
        raise ValueError("gru_bwd_cuda takes CUDA tensors")
    t_len, n, h3 = gates_tm.shape
    h_dim = h3 // 3
    dev = gates_tm.device
    _build.check_f32(dev, gates_tm=(gates_tm, (t_len, n, h3)),
                     hpn_tm=(hpn_tm, (t_len, n, h_dim)),
                     hs_tm=(hs_tm, (t_len, n, h_dim)),
                     h0=(h0, (n, h_dim)), gh_tm=(gh_tm, (t_len, n, h_dim)),
                     rw=(rw, (h_dim, h3)))
    dxp = torch.empty_like(gates_tm)
    rotn = torch.empty((2, n, h_dim), dtype=torch.float32, device=dev)
    # the elementwise part of the dh carry, dh_total ⊙ z, kept in place
    # from step to step; dL/dh0 on return
    dh0 = torch.zeros_like(h0)
    lib = _lib()
    rc = lib.dl4j_gru_bwd(
        dev.index, gates_tm.data_ptr(), hpn_tm.data_ptr(), hs_tm.data_ptr(),
        h0.data_ptr(), gh_tm.data_ptr(), rw.data_ptr(), dxp.data_ptr(),
        rotn.data_ptr(), dh0.data_ptr(), t_len, n, h_dim,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, "gru_bwd", rc)
    _dispatch.count_launch("gru_bwd")
    return dxp, dh0


def launch_plan(n_rows, hidden, device=None):
    """How the sweeps launch on the card for N rows and H units (the C
    entry point ``dl4j_gru_plan``): the cluster size, the grid, the row
    tile, and each sweep's dynamic shared memory with the number of its
    clusters the card holds at once. Raises where the card cannot hold
    one cluster."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    lib = _lib()
    if lib.dl4j_gru_plan.argtypes is None:
        lib.dl4j_gru_plan.restype = ctypes.c_int
        lib.dl4j_gru_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 10)()
    _build.raise_on(lib, "gru_plan",
                    lib.dl4j_gru_plan(dev.index, n_rows, hidden, out))
    keys = ["row_tile", "grid_y"] + [
        f"{sweep}_{k}" for sweep in ("fwd", "bwd")
        for k in ("cluster", "grid_x", "smem_bytes", "active_clusters")]
    return dict(zip(keys, out))


# -- dispatch and autograd ----------------------------------------------------

def _sweep_fwd(xp_tm, rw, b, h0, save_workspace):
    args = (xp_tm, _f32(rw), _f32(b), _f32(h0), save_workspace)
    if _dispatch.use_kernel(xp_tm):
        return gru_fwd_cuda(*args)
    return reference_gru_fwd(*args)


class _GRU(torch.autograd.Function):
    """The JAX package's ``_gru_core`` custom VJP, with the initial state
    as an input: forward saves the workspace, backward runs the reversed
    sweep (``gru_bwd`` on the card) and forms the other gradients."""

    @staticmethod
    def forward(ctx, x, w_x, w_h, b, h0):
        xp_tm = _project(x, w_x)
        hs, h_t, gates, hpn = _sweep_fwd(xp_tm, w_h, b, h0, True)
        ctx.save_for_backward(x, w_x, w_h, b, h0, hs, gates, hpn)
        return hs.transpose(0, 1).to(x.dtype), h_t.to(x.dtype)

    @staticmethod
    def backward(ctx, g_out, ghT):
        x, w_x, w_h, b, h0, hs, gates, hpn = ctx.saved_tensors
        h0f = _f32(h0)
        # a copy: dL/dh_T is added into it, and g_out is autograd's
        gh_tm = g_out.float().transpose(0, 1).clone(
            memory_format=torch.contiguous_format)
        gh_tm[-1] += ghT.float()
        h_prev_tm = torch.cat([h0f[None], hs[:-1]])
        if _dispatch.use_kernel(gates):
            dxp, dh0 = gru_bwd_cuda(gates, hpn, hs, h0f, gh_tm, _f32(w_h))
        else:
            dxp, dh0 = reference_gru_bwd(gates, hpn, h_prev_tm, gh_tm, w_h)
        t_len, n, h3 = dxp.shape
        h_dim = h3 // 3
        # the recurrent weight's gradient takes the rotated n-columns
        # (r ⊙ dn_pre: the candidate's product was r ⊙ h·RW_n); the bias,
        # input and input-weight gradients the raw dz̃
        rot = torch.cat([dxp[..., :2 * h_dim],
                         gates[..., :h_dim] * dxp[..., 2 * h_dim:]], dim=2)
        dz = dxp.reshape(t_len * n, h3)
        d_rw = h_prev_tm.reshape(t_len * n, h_dim).t() @ rot.reshape(
            t_len * n, h3)
        d_b = dz.sum(0)
        d_x = (dz @ w_x.float().t()).reshape(t_len, n, -1).transpose(0, 1)
        x_tm = x.transpose(0, 1).float().reshape(t_len * n, -1)
        d_wx = x_tm.t() @ dz
        return (d_x.to(x.dtype), d_wx.to(w_x.dtype), d_rw.to(w_h.dtype),
                d_b.to(b.dtype), dh0.to(h0.dtype))


def gru(x, w_x, w_h, b=None, *, init_h=None):
    """Full-sequence GRU through the fused sweeps: x [N,T,In], w_x [In,3H],
    w_h [H,3H], b [3H] (zeros when None) → (outputs [N,T,H], final h
    [N,H]), the function of the JAX package's ``gru_scan.gru`` and
    ``ops/rnn.gru``. ``init_h``: an optional initial state [N,H] (zeros
    when None), differentiable."""
    n = x.shape[0]
    h_dim = w_h.shape[0]
    if b is None:
        b = torch.zeros((3 * h_dim,), dtype=torch.float32, device=x.device)
    h0 = (torch.zeros((n, h_dim), dtype=torch.float32, device=x.device)
          if init_h is None else init_h)
    args = (x, w_x, w_h, b, h0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _GRU.apply(*args)
    hs, h_t = _sweep_fwd(_project(x, w_x), w_h, b, h0, False)
    return hs.transpose(0, 1).to(x.dtype), h_t.to(x.dtype)
