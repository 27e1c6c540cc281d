"""Fused LSTM / GravesLSTM recurrence, forward and backward (↔ deeplearning4j_tpu/kernels/lstm_scan.py).

- :func:`reference_lstm_fwd` — the plain PyTorch forward sweep, the math
  of the JAX package's ``_lstm_pallas_fwd`` in the same order;
- :func:`reference_lstm_bwd` — the plain reversed dgrad sweep of
  ``_lstm_pallas_bwd``, which also returns the dh and dc carries left
  after step 0 (the gradients of the initial state);
- :func:`lstm_fwd_cuda` / :func:`lstm_bwd_cuda` — the wrappers of the
  hand-written Hopper kernels of ``csrc/lstm_scan.cu``, ``lstm_fwd`` and
  ``lstm_bwd`` (which replace ``_make_fwd_kernel`` and ``_make_bwd_kernel``);
  :func:`route` and :func:`launch_plan` say how they launch: one
  persistent launch a call while a cluster's shared memory holds RW
  (:func:`route`, the C entry points' rule), one launch a step above;
- :func:`lstm` — the entry point the recurrent layers call. A CUDA tensor
  launches the kernels, a CPU tensor runs the plain versions. With grad
  enabled it goes through ``_LSTM`` (a ``torch.autograd.Function``, the
  JAX package's ``_lstm_core`` custom VJP): the forward saves the gates
  and cell states, the backward sweeps them and forms the weight, bias,
  input and peephole gradients outside the kernel as large products.
  Without grad (serving under ``torch.inference_mode()``) no workspace is
  written.

Everything inside the sweeps is float32 whatever the input dtype, but
for a float64 input on the CPU, whose plain sweeps run in float64 (the
path of a float64 reference; the card's kernels are float32 only);
outputs come back in ``x``'s dtype. Two deliberate differences from the JAX
package's routing, neither changing the function computed: its kernels
take only the TPU's tiled shapes (N % 8 == 0, H % 128 == 0) and a zero
initial state, and send everything else to ``ops/rnn.lstm``; the CUDA
kernels take any N and H and an initial state (h0, c0), with its
gradients, so no call on the card goes to the plain scan.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build, _dispatch
from deeplearning4j_tpu_torch.ops.rnn import LSTMState

KERNEL = "lstm_scan"  # one source, two kernels: lstm_fwd, lstm_bwd

# The resident route of csrc/lstm_scan.cu (its struct Resident): clusters
# of CLUSTER blocks of THREADS threads, ROW_TILE batch rows a cluster,
# ceil(H / CLUSTER) units a block, whose slice of RW (split into two TF32
# halves) stays in the block's shared memory, at most SMEM_LIMIT bytes
# (an H100's or H200's 227 KB).
CLUSTER, ROW_TILE, THREADS = 16, 8, 256
SMEM_LIMIT = 232448


def _cdiv(a, b):
    return -(-a // b)


def resident_smem_bytes(hidden):
    """(forward, backward) shared bytes of a block on the resident route
    for ``hidden`` units, each of the 16 blocks owning U = ceil(H / 16)
    unit slots: two mbarriers (16 bytes), the split RW slice in m16k8
    fragments (256 floats each), and forward the two h receive buffers
    (16U rows) and the two slabs of partial sums,
    backward the split dz operand and the two buffers of received partial
    sums. The k8 steps are padded to groups of 4 forward, 2 backward."""
    units = _cdiv(hidden, CLUSTER)
    fwd_mt, fwd_ks = _cdiv(4 * units, 16), 4 * _cdiv(2 * units, 4)
    bwd_mt, bwd_ks = _cdiv(hidden, 16), 2 * _cdiv(4 * units, 16)
    fwd = (4 + fwd_mt * fwd_ks * 256 + 2 * 64 * fwd_ks
           + 2 * ROW_TILE * (16 * fwd_mt + 4))
    bwd = (4 + bwd_mt * bwd_ks * 256 + 128 * bwd_ks
           + 2 * CLUSTER * ROW_TILE * units)
    return 4 * fwd, 4 * bwd


def route(hidden):
    """``"resident"`` (one persistent launch a call) when both sweeps'
    shared memory fits a block and a block's (row, unit) pairs fit its
    threads, else ``"step"`` (one launch a step): the rule of
    ``Resident::fits`` in csrc/lstm_scan.cu, by shape alone. H <= 320."""
    units = _cdiv(hidden, CLUSTER)
    fits = (max(resident_smem_bytes(hidden)) <= SMEM_LIMIT
            and ROW_TILE * units <= THREADS
            and _cdiv(4 * units, 16) <= 8 and _cdiv(hidden, 16) <= 24)
    return "resident" if fits else "step"


def _split4(z):
    return torch.chunk(z, 4, dim=-1)


def reference_lstm_fwd(xp_tm, rw, b, h0, c0, peep, forget_bias,
                       save_workspace=False):
    """Plain forward sweep; xp_tm [T,N,4H] (``x·W``, time-major), rw
    [H,4H], b [4H], h0/c0 [N,H], peep [3,H] or None. Returns (hs [T,N,H],
    hT, cT) and, with ``save_workspace``, the post-activation gates
    [T,N,4H] and the cell states [T,N,H]; all float32 (float64 for a
    float64 ``xp_tm``)."""
    dt = _ref_dtype(xp_tm)
    rw, b = rw.to(dt), b.to(dt)
    h, c = h0.to(dt), c0.to(dt)
    hs, gates, cs = [], [], []
    for t in range(xp_tm.shape[0]):
        z = xp_tm[t].to(dt) + h @ rw + b
        zi, zf, zg, zo = _split4(z)
        if peep is not None:
            zi = zi + peep[0] * c
            zf = zf + peep[1] * c
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf + forget_bias)
        g = torch.tanh(zg)
        c = f * c + i * g
        if peep is not None:
            zo = zo + peep[2] * c
        o = torch.sigmoid(zo)
        h = o * torch.tanh(c)
        hs.append(h)
        if save_workspace:
            gates.append(torch.cat([i, f, g, o], dim=1))
            cs.append(c)
    out = (torch.stack(hs), h, c)
    if save_workspace:
        return out + (torch.stack(gates), torch.stack(cs))
    return out


def reference_lstm_bwd(gates_tm, cs_tm, c_prev_tm, gh_tm, gcT, rw, peep):
    """Plain reversed dgrad sweep → (dxp_tm [T,N,4H], dh0 [N,H], dc0
    [N,H]). ``gh_tm`` [T,N,H] is the upstream dL/dh_t with dL/dh_T folded
    into the last step, ``gcT`` dL/dc_T; the dh carry starts at 0. dh0 and
    dc0 are the carries left after step 0. Float32, or float64 for
    float64 ``gates_tm``."""
    dt = _ref_dtype(gates_tm)
    rw = rw.to(dt)
    dh = torch.zeros_like(gcT, dtype=dt)
    dc = gcT.to(dt)
    dxp = torch.empty_like(gates_tm, dtype=dt)
    for t in range(gates_tm.shape[0] - 1, -1, -1):
        ig, fg, gg, og = _split4(gates_tm[t])
        c_prev = c_prev_tm[t]
        dh_total = gh_tm[t] + dh
        tanh_c = torch.tanh(cs_tm[t])
        do = dh_total * tanh_c
        dzo = do * og * (1.0 - og)
        dc = dc + dh_total * og * (1.0 - tanh_c * tanh_c)
        if peep is not None:
            dc = dc + dzo * peep[2]
        dzi = dc * gg * ig * (1.0 - ig)
        dzf = dc * c_prev * fg * (1.0 - fg)
        dzg = dc * ig * (1.0 - gg * gg)
        dc_next = dc * fg
        if peep is not None:
            dc_next = dc_next + dzi * peep[0] + dzf * peep[1]
        dz = torch.cat([dzi, dzf, dzg, dzo], dim=1)
        dxp[t] = dz
        dh = dz @ rw.t()
        dc = dc_next
    return dxp, dh, dc


# -- the CUDA kernels ---------------------------------------------------------

def _lib():
    lib = _build.load(KERNEL)
    if lib.dl4j_lstm_bwd.argtypes is None:
        # argtypes last: another thread that sees them set finds the rest
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_lstm_fwd.restype = ctypes.c_int
        lib.dl4j_lstm_fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p])
        lib.dl4j_lstm_bwd.restype = ctypes.c_int
        lib.dl4j_lstm_bwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
    return lib


def lstm_fwd_cuda(xp_tm, rw, b, h0, c0, peep, forget_bias,
                  save_workspace=False):
    """Launch ``lstm_fwd`` (one launch, or T on the step route, from one
    C call) on the current stream; the arguments and results of
    :func:`reference_lstm_fwd`, as contiguous float32 CUDA tensors."""
    if not xp_tm.is_cuda:
        raise ValueError("lstm_fwd_cuda takes CUDA tensors")
    t_len, n, h4 = xp_tm.shape
    h_dim = h4 // 4
    if t_len < 1 or n < 1 or h_dim < 1 or h4 != 4 * h_dim:
        raise ValueError(f"xp_tm must be [T>=1, N>=1, 4H], got "
                         f"{tuple(xp_tm.shape)}")
    dev = xp_tm.device
    _build.check_f32(dev, xp_tm=(xp_tm, (t_len, n, h4)),
                     rw=(rw, (h_dim, h4)), b=(b, (h4,)), h0=(h0, (n, h_dim)),
                     c0=(c0, (n, h_dim)), peep=(peep, (3, h_dim)))
    hs = torch.empty((t_len, n, h_dim), dtype=torch.float32, device=dev)
    if save_workspace:
        gates = torch.empty((t_len, n, h4), dtype=torch.float32, device=dev)
        cs = torch.empty((t_len, n, h_dim), dtype=torch.float32, device=dev)
        c_state = None
    else:
        gates = cs = None
        c_state = torch.empty((n, h_dim), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.dl4j_lstm_fwd(
        dev.index, xp_tm.data_ptr(), rw.data_ptr(), b.data_ptr(),
        _build.ptr(peep), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        _build.ptr(c_state), _build.ptr(gates), _build.ptr(cs), t_len, n,
        h_dim, float(forget_bias), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, "lstm_fwd", rc)
    _dispatch.count_launch("lstm_fwd")
    if save_workspace:
        return hs, hs[-1], cs[-1], gates, cs
    return hs, hs[-1], c_state


def lstm_bwd_cuda(gates_tm, cs_tm, c0, gh_tm, gcT, rw, peep):
    """Launch ``lstm_bwd`` (one launch, or T + 1 on the step route, from
    one C call) on the current stream → (dxp_tm, dh0, dc0). Takes c0 [N,H] where
    :func:`reference_lstm_bwd` takes c_prev_tm: the kernel reads c_{t-1}
    from ``cs_tm`` itself."""
    if not gates_tm.is_cuda:
        raise ValueError("lstm_bwd_cuda takes CUDA tensors")
    t_len, n, h4 = gates_tm.shape
    h_dim = h4 // 4
    dev = gates_tm.device
    _build.check_f32(dev, gates_tm=(gates_tm, (t_len, n, h4)),
                     cs_tm=(cs_tm, (t_len, n, h_dim)), c0=(c0, (n, h_dim)),
                     gh_tm=(gh_tm, (t_len, n, h_dim)),
                     gcT=(gcT, (n, h_dim)), rw=(rw, (h_dim, h4)),
                     peep=(peep, (3, h_dim)))
    if rw.data_ptr() % 16:
        raise ValueError("rw must be 16-byte aligned (float4 loads)")
    dxp = torch.empty_like(gates_tm)
    dh0 = torch.empty_like(c0)
    dc = gcT.clone()  # the dc carry: dL/dc_T in, dL/dc_0 out
    lib = _lib()
    rc = lib.dl4j_lstm_bwd(
        dev.index, gates_tm.data_ptr(), cs_tm.data_ptr(), c0.data_ptr(),
        gh_tm.data_ptr(), rw.data_ptr(), _build.ptr(peep), dxp.data_ptr(),
        dh0.data_ptr(), dc.data_ptr(), t_len, n, h_dim,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, "lstm_bwd", rc)
    _dispatch.count_launch("lstm_bwd")
    return dxp, dh0, dc


def launch_plan(n_rows, hidden, device=None):
    """How the sweeps launch on the card for N rows and H units (the C
    entry point ``dl4j_lstm_plan``): the route, the cluster size, the row
    tile, the units a block owns, the blocks of a launch, and each
    sweep's dynamic shared memory with the number of its clusters the
    card holds at once (0 on the step route). Raises where the card
    cannot hold the resident route's clusters."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    lib = _lib()
    if lib.dl4j_lstm_plan.argtypes is None:
        lib.dl4j_lstm_plan.restype = ctypes.c_int
        lib.dl4j_lstm_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 9)()
    _build.raise_on(lib, "lstm_plan",
                    lib.dl4j_lstm_plan(dev.index, n_rows, hidden, out))
    keys = ["route", "cluster", "row_tile", "units", "blocks"] + [
        f"{sweep}_{k}" for sweep in ("fwd", "bwd")
        for k in ("smem_bytes", "active_clusters")]
    plan = dict(zip(keys, out))
    plan["route"] = "resident" if plan["route"] else "step"
    return plan


# -- dispatch and autograd ----------------------------------------------------

def _ref_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _sweep_dtype(x):
    """The sweeps' dtype for an input ``x``: float32, or float64 for a
    float64 CPU tensor (its plain sweeps keep the precision)."""
    return (torch.float64 if x.dtype == torch.float64
            and x.device.type == "cpu" else torch.float32)


def _f32(t, dtype=torch.float32):
    """``t`` contiguous in the sweeps' dtype (float32 unless given)."""
    return None if t is None else t.to(dtype).contiguous()


def _sweep_fwd(xp_tm, rw, b, h0, c0, peep, forget_bias, save_workspace):
    dt = xp_tm.dtype
    args = (xp_tm, _f32(rw, dt), _f32(b, dt), _f32(h0, dt), _f32(c0, dt),
            _f32(peep, dt), forget_bias, save_workspace)
    if _dispatch.use_kernel(xp_tm):
        return lstm_fwd_cuda(*args)
    return reference_lstm_fwd(*args)


def _project(x, w_x, dtype=torch.float32):
    """x [N,T,I] · W [I,G·H] → xp [T,N,G·H] in ``dtype``, contiguous: the
    input projection of every step as one product outside the sweep (G =
    4 gates for the LSTM, 3 for the GRU). Time-major by multiplying x's
    transposed view, which is already contiguous when x is the previous
    recurrent layer's output."""
    return torch.matmul(x.transpose(0, 1), w_x).to(dtype).contiguous()


class _LSTM(torch.autograd.Function):
    """The JAX package's ``_lstm_core`` custom VJP, with the initial state
    as an input: forward saves the workspace, backward runs the reversed
    sweep (``lstm_bwd`` on the card) and forms the other gradients."""

    @staticmethod
    def forward(ctx, x, w_x, w_h, b, peep, h0, c0, forget_bias):
        xp_tm = _project(x, w_x, _sweep_dtype(x))
        hs, hT, cT, gates, cs = _sweep_fwd(xp_tm, w_h, b, h0, c0, peep,
                                           forget_bias, True)
        ctx.save_for_backward(x, w_x, w_h, b, peep, h0, c0, hs, gates, cs)
        return (hs.transpose(0, 1).to(x.dtype), hT.to(x.dtype),
                cT.to(x.dtype))

    @staticmethod
    def backward(ctx, g_out, ghT, gcT):
        x, w_x, w_h, b, peep, h0, c0, hs, gates, cs = ctx.saved_tensors
        dt = gates.dtype  # the sweeps' (float32, or float64 on the CPU)
        h0f, c0f = _f32(h0, dt), _f32(c0, dt)
        # a copy: dL/dh_T is added into it, and g_out is autograd's
        gh_tm = g_out.to(dt).transpose(0, 1).clone(
            memory_format=torch.contiguous_format)
        gh_tm[-1] += ghT.to(dt)
        gcT = _f32(gcT, dt)
        c_prev_tm = torch.cat([c0f[None], cs[:-1]])
        if _dispatch.use_kernel(gates):
            dxp, dh0, dc0 = lstm_bwd_cuda(gates, cs, c0f, gh_tm, gcT,
                                          _f32(w_h), _f32(peep))
        else:
            dxp, dh0, dc0 = reference_lstm_bwd(gates, cs, c_prev_tm, gh_tm,
                                               gcT, w_h, _f32(peep, dt))
        t_len, n, h4 = dxp.shape
        h_dim = h4 // 4
        dz = dxp.reshape(t_len * n, h4)
        h_prev = torch.cat([h0f[None], hs[:-1]]).reshape(t_len * n, h_dim)
        x_tm = x.transpose(0, 1).to(dt).reshape(t_len * n, -1)
        d_rw = h_prev.t() @ dz
        d_b = dz.sum(0)
        d_x = (dz @ w_x.to(dt).t()).reshape(t_len, n, -1).transpose(0, 1)
        d_wx = x_tm.t() @ dz
        d_peep = None
        if peep is not None:
            dzi, dzf, _, dzo = _split4(dxp)
            d_peep = torch.stack([
                torch.sum(dzi * c_prev_tm, dim=(0, 1)),
                torch.sum(dzf * c_prev_tm, dim=(0, 1)),
                torch.sum(dzo * cs, dim=(0, 1))]).to(peep.dtype)
        return (d_x.to(x.dtype), d_wx.to(w_x.dtype), d_rw.to(w_h.dtype),
                d_b.to(b.dtype), d_peep, dh0.to(h0.dtype), dc0.to(c0.dtype),
                None)


def lstm(x, w_x, w_h, b, *, peepholes=None, forget_bias: float = 0.0,
         init_state=None):
    """Full-sequence LSTM through the fused sweeps: x [N,T,In], w_x
    [In,4H], w_h [H,4H], b [4H] → (outputs [N,T,H], final ``LSTMState``),
    the function of the JAX package's ``lstm_scan.lstm`` and
    ``ops/rnn.lstm``. ``peepholes``: an optional (pI, pF, pO) triple of [H]
    (GravesLSTM); ``init_state``: an optional ``LSTMState`` (zeros when
    None), differentiable. Gate order i, f, g, o; ``forget_bias`` is added
    inside the forget gate's sigmoid."""
    n = x.shape[0]
    h_dim = w_h.shape[0]
    peep = torch.stack(list(peepholes)) if peepholes is not None else None
    if init_state is None:
        h0 = c0 = torch.zeros((n, h_dim), dtype=torch.float32,
                              device=x.device)
    else:
        h0, c0 = init_state
    args = (x, w_x, w_h, b, peep, h0, c0)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in args):
        out, h_t, c_t = _LSTM.apply(*args, float(forget_bias))
        return out, LSTMState(h_t, c_t)
    hs, h_t, c_t = _sweep_fwd(_project(x, w_x, _sweep_dtype(x)), w_h, b,
                              h0, c0, peep,
                              float(forget_bias), False)
    return (hs.transpose(0, 1).to(x.dtype),
            LSTMState(h_t.to(x.dtype), c_t.to(x.dtype)))
