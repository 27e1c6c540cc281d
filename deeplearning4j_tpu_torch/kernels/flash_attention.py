"""Blockwise (flash) attention, forward and backward (↔ deeplearning4j_tpu/kernels/flash_attention.py).

- :func:`reference_attention` — the plain PyTorch forward, a port of the
  JAX package's ``reference_attention`` in the same order of operations;
  :func:`reference_attention_lse` also returns the row log-sum-exp;
- :func:`reference_attention_bwd` — the plain backward from the saved
  LSE, in the math of the JAX package's ``_bwd_recompute``;
  :func:`reference_delta` is its rowsum(dO·O);
- :func:`flash_attention_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/flash_fwd.cu`` (which replaces the Pallas ``_flash_kernel``);
- :func:`flash_attention_bwd_cuda` — the wrapper of the three kernels of
  ``csrc/flash_bwd.cu``: ``flash_bwd_delta`` (the pre-pass rowsum(dO·O),
  which the JAX package leaves to XLA) and ``flash_bwd_dkv`` and
  ``flash_bwd_dq`` (which replace ``_flash_bwd_dkv_kernel`` and
  ``_flash_bwd_dq_kernel``);
- :func:`flash_attention` — the entry point layers call: a CUDA tensor
  launches the kernels, a CPU tensor runs the plain versions. With grad
  enabled it goes through ``_FlashAttention`` (a ``torch.autograd.Function``:
  the forward saves the LSE, the backward recomputes the scores from it),
  the same path on both devices but for the kernels. On the card a head
  size the kernels lack (below 128) runs zero-padded to the next one
  (:func:`pad_head`), as the JAX kernel pads D to 128 lanes.

Fully-masked query rows (a batch row whose key mask is all zero, such as
the zero rows ``ParallelInference`` pads a bucket with) come out as 0 from
the kernel and as uniform attention from the plain version, exactly as the
JAX package's kernel and reference disagree; callers never read them.
Their gradients are 0 from both backwards.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels import _build, _dispatch

_NEG_INF = -1e30
_LSE_FLOOR = -1e20  # the JAX package's clamp of the LSE in backward
KERNEL = "flash_fwd"
# one source, three kernels: flash_bwd_delta, flash_bwd_dkv, flash_bwd_dq
BWD_KERNEL = "flash_bwd"
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _causal_keep(t_len, s_len, device):
    """[T, S] bool: query i sees key j iff i + (S - T) >= j (bottom-right)."""
    idx_t = torch.arange(t_len, device=device)[:, None]
    idx_s = torch.arange(s_len, device=device)[None, :]
    return idx_t + (s_len - t_len) >= idx_s


def _scores(q, k, *, causal, bias, key_mask, scale):
    s = torch.einsum("bhtd,bhsd->bhts", q, k).float() * scale
    if bias is not None:
        s = s + bias
    if key_mask is not None:
        s = s + torch.where(key_mask[:, None, None, :] > 0, 0.0, _NEG_INF)
    if causal:
        s = torch.where(_causal_keep(s.shape[-2], s.shape[-1], s.device), s,
                        _NEG_INF)
    return s


def reference_attention(q, k, v, *, causal=False, bias=None, key_mask=None,
                        scale=None):
    """O(T²) attention; q [B,H,T,D], k/v [B,H,S,D]. fp32 softmax.

    ``key_mask`` [B,S] 1/0 is folded into an additive bias. Fully-masked
    rows produce uniform attention (softmax of a constant)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = _scores(q, k, causal=causal, bias=bias, key_mask=key_mask,
                scale=scale)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", p, v)


def reference_attention_lse(q, k, v, *, causal=False, key_mask=None,
                            scale=None):
    """:func:`reference_attention` and the row log-sum-exp of the scaled,
    masked scores, [B·H, T] float32 (about -1e30 on fully-masked rows),
    the layout ``flash_attention_cuda(return_lse=True)`` writes."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = _scores(q, k, causal=causal, bias=None, key_mask=key_mask,
                scale=scale)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    b, h, t, _ = q.shape
    lse = torch.logsumexp(s, dim=-1).reshape(b * h, t)
    return torch.einsum("bhts,bhsd->bhtd", p, v), lse


def reference_attention_bwd(q, k, v, key_mask, out, lse, g, *, causal=False,
                            scale=None):
    """Plain FlashAttention-2 backward from the saved LSE → (dq, dk, dv).

    The math of the JAX package's ``_bwd_recompute`` and its two kernels,
    in float32, over the whole [T, S] score matrix at once:
    delta = rowsum(dO·O); p = exp(s − max(lse, −1e20)), 0 where masked;
    dp = dO·Vᵀ; dS = p·(dp − delta)·scale; dV = pᵀ·dO, dK = dSᵀ·Q,
    dQ = dS·K. As ``_bwd_recompute`` hands p and dS to its products in
    the inputs' dtype, they are rounded to it (bf16; nothing changes for
    float32) before the last three products, which sum in float32.
    Causal is aligned to the bottom right. Rows whose keys are all masked
    get 0 gradients. Gradients come out in the inputs' dtypes."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    b, h, t, _ = q.shape
    s_len = k.shape[2]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    keep = torch.ones((1, 1, t, s_len), dtype=torch.bool, device=q.device)
    if key_mask is not None:
        keep = keep & (key_mask[:, None, None, :] > 0)
    if causal:
        keep = keep & _causal_keep(t, s_len, q.device)
    s = torch.where(keep, s, _NEG_INF)
    lse = torch.clamp(lse.reshape(b, h, t, 1), min=_LSE_FLOOR)
    p = torch.exp(s - lse)  # exactly 0 where masked
    delta = reference_delta(out, g).reshape(b, h, t, 1)
    dp = torch.einsum("bhtd,bhsd->bhts", gf, vf)
    ds = p * (dp - delta) * scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bhts,bhtd->bhsd", p, gf)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_delta(out, g):
    """rowsum(dO·O) in float32 → [B·H, T]: the plain version of the
    ``flash_bwd_delta`` kernel, as the JAX package computes it outside its
    kernels (``jnp.sum(out.astype(f32) * g.astype(f32), axis=-1)``)."""
    b, h, t, _ = out.shape
    return torch.sum(out.float() * g.float(), dim=-1).reshape(b * h, t)


def _check(q, k, v, key_mask):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v must share one of {list(_DTYPE_CODES)}; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T|S, D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} has no kernel; supported: "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if key_mask is not None:
        if key_mask.shape != (b, k.shape[2]):
            raise ValueError(f"key_mask must be [B, S] = {(b, k.shape[2])}, "
                             f"got {tuple(key_mask.shape)}")
        if key_mask.device != q.device:
            raise ValueError("key_mask must be on q's device")


def flash_attention_cuda(q, k, v, key_mask=None, *, causal=False,
                         scale=None, return_lse=False):
    """Launch ``csrc/flash_fwd.cu`` on ``torch.cuda.current_stream()``.

    q [B,H,T,D], k/v [B,H,S,D] contiguous CUDA tensors, float32 or
    bfloat16, D in (32, 64, 128); ``key_mask`` [B,S] 1/0. Returns the
    output in q's dtype, and with ``return_lse`` also the row log-sum-exp
    [B·H, T] float32 (about -7e29 on fully-masked rows)."""
    _check(q, k, v, key_mask)
    b, h, t, d = q.shape
    s_len = k.shape[2]
    scale = (d ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = (torch.empty((b * h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    km = (key_mask.to(torch.float32).contiguous()
          if key_mask is not None else None)
    lib = _lib()
    rc = lib.dl4j_flash_fwd(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        km.data_ptr() if km is not None else None, out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, h, t, s_len, d, scale, int(causal), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: CUDA error {rc} "
            f"({lib.dl4j_cuda_error_string(rc).decode()})")
    _dispatch.count_launch(KERNEL)
    return (out, lse) if return_lse else out


def _lib():
    lib = _build.load(KERNEL)
    if lib.dl4j_flash_fwd.argtypes is None:
        # argtypes last: another thread that sees them set finds the rest
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_flash_fwd.restype = ctypes.c_int
        lib.dl4j_flash_fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return lib


def set_bwd_argtypes(lib):
    """The ctypes signatures of ``flash_bwd``'s dkv and dq entries (and of
    its delta entry, where the library has one)."""
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
    if hasattr(lib, "dl4j_flash_bwd_delta"):
        lib.dl4j_flash_bwd_delta.restype = ctypes.c_int
        lib.dl4j_flash_bwd_delta.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
    lib.dl4j_flash_bwd_dkv.restype = ctypes.c_int
    lib.dl4j_flash_bwd_dkv.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + tail)
    lib.dl4j_flash_bwd_dq.restype = ctypes.c_int
    # argtypes last: another thread that sees them set finds the rest
    lib.dl4j_flash_bwd_dq.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + tail)


def _bwd_lib():
    lib = _build.load(BWD_KERNEL)
    if lib.dl4j_flash_bwd_dq.argtypes is None:
        set_bwd_argtypes(lib)
    return lib


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({lib.dl4j_cuda_error_string(rc).decode()})")


def _check_bwd(q, k, v, key_mask, out, lse):
    """q/k/v/key_mask as ``_check``; out like q (its layout and g's are
    ``flash_bwd_delta_cuda``'s to check); lse [B·H, T] float32."""
    _check(q, k, v, key_mask)
    b, h, t, _ = q.shape
    if (out.shape != q.shape or out.dtype != q.dtype
            or out.device != q.device):
        raise ValueError(f"out must match q: {tuple(out.shape)} "
                         f"{out.dtype} {out.device}")
    if (lse.shape != (b * h, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B·H, T] = "
                         f"{(b * h, t)} on q's device")


def flash_bwd_delta_cuda(out, g):
    """Launch ``csrc/flash_bwd.cu``'s ``flash_bwd_delta`` on the current
    stream → rowsum(dO·O) [B·H, T] float32 (:func:`reference_delta`).

    out/g [B,H,T,D] contiguous, 16-byte aligned CUDA tensors of one dtype
    (float32 or bfloat16, D in (32, 64, 128))."""
    if not (out.is_cuda and out.dim() == 4 and out.dtype in _DTYPE_CODES):
        raise ValueError("out must be a [B, H, T, D] float32 or bfloat16 "
                         "CUDA tensor")
    if g.shape != out.shape or g.dtype != out.dtype or g.device != out.device:
        raise ValueError(f"g must match out: {tuple(g.shape)} {g.dtype} "
                         f"{g.device}")
    b, h, t, d = out.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} has no kernel; supported: "
                         f"{HEAD_DIMS}")
    for name, x in (("out", out), ("g", g)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    delta = torch.empty((b * h, t), dtype=torch.float32, device=out.device)
    lib = _bwd_lib()
    rc = lib.dl4j_flash_bwd_delta(
        out.device.index, out.data_ptr(), g.data_ptr(), delta.data_ptr(),
        b * h * t, d, _DTYPE_CODES[out.dtype],
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(lib, rc, "flash_bwd_delta")
    _dispatch.count_launch("flash_bwd_delta")
    return delta


def flash_bwd_kernels_cuda(lib, q, k, v, key_mask, lse, g, delta, *,
                           causal=False, scale=None):
    """Launch ``lib``'s ``flash_bwd_dkv`` and ``flash_bwd_dq`` on the
    current stream from a given ``delta`` [B·H, T] float32 → (dq, dk, dv);
    each counts its launch. ``lib`` is the loaded ``flash_bwd`` library
    (``_bwd_lib()``; an A/B run passes an older build of the source)."""
    b, h, t, d = q.shape
    s_len = k.shape[2]
    scale = (d ** -0.5) if scale is None else float(scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    km = (key_mask.to(torch.float32).contiguous()
          if key_mask is not None else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
              km.data_ptr() if km is not None else None, g.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    tail = (b, h, t, s_len, d, scale, int(causal), _DTYPE_CODES[q.dtype],
            stream)
    for name, outs in (("flash_bwd_dkv", (dk.data_ptr(), dv.data_ptr())),
                       ("flash_bwd_dq", (dq.data_ptr(),))):
        rc = getattr(lib, f"dl4j_{name}")(q.device.index, *common, *outs,
                                          *tail)
        _raise_on(lib, rc, name)
        _dispatch.count_launch(name)
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, key_mask, out, lse, g, *,
                             causal=False, scale=None):
    """Launch ``csrc/flash_bwd.cu``'s three kernels on the current stream
    → (dq, dk, dv) in q's dtype.

    q/out/g [B,H,T,D], k/v [B,H,S,D] contiguous CUDA tensors of one dtype
    (float32 or bfloat16, D in (32, 64, 128)), ``key_mask`` [B,S] 1/0 or
    None, ``lse`` [B·H, T] float32 as ``flash_attention_cuda`` writes it.
    ``flash_bwd_delta`` writes delta = rowsum(dO·O) (the JAX package
    computes it outside its kernels), ``flash_bwd_dkv`` then dK and dV,
    ``flash_bwd_dq`` dQ; each counts its launch."""
    _check_bwd(q, k, v, key_mask, out, lse)
    delta = flash_bwd_delta_cuda(out, g)
    return flash_bwd_kernels_cuda(_bwd_lib(), q, k, v, key_mask, lse, g,
                                  delta, causal=causal, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Attention whose backward recomputes the scores from the saved LSE
    (↔ the JAX package's ``_flash`` custom VJP). A CUDA tensor runs
    ``flash_fwd`` with the LSE, then ``flash_bwd_delta``, ``flash_bwd_dkv``
    and ``flash_bwd_dq``;
    a CPU tensor runs :func:`reference_attention_lse` and
    :func:`reference_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale):
        if _dispatch.use_kernel(q):
            out, lse = flash_attention_cuda(q, k, v, key_mask, causal=causal,
                                            scale=scale, return_lse=True)
        else:
            out, lse = reference_attention_lse(q, k, v, causal=causal,
                                               key_mask=key_mask, scale=scale)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_cuda if _dispatch.use_kernel(q)
               else reference_attention_bwd)
        dq, dk, dv = bwd(q, k, v, key_mask, out, lse, g.contiguous(),
                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def kernel_head_size(d):
    """The head size the kernels run a head of ``d`` at: the least of
    ``HEAD_DIMS`` that holds it. Above the largest it raises."""
    for size in HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"head size {d} exceeds the flash kernels' limit of "
                     f"{HEAD_DIMS[-1]}")


def pad_head(attend, q, k, v, *, scale=None):
    """``attend(q, k, v, scale)`` at the kernels' head size: q, k and v
    zero-padded on D to ``kernel_head_size(D)``, the output sliced back
    to D. The scale is the original D's (D^-0.5 unless given). Zero
    columns add nothing to QKᵀ and give zero output columns, so the
    result is the unpadded attention; padding and slicing are autograd
    ops, so a backward through ``attend`` runs on the padded tensors and
    its gradients come back [.., D]. (The JAX wrapper pads D to its
    128-lane tile the same way.)"""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    size = kernel_head_size(d)
    if size == d:
        return attend(q, k, v, scale)
    pad = (0, size - d)
    return attend(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad),
                  scale)[..., :d]


def flash_attention(q, k, v, *, causal: bool = False, scale=None, bias=None,
                    key_mask=None):
    """Attention entry point; q [B,H,T,D], k/v [B,H,S,D] → [B,H,T,D].

    CUDA tensors launch the hand kernels; CPU tensors run the plain
    versions. ``key_mask`` [B,S] 1/0 runs inside the kernels. When grad is
    enabled and q, k or v requires it, the call goes through
    ``_FlashAttention``, whose backward is ``flash_bwd_delta``,
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` on the card. On the card a
    head size outside ``HEAD_DIMS`` runs zero-padded to the next of them
    (``pad_head``), forward and backward; above 128 it raises. An
    additive ``bias`` has no kernel path:
    it runs the plain version on the CPU and raises on CUDA (nothing on the
    port's path passes one)."""
    if bias is not None:
        if _dispatch.use_kernel(q):
            raise NotImplementedError(
                "flash_attention: an additive bias has no CUDA kernel path")
        return reference_attention(q, k, v, causal=causal, bias=bias,
                                   key_mask=key_mask, scale=scale)
    if _dispatch.use_kernel(q) and q.shape[-1] not in HEAD_DIMS:
        return pad_head(lambda qp, kp, vp, s: flash_attention(
            qp, kp, vp, causal=causal, scale=s, key_mask=key_mask),
            q, k, v, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), key_mask, causal, scale)
    if not _dispatch.use_kernel(q):
        return reference_attention(q, k, v, causal=causal,
                                   key_mask=key_mask, scale=scale)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), key_mask, causal=causal,
                                scale=scale)
