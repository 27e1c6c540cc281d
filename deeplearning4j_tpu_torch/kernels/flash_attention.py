"""Blockwise (flash) attention forward (↔ deeplearning4j_tpu/kernels/flash_attention.py).

Three functions:

- :func:`reference_attention` — the plain PyTorch version, a port of the
  JAX package's ``reference_attention`` in the same order of operations;
- :func:`flash_attention_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/flash_fwd.cu`` (which replaces the Pallas ``_flash_kernel``);
- :func:`flash_attention` — the entry point layers call: a CUDA tensor
  launches the kernel, a CPU tensor runs the plain version.

Fully-masked query rows (a batch row whose key mask is all zero, such as
the zero rows ``ParallelInference`` pads a bucket with) come out as 0 from
the kernel and as uniform attention from the plain version, exactly as the
JAX package's kernel and reference disagree; callers never read them.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build, _dispatch

_NEG_INF = -1e30
KERNEL = "flash_fwd"
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, *, causal=False, bias=None, key_mask=None,
                        scale=None):
    """O(T²) attention; q [B,H,T,D], k/v [B,H,S,D]. fp32 softmax.

    ``key_mask`` [B,S] 1/0 is folded into an additive bias. Fully-masked
    rows produce uniform attention (softmax of a constant)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhtd,bhsd->bhts", q, k).float() * scale
    if bias is not None:
        s = s + bias
    if key_mask is not None:
        s = s + torch.where(key_mask[:, None, None, :] > 0, 0.0, _NEG_INF)
    if causal:
        t_len, s_len = s.shape[-2], s.shape[-1]
        idx_t = torch.arange(t_len, device=s.device)[:, None]
        idx_s = torch.arange(s_len, device=s.device)[None, :]
        s = torch.where(idx_t + (s_len - t_len) >= idx_s, s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", p, v)


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


def flash_attention(q, k, v, *, causal: bool = False, scale=None, bias=None,
                    key_mask=None):
    """Attention entry point; q [B,H,T,D], k/v [B,H,S,D] → [B,H,T,D].

    CUDA tensors launch the hand kernel; CPU tensors run
    :func:`reference_attention`. ``key_mask`` [B,S] 1/0 runs inside the
    kernel. An additive ``bias`` has no kernel path and raises on CUDA
    (nothing on the port's path passes one)."""
    if not _dispatch.use_kernel(q):
        return reference_attention(q, k, v, causal=causal, bias=bias,
                                   key_mask=key_mask, scale=scale)
    if bias is not None:
        raise NotImplementedError(
            "flash_attention: an additive bias has no CUDA kernel path")
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), key_mask, causal=causal,
                                scale=scale)
