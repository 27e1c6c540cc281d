"""Fused bitmap gradient encode: classify, pack, residual (↔ deeplearning4j_tpu/kernels/bitmap_pack.py).

- :func:`reference_bitmap_encode` — the plain PyTorch version of the
  Pallas kernel ``_kernel``: the gradient cast to float32, each element
  classified against the threshold (code 1 if g >= thr, 2 if g <= -thr,
  else 0), 16 codes packed into each int32 word (code i at bits 2i), and
  the residual g - sent computed in float32 and cast back to g's dtype;
- :func:`bitmap_encode_cuda` — the wrapper of the hand-written kernel of
  ``csrc/bitmap_pack.cu``, ``bitmap_pack``: one thread per packed word
  reads its 16 elements once and writes the word and 16 residuals;
- :func:`bitmap_encode` — the entry point, with the JAX package's
  signature. ``backend="auto"`` or ``"pallas"``: the kernel on a CUDA
  tensor, its plain version on a CPU tensor; ``"xla"``: the plain codec
  of ``ops/compression.py`` on any device (what the tests and
  ``chip_smoke.py`` compare with).

For float32 gradients the kernel, its plain version and the codec are
bit-identical. For bfloat16 the kernel follows the Pallas kernel's rule
(compare and subtract in float32, round the residual once), which may
differ from the codec's (compare and subtract in g's dtype) near
±threshold; other dtypes are refused on the card. Elements past n in the
last word encode as 0, as in the codec (the Pallas kernel classifies its
zero padding, which differs only for a threshold <= 0).
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.kernels import _build, _dispatch
from deeplearning4j_tpu_torch.ops import compression as _codec

KERNEL = "bitmap_pack"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_bitmap_encode(grad, threshold):
    """Plain version of the kernel → (packed int32 [ceil(n/16)], residual
    like grad)."""
    g = grad.reshape(-1).float()
    thr = torch.tensor(threshold, dtype=torch.float32, device=g.device)
    code = _codec.bitmap_codes(g, thr)
    sent = torch.where(code == 1, thr, torch.where(
        code == 2, -thr, torch.zeros((), device=g.device)))
    return (_codec.pack_codes(code),
            (g - sent).to(grad.dtype).reshape(grad.shape))


def _lib():
    lib = _build.load(KERNEL)
    if lib.dl4j_bitmap_encode.argtypes is None:
        # argtypes last: another thread that sees them set finds the rest
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_bitmap_encode.restype = ctypes.c_int
        lib.dl4j_bitmap_encode.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def bitmap_encode_cuda(grad, threshold):
    """Launch ``bitmap_pack`` on the current stream → (packed int32
    [ceil(n/16)], residual like grad); grad a float32 or bfloat16 CUDA
    tensor (copied first if it is not contiguous)."""
    if not grad.is_cuda:
        raise ValueError("bitmap_encode_cuda takes CUDA tensors")
    if grad.dtype not in _DTYPE_CODES:
        raise ValueError(f"bitmap_pack takes {sorted(map(str, _DTYPE_CODES))}"
                         f", got {grad.dtype}")
    flat = grad.contiguous().reshape(-1)
    n = flat.numel()
    packed = torch.empty(((n + 15) // 16,), dtype=torch.int32,
                         device=grad.device)
    resid = torch.empty_like(flat)
    if n:
        lib = _lib()
        rc = lib.dl4j_bitmap_encode(
            grad.device.index, flat.data_ptr(), packed.data_ptr(),
            resid.data_ptr(), n, float(threshold), _DTYPE_CODES[grad.dtype],
            torch.cuda.current_stream(grad.device).cuda_stream)
        _build.raise_on(lib, "bitmap_pack", rc)
        _dispatch.count_launch("bitmap_pack")
    return packed, resid.reshape(grad.shape)


def bitmap_encode(grad, threshold: float, *, backend: str = "auto"):
    """Fused bitmap encode; the contract of ``ops/compression.
    bitmap_encode``: (packed int32 [ceil(n/16)], residual like grad).
    backend: "auto" | "pallas" (the kernel, or on the CPU its plain
    version) | "xla" (the plain codec)."""
    if backend == "xla":
        return _codec.bitmap_encode(grad, threshold)
    if backend not in ("auto", "pallas"):
        raise ValueError(f"unknown bitmap backend {backend!r}; valid: "
                         "'auto', 'pallas', 'xla'")
    if _dispatch.use_kernel(grad):
        return bitmap_encode_cuda(grad, threshold)
    return reference_bitmap_encode(grad, threshold)
