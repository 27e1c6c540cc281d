"""Gradient compression: threshold and bitmap codecs (↔ deeplearning4j_tpu/ops/compression.py).

The libnd4j encode_threshold/decode_threshold and encode_bitmap/
decode_bitmap ops, with residual accumulation: what was not sent (and the
quantization error of what was) stays in the returned residual. Plain
PyTorch, fixed shapes, the JAX package's "xla" codec:

- :func:`threshold_encode` / :func:`threshold_decode` — up to
  ``max_elements`` (index, ±threshold) pairs, the largest magnitudes
  first, ties to the lower index (``jax.lax.top_k``'s order, here a stable
  descending sort: ``torch.topk`` promises no order among ties);
- :func:`bitmap_encode` / :func:`bitmap_decode` — a dense 2-bit plane, 16
  codes in each int32 word, code i at bits 2i: 0 below the threshold, 1
  for +threshold, 2 for -threshold. A word with code 2 in slot 15 has bit
  31 set and is negative as an int32; the packing sums in int64 and wraps.

``bitmap_encode`` here compares in the gradient's own dtype against the
threshold cast to it, as the JAX package's XLA codec does. The fused
kernel (``kernels/bitmap_pack.py``) compares in float32, as the Pallas
kernel it replaces does; for float32 gradients the two are bit-identical.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class ThresholdEncoded(NamedTuple):
    """Sparse codec output: up to ``max_elements`` (index, ±threshold)."""

    indices: torch.Tensor    # [max_elements] int32, -1 = empty slot
    signs: torch.Tensor      # [max_elements] int8 (+1/-1; 0 = empty)
    threshold: torch.Tensor  # scalar float32
    count: torch.Tensor      # scalar int32: how many slots are live


def threshold_encode(grad: torch.Tensor, threshold: float,
                     max_elements: int
                     ) -> Tuple[ThresholdEncoded, torch.Tensor]:
    """↔ encode_threshold: entries with |g| >= threshold are quantized to
    ±threshold; the rest (and any overflow beyond ``max_elements``) stays
    in the returned residual. Deterministic: the largest magnitudes win
    the slots, the lower index first among equal magnitudes.

    Returns (encoded, residual) with residual.shape == grad.shape."""
    flat = grad.reshape(-1)
    n = flat.shape[0]
    mag = flat.abs()
    score = torch.where(mag >= threshold, mag, torch.full_like(mag, -1.0))
    k = min(max_elements, n)
    top_val, top_idx = torch.sort(score, descending=True, stable=True)
    top_val, top_idx = top_val[:k], top_idx[:k]
    live = top_val >= threshold
    count = live.sum(dtype=torch.int32)
    idx = torch.where(live, top_idx, -1).to(torch.int32)
    sgn = torch.where(live, torch.sign(flat[top_idx]),
                      torch.zeros((), dtype=flat.dtype,
                                  device=flat.device)).to(torch.int8)
    if k < max_elements:
        idx = torch.cat([idx, idx.new_full((max_elements - k,), -1)])
        sgn = torch.cat([sgn, sgn.new_zeros((max_elements - k,))])
    # the residual: everything not sent, plus the quantization error of
    # what was (g - ±threshold), the reference's residual rule
    vals = torch.where(idx >= 0, sgn.to(flat.dtype) * threshold,
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    sent = torch.zeros_like(flat).index_add_(
        0, torch.where(idx >= 0, idx, 0).long(), vals)
    residual = (flat - sent).reshape(grad.shape)
    enc = ThresholdEncoded(idx, sgn, torch.tensor(threshold,
                                                  dtype=torch.float32,
                                                  device=flat.device), count)
    return enc, residual


def threshold_decode(encoded: ThresholdEncoded, shape) -> torch.Tensor:
    """↔ decode_threshold: scatter ±threshold back into a dense float32
    array of ``shape``."""
    n = math.prod(int(s) for s in shape)
    idx = encoded.indices
    flat = torch.zeros((n,), dtype=torch.float32, device=idx.device)
    vals = torch.where(idx >= 0,
                       encoded.signs.to(torch.float32) * encoded.threshold,
                       torch.zeros((), device=idx.device))
    return flat.index_add_(0, torch.where(idx >= 0, idx, 0).long(),
                           vals).reshape(shape)


def bitmap_codes(flat: torch.Tensor, threshold) -> torch.Tensor:
    """The 2-bit code of each element of ``flat`` against ``threshold`` (a
    number or a 0-d tensor compared in ``flat``'s dtype): int64."""
    return torch.where(flat >= threshold, 1,
                       torch.where(flat <= -threshold, 2, 0)).long()


def pack_codes(code: torch.Tensor) -> torch.Tensor:
    """int64 codes [n] → int32 words [ceil(n/16)], code i of a word at
    bits 2i; summed in int64 and wrapped into the int32 range."""
    n = code.shape[0]
    words = torch.nn.functional.pad(code, (0, (-n) % 16)).reshape(-1, 16)
    shifts = torch.arange(16, device=code.device, dtype=torch.int64) * 2
    packed = (words << shifts).sum(dim=1)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(
        torch.int32)


def bitmap_encode(grad: torch.Tensor, threshold: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """↔ encode_bitmap: dense 2-bit plane, 0 = below threshold, 1 =
    +threshold, 2 = -threshold, packed 16 codes per int32 word. Returns
    (packed int32 [ceil(n/16)], residual like grad). There is no element
    cap: the size is n/16 words always."""
    flat = grad.reshape(-1)
    thr = torch.tensor(threshold, dtype=flat.dtype, device=flat.device)
    code = bitmap_codes(flat, thr)
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    sent = torch.where(code == 1, thr, torch.where(code == 2, -thr, zero))
    return pack_codes(code), (flat - sent).reshape(grad.shape)


def bitmap_decode(packed: torch.Tensor, threshold: float, shape
                  ) -> torch.Tensor:
    """↔ decode_bitmap: the float32 array of ``shape`` the words encode."""
    n = math.prod(int(s) for s in shape)
    words = packed.long()[:, None] & 0xFFFFFFFF
    shifts = torch.arange(16, device=packed.device, dtype=torch.int64) * 2
    codes = ((words >> shifts) & 0x3).reshape(-1)[:n]
    thr = torch.tensor(threshold, dtype=torch.float32, device=packed.device)
    zero = torch.zeros((), device=packed.device)
    return torch.where(codes == 1, thr, torch.where(
        codes == 2, -thr, zero)).reshape(shape)


def compress_ratio(n_elements: int, encoded: ThresholdEncoded) -> float:
    """Wire-size ratio vs dense float32 (diagnostic, host-side)."""
    wire = int(encoded.indices.shape[0]) * (4 + 1) + 8
    return wire / (n_elements * 4)
