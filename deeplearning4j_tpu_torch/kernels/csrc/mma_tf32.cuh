// Float32-grade tensor-core helpers (3xTF32 on mma.sync.m16n8k8) for the
// float32 flash-attention kernels: float32 shared tiles and their cp.async
// copies, the split of a float32 value into two TF32 parts, the operand
// fragments (ldmatrix for K-major tiles, single loads for MN-major ones,
// accumulators fed back as A), the products and the accumulator epilogue.
// Included by flash_fwd.cu and flash_bwd.cu; each builds into its own
// library, so the anonymous namespace gives each its own copy.
//
// One block of 4 warps (128 threads) owns a 64-row tile, 16 rows a warp.
// An m16n8 accumulator of lane l holds rows l/4 and l/4 + 8 of the warp's
// 16, columns 2(l%4) and 2(l%4) + 1 of its 8.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {
namespace tf32 {

using wg::cp_async16;
using wg::cp_async_commit;
using wg::cp_async_wait;
using wg::kRows;
using wg::kThreads;
using wg::smem_addr;

// A [kRows][D] float32 tile in shared memory, row stride D + 4 floats.
template <int D>
struct Tile {
  static constexpr int kStride = D + 4;
  static constexpr int kFloats = kRows * kStride;
};

// Rows [0, kRows) of a tile whose row 0 is at src ([rows][D] contiguous)
// into shared memory at dst. Rows at or past ``rows``, and rows whose
// valid[r] is 0 (when valid is given), are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows, const float* valid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < rows && (valid == nullptr || valid[r] > 0.f);
    cp_async16(smem_addr(dst + r * Tile<D>::kStride + 4 * c),
               ok ? src + r * D + 4 * c : src, ok);
  }
}

// An operand fragment as two TF32 parts, big + small = x to about 21 bits.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

// big: x rounded to TF32 (half a TF32 ulp added to the magnitude, the low
// 13 bits cut); small: x - big, exact in float32, which the tensor core
// reads as TF32 by ignoring its low 13 bits (CUTLASS's
// round_half_ulp_truncate and round_toward_zero). Three instructions.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Four 8 x 4 float32 matrices from shared memory (ldmatrix of 8 x 8 b16):
// lanes 8m..8m+7 give the addresses of matrix m's rows, and register m of
// lane l receives row l / 4, column l % 4 of matrix m.
__device__ __forceinline__ void ldmatrix_x4(float (&r)[4], uint32_t addr) {
  uint32_t u[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
      : "r"(addr));
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(u[i]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[16 x 8] += a[16 x 8] . b[8 x 8] in float32 grade: the cross terms
// first, then big x big.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// The same product with the cross terms (about 2^-11 of it) summed apart,
// in cor, which the caller adds to d once the sum over k is complete: d
// takes one instruction a k step in place of three, and the two chains
// run side by side.
__device__ __forceinline__ void mma3(float (&d)[4], float (&cor)[4],
                                     const Frag<4>& a, const Frag<2>& b) {
  mma(cor, a.small, b.big);
  mma(cor, a.big, b.small);
  mma(d, a.big, b.big);
}

// 2^x with ex2.approx (2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment coordinates of a lane: g = lane / 4 (A rows g, g + 8; B column
// g), t = lane % 4.
__device__ __forceinline__ int lane_g() { return (threadIdx.x % 32) / 4; }
__device__ __forceinline__ int lane_t() { return threadIdx.x % 4; }

// A = rows r0..r0+15, columns c0..c0+7 of a tile (row-major [row][k]):
// one ldmatrix, the four 8 x 4 quarters (rows +0/+8, columns +0/+4) in
// the order of a0..a3.
template <int D>
__device__ __forceinline__ Frag<4> frag_a(const float* tile, int r0,
                                         int c0) {
  const int l = threadIdx.x % 32, m = l / 8;
  float x[4];
  ldmatrix_x4(x, smem_addr(tile + (r0 + l % 8 + 8 * (m & 1)) *
                                      Tile<D>::kStride +
                           c0 + 4 * (m >> 1)));
  Frag<4> f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.big[i], f.small[i]);
  return f;
}

// B of the n8 tiles n0 and n0 + 8, B[k][n] = tile[n0 + n][c0 + k]: the
// tile's rows are B's columns (the tile K-major: Q and dO in S^T and
// dP^T, K and V in S and dP). One ldmatrix: b0, b1 of tile n0, then of
// tile n0 + 8.
template <int D>
__device__ __forceinline__ void frag_b_k2(Frag<2> (&f)[2], const float* tile,
                                          int n0, int c0) {
  const int l = threadIdx.x % 32, m = l / 8;
  float x[4];
  ldmatrix_x4(x, smem_addr(tile + (n0 + l % 8 + 8 * (m >> 1)) *
                                      Tile<D>::kStride +
                           c0 + 4 * (m & 1)));
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f[i / 2].big[i % 2],
                                    f[i / 2].small[i % 2]);
}

// B[k][n] = tile[k0 + k'][n0 + n] in the permuted k order of an
// accumulator fed as A (frag_acc): k = t reads row k0 + 2t, k = t + 4 row
// k0 + 2t + 1 (the tile MN-major).
template <int D>
__device__ __forceinline__ Frag<2> frag_b_mn(const float* tile, int k0,
                                            int n0) {
  constexpr int kS = Tile<D>::kStride;
  const float* p = tile + (k0 + 2 * lane_t()) * kS + n0 + lane_g();
  Frag<2> f;
  split(p[0], f.big[0], f.small[0]);
  split(p[kS], f.big[1], f.small[1]);
  return f;
}

// An m16n8 accumulator (rows g, g + 8; columns 2t, 2t + 1) as the A
// fragment of one k8 step, in the permuted k order of frag_b_mn.
__device__ __forceinline__ Frag<4> frag_acc(const float (&c)[4]) {
  Frag<4> f;
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
  return f;
}

// Rows r0 + g (+8) of the D / 8 accumulators of a [16][D] output tile,
// times mul, into a [*, D] float32 matrix at out (row 0 of the tile); rows
// at or past ``rows`` are skipped.
template <int D>
__device__ __forceinline__ void store_acc(float* out,
                                          const float (&d)[D / 8][4], int r0,
                                          int rows, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + lane_g() + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * D + 8 * n +
                                 2 * lane_t()) =
          make_float2(d[n][2 * h] * mul, d[n][2 * h + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
}

// acc[n0 + n] += part[n], rounded as float32 adds round.
template <int N, int M>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&part)[M][4], int n0) {
#pragma unroll
  for (int n = 0; n < M; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n0 + n][i] += part[n][i];
}

}  // namespace tf32
}  // namespace
