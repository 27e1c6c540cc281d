// Hopper (sm_90a) tile helpers for the bf16 flash-attention kernels: the
// swizzled shared-memory tiles, wgmma descriptors and instructions, fences,
// the cp.async ring's copies and the accumulator epilogue. Included by
// flash_fwd.cu and flash_bwd.cu; each builds into its own library, so the
// anonymous namespace gives each its own copy.
//
// One warpgroup (128 threads) owns a 64-row tile: the rows are wgmma's M.
// An accumulator of N columns is N/2 floats a thread; thread (warp w, lane
// l) holds rows 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) (+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wg {

constexpr int kRows = 64;      // query rows and keys per tile: wgmma's M
constexpr int kThreads = 128;  // one warpgroup
constexpr int kSlices = kRows / 16;  // k16 slices of a tile's 64 rows

// A [kRows][D] bf16 tile in shared memory, in wgmma's canonical swizzled
// layout. D = 64 and 128: column blocks of 64 values (rows of 128 bytes,
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8));
// D = 32: rows of 64 bytes, 64-byte swizzle (chunk c ^ ((r / 2) % 4)).
// Every tile starts on a 1024-byte boundary, where the pattern repeats.
template <int D>
struct Tile {
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;
  static constexpr int kBlockBytes = kRows * kRowBytes;  // one column block
  static constexpr int kBytes = kRows * D * 2;
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: the SBO
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2;  // 128B / 64B swizzle
  // wgmma's N for the accumulating products: column blocks of kN values
  static constexpr int kN = D >= 64 ? 64 : 32;
  static constexpr int kNB = D / kN;

  __device__ static uint32_t offset(int r, int c) {  // 16-byte chunk c
    constexpr int kChunks = kRowBytes / 16;
    const int sw = D >= 64 ? (r & 7) : ((r >> 1) & 3);
    return (c / kChunks) * kBlockBytes + r * kRowBytes +
           (((c % kChunks) ^ sw) << 4);
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// The tile as a K-major operand (its rows are wgmma's M or N, its D
// columns the reduction): k16 slice s starts 32 bytes further along the
// row, in column block s / (kRowBytes / 32).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int s) {
  using L = Tile<D>;
  constexpr int kPerBlock = L::kRowBytes / 32;
  return make_desc(tile + (s / kPerBlock) * L::kBlockBytes +
                       (s % kPerBlock) * 32,
                   16, L::kGroupBytes, L::kLayout);
}

// The tile as an MN-major operand (its rows are the reduction, its columns
// wgmma's N): k16 slice s starts 16 rows down; nb picks the column block.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s, int nb) {
  using L = Tile<D>;
  return make_desc(tile + nb * L::kBlockBytes + s * 16 * L::kRowBytes,
                   L::kBlockBytes, L::kGroupBytes, L::kLayout);
}

#define DL4J_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DL4J_ACC16(i) \
  DL4J_ACC4(i), DL4J_ACC4(i + 4), DL4J_ACC4(i + 8), DL4J_ACC4(i + 12)
#define DL4J_ACC32(i) DL4J_ACC16(i), DL4J_ACC16(i + 16)

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major; ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : DL4J_ACC32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (the fragment
// layout of an accumulator's k16 slice), B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DL4J_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (the fragment
// layout of an accumulator's k16 slice), B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : DL4J_ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The accumulating products: wgmma's N is the tile's column block.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d, a, b);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n32(d, a, b);
}

#undef DL4J_ACC32
#undef DL4J_ACC16
#undef DL4J_ACC4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory; with ok false the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, kRows) of a tile whose row 0 is at src ([rows][D] contiguous)
// into shared memory at dst. Rows at or past ``rows``, and rows whose
// valid[r] is 0 (when valid is given), are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int rows,
                                          const float* valid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < rows && (valid == nullptr || valid[r] > 0.f);
    cp_async16(dst + Tile<D>::offset(r, c), ok ? src + r * D + c * 8 : src,
               ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 accumulator as four k16 A fragments, rounded to bf16. Thread
// (warp w, lane l) holds d[4j + e] at row 16w + l/4 + 8(e/2), column
// 8j + 2(l%4) + e%2; fragment register i of slice s holds rows l/4 (+8
// for odd i), columns 16s + 2(l%4) (+8 for i >= 2): the same values.
__device__ __forceinline__ void to_frags(const float (&d)[32],
                                         uint32_t (&a)[kSlices][4]) {
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[s][i] = pack_bf16(d[8 * s + 2 * i], d[8 * s + 2 * i + 1]);
}

// Rows row0 (+8) of an accumulator of column block nb into a [*, D] bf16
// matrix at out (row 0 of the tile); rows at or past ``rows`` are skipped.
template <int D, int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out,
                                          const float (&d)[N], int nb,
                                          int row0, int col0, int rows) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<uint32_t*>(
          out + static_cast<size_t>(r) * D + nb * Tile<D>::kN + 8 * j +
          col0) = pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// The first 1024-byte boundary at or after raw: where the tiles start.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

}  // namespace wg
}  // namespace
