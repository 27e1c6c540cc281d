// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py::
// _flash_bwd_dkv_kernel (:321) and ::_flash_bwd_dq_kernel (:352), the two
// Pallas TPU kernels launched by _flash_bwd_impl (the custom VJP of
// flash_attention). They compute the FlashAttention-2 backward from the
// forward's row log-sum-exp, in the math of _bwd_recompute:
//   p  = exp(scale * q.k - max(lse, -1e20))   (0 where masked)
//   dp = dO . v,  dS = p * (dp - delta) * scale,  delta = rowsum(dO * O)
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
// with the key-padding mask, the ragged tails and the bottom-right-aligned
// causal mask (query i sees key j iff i + (S - T) >= j). delta is computed
// by the caller (a torch op, as the JAX package computes it outside its
// kernels). Two kernels, as in the JAX package, so that every gradient
// element has exactly one writer: deterministic, no atomics. Masked and
// ragged keys get dK = dV = 0; fully masked query rows (whose LSE the
// forward writes as about -7e29) get dQ = 0, never NaN: every masked
// pair's probability is set to 0 explicitly, and the LSE is clamped at
// -1e20 as _bwd_recompute does. A key tile whose keys are all masked, and
// a tile pair wholly above the causal diagonal (_causal_block_live), does
// no work. Each dtype has its own pair of kernels.
//
// float32 (flash_bwd_dkv_kernel, flash_bwd_dq_kernel): on the CUDA cores.
// Per (batch, head) the work is 8*T*S*D operations for dK/dV (two score
// products and two accumulating products) and 6*T*S*D for dQ, over the
// visible query-key pairs. At the BERT-base training shape (B=32, H=12,
// T=S=128, D=64) unpadded that is 3.2 and 2.4 GFLOP: 48 and 36 us at 67
// TFLOP/s on the float32 CUDA cores, against about 15 us and 12 us for
// their bytes. So the operations bound both kernels. Design: one block
// per (batch*head, 32-key tile) for dK/dV, (batch*head, 32-query tile) for
// dQ; the [T, S] score and probability tiles never leave the SM. Phase 1
// of each tile pair has four threads per query row, each computing the
// score and dP of eight keys from float4 reads of shared memory (row
// stride D + 4 floats, so four different rows fall in different banks);
// phase 2 has four threads per output row (a key for dK/dV, a query for
// dQ), each owning D/4 of its dimensions in float32 registers.
//
// bfloat16 (flash_bwd_dkv_kernel_wgmma, flash_bwd_dq_kernel_wgmma): every
// product on the tensor cores (wgmma m64nNk16, bf16 operands, float32
// accumulators). At the training shape the same 3.2 and 2.4 GFLOP take
// 3.3 and 2.5 us at 989 TFLOP/s, so the bytes bound them: q, k, v, dO and
// the outputs once in bf16, the LSE and delta in float32 (0.0112 and
// 0.0093 ms at 3.35 TB/s, as chip_smoke.py counts them). What the design
// does about it: each operand tile is read from device memory once per
// block and the [T, S] tiles (S, dP, P, dS) live only in registers.
// - flash_bwd_dkv: one warpgroup (128 threads) owns a 64-key tile of one
//   (batch*head); grid (B*H, ceil(S/64)). K and V are loaded once; the
//   64-row query tiles (Q, dO, LSE, delta) stream through a two-stage
//   cp.async ring, the next tile's load in flight under this tile's
//   products. Per tile: S^T = K Q^T and dP^T = V dO^T (A and B K-major in
//   shared memory); P^T and dS^T formed and masked in the accumulator
//   registers, rounded to bf16 in place, and fed as the register A
//   operand of dV += P^T dO and dK += dS^T Q (B = dO or Q, MN-major). A
//   64 x 64 float32 accumulator read as four k16 slices has the layout of
//   the A fragment, so no shuffle is needed (the FlashAttention-3
//   arrangement).
// - flash_bwd_dq: one warpgroup owns a 64-row query tile; grid (B*H,
//   ceil(T/64)). Q, dO, LSE and delta are loaded once; the 64-key tiles
//   (K, V) stream through the ring, tiles of masked keys and tiles past
//   the causal diagonal skipped. Per tile: S = Q K^T, dP = dO V^T, dS in
//   registers as bf16, dQ += dS K (B = K, MN-major).
// Shared tiles sit in wgmma's swizzled layouts (128-byte swizzle for
// D = 64 and 128, 64-byte for D = 32, whose bf16 row is 64 bytes); rows
// past T or S and masked keys are zero-filled by the copy (source size 0),
// so no stale value ever meets a 0. Rounding as the JAX kernels do it: P
// and dS in bf16 into their products, float32 accumulation, each gradient
// rounded once to bf16 at the store. The tile helpers are shared with
// flash_fwd.cu (wgmma_sm90.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kTile = 32;     // query rows and keys per tile
constexpr int kParts = 4;     // threads sharing one row
constexpr int kThreads = kTile * kParts;  // 128
constexpr int kKeysPerThread = kTile / kParts;  // phase 1: 8 keys a thread
constexpr int kPStride = kTile + 1;  // [row][key] tiles of p and dS
constexpr float kLseFloor = -1e20f;  // _bwd_recompute's clamp
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kTile <= kThreads, "one thread per row/key for the stats");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// Rows [row0, row0 + kTile) of a contiguous [n, D] matrix into shared
// memory as float32, row stride D + 4. Rows past n, and rows whose
// valid[r] is 0 (when valid is given), are written as 0 and never read.
template <typename T, int D>
__device__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                          int n, const float* valid) {
  constexpr int kRowVec = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kRowVec; idx += kThreads) {
    const int r = idx / kRowVec;
    const int c = (idx % kRowVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n && (valid == nullptr || valid[r] > 0.f))
      x = load4(src + static_cast<size_t>(row0 + r) * D + c);
    store4(dst + r * (D + 4) + c, x);
  }
}

// The per-row statistics of query rows [q0, q0 + kTile): the LSE clamped
// and in log2 units, and delta. Threads 0..kTile-1 write one row each.
__device__ __forceinline__ void load_row_stats(
    float* lse2, float* dlt, const float* __restrict__ lse,
    const float* __restrict__ delta, size_t bh_t, int q0, int t_len) {
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    const bool live = qi < t_len;
    lse2[threadIdx.x] = live ? fmaxf(lse[bh_t + qi], kLseFloor) * kLog2e : 0.f;
    dlt[threadIdx.x] = live ? delta[bh_t + qi] : 0.f;
  }
}

// Phase 1 for the tile pair (query rows q0.., keys k0..): p and dS of all
// kTile x kTile pairs into ps / dss ([row][key], stride kPStride). Thread
// (r, part) takes query row r and keys part + kParts * j. A pair counts
// only if its row exists, its key is valid (kvalid: in range and not
// masked) and, under causal, the key is not above the diagonal; every
// other pair gets p = dS = 0.
template <int D, bool kWriteP>
__device__ void score_tile(const float* qs, const float* dos, const float* ks,
                           const float* vs, const float* lse2,
                           const float* dlt, const float* kvalid, int q0,
                           int k0, int t_len, int offset, int causal,
                           float scale, float scale_log2, float* ps,
                           float* dss) {
  const int r = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  float s[kKeysPerThread], dp[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) s[j] = dp[j] = 0.f;
  const float* qr = qs + r * (D + 4);
  const float* gr = dos + r * (D + 4);
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
    const float4 g4 = *reinterpret_cast<const float4*>(gr + d);
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int c = part + kParts * j;
      s[j] = dot4(q4, *reinterpret_cast<const float4*>(ks + c * (D + 4) + d),
                  s[j]);
      dp[j] = dot4(g4, *reinterpret_cast<const float4*>(vs + c * (D + 4) + d),
                   dp[j]);
    }
  }
  const int qi = q0 + r;
  const float lse_r = lse2[r];
  const float delta_r = dlt[r];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int c = part + kParts * j;
    const bool ok = qi < t_len && kvalid[c] > 0.f &&
                    (!causal || qi + offset >= k0 + c);
    const float p = ok ? exp2f(fmaf(s[j], scale_log2, -lse_r)) : 0.f;
    if (kWriteP) ps[r * kPStride + c] = p;
    dss[r * kPStride + c] = p * (dp[j] - delta_r) * scale;
  }
}

// Shared memory of either kernel: four [kTile][D+4] float tiles, the p and
// dS tiles, and three [kTile] vectors (LSE, delta, key validity).
template <int D>
constexpr size_t smem_bytes() {
  return (4 * kTile * (D + 4) + 2 * kTile * kPStride + 3 * kTile) *
         sizeof(float);
}

// q/dO [BH, T, D], k/v [BH, S, D], dk/dv [BH, S, D] contiguous; key_mask
// [B, S] float (nullptr = none); lse/delta [BH, T] float.
// Grid: x = batch*head, y = key tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ key_mask,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int t_len, int s_len,
                     float scale, int causal) {
  constexpr int kVec = D / (4 * kParts);  // float4 slices a thread owns
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * (D + 4);
  float* qs = vs + kTile * (D + 4);
  float* dos = qs + kTile * (D + 4);
  float* ps = dos + kTile * (D + 4);
  float* dss = ps + kTile * kPStride;
  float* lse2 = dss + kTile * kPStride;
  float* dlt = lse2 + kTile;
  float* kvalid = dlt + kTile;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int k0 = blockIdx.y * kTile;
  const int offset = s_len - t_len;  // bottom-right causal alignment
  const size_t bh_t = static_cast<size_t>(bh) * t_len;
  const size_t bh_s = static_cast<size_t>(bh) * s_len;

  bool key_ok = false;
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    key_ok = key < s_len &&
             (key_mask == nullptr ||
              key_mask[static_cast<size_t>(b) * s_len + key] > 0.f);
    kvalid[threadIdx.x] = key_ok ? 1.f : 0.f;
  }
  const bool any_key = __syncthreads_or(key_ok);

  // Phase 2 ownership: key c of the tile, dimensions {i*16 + part*4 + 0..3}.
  const int c = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  float4 dk_acc[kVec], dv_acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    dk_acc[i] = dv_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (any_key) {  // a tile of masked keys has dK = dV = 0 and reads nothing
    load_tile<T, D>(ks, k + bh_s * D, k0, s_len, kvalid);
    load_tile<T, D>(vs, v + bh_s * D, k0, s_len, kvalid);
    // Causal: query row i sees key k0 first when i + offset >= k0, so the
    // query tiles wholly above the diagonal are never loaded.
    const int q_begin =
        causal ? (max(0, k0 - offset) / kTile) * kTile : 0;
    const float scale_log2 = scale * kLog2e;
    for (int q0 = q_begin; q0 < t_len; q0 += kTile) {
      __syncthreads();  // the previous query tile is consumed
      load_tile<T, D>(qs, q + bh_t * D, q0, t_len, nullptr);
      load_tile<T, D>(dos, dout + bh_t * D, q0, t_len, nullptr);
      load_row_stats(lse2, dlt, lse, delta, bh_t, q0, t_len);
      __syncthreads();
      score_tile<D, true>(qs, dos, ks, vs, lse2, dlt, kvalid, q0, k0, t_len,
                          offset, causal, scale, scale_log2, ps, dss);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        const float p = ps[r * kPStride + c];
        const float ds = dss[r * kPStride + c];
        const float* gr = dos + r * (D + 4) + part * 4;
        const float* qr = qs + r * (D + 4) + part * 4;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          axpy4(p, *reinterpret_cast<const float4*>(gr + i * 16), dv_acc[i]);
          axpy4(ds, *reinterpret_cast<const float4*>(qr + i * 16), dk_acc[i]);
        }
      }
    }
  }

  const int key = k0 + c;
  if (key >= s_len) return;
  const size_t out = (bh_s + key) * D + part * 4;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    store4(dk + out + i * 16, dk_acc[i]);
    store4(dv + out + i * 16, dv_acc[i]);
  }
}

// Same layouts; dq [BH, T, D]. Grid: x = batch*head, y = query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const float* __restrict__ key_mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int t_len, int s_len, float scale,
                    int causal) {
  constexpr int kVec = D / (4 * kParts);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile * (D + 4);
  float* ks = dos + kTile * (D + 4);
  float* vs = ks + kTile * (D + 4);
  float* dss = vs + kTile * (D + 4);  // p is not needed for dQ
  float* lse2 = dss + 2 * kTile * kPStride;
  float* dlt = lse2 + kTile;
  float* kvalid = dlt + kTile;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int q0 = blockIdx.y * kTile;
  const int offset = s_len - t_len;
  const size_t bh_t = static_cast<size_t>(bh) * t_len;
  const size_t bh_s = static_cast<size_t>(bh) * s_len;

  load_tile<T, D>(qs, q + bh_t * D, q0, t_len, nullptr);
  load_tile<T, D>(dos, dout + bh_t * D, q0, t_len, nullptr);
  load_row_stats(lse2, dlt, lse, delta, bh_t, q0, t_len);

  // Causal: keys past the tile's last row are masked for every row.
  int k_end = s_len;
  if (causal)
    k_end = min(s_len, min(q0 + kTile, t_len) - 1 + offset + 1);

  // Phase 2 ownership: query row r of the tile, dimensions as in dK/dV.
  const int r = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  float4 dq_acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) dq_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float scale_log2 = scale * kLog2e;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    bool key_ok = false;
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      key_ok = key < k_end &&
               (key_mask == nullptr ||
                key_mask[static_cast<size_t>(b) * s_len + key] > 0.f);
      kvalid[threadIdx.x] = key_ok ? 1.f : 0.f;
    }
    // A tile whose keys are all masked adds nothing: skip it whole (the
    // decision is the same for every thread of the block).
    if (!__syncthreads_or(key_ok)) continue;
    load_tile<T, D>(ks, k + bh_s * D, k0, s_len, kvalid);
    load_tile<T, D>(vs, v + bh_s * D, k0, s_len, kvalid);
    __syncthreads();
    score_tile<D, false>(qs, dos, ks, vs, lse2, dlt, kvalid, q0, k0, t_len,
                         offset, causal, scale, scale_log2, nullptr, dss);
    __syncthreads();
    const float* dsr = dss + r * kPStride;
#pragma unroll 4
    for (int cc = 0; cc < kTile; ++cc) {
      const float ds = dsr[cc];
      const float* kr = ks + cc * (D + 4) + part * 4;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        axpy4(ds, *reinterpret_cast<const float4*>(kr + i * 16), dq_acc[i]);
    }
  }

  const int qi = q0 + r;
  if (qi >= t_len) return;
  const size_t out = (bh_t + qi) * D + part * 4;
#pragma unroll
  for (int i = 0; i < kVec; ++i) store4(dq + out + i * 16, dq_acc[i]);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* key_mask;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;  // dK (dkv) or dQ (dq)
  void* out1;  // dV (dkv); unused by dq
  int batch, heads, t_len, s_len;
  float scale;
  int causal;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  if (smem > 48 * 1024) {
    // Above 48 KB a block's shared memory must be opted into.
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.batch * a.heads, (a.s_len + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.key_mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.heads, a.t_len, a.s_len, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.batch * a.heads, (a.t_len + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.key_mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.out0), a.heads, a.t_len, a.s_len,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kDkv, typename T>
cudaError_t launch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 32:
      return kDkv ? launch_dkv<T, 32>(a, stream) : launch_dq<T, 32>(a, stream);
    case 64:
      return kDkv ? launch_dkv<T, 64>(a, stream) : launch_dq<T, 64>(a, stream);
    case 128:
      return kDkv ? launch_dkv<T, 128>(a, stream)
                  : launch_dq<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// -- bfloat16: the products on the tensor cores (wgmma) -----------------------

namespace wg {

// The LSE and delta of query rows [0, kRows) of a tile (row 0 at lse /
// delta) into lse_dst[kRows], dlt_dst[kRows]; rows at or past ``rows``
// read as 0 (and are masked).
__device__ __forceinline__ void load_stats(float* lse_dst, float* dlt_dst,
                                           const float* lse,
                                           const float* delta, int rows) {
  const int r = threadIdx.x % kRows;
  const bool ok = r < rows;
  if (threadIdx.x < kRows)
    cp_async4(smem_addr(lse_dst + r), ok ? lse + r : lse, ok);
  else
    cp_async4(smem_addr(dlt_dst + r), ok ? delta + r : delta, ok);
}

// Shared memory of either kernel: six tiles on 1024-byte boundaries, up
// to 1280 bytes of row statistics and key flags, and the slack that
// aligns them.
template <int D>
constexpr size_t smem_bytes() {
  return 6 * Tile<D>::kBytes + 1280 + 1024;
}

// q/dO [BH, T, D], k/v [BH, S, D], dk/dv [BH, S, D] contiguous bf16;
// key_mask [B, S] float (nullptr = none); lse/delta [BH, T] float.
// Grid: x = batch*head, y = 64-key tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ key_mask,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int heads,
                           int t_len, int s_len, float scale, int causal) {
  using L = Tile<D>;
  constexpr int kNB = L::kNB, kAcc = L::kN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t ks = smem_addr(smem), vs = ks + L::kBytes;
  const uint32_t qs0 = vs + L::kBytes;  // stage st: Q at qs0 + 2 st kBytes,
                                        // dO one tile after it
  float* stats = reinterpret_cast<float*>(smem + 6 * L::kBytes);  // [2][2][64]
  float* kvalid = stats + 4 * kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / heads, k0 = blockIdx.y * kRows;
  const int offset = s_len - t_len;  // bottom-right causal alignment
  const size_t bh_t = static_cast<size_t>(bh) * t_len;
  const size_t bh_s = static_cast<size_t>(bh) * s_len;

  bool key_ok = false;
  if (tid < kRows) {
    const int key = k0 + tid;
    key_ok = key < s_len &&
             (key_mask == nullptr ||
              key_mask[static_cast<size_t>(b) * s_len + key] > 0.f);
    kvalid[tid] = key_ok ? 1.f : 0.f;
  }
  const bool any_key = __syncthreads_or(key_ok);

  // Accumulator rows (keys of the tile) row0 and row0 + 8, columns
  // col0 + 8j (+1).
  const int row0 = warp * 16 + lane / 4, col0 = (lane % 4) * 2;
  float dk_acc[kNB][kAcc], dv_acc[kNB][kAcc];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;

  if (any_key) {  // a tile of masked keys has dK = dV = 0 and reads nothing
    load_tile<D>(ks, k + (bh_s + k0) * D, s_len - k0, kvalid);
    load_tile<D>(vs, v + (bh_s + k0) * D, s_len - k0, kvalid);
    cp_async_commit();
    auto load_q = [&](int q0, int st) {
      const uint32_t qs = qs0 + 2 * st * L::kBytes;
      load_tile<D>(qs, q + (bh_t + q0) * D, t_len - q0, nullptr);
      load_tile<D>(qs + L::kBytes, dout + (bh_t + q0) * D, t_len - q0,
                   nullptr);
      load_stats(stats + 2 * st * kRows, stats + (2 * st + 1) * kRows,
                 lse + bh_t + q0, delta + bh_t + q0, t_len - q0);
    };
    // Causal: query row i sees key k0 first when i + offset >= k0, so the
    // query tiles wholly above the diagonal are never loaded.
    const int q_begin = causal ? (max(0, k0 - offset) / kRows) * kRows : 0;
    if (q_begin < t_len) load_q(q_begin, 0);
    cp_async_commit();
    const bool kv0 = kvalid[row0] > 0.f, kv1 = kvalid[row0 + 8] > 0.f;
    const float scale_log2 = scale * kLog2e;
    int st = 0;
    for (int q0 = q_begin; q0 < t_len; q0 += kRows, st ^= 1) {
      if (q0 + kRows < t_len) load_q(q0 + kRows, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // K/V and this query tile have landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t qs = qs0 + 2 * st * L::kBytes, dos = qs + L::kBytes;

      // S^T = K Q^T and dP^T = V dO^T: [key][query]
      float sacc[32], dpacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < D / 16; ++s)
        wgmma_ss_n64(sacc, desc_k<D>(ks, s), desc_k<D>(qs, s), s > 0);
#pragma unroll
      for (int s = 0; s < D / 16; ++s)
        wgmma_ss_n64(dpacc, desc_k<D>(vs, s), desc_k<D>(dos, s), s > 0);
      wgmma_commit_and_wait();
      fence_regs(sacc);
      fence_regs(dpacc);

      // P^T and dS^T in place, masked pairs exactly 0
      const float* lse_t = stats + 2 * st * kRows;
      const float* dlt_t = lse_t + kRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + col0;  // query columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int qi = q0 + c + (e & 1);
          const int key = k0 + row0 + 8 * (e >> 1);
          const bool ok = ((e >> 1) ? kv1 : kv0) && qi < t_len &&
                          (!causal || qi + offset >= key);
          const float lse2 = fmaxf((e & 1) ? l2.y : l2.x, kLseFloor) * kLog2e;
          const float p =
              ok ? exp2f(fmaf(sacc[i], scale_log2, -lse2)) : 0.f;
          dpacc[i] = p * (dpacc[i] - ((e & 1) ? d2.y : d2.x)) * scale;
          sacc[i] = p;
        }
      }
      uint32_t pf[kSlices][4], dsf[kSlices][4];
      to_frags(sacc, pf);
      to_frags(dpacc, dsf);

      // dV += P^T dO, dK += dS^T Q, over the tile's 64 query rows
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSlices; ++s)
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          wgmma_rs(dv_acc[nb], pf[s], desc_mn<D>(dos, s, nb));
          wgmma_rs(dk_acc[nb], dsf[s], desc_mn<D>(qs, s, nb));
        }
      wgmma_commit_and_wait();
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        fence_regs(dv_acc[nb]);
        fence_regs(dk_acc[nb]);
      }
      __syncthreads();  // this stage is read: the next load may reuse it
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    store_acc<D>(dk + (bh_s + k0) * D, dk_acc[nb], nb, row0, col0,
                 s_len - k0);
    store_acc<D>(dv + (bh_s + k0) * D, dv_acc[nb], nb, row0, col0,
                 s_len - k0);
  }
}

// Same layouts; dq [BH, T, D]. Grid: x = batch*head, y = 64-query tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ key_mask,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int heads,
                          int t_len, int s_len, float scale, int causal) {
  using L = Tile<D>;
  constexpr int kNB = L::kNB, kAcc = L::kN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t qs = smem_addr(smem), dos = qs + L::kBytes;
  const uint32_t ks0 = dos + L::kBytes;  // stage st: K at ks0 + 2 st kBytes,
                                         // V one tile after it
  float* lse_q = reinterpret_cast<float*>(smem + 6 * L::kBytes);
  float* dlt_q = lse_q + kRows;
  float* kvalid = dlt_q + kRows;  // [2][kRows]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / heads, q0 = blockIdx.y * kRows;
  const int offset = s_len - t_len;
  const size_t bh_t = static_cast<size_t>(bh) * t_len;
  const size_t bh_s = static_cast<size_t>(bh) * s_len;

  load_tile<D>(qs, q + (bh_t + q0) * D, t_len - q0, nullptr);
  load_tile<D>(dos, dout + (bh_t + q0) * D, t_len - q0, nullptr);
  load_stats(lse_q, dlt_q, lse + bh_t + q0, delta + bh_t + q0, t_len - q0);
  cp_async_commit();

  // Causal: keys past the tile's last row are masked for every row.
  const int k_end =
      causal ? min(s_len, min(q0 + kRows, t_len) + offset) : s_len;
  // The first key tile at or after k_from with a key that is not masked
  // (k_end if none), its key flags written to valid[kRows]. The decision
  // is the same for every thread of the block.
  auto next_live = [&](int k_from, float* valid) {
    for (int kt = k_from; kt < k_end; kt += kRows) {
      bool ok = false;
      if (tid < kRows) {
        const int key = kt + tid;
        ok = key < k_end &&
             (key_mask == nullptr ||
              key_mask[static_cast<size_t>(b) * s_len + key] > 0.f);
        valid[tid] = ok ? 1.f : 0.f;
      }
      if (__syncthreads_or(ok)) return kt;
    }
    return k_end;
  };
  auto load_kv = [&](int kt, int st) {
    const uint32_t ks = ks0 + 2 * st * L::kBytes;
    const float* valid = kvalid + st * kRows;
    load_tile<D>(ks, k + (bh_s + kt) * D, s_len - kt, valid);
    load_tile<D>(ks + L::kBytes, v + (bh_s + kt) * D, s_len - kt, valid);
  };

  // Accumulator rows (queries of the tile) row0 and row0 + 8, columns
  // col0 + 8j (+1).
  const int row0 = warp * 16 + lane / 4, col0 = (lane % 4) * 2;
  float dq_acc[kNB][kAcc];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dq_acc[nb][i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  int k0 = next_live(0, kvalid);
  if (k0 < k_end) load_kv(k0, 0);
  cp_async_commit();
  for (int st = 0; k0 < k_end; st ^= 1) {
    const int k_next = next_live(k0 + kRows, kvalid + (st ^ 1) * kRows);
    if (k_next < k_end) load_kv(k_next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q/dO and this key tile have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t ks = ks0 + 2 * st * L::kBytes, vs = ks + L::kBytes;

    // S = Q K^T and dP = dO V^T: [query][key]
    float sacc[32], dpacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = dpacc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < D / 16; ++s)
      wgmma_ss_n64(sacc, desc_k<D>(qs, s), desc_k<D>(ks, s), s > 0);
#pragma unroll
    for (int s = 0; s < D / 16; ++s)
      wgmma_ss_n64(dpacc, desc_k<D>(dos, s), desc_k<D>(vs, s), s > 0);
    wgmma_commit_and_wait();
    fence_regs(sacc);
    fence_regs(dpacc);

    // dS in place, masked pairs exactly 0
    const float* valid = kvalid + st * kRows;
    float lse2[2], dlt[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      live[h] = q0 + r < t_len;
      lse2[h] = fmaxf(lse_q[r], kLseFloor) * kLog2e;
      dlt[h] = dlt_q[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + col0;  // key columns c, c + 1
      const float2 kv = *reinterpret_cast<const float2*>(valid + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, h = e >> 1;
        const int key = k0 + c + (e & 1);
        const bool ok = live[h] && ((e & 1) ? kv.y : kv.x) > 0.f &&
                        (!causal || q0 + row0 + 8 * h + offset >= key);
        const float p = ok ? exp2f(fmaf(sacc[i], scale_log2, -lse2[h])) : 0.f;
        dpacc[i] = p * (dpacc[i] - dlt[h]) * scale;
      }
    }
    uint32_t dsf[kSlices][4];
    to_frags(dpacc, dsf);

    // dQ += dS K, over the tile's 64 keys
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(dq_acc[nb], dsf[s], desc_mn<D>(ks, s, nb));
    wgmma_commit_and_wait();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(dq_acc[nb]);
    __syncthreads();  // this stage is read: the next load may reuse it
    k0 = k_next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
    store_acc<D>(dq + (bh_t + q0) * D, dq_acc[nb], nb, row0, col0,
                 t_len - q0);
}

template <bool kDkv, int D>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const int tiles = ((kDkv ? a.s_len : a.t_len) + kRows - 1) / kRows;
  const dim3 grid(a.batch * a.heads, tiles);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.dout);
  if constexpr (kDkv) {
    auto kernel = flash_bwd_dkv_kernel_wgmma<D>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(
        q, k, v, a.key_mask, g, a.lse, a.delta, static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.heads, a.t_len, a.s_len, a.scale,
        a.causal);
  } else {
    auto kernel = flash_bwd_dq_kernel_wgmma<D>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(
        q, k, v, a.key_mask, g, a.lse, a.delta, static_cast<bf16*>(a.out0),
        a.heads, a.t_len, a.s_len, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <bool kDkv>
cudaError_t launch(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_one<kDkv, 32>(a, stream);
    case 64:
      return launch_one<kDkv, 64>(a, stream);
    case 128:
      return launch_one<kDkv, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

template <bool kDkv>
int launch(int device, const Args& a, int d, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    e = launch_d<kDkv, float>(d, a, st);  // the CUDA cores
  else if (dtype == 1)
    e = wg::launch<kDkv>(d, a, st);  // the tensor cores
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launch (0 = launched). The caller checks shapes, types and alignment.
int dl4j_flash_bwd_dkv(int device, const void* q, const void* k,
                       const void* v, const void* key_mask, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int batch, int heads, int t_len, int s_len, int d,
                       float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(key_mask), dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, batch, heads, t_len,
               s_len, scale, causal};
  return launch<true>(device, a, d, dtype, stream);
}

int dl4j_flash_bwd_dq(int device, const void* q, const void* k,
                      const void* v, const void* key_mask, const void* dout,
                      const void* lse, const void* delta, void* dq, int batch,
                      int heads, int t_len, int s_len, int d, float scale,
                      int causal, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(key_mask), dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, batch, heads,
               t_len, s_len, scale, causal};
  return launch<false>(device, a, d, dtype, stream);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
