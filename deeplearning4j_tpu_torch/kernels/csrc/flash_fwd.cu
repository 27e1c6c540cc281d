// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py:115 _flash_kernel,
// the Pallas TPU kernel launched by _flash_fwd (public flash_attention).
// It computes the same function, O = softmax(scale * Q K^T + masks) V, with
// the key-padding mask, the ragged key tail and the bottom-right-aligned
// causal mask (query i sees key j iff i + (S - T) >= j) applied inside the
// kernel, and optionally the row log-sum-exp for a backward pass ([B*H, T]
// float32, natural log, about -6.9e29 on fully-masked rows). Fully-masked
// rows give 0 (never NaN), as the Pallas kernel does. Each dtype has its
// own kernel.
//
// What bounds it on the card: at the BERT-base serving shape (B=8, H=12,
// T=S=128, D=64) with no key masked, the work is 4*B*H*T*S*D = 0.403 GFLOP
// and the bytes are q, k, v and o once each (12.6 MB in float32, 6.3 MB in
// bfloat16). In float32 the operations bound it (0.403e9 / 67e12 FLOP/s on
// the CUDA cores = 6.0 us against 3.8 us for the bytes); in bfloat16 the
// bytes do (1.9 us at 3.35 TB/s against 0.4 us on the bf16 tensor cores).
// Masked keys cost neither: with padding, both counts shrink to the
// query-key pairs, query rows and keys that the masks leave visible
// (chip_smoke.py _bound: 0.0014 ms at the serving shape with its key
// lengths; about 0.007 ms for the ~24 MB of the training shape, B=32, with
// the first training batch's key lengths).
//
// float32 (flash_fwd_kernel): on the CUDA cores. The [T, S] score matrix
// never reaches device memory. One thread block takes one (batch*head,
// 32-query-row) tile and walks the key/value sequence in 64-key tiles
// staged in shared memory, shared by the block's 32 rows, so q, k and v
// are read from device memory once per tile. Masked keys are never read,
// and a tile whose keys are all masked is skipped whole. The loop inside
// the block replaces the TPU grid's sequential innermost kv dimension.
// Four threads share one query row, each owning D/4 of its dimensions: a
// score is four partial dot products and two warp shuffles, and the
// running max, denominator and output accumulator stay in float32
// registers (online softmax, rescaled once per 16-key chunk). Causal key
// tiles entirely above the diagonal are never loaded.
//
// bfloat16 (flash_fwd_kernel_wgmma): both products on the tensor cores
// (wgmma m64nNk16, bf16 operands, float32 accumulators), so the bytes
// bound it. What the design does about them: q, k and v are read from
// device memory once per block and the [T, S] tiles live only in
// registers. One warpgroup (128 threads) owns a 64-row query tile; grid
// (B*H, ceil(T/64)). Q is loaded once into shared memory in wgmma's
// swizzled layout; the 64-key K/V tiles stream through a two-stage
// cp.async ring, the next live tile's load in flight under this tile's
// products. Per tile: S = Q K^T (A and B K-major in shared memory), the
// masks and the online softmax on the accumulator registers (scores in
// log2 units; a row's 64 scores are spread over the 4 threads of a quad,
// so its max takes two shuffles; each thread keeps a partial row sum,
// reduced across the quad once at the end), the running output rescaled
// after the previous product has been waited for, and O += P V with P
// packed to bf16 straight from the accumulator as the register A operand
// (B = V, MN-major). Rows past T, keys past S and masked keys are
// zero-filled by the copy (source size 0), a masked pair's p is set to 0
// explicitly, tiles of masked keys and tiles past the causal diagonal are
// never loaded. Rounding as _flash_kernel does it: the unnormalised p
// rounded to bf16 into P V, the row sum from the float32 p, float32
// accumulation, O scaled by 1 / max(row sum, 1e-30) and rounded once to
// bf16 at the store. The tile helpers are shared with flash_bwd.cu
// (wgmma_sm90.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kRowsPerBlock = 32;  // query rows per thread block
constexpr int kThreadsPerRow = 4;  // threads sharing one query row
constexpr int kThreads = kRowsPerBlock * kThreadsPerRow;  // 128
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr int kChunk = 16;         // keys scored per online-softmax rescale
constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockK % kChunk == 0, "a tile holds whole chunks");
static_assert(kChunk <= 32, "chunk validity fits one 32-bit mask");
static_assert(kBlockK <= kThreads, "one thread reads each key's mask");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// q [BH, T, D], k/v [BH, S, D], o [BH, T, D] contiguous; key_mask [B, S]
// float (nullptr = no mask); lse [BH, T] float (nullptr = not wanted).
// Grid: x = batch*head, y = query tile. Thread (row, part) owns the query
// row blockIdx.y*32 + row and its dimensions {i*16 + part*4 + c}.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_mask,
                 T* __restrict__ o, float* __restrict__ lse, int heads,
                 int t_len, int s_len, float scale_log2, int causal) {
  constexpr int kVec = D / (4 * kThreadsPerRow);  // float4 slices a thread owns
  constexpr int kRowVec = D / 4;                  // float4 slices in one row
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBlockK][D]
  float* vs = ks + kBlockK * D;                 // [kBlockK][D]
  float* kvalid = vs + kBlockK * D;             // [kBlockK] 1 = key usable

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int row = threadIdx.x / kThreadsPerRow;
  const int part = threadIdx.x % kThreadsPerRow;
  const int qi = blockIdx.y * kRowsPerBlock + row;
  const bool row_live = qi < t_len;
  const int offset = s_len - t_len;  // bottom-right causal alignment

  const T* kb = k + static_cast<size_t>(bh) * s_len * D;
  const T* vb = v + static_cast<size_t>(bh) * s_len * D;
  const size_t q_off = (static_cast<size_t>(bh) * t_len + qi) * D + part * 4;

  // The query slice, pre-scaled so scores come out in log2 units.
  float4 qr[kVec];
  float4 acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float4 x = row_live ? load4(q + q_off + i * 16) : make_float4(0, 0, 0, 0);
    qr[i] = make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2,
                        x.w * scale_log2);
    acc[i] = make_float4(0, 0, 0, 0);
  }
  float m = kNegInf;  // running max of the scores (log2 units)
  float l = 0.f;      // running softmax denominator

  // Causal: keys past the last row of this tile are masked for every row.
  int k_end = s_len;
  if (causal) {
    const int q_hi = min(static_cast<int>(blockIdx.y + 1) * kRowsPerBlock,
                         t_len) - 1 + offset;
    k_end = min(s_len, q_hi + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    bool key_ok = false;
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      key_ok = key < k_end;
      if (key_ok && key_mask != nullptr)
        key_ok = key_mask[static_cast<size_t>(b) * s_len + key] > 0.f;
      kvalid[threadIdx.x] = key_ok ? 1.f : 0.f;
    }
    // A tile whose keys are all masked adds nothing: skip it whole (the
    // decision is the same for every thread of the block).
    if (!__syncthreads_or(key_ok)) continue;
    for (int idx = threadIdx.x; idx < kBlockK * kRowVec; idx += kThreads) {
      const int r = idx / kRowVec;
      const int c = (idx % kRowVec) * 4;
      const int key = k0 + r;
      float4 kk = make_float4(0, 0, 0, 0);
      float4 vv = make_float4(0, 0, 0, 0);
      if (kvalid[r] > 0.f) {  // masked keys are never read
        kk = load4(kb + static_cast<size_t>(key) * D + c);
        vv = load4(vb + static_cast<size_t>(key) * D + c);
      }
      store4(ks + r * D + c, kk);
      store4(vs + r * D + c, vv);
    }
    __syncthreads();

    const int n_keys = min(kBlockK, k_end - k0);
    for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
      float s[kChunk];
      uint32_t ok_bits = 0;
      float chunk_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (c0 + j) * D + part * 4;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + i * 16);
          dot = fmaf(qr[i].x, kk.x, dot);
          dot = fmaf(qr[i].y, kk.y, dot);
          dot = fmaf(qr[i].z, kk.z, dot);
          dot = fmaf(qr[i].w, kk.w, dot);
        }
        // The four threads of a row hold partial sums over their dims.
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int key = k0 + c0 + j;
        const bool ok = (c0 + j < n_keys) && kvalid[c0 + j] > 0.f &&
                        (!causal || qi + offset >= key);
        s[j] = ok ? dot : kNegInf;
        ok_bits |= static_cast<uint32_t>(ok) << j;
        chunk_max = fmaxf(chunk_max, s[j]);
      }
      const float m_new = fmaxf(m, chunk_max);
      // m == m_new == kNegInf (nothing usable yet) gives alpha = 1 on a
      // zero accumulator; masked keys are zeroed explicitly below, since
      // exp2(kNegInf - kNegInf) would be 1.
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = ((ok_bits >> j) & 1u) ? exp2f(s[j] - m_new) : 0.f;
        l += p;
        const float* vr = vs + (c0 + j) * D + part * 4;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + i * 16);
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
      m = m_new;
    }
  }

  if (!row_live) return;
  // Fully-masked row: l == 0 and acc == 0, so the output is 0.
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + q_off;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    store4(orow + i * 16, make_float4(acc[i].x * inv, acc[i].y * inv,
                                      acc[i].z * inv, acc[i].w * inv));
  if (lse != nullptr && part == 0)
    lse[static_cast<size_t>(bh) * t_len + qi] =
        (m + log2f(fmaxf(l, 1e-30f))) * kLn2;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* key_mask, void* o, float* lse, int batch,
                   int heads, int t_len, int s_len, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = (2 * kBlockK * D + kBlockK) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    // Above 48 KB a block's shared memory must be opted into.
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(batch * heads, (t_len + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_mask, static_cast<T*>(o), lse, heads,
      t_len, s_len, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const float* key_mask, void* o, float* lse, int batch,
                     int heads, int t_len, int s_len, float scale, int causal,
                     cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, key_mask, o, lse, batch, heads, t_len,
                           s_len, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, key_mask, o, lse, batch, heads, t_len,
                           s_len, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, key_mask, o, lse, batch, heads, t_len,
                            s_len, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// -- bfloat16: the products on the tensor cores (wgmma) -----------------------

namespace wg {

// Shared memory: the Q tile and two stages of K and V, on 1024-byte
// boundaries, two stages of key flags, and the slack that aligns them.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return 5 * Tile<D>::kBytes + 2 * kRows * sizeof(float) + 1024;
}

// q [BH, T, D], k/v [BH, S, D], o [BH, T, D] contiguous bf16; key_mask
// [B, S] float (nullptr = none); lse [BH, T] float (nullptr = not wanted).
// Grid: x = batch*head, y = 64-query tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ key_mask,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int heads, int t_len, int s_len, float scale_log2,
                       int causal) {
  using L = Tile<D>;
  constexpr int kNB = L::kNB, kAcc = L::kN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t qs = smem_addr(smem);
  const uint32_t ks0 = qs + L::kBytes;  // stage st: K at ks0 + 2 st kBytes,
                                        // V one tile after it
  float* kvalid = reinterpret_cast<float*>(smem + 5 * L::kBytes);  // [2][64]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / heads, q0 = blockIdx.y * kRows;
  const int offset = s_len - t_len;  // bottom-right causal alignment
  const size_t bh_t = static_cast<size_t>(bh) * t_len;
  const size_t bh_s = static_cast<size_t>(bh) * s_len;

  load_tile<D>(qs, q + (bh_t + q0) * D, t_len - q0, nullptr);
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
  // col0 + 8j (+1). m: the rows' running max (log2 units); l: this
  // thread's part of their running sums (its 16 of each tile's 64 keys).
  const int row0 = warp * 16 + lane / 4, col0 = (lane % 4) * 2;
  float o_acc[kNB][kAcc];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o_acc[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int k0 = next_live(0, kvalid);
  if (k0 < k_end) load_kv(k0, 0);
  cp_async_commit();
  for (int st = 0; k0 < k_end; st ^= 1) {
    const int k_next = next_live(k0 + kRows, kvalid + (st ^ 1) * kRows);
    if (k_next < k_end) load_kv(k_next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this key tile have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t ks = ks0 + 2 * st * L::kBytes, vs = ks + L::kBytes;

    // S = Q K^T: [query][key]
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < D / 16; ++s)
      wgmma_ss_n64(sacc, desc_k<D>(qs, s), desc_k<D>(ks, s), s > 0);
    wgmma_commit_and_wait();
    fence_regs(sacc);

    // Scores in log2 units, masked pairs flagged; the rows' new max over
    // the quad that holds them.
    const float* valid = kvalid + st * kRows;
    uint32_t ok_bits = 0;
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + col0;  // key columns c, c + 1
      const float2 kv = *reinterpret_cast<const float2*>(valid + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, h = e >> 1;
        const int key = k0 + c + (e & 1);
        const bool ok = ((e & 1) ? kv.y : kv.x) > 0.f &&
                        (!causal || q0 + row0 + 8 * h + offset >= key);
        sacc[i] *= scale_log2;
        ok_bits |= static_cast<uint32_t>(ok) << i;
        if (ok) m_new[h] = fmaxf(m_new[h], sacc[i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      // m == m_new == kNegInf (no usable key yet) gives alpha = 1 on a
      // zero accumulator
      alpha[h] = exp2f(m[h] - m_new[h]);
      l[h] *= alpha[h];
      m[h] = m_new[h];
    }
    // p in place; exactly 0 where masked, since exp2(kNegInf - kNegInf)
    // would be 1. The row sums take the float32 p.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sacc[i] = ((ok_bits >> i) & 1u) ? exp2f(sacc[i] - m_new[h]) : 0.f;
      l[h] += sacc[i];
    }
    uint32_t pf[kSlices][4];
    to_frags(sacc, pf);  // the unnormalised p, rounded to bf16

    // The previous tile's O += P V was waited for: rescale, then add
    // this tile's, over its 64 keys
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) o_acc[nb][i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(o_acc[nb], pf[s], desc_mn<D>(vs, s, nb));
    wgmma_commit_and_wait();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(o_acc[nb]);
    __syncthreads();  // this stage is read: the next load may reuse it
    k0 = k_next;
  }
  cp_async_wait<0>();

  // The row sums over the quad; a fully-masked row has l == 0 and o == 0,
  // so its output is 0.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o_acc[nb][i] *= inv[(i >> 1) & 1];
    store_acc<D>(o + (bh_t + q0) * D, o_acc[nb], nb, row0, col0,
                 t_len - q0);
  }
  if (lse != nullptr && col0 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + row0 + 8 * h;
      if (qi < t_len)
        lse[bh_t + qi] = (m[h] + log2f(fmaxf(l[h], 1e-30f))) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch_one(const void* q, const void* k, const void* v,
                       const float* key_mask, void* o, float* lse, int batch,
                       int heads, int t_len, int s_len, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  using bf16 = __nv_bfloat16;
  auto kernel = flash_fwd_kernel_wgmma<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * heads, (t_len + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), key_mask, static_cast<bf16*>(o), lse,
      heads, t_len, s_len, scale * kLog2e, causal);
  return cudaGetLastError();
}

// No fallback: a head size without a kernel is refused, never sent to the
// float32 kernel.
cudaError_t launch(int d, const void* q, const void* k, const void* v,
                   const float* key_mask, void* o, float* lse, int batch,
                   int heads, int t_len, int s_len, float scale, int causal,
                   cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_one<32>(q, k, v, key_mask, o, lse, batch, heads, t_len,
                            s_len, scale, causal, stream);
    case 64:
      return launch_one<64>(q, k, v, key_mask, o, lse, batch, heads, t_len,
                            s_len, scale, causal, stream);
    case 128:
      return launch_one<128>(q, k, v, key_mask, o, lse, batch, heads, t_len,
                             s_len, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 = launched). The caller checks shapes, types and alignment first.
int dl4j_flash_fwd(int device, const void* q, const void* k, const void* v,
                   const void* key_mask, void* o, void* lse, int batch,
                   int heads, int t_len, int s_len, int d, float scale,
                   int causal, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* km = static_cast<const float*>(key_mask);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)  // the CUDA cores
    e = launch_d<float>(d, q, k, v, km, o, lse_f, batch, heads, t_len, s_len,
                        scale, causal, st);
  else if (dtype == 1)  // the tensor cores
    e = wg::launch(d, q, k, v, km, o, lse_f, batch, heads, t_len, s_len,
                   scale, causal, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
