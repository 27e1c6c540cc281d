// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py::_flash_kernel,
// the Pallas TPU kernel launched by _flash_fwd (public flash_attention).
// It computes the same function, O = softmax(scale * Q K^T + masks) V, with
// the key-padding mask, the ragged key tail and the bottom-right-aligned
// causal mask (query i sees key j iff i + (S - T) >= j) applied inside the
// kernel, and optionally the row log-sum-exp for a backward pass.
// Fully-masked rows give 0 (never NaN), as the Pallas kernel does.
//
// What bounds it on the card: at the BERT-base serving shape (B=8, H=12,
// T=S=128, D=64) with no key masked, the work is 4*B*H*T*S*D = 0.403 GFLOP
// and the bytes are q, k, v and o once each (12.6 MB in float32, 6.3 MB in
// bfloat16). In float32 the operations bound it (0.403e9 / 67e12 FLOP/s on
// the CUDA cores = 6.0 us against 3.8 us for the bytes); in bfloat16 the
// bytes do (1.9 us at 3.35 TB/s against 0.4 us on the bf16 tensor cores).
// Masked keys cost neither: with padding, both counts shrink to the
// query-key pairs, query rows and keys that the masks leave visible.
//
// What the design does about it: the [T, S] score matrix never reaches
// device memory. One thread block takes one (batch*head, 32-query-row)
// tile and walks the key/value sequence in 64-key tiles staged in shared
// memory (converted to float32 once, shared by the block's 32 rows), so
// q, k and v are read from device memory once per tile. Masked keys are
// never read, and a tile whose keys are all masked is skipped whole. The
// loop inside the block replaces the TPU grid's sequential innermost kv
// dimension.
// Four threads share one query row, each owning D/4 of its dimensions: a
// score is four partial dot products and two warp shuffles, and the
// running max, denominator and output accumulator stay in float32
// registers (online softmax, rescaled once per 16-key chunk). Causal key
// tiles entirely above the diagonal are never loaded. All arithmetic runs
// in float32 on the CUDA cores, also for bfloat16 inputs: simple and right
// first. The bf16 tensor-core path (wgmma fed by TMA) is later work, and
// until then bfloat16 runs at the float32 operation rate, well above its
// byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = raw.x;
  *reinterpret_cast<uint32_t*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
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
  if (dtype == 0)
    e = launch_d<float>(d, q, k, v, km, o, lse_f, batch, heads, t_len, s_len,
                        scale, causal, st);
  else if (dtype == 1)
    e = launch_d<__nv_bfloat16>(d, q, k, v, km, o, lse_f, batch, heads,
                                t_len, s_len, scale, causal, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
