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
// What bounds it on the card: at the BERT-base training shape (B=32, H=12,
// T=S=128, D=64) with the first training batch's key lengths, the work
// over the query-key pairs the masks leave visible is 4*D per pair, 1.53
// GFLOP, and the bytes are o in full and q, k, v of the rows and keys the
// masks leave visible (49 MB in float32, 24.5 MB in bfloat16;
// chip_smoke.py _bound). On the tensor cores the bytes bound both dtypes:
// 0.0146 ms in float32 at 3.35 TB/s, against 9.3 us for three TF32 passes
// at 495 TFLOP/s (and 0.0228 ms for the operations on the CUDA cores at
// 67 TFLOP/s); 0.0073 ms in bfloat16. At the serving shape (B=8, with its
// key lengths) the bounds are 0.0027 ms (float32; 0.0031 on the CUDA
// cores) and 0.0014 ms (bfloat16), both bytes. Masked keys cost neither
// time: tiles of masked keys are never loaded.
//
// Both dtypes share one design: one block of 4 warps (128 threads) owns a
// 64-row query tile; grid (B*H, ceil(T/64)). Q is loaded once into shared
// memory; the 64-key K/V tiles stream through a two-stage cp.async ring,
// the next live tile's load in flight under this tile's products; the
// [T, S] tiles live only in registers. Rows past T, keys past S and
// masked keys are zero-filled by the copy (source size 0), a masked
// pair's p is set to 0 explicitly, tiles of masked keys and tiles past
// the causal diagonal are never loaded. Per tile: S = Q K^T, the masks
// and the online softmax on the accumulator registers (scores in log2
// units; a row's 64 scores are spread over the 4 threads of a quad, so
// its max takes two shuffles; each thread keeps a partial row sum,
// reduced across the quad once at the end), the running output rescaled
// by 2^(m_old - m_new), and O += P V with P fed straight from the score
// accumulators as the A operand. The epilogue scales O by
// 1 / max(row sum, 1e-30) and writes LSE = (m + log2 max(row sum,
// 1e-30)) ln 2.
//
// float32 (tf32::flash_fwd_kernel): every product on the tensor cores in
// 3xTF32 (mma.sync m16n8k8, TF32 operands, float32 accumulators), so that
// the result stays float32-grade. Each float32 operand x is split in
// registers into big (x rounded to TF32) and small (x - big); a product
// is small*big + big*small + big*big (mma_tf32.cuh, shared with
// flash_bwd.cu's float32 backward). Tiles are float32 [64][D + 4] in
// shared memory (ldmatrix for K, K-major; single loads for V, MN-major,
// conflict-free). Each warp owns 16 query rows, and Q's fragments are
// split once per block and kept in registers at D = 32 and 64; at
// D = 128 they would take 128 registers, so they are re-read from shared
// memory and split again per tile, and O += P V runs over half of D at a
// time. P enters as A straight from the accumulators (an m16n8
// accumulator holds columns 2t, 2t + 1, so V's rows are read in the same
// permuted k order). No long running sum: the score's cross terms are
// summed apart from big*big and added once per tile, and each tile's
// P V is summed in fresh registers and added to the rescaled O with one
// rounded float32 add. p = 2^x with ex2.approx.
//
// bfloat16 (wg::flash_fwd_kernel_wgmma): both products on wgmma
// (m64nNk16, bf16 operands, float32 accumulators); Q, K and V in wgmma's
// swizzled layout, S = Q K^T with A and B K-major in shared memory, P
// packed to bf16 from the accumulator as the register A operand of O +=
// P V (B = V, MN-major), the running output rescaled after the previous
// product has been waited for. Rounding as _flash_kernel does it: the
// unnormalised p rounded to bf16 into P V, the row sum from the float32
// p, float32 accumulation, O rounded once to bf16 at the store. The tile
// helpers are shared with flash_bwd.cu (wgmma_sm90.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

}  // namespace wg

// -- float32: the products on the tensor cores in 3xTF32 (mma.sync) ----------

namespace tf32 {

// Shared memory: the Q tile, two stages of K and V, two stages of key
// flags.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return (5 * Tile<D>::kFloats + 2 * kRows) * sizeof(float);
}

// q [BH, T, D], k/v [BH, S, D], o [BH, T, D] contiguous float32; key_mask
// [B, S] float (nullptr = none); lse [BH, T] float (nullptr = not wanted).
// Grid: x = batch*head, y = 64-query tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ key_mask, float* __restrict__ o,
                 float* __restrict__ lse, int heads, int t_len, int s_len,
                 float scale_log2, int causal) {
  constexpr int kF = Tile<D>::kFloats;
  constexpr int kNT = D / 8;       // n8 tiles of an output row, k8 steps of Q
  constexpr int kKT = kRows / 8;   // n8 tiles of a score row, k8 steps of P
  constexpr bool kQRegs = D <= 64;  // Q's fragments kept split in registers
  constexpr int kNG = kQRegs ? kNT : kNT / 2;  // output n8 tiles a pass
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks0 = qs + kF;  // stage st: K at ks0 + 2 st kF, V one tile after
  float* kvalid = ks0 + 4 * kF;  // [2][kRows]

  const int tid = threadIdx.x, warp = tid / 32;
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
    float* ks = ks0 + 2 * st * kF;
    const float* valid = kvalid + st * kRows;
    load_tile<D>(ks, k + (bh_s + kt) * D, s_len - kt, valid);
    load_tile<D>(ks + kF, v + (bh_s + kt) * D, s_len - kt, valid);
  };

  // The warp's queries r0..r0+15; accumulator rows (queries) row0 and
  // row0 + 8, columns 8n + col0 (+1). m: the rows' running max (log2
  // units); l: this thread's part of their running sums.
  const int r0 = warp * 16, row0 = r0 + lane_g(), col0 = 2 * lane_t();
  float o_acc[kNT][4];
  zero(o_acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int k0 = next_live(0, kvalid);
  if (k0 < k_end) load_kv(k0, 0);
  cp_async_commit();

  // Q's A fragments of the warp's rows, split once (D <= 64)
  Frag<4> qf[kQRegs ? kNT : 1];
  if constexpr (kQRegs) {
    cp_async_wait<1>();  // Q has landed
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kNT; ++c) qf[c] = frag_a<D>(qs, r0, 8 * c);
  }

  for (int st = 0; k0 < k_end; st ^= 1) {
    const int k_next = next_live(k0 + kRows, kvalid + (st ^ 1) * kRows);
    if (k_next < k_end) load_kv(k_next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this key tile have landed
    __syncthreads();
    const float* ks = ks0 + 2 * st * kF;
    const float* vs = ks + kF;
    const float* valid = kvalid + st * kRows;

    // S = Q K^T: [query][key], the tile's 64 keys
    float sacc[kKT][4], scor[kKT][4];
    zero(sacc);
    zero(scor);
#pragma unroll
    for (int c = 0; c < kNT; ++c) {
      Frag<4> qa;  // at D = 128 re-read and re-split per tile
      if constexpr (kQRegs)
        qa = qf[c];
      else
        qa = frag_a<D>(qs, r0, 8 * c);
#pragma unroll
      for (int n = 0; n < kKT; n += 2) {
        Frag<2> kb[2];
        frag_b_k2<D>(kb, ks, 8 * n, 8 * c);
        mma3(sacc[n], scor[n], qa, kb[0]);
        mma3(sacc[n + 1], scor[n + 1], qa, kb[1]);
      }
    }
    add_to(sacc, scor, 0);

    // Scores in log2 units, masked pairs flagged; the rows' new max over
    // the quad that holds them
    uint32_t ok_bits = 0;
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kKT; ++n) {
      const int c = 8 * n + col0;  // key columns c, c + 1
      const float2 kv = *reinterpret_cast<const float2*>(valid + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = k0 + c + (e & 1);
        const bool ok = ((e & 1) ? kv.y : kv.x) > 0.f &&
                        (!causal || q0 + row0 + 8 * h + offset >= key);
        sacc[n][e] *= scale_log2;
        ok_bits |= static_cast<uint32_t>(ok) << (4 * n + e);
        if (ok) m_new[h] = fmaxf(m_new[h], sacc[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      // m == m_new == kNegInf (no usable key yet) gives alpha = 1 on a
      // zero accumulator
      alpha[h] = ex2(m[h] - m_new[h]);
      l[h] *= alpha[h];
      m[h] = m_new[h];
    }
    // p in place; exactly 0 where masked, since 2^(kNegInf - kNegInf)
    // would be 1
#pragma unroll
    for (int n = 0; n < kKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        sacc[n][e] = ((ok_bits >> (4 * n + e)) & 1u)
                         ? ex2(sacc[n][e] - m_new[h])
                         : 0.f;
        l[h] += sacc[n][e];
      }

    // O = alpha O + P V: the tile's P V over its 64 keys summed in fresh
    // registers, then added
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_acc[n][i] *= alpha[i >> 1];
#pragma unroll
    for (int ng = 0; ng < kNT; ng += kNG) {
      float part[kNG][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        const Frag<4> pa = frag_acc(sacc[j]);
#pragma unroll
        for (int n = 0; n < kNG; ++n)
          mma3(part[n], pa, frag_b_mn<D>(vs, 8 * j, 8 * (ng + n)));
      }
      add_to(o_acc, part, ng);
    }
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
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[n][i] *= inv[i >> 1];
  store_acc<D>(o + (bh_t + q0) * D, o_acc, r0, t_len - q0, 1.f);
  if (lse != nullptr && lane_t() == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + row0 + 8 * h;
      if (qi < t_len)
        lse[bh_t + qi] = (m[h] + log2f(fmaxf(l[h], 1e-30f))) * kLn2;
    }
  }
}

}  // namespace tf32

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* key_mask;
  void* o;
  float* lse;
  int batch, heads, t_len, s_len;
  float scale;
  int causal;
};

// One dtype's kernel on grid (B*H, ceil(T/64)) with smem bytes of shared
// memory.
template <typename T, typename Kernel>
cudaError_t launch_one(Kernel kernel, size_t smem, const Args& a,
                       cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.batch * a.heads, (a.t_len + wg::kRows - 1) / wg::kRows);
  kernel<<<grid, wg::kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.key_mask, static_cast<T*>(a.o), a.lse,
      a.heads, a.t_len, a.s_len, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// dtype 0: float32 on the tensor cores in 3xTF32; 1: bfloat16 on wgmma.
template <int D>
cudaError_t launch_d(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0)
    return launch_one<float>(tf32::flash_fwd_kernel<D>,
                             tf32::fwd_smem_bytes<D>(), a, stream);
  if (dtype == 1)
    return launch_one<__nv_bfloat16>(wg::flash_fwd_kernel_wgmma<D>,
                                     wg::fwd_smem_bytes<D>(), a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (3xTF32 on the tensor cores), 1 = bfloat16 (wgmma).
// Returns the cudaError_t of the launch (0 = launched). The caller checks
// shapes, types and alignment first. No fallback: a head size or dtype
// without a kernel is refused.
int dl4j_flash_fwd(int device, const void* q, const void* k, const void* v,
                   const void* key_mask, void* o, void* lse, int batch,
                   int heads, int t_len, int s_len, int d, float scale,
                   int causal, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{q, k, v, static_cast<const float*>(key_mask), o,
               static_cast<float*>(lse), batch, heads, t_len, s_len, scale,
               causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      e = launch_d<32>(dtype, a, st);
      break;
    case 64:
      e = launch_d<64>(dtype, a, st);
      break;
    case 128:
      e = launch_d<128>(dtype, a, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
