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
// causal mask (query i sees key j iff i + (S - T) >= j). delta is the
// third kernel of this file, flash_bwd_delta (below), a pre-pass the
// wrapper launches first, where the JAX package sums it with XLA outside
// its kernels (_flash_bwd_impl, flash_attention.py:389). Two gradient
// kernels, as in the JAX package, so that every gradient
// element has exactly one writer: deterministic, no atomics. Masked and
// ragged keys get dK = dV = 0; fully masked query rows (whose LSE the
// forward writes as about -7e29) get dQ = 0, never NaN: every masked
// pair's probability is set to 0 explicitly, and the LSE is clamped at
// -1e20 as _bwd_recompute does. A key tile whose keys are all masked, and
// a tile pair wholly above the causal diagonal (_causal_block_live), does
// no work. Each dtype has its own pair of kernels.
//
// float32 (tf32::flash_bwd_dkv_kernel, tf32::flash_bwd_dq_kernel): every
// product on the tensor cores in 3xTF32 (mma.sync m16n8k8, TF32 operands,
// float32 accumulators). Per (batch, head) the work is 8*T*S*D operations
// for dK/dV (two score products and two accumulating products) and 6*T*S*D
// for dQ, over the visible query-key pairs: at the BERT-base training
// shape (B=32, H=12, T=S=128, D=64) unpadded 3.2 and 2.4 GFLOP, 48 and 36
// us at 67 TFLOP/s on the float32 CUDA cores. Three TF32 passes at 495
// TFLOP/s take 19 and 15 us, under the bytes of the float32 operands (22
// and 18 us at 3.35 TB/s, as chip_smoke.py counts them), so on the tensor
// cores the bytes bound both kernels; mma.sync reaches only part of that
// rate, and each value an MMA reads is first split in registers on the
// CUDA cores. What the design does about it:
// - Tiles and grid as in the bf16 kernels: one block of 4 warps owns a
//   64-key tile (dK/dV, grid (B*H, ceil(S/64))) or a 64-query tile (dQ,
//   grid (B*H, ceil(T/64))); each warp owns 16 of the 64 rows. The
//   streamed tiles (Q, dO, LSE and delta for dK/dV; K and V for dQ) go
//   through a two-stage cp.async ring, the next tile's copy in flight under
//   this tile's products; each operand tile is read from device memory
//   once per block, and the [T, S] tiles (S, dP, P, dS) live only in
//   registers.
// - Shared tiles are float32 [64][D + 4]. The score products read their
//   operands K-major with ldmatrix (four 8 x 4 float32 quarters a load;
//   rows 16 bytes apart in bank groups, conflict-free); the accumulating
//   products (dV += P^T dO, dK += dS^T Q, dQ += dS K) read B MN-major one
//   value at a time, a warp hitting 32 different banks (8t + g, g = lane
//   / 4, t = lane % 4). wgmma cannot read TF32 MN-major without a
//   transposed copy.
// - P^T and dS^T (dS for dQ) never leave registers: an m16n8 accumulator
//   holds columns (2t, 2t + 1) of its 8, the m16k8 A fragment wants
//   columns (t, t + 4); the accumulator is fed as A as it is, and the
//   matching B rows are read in the same permuted k order (rows 8j + 2t
//   and 8j + 2t + 1 in place of 8j + t and 8j + t + 4). A sum over k does
//   not depend on its order.
// - Precision: each float32 operand x is split in registers into big, x
//   rounded to TF32, and small = x - big (three integer and float
//   instructions; the tensor core reads small's top 11 bits), together
//   about 21 bits of x; a product is small*big + big*small + big*big (the
//   small*small term, 2^-22 of it, is dropped), as CUTLASS's
//   OpMultiplyAddFastF32 does it. The tensor cores' float32 sums lose up
//   to about an ulp of the running sum per instruction, so the error grew
//   with the number of instructions summed into one accumulator (on an
//   H100, with one running sum per gradient, T = 512 reached 8e-6 of max
//   |dK|). So every sum is kept short: the score products sum their
//   cross terms apart from big*big, and each chunk's contribution to dK,
//   dV and dQ is summed in fresh registers and added to the total with a
//   rounded float32 add. scale multiplies dK and dQ once, at the store;
//   p = 2^x with ex2.approx.
// - Chunks: dK/dV forms the scores of a 64-query tile in two chunks of 32
//   queries, dQ of a 64-key tile in one chunk (two of 32 at D = 128), so
//   that the gradient, score and partial-sum accumulators fit in
//   registers; at D = 128 the partial sums cover half of D at a time.
// The float32 tiles, fragments and products are shared with flash_fwd.cu
// (mma_tf32.cuh).
//
// bfloat16 (flash_bwd_dkv_kernel_wgmma, flash_bwd_dq_kernel_wgmma): every
// product on the tensor cores (wgmma m64nNk16, bf16 operands, float32
// accumulators). At the training shape the same 3.2 and 2.4 GFLOP take
// 3.3 and 2.5 us at 989 TFLOP/s, so the bytes bound them on paper: q, k,
// v, dO and the outputs once in bf16, the LSE and delta in float32
// (0.0112 and 0.0093 ms at 3.35 TB/s, as chip_smoke.py counts them).
// What holds them on the card is instruction issue on the CUDA cores: a
// 64 x 64 tile pair is 16 (dkv) or 12 (dq) wgmmas, about 512 tensor-core
// clocks, against some 32 pairs a thread of P/dS math. Overlapping the
// two products of a tile with the next tile's scores inside the
// warpgroup (the FlashAttention-3 order) gave the same bits but ran 3-5%
// slower on an H100 (PERF.md). So the design keeps that math short
// and the SM full:
// - p is computed for every pair and selected, no branch per pair; 2^x is
//   one ex2.approx.ftz; a tile pair inside the causal triangle and inside
//   T and S tests no position, only the flags of the thread's rows
//   (p_ds_keys / ds_queries with kMasked false);
// - dkv at D = 32 and 64 is held to 168 registers so that three blocks
//   share an SM (52 bytes spill at D = 64); at D = 128 it takes only the
//   masked path, one copy of the math (4 bytes spill);
// - each operand tile is read from device memory once per block and the
//   [T, S] tiles (S, dP, P, dS) live only in registers.
// - flash_bwd_dkv: one warpgroup (128 threads) owns a 64-key tile of one
//   (batch*head); grid (B*H, ceil(S/64)). K and V are loaded once; the
//   64-row query tiles (Q, dO, LSE, delta) stream through a two-stage
//   cp.async ring, the next tile's load in flight under this tile's
//   products. Causal: key tile y walks the query tiles from the diagonal
//   down, so the heaviest blocks (y = 0) start first. Per tile: S^T =
//   K Q^T and dP^T = V dO^T (A and B K-major in shared memory); P^T and
//   dS^T formed and masked in the accumulator registers, rounded to bf16
//   in place, and fed as the register A operand of dV += P^T dO and dK +=
//   dS^T Q (B = dO or Q, MN-major). A 64 x 64 float32 accumulator read as
//   four k16 slices has the layout of the A fragment, so no shuffle is
//   needed (the FlashAttention-3 arrangement).
// - flash_bwd_dq: one warpgroup owns a 64-row query tile; grid (B*H,
//   ceil(T/64)). Q, dO, LSE and delta are loaded once; the 64-key tiles
//   (K, V) stream through the ring, tiles of masked keys and tiles past
//   the causal diagonal skipped. Causal: blockIdx.y runs the query tiles
//   last to first, so the tiles that walk the most key tiles start first
//   and the grid's tail is light. Per tile: S = Q K^T, dP = dO V^T, dS in
//   registers as bf16, dQ += dS K (B = K, MN-major).
// Shared tiles sit in wgmma's swizzled layouts (128-byte swizzle for
// D = 64 and 128, 64-byte for D = 32, whose bf16 row is 64 bytes); rows
// past T or S and masked keys are zero-filled by the copy (source size 0),
// so no stale value ever meets a 0. Rounding as the JAX kernels do it: P
// and dS in bf16 into their products, float32 accumulation, each gradient
// rounded once to bf16 at the store. The tile helpers are shared with
// flash_fwd.cu (wgmma_sm90.cuh).
//
// flash_bwd_delta (both dtypes): delta[r] = sum_d float(O) * float(dO),
// float32, over the B*H*T rows. It moves O and dO once (12.6 MB in bf16
// at the BERT-base and GPT-2-small training shapes, 3.8 us at 3.35 TB/s)
// and does 2*D operations a row, so the bytes bound it. Each thread reads
// one 16-byte chunk of each, 4 to 32 neighbouring lanes cover a row
// (coalesced), the lanes sum with warp shuffles, and one lane writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr float kLseFloor = -1e20f;  // _bwd_recompute's clamp
constexpr float kLog2e = 1.4426950408889634f;

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

// The P/dS math, which bounds both kernels (see the top of the file).

// dkv: P^T and dS^T of the query tile at q0 in place (sacc, dpacc:
// [key][query]), masked pairs exactly 0. The thread's keys are key0 and
// key0 + 8 (flags kv0, kv1), its query columns q0 + col0 + 8j (+1).
template <bool kMasked>
__device__ __forceinline__ void p_ds_keys(float (&sacc)[32],
                                          float (&dpacc)[32],
                                          const float* lse_t,
                                          const float* dlt_t, int q0,
                                          int key0, bool kv0, bool kv1,
                                          int col0, int t_len, int offset,
                                          bool causal, float scale_log2,
                                          float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + col0;  // query columns c, c + 1
    const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + c);
    const float lse2[2] = {fmaxf(l2.x, kLseFloor) * kLog2e,
                           fmaxf(l2.y, kLseFloor) * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      bool ok = (e >> 1) ? kv1 : kv0;
      if (kMasked) {
        const int qi = q0 + c + (e & 1);
        ok = ok & (qi < t_len) &
             (!causal | (qi + offset >= key0 + 8 * (e >> 1)));
      }
      const float p =
          ok ? tf32::ex2(fmaf(sacc[i], scale_log2, -lse2[e & 1])) : 0.f;
      dpacc[i] = p * (dpacc[i] - ((e & 1) ? d2.y : d2.x)) * scale;
      sacc[i] = p;
    }
  }
}

// dq: dS of the key tile at k0 in place (sacc, dpacc: [query][key]),
// masked pairs exactly 0. The thread's query rows are qrow0 and qrow0 + 8
// (live, lse2, dlt), its key columns k0 + col0 + 8j (+1), their flags in
// valid.
template <bool kMasked>
__device__ __forceinline__ void ds_queries(const float (&sacc)[32],
                                           float (&dpacc)[32],
                                           const float* valid, int k0,
                                           int qrow0, const bool (&live)[2],
                                           const float (&lse2)[2],
                                           const float (&dlt)[2], int col0,
                                           int offset, bool causal,
                                           float scale_log2, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + col0;  // key columns c, c + 1
    float2 kv = make_float2(1.f, 1.f);
    if (kMasked) kv = *reinterpret_cast<const float2*>(valid + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, h = e >> 1;
      bool ok = live[h];
      if (kMasked) {
        const int key = k0 + c + (e & 1);
        ok = ok & (((e & 1) ? kv.y : kv.x) > 0.f) &
             (!causal | (qrow0 + 8 * h + offset >= key));
      }
      const float p =
          ok ? tf32::ex2(fmaf(sacc[i], scale_log2, -lse2[h])) : 0.f;
      dpacc[i] = p * (dpacc[i] - dlt[h]) * scale;
    }
  }
}

// q/dO [BH, T, D], k/v [BH, S, D], dk/dv [BH, S, D] contiguous bf16;
// key_mask [B, S] float (nullptr = none); lse/delta [BH, T] float.
// Grid: x = batch*head, y = 64-key tile.
// Three blocks an SM at D <= 64 (168 registers).
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 3)
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
      // at D = 128 one copy of the math keeps the spills down
      if (D < 128 && q0 + kRows <= t_len &&
          (!causal || q0 + offset >= k0 + kRows - 1))
        p_ds_keys<false>(sacc, dpacc, lse_t, dlt_t, q0, k0 + row0, kv0, kv1,
                         col0, t_len, offset, causal, scale_log2, scale);
      else
        p_ds_keys<true>(sacc, dpacc, lse_t, dlt_t, q0, k0 + row0, kv0, kv1,
                        col0, t_len, offset, causal, scale_log2, scale);
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
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.x, b = bh / heads, q0 = tile * kRows;
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
  // (k_end if none), its key flags written to valid[kRows] and whether
  // all 64 are live to all_live. The decision is the same for every
  // thread of the block.
  auto next_live = [&](int k_from, float* valid, bool& all_live) {
    for (int kt = k_from; kt < k_end; kt += kRows) {
      bool ok = false;
      if (tid < kRows) {
        const int key = kt + tid;
        ok = key < k_end &&
             (key_mask == nullptr ||
              key_mask[static_cast<size_t>(b) * s_len + key] > 0.f);
        valid[tid] = ok ? 1.f : 0.f;
      }
      const int live_keys = __syncthreads_count(ok);
      if (live_keys > 0) {
        all_live = live_keys == kRows;
        return kt;
      }
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

  bool all_live = false, next_all_live = false;
  int k0 = next_live(0, kvalid, all_live);
  if (k0 < k_end) load_kv(k0, 0);
  cp_async_commit();
  for (int st = 0; k0 < k_end; st ^= 1) {
    const int k_next =
        next_live(k0 + kRows, kvalid + (st ^ 1) * kRows, next_all_live);
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
    if (all_live && (!causal || q0 + offset >= k0 + kRows - 1))
      ds_queries<false>(sacc, dpacc, valid, k0, q0 + row0, live, lse2, dlt,
                        col0, offset, causal, scale_log2, scale);
    else
      ds_queries<true>(sacc, dpacc, valid, k0, q0 + row0, live, lse2, dlt,
                       col0, offset, causal, scale_log2, scale);
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
    all_live = next_all_live;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
    store_acc<D>(dq + (bh_t + q0) * D, dq_acc[nb], nb, row0, col0,
                 t_len - q0);
}

}  // namespace wg

// -- float32: the products on the tensor cores in 3xTF32 (mma.sync) ----------

namespace tf32 {

using wg::load_stats;

// Shared memory of either kernel: six tiles and up to five [kRows] vectors
// of row statistics and key flags.
template <int D>
constexpr size_t smem_bytes() {
  return (6 * Tile<D>::kFloats + 5 * kRows) * sizeof(float);
}

// q/dO [BH, T, D], k/v [BH, S, D], dk/dv [BH, S, D] contiguous float32;
// key_mask [B, S] float (nullptr = none); lse/delta [BH, T] float.
// Grid: x = batch*head, y = 64-key tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ key_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int t_len, int s_len,
                     float scale, int causal) {
  constexpr int kF = Tile<D>::kFloats;
  constexpr int kNT = D / 8;  // n8 tiles of a gradient row
  constexpr int kQC = 32;     // queries per chunk
  // gradient n8 tiles summed per pass over a chunk
  constexpr int kNG = D >= 128 ? kNT / 2 : kNT;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kF;
  float* qs0 = vs + kF;  // stage st: Q at qs0 + 2 st kF, dO one tile after
  float* stats = qs0 + 4 * kF;  // [2 stages][LSE, delta][kRows]
  float* kvalid = stats + 4 * kRows;

  const int tid = threadIdx.x, warp = tid / 32;
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

  // The warp's keys r0..r0+15; accumulator rows (keys) row0 and row0 + 8,
  // columns 8n + col0 (+1).
  const int r0 = warp * 16, row0 = r0 + lane_g(), col0 = 2 * lane_t();
  float dk_acc[kNT][4], dv_acc[kNT][4];
  zero(dk_acc);
  zero(dv_acc);

  if (any_key) {  // a tile of masked keys has dK = dV = 0 and reads nothing
    load_tile<D>(ks, k + (bh_s + k0) * D, s_len - k0, kvalid);
    load_tile<D>(vs, v + (bh_s + k0) * D, s_len - k0, kvalid);
    cp_async_commit();
    auto load_q = [&](int q0, int st) {
      float* qs = qs0 + 2 * st * kF;
      load_tile<D>(qs, q + (bh_t + q0) * D, t_len - q0, nullptr);
      load_tile<D>(qs + kF, dout + (bh_t + q0) * D, t_len - q0, nullptr);
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
      __syncthreads();
      const float* qs = qs0 + 2 * st * kF;
      const float* dos = qs + kF;
      const float* lse_t = stats + 2 * st * kRows;
      const float* dlt_t = lse_t + kRows;
#pragma unroll 1
      for (int qc = 0; qc < kRows; qc += kQC) {
        // S^T = K Q^T and dP^T = V dO^T: [key][query], kQC queries
        float sacc[kQC / 8][4], dpacc[kQC / 8][4];
        float scor[kQC / 8][4], dpcor[kQC / 8][4];
        zero(sacc);
        zero(dpacc);
        zero(scor);
        zero(dpcor);
#pragma unroll
        for (int c = 0; c < D; c += 8) {
          const Frag<4> ka = frag_a<D>(ks, r0, c), va = frag_a<D>(vs, r0, c);
#pragma unroll
          for (int n = 0; n < kQC / 8; n += 2) {
            Frag<2> qb[2], gb[2];
            frag_b_k2<D>(qb, qs, qc + 8 * n, c);
            frag_b_k2<D>(gb, dos, qc + 8 * n, c);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma3(sacc[n + i], scor[n + i], ka, qb[i]);
              mma3(dpacc[n + i], dpcor[n + i], va, gb[i]);
            }
          }
        }
        add_to(sacc, scor, 0);
        add_to(dpacc, dpcor, 0);

        // P^T and dS^T / scale in place, masked pairs exactly 0
#pragma unroll
        for (int n = 0; n < kQC / 8; ++n) {
          const int c = qc + 8 * n + col0;  // query columns c, c + 1
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
          const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + c + (e & 1);
            const int key = k0 + row0 + 8 * (e >> 1);
            const bool ok = ((e >> 1) ? kv1 : kv0) && qi < t_len &&
                            (!causal || qi + offset >= key);
            const float lse2 =
                fmaxf((e & 1) ? l2.y : l2.x, kLseFloor) * kLog2e;
            const float p =
                ok ? ex2(fmaf(sacc[n][e], scale_log2, -lse2)) : 0.f;
            dpacc[n][e] = p * (dpacc[n][e] - ((e & 1) ? d2.y : d2.x));
            sacc[n][e] = p;
          }
        }

        // dV += P^T dO, dK += dS^T Q over the chunk's queries, summed in
        // fresh registers and added to the totals
#pragma unroll
        for (int ng = 0; ng < kNT; ng += kNG) {
          float dv_part[kNG][4], dk_part[kNG][4];
          zero(dv_part);
          zero(dk_part);
#pragma unroll
          for (int j = 0; j < kQC / 8; ++j) {
            const Frag<4> pa = frag_acc(sacc[j]), dsa = frag_acc(dpacc[j]);
#pragma unroll
            for (int n = 0; n < kNG; ++n) {
              const int col = 8 * (ng + n);
              mma3(dv_part[n], pa, frag_b_mn<D>(dos, qc + 8 * j, col));
              mma3(dk_part[n], dsa, frag_b_mn<D>(qs, qc + 8 * j, col));
            }
          }
          add_to(dv_acc, dv_part, ng);
          add_to(dk_acc, dk_part, ng);
        }
      }
      __syncthreads();  // this stage is read: the next load may reuse it
    }
  }
  cp_async_wait<0>();

  store_acc<D>(dk + (bh_s + k0) * D, dk_acc, r0, s_len - k0, scale);
  store_acc<D>(dv + (bh_s + k0) * D, dv_acc, r0, s_len - k0, 1.f);
}

// Same layouts; dq [BH, T, D]. Grid: x = batch*head, y = 64-query tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ key_mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int t_len, int s_len, float scale,
                    int causal) {
  constexpr int kF = Tile<D>::kFloats;
  constexpr int kNT = D / 8;
  constexpr int kKC = D >= 128 ? 32 : 64;  // keys per chunk
  constexpr int kNG = D >= 128 ? kNT / 2 : kNT;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kF;
  float* ks0 = dos + kF;  // stage st: K at ks0 + 2 st kF, V one tile after
  float* lse_q = ks0 + 4 * kF;
  float* dlt_q = lse_q + kRows;
  float* kvalid = dlt_q + kRows;  // [2][kRows]

  const int tid = threadIdx.x, warp = tid / 32;
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
    float* ks = ks0 + 2 * st * kF;
    const float* valid = kvalid + st * kRows;
    load_tile<D>(ks, k + (bh_s + kt) * D, s_len - kt, valid);
    load_tile<D>(ks + kF, v + (bh_s + kt) * D, s_len - kt, valid);
  };

  // The warp's queries r0..r0+15; accumulator rows (queries) row0 and
  // row0 + 8, columns 8n + col0 (+1).
  const int r0 = warp * 16, row0 = r0 + lane_g(), col0 = 2 * lane_t();
  float dq_acc[kNT][4];
  zero(dq_acc);
  const float scale_log2 = scale * kLog2e;

  int k0 = next_live(0, kvalid);
  if (k0 < k_end) load_kv(k0, 0);
  cp_async_commit();
  for (int st = 0; k0 < k_end; st ^= 1) {
    const int k_next = next_live(k0 + kRows, kvalid + (st ^ 1) * kRows);
    if (k_next < k_end) load_kv(k_next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q/dO and this key tile have landed
    __syncthreads();
    const float* ks = ks0 + 2 * st * kF;
    const float* vs = ks + kF;

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
#pragma unroll 1
    for (int kc = 0; kc < kRows; kc += kKC) {
      // S = Q K^T and dP = dO V^T: [query][key], kKC keys
      float sacc[kKC / 8][4], dpacc[kKC / 8][4];
      float scor[kKC / 8][4], dpcor[kKC / 8][4];
      zero(sacc);
      zero(dpacc);
      zero(scor);
      zero(dpcor);
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        const Frag<4> qa = frag_a<D>(qs, r0, c), ga = frag_a<D>(dos, r0, c);
#pragma unroll
        for (int n = 0; n < kKC / 8; n += 2) {
          Frag<2> kb[2], vb[2];
          frag_b_k2<D>(kb, ks, kc + 8 * n, c);
          frag_b_k2<D>(vb, vs, kc + 8 * n, c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma3(sacc[n + i], scor[n + i], qa, kb[i]);
            mma3(dpacc[n + i], dpcor[n + i], ga, vb[i]);
          }
        }
      }
      add_to(sacc, scor, 0);
      add_to(dpacc, dpcor, 0);

      // dS / scale in place, masked pairs exactly 0
#pragma unroll
      for (int n = 0; n < kKC / 8; ++n) {
        const int c = kc + 8 * n + col0;  // key columns c, c + 1
        const float2 kv = *reinterpret_cast<const float2*>(valid + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = k0 + c + (e & 1);
          const bool ok = live[h] && ((e & 1) ? kv.y : kv.x) > 0.f &&
                          (!causal || q0 + row0 + 8 * h + offset >= key);
          const float p =
              ok ? ex2(fmaf(sacc[n][e], scale_log2, -lse2[h])) : 0.f;
          dpacc[n][e] = p * (dpacc[n][e] - dlt[h]);
        }
      }

      // dQ += dS K over the chunk's keys, summed in fresh registers and
      // added to the total
#pragma unroll
      for (int ng = 0; ng < kNT; ng += kNG) {
        float dq_part[kNG][4];
        zero(dq_part);
#pragma unroll
        for (int j = 0; j < kKC / 8; ++j) {
          const Frag<4> dsa = frag_acc(dpacc[j]);
#pragma unroll
          for (int n = 0; n < kNG; ++n)
            mma3(dq_part[n], dsa,
                 frag_b_mn<D>(ks, kc + 8 * j, 8 * (ng + n)));
        }
        add_to(dq_acc, dq_part, ng);
      }
    }
    __syncthreads();  // this stage is read: the next load may reuse it
    k0 = k_next;
  }
  cp_async_wait<0>();

  store_acc<D>(dq + (bh_t + q0) * D, dq_acc, r0, t_len - q0, scale);
}

}  // namespace tf32

// -- delta = rowsum(dO * O): the pre-pass both dtypes' kernels read -----------

namespace delta_pass {

constexpr int kThreads = 256;

// The float32 sum of the products of one 16-byte chunk of o and of g.
__device__ __forceinline__ float dot_chunk(const uint4& a, const uint4& b,
                                           const float*) {
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w),
              fmaf(__uint_as_float(a.z), __uint_as_float(b.z),
                   fmaf(__uint_as_float(a.y), __uint_as_float(b.y),
                        __uint_as_float(a.x) * __uint_as_float(b.x))));
}

__device__ __forceinline__ float dot_chunk(const uint4& a, const uint4& b,
                                           const __nv_bfloat16*) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
    sum = fmaf(x.y, y.y, fmaf(x.x, y.x, sum));
  }
  return sum;
}

// delta[r] = sum_d float(o[r, d]) * float(g[r, d]) over rows r < rows of
// [rows, D] contiguous o and g. Each thread reads one 16-byte chunk of
// each (kLanes consecutive lanes cover a row), sums its products in
// float32, and the row's lanes add theirs with warp shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                       float* __restrict__ delta, int rows) {
  constexpr int kLanes = D * static_cast<int>(sizeof(T)) / 16;
  static_assert(kLanes >= 4 && kLanes <= 32, "a row spans 4 to 32 lanes");
  const size_t chunk = static_cast<size_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
  const size_t row = chunk / kLanes;
  float sum = 0.f;
  if (row < static_cast<size_t>(rows))
    sum = dot_chunk(__ldg(reinterpret_cast<const uint4*>(o) + chunk),
                    __ldg(reinterpret_cast<const uint4*>(g) + chunk),
                    static_cast<const T*>(nullptr));
#pragma unroll
  for (int lanes = kLanes / 2; lanes > 0; lanes /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, lanes);
  if (row < static_cast<size_t>(rows) && chunk % kLanes == 0)
    delta[row] = sum;
}

template <typename T, int D>
cudaError_t launch_t(const void* o, const void* g, float* dlt, int rows,
                     cudaStream_t stream) {
  constexpr int kLanes = D * static_cast<int>(sizeof(T)) / 16;
  const size_t chunks = static_cast<size_t>(rows) * kLanes;
  const unsigned blocks =
      static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
  if (blocks == 0) return cudaSuccess;
  flash_bwd_delta_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(g), dlt, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* o, const void* g, float* dlt, int rows,
                     int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_t<float, D>(o, g, dlt, rows, stream);
  if (dtype == 1) return launch_t<__nv_bfloat16, D>(o, g, dlt, rows, stream);
  return cudaErrorInvalidValue;
}

}  // namespace delta_pass

// One kernel of a dtype's pair (dkv or dq, as kDkv says) on grid (B*H,
// ceil(S/64)) or (B*H, ceil(T/64)) with smem bytes of shared memory.
template <bool kDkv, typename T, typename DkvKernel, typename DqKernel>
cudaError_t launch_one(DkvKernel dkv, DqKernel dq, size_t smem,
                       const Args& a, cudaStream_t stream) {
  const int tiles = ((kDkv ? a.s_len : a.t_len) + wg::kRows - 1) / wg::kRows;
  const dim3 grid(a.batch * a.heads, tiles);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  cudaError_t e;
  if constexpr (kDkv) {
    e = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    dkv<<<grid, wg::kThreads, smem, stream>>>(
        q, k, v, a.key_mask, g, a.lse, a.delta, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.heads, a.t_len, a.s_len, a.scale,
        a.causal);
  } else {
    e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    dq<<<grid, wg::kThreads, smem, stream>>>(
        q, k, v, a.key_mask, g, a.lse, a.delta, static_cast<T*>(a.out0),
        a.heads, a.t_len, a.s_len, a.scale, a.causal);
  }
  return cudaGetLastError();
}

// dtype 0: float32 on the tensor cores in 3xTF32; 1: bfloat16 on wgmma.
template <bool kDkv, int D>
cudaError_t launch_d(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0)
    return launch_one<kDkv, float>(tf32::flash_bwd_dkv_kernel<D>,
                                   tf32::flash_bwd_dq_kernel<D>,
                                   tf32::smem_bytes<D>(), a, stream);
  if (dtype == 1)
    return launch_one<kDkv, __nv_bfloat16>(wg::flash_bwd_dkv_kernel_wgmma<D>,
                                           wg::flash_bwd_dq_kernel_wgmma<D>,
                                           wg::smem_bytes<D>(), a, stream);
  return cudaErrorInvalidValue;
}

template <bool kDkv>
int launch(int device, const Args& a, int d, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      e = launch_d<kDkv, 32>(dtype, a, st);
      break;
    case 64:
      e = launch_d<kDkv, 64>(dtype, a, st);
      break;
    case 128:
      e = launch_d<kDkv, 128>(dtype, a, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
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

// delta [rows] float32 = rowsum(dout * out) over [rows, d] contiguous
// out and dout of one dtype, both 16-byte aligned (rows = B*H*T).
int dl4j_flash_bwd_delta(int device, const void* out, const void* dout,
                         void* delta, int rows, int d, int dtype,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dlt = static_cast<float*>(delta);
  switch (d) {
    case 32:
      e = delta_pass::launch_d<32>(out, dout, dlt, rows, dtype, st);
      break;
    case 64:
      e = delta_pass::launch_d<64>(out, dout, dlt, rows, dtype, st);
      break;
    case 128:
      e = delta_pass::launch_d<128>(out, dout, dlt, rows, dtype, st);
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
