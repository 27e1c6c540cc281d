// GRU recurrence for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/kernels/gru_scan.py::_make_fwd_kernel (the
// Pallas TPU kernel launched by _gru_pallas_fwd) and ::_make_bwd_kernel
// (launched by _gru_pallas_bwd), the two halves of the custom VJP behind
// the public gru_scan.gru.
//
// Forward, one time step t, gate order r, z, n:
//   p    = h_{t-1} . RW                                  ([N, 3H])
//   r, z = sigmoid(xp_rz + p_rz + b_rz)
//   n    = tanh(xp_n + r * p_n + b_n)                    (reset after RW)
//   h_t  = (1 - z) * n + z * h_{t-1}
// Optionally it saves the post-activation gates [N, 3H] and p_n [N, H],
// the training workspace. Backward, reversed time: from the workspace, the
// upstream dL/dh_t and the carry it writes dz_t = [dr_pre, dz_pre, dn_pre]
// and carries dh_{t-1} = dh_total * z + [dr_pre, dz_pre, r * dn_pre] . RW^T
// (the n-columns rotated by r: the candidate's product was r * p_n); after
// step 0 the carry is the gradient of h0. The weight, bias and input
// gradients are products over all of dz, computed outside (dgrad here,
// wgrad as large GEMMs), as in the JAX package.
//
// The recurrence needs all of h_{t-1} before any column of step t, so each
// step is one kernel launch and the C entry points issue the T launches
// (T + 1 backward) in a loop on one stream: one call per layer.
//
// What bounds a step on the card (N = 64, H = 1024). The product, 2 * N *
// H * 3H = 403 MFLOP, is float32-grade: three TF32 passes on the tensor
// cores (3xTF32), 2.4 us at 495 TFLOP/s, about 4 us at the ~300 TFLOP/s
// that mma.sync reaches in TF32 on an H100. The step also reads RW (12
// MiB) and, once per cluster, its left operand (h_{t-1}, 256 KiB forward;
// the carry [dz_{t+1}[:, :2H], r * dn_pre_{t+1}], 768 KiB backward) from
// the L2: 12 + 7.25 MiB forward (29 clusters), 12 + 11.25 MiB backward
// (15 clusters), several microseconds at the L2's rate; a launch and two
// cluster barriers add more.
//
// Design (both sweeps). A thread-block cluster owns kOwn * CL hidden units
// (CL = 4 or 8 blocks, kOwn = 9 units a block: H = 1024 takes 29 clusters
// of 4 or 15 of 8, 116 or 120 blocks, one per SM, all resident at once:
// the card holds 30 clusters of 4 and 15 of 8 at this shared memory) of
// one tile of NR batch rows (NR = 8, 16, 32 or 64, the least that covers
// min(N, 64)). The product is computed transposed, the batch rows on the
// n8 side of mma.sync.m16n8k8 (so N = 8 fills a tile): forward p^T [3 x
// the cluster's units, gate-major, padded to m16 tiles][NR] = RW^T . h^T,
// backward dot^T [the cluster's units][NR] = RW . carry^T. The cluster
// splits the reduction axis (H forward, 3H backward) into chunks dealt
// round-robin to its members, so each member copies 1/CL of the left
// operand and of its RW slice, with 16-byte cp.async copies (zero-filled
// past N, H and 3H; 4-byte copies where H % 4 != 0) into a ring of
// chunks in flight. A member's 8 warps split its product as (m16 tiles) x
// (n8 tiles) x (k8 steps of a chunk) and sum 3xTF32 products (mma_tf32.cuh;
// the three passes over all of a warp's tiles in turn) in registers. The
// warps' slabs of partial sums are added in shared memory, in slab order;
// each block then writes every row of its sum into the shared memory of
// the member that finishes that unit (distributed shared memory), the
// cluster syncs once, and each member adds what it received in rank order
// and runs the gate math on operands it copied in at the start. Every
// output element has one writer and there are no atomics, so the sweeps
// are deterministic. The gate math is float32 in the JAX kernel's order,
// (xp + h.RW) + b.
//
// The steps are launched as programmatic dependent launches: a step's
// blocks start on the SMs the step before frees, copy what does not
// depend on it (RW's first chunks, xp, bias, the workspace rows) and wait
// for it to complete before they read h_{t-1} or the carry.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;
using tf32::Frag;

constexpr int kBlockThreads = 256;  // 8 warps
constexpr int kOwn = 9;             // units each member finishes

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int larger(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int smaller(int a, int b) {
  return a < b ? a : b;
}
// the least stride >= n that is 8 mod 32: a fragment's single loads, 4
// rows x 8 columns, then fall in 32 different banks
__host__ __device__ constexpr int stride8(int n) {
  return n + (40 - n % 32) % 32;
}

// The warps of a block as (m16 tiles) x (n8 tiles) x (k8 steps of a
// chunk): WM x WN x WK = 8, WM the most of 4, 2, 1 that divides the m16
// tiles, WN at most WN_MAX. Warps of different wk sum different k8 steps
// of every chunk into separate slabs of partial sums.
template <int MTILES, int NR, int WN_MAX>
struct Warps {
  static constexpr int WM = MTILES % 4 == 0 ? 4 : MTILES % 2 == 0 ? 2 : 1;
  static constexpr int WN = smaller(smaller(NR / 8, 8 / WM), WN_MAX);
  static constexpr int WK = 8 / (WM * WN);
  static constexpr int MT = MTILES / WM;  // m16 tiles of a warp
  static constexpr int NT = NR / 8 / WN;  // n8 tiles of a warp
};

// Shared memory of a block, in floats: the ring of chunks, which after
// the last chunk holds the block's WK slabs of partial sums [M][NR + 4];
// the staging, where every member writes its sums of this member's rows,
// [rank][row][NR]; the epilogue's operands, [field][NR][kOwn].
//
// The forward for a row tile of NR rows. M is 3 x the cluster's units,
// gate-major; a chunk is kKc values of H: RW's rows for the M columns (A =
// RW^T, MN-major, row stride 8 mod 32) and h_{t-1}'s rows [NR][kKc] (B,
// K-major, stride kKc + 4). The N = 8 tile runs in clusters of 8, the
// others in clusters of 4 (the faster of the two on the card, PERF.md).
template <int NR>
struct Fwd {
  static constexpr int kCluster = NR <= 8 ? 8 : 4;
  static constexpr int kUnits = kOwn * kCluster;
  static constexpr int kCols = 3 * kUnits;
  static constexpr int kMTiles = cdiv(kCols, 16);
  static constexpr int kM = 16 * kMTiles;
  static constexpr int kKc = kCluster == 8 ? 32 : 64;
  static constexpr int kStages = kCluster == 8 ? 4 : 3;
  static constexpr int kStrideA = stride8(kM);
  static constexpr int kStrideB = kKc + 4;
  using W = Warps<kMTiles, NR, 4>;
  static constexpr int kStage = kKc * kStrideA + NR * kStrideB;
  static constexpr int kRing =
      larger(kStages * kStage, W::WK * kM * (NR + 4));
  static constexpr int kRows = 3 * kOwn;  // staged rows of a member
  static constexpr int kStaging = kCluster * kRows * NR;
  // xp [3][NR][kOwn], h_{t-1} [NR][kOwn], bias [3][kOwn]
  static constexpr int kEpi = 4 * NR * kOwn + 3 * kOwn;
  static constexpr size_t kBytes =
      sizeof(float) * (kRing + kStaging + kEpi);
};

// The backward: M is the cluster's units; a chunk is kKc values of 3H:
// RW's rows of the units [M][kKc] (A, K-major) and the carry's rows
// [NR][kKc] (B, K-major), both at stride kKc + 4.
template <int NR>
struct Bwd {
  static constexpr int kCluster = 8;
  static constexpr int kUnits = kOwn * kCluster;
  static constexpr int kMTiles = cdiv(kUnits, 16);
  static constexpr int kM = 16 * kMTiles;
  static constexpr int kKc = 64;
  static constexpr int kStages = 3;
  static constexpr int kStride = kKc + 4;
  using W = Warps<kMTiles, NR, 2>;
  static constexpr int kStage = (kM + NR) * kStride;
  static constexpr int kRing =
      larger(kStages * kStage, W::WK * kM * (NR + 4));
  static constexpr int kRows = kOwn;
  static constexpr int kStaging = kCluster * kRows * NR;
  // gates [3][NR][kOwn], hpn, h_{t-1}, dL/dh_t and the carry [NR][kOwn]
  static constexpr int kEpi = 7 * NR * kOwn;
  static constexpr size_t kBytes =
      sizeof(float) * (kRing + kStaging + kEpi);
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Four consecutive floats at src into shared memory at dst, of which the
// first `valid` (0..4) are read and the rest zero-filled: one 16-byte copy
// when vec (src 16-byte aligned and valid 0 or 4), else four 4-byte
// copies. `any` is a valid address, read for nothing.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int valid, int vec, const float* any) {
  const uint32_t d = tf32::smem_addr(dst);
  if (vec) {
    tf32::cp_async16(d, valid > 0 ? src : any, valid > 0);
  } else {
#pragma unroll
    for (int z = 0; z < 4; ++z)
      wg::cp_async4(d + 4 * z, z < valid ? src + z : any, z < valid);
  }
}

__device__ __forceinline__ int clamp4(int n) {
  return n < 0 ? 0 : n > 4 ? 4 : n;
}

// Columns j0..j0+kOwn-1 of rows r0..r0+NR-1 of a matrix with row stride
// `stride` (from column `col` on) into dst [NR][kOwn], zero past n_rows
// and H: 4-byte copies (j0 is a multiple of 9), spread over the block.
template <int NR>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          size_t stride, size_t col, int r0,
                                          int n_rows, int j0, int hidden) {
  for (int e = threadIdx.x; e < NR * kOwn; e += kBlockThreads) {
    const int row = e / kOwn, c = e % kOwn;
    const int n = r0 + row, j = j0 + c;
    const bool ok = n < n_rows && j < hidden;
    wg::cp_async4(tf32::smem_addr(dst + e),
                  ok ? src + static_cast<size_t>(n) * stride + col + j : src,
                  ok);
  }
}

// A[m][k] = tile[k0 + k][m0 + m] (the tile MN-major, row stride S) as the
// A fragment of one m16n8k8 step: four single loads, rows g, g + 8 and
// columns t, t + 4 of A.
template <int S>
__device__ __forceinline__ Frag<4> frag_a_mn(const float* tile, int m0,
                                            int k0) {
  const float* p = tile + (k0 + tf32::lane_t()) * S + m0 + tf32::lane_g();
  Frag<4> f;
  tf32::split(p[0], f.big[0], f.small[0]);
  tf32::split(p[8], f.big[1], f.small[1]);
  tf32::split(p[4 * S], f.big[2], f.small[2]);
  tf32::split(p[4 * S + 8], f.big[3], f.small[3]);
  return f;
}

// B of one n8 tile, B[k][n] = tile[n0 + n][c0 + k] (the tile K-major,
// mma_tf32.cuh's Tile<D> stride): one ldmatrix of two 8 x 4 matrices,
// whose rows lanes 0-15 address.
template <int D>
__device__ __forceinline__ Frag<2> frag_b_k1(const float* tile, int n0,
                                            int c0) {
  const int l = threadIdx.x % 32;
  const uint32_t addr = tf32::smem_addr(
      tile + (n0 + l % 8) * tf32::Tile<D>::kStride + c0 + 4 * ((l / 8) & 1));
  uint32_t u[2];
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(u[0]), "=r"(u[1])
               : "r"(addr));
  Frag<2> f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    tf32::split(__uint_as_float(u[i]), f.big[i], f.small[i]);
  return f;
}

// B of the NT n8 tiles n0, n0 + 8, ... of a K-major tile at k step c0.
template <int D, int NT>
__device__ __forceinline__ void frag_b_tiles(Frag<2> (&b)[NT],
                                             const float* tile, int n0,
                                             int c0) {
  if constexpr (NT % 2 == 0) {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      Frag<2> two[2];
      tf32::frag_b_k2<D>(two, tile, n0 + 16 * p, c0);
      b[2 * p] = two[0];
      b[2 * p + 1] = two[1];
    }
  } else {
    static_assert(NT == 1, "one n8 tile or pairs");
    b[0] = frag_b_k1<D>(tile, n0, c0);
  }
}

// d[mt][nt] += a[mt] . b[nt] for every tile, float32-grade: the three TF32
// passes of mma_tf32.cuh's mma3 (small x big, big x small, big x big, into
// one accumulator), each pass over all tiles before the next, so a tile's
// three products are MT x NT instructions apart.
template <int MT, int NT>
__device__ __forceinline__ void mma3_tiles(float (&d)[MT][NT][4],
                                           const Frag<4> (&a)[MT],
                                           const Frag<2> (&b)[NT]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      tf32::mma(d[mt][nt], a[mt].small, b[nt].big);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      tf32::mma(d[mt][nt], a[mt].big, b[nt].small);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      tf32::mma(d[mt][nt], a[mt].big, b[nt].big);
}

// The warp's accumulators into its slab of partial sums, [M][NR + 4]: row
// m0 + 16 mt + g (+8), columns n0 + 8 nt + 2t, +1 of each m16n8 tile.
template <int NR, int MT, int NT>
__device__ __forceinline__ void store_partials(float* slab,
                                               const float (&d)[MT][NT][4],
                                               int m0, int n0) {
  constexpr int kPS = NR + 4;
  const int g = tf32::lane_g(), t = tf32::lane_t();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = slab + (m0 + 16 * mt + g) * kPS + n0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(d[mt][nt][0], d[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * kPS) =
          make_float2(d[mt][nt][2], d[mt][nt][3]);
    }
}

// The block's partial sums, its WK slabs [M][NR + 4] added in slab order,
// into the staging of the members that finish them: row m < M_VALID of
// the product's M side (gate m / UNITS, the cluster's unit m % UNITS) to
// member (m % UNITS) / kOwn, at [rank][(m / UNITS) kOwn + m % UNITS %
// kOwn][NR] of its staging. Remote stores, which nothing waits for before
// the cluster barrier that follows.
template <int NR, int WK, int M, int ROWS, int UNITS, int M_VALID>
__device__ __forceinline__ void push_partials(cg::cluster_group& cl,
                                              const float* slabs,
                                              float* staging, int rank) {
  constexpr int kPS = NR + 4;
  constexpr int kQuads = NR / 4;
  for (int e = threadIdx.x; e < M_VALID * kQuads; e += kBlockThreads) {
    const int m = e / kQuads, nq = e % kQuads;
    const float* p = slabs + m * kPS + 4 * nq;
    float4 s = *reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int w = 1; w < WK; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(p + w * M * kPS);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int unit = m % UNITS;
    const int c = m / UNITS * kOwn + unit % kOwn;
    *reinterpret_cast<float4*>(cl.map_shared_rank(staging, unit / kOwn) +
                               (rank * ROWS + c) * NR + 4 * nq) = s;
  }
}

// Row c, columns 4nq..4nq+3 of the staged partial sums, summed in rank
// order.
template <int NR, int ROWS, int CL>
__device__ __forceinline__ float4 staged_sum(const float* staging, int c,
                                             int nq) {
  float4 s = *reinterpret_cast<const float4*>(staging + c * NR + 4 * nq);
#pragma unroll
  for (int q = 1; q < CL; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(
        staging + (q * ROWS + c) * NR + 4 * nq);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  return s;
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The cluster barrier in two halves: every member arrives when it starts
// and waits before it first writes to another's shared memory, which then
// exists.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Programmatic dependent launch: the next step's grid may be scheduled
// once every block of this one has started; before it reads anything the
// previous step wrote, a block waits until that step has completed and
// its writes are visible (a no-op when the launch did not allow overlap).
__device__ __forceinline__ void launch_next_step() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void wait_previous_step() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// One forward step for a row tile of NR rows. Grid (F::kCluster * ceil(H
// / F::kUnits), ceil(N / NR)) in clusters of F::kCluster along x. `vec`:
// RW, h_{t-1} and H allow 16-byte copies.
template <int NR>
__global__ void __launch_bounds__(kBlockThreads, 1)
    gru_fwd_step_kernel(const float* __restrict__ xp,
                        const float* __restrict__ rw,
                        const float* __restrict__ bias,
                        const float* __restrict__ h_prev,
                        float* __restrict__ h_out, float* __restrict__ gates,
                        float* __restrict__ hpn, int n_rows, int hidden,
                        int vec) {
  using F = Fwd<NR>;
  using W = typename F::W;
  static_assert(F::kMTiles % W::WM == 0 && NR % (8 * W::WN) == 0 &&
                    (F::kKc / 8) % W::WK == 0,
                "whole warp tiles");

  extern __shared__ __align__(16) float smem[];
  launch_next_step();
  cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % W::WM;
  const int wn = (warp / W::WM) % W::WN;
  const int wk = warp / (W::WM * W::WN);
  const int u0 = (blockIdx.x / F::kCluster) * F::kUnits;
  const int j0 = u0 + rank * kOwn;  // the units this member finishes
  const int r0 = blockIdx.y * NR;
  const int H = hidden;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int n_chunks = (H + F::kKc - 1) / F::kKc;
  // this member's chunks: rank, rank + kCluster, ...
  const int mine =
      rank < n_chunks ? (n_chunks - 1 - rank) / F::kCluster + 1 : 0;

  // this member's chunk i of RW (the rows k0.., 4 units a copy) and of
  // h_{t-1}, into ring slot i % kStages
  auto issue_rw = [&](int i) {
    if (i >= mine) return;
    const int k0 = (rank + i * F::kCluster) * F::kKc;
    float* a_s = smem + (i % F::kStages) * F::kStage;
    constexpr int kQ = F::kUnits / 4;  // copies of a gate's units
    constexpr int kA = F::kKc * 3 * kQ;
#pragma unroll
    for (int x = 0; x < cdiv(kA, kBlockThreads); ++x) {
      const int e = tid + x * kBlockThreads;
      if (kA % kBlockThreads == 0 || e < kA) {
        const int k = e / (3 * kQ), g = (e / kQ) % 3, q = e % kQ;
        const int kr = k0 + k, u = u0 + 4 * q;
        copy4(a_s + k * F::kStrideA + g * F::kUnits + 4 * q,
              rw + static_cast<size_t>(kr) * H3 +
                  static_cast<size_t>(g) * H + u,
              kr < H ? clamp4(H - u) : 0, vec, rw);
      }
    }
  };
  auto issue_h = [&](int i) {
    if (i >= mine) return;
    const int k0 = (rank + i * F::kCluster) * F::kKc;
    float* b_s = smem + (i % F::kStages) * F::kStage + F::kKc * F::kStrideA;
    constexpr int kB = NR * F::kKc / 4;
#pragma unroll
    for (int x = 0; x < cdiv(kB, kBlockThreads); ++x) {
      const int e = tid + x * kBlockThreads;
      if (kB % kBlockThreads == 0 || e < kB) {
        const int row = e / (F::kKc / 4), q = e % (F::kKc / 4);
        const int n = r0 + row, k = k0 + 4 * q;
        copy4(b_s + row * F::kStrideB + 4 * q,
              h_prev + static_cast<size_t>(n) * H + k,
              n < n_rows ? clamp4(H - k) : 0, vec, h_prev);
      }
    }
  };

  // First what does not depend on the previous step (the epilogue's xp
  // and bias, RW of the first chunks), then, once it has completed, its
  // h_{t-1}. The copy groups: the epilogue's operands with the first
  // chunks' RW; then one a chunk (its h_{t-1}, or all of it past the first
  // kStages - 1), empty past the last.
  float* epi = smem + F::kRing + F::kStaging;
#pragma unroll
  for (int g = 0; g < 3; ++g)
    copy_rows<NR>(epi + g * NR * kOwn, xp, H3, static_cast<size_t>(g) * H,
                  r0, n_rows, j0, H);
  if (tid < 3 * kOwn) {
    const int g = tid / kOwn, j = j0 + tid % kOwn;
    wg::cp_async4(tf32::smem_addr(epi + 4 * NR * kOwn + tid),
                  j < H ? bias + g * H + j : bias, j < H);
  }
#pragma unroll
  for (int c = 0; c < F::kStages - 1; ++c) issue_rw(c);
  wait_previous_step();
  copy_rows<NR>(epi + 3 * NR * kOwn, h_prev, H, 0, r0, n_rows, j0, H);
  tf32::cp_async_commit();
#pragma unroll
  for (int c = 0; c < F::kStages - 1; ++c) {
    issue_h(c);
    tf32::cp_async_commit();
  }

  float acc[W::MT][W::NT][4];
#pragma unroll
  for (int mt = 0; mt < W::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int i = 0; i < mine; ++i) {
    tf32::cp_async_wait<F::kStages - 2>();  // this thread's copies of i
    // every thread's copies of chunk i have landed, and every warp is done
    // with chunk i - 1, whose slot the next issue refills
    __syncthreads();
    issue_rw(i + F::kStages - 1);
    issue_h(i + F::kStages - 1);
    tf32::cp_async_commit();
    const float* a_s = smem + (i % F::kStages) * F::kStage;
    const float* b_s = a_s + F::kKc * F::kStrideA;
    // this warp's k8 steps, wk, wk + WK, ...: one straight unrolled run,
    // so the next step's loads can be issued before this one's products
#pragma unroll
    for (int kk = 0; kk < F::kKc / 8 / W::WK; ++kk) {
      const int ks = kk * W::WK + wk;
      Frag<2> b[W::NT];
      frag_b_tiles<F::kKc, W::NT>(b, b_s, wn * W::NT * 8, 8 * ks);
      Frag<4> a[W::MT];
#pragma unroll
      for (int mt = 0; mt < W::MT; ++mt)
        a[mt] = frag_a_mn<F::kStrideA>(a_s, (wm * W::MT + mt) * 16, 8 * ks);
      mma3_tiles(acc, a, b);
    }
  }
  tf32::cp_async_wait<0>();  // the epilogue's operands too
  __syncthreads();           // the partial sums overwrite the ring
  store_partials<NR>(smem + wk * F::kM * (NR + 4), acc, wm * W::MT * 16,
                     wn * W::NT * 8);
  __syncthreads();
  cluster_wait();  // every member has started: its staging exists
  float* staging = smem + F::kRing;
  push_partials<NR, W::WK, F::kM, F::kRows, F::kUnits, F::kCols>(
      cluster, smem, staging, rank);
  cluster.sync();  // every partial sum has reached its member

  // finish units j0 + u, rows r0 + 4 nq .. + 3
  constexpr int kTasks = kOwn * NR / 4;
  for (int task = tid; task < kTasks; task += kBlockThreads) {
    const int u = task % kOwn, nq = task / kOwn;
    const int j = j0 + u;
    if (j >= H) continue;
    float4 p[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      p[g] = staged_sum<NR, F::kRows, F::kCluster>(staging, g * kOwn + u,
                                                   nq);
    const float* x_s = epi;
    const float* h_s = epi + 3 * NR * kOwn;
    const float* b_s = epi + 4 * NR * kOwn;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * nq + i, n = r0 + row;
      if (n < n_rows) {
        const size_t row3 = static_cast<size_t>(n) * H3;
        const size_t idx = static_cast<size_t>(n) * H + j;
        const int e = row * kOwn + u;
        const float pr = lane4(p[0], i), pz = lane4(p[1], i),
                    pn = lane4(p[2], i);
        // the JAX kernel's order: (xp + h.RW) + b
        const float r = sigmoid((x_s[e] + pr) + b_s[u]);
        const float z = sigmoid((x_s[NR * kOwn + e] + pz) + b_s[kOwn + u]);
        const float nn = tanhf((x_s[2 * NR * kOwn + e] + r * pn) +
                               b_s[2 * kOwn + u]);
        h_out[idx] = (1.f - z) * nn + z * h_s[e];
        if (gates != nullptr) {
          gates[row3 + j] = r;
          gates[row3 + H + j] = z;
          gates[row3 + 2 * H + j] = nn;
          hpn[idx] = pn;
        }
      }
    }
  }
}

// One backward step, or (gates == nullptr) the final carry. Grid and
// clusters as forward, with B::kCluster. dot = [dz_next[:, :2H],
// rotn_next] . RW^T over the 3H columns (0 when dz_next is null: the
// first reversed step, which then touches no other member); carry = dhz +
// dot; the final launch writes dhz = carry (dL/dh0) and stops. Otherwise
// dh_total = gh + carry, the gate gradients go to dz, r * dn_pre to rotn
// (the next launch's rotated n-columns), and dhz becomes dh_total * z.
// dhz is read (once the previous step has completed) and written in place
// by the block that owns the element. `vec`: RW, dz_next, rotn_next and H
// allow 16-byte copies.
template <int NR>
__global__ void __launch_bounds__(kBlockThreads, 1)
    gru_bwd_step_kernel(const float* __restrict__ gates,
                        const float* __restrict__ hpn,
                        const float* __restrict__ h_prev,
                        const float* __restrict__ gh,
                        const float* __restrict__ dz_next,
                        const float* __restrict__ rotn_next,
                        const float* __restrict__ rw, float* __restrict__ dz,
                        float* __restrict__ rotn, float* dhz, int n_rows,
                        int hidden, int vec) {
  using B = Bwd<NR>;
  using W = typename B::W;
  static_assert(B::kMTiles % W::WM == 0 && NR % (8 * W::WN) == 0 &&
                    (B::kKc / 8) % W::WK == 0,
                "whole warp tiles");

  extern __shared__ __align__(16) float smem[];
  const bool product = dz_next != nullptr;  // uniform across the grid
  launch_next_step();
  if (product) cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % W::WM;
  const int wn = (warp / W::WM) % W::WN;
  const int wk = warp / (W::WM * W::WN);
  const int u0 = (blockIdx.x / B::kCluster) * B::kUnits;
  const int j0 = u0 + rank * kOwn;
  const int r0 = blockIdx.y * NR;
  const int H = hidden;
  const int M = 3 * H;
  const int n_chunks = (M + B::kKc - 1) / B::kKc;
  const int mine =
      product && rank < n_chunks ? (n_chunks - 1 - rank) / B::kCluster + 1
                                 : 0;

  // this member's chunk i of RW (the units' rows, m0..m0+kKc-1) and of
  // the carry, into ring slot i % kStages
  auto issue_rw = [&](int i) {
    if (i >= mine) return;
    const int m0 = (rank + i * B::kCluster) * B::kKc;
    float* a_s = smem + (i % B::kStages) * B::kStage;
    constexpr int kA = B::kUnits * B::kKc / 4;
#pragma unroll
    for (int x = 0; x < cdiv(kA, kBlockThreads); ++x) {
      const int e = tid + x * kBlockThreads;
      if (kA % kBlockThreads == 0 || e < kA) {
        const int row = e / (B::kKc / 4), q = e % (B::kKc / 4);
        const int uu = u0 + row, m = m0 + 4 * q;
        copy4(a_s + row * B::kStride + 4 * q,
              rw + static_cast<size_t>(uu) * M + m,
              uu < H ? clamp4(M - m) : 0, vec, rw);
      }
    }
  };
  auto issue_carry = [&](int i) {
    if (i >= mine) return;
    const int m0 = (rank + i * B::kCluster) * B::kKc;
    float* b_s = smem + (i % B::kStages) * B::kStage + B::kM * B::kStride;
    constexpr int kB = NR * B::kKc / 4;
#pragma unroll
    for (int x = 0; x < cdiv(kB, kBlockThreads); ++x) {
      const int e = tid + x * kBlockThreads;
      if (kB % kBlockThreads == 0 || e < kB) {
        const int row = e / (B::kKc / 4), q = e % (B::kKc / 4);
        const int n = r0 + row, m = m0 + 4 * q;
        float* dst = b_s + row * B::kStride + 4 * q;
        if (vec) {  // 2H % 4 == 0: a copy never straddles 2H
          const float* src =
              m < 2 * H ? dz_next + static_cast<size_t>(n) * M + m
                        : rotn_next + static_cast<size_t>(n) * H + m - 2 * H;
          copy4(dst, src, n < n_rows ? clamp4(M - m) : 0, 1, dz_next);
        } else {
#pragma unroll
          for (int z = 0; z < 4; ++z) {
            const int mz = m + z;
            const bool ok = n < n_rows && mz < M;
            const float* src =
                !ok ? dz_next
                : mz < 2 * H
                    ? dz_next + static_cast<size_t>(n) * M + mz
                    : rotn_next + static_cast<size_t>(n) * H + mz - 2 * H;
            wg::cp_async4(tf32::smem_addr(dst + z), src, ok);
          }
        }
      }
    }
  };

  // First what does not depend on the previous step (the epilogue's
  // workspace rows and dL/dh_t, RW of the first chunks), then, once it
  // has completed, the carry it wrote. The copy groups: the epilogue's
  // operands with the first chunks' RW; then one a chunk (its carry, or
  // all of it past the first kStages - 1), empty past the last.
  float* epi = smem + B::kRing + B::kStaging;
  constexpr int kF = NR * kOwn;  // floats of one [NR][kOwn] field
  if (gates != nullptr) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
      copy_rows<NR>(epi + g * kF, gates, M, static_cast<size_t>(g) * H, r0,
                    n_rows, j0, H);
    copy_rows<NR>(epi + 3 * kF, hpn, H, 0, r0, n_rows, j0, H);
    copy_rows<NR>(epi + 4 * kF, h_prev, H, 0, r0, n_rows, j0, H);
    copy_rows<NR>(epi + 5 * kF, gh, H, 0, r0, n_rows, j0, H);
  }
#pragma unroll
  for (int c = 0; c < B::kStages - 1; ++c) issue_rw(c);
  wait_previous_step();
  copy_rows<NR>(epi + 6 * kF, dhz, H, 0, r0, n_rows, j0, H);
  tf32::cp_async_commit();

  float* staging = smem + B::kRing;
  if (product) {
#pragma unroll
    for (int c = 0; c < B::kStages - 1; ++c) {
      issue_carry(c);
      tf32::cp_async_commit();
    }
    float acc[W::MT][W::NT][4];
#pragma unroll
    for (int mt = 0; mt < W::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    for (int i = 0; i < mine; ++i) {
      tf32::cp_async_wait<B::kStages - 2>();
      __syncthreads();
      issue_rw(i + B::kStages - 1);
      issue_carry(i + B::kStages - 1);
      tf32::cp_async_commit();
      const float* a_s = smem + (i % B::kStages) * B::kStage;
      const float* b_s = a_s + B::kM * B::kStride;
#pragma unroll
      for (int kk = 0; kk < B::kKc / 8 / W::WK; ++kk) {
        const int ks = kk * W::WK + wk;  // this warp's k8 steps
        Frag<2> b[W::NT];
        frag_b_tiles<B::kKc, W::NT>(b, b_s, wn * W::NT * 8, 8 * ks);
        Frag<4> a[W::MT];
#pragma unroll
        for (int mt = 0; mt < W::MT; ++mt)
          a[mt] = tf32::frag_a<B::kKc>(a_s, (wm * W::MT + mt) * 16, 8 * ks);
        mma3_tiles(acc, a, b);
      }
    }
    tf32::cp_async_wait<0>();  // the epilogue's operands too
    __syncthreads();           // the partial sums overwrite the ring
    store_partials<NR>(smem + wk * B::kM * (NR + 4), acc, wm * W::MT * 16,
                       wn * W::NT * 8);
    __syncthreads();
    cluster_wait();  // every member has started: its staging exists
    push_partials<NR, W::WK, B::kM, B::kRows, B::kUnits, B::kUnits>(
        cluster, smem, staging, rank);
    cluster.sync();  // every partial sum has reached its member
  } else {
    tf32::cp_async_wait<0>();
    __syncthreads();  // the epilogue's operands are complete
  }

  constexpr int kTasks = kOwn * NR / 4;
  for (int task = tid; task < kTasks; task += kBlockThreads) {
    const int u = task % kOwn, nq = task / kOwn;
    const int j = j0 + u;
    if (j >= H) continue;
    float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
    if (product) dot = staged_sum<NR, B::kRows, B::kCluster>(staging, u, nq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * nq + i, n = r0 + row;
      if (n < n_rows) {
        const size_t idx = static_cast<size_t>(n) * H + j;
        const int e = row * kOwn + u;
        const float carry = epi[6 * kF + e] + lane4(dot, i);
        if (gates == nullptr) {
          dhz[idx] = carry;
        } else {
          const size_t row3 = static_cast<size_t>(n) * M;
          const float r = epi[e];
          const float z = epi[kF + e];
          const float nn = epi[2 * kF + e];
          const float dh_total = epi[5 * kF + e] + carry;
          const float dn = dh_total * (1.f - z);
          const float dzv = dh_total * (epi[4 * kF + e] - nn);
          const float dn_pre = dn * (1.f - nn * nn);
          const float dr = dn_pre * epi[3 * kF + e];
          const float dr_pre = dr * r * (1.f - r);
          const float dz_pre = dzv * z * (1.f - z);
          dz[row3 + j] = dr_pre;
          dz[row3 + H + j] = dz_pre;
          dz[row3 + 2 * H + j] = dn_pre;
          rotn[idx] = r * dn_pre;
          dhz[idx] = dh_total * z;
        }
      }
    }
  }
}

// The row tile NR for N rows: the least of 8, 16, 32, 64 that covers
// min(N, 64).
int row_tile(int n_rows) {
  return n_rows <= 8 ? 8 : n_rows <= 16 ? 16 : n_rows <= 32 ? 32 : 64;
}

// Grid of a sweep: clusters of `cluster` blocks along x, each owning
// `units` hidden units, by row tiles of NR along y.
dim3 step_grid(int n_rows, int hidden, int nr, int cluster, int units) {
  return dim3(cluster * ((hidden + units - 1) / units),
              (n_rows + nr - 1) / nr);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A launch in clusters of `cluster` blocks; `overlap` lets it start while
// the previous kernel in the stream runs (programmatic dependent launch:
// the kernel waits for that kernel before it reads what it wrote).
struct Launch {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;  // points at attr: not copied
  Launch(const Launch&) = delete;
  Launch(dim3 grid, size_t smem, cudaStream_t st, int cluster,
         bool overlap) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kBlockThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = overlap ? 2 : 1;
  }
};

// Allows the kernel `smem` bytes of dynamic shared memory on the current
// device and asks how many of its clusters fit on the card at once (into
// *active when given); none is an error: the card refuses the launch.
// Without `active`, a device already prepared is not asked again.
template <auto kernel>
cudaError_t prepare(dim3 grid, size_t smem, int cluster, int* active) {
  static unsigned prepared = 0;  // a bit per device, for this kernel
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (active == nullptr &&
      (__atomic_load_n(&prepared, __ATOMIC_ACQUIRE) & bit) != 0)
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const Launch l(grid, smem, nullptr, cluster, false);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kernel), &l.cfg);
  if (e != cudaSuccess) return e;
  if (active != nullptr) *active = n;
  if (n < 1) return cudaErrorLaunchOutOfResources;
  __atomic_fetch_or(&prepared, bit, __ATOMIC_RELEASE);
  return cudaSuccess;
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), const Launch& l,
                   Args... args) {
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int NR>
cudaError_t run_fwd(const float* xp, const float* rw, const float* bias,
                    const float* h0, float* hs, float* gates, float* hpn,
                    int t_len, int n_rows, int hidden, cudaStream_t st) {
  using F = Fwd<NR>;
  const dim3 grid = step_grid(n_rows, hidden, NR, F::kCluster, F::kUnits);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  cudaError_t e =
      prepare<gru_fwd_step_kernel<NR>>(grid, F::kBytes, F::kCluster, nullptr);
  if (e != cudaSuccess) return e;
  // every h_{t-1} is h0 or a row block of hs, nh floats apart: 16-byte
  // aligned when H % 4 == 0
  const int vec = hidden % 4 == 0 && aligned16(rw) && aligned16(h0) &&
                  aligned16(hs);
  // the first step waits for whatever wrote xp; the others may start
  // while the step before them runs
  const Launch first(grid, F::kBytes, st, F::kCluster, false);
  const Launch next(grid, F::kBytes, st, F::kCluster, true);
  for (int t = 0; t < t_len; ++t) {
    e = launch(gru_fwd_step_kernel<NR>, t == 0 ? first : next,
               xp + t * 3 * nh, rw, bias, t == 0 ? h0 : hs + (t - 1) * nh,
               hs + t * nh, gates != nullptr ? gates + t * 3 * nh : nullptr,
               hpn != nullptr ? hpn + t * nh : nullptr, n_rows, hidden, vec);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int NR>
cudaError_t run_bwd(const float* gates, const float* hpn, const float* hs,
                    const float* h0, const float* gh, const float* rw,
                    float* dxp, float* rotn, float* dh, int t_len,
                    int n_rows, int hidden, cudaStream_t st) {
  using B = Bwd<NR>;
  const dim3 grid = step_grid(n_rows, hidden, NR, B::kCluster, B::kUnits);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  cudaError_t e =
      prepare<gru_bwd_step_kernel<NR>>(grid, B::kBytes, B::kCluster, nullptr);
  if (e != cudaSuccess) return e;
  const int vec = hidden % 4 == 0 && aligned16(rw) && aligned16(dxp) &&
                  aligned16(rotn);
  // the first launch waits for whatever wrote the workspace and dh
  const Launch first(grid, B::kBytes, st, B::kCluster, false);
  const Launch next(grid, B::kBytes, st, B::kCluster, true);
  for (int t = t_len - 1; t >= 0; --t) {
    const bool last = t == t_len - 1;
    // rotn ping-pongs between two [N, H] halves: step t writes half t % 2
    // while its blocks read half (t + 1) % 2, written by step t + 1
    e = launch(gru_bwd_step_kernel<NR>, last ? first : next,
               gates + t * 3 * nh, hpn + t * nh,
               t == 0 ? h0 : hs + (t - 1) * nh, gh + t * nh,
               last ? nullptr : dxp + (t + 1) * 3 * nh,
               last ? nullptr : rotn + ((t + 1) % 2) * nh, rw,
               dxp + t * 3 * nh, rotn + (t % 2) * nh, dh, n_rows, hidden,
               vec);
    if (e != cudaSuccess) return e;
  }
  return launch(gru_bwd_step_kernel<NR>, next, nullptr, nullptr, nullptr,
                nullptr, dxp, rotn, rw, nullptr, nullptr, dh, n_rows, hidden,
                vec);
}

template <int NR>
cudaError_t plan(int n_rows, int hidden, int* out) {
  using F = Fwd<NR>;
  using B = Bwd<NR>;
  const dim3 fwd = step_grid(n_rows, hidden, NR, F::kCluster, F::kUnits);
  const dim3 bwd = step_grid(n_rows, hidden, NR, B::kCluster, B::kUnits);
  out[0] = NR;
  out[1] = static_cast<int>(fwd.y);
  out[2] = F::kCluster;
  out[3] = static_cast<int>(fwd.x);
  out[4] = static_cast<int>(F::kBytes);
  out[6] = B::kCluster;
  out[7] = static_cast<int>(bwd.x);
  out[8] = static_cast<int>(B::kBytes);
  const cudaError_t e = prepare<gru_fwd_step_kernel<NR>>(
      fwd, F::kBytes, F::kCluster, &out[5]);
  if (e != cudaSuccess) return e;
  return prepare<gru_bwd_step_kernel<NR>>(bwd, B::kBytes, B::kCluster,
                                          &out[9]);
}

}  // namespace

extern "C" {

// Forward over T steps, all float32 and contiguous. xp [T, N, 3H] (the
// input projection x . W, time-major), rw [H, 3H], bias [3H], h0 [N, H].
// Writes hs [T, N, H]; with the workspace (gates and hpn non-null) gates
// [T, N, 3H] (r, z, n) and hpn [T, N, H] (h_{t-1} . RW_n). Returns the
// cudaError_t of the first failed launch (0 = all T launched).
int dl4j_gru_fwd(int device, const void* xp, const void* rw,
                 const void* bias, const void* h0, void* hs, void* gates,
                 void* hpn, int t_len, int n_rows, int hidden,
                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((gates == nullptr) != (hpn == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(xp);
  const float* w = static_cast<const float*>(rw);
  const float* b = static_cast<const float*>(bias);
  const float* h = static_cast<const float*>(h0);
  float* o = static_cast<float*>(hs);
  float* g = static_cast<float*>(gates);
  float* p = static_cast<float*>(hpn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_tile(n_rows)) {
    case 8: e = run_fwd<8>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
      break;
    case 16: e = run_fwd<16>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
      break;
    case 32: e = run_fwd<32>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
      break;
    default:
      e = run_fwd<64>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
  }
  return static_cast<int>(e);
}

// Backward over T steps, reversed, all float32 and contiguous: gates
// [T, N, 3H] and hpn [T, N, H] from the forward's workspace, hs [T, N, H]
// its outputs and h0 [N, H] (h_{t-1} is read from them), gh [T, N, H] the
// upstream dL/dh_t (dL/dh_T folded into the last step), rw [H, 3H]. dxp
// [T, N, 3H] receives dz; rotn [2, N, H] is scratch for the rotated
// n-columns. dh [N, H] must hold zeros on entry (the carry's elementwise
// part starts at 0) and holds dL/dh0 on return. T + 1 launches.
int dl4j_gru_bwd(int device, const void* gates, const void* hpn,
                 const void* hs, const void* h0, const void* gh,
                 const void* rw, void* dxp, void* rotn, void* dh, int t_len,
                 int n_rows, int hidden, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* p = static_cast<const float*>(hpn);
  const float* o = static_cast<const float*>(hs);
  const float* h = static_cast<const float*>(h0);
  const float* u = static_cast<const float*>(gh);
  const float* w = static_cast<const float*>(rw);
  float* d = static_cast<float*>(dxp);
  float* r = static_cast<float*>(rotn);
  float* c = static_cast<float*>(dh);
  switch (row_tile(n_rows)) {
    case 8: e = run_bwd<8>(g, p, o, h, u, w, d, r, c, t_len, n_rows, hidden,
                           st);
      break;
    case 16: e = run_bwd<16>(g, p, o, h, u, w, d, r, c, t_len, n_rows,
                             hidden, st);
      break;
    case 32: e = run_bwd<32>(g, p, o, h, u, w, d, r, c, t_len, n_rows,
                             hidden, st);
      break;
    default:
      e = run_bwd<64>(g, p, o, h, u, w, d, r, c, t_len, n_rows, hidden, st);
  }
  return static_cast<int>(e);
}

// The launch plan of both sweeps for N rows and H units, into out[10]:
// the row tile and the grid's y (row tiles); then for the forward and
// then the backward: the cluster size, the grid's x, the dynamic shared
// bytes of a block and the clusters the card holds at once. Returns a
// cudaError_t (0 = both fit).
int dl4j_gru_plan(int device, int n_rows, int hidden, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (row_tile(n_rows)) {
    case 8: e = plan<8>(n_rows, hidden, out); break;
    case 16: e = plan<16>(n_rows, hidden, out); break;
    case 32: e = plan<32>(n_rows, hidden, out); break;
    default: e = plan<64>(n_rows, hidden, out);
  }
  return static_cast<int>(e);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
