// LSTM / GravesLSTM recurrence for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/kernels/lstm_scan.py::_make_fwd_kernel (the
// Pallas TPU kernel launched by _lstm_pallas_fwd) and ::_make_bwd_kernel
// (launched by _lstm_pallas_bwd), the two halves of the custom VJP behind
// the public lstm_scan.lstm.
//
// Forward, one time step t, gate order i, f, g, o:
//   z   = xp_t + h_{t-1} . RW + b                      ([N, 4H])
//   i   = sigmoid(z_i + pI * c_{t-1})   f = sigmoid(z_f + pF * c_{t-1} + fb)
//   g   = tanh(z_g)                     c_t = f * c_{t-1} + i * g
//   o   = sigmoid(z_o + pO * c_t)       h_t = o * tanh(c_t)
// (the peephole terms only with Graves peepholes). Optionally it saves the
// post-activation gates [N, 4H] and c_t, the training workspace.
// Backward, reversed time: from the saved gates and cell states, the
// upstream dL/dh_t and the dh/dc carries it writes dz_t = dL/dz [N, 4H]
// and carries dh_{t-1} = gh_{t-1} + dz_t . RW^T and dc_{t-1}; after step 0
// the carries are the gradients of the initial state. The weight, bias,
// input and peephole gradients are products over all of dz, computed
// outside (dgrad here, wgrad as large GEMMs), as in the JAX package.
//
// What bounds it on the card: the recurrent products, 2 * N * H * 4H
// operations per step, 4.29 GFLOP per layer and direction at N = 32,
// T = 256, H = 256: 26 us as three TF32 passes at 495 TFLOP/s on the
// tensor cores, 64 us at 67 TFLOP/s on the CUDA cores, against ~13 us for
// the forward's bytes (~25 us with the workspace). Neither sets the time:
// the recurrence needs all of h_{t-1} before any column of step t, so the
// 256 steps are a dependent chain of latencies. On the resident route a
// step is the block's share of the product read from shared memory (its
// 128 KiB split slice at H = 256), the gate math and one exchange across
// the cluster, about 2.5 us on an H100 (PERF.md).
//
// Two routes, chosen by shape before launch in the C entry points (and
// reported by dl4j_lstm_plan): the resident route where the shared memory
// of a cluster holds RW, else the step route.
//
// Resident route (H <= 320 on an H100: Resident::fits). One persistent
// launch per call walks all T steps. A thread-block cluster of kCluster =
// 16 blocks owns one tile of kRows = 8 batch rows (grid: ceil(N / 8)
// clusters, which never talk to each other, so more clusters than the
// card holds run in waves); each block owns U = ceil(H / 16) hidden units
// and keeps its slice of RW, the 4U gate columns of its units over all H
// rows, in shared memory for the whole call: split once at load into the
// big and small TF32 halves of 3xTF32 (mma_tf32.cuh's split) and stored in
// mma.sync.m16n8k8 fragment order, so a lane reads its A fragment as two
// 16-byte loads. The products are float32-grade 3xTF32 with the batch rows
// on the n8 side (8 rows fill a tile), each warp loading a group of k8
// steps' operands before their products.
//   Forward step: each block's 8 warps (4 along the m16 tiles of its 4U
// columns x 2 along K) compute z^T = RW_slice^T . h_{t-1}^T, add the two
// halves in shared memory, and 8U threads run the gate math, keeping
// c_{t-1}, the peepholes and the bias in registers (xp_{t+1} is loaded one
// step ahead). The block sends its h_t into every member's receive buffer
// (an all-gather of 8 x H floats through distributed shared memory, in B
// fragment order) and writes hs, the workspace and c_T to global memory
// without waiting on them.
//   Backward step: the gate threads add the partial sums of dz_{t+1} .
// RW^T they received for their units in rank order (deterministic), form
// dh = gh + that, dz for their units' four gate columns and the dc carry
// (kept in registers), and write dz, split, into the block's B operand;
// the 8 warps compute the block's partial dz . RW^T over its own 4U
// columns for all H units from the same resident slice and send each
// unit's sums to the member that owns it (a reduce-scatter), then write
// dz to global memory. The T + 1-th product, dh0, is the loop's last
// iteration.
//   The exchanges need no cluster barrier a step: a block sends with
// st.async, which counts the bytes on the receiver's mbarrier, and a
// receiver waits for its own buffer only (below, "the cluster's
// exchanges"); every member owns U unit slots, sends and receives the same
// bytes every step, and so stays in step with the others. Every output
// element has one writer and there are no atomics.
//
// Step route (larger H, whose slice does not fit): each step is one
// kernel launch and the C entry points issue the T launches (T + 1
// backward) in a loop on one stream, RW staged from the L2 every step.
// Block layout (both directions): one block per (8 hidden units, 8 batch
// rows), 256 threads. Thread (s, r, u) takes row r, unit u and a quarter s
// of the reduction axis; the four quarters' partial sums meet in shared
// memory and one thread per (r, u) applies the gate math. Forward, a
// thread accumulates the four gate columns {u, H+u, 2H+u, 3H+u} of its
// row from one float4 of the gate-interleaved RW slice per k; backward it
// accumulates the dh of its (row, unit) from float4s of dz_{t+1} and of
// row u of RW. All arithmetic is float32 on the CUDA cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;
using tf32::Frag;

// -- the step route -----------------------------------------------------------

constexpr int kUnits = 8;   // hidden units per block (4 * kUnits gate columns)
constexpr int kRows = 8;    // batch rows per block
constexpr int kSplit = 4;   // threads sharing one (row, unit) reduction
constexpr int kPairs = kUnits * kRows;      // 64
constexpr int kThreads = kPairs * kSplit;   // 256
// Reduction values staged per shared-memory pass: forward k of H (the
// RW slice is 4 * kUnits wide), backward m of 4H (rows of dz and RW).
// Each pass is one round trip to L2 and two barriers on the step's
// critical path, so the chunks are as large as fits well under 48 KB.
constexpr int kChunkFwd = 128;
constexpr int kChunkBwd = 256;
constexpr int kPerThreadFwd = kChunkFwd / kSplit;  // 32
constexpr int kPerThreadBwd = kChunkBwd / kSplit;  // 64

static_assert(kPerThreadBwd % 4 == 0, "backward reads float4s of the chunk");

// Per-thread counts of the staging loads of one chunk: scalar loads of
// the forward's RW slice and h rows (any H), float4 loads of the
// backward's dz and RW rows (their row length 4H is a multiple of 4).
constexpr int kWLoadsFwd = kChunkFwd * 4 * kUnits / kThreads;   // 16
constexpr int kHLoadsFwd = kRows * kChunkFwd / kThreads;        // 4
constexpr int kVecsBwd = kRows * kChunkBwd / 4 / kThreads;      // 2

static_assert(kChunkFwd * 4 * kUnits % kThreads == 0, "whole loads");
static_assert(kRows * kChunkFwd % kThreads == 0, "whole loads");
static_assert(kRows == kUnits, "the backward stages as many dz as RW rows");
static_assert(kRows * kChunkBwd % (4 * kThreads) == 0, "whole float4s");

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// One forward step. Grid (ceil(H / kUnits), ceil(N / kRows)). c_prev and
// c_out may alias (the in-place cell state of a call without workspace):
// each element is read and then written by the same thread. A chunk's
// staging loads are issued together into registers before any is
// stored, and the gate math's operands are fetched before the reduction,
// so a step waits on about one L2 round trip per chunk.
__global__ void __launch_bounds__(kThreads) lstm_fwd_step_kernel(
    const float* __restrict__ xp, const float* __restrict__ rw,
    const float* __restrict__ bias, const float* __restrict__ peep,
    const float* __restrict__ h_prev, const float* c_prev,
    float* __restrict__ h_out, float* c_out, float* __restrict__ gates,
    int n_rows, int hidden, float forget_bias) {
  __shared__ __align__(16) float w_s[kChunkFwd][kUnits][4];
  __shared__ float h_s[kRows][kChunkFwd + 1];
  __shared__ float part[kSplit][kPairs][4];

  const int tid = threadIdx.x;
  const int s = tid / kPairs;
  const int p = tid % kPairs;
  const int r = p / kUnits;
  const int u = p % kUnits;
  const int u0 = blockIdx.x * kUnits;
  const int r0 = blockIdx.y * kRows;
  const int H = hidden;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int n = r0 + r;
  const int j = u0 + u;
  const bool owner = s == 0 && n < n_rows && j < H;  // applies the gates
  const size_t row4 = static_cast<size_t>(n) * H4;
  const size_t idx = static_cast<size_t>(n) * H + j;

  float pre[4] = {0.f, 0.f, 0.f, 0.f};  // xp + b of the four gates
  float cp = 0.f, p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if (owner) {
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] = xp[row4 + g * H + j];
#pragma unroll
    for (int g = 0; g < 4; ++g) pre[g] += bias[g * H + j];
    cp = c_prev[idx];
    if (peep != nullptr) {
      p_i = peep[j];
      p_f = peep[H + j];
      p_o = peep[2 * H + j];
    }
  }

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  for (int k0 = 0; k0 < H; k0 += kChunkFwd) {
    // RW[k0 + k, g * H + u0 + uu] -> w_s[k][uu][g]; consecutive threads
    // read consecutive units of one gate's columns
    float wv[kWLoadsFwd];
#pragma unroll
    for (int i = 0; i < kWLoadsFwd; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / (4 * kUnits);
      const int g = (e / kUnits) % 4;
      const int uu = e % kUnits;
      wv[i] = (k0 + k < H && u0 + uu < H)
                  ? rw[static_cast<size_t>(k0 + k) * H4 +
                       static_cast<size_t>(g) * H + u0 + uu]
                  : 0.f;
    }
    float hv[kHLoadsFwd];
#pragma unroll
    for (int i = 0; i < kHLoadsFwd; ++i) {
      const int e = tid + i * kThreads;
      const int rr = e / kChunkFwd;
      const int k = e % kChunkFwd;
      hv[i] = (r0 + rr < n_rows && k0 + k < H)
                  ? h_prev[static_cast<size_t>(r0 + rr) * H + k0 + k]
                  : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWLoadsFwd; ++i) {
      const int e = tid + i * kThreads;
      w_s[e / (4 * kUnits)][e % kUnits][(e / kUnits) % 4] = wv[i];
    }
#pragma unroll
    for (int i = 0; i < kHLoadsFwd; ++i) {
      const int e = tid + i * kThreads;
      h_s[e / kChunkFwd][e % kChunkFwd] = hv[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerThreadFwd; ++i) {
      const int k = s * kPerThreadFwd + i;
      const float h = h_s[r][k];
      const float4 w = *reinterpret_cast<const float4*>(&w_s[k][u][0]);
      acc0 = fmaf(h, w.x, acc0);
      acc1 = fmaf(h, w.y, acc1);
      acc2 = fmaf(h, w.z, acc2);
      acc3 = fmaf(h, w.w, acc3);
    }
    __syncthreads();
  }
  part[s][p][0] = acc0;
  part[s][p][1] = acc1;
  part[s][p][2] = acc2;
  part[s][p][3] = acc3;
  __syncthreads();
  if (!owner) return;

  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float sum = part[0][p][g];
#pragma unroll
    for (int q = 1; q < kSplit; ++q) sum += part[q][p][g];
    z[g] = sum;
  }
  // xp + b was summed before the reduction (the JAX kernel adds b last):
  // one float32 rounding apart
  float zi = pre[0] + z[0];
  float zf = pre[1] + z[1];
  const float zg = pre[2] + z[2];
  float zo = pre[3] + z[3];
  zi += p_i * cp;
  zf += p_f * cp;
  const float ig = sigmoid(zi);
  const float fg = sigmoid(zf + forget_bias);
  const float gg = tanhf(zg);
  const float c = fg * cp + ig * gg;
  zo += p_o * c;
  const float og = sigmoid(zo);
  h_out[idx] = og * tanhf(c);
  c_out[idx] = c;
  if (gates != nullptr) {
    gates[row4 + j] = ig;
    gates[row4 + H + j] = fg;
    gates[row4 + 2 * H + j] = gg;
    gates[row4 + 3 * H + j] = og;
  }
}

// One backward step, or (gates == nullptr) the final carry: dh_out =
// dz_next . RW^T. Grid as forward. dh_in = gh + dz_next . RW^T, where gh
// and dz_next may be null (no upstream gradient; the first reversed step).
// dc is the dc carry, updated in place element by element. dz_next and rw
// must be 16-byte aligned (float4 loads). As forward, the staging loads
// of a chunk are issued together and the gate-math operands early.
__global__ void __launch_bounds__(kThreads) lstm_bwd_step_kernel(
    const float* __restrict__ gates, const float* __restrict__ c_t,
    const float* __restrict__ c_prev, const float* __restrict__ gh,
    const float* __restrict__ dz_next, const float* __restrict__ rw,
    const float* __restrict__ peep, float* __restrict__ dz,
    float* __restrict__ dh_out, float* dc, int n_rows, int hidden) {
  __shared__ __align__(16) float dz_s[kRows][kChunkBwd + 4];
  __shared__ __align__(16) float w_s[kUnits][kChunkBwd + 4];
  __shared__ float part[kSplit][kPairs];

  const int tid = threadIdx.x;
  const int s = tid / kPairs;
  const int p = tid % kPairs;
  const int r = p / kUnits;
  const int u = p % kUnits;
  const int u0 = blockIdx.x * kUnits;
  const int r0 = blockIdx.y * kRows;
  const int H = hidden;
  const int M = 4 * H;
  const int n = r0 + r;
  const int j = u0 + u;
  const bool owner = s == 0 && n < n_rows && j < H;
  const size_t idx = static_cast<size_t>(n) * H + j;
  const size_t row4 = static_cast<size_t>(n) * M;

  float gate[4] = {0.f, 0.f, 0.f, 0.f};
  float ct = 0.f, cp = 0.f, g_h = 0.f, dc_in = 0.f;
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if (owner) {
    if (gh != nullptr) g_h = gh[idx];
    if (gates != nullptr) {
#pragma unroll
      for (int g = 0; g < 4; ++g) gate[g] = gates[row4 + g * H + j];
      ct = c_t[idx];
      cp = c_prev[idx];
      dc_in = dc[idx];
      if (peep != nullptr) {
        p_i = peep[j];
        p_f = peep[H + j];
        p_o = peep[2 * H + j];
      }
    }
  }

  float acc = 0.f;
  if (dz_next != nullptr) {  // uniform across the block
    for (int m0 = 0; m0 < M; m0 += kChunkBwd) {
      // rows r0.. of dz_next and u0.. of RW, m0..m0 + kChunkBwd; M is a
      // multiple of 4, so a float4 lies wholly inside or outside
      float4 dv[kVecsBwd], wv[kVecsBwd];
#pragma unroll
      for (int i = 0; i < kVecsBwd; ++i) {
        const int e = tid + i * kThreads;
        const int row = e / (kChunkBwd / 4);
        const int m = (e % (kChunkBwd / 4)) * 4;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        dv[i] = (r0 + row < n_rows && m0 + m < M)
                    ? *reinterpret_cast<const float4*>(
                          dz_next + static_cast<size_t>(r0 + row) * M +
                          m0 + m)
                    : zero;
        wv[i] = (u0 + row < H && m0 + m < M)
                    ? *reinterpret_cast<const float4*>(
                          rw + static_cast<size_t>(u0 + row) * M + m0 + m)
                    : zero;
      }
#pragma unroll
      for (int i = 0; i < kVecsBwd; ++i) {
        const int e = tid + i * kThreads;
        const int row = e / (kChunkBwd / 4);
        const int m = (e % (kChunkBwd / 4)) * 4;
        *reinterpret_cast<float4*>(&dz_s[row][m]) = dv[i];
        *reinterpret_cast<float4*>(&w_s[row][m]) = wv[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPerThreadBwd; i += 4) {
        const int m = s * kPerThreadBwd + i;
        const float4 a = *reinterpret_cast<const float4*>(&dz_s[r][m]);
        const float4 w = *reinterpret_cast<const float4*>(&w_s[u][m]);
        acc = fmaf(a.x, w.x, acc);
        acc = fmaf(a.y, w.y, acc);
        acc = fmaf(a.z, w.z, acc);
        acc = fmaf(a.w, w.w, acc);
      }
      __syncthreads();
    }
  }
  part[s][p] = acc;
  __syncthreads();
  if (!owner) return;

  float dh = part[0][p];
#pragma unroll
  for (int q = 1; q < kSplit; ++q) dh += part[q][p];
  dh = g_h + dh;
  if (gates == nullptr) {
    dh_out[idx] = dh;
    return;
  }
  const float ig = gate[0], fg = gate[1], gg = gate[2], og = gate[3];
  const float tc = tanhf(ct);
  const float dzo = dh * tc * og * (1.f - og);
  const float dcv = dc_in + dh * og * (1.f - tc * tc) + dzo * p_o;
  const float dzi = dcv * gg * ig * (1.f - ig);
  const float dzf = dcv * cp * fg * (1.f - fg);
  const float dzg = dcv * ig * (1.f - gg * gg);
  dz[row4 + j] = dzi;
  dz[row4 + H + j] = dzf;
  dz[row4 + 2 * H + j] = dzg;
  dz[row4 + 3 * H + j] = dzo;
  dc[idx] = dcv * fg + dzi * p_i + dzf * p_f;
}

// -- the resident route -------------------------------------------------------

constexpr int kCluster = 16;           // blocks of a cluster (non-portable)
constexpr int kWarps = kThreads / 32;  // 8
constexpr int kFwdWM = 4;  // forward warps along the m16 tiles of 4U columns
constexpr int kFwdWK = 2;  //   and along the k8 steps of H (two slabs)
constexpr int kFwdMT = 2;  // m16 tiles a forward warp takes at most
constexpr int kBwdMT = 3;  // m16 tiles (of H units) a backward warp takes
// k8 steps a warp loads at once before their products: forward 4 (the
// steps padded to groups of 4), backward 4 and a last 2 (padded to pairs)
constexpr int kFwdGroup = 4;
constexpr int kBwdGroup = 4;
// One m16k8 A fragment, split: 32 lanes x 4 big floats, then x 4 small.
constexpr int kFrag = 256;
// A block's shared memory on an H100 or H200 (227 KB, the opt-in most).
constexpr int kSmemLimit = 232448;

static_assert(kFwdWM * kFwdWK == kWarps, "every warp in the forward");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shapes and shared memory (floats) of the resident route for H units.
// Every member owns U unit slots, the last ones past H when 16U > H (their
// RW rows and columns are zero and their h is sent as 0): every member
// sends and receives the same bytes every step, which keeps the cluster
// in step (a member with nothing to receive would run ahead and write
// into buffers not yet read). Both sweeps start with two mbarriers (4
// floats). Forward: A = RW_slice^T, M the 4U gate columns (gate-major:
// column g * U + u is gate g of the block's unit u), K = 16U; the two
// receive buffers of h_{t-1} (8 rows x K, B fragment order); two slabs
// of partial sums [8 rows][M + 4]. Backward: A = RW_slice, M = H units, K
// the 4U columns; dz of the block's columns (B fragment order, big and
// small); two receive buffers [kCluster senders][U units][8 rows]. The k8 steps are padded with zeros to whole
// groups of the warps' loops: 4 forward, 2 backward.
struct Resident {
  int units, fwd_mt, fwd_ks, bwd_mt, bwd_ks;
  __host__ __device__ explicit Resident(int hidden)
      : units(cdiv(hidden, kCluster)),
        fwd_mt(cdiv(4 * units, 16)),
        fwd_ks(kFwdGroup * cdiv(2 * units, kFwdGroup)),
        bwd_mt(cdiv(hidden, 16)),
        bwd_ks(2 * cdiv(4 * units, 16)) {}
  __host__ __device__ int fwd_a() const { return fwd_mt * fwd_ks * kFrag; }
  __host__ __device__ int fwd_h() const { return 64 * fwd_ks; }  // a buffer
  __host__ __device__ int slab_stride() const { return 16 * fwd_mt + 4; }
  __host__ __device__ int fwd_slab() const { return kRows * slab_stride(); }
  __host__ __device__ int bwd_a() const { return bwd_mt * bwd_ks * kFrag; }
  __host__ __device__ int bwd_dz() const { return 128 * bwd_ks; }
  __host__ __device__ int bwd_recv() const {  // a buffer
    return kCluster * kRows * units;
  }
  size_t fwd_bytes() const {
    return sizeof(float) * (4 + fwd_a() + 2 * fwd_h() + kFwdWK * fwd_slab());
  }
  size_t bwd_bytes() const {
    return sizeof(float) * (4 + bwd_a() + bwd_dz() + 2 * bwd_recv());
  }
  // The route rule: both sweeps' shared memory within a block's, one gate
  // thread per (row, unit) and the warps' tiles within their registers.
  bool fits() const {
    return fwd_bytes() <= kSmemLimit && bwd_bytes() <= kSmemLimit &&
           kRows * units <= kThreads && fwd_mt <= kFwdWM * kFwdMT &&
           bwd_mt <= kWarps * kBwdMT;
  }
};

// Where x = A[m][k] (m < 16, k < 8 within its m16k8 tile) lies in the
// tile's fragment: lane (m % 8) * 4 + k % 4, register (k / 4) * 2 + m / 8
// (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)). The
// big half at [4 lane + register], the small one 128 floats on.
__device__ __forceinline__ void store_split(float* frag, int m, int k,
                                            float x) {
  const int at = 4 * ((m % 8) * 4 + k % 4) + (k / 4) * 2 + m / 8;
  uint32_t big, small;
  tf32::split(x, big, small);
  frag[at] = __uint_as_float(big);
  frag[at + 128] = __uint_as_float(small);
}

// The lane's A fragment of a split tile: two 16-byte loads.
__device__ __forceinline__ Frag<4> load_split(const float* frag) {
  const int l = threadIdx.x % 32;
  const float4 big = *reinterpret_cast<const float4*>(frag + 4 * l);
  const float4 small = *reinterpret_cast<const float4*>(frag + 128 + 4 * l);
  Frag<4> f;
  f.big[0] = __float_as_uint(big.x);
  f.big[1] = __float_as_uint(big.y);
  f.big[2] = __float_as_uint(big.z);
  f.big[3] = __float_as_uint(big.w);
  f.small[0] = __float_as_uint(small.x);
  f.small[1] = __float_as_uint(small.y);
  f.small[2] = __float_as_uint(small.z);
  f.small[3] = __float_as_uint(small.w);
  return f;
}

// Where B[k][n] (k < 8 of a k8 step, n < 8) lies in a buffer of B
// fragments, two floats a lane and step: lane n * 4 + k % 4, float k / 4.
__device__ __forceinline__ int b_pos(int ks, int n, int k) {
  return (ks * 32 + n * 4 + k % 4) * 2 + k / 4;
}

// A 3xTF32 product in three accumulators, one chain each: the cross terms
// into c1 and c2, big x big into d. The sum is d + (c1 + c2).
struct Acc {
  float d[4], c1[4], c2[4];
};

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.d[i] = a.c1[i] = a.c2[i] = 0.f;
}

__device__ __forceinline__ void mma3(Acc& acc, const Frag<4>& a,
                                     const Frag<2>& b) {
  tf32::mma(acc.c1, a.small, b.big);
  tf32::mma(acc.c2, a.big, b.small);
  tf32::mma(acc.d, a.big, b.big);
}

// Two accumulators (even and odd k8 steps of a warp) summed, element i.
__device__ __forceinline__ float total(const Acc& e, const Acc& o, int i) {
  return (e.d[i] + (e.c1[i] + e.c2[i])) + (o.d[i] + (o.c1[i] + o.c2[i]));
}

// -- the cluster's exchanges --
//
// Each block receives into double-buffered shared memory: the data of
// step t into buffer t % 2, whose mbarrier t % 2 completes a phase once
// its one local arrival, which announces the bytes the phase brings, and
// every sender's bytes have come. Senders write with st.async, whose
// completion counts its bytes on the receiver's mbarrier with release
// semantics at cluster scope; a receiver waits with acquire semantics and
// then reads. No cluster-wide barrier runs per step, and a receiver's
// wait needs none of the sender's other memory traffic (its global
// stores) to complete. A buffer is written again only two steps on: its
// senders have by then received what every receiver computed after
// reading it (the recurrence orders the reuse), so the double buffer
// needs no extra barrier. For the same reason a receiver arms a buffer's
// next phase (arrives with the bytes expected) as soon as its wait on the
// buffer ends, before it sends anything itself: no sender's bytes can
// reach a phase before the phase is armed.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared memory location in member `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float2 v,
                                         uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(mbar)
      : "memory");
}

// Thread 0 of each block initialises its two mbarriers (one arrival a
// phase); the cluster barrier after it makes them visible to the senders.
__device__ __forceinline__ void init_mbarriers(uint64_t* mbar) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(mbar + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Thread 0 arms the current phase of mbarrier `mbar`: its one arrival,
// announcing the bytes the phase brings.
__device__ __forceinline__ void arm(uint64_t* mbar, uint32_t bytes) {
  if (threadIdx.x == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(mbar)),
        "r"(bytes)
        : "memory");
}

// Waits until the phase of parity `parity` of mbarrier `mbar` completes.
__device__ __forceinline__ void wait_phase(uint64_t* mbar, uint32_t parity) {
  const uint32_t addr = smem_u32(mbar);
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// The whole cluster's barrier, twice a launch: at the start every member
// has started and armed its mbarriers before any writes to it; at the end
// none exits while another may still use its shared memory.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Every float of [p, p + n) zeroed, n a multiple of 4, p 16-byte aligned.
__device__ __forceinline__ void zero_floats(float* p, int n) {
  for (int e = threadIdx.x; e < n / 4; e += kThreads)
    reinterpret_cast<float4*>(p)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The units [j0, j0 + n) that member `rank` owns, n of U.
__device__ __forceinline__ int owned(int rank, int units, int hidden) {
  const int left = hidden - rank * units;
  return left < 0 ? 0 : left < units ? left : units;
}

// The forward sweep, one launch: grid kCluster * ceil(N / kRows) blocks in
// clusters of kCluster. Arguments as dl4j_lstm_fwd's.
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_persistent_kernel(
    const float* __restrict__ xp, const float* __restrict__ rw,
    const float* __restrict__ bias, const float* __restrict__ peep,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ hs, float* __restrict__ c_state,
    float* __restrict__ gates, float* __restrict__ cs, int t_len, int n_rows,
    int hidden, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Resident R(hidden);
  const int H = hidden, U = R.units, MT = R.fwd_mt, KS = R.fwd_ks;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int j0 = rank * U;
  const int uval = owned(rank, U, H);
  const int r0 = (blockIdx.x / kCluster) * kRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % kFwdWM, wk = warp / kFwdWM;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  float* a_s = smem + 4;
  float* hbuf = a_s + R.fwd_a();  // two buffers of R.fwd_h()
  float* slab = hbuf + 2 * R.fwd_h();
  const int S = R.slab_stride();
  // a buffer receives 8 rows x U floats from each member a step
  const uint32_t step_bytes = kCluster * kRows * U * 4;

  // The slice, split, in fragment order (zero past H and the block's
  // units), and h0 into receive buffer 0 (zero past N and H).
  zero_floats(a_s, R.fwd_a() + 2 * R.fwd_h());
  init_mbarriers(mbar);
  __syncthreads();
  const int cols = 4 * U;
  for (int e = tid; e < H * cols; e += kThreads) {
    const int k = e / cols, m = e % cols, g = m / U, u = m % U;
    if (u < uval)
      store_split(a_s + ((m / 16) * KS + k / 8) * kFrag, m % 16, k % 8,
                  rw[static_cast<size_t>(k) * H4 + static_cast<size_t>(g) * H +
                     j0 + u]);
  }
  for (int e = tid; e < kRows * H; e += kThreads) {
    const int n = e / H, k = e % H;
    if (r0 + n < n_rows)
      hbuf[b_pos(k / 8, n, k % 8)] = h0[static_cast<size_t>(r0 + n) * H + k];
  }

  // The gate thread of (row n, unit u): its cell state, peepholes, bias
  // and next xp in registers. Rows past N compute on zeros and are not
  // written out; their h stays in their own row of the product.
  const bool gate = tid < kRows * U;
  const int n = gate ? tid / U : 0, u = gate ? tid % U : 0;
  const int j = j0 + u;
  const bool mine = gate && u < uval;
  const bool active = mine && r0 + n < n_rows;
  const size_t idx = static_cast<size_t>(r0 + n) * H + j;  // [N, H]
  const size_t nh = static_cast<size_t>(n_rows) * H;
  const int pos = b_pos(j / 8, n, j % 8);  // of h[n][j] in a buffer
  float c = 0.f, p_i = 0.f, p_f = 0.f, p_o = 0.f, b[4] = {0.f, 0.f, 0.f, 0.f};
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    c = c0[idx];
    if (peep != nullptr) {
      p_i = peep[j];
      p_f = peep[H + j];
      p_o = peep[2 * H + j];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      b[g] = bias[g * H + j];
      x[g] = xp[static_cast<size_t>(r0 + n) * H4 + g * H + j];
    }
  }
  // the first phases: step 1's data in buffer 1, step 2's in buffer 0
  if (t_len > 1) arm(mbar + 1, step_bytes);
  if (t_len > 2) arm(mbar, step_bytes);
  cluster_sync_all();

  for (int t = 0; t < t_len; ++t) {
    const float* h_in = hbuf + (t % 2) * R.fwd_h();
    float x_next[4] = {0.f, 0.f, 0.f, 0.f};
    if (active && t + 1 < t_len) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x_next[g] = xp[(t + 1) * 4 * nh + static_cast<size_t>(r0 + n) * H4 +
                       g * H + j];
    }
    // h_{t-1} from every member: the phase (t - 1) / 2 of buffer t % 2;
    // then the buffer's next phase, step t + 2's, is armed
    if (t > 0) {
      wait_phase(mbar + t % 2, ((t - 1) >> 1) & 1);
      if (t + 2 < t_len) arm(mbar + t % 2, step_bytes);
    }

    // z^T [the warp's m16 tiles][8 rows] over the warp's groups of
    // kFwdGroup k8 steps (wk, wk + 2, ...): each group's operands loaded
    // before its products
    Acc acc[kFwdMT][2];
#pragma unroll
    for (int i = 0; i < kFwdMT; ++i) {
      zero(acc[i][0]);
      zero(acc[i][1]);
    }
    for (int ks0 = kFwdGroup * wk; ks0 < KS; ks0 += kFwdGroup * kFwdWK) {
      float2 hv[kFwdGroup];
#pragma unroll
      for (int q = 0; q < kFwdGroup; ++q)
        hv[q] = *reinterpret_cast<const float2*>(h_in +
                                                 ((ks0 + q) * 32 + lane) * 2);
      Frag<4> af[kFwdMT][kFwdGroup];
#pragma unroll
      for (int i = 0; i < kFwdMT; ++i) {
        if (wm + kFwdWM * i < MT) {
#pragma unroll
          for (int q = 0; q < kFwdGroup; ++q)
            af[i][q] = load_split(a_s + ((wm + kFwdWM * i) * KS + ks0 + q) *
                                            kFrag);
        }
      }
#pragma unroll
      for (int q = 0; q < kFwdGroup; ++q) {
        Frag<2> bf;
        tf32::split(hv[q].x, bf.big[0], bf.small[0]);
        tf32::split(hv[q].y, bf.big[1], bf.small[1]);
#pragma unroll
        for (int i = 0; i < kFwdMT; ++i)
          if (wm + kFwdWM * i < MT) mma3(acc[i][q % 2], af[i][q], bf);
      }
    }
    // slab wk [row][column]: rows 2t, 2t + 1, columns 16 mt + g (+ 8)
    {
      const int g = lane / 4, tq = lane % 4;
      float* sl = slab + wk * R.fwd_slab();
#pragma unroll
      for (int i = 0; i < kFwdMT; ++i) {
        const int mt = wm + kFwdWM * i;
        if (mt < MT) {
          const int m = 16 * mt + g;
          sl[(2 * tq) * S + m] = total(acc[i][0], acc[i][1], 0);
          sl[(2 * tq + 1) * S + m] = total(acc[i][0], acc[i][1], 1);
          sl[(2 * tq) * S + m + 8] = total(acc[i][0], acc[i][1], 2);
          sl[(2 * tq + 1) * S + m + 8] = total(acc[i][0], acc[i][1], 3);
        }
      }
    }
    __syncthreads();

    const bool send = t + 1 < t_len;
    float* h_out = hbuf + ((t + 1) % 2) * R.fwd_h();
    const uint32_t mb_out = smem_u32(mbar + (t + 1) % 2);
    float h = 0.f, ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f;
    if (gate) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int m = g * U + u;
        z[g] = slab[n * S + m] + slab[R.fwd_slab() + n * S + m];
      }
      // the JAX kernel's order: (xp + h.RW) + b
      float zi = (x[0] + z[0]) + b[0];
      float zf = (x[1] + z[1]) + b[1];
      const float zg = (x[2] + z[2]) + b[2];
      float zo = (x[3] + z[3]) + b[3];
      zi += p_i * c;
      zf += p_f * c;
      ig = sigmoid(zi);
      fg = sigmoid(zf + forget_bias);
      gg = tanhf(zg);
      c = fg * c + ig * gg;
      zo += p_o * c;
      og = sigmoid(zo);
      h = og * tanhf(c);
      if (send) {  // h_t[n][j] into every member's buffer (t + 1) % 2
        const float hv = mine ? h : 0.f;  // 0 in the slots past H
        const uint32_t at = smem_u32(h_out + pos);
#pragma unroll 4
        for (int r = 0; r < kCluster; ++r)
          st_async(map_rank(at, r), hv, map_rank(mb_out, r));
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = x_next[g];
    }
    // every read of the slabs is done before the next step's products
    // write them
    __syncthreads();
    if (active) {
      hs[t * nh + idx] = h;
      if (gates != nullptr) {
        float* gt = gates + t * 4 * nh + static_cast<size_t>(r0 + n) * H4;
        gt[j] = ig;
        gt[H + j] = fg;
        gt[2 * H + j] = gg;
        gt[3 * H + j] = og;
        cs[t * nh + idx] = c;
      }
    }
  }
  if (active && c_state != nullptr) c_state[idx] = c;
  // every member is done with the cluster's shared memory before any exits
  cluster_sync_all();
}

// The backward sweep, one launch: grid and clusters as forward. Arguments
// as dl4j_lstm_bwd's.
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_persistent_kernel(
    const float* __restrict__ gates, const float* __restrict__ cs,
    const float* __restrict__ c0, const float* __restrict__ gh,
    const float* __restrict__ rw, const float* __restrict__ peep,
    float* __restrict__ dxp, float* __restrict__ dh0, float* __restrict__ dc,
    int t_len, int n_rows, int hidden) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const Resident R(hidden);
  const int H = hidden, U = R.units, MT = R.bwd_mt, KS = R.bwd_ks;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int j0 = rank * U;
  const int uval = owned(rank, U, H);
  const int r0 = (blockIdx.x / kCluster) * kRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  float* a_s = smem + 4;
  float* dzb = a_s + R.bwd_a();
  float* recv = dzb + R.bwd_dz();  // two buffers of R.bwd_recv()
  // every member sends its sums of this member's U unit slots, all 8
  // rows (those past H zero)
  const uint32_t step_bytes = kCluster * kRows * U * 4;

  // The slice, split, in fragment order: A[m][k] = RW[m][column k of the
  // block], zero past H and the block's units; dz's padding stays zero.
  zero_floats(a_s, R.bwd_a() + R.bwd_dz());
  init_mbarriers(mbar);
  __syncthreads();
  const int cols = 4 * U;
  for (int e = tid; e < H * cols; e += kThreads) {
    const int m = e / cols, k = e % cols, g = k / U, u = k % U;
    if (u < uval)
      store_split(a_s + ((m / 16) * KS + k / 8) * kFrag, m % 16, k % 8,
                  rw[static_cast<size_t>(m) * H4 + static_cast<size_t>(g) * H +
                     j0 + u]);
  }

  const bool gate = tid < kRows * U;
  const int n = gate ? tid / U : 0, u = gate ? tid % U : 0;
  const int j = j0 + u;
  const bool mine = gate && u < uval;  // a column of this block
  const bool active = mine && r0 + n < n_rows;
  const size_t idx = static_cast<size_t>(r0 + n) * H + j;
  const size_t nh = static_cast<size_t>(n_rows) * H;
  // step t's operands: the gates, c_t, c_{t-1}, dL/dh_t; loaded a step
  // ahead. Rows past N read 0, so their dz is 0.
  float gt[4] = {0.f, 0.f, 0.f, 0.f}, ct = 0.f, cp = 0.f, g_h = 0.f;
  auto load = [&](int t, float (&gv)[4], float& c_t, float& c_p, float& gh_t) {
    if (!active) return;
    const float* grow = gates + t * 4 * nh + static_cast<size_t>(r0 + n) * H4;
#pragma unroll
    for (int g = 0; g < 4; ++g) gv[g] = grow[g * H + j];
    c_t = cs[t * nh + idx];
    c_p = t > 0 ? cs[(t - 1) * nh + idx] : c0[idx];
    gh_t = gh[t * nh + idx];
  };
  load(t_len - 1, gt, ct, cp, g_h);
  float dcv = active ? dc[idx] : 0.f;
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if (active && peep != nullptr) {
    p_i = peep[j];
    p_f = peep[H + j];
    p_o = peep[2 * H + j];
  }
  // the first phases: the sums of step T - 1's dz and of step T - 2's
  arm(mbar + (t_len - 1) % 2, step_bytes);
  if (t_len > 1) arm(mbar + (t_len - 2) % 2, step_bytes);
  cluster_sync_all();

  // the sums of step s's dz come into buffer s % 2, in the phase
  // ((T - 1) - s) / 2 of its mbarrier; then the buffer's next phase, step
  // s - 2's, is armed
  auto sums_of = [&](int s) {
    wait_phase(mbar + s % 2, (((t_len - 1) - s) >> 1) & 1);
    if (s >= 2) arm(mbar + s % 2, step_bytes);
    return recv + (s % 2) * R.bwd_recv() + u * kRows + n;
  };
  const int g8 = lane / 4, tq = lane % 4;
  for (int t = t_len - 1; t >= 0; --t) {
    float gt_n[4] = {0.f, 0.f, 0.f, 0.f}, ct_n = 0.f, cp_n = 0.f, gh_n = 0.f;
    if (t > 0) load(t - 1, gt_n, ct_n, cp_n, gh_n);
    float carry = 0.f;  // dz_{t+1} . RW^T, the senders' sums in rank order
    if (t + 1 < t_len) {
      const float* in = sums_of(t + 1);
      if (gate) {
        carry = in[0];
#pragma unroll
        for (int r = 1; r < kCluster; ++r) carry += in[r * U * kRows];
      }
    }
    float dzv[4] = {0.f, 0.f, 0.f, 0.f};
    if (gate) {
      const float dh = g_h + carry;
      const float ig = gt[0], fg = gt[1], gg = gt[2], og = gt[3];
      const float tc = tanhf(ct);
      const float dzo = dh * tc * og * (1.f - og);
      const float dcs = dcv + dh * og * (1.f - tc * tc) + dzo * p_o;
      const float dzi = dcs * gg * ig * (1.f - ig);
      const float dzf = dcs * cp * fg * (1.f - fg);
      const float dzg = dcs * ig * (1.f - gg * gg);
      dcv = dcs * fg + dzi * p_i + dzf * p_f;
      dzv[0] = dzi;
      dzv[1] = dzf;
      dzv[2] = dzg;
      dzv[3] = dzo;
      if (mine) {
        // B[k][n] = dz[n][k] for the block's column k = g U + u: big at
        // float k % 8 / 4 of the lane's four, small two on
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int k = g * U + u;
          const int at = 2 * b_pos(k / 8, n, k % 8) - (k % 8) / 4;
          uint32_t big, small;
          tf32::split(dzv[g], big, small);
          dzb[at] = __uint_as_float(big);
          dzb[at + 2] = __uint_as_float(small);
        }
      }
    }
    __syncthreads();

    // the block's partial dz . RW^T for units of m16 tiles warp, warp + 8..,
    // over groups of kBwdGroup k8 steps and a last pair, each group's
    // operands loaded before its products
    Acc acc[kBwdMT][2];
#pragma unroll
    for (int i = 0; i < kBwdMT; ++i) {
      zero(acc[i][0]);
      zero(acc[i][1]);
    }
    auto group = [&](int ks0, auto width) {
      constexpr int G = decltype(width)::value;
      float4 v[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        v[q] = *reinterpret_cast<const float4*>(dzb +
                                                ((ks0 + q) * 32 + lane) * 4);
      Frag<4> af[kBwdMT][G];
#pragma unroll
      for (int i = 0; i < kBwdMT; ++i) {
        if (warp + kWarps * i < MT) {
#pragma unroll
          for (int q = 0; q < G; ++q)
            af[i][q] = load_split(a_s + ((warp + kWarps * i) * KS + ks0 + q) *
                                            kFrag);
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        Frag<2> bf;
        bf.big[0] = __float_as_uint(v[q].x);
        bf.big[1] = __float_as_uint(v[q].y);
        bf.small[0] = __float_as_uint(v[q].z);
        bf.small[1] = __float_as_uint(v[q].w);
#pragma unroll
        for (int i = 0; i < kBwdMT; ++i)
          if (warp + kWarps * i < MT) mma3(acc[i][q % 2], af[i][q], bf);
      }
    };
    int ks0 = 0;
    for (; ks0 + kBwdGroup <= KS; ks0 += kBwdGroup)
      group(ks0, std::integral_constant<int, kBwdGroup>{});
    if (ks0 < KS) group(ks0, std::integral_constant<int, 2>{});
    // each unit's sums (rows 2 tq, 2 tq + 1) to its owner's buffer t % 2,
    // at [this rank][unit][row]; the slots past H (16U = 16 MT units) carry
    // zeros, so every member receives the same bytes
    {
      const uint32_t dst = smem_u32(recv + (t % 2) * R.bwd_recv() +
                                    rank * U * kRows + 2 * tq);
      const uint32_t mb = smem_u32(mbar + t % 2);
#pragma unroll
      for (int i = 0; i < kBwdMT; ++i) {
        const int mt = warp + kWarps * i;
        if (mt < MT) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = 16 * mt + g8 + 8 * half, owner = m / U;
            st_async(map_rank(dst + 4 * (m - owner * U) * kRows, owner),
                     make_float2(total(acc[i][0], acc[i][1], 2 * half),
                                 total(acc[i][0], acc[i][1], 2 * half + 1)),
                     map_rank(mb, owner));
          }
        }
      }
    }
    // every read of dz is done before the next step writes it
    __syncthreads();
    if (active) {
      float* drow = dxp + t * 4 * nh + static_cast<size_t>(r0 + n) * H4;
#pragma unroll
      for (int g = 0; g < 4; ++g) drow[g * H + j] = dzv[g];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) gt[g] = gt_n[g];
    ct = ct_n;
    cp = cp_n;
    g_h = gh_n;
  }
  // dz_0 . RW^T: the gradient of h0
  const float* in = sums_of(0);
  if (active) {
    float s = in[0];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) s += in[r * U * kRows];
    dh0[idx] = s;
    dc[idx] = dcv;
  }
  // every member is done with the cluster's shared memory before any exits
  cluster_sync_all();
}

dim3 step_grid(int n_rows, int hidden) {
  return dim3((hidden + kUnits - 1) / kUnits, (n_rows + kRows - 1) / kRows);
}

// The step route's T forward launches.
cudaError_t run_fwd_steps(const float* xp, const float* rw, const float* bias,
                          const float* peep, const float* h0, const float* c0,
                          float* hs, float* cstate, float* gf, float* csf,
                          int t_len, int n_rows, int hidden, float forget_bias,
                          cudaStream_t st) {
  const dim3 grid = step_grid(n_rows, hidden);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  for (int t = 0; t < t_len; ++t) {
    const float* h_prev = t == 0 ? h0 : hs + (t - 1) * nh;
    const float* c_prev = t == 0 ? c0
                          : csf != nullptr ? csf + (t - 1) * nh
                                           : cstate;
    float* c_out = csf != nullptr ? csf + t * nh : cstate;
    lstm_fwd_step_kernel<<<grid, kThreads, 0, st>>>(
        xp + t * 4 * nh, rw, bias, peep, h_prev, c_prev, hs + t * nh, c_out,
        gf != nullptr ? gf + t * 4 * nh : nullptr, n_rows, hidden,
        forget_bias);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The step route's T + 1 backward launches.
cudaError_t run_bwd_steps(const float* gf, const float* csf, const float* c0,
                          const float* ghf, const float* rwf, const float* pf,
                          float* dzf, float* dh0, float* dcf, int t_len,
                          int n_rows, int hidden, cudaStream_t st) {
  const dim3 grid = step_grid(n_rows, hidden);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  for (int t = t_len - 1; t >= 0; --t) {
    const float* c_prev = t == 0 ? c0 : csf + (t - 1) * nh;
    const float* dz_next = t == t_len - 1 ? nullptr : dzf + (t + 1) * 4 * nh;
    lstm_bwd_step_kernel<<<grid, kThreads, 0, st>>>(
        gf + t * 4 * nh, csf + t * nh, c_prev, ghf + t * nh, dz_next, rwf, pf,
        dzf + t * 4 * nh, nullptr, dcf, n_rows, hidden);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  lstm_bwd_step_kernel<<<grid, kThreads, 0, st>>>(
      nullptr, nullptr, nullptr, nullptr, dzf, rwf, nullptr, nullptr, dh0,
      nullptr, n_rows, hidden);
  return cudaGetLastError();
}

// A launch of a persistent kernel in clusters of kCluster blocks, one
// cluster for every kRows batch rows.
struct Launch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;  // points at attr: not copied
  Launch(const Launch&) = delete;
  Launch(int n_rows, size_t smem, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(kCluster * cdiv(n_rows, kRows));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Allows the kernel clusters of 16 and a block's most shared memory on
// the current device, once per device; with `active`, also asks how many
// of its clusters of `smem` bytes a block the card holds at once, none
// being an error (the card cannot run the plan).
template <auto kernel>
cudaError_t prepare(int n_rows, size_t smem, int* active) {
  static unsigned prepared = 0;  // a bit per device, for this kernel
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if ((__atomic_load_n(&prepared, __ATOMIC_ACQUIRE) & bit) == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    if (e != cudaSuccess) return e;
    __atomic_fetch_or(&prepared, bit, __ATOMIC_RELEASE);
  }
  if (active == nullptr) return cudaSuccess;
  const Launch l(n_rows, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kernel), &l.cfg);
  if (e != cudaSuccess) return e;
  *active = n;
  return n < 1 ? cudaErrorLaunchOutOfResources : cudaSuccess;
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), const Launch& l,
                   Args... args) {
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward over T steps, all float32 and contiguous. xp [T, N, 4H] (the
// input projection x . W, time-major), rw [H, 4H], bias [4H], peep [3, H]
// or null, h0 and c0 [N, H]. Writes hs [T, N, H]; with the workspace
// (gates and cs non-null) gates [T, N, 4H] and cs [T, N, H], without it
// the final cell state in c_state [N, H]. One launch on the resident
// route, T on the step route. Returns the cudaError_t of the first failed
// launch (0 = all launched).
int dl4j_lstm_fwd(int device, const void* xp, const void* rw,
                  const void* bias, const void* peep, const void* h0,
                  const void* c0, void* hs, void* c_state, void* gates,
                  void* cs, int t_len, int n_rows, int hidden,
                  float forget_bias, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((gates == nullptr) != (cs == nullptr) ||
      (cs == nullptr && c_state == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(xp);
  const float* w = static_cast<const float*>(rw);
  const float* b = static_cast<const float*>(bias);
  const float* p = static_cast<const float*>(peep);
  const float* h = static_cast<const float*>(h0);
  const float* c = static_cast<const float*>(c0);
  float* o = static_cast<float*>(hs);
  float* g = static_cast<float*>(gates);
  float* s = static_cast<float*>(cs);
  // the cell state without the workspace: the step route keeps it in
  // c_state from step to step, the resident route writes c_T there
  float* cst = s == nullptr ? static_cast<float*>(c_state) : nullptr;
  const Resident r(hidden);
  if (!r.fits())
    return static_cast<int>(run_fwd_steps(a, w, b, p, h, c, o, cst, g, s,
                                          t_len, n_rows, hidden, forget_bias,
                                          st));
  e = prepare<lstm_fwd_persistent_kernel>(n_rows, r.fwd_bytes(), nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Launch l(n_rows, r.fwd_bytes(), st);
  return static_cast<int>(launch(lstm_fwd_persistent_kernel, l, a, w, b, p,
                                 h, c, o, cst, g, s, t_len, n_rows, hidden,
                                 forget_bias));
}

// Backward over T steps, reversed, all float32 and contiguous: gates
// [T, N, 4H] and cs [T, N, H] from the forward's workspace, c0 [N, H], gh
// [T, N, H] the upstream dL/dh_t (dL/dh_T folded into the last step), rw
// [H, 4H], peep [3, H] or null. dc [N, H] holds dL/dc_T on entry and the
// gradient of c0 on return; dxp [T, N, 4H] receives dz, dh0 [N, H] the
// gradient of h0. One launch on the resident route, T + 1 on the step
// route (where rw must be 16-byte aligned).
int dl4j_lstm_bwd(int device, const void* gates, const void* cs,
                  const void* c0, const void* gh, const void* rw,
                  const void* peep, void* dxp, void* dh0, void* dc,
                  int t_len, int n_rows, int hidden, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* s = static_cast<const float*>(cs);
  const float* c = static_cast<const float*>(c0);
  const float* u = static_cast<const float*>(gh);
  const float* w = static_cast<const float*>(rw);
  const float* p = static_cast<const float*>(peep);
  float* d = static_cast<float*>(dxp);
  float* h = static_cast<float*>(dh0);
  float* dcf = static_cast<float*>(dc);
  const Resident r(hidden);
  if (!r.fits())
    return static_cast<int>(run_bwd_steps(g, s, c, u, w, p, d, h, dcf, t_len,
                                          n_rows, hidden, st));
  e = prepare<lstm_bwd_persistent_kernel>(n_rows, r.bwd_bytes(), nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Launch l(n_rows, r.bwd_bytes(), st);
  return static_cast<int>(launch(lstm_bwd_persistent_kernel, l, g, s, c, u,
                                 w, p, d, h, dcf, t_len, n_rows, hidden));
}

// The launch plan of both sweeps for N rows and H units, into out[9]: the
// route (1 resident, 0 step), the cluster size, the row tile, the units a
// block owns, the blocks of a launch; then for the forward and then the
// backward the dynamic shared bytes of a block and the clusters the card
// holds at once (0 on the step route, which has no clusters). Returns a
// cudaError_t: 0, or why the card cannot hold the resident route's plan.
int dl4j_lstm_plan(int device, int n_rows, int hidden, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Resident r(hidden);
  const bool resident = r.fits();
  const dim3 steps = step_grid(n_rows, hidden);
  out[0] = resident ? 1 : 0;
  out[1] = resident ? kCluster : 1;
  out[2] = kRows;
  out[3] = resident ? r.units : kUnits;
  out[4] = resident ? kCluster * cdiv(n_rows, kRows)
                    : static_cast<int>(steps.x * steps.y);
  out[5] = resident ? static_cast<int>(r.fwd_bytes()) : 0;
  out[6] = 0;
  out[7] = resident ? static_cast<int>(r.bwd_bytes()) : 0;
  out[8] = 0;
  if (!resident) return 0;
  e = prepare<lstm_fwd_persistent_kernel>(n_rows, r.fwd_bytes(), &out[6]);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      prepare<lstm_bwd_persistent_kernel>(n_rows, r.bwd_bytes(), &out[8]));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
