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
// The recurrence needs all of h_{t-1} before any column of step t, so each
// step is one kernel launch and the C entry points below issue the T
// launches (T + 1 backward) in a loop on one stream: one call per layer
// and direction. Unlike the TPU kernel, which keeps RW resident in VMEM,
// RW (1 MiB in float32 at H = 256) cannot sit in one SM's 227 KB of shared
// memory; it stays in the 50 MB L2 between steps and each block stages its
// slice through shared memory.
//
// Block layout (both directions): one block per (8 hidden units, 8 batch
// rows), 256 threads. Thread (s, r, u) takes row r, unit u and a quarter s
// of the reduction axis; the four quarters' partial sums meet in shared
// memory and one thread per (r, u) applies the gate math. Forward, a
// thread accumulates the four gate columns {u, H+u, 2H+u, 3H+u} of its
// row from one float4 of the gate-interleaved RW slice per k; backward it
// accumulates the dh of its (row, unit) from float4s of dz_{t+1} and of
// row u of RW. Every output element has one writer and there are no
// atomics, so results are deterministic. All arithmetic is float32.
//
// What bounds it on the card: the recurrent products, 2 * N * H * 4H
// operations per step, 4.29 GFLOP per layer and direction at N = 32,
// T = 256, H = 256, 64 us at 67 TFLOP/s on the CUDA cores, against ~13 us
// for the forward's bytes (~25 us with the workspace). Neither is what
// sets this kernel's time: each of the 256 dependent steps is a launch of
// 128 blocks whose work is a few microseconds of latency (the L2 reads of
// the RW slice and h_{t-1}, two barriers). A persistent kernel that keeps
// RW on chip across a cluster's shared memory and syncs per step is the
// later redesign.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

dim3 step_grid(int n_rows, int hidden) {
  return dim3((hidden + kUnits - 1) / kUnits, (n_rows + kRows - 1) / kRows);
}

}  // namespace

extern "C" {

// Forward over T steps, all float32 and contiguous. xp [T, N, 4H] (the
// input projection x . W, time-major), rw [H, 4H], bias [4H], peep [3, H]
// or null, h0 and c0 [N, H]. Writes hs [T, N, H]; with the workspace
// (gates and cs non-null) gates [T, N, 4H] and cs [T, N, H], without it
// the running cell state in c_state [N, H] (c_T at the end). Returns the
// cudaError_t of the first failed launch (0 = all T launched).
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
  const dim3 grid = step_grid(n_rows, hidden);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  const float* xpf = static_cast<const float*>(xp);
  float* hsf = static_cast<float*>(hs);
  float* csf = static_cast<float*>(cs);
  float* gf = static_cast<float*>(gates);
  float* cstate = static_cast<float*>(c_state);
  for (int t = 0; t < t_len; ++t) {
    const float* h_prev =
        t == 0 ? static_cast<const float*>(h0) : hsf + (t - 1) * nh;
    const float* c_prev = t == 0 ? static_cast<const float*>(c0)
                          : csf != nullptr ? csf + (t - 1) * nh
                                           : cstate;
    float* c_out = csf != nullptr ? csf + t * nh : cstate;
    lstm_fwd_step_kernel<<<grid, kThreads, 0, st>>>(
        xpf + t * 4 * nh, static_cast<const float*>(rw),
        static_cast<const float*>(bias), static_cast<const float*>(peep),
        h_prev, c_prev, hsf + t * nh, c_out,
        gf != nullptr ? gf + t * 4 * nh : nullptr, n_rows, hidden,
        forget_bias);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Backward over T steps, reversed, all float32 and contiguous: gates
// [T, N, 4H] and cs [T, N, H] from the forward's workspace, c0 [N, H], gh
// [T, N, H] the upstream dL/dh_t (dL/dh_T folded into the last step), rw
// [H, 4H], peep [3, H] or null. dc [N, H] holds dL/dc_T on entry and the
// gradient of c0 on return; dxp [T, N, 4H] receives dz, dh0 [N, H] the
// gradient of h0. T + 1 launches.
int dl4j_lstm_bwd(int device, const void* gates, const void* cs,
                  const void* c0, const void* gh, const void* rw,
                  const void* peep, void* dxp, void* dh0, void* dc,
                  int t_len, int n_rows, int hidden, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = step_grid(n_rows, hidden);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  const float* gf = static_cast<const float*>(gates);
  const float* csf = static_cast<const float*>(cs);
  const float* ghf = static_cast<const float*>(gh);
  const float* rwf = static_cast<const float*>(rw);
  const float* pf = static_cast<const float*>(peep);
  float* dzf = static_cast<float*>(dxp);
  float* dcf = static_cast<float*>(dc);
  for (int t = t_len - 1; t >= 0; --t) {
    const float* c_prev =
        t == 0 ? static_cast<const float*>(c0) : csf + (t - 1) * nh;
    const float* dz_next = t == t_len - 1 ? nullptr : dzf + (t + 1) * 4 * nh;
    lstm_bwd_step_kernel<<<grid, kThreads, 0, st>>>(
        gf + t * 4 * nh, csf + t * nh, c_prev, ghf + t * nh, dz_next, rwf, pf,
        dzf + t * 4 * nh, nullptr, dcf, n_rows, hidden);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lstm_bwd_step_kernel<<<grid, kThreads, 0, st>>>(
      nullptr, nullptr, nullptr, nullptr, dzf, rwf, nullptr, nullptr,
      static_cast<float*>(dh0), nullptr, n_rows, hidden);
  return static_cast<int>(cudaGetLastError());
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
