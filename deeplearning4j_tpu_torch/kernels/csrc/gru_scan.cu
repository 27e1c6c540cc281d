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
// (T + 1 backward) in a loop on one stream: one call per layer. RW (12 MiB
// at H = 1024) cannot sit in shared memory; it stays in the 50 MB L2.
//
// Block layout (both directions): one block per (8 hidden units, a tile of
// up to 64 batch rows), 256 threads; the row tile is 8, 16, 32 or 64 rows,
// the least that covers min(N, 64), so a small serving batch does not pay
// for 64 rows. A block reads its RW slice (every row of the slice once per
// step, whatever N is up to 64) and the rows' h_{t-1} (forward) or
// [dz, r * dn_pre]_{t+1} (backward) into shared memory in passes of 64
// reduction values, copied by cp.async into a ring of 4 (forward) or 6
// (backward) passes in flight, each block starting at its own offset along
// the reduction axis. A thread accumulates a register tile: forward 4 rows
// x the 3 gate columns of one unit (12 sums from two float4 shared loads
// per k), backward 4 rows x 4 units (16 sums from two float4 loads per m);
// the threads left over split the reduction axis, and the split's partial
// sums meet in shared memory in a fixed order. Every output element has
// one writer and there are no atomics, so results are deterministic. All
// arithmetic is float32.
//
// What bounds it on the card: the recurrent products, 2 * N * H * 3H
// operations per step, 403 MFLOP at N = 64, H = 1024, 6.0 us at 67 TFLOP/s
// on the CUDA cores (0.60 ms for T = 100). The bytes from device memory
// (xp, the workspace, RW once) are a fraction of that. The sweeps run at
// 6x (forward) and 12x (backward) that bound on an H100 (PERF.md): one
// block of 8 warps per SM, two shared loads per 12 or 16 FMAs, and the
// launch gap of each dependent step. Larger register tiles, and a
// persistent or cluster kernel that keeps RW on chip across steps, are the
// later redesign.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kUnits = 8;      // hidden units per block
constexpr int kThreads = 256;
constexpr int kChunk = 64;     // reduction values staged per pass
constexpr int kStagesFwd = 4;  // passes in flight (cp.async ring)
constexpr int kStagesBwd = 6;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// cp.async of one float from global to shared memory; a copy that is not
// `valid` reads nothing and writes 0 (src-size 0). `src` must be a valid
// address either way.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory floats of the forward kernel for a row tile of 4 * RG
// rows: kStagesFwd passes of (the RW slice [kChunk][kUnits][4], h
// [kChunk][rows + 4]), then the split's partial sums.
template <int RG>
__host__ __device__ constexpr int fwd_stage_floats() {
  return kChunk * kUnits * 4 + kChunk * (4 * RG + 4);
}
template <int RG>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         (kStagesFwd * fwd_stage_floats<RG>() +
          (kThreads / (kUnits * RG)) * (4 * RG) * kUnits * 3);
}

// One forward step for a row tile of 4 * RG rows. Grid (ceil(H / kUnits),
// ceil(N / (4 * RG))). Thread (s, rg, u): unit u, rows 4rg..4rg+3 of the
// tile, split s of each pass's kChunk reduction values. Passes are loaded
// by cp.async kStagesFwd - 1 ahead of the one being summed, and each block
// starts its passes at its own offset along H, so the blocks do not all
// read the same rows of h_{t-1} at the same moment.
template <int RG>
__global__ void __launch_bounds__(kThreads) gru_fwd_step_kernel(
    const float* __restrict__ xp, const float* __restrict__ rw,
    const float* __restrict__ bias, const float* __restrict__ h_prev,
    float* __restrict__ h_out, float* __restrict__ gates,
    float* __restrict__ hpn, int n_rows, int hidden) {
  constexpr int kRows = 4 * RG;
  constexpr int kSplit = kThreads / (kUnits * RG);
  constexpr int kPerSplit = kChunk / kSplit;
  constexpr int kWLoads = kChunk * 3 * kUnits / kThreads;  // 6
  constexpr int kHLoads = kRows * kChunk / kThreads;       // RG
  constexpr int kStage = fwd_stage_floats<RG>();
  static_assert(kChunk % kSplit == 0, "whole splits");
  static_assert(kChunk * 3 * kUnits % kThreads == 0, "whole loads");
  static_assert(kRows * kChunk % kThreads == 0, "whole loads");

  extern __shared__ __align__(16) float smem[];
  float (*part)[kRows][kUnits][3] =
      reinterpret_cast<float (*)[kRows][kUnits][3]>(smem +
                                                    kStagesFwd * kStage);

  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rg = (tid / kUnits) % RG;
  const int s = tid / (kUnits * RG);
  const int u0 = blockIdx.x * kUnits;
  const int r0 = blockIdx.y * kRows;
  const int H = hidden;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int n_chunks = (H + kChunk - 1) / kChunk;
  const int first = blockIdx.x % n_chunks;

  // queue pass c (of n_chunks, in this block's order) into ring slot
  // c % kStagesFwd; always commits a group, empty past the last pass
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int k0 = ((first + c) % n_chunks) * kChunk;
      float* w_s = smem + (c % kStagesFwd) * kStage;
      float* h_s = w_s + kChunk * kUnits * 4;
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int e = tid + i * kThreads;
        const int k = e / (3 * kUnits);
        const int g = (e / kUnits) % 3;
        const int uu = e % kUnits;
        const bool ok = k0 + k < H && u0 + uu < H;
        cp_async_f32(&w_s[(k * kUnits + uu) * 4 + g],
                     ok ? rw + static_cast<size_t>(k0 + k) * H3 +
                              static_cast<size_t>(g) * H + u0 + uu
                        : rw,
                     ok);
      }
#pragma unroll
      for (int i = 0; i < kHLoads; ++i) {
        const int e = tid + i * kThreads;
        const int rr = e / kChunk;
        const int k = e % kChunk;
        const bool ok = r0 + rr < n_rows && k0 + k < H;
        cp_async_f32(&h_s[k * (kRows + 4) + rr],
                     ok ? h_prev + static_cast<size_t>(r0 + rr) * H + k0 + k
                        : h_prev,
                     ok);
      }
    }
    cp_async_commit();
  };

  float acc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 3; ++g) acc[i][g] = 0.f;

#pragma unroll
  for (int c = 0; c < kStagesFwd - 1; ++c) issue(c);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStagesFwd - 2>();  // this thread's copies of pass c
    // every thread's copies of pass c have landed, and every thread is
    // done with pass c - 1, whose slot the next issue refills
    __syncthreads();
    issue(c + kStagesFwd - 1);
    const float* w_s = smem + (c % kStagesFwd) * kStage;
    const float* h_s = w_s + kChunk * kUnits * 4;
#pragma unroll
    for (int kk = 0; kk < kPerSplit; ++kk) {
      const int k = s * kPerSplit + kk;
      const float4 h4 =
          *reinterpret_cast<const float4*>(&h_s[k * (kRows + 4) + 4 * rg]);
      const float4 w4 =
          *reinterpret_cast<const float4*>(&w_s[(k * kUnits + u) * 4]);
      const float hr[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(hr[i], w4.x, acc[i][0]);
        acc[i][1] = fmaf(hr[i], w4.y, acc[i][1]);
        acc[i][2] = fmaf(hr[i], w4.z, acc[i][2]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 3; ++g) part[s][4 * rg + i][u][g] = acc[i][g];
  __syncthreads();

  for (int o = tid; o < kRows * kUnits; o += kThreads) {
    const int rr = o / kUnits;
    const int uu = o % kUnits;
    const int n = r0 + rr;
    const int j = u0 + uu;
    if (n >= n_rows || j >= H) continue;
    float p[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float sum = part[0][rr][uu][g];
#pragma unroll
      for (int q = 1; q < kSplit; ++q) sum += part[q][rr][uu][g];
      p[g] = sum;
    }
    const size_t row3 = static_cast<size_t>(n) * H3;
    const size_t idx = static_cast<size_t>(n) * H + j;
    // the JAX kernel's order: (xp + h.RW) + b
    const float r = sigmoid((xp[row3 + j] + p[0]) + bias[j]);
    const float z = sigmoid((xp[row3 + H + j] + p[1]) + bias[H + j]);
    const float nn = tanhf((xp[row3 + 2 * H + j] + r * p[2]) + bias[2 * H + j]);
    h_out[idx] = (1.f - z) * nn + z * h_prev[idx];
    if (gates != nullptr) {
      gates[row3 + j] = r;
      gates[row3 + H + j] = z;
      gates[row3 + 2 * H + j] = nn;
      hpn[idx] = p[2];
    }
  }
}

// Shared-memory floats of the backward kernel: kStagesBwd passes of (the
// carry operand [kChunk][rows + 4], RW rows [kChunk][kUnits]), then the
// split's partial sums.
template <int RG>
__host__ __device__ constexpr int bwd_stage_floats() {
  return kChunk * (4 * RG + 4) + kChunk * kUnits;
}
template <int RG>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (kStagesBwd * bwd_stage_floats<RG>() +
                          (kThreads / (2 * RG)) * (4 * RG) * kUnits);
}

// One backward step, or (gates == nullptr) the final carry. Grid as
// forward. dot = [dz_next[:, :2H], rotn_next] . RW^T over the 3H columns
// (0 when dz_next is null: the first reversed step); carry = dhz + dot;
// the final launch writes dhz = carry (dL/dh0) and stops. Otherwise
// dh_total = gh + carry, the gate gradients go to dz, r * dn_pre to rotn
// (the next launch's rotated n-columns), and dhz becomes dh_total * z.
// dhz is read and written in place by the same thread, element by
// element. Thread (s, rg, ug): units 4ug..4ug+3, rows 4rg..4rg+3. Passes
// are loaded as in the forward, kStagesBwd - 1 ahead, from a per-block
// offset along 3H.
template <int RG>
__global__ void __launch_bounds__(kThreads) gru_bwd_step_kernel(
    const float* __restrict__ gates, const float* __restrict__ hpn,
    const float* __restrict__ h_prev, const float* __restrict__ gh,
    const float* __restrict__ dz_next, const float* __restrict__ rotn_next,
    const float* __restrict__ rw, float* __restrict__ dz,
    float* __restrict__ rotn, float* dhz, int n_rows, int hidden) {
  constexpr int kRows = 4 * RG;
  constexpr int kSplit = kThreads / (2 * RG);
  constexpr int kPerSplit = kChunk / kSplit;
  constexpr int kZLoads = kRows * kChunk / kThreads;       // RG
  constexpr int kWLoads = kUnits * kChunk / kThreads;      // 2
  constexpr int kStage = bwd_stage_floats<RG>();
  static_assert(kChunk % kSplit == 0, "whole splits");
  static_assert(kUnits == 8, "two float4 unit groups");

  extern __shared__ __align__(16) float smem[];
  float (*part)[kRows][kUnits] = reinterpret_cast<float (*)[kRows][kUnits]>(
      smem + kStagesBwd * kStage);

  const int tid = threadIdx.x;
  const int ug = tid % 2;
  const int rg = (tid / 2) % RG;
  const int s = tid / (2 * RG);
  const int u0 = blockIdx.x * kUnits;
  const int r0 = blockIdx.y * kRows;
  const int H = hidden;
  const int M = 3 * H;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  if (dz_next != nullptr) {  // uniform across the grid
    const int n_chunks = (M + kChunk - 1) / kChunk;
    const int first = blockIdx.x % n_chunks;
    auto issue = [&](int c) {
      if (c < n_chunks) {
        const int m0 = ((first + c) % n_chunks) * kChunk;
        float* z_s = smem + (c % kStagesBwd) * kStage;
        float* w_s = z_s + kChunk * (kRows + 4);
#pragma unroll
        for (int i = 0; i < kZLoads; ++i) {
          const int e = tid + i * kThreads;
          const int rr = e / kChunk;
          const int m = m0 + e % kChunk;
          const int n = r0 + rr;
          const bool ok = n < n_rows && m < M;
          const float* src =
              !ok ? dz_next
              : m < 2 * H
                  ? dz_next + static_cast<size_t>(n) * M + m
                  : rotn_next + static_cast<size_t>(n) * H + m - 2 * H;
          cp_async_f32(&z_s[(e % kChunk) * (kRows + 4) + rr], src, ok);
        }
#pragma unroll
        for (int i = 0; i < kWLoads; ++i) {
          const int e = tid + i * kThreads;
          const int uu = e / kChunk;
          const int m = m0 + e % kChunk;
          const bool ok = u0 + uu < H && m < M;
          cp_async_f32(&w_s[(e % kChunk) * kUnits + uu],
                       ok ? rw + static_cast<size_t>(u0 + uu) * M + m : rw,
                       ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int c = 0; c < kStagesBwd - 1; ++c) issue(c);
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kStagesBwd - 2>();
      __syncthreads();
      issue(c + kStagesBwd - 1);
      const float* z_s = smem + (c % kStagesBwd) * kStage;
      const float* w_s = z_s + kChunk * (kRows + 4);
#pragma unroll
      for (int mm = 0; mm < kPerSplit; ++mm) {
        const int m = s * kPerSplit + mm;
        const float4 a =
            *reinterpret_cast<const float4*>(&z_s[m * (kRows + 4) + 4 * rg]);
        const float4 w =
            *reinterpret_cast<const float4*>(&w_s[m * kUnits + 4 * ug]);
        const float ar[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(ar[i], w.x, acc[i][0]);
          acc[i][1] = fmaf(ar[i], w.y, acc[i][1]);
          acc[i][2] = fmaf(ar[i], w.z, acc[i][2]);
          acc[i][3] = fmaf(ar[i], w.w, acc[i][3]);
        }
      }
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[s][4 * rg + i][4 * ug + q] = acc[i][q];
  __syncthreads();

  for (int o = tid; o < kRows * kUnits; o += kThreads) {
    const int rr = o / kUnits;
    const int uu = o % kUnits;
    const int n = r0 + rr;
    const int j = u0 + uu;
    if (n >= n_rows || j >= H) continue;
    float dot = part[0][rr][uu];
#pragma unroll
    for (int q = 1; q < kSplit; ++q) dot += part[q][rr][uu];
    const size_t idx = static_cast<size_t>(n) * H + j;
    const float carry = dhz[idx] + dot;
    if (gates == nullptr) {
      dhz[idx] = carry;
      continue;
    }
    const size_t row3 = static_cast<size_t>(n) * M;
    const float r = gates[row3 + j];
    const float z = gates[row3 + H + j];
    const float nn = gates[row3 + 2 * H + j];
    const float dh_total = gh[idx] + carry;
    const float dn = dh_total * (1.f - z);
    const float dzv = dh_total * (h_prev[idx] - nn);
    const float dn_pre = dn * (1.f - nn * nn);
    const float dr = dn_pre * hpn[idx];
    const float dr_pre = dr * r * (1.f - r);
    const float dz_pre = dzv * z * (1.f - z);
    dz[row3 + j] = dr_pre;
    dz[row3 + H + j] = dz_pre;
    dz[row3 + 2 * H + j] = dn_pre;
    rotn[idx] = r * dn_pre;
    dhz[idx] = dh_total * z;
  }
}

// The row-tile parameter RG (4 * RG rows) for N rows: the least tile that
// covers min(N, 64).
int row_groups(int n_rows) {
  return n_rows <= 8 ? 2 : n_rows <= 16 ? 4 : n_rows <= 32 ? 8 : 16;
}

dim3 step_grid(int n_rows, int hidden, int rg) {
  return dim3((hidden + kUnits - 1) / kUnits,
              (n_rows + 4 * rg - 1) / (4 * rg));
}

template <int RG>
cudaError_t run_fwd(const float* xp, const float* rw, const float* bias,
                    const float* h0, float* hs, float* gates, float* hpn,
                    int t_len, int n_rows, int hidden, cudaStream_t st) {
  const dim3 grid = step_grid(n_rows, hidden, RG);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  constexpr size_t smem = fwd_smem_bytes<RG>();
  cudaError_t e = cudaFuncSetAttribute(
      gru_fwd_step_kernel<RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  for (int t = 0; t < t_len; ++t) {
    gru_fwd_step_kernel<RG><<<grid, kThreads, smem, st>>>(
        xp + t * 3 * nh, rw, bias, t == 0 ? h0 : hs + (t - 1) * nh,
        hs + t * nh, gates != nullptr ? gates + t * 3 * nh : nullptr,
        hpn != nullptr ? hpn + t * nh : nullptr, n_rows, hidden);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int RG>
cudaError_t run_bwd(const float* gates, const float* hpn, const float* hs,
                    const float* h0, const float* gh, const float* rw,
                    float* dxp, float* rotn, float* dh, int t_len,
                    int n_rows, int hidden, cudaStream_t st) {
  const dim3 grid = step_grid(n_rows, hidden, RG);
  const size_t nh = static_cast<size_t>(n_rows) * hidden;
  constexpr size_t smem = bwd_smem_bytes<RG>();
  cudaError_t e = cudaFuncSetAttribute(
      gru_bwd_step_kernel<RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  for (int t = t_len - 1; t >= 0; --t) {
    const bool last = t == t_len - 1;
    // rotn ping-pongs between two [N, H] halves: step t writes half t % 2
    // while its blocks read half (t + 1) % 2, written by step t + 1
    gru_bwd_step_kernel<RG><<<grid, kThreads, smem, st>>>(
        gates + t * 3 * nh, hpn + t * nh, t == 0 ? h0 : hs + (t - 1) * nh,
        gh + t * nh, last ? nullptr : dxp + (t + 1) * 3 * nh,
        last ? nullptr : rotn + ((t + 1) % 2) * nh, rw, dxp + t * 3 * nh,
        rotn + (t % 2) * nh, dh, n_rows, hidden);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  gru_bwd_step_kernel<RG><<<grid, kThreads, smem, st>>>(
      nullptr, nullptr, nullptr, nullptr, dxp, rotn, rw, nullptr, nullptr,
      dh, n_rows, hidden);
  return cudaGetLastError();
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
  switch (row_groups(n_rows)) {
    case 2: e = run_fwd<2>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
      break;
    case 4: e = run_fwd<4>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
      break;
    case 8: e = run_fwd<8>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
      break;
    default:
      e = run_fwd<16>(a, w, b, h, o, g, p, t_len, n_rows, hidden, st);
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
  switch (row_groups(n_rows)) {
    case 2: e = run_bwd<2>(g, p, o, h, u, w, d, r, c, t_len, n_rows, hidden,
                           st);
      break;
    case 4: e = run_bwd<4>(g, p, o, h, u, w, d, r, c, t_len, n_rows, hidden,
                           st);
      break;
    case 8: e = run_bwd<8>(g, p, o, h, u, w, d, r, c, t_len, n_rows, hidden,
                           st);
      break;
    default:
      e = run_bwd<16>(g, p, o, h, u, w, d, r, c, t_len, n_rows, hidden, st);
  }
  return static_cast<int>(e);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
