// Bitmap gradient encode for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces: deeplearning4j_tpu/kernels/bitmap_pack.py::_kernel (the Pallas
// TPU kernel launched by bitmap_encode), the fused half of the libnd4j
// encode_bitmap codec.
//
// For each element g (read as float32 whatever its stored type): code 1
// if g >= thr, 2 if g <= -thr, else 0; 16 codes go into one int32 word,
// code i at bits 2i (code 2 in slot 15 sets the sign bit); the residual
// g - sent (sent = +thr, -thr or 0) is computed in float32 and stored in
// g's type (float32, or bfloat16 rounded to nearest even). Elements past
// n in the last word encode as 0.
//
// One thread per packed word: it reads its 16 contiguous elements once
// (four float4 loads for float32, two 16-byte loads for bfloat16, when
// the word is whole and aligned; element loads for the ragged last
// word) and writes the word and the 16 residuals the same way. Nothing is
// shared between threads, so there is one writer per output and no
// ordering. What bounds it on the card: bytes, 2 * 4n + n / 4 for float32
// (g read once, residual and words written once), 0.27 ms at 3.35 TB/s for
// BERT-base's 110 M parameters; the operations (a few per element) are
// far below the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bitmap_pack_kernel(
    const T* __restrict__ g, int32_t* __restrict__ packed,
    T* __restrict__ resid, int64_t n, float thr) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_words = (n + 15) / 16;
  if (w >= n_words) return;
  const int64_t base = w * 16;
  // whole 16-element words take 16-byte vector loads and stores when both
  // arrays are 16-byte aligned (then so is every word: 16 elements of 2
  // or 4 bytes are 32 or 64 bytes)
  const bool vec = base + 16 <= n &&
                   (reinterpret_cast<uintptr_t>(g) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(resid) % 16) == 0;
  constexpr int kPer16B = 16 / sizeof(T);
  alignas(16) T in[16];
  if (vec) {
#pragma unroll
    for (int v = 0; v < 16 / kPer16B; ++v)
      *reinterpret_cast<uint4*>(&in[v * kPer16B]) =
          *reinterpret_cast<const uint4*>(g + base + v * kPer16B);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      in[i] = base + i < n ? g[base + i] : from_f32<T>(0.f);
  }
  uint32_t word = 0;
  alignas(16) T out[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float x = to_f32(in[i]);
    const uint32_t code = base + i >= n ? 0u : x >= thr ? 1u
                          : x <= -thr ? 2u : 0u;
    const float sent = code == 1u ? thr : code == 2u ? -thr : 0.f;
    word |= code << (2 * i);
    out[i] = from_f32<T>(x - sent);
  }
  packed[w] = static_cast<int32_t>(word);
  if (vec) {
#pragma unroll
    for (int v = 0; v < 16 / kPer16B; ++v)
      *reinterpret_cast<uint4*>(resid + base + v * kPer16B) =
          *reinterpret_cast<const uint4*>(&out[v * kPer16B]);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (base + i < n) resid[base + i] = out[i];
  }
}

template <typename T>
cudaError_t launch(const void* g, void* packed, void* resid, int64_t n,
                   float thr, cudaStream_t st) {
  const int64_t n_words = (n + 15) / 16;
  const unsigned blocks =
      static_cast<unsigned>((n_words + kThreads - 1) / kThreads);
  bitmap_pack_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<int32_t*>(packed),
      static_cast<T*>(resid), n, thr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g [n] contiguous, of the type `dtype` names (0 float32, 1 bfloat16);
// packed int32 [ceil(n / 16)]; resid [n] of g's type.
// Returns the launch's cudaError_t (0 = launched).
int dl4j_bitmap_encode(int device, const void* g, void* packed, void* resid,
                       int64_t n, float threshold, int dtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: e = launch<float>(g, packed, resid, n, threshold, st); break;
    case 1:
      e = launch<__nv_bfloat16>(g, packed, resid, n, threshold, st);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
