// Shared helpers of the repro_torch kernels (plain C interface, no torch headers).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Return the launch error (as a nonzero int) from the enclosing C entry
// point right after a launch; the Python wrapper raises on it.
#define REPRO_LAUNCH_CHECK()                       \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

static inline unsigned int repro_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// Helpers of the attention and norm kernels (#8-#10): the element type
// crosses the C interface as a dtype code, and every kernel computes in
// float32 whatever it stores.
// ---------------------------------------------------------------------------
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

// The reference's masked logit: finite, so exp(NEG - NEG) = 1 when a whole
// run of keys is masked, as in the Pallas kernels (never -inf, which gives NaN).
constexpr float REPRO_NEG = -1e30f;

__device__ __forceinline__ float repro_f32(float v) { return v; }
__device__ __forceinline__ float repro_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T repro_from_f32(float v);
template <> __device__ __forceinline__ float repro_from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 repro_from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the reference's `p.astype(v.dtype)` before P.V.
template <typename T> __device__ __forceinline__ float repro_round_to(float v) {
  return repro_f32(repro_from_f32<T>(v));
}

__device__ __forceinline__ float repro_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float repro_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) of v over the block; every thread gets the result.  `red`
// holds 32 floats of shared memory; the trailing barrier lets the caller
// reuse it at once.
__device__ __forceinline__ float repro_block_sum(float v, float* red) {
  v = repro_warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float repro_block_max(float v, float* red) {
  v = repro_warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}
