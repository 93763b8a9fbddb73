// RMSNorm over the last dimension: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/rmsnorm.py
// (called from `rmsnorm`, kernel #10).  x (R, D) float32 or bfloat16,
// scale (D,) float32 or bfloat16 (read as float32, as the reference does);
// the arithmetic is float32 and the result is stored in x's type.
//
// What bounds it on an H100: bytes.  It reads x and scale once and writes
// the output once, with a handful of operations per element.
//
// What the design does about it: one block per row (a grid-stride loop
// over rows), consecutive threads on consecutive elements, so both passes
// over the row are coalesced; the second pass finds the row in L1/L2.  The
// TPU kernel padded R up to its row block; here a block owns whole rows, so
// any R runs with no padding and rows past R are never touched.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, typename S>
__global__ void rmsnorm(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ out, long long rows, int d, float eps) {
  __shared__ float red[32];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * d;
    T* orow = out + r * d;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = repro_f32(xr[i]);
      ss += v * v;  // x*x then a float32 sum, as mean(x * x) (no contraction)
    }
    ss = repro_block_sum(ss, red);
    const float rinv = rsqrtf(ss / (float)d + eps);
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      orow[i] = repro_from_f32<T>(repro_f32(xr[i]) * rinv * repro_f32(scale[i]));
    }
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows, int d, float eps,
           cudaStream_t stream) {
  const unsigned int grid = (unsigned int)(rows < (1LL << 30) ? rows : (1LL << 30));
  rmsnorm<T, S><<<grid, THREADS, 0, stream>>>((const T*)x, (const S*)scale, (T*)out,
                                              rows, d, eps);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// x, out: (rows, d) of dtype code x_dtype; scale: (d,) of dtype code
// s_dtype (REPRO_F32 or REPRO_BF16).  Returns 0 or the CUDA error of the
// launch (cudaErrorInvalidValue for an unknown dtype code).
int repro_rmsnorm(const void* x, const void* scale, void* out, long long rows, int d,
                  int x_dtype, int s_dtype, float eps, void* stream) {
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == REPRO_F32 && s_dtype == REPRO_F32)
    return launch<float, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == REPRO_F32 && s_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  if (x_dtype == REPRO_BF16 && s_dtype == REPRO_F32)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == REPRO_BF16 && s_dtype == REPRO_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
