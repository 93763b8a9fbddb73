// RMSNorm backward: (x, scale, dy) -> (dx, dscale).
//
// The backward of kernel #10 (rmsnorm.cu).  The reference has no backward
// kernel: it trains through the jnp `rmsnorm` of src/repro/models/modules.py
// under jax.grad, so this kernel replaces no Pallas kernel; it exists so
// that training on the card runs the same norm kernel as serving, behind
// `RMSNorm` (kernels/rmsnorm.py).  With r = rsqrt(mean(x^2) + eps)
// recomputed from x as the forward computes it, and g = scale * dy,
//   dx     = r * g - x * r^3 * mean(x * g)      (float32, stored in x's type)
//   dscale = sum over rows of dy * x * r        (float32, stored in scale's type)
//
// What bounds it on an H100: bytes: x and dy read, dx written, a few
// operations an element.
//
// What the design does about it:
// * Launch 1: a fixed grid of blocks (4 an SM, at most one a row) walks the
//   rows; a block reduces sum(x^2) and sum(x * g) of a row in one pass
//   (fixed order: a thread's columns, then shuffles, then the warps in
//   turn), writes dx in a second pass over the row (from L1/L2), and keeps
//   its share of dscale, dy * x * r summed over its rows, in shared memory,
//   one float a column, each owned by one thread.  The block stores its
//   partial row at the end.
// * Launch 2: one thread a column adds the partial rows in block order.
//   No atomics: dscale is the same on every run of the same shapes.
// Coalesced scalar reads (thread t takes columns t, t + 256, ...), so any D
// and any alignment of x and dy; 16-byte vectors are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_bwd_rows(const T* __restrict__ x, const S* __restrict__ scale,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                     long long rows, int d, float eps) {
  extern __shared__ float acc[];  // (d,): this block's dscale partial
  __shared__ float red[32];
  for (int c = threadIdx.x; c < d; c += THREADS) acc[c] = 0.0f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.0f, xg = 0.0f;
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float xv = repro_f32(xr[c]);
      ss += xv * xv;
      xg += xv * (repro_f32(scale[c]) * repro_f32(gr[c]));
    }
    ss = repro_block_sum(ss, red);
    xg = repro_block_sum(xg, red);
    const float r = rsqrtf(ss / (float)d + eps);  // as the forward computes it
    const float coef = r * r * r * (xg / (float)d);
    T* out = dx + row * d;
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float xv = repro_f32(xr[c]), gv = repro_f32(gr[c]);
      out[c] = repro_from_f32<T>(r * (repro_f32(scale[c]) * gv) - xv * coef);
      acc[c] += gv * xv * r;
    }
  }
  float* pr = partial + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += THREADS) pr[c] = acc[c];
}

template <typename S>
__global__ void rmsnorm_bwd_reduce(const float* __restrict__ partial, S* __restrict__ dscale,
                                   int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float v = 0.0f;
  for (int b = 0; b < blocks; ++b) v += partial[(long long)b * d + c];
  dscale[c] = repro_from_f32<S>(v);
}

int grid_of(long long rows) {
  const long long g = (long long)repro_sm_count() * BLOCKS_PER_SM;
  return (int)(rows < g ? rows : g);
}

template <typename T, typename S>
int launch(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
           void* partial, long long rows, int d, float eps, cudaStream_t stream) {
  const int grid = grid_of(rows);
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(rmsnorm_bwd_rows<T, S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rmsnorm_bwd_rows<T, S><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const S*)scale, (const T*)dy, (T*)dx, (float*)partial, rows, d, eps);
  REPRO_LAUNCH_CHECK();
  rmsnorm_bwd_reduce<S><<<repro_blocks(d, THREADS), THREADS, 0, stream>>>(
      (const float*)partial, (S*)dscale, grid, d);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// Rows of scratch (each d floats) that repro_rmsnorm_bwd needs for `rows` rows.
long long repro_rmsnorm_bwd_blocks(long long rows) { return rows > 0 ? grid_of(rows) : 0; }

// x, dy, dx: (rows, d) of dtype code x_dtype; scale, dscale: (d,) of dtype
// code s_dtype; partial: repro_rmsnorm_bwd_blocks(rows) x d float32 scratch.
// Any alignment; d * 4 bytes must fit a block's shared memory (d <= 56,000).
// Two launches on `stream`.  Returns 0 or the CUDA error of a launch.
int repro_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                      void* partial, long long rows, int d, int x_dtype, int s_dtype, float eps,
                      void* stream) {
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == REPRO_F32 && s_dtype == REPRO_F32)
    return launch<float, float>(x, scale, dy, dx, dscale, partial, rows, d, eps, s);
  if (x_dtype == REPRO_F32 && s_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows, d, eps, s);
  if (x_dtype == REPRO_BF16 && s_dtype == REPRO_F32)
    return launch<__nv_bfloat16, float>(x, scale, dy, dx, dscale, partial, rows, d, eps, s);
  if (x_dtype == REPRO_BF16 && s_dtype == REPRO_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, dy, dx, dscale, partial, rows, d, eps,
                                                s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
