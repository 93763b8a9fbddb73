// RMSNorm over the last dimension: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/rmsnorm.py
// (called from `rmsnorm`, kernel #10).  x (R, D) float32 or bfloat16,
// scale (D,) float32 or bfloat16 (read as float32, as the reference does);
// the arithmetic is float32 (x*x, then a float32 sum; no contraction, the
// library is built with --fmad=false) and the result is stored in x's type.
//
// What bounds it on an H100: bytes.  It reads x and scale once and writes
// the output once, with a handful of operations per element.
//
// What the design does about it:
// * A group of 32-256 threads owns a row, sized from D so that each thread
//   holds 2-8 sixteen-byte vectors of it (4 floats or 8 bfloat16 each): the
//   row is read once, with 16-byte loads, into registers, its sum of
//   squares reduced with shuffles (and, for a group of several warps, one
//   barrier through a double-buffered slot in shared memory), and the
//   output written from the registers with 16-byte stores.  At D = 2048,
//   f32 rows take 256 threads of 8 floats, bf16 rows 128 threads of 16.
// * A persistent grid, a few blocks per SM, walks the rows; each block
//   loads the scale entries of its threads once, into registers.
// * A row that cannot be read in 16-byte vectors (D not a multiple of the
//   vector width, a base off 16-byte alignment: a contiguous view may start
//   at any element, or D past the largest group) takes the scalar path: one
//   block per row, two coalesced passes.  Neither path reads past a row.
// The TPU kernel padded R up to its row block; here rows are owned whole,
// so any R runs with no padding and rows past R are never touched.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads: the SM's limit

// 16 bytes of x as floats, and back.
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The vector path: TPR threads per row, VPT vectors of VEC elements each;
// vector i of thread t holds columns (i * TPR + t) * VEC ...  Needs d a
// multiple of VEC, d <= TPR * VPT * VEC, and x and out 16-byte aligned.
template <typename T, typename S, int TPR, int VPT>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_vec(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                long long rows, int d, float eps) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int GROUPS = THREADS / TPR;  // rows a block holds at once
  constexpr int WARPS = TPR / 32;        // warps of a row
  __shared__ float red[2][THREADS / 32];
  const int t = threadIdx.x % TPR, grp = threadIdx.x / TPR, warp = threadIdx.x / 32;
  float sc[VPT][VEC];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = (i * TPR + t) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) sc[i][e] = col < d ? repro_f32(scale[col + e]) : 0.0f;
  }
  // Row r0 + grp is in registers while the next one loads: the loads of
  // a row are in flight through the reduction and the stores of the last.
  auto load_row = [&](long long r, float (&v)[VPT][VEC]) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * TPR + t) * VEC;
      if (r < rows && col < d) load16(x + r * d + col, v[i]);
    }
  };
  const long long stride = (long long)gridDim.x * GROUPS;
  float v[VPT][VEC], next[VPT][VEC];
  long long r0 = (long long)blockIdx.x * GROUPS;
  load_row(r0 + grp, v);
  for (int parity = 0; r0 < rows; r0 += stride, parity ^= 1) {
    const long long r = r0 + grp;
    if (r0 + stride < rows) load_row(r + stride, next);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * TPR + t) * VEC;
      if (r < rows && col < d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += v[i][e] * v[i][e];  // x*x, then a float32 sum
      }
    }
    ss = repro_warp_sum(ss);
    if (WARPS > 1) {
      if ((threadIdx.x & 31) == 0) red[parity][warp] = ss;
      __syncthreads();  // one barrier a row: the slot alternates, so no second one
      ss = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) ss += red[parity][grp * WARPS + w];
    }
    const float rinv = rsqrtf(ss / (float)d + eps);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * TPR + t) * VEC;
      if (r < rows && col < d) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = v[i][e] * rinv * sc[i][e];
        store16(out + r * d + col, o);
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = next[i][e];
  }
}

// The scalar path: one block per row (a grid-stride loop over rows),
// consecutive threads on consecutive elements; the second pass finds the
// row in L1/L2.
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                 long long rows, int d, float eps) {
  __shared__ float red[32];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * d;
    T* orow = out + r * d;
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = repro_f32(xr[i]);
      ss += v * v;
    }
    ss = repro_block_sum(ss, red);
    const float rinv = rsqrtf(ss / (float)d + eps);
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      orow[i] = repro_from_f32<T>(repro_f32(xr[i]) * rinv * repro_f32(scale[i]));
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

template <typename T, typename S, int TPR, int VPT>
int launch_vec(const void* x, const void* scale, void* out, long long rows, int d, float eps,
               cudaStream_t stream) {
  constexpr int GROUPS = THREADS / TPR;
  const long long need = (rows + GROUPS - 1) / GROUPS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  rmsnorm_vec<T, S, TPR, VPT><<<(unsigned int)(need < cap ? need : cap), THREADS, 0, stream>>>(
      (const T*)x, (const S*)scale, (T*)out, rows, d, eps);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows, int d, float eps,
           cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0) && d % VEC == 0;
  const int nvec = d / VEC;
  if (aligned && nvec <= 64) return launch_vec<T, S, 32, 2>(x, scale, out, rows, d, eps, stream);
  if (aligned && nvec <= 128) return launch_vec<T, S, 64, 2>(x, scale, out, rows, d, eps, stream);
  if (aligned && nvec <= 256) return launch_vec<T, S, 128, 2>(x, scale, out, rows, d, eps, stream);
  if (aligned && nvec <= 512) return launch_vec<T, S, 256, 2>(x, scale, out, rows, d, eps, stream);
  if (aligned && nvec <= 1024) return launch_vec<T, S, 256, 4>(x, scale, out, rows, d, eps, stream);
  if (aligned && nvec <= 2048) return launch_vec<T, S, 256, 8>(x, scale, out, rows, d, eps, stream);
  const unsigned int grid = (unsigned int)(rows < (1LL << 30) ? rows : (1LL << 30));
  rmsnorm_rows<T, S><<<grid, THREADS, 0, stream>>>((const T*)x, (const S*)scale, (T*)out, rows,
                                                   d, eps);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// x, out: (rows, d) of dtype code x_dtype; scale: (d,) of dtype code
// s_dtype (REPRO_F32 or REPRO_BF16).  Any alignment of x.  Returns 0 or the
// CUDA error of the launch (cudaErrorInvalidValue for an unknown dtype code).
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
