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
// * Launch 1, the vector path (as the forward's): a group of 32-256 threads
//   owns a row, sized from D so that each thread holds up to 16 elements of
//   x in sixteen-byte vectors (4 floats or 8 bfloat16 each) and as many of
//   dy; at D = 2048, 128 threads of two bf16 vectors each (two rows a
//   block: measured faster than 256 threads of one), or 256 of two f32
//   ones.
//   The row is read once, into registers (the next two rows' vectors load
//   while this one is reduced), its sum(x^2) and sum(x * g) reduced in one fixed
//   order (a thread's columns, shuffles, then the group's warps in turn
//   through a double-buffered slot in shared memory: one barrier a row),
//   and dx written from the registers with 16-byte stores.  A persistent
//   grid (the blocks that fit an SM at once, at most 4) walks the rows; each thread keeps its scale
//   entries and its share of dscale, dy * x * r summed over its rows, in
//   registers, since its columns are the same for every row it walks.  At
//   the end the block's groups add their shares in group order into one
//   partial row, which the block stores.
// * A row that cannot be read in 16-byte vectors (D not a multiple of the
//   vector width, x, dy or dx off 16-byte alignment, or D past 4,096)
//   takes the scalar path of the same entry point:
//   a block a row, two coalesced passes (the second finds the row in L1/L2),
//   the block's dscale share in shared memory, one float a column.
// * Launch 2: a block of 8 warps a 32 columns adds the partial rows, warp
//   w the rows w, w + 8, ... in order, then the warps' sums in warp order.
//   No atomics: dscale is the same on every run of the same shapes.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_ELEMS = 16;  // elements of x (and of dy) a thread holds on the vector path

// 16 bytes of a row as raw bits, and as floats.
__device__ __forceinline__ uint4 load_raw(const void* p) { return *reinterpret_cast<const uint4*>(p); }

__device__ __forceinline__ void unpack(const uint4& t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x);
  v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z);
  v[3] = __uint_as_float(t.w);
}

__device__ __forceinline__ void unpack(const uint4& t, float (&v)[8]) {
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

// The vector path: TPR threads a row, VPT vectors of VEC elements each;
// vector i of thread t holds columns (i * TPR + t) * VEC ...  Needs d a
// multiple of VEC, d <= TPR * VPT * VEC, and x, dy and dx 16-byte aligned.
// `comb` (dynamic shared memory, d floats) adds the groups' dscale shares
// when a block holds more than one row at once.
template <typename T, typename S, int TPR, int VPT>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_bwd_vec(const T* __restrict__ x, const S* __restrict__ scale,
                    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                    long long rows, int d, float eps) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int GROUPS = THREADS / TPR;  // rows a block holds at once
  constexpr int WARPS = TPR / 32;        // warps of a row
  extern __shared__ float comb[];
  __shared__ float red[2][2][THREADS / 32];  // [parity][sum(x^2), sum(x g)][warp]
  const int t = threadIdx.x % TPR, grp = threadIdx.x / TPR, warp = threadIdx.x / 32;
  float sc[VPT][VEC], acc[VPT][VEC];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int col = (i * TPR + t) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sc[i][e] = col < d ? repro_f32(scale[col + e]) : 0.0f;
      acc[i][e] = 0.0f;
    }
  }
  // Row r0 + grp is in registers while the next two load.
  auto load_row = [&](long long r, uint4 (&vx)[VPT], uint4 (&vg)[VPT]) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * TPR + t) * VEC;
      if (r < rows && col < d) {
        vx[i] = load_raw(x + r * d + col);
        vg[i] = load_raw(dy + r * d + col);
      }
    }
  };
  const long long stride = (long long)gridDim.x * GROUPS;
  uint4 cx[VPT], cg[VPT], nx[VPT], ng[VPT], mx[VPT], mg[VPT];
  long long r0 = (long long)blockIdx.x * GROUPS;
  load_row(r0 + grp, cx, cg);
  load_row(r0 + grp + stride, nx, ng);
  for (int parity = 0; r0 < rows; r0 += stride, parity ^= 1) {
    const long long r = r0 + grp;
    if (r0 + 2 * stride < rows) load_row(r + 2 * stride, mx, mg);
    const bool live = r < rows;
    float xv[VPT][VEC], gv[VPT][VEC];
    float ss = 0.0f, xg = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * TPR + t) * VEC;
      if (live && col < d) {
        unpack(cx[i], xv[i]);
        unpack(cg[i], gv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[i][e] = gv[i][e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += xv[i][e] * xv[i][e];
        xg += xv[i][e] * (sc[i][e] * gv[i][e]);
      }
    }
    ss = repro_warp_sum(ss);
    xg = repro_warp_sum(xg);
    if (WARPS > 1) {
      if ((threadIdx.x & 31) == 0) {
        red[parity][0][warp] = ss;
        red[parity][1][warp] = xg;
      }
      __syncthreads();  // one barrier a row: the slot alternates, so no second one
      ss = xg = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        ss += red[parity][0][grp * WARPS + w];
        xg += red[parity][1][grp * WARPS + w];
      }
    }
    const float rinv = rsqrtf(ss / (float)d + eps);  // as the forward computes it
    const float coef = rinv * rinv * rinv * (xg / (float)d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * TPR + t) * VEC;
      if (live && col < d) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          o[e] = rinv * (sc[i][e] * gv[i][e]) - xv[i][e] * coef;
          acc[i][e] += gv[i][e] * xv[i][e] * rinv;
        }
        store16(dx + r * d + col, o);
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      cx[i] = nx[i];
      cg[i] = ng[i];
      nx[i] = mx[i];
      ng[i] = mg[i];
    }
  }
  float* pr = partial + (long long)blockIdx.x * d;
  if constexpr (GROUPS == 1) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int col = (i * TPR + t) * VEC;
      if (col < d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) pr[col + e] = acc[i][e];
      }
    }
  } else {
    for (int g = 0; g < GROUPS; ++g) {  // the groups' shares, added in group order
      if (grp == g) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int col = (i * TPR + t) * VEC;
          if (col < d) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              comb[col + e] = g == 0 ? acc[i][e] : comb[col + e] + acc[i][e];
          }
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < d; c += THREADS) pr[c] = comb[c];
  }
}

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

// dscale from the partial rows: a block owns 32 columns; warp w adds the
// rows w, w + 8, ... in order (coalesced 128-byte reads, several in flight),
// then the warps' sums are added in warp order.  One fixed order.
constexpr int REDUCE_WARPS = 8;

template <typename S>
__global__ void __launch_bounds__(32 * REDUCE_WARPS)
    rmsnorm_bwd_reduce(const float* __restrict__ partial, S* __restrict__ dscale, int blocks,
                       int d) {
  __shared__ float part[REDUCE_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (c < d) {
#pragma unroll 4
    for (int b = w; b < blocks; b += REDUCE_WARPS) v += partial[(long long)b * d + c];
  }
  part[w][lane] = v;
  __syncthreads();
  if (w == 0 && c < d) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < REDUCE_WARPS; ++i) t += part[i][lane];
    dscale[c] = repro_from_f32<S>(t);
  }
}

int grid_of(long long rows) {
  const long long g = (long long)repro_sm_count() * BLOCKS_PER_SM;
  return (int)(rows < g ? rows : g);
}

template <typename T, typename S, int TPR, int VPT>
int launch_vec(const void* x, const void* scale, const void* dy, void* dx, void* partial,
               long long rows, int d, float eps, cudaStream_t stream, int* grid) {
  constexpr int GROUPS = THREADS / TPR;
  const size_t smem = GROUPS > 1 ? (size_t)d * sizeof(float) : 0;
  // as many blocks as are resident at once (registers may allow fewer than
  // BLOCKS_PER_SM), so that no block waits for a second wave
  int fit = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, rmsnorm_bwd_vec<T, S, TPR, VPT>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  fit = fit < 1 ? 1 : fit > BLOCKS_PER_SM ? BLOCKS_PER_SM : fit;
  const long long need = (rows + GROUPS - 1) / GROUPS;
  const long long cap = (long long)repro_sm_count() * fit;
  *grid = (int)(need < cap ? need : cap);
  rmsnorm_bwd_vec<T, S, TPR, VPT><<<*grid, THREADS, smem, stream>>>(
      (const T*)x, (const S*)scale, (const T*)dy, (T*)dx, (float*)partial, rows, d, eps);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <typename T, typename S>
int launch(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
           void* partial, long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)dy % 16 == 0 &&
                       (uintptr_t)dx % 16 == 0 && d % VEC == 0;
  const int nvec = d / VEC;
  int grid = 0, rc = -1;  // -1: the scalar path
  if (aligned) {
    if (nvec <= 32) {
      rc = launch_vec<T, S, 32, 1>(x, scale, dy, dx, partial, rows, d, eps, stream, &grid);
    } else if (nvec <= 64) {
      rc = launch_vec<T, S, 64, 1>(x, scale, dy, dx, partial, rows, d, eps, stream, &grid);
    } else if (nvec <= 128) {
      rc = launch_vec<T, S, 128, 1>(x, scale, dy, dx, partial, rows, d, eps, stream, &grid);
    } else if (nvec <= 256) {  // two rows a block: faster than one of 256 threads (bf16 d 2048)
      rc = launch_vec<T, S, 128, 2>(x, scale, dy, dx, partial, rows, d, eps, stream, &grid);
    } else if (nvec <= 512) {
      rc = launch_vec<T, S, 256, 2>(x, scale, dy, dx, partial, rows, d, eps, stream, &grid);
    } else if constexpr (4 * VEC <= MAX_ELEMS) {
      if (nvec <= 1024)
        rc = launch_vec<T, S, 256, 4>(x, scale, dy, dx, partial, rows, d, eps, stream, &grid);
    }
  }
  if (rc > 0) return rc;
  if (rc < 0) {  // the scalar path
    grid = grid_of(rows);
    const size_t smem = (size_t)d * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          rmsnorm_bwd_rows<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    rmsnorm_bwd_rows<T, S><<<grid, THREADS, smem, stream>>>(
        (const T*)x, (const S*)scale, (const T*)dy, (T*)dx, (float*)partial, rows, d, eps);
    REPRO_LAUNCH_CHECK();
  }
  rmsnorm_bwd_reduce<S><<<repro_blocks(d, 32), 32 * REDUCE_WARPS, 0, stream>>>(
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
