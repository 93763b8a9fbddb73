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

static inline long long repro_round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// Streaming multiprocessors of the current device (cached per device).
static inline int repro_sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    n = 132;
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

// ---------------------------------------------------------------------------
// Single-pass exclusive scan of a row of 0 / 1 flags (bytes or int32),
// with decoupled look-back: kernel #2's survivor prefix (level_sweep.cu) and
// kernel #4's key ranks (build_levels.cu).  One launch of
// repro_scan_parts(width) blocks of REPRO_SCAN_THREADS threads; each
// partition is REPRO_SCAN_SEG flags, 16 a thread read in 16-byte loads.
// ---------------------------------------------------------------------------
constexpr int REPRO_SCAN_THREADS = 256;
constexpr int REPRO_SCAN_ITEMS = 16;
constexpr long long REPRO_SCAN_SEG = (long long)REPRO_SCAN_THREADS * REPRO_SCAN_ITEMS;

static inline long long repro_scan_parts(long long width) {
  return (width + REPRO_SCAN_SEG - 1) / REPRO_SCAN_SEG;
}

namespace {

constexpr unsigned long long REPRO_SCAN_AGGREGATE = 1ULL << 62;
constexpr unsigned long long REPRO_SCAN_INCLUSIVE = 2ULL << 62;

// Exclusive scan of one int per thread over a block of REPRO_SCAN_THREADS
// threads: returns this thread's exclusive prefix, the block's total in
// *total.  Every thread of the block must call it.
__device__ int repro_block_exclusive_scan(int v, int* total) {
  constexpr int WARPS = REPRO_SCAN_THREADS / 32;
  __shared__ int warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < WARPS ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  const int r = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[WARPS - 1];
  return r;
}

// Flags base .. base + 15 (those below width) as 16 bytes of 0 / 1, flag i
// in byte i % 4 of words[i / 4].
__device__ __forceinline__ void repro_load_flags(const uint8_t* flags, long long base,
                                                 long long width, uint32_t (&words)[4]) {
  if (base + REPRO_SCAN_ITEMS <= width) {
    const uint4 u = *reinterpret_cast<const uint4*>(flags + base);
    words[0] = u.x;
    words[1] = u.y;
    words[2] = u.z;
    words[3] = u.w;
  } else {
    for (int i = 0; i < REPRO_SCAN_ITEMS; ++i)
      if (base + i < width) words[i / 4] |= (uint32_t)flags[base + i] << (8 * (i % 4));
  }
}
__device__ __forceinline__ void repro_load_flags(const int32_t* flags, long long base,
                                                 long long width, uint32_t (&words)[4]) {
  if (base + REPRO_SCAN_ITEMS <= width) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 v = reinterpret_cast<const int4*>(flags + base)[i];
      words[i] = (uint32_t)v.x | (uint32_t)v.y << 8 | (uint32_t)v.z << 16 | (uint32_t)v.w << 24;
    }
  } else {
    for (int i = 0; i < REPRO_SCAN_ITEMS; ++i)
      if (base + i < width) words[i / 4] |= (uint32_t)flags[base + i] << (8 * (i % 4));
  }
}

// prefix[w] = number of set flags of flags[0, w), for w in [0, width], in
// one pass.  flags is 16-byte aligned and holds only 0 and 1.  state[0]
// hands out partitions in launch order; state[1 + p] is partition p's count
// (REPRO_SCAN_AGGREGATE) and then its inclusive prefix
// (REPRO_SCAN_INCLUSIVE), flag and value in one 64-bit word.  A partition
// adds up its predecessors' words back to the first inclusive one
// (decoupled look-back); each waits only on partitions handed out before
// it, which are running, so the scan cannot deadlock.  state (1 +
// repro_scan_parts(width) words) is zero at launch.
template <typename F>
__global__ void __launch_bounds__(REPRO_SCAN_THREADS) repro_flag_prefix_scan(
    const F* __restrict__ flags, long long width, int32_t* __restrict__ prefix,
    unsigned long long* state) {
  __shared__ long long s_part;
  __shared__ int s_excl;
  if (threadIdx.x == 0) s_part = (long long)atomicAdd(state, 1ULL);
  __syncthreads();
  const long long part = s_part;
  const long long base = part * REPRO_SCAN_SEG + (long long)threadIdx.x * REPRO_SCAN_ITEMS;
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  repro_load_flags(flags, base, width, words);
  int count = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) count += (int)((words[i] * 0x01010101u) >> 24);  // bytes are 0 / 1
  int total;
  const int excl_in_block = repro_block_exclusive_scan(count, &total);
  if (threadIdx.x == 0) {
    int excl = 0;
    if (part > 0) {
      atomicExch(state + 1 + part, REPRO_SCAN_AGGREGATE | (unsigned int)total);
      for (long long p = part - 1;; --p) {
        unsigned long long s;
        do {
          s = atomicAdd(state + 1 + p, 0ULL);
        } while ((s >> 62) == 0);
        excl += (int)(s & 0xffffffffu);
        if ((s >> 62) == 2) break;
      }
    }
    atomicExch(state + 1 + part, REPRO_SCAN_INCLUSIVE | (unsigned int)(excl + total));
    s_excl = excl;
  }
  __syncthreads();
  int run = s_excl + excl_in_block;
  int out[REPRO_SCAN_ITEMS];
#pragma unroll
  for (int i = 0; i < REPRO_SCAN_ITEMS; ++i) {
    out[i] = run;
    run += (int)((words[i / 4] >> (8 * (i % 4))) & 0xffu);
  }
  if (base + REPRO_SCAN_ITEMS <= width) {
    int4* dst = reinterpret_cast<int4*>(prefix + base);
#pragma unroll
    for (int i = 0; i < REPRO_SCAN_ITEMS / 4; ++i)
      dst[i] = make_int4(out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
  } else {
    for (int i = 0; i < REPRO_SCAN_ITEMS; ++i)
      if (base + i < width) prefix[base + i] = out[i];
  }
  if (base < width && width <= base + REPRO_SCAN_ITEMS) prefix[width] = run;
}

}  // namespace
