// Device bulk build of the mqr group pyramid, straight to schedule arrays.
//
// Replaces the Pallas kernel `_build_kernel` of src/repro/kernels/build.py
// (called from `build_levels_pallas`).  Computes, for any n, the arrays of
// `build_levels_pallas` / `build_levels_jnp`: group_of (L, n) int32,
// mbr_cm (L, 4, n) float32, parent (L, n) int32, n_real (L,) int32.
//
// Level l >= 1, as a few launches on one stream:
//   1. init:   level-l slot MBRs = (+inf, +inf, -inf, -inf), parents = 0,
//              key presence bitmap = 0;
//   2. key:    key = gid*5 + quad_code(centroid, group-MBR centroid) for
//              objects of multi-member groups, gid*5 for singletons; mark
//              key as present;
//   3. scan:   exclusive prefix sum of the presence bitmap over the 5n key
//              space (hand-written block scan, recursive over block sums);
//   4. gid:    new gid = rank[key] (ascending-key numbering, exactly the
//              JAX `_densify`); zero the member counts; n_real[l];
//   5. reduce: segment min/max of the four coordinates with atomics on the
//              float bits, member counts (atomicAdd), parent slot (atomicMax
//              of the previous gid: every member of a group agrees on it).
//
// Float atomics: IEEE float32 bits order like sign-magnitude integers, so
// a min over non-negative floats is an atomicMin on the bits as int, and a
// min over negative floats an atomicMax on the bits as unsigned (the max
// case mirrors).  The result is the exact float min/max, independent of
// the order in which atomics land, so the build is deterministic.
//
// What bounds it on an H100: bytes and latency of the ~9 small launches per
// level; the arrays it writes are 24 bytes per object per level.  The TPU
// kernel held the whole set plus the 5n key space in VMEM, which capped it
// at n = 4096 (PALLAS_BUILD_MAX_N); here every array lives in device memory,
// so there is no cap, and gathers and atomics take the place of the TPU's
// one-hot matmuls.  Ranks are integers, where the TPU used a float cumsum.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_BLOCK = 1024;

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!signbit(v)) atomicMin((int*)addr, __float_as_int(v));
  else atomicMax((unsigned int*)addr, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!signbit(v)) atomicMax((int*)addr, __float_as_int(v));
  else atomicMin((unsigned int*)addr, __float_as_uint(v));
}

// Fig. 2 orientation of entry centroid a about node centroid b
// (bulk.quad_code: NE=0, NW=1, SW=2, SE=3, EQ=4).
__device__ __forceinline__ int quad_code(float acx, float acy, float bcx, float bcy) {
  const bool gx = acx > bcx, lx = acx < bcx, gy = acy > bcy, ly = acy < bcy;
  const bool ex = !gx && !lx, ey = !gy && !ly;
  if (ex && ey) return 4;
  if (gx && !ly) return 0;
  if ((lx && gy) || (ex && gy)) return 1;
  if (lx && !gy) return 2;
  return 3;
}

__global__ void init_level(float* bounds, int* parent, int* pres, long long n,
                           long long keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    bounds[i] = INFINITY;
    bounds[n + i] = INFINITY;
    bounds[2 * n + i] = -INFINITY;
    bounds[3 * n + i] = -INFINITY;
    parent[i] = 0;
  }
  if (pres != nullptr && i < keys) pres[i] = 0;
}

__global__ void root_level(int* gid, int* counts, int* n_real, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    gid[i] = 0;
    counts[i] = 0;
  }
  if (i == 0) *n_real = 1;
}

__global__ void make_keys(const float* __restrict__ mbrs, const int* __restrict__ gid_prev,
                          const float* __restrict__ bounds_prev,
                          const int* __restrict__ counts, int* __restrict__ key,
                          int* __restrict__ pres, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = gid_prev[i];
  int k = g * 5;
  if (counts[g] > 1) {
    const float cx = (mbrs[4 * i] + mbrs[4 * i + 2]) * 0.5f;
    const float cy = (mbrs[4 * i + 1] + mbrs[4 * i + 3]) * 0.5f;
    const float gcx = (bounds_prev[g] + bounds_prev[2 * n + g]) * 0.5f;
    const float gcy = (bounds_prev[n + g] + bounds_prev[3 * n + g]) * 0.5f;
    k += quad_code(cx, cy, gcx, gcy);
  }
  key[i] = k;
  pres[k] = 1;  // every writer stores the same value
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// Exclusive scan of one SCAN_BLOCK-element block; may run in place.
__global__ void scan_block(const int* in, int* out, int* block_sums, long long m) {
  __shared__ int warp_off[SCAN_BLOCK / 32];
  const long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  const int v = i < m ? in[i] : 0;
  const int inc = warp_inclusive_scan(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 31) warp_off[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_off[lane];
    warp_off[lane] = warp_inclusive_scan(t) - t;
  }
  __syncthreads();
  const int excl = inc - v + warp_off[warp];
  if (i < m) out[i] = excl;
  if (block_sums != nullptr && threadIdx.x == SCAN_BLOCK - 1)
    block_sums[blockIdx.x] = excl + v;
}

__global__ void add_block_offsets(int* out, const int* offsets, long long m) {
  const long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  if (i < m) out[i] += offsets[blockIdx.x];
}

long long scan_workspace(long long m) {
  long long total = 0;
  for (long long nb = (m + SCAN_BLOCK - 1) / SCAN_BLOCK; nb > 1;
       nb = (nb + SCAN_BLOCK - 1) / SCAN_BLOCK)
    total += nb;
  return total;
}

int exclusive_scan(const int* in, int* out, long long m, int* sums, cudaStream_t s) {
  const long long nb = (m + SCAN_BLOCK - 1) / SCAN_BLOCK;
  scan_block<<<(unsigned int)nb, SCAN_BLOCK, 0, s>>>(in, out, nb > 1 ? sums : nullptr, m);
  REPRO_LAUNCH_CHECK();
  if (nb > 1) {
    const int rc = exclusive_scan(sums, sums, nb, sums + nb, s);
    if (rc) return rc;
    add_block_offsets<<<(unsigned int)nb, SCAN_BLOCK, 0, s>>>(out, sums, m);
    REPRO_LAUNCH_CHECK();
  }
  return 0;
}

__global__ void assign_gid(const int* __restrict__ key, const int* __restrict__ rank,
                           const int* __restrict__ pres, int* __restrict__ gid,
                           int* __restrict__ counts, int* __restrict__ n_real,
                           long long n, long long keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    gid[i] = rank[key[i]];
    counts[i] = 0;
  }
  if (i == 0) *n_real = rank[keys - 1] + pres[keys - 1];
}

__global__ void reduce_groups(const float* __restrict__ mbrs, const int* __restrict__ gid,
                              const int* __restrict__ gid_prev, float* bounds, int* counts,
                              int* parent, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = gid[i];
  atomic_min_f32(&bounds[g], mbrs[4 * i]);
  atomic_min_f32(&bounds[n + g], mbrs[4 * i + 1]);
  atomic_max_f32(&bounds[2 * n + g], mbrs[4 * i + 2]);
  atomic_max_f32(&bounds[3 * n + g], mbrs[4 * i + 3]);
  atomicAdd(&counts[g], 1);
  if (gid_prev != nullptr) atomicMax(&parent[g], gid_prev[i]);
}

}  // namespace

extern "C" {

// Bytes of scratch `repro_build_levels` needs for n objects.
long long repro_build_levels_workspace(long long n) {
  const long long keys = 5 * n;
  return 4 * (2 * n + 2 * keys + scan_workspace(keys));
}

// mbrs: (n, 4) float32 row-major.  Outputs: group_of (L, n) int32,
// mbr_cm (L, 4, n) float32, parent (L, n) int32, n_real (L,) int32.
// workspace: repro_build_levels_workspace(n) bytes.  Returns 0 or the CUDA
// error of a launch.
int repro_build_levels(const void* mbrs_v, void* group_of_v, void* mbr_cm_v,
                       void* parent_v, void* n_real_v, void* workspace, long long n,
                       int levels, void* stream) {
  if (n == 0 || levels == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* mbrs = (const float*)mbrs_v;
  int* group_of = (int*)group_of_v;
  float* mbr_cm = (float*)mbr_cm_v;
  int* parent = (int*)parent_v;
  int* n_real = (int*)n_real_v;
  const long long keys = 5 * n;
  int* counts = (int*)workspace;
  int* key = counts + n;
  int* pres = key + n;
  int* rank = pres + keys;
  int* sums = rank + keys;
  const unsigned int bn = repro_blocks(n, THREADS), bk = repro_blocks(keys, THREADS);

  init_level<<<bn, THREADS, 0, s>>>(mbr_cm, parent, nullptr, n, 0);
  REPRO_LAUNCH_CHECK();
  root_level<<<bn, THREADS, 0, s>>>(group_of, counts, n_real, n);
  REPRO_LAUNCH_CHECK();
  reduce_groups<<<bn, THREADS, 0, s>>>(mbrs, group_of, nullptr, mbr_cm, counts, parent, n);
  REPRO_LAUNCH_CHECK();
  for (int l = 1; l < levels; ++l) {
    const int* gid_prev = group_of + (size_t)(l - 1) * n;
    int* gid = group_of + (size_t)l * n;
    const float* bounds_prev = mbr_cm + (size_t)(l - 1) * 4 * n;
    float* bounds = mbr_cm + (size_t)l * 4 * n;
    int* par = parent + (size_t)l * n;
    init_level<<<bk, THREADS, 0, s>>>(bounds, par, pres, n, keys);
    REPRO_LAUNCH_CHECK();
    make_keys<<<bn, THREADS, 0, s>>>(mbrs, gid_prev, bounds_prev, counts, key, pres, n);
    REPRO_LAUNCH_CHECK();
    const int rc = exclusive_scan(pres, rank, keys, sums, s);
    if (rc) return rc;
    assign_gid<<<bn, THREADS, 0, s>>>(key, rank, pres, gid, counts, n_real + l, n, keys);
    REPRO_LAUNCH_CHECK();
    reduce_groups<<<bn, THREADS, 0, s>>>(mbrs, gid, gid_prev, bounds, counts, par, n);
    REPRO_LAUNCH_CHECK();
  }
  return 0;
}

}  // extern "C"
