// Device bulk build of the mqr group pyramid, straight to schedule arrays.
//
// Replaces the Pallas kernel `_build_kernel` of src/repro/kernels/build.py
// (called from `build_levels_pallas`).  Computes, for any n, the arrays of
// `build_levels_pallas` / `build_levels_jnp`: group_of (L, n) int32,
// mbr_cm (L, 4, n) float32, parent (L, n) int32, n_real (L,) int32.
//
// Level l >= 1 is three launches on one stream:
//   1. make_keys:    key = gid*5 + quad_code(centroid, group-MBR centroid);
//                    mark the key present (a flag); set level l's slots to
//                    (+inf, +inf, -inf, -inf); clear the scan's state;
//   2. scan:         exclusive prefix of the presence flags over the level's
//                    K_l keys (`repro_flag_prefix_scan`, common.cuh: one
//                    pass, decoupled look-back); rank[K_l] is n_real[l];
//   3. reduce_level: new gid = rank[key] (ascending-key numbering, exactly
//                    the JAX `_densify`), stored at once as group_of; segment
//                    min/max of the four coordinates; the parents from the
//                    keys (present key k is group rank[k], child of k / 5);
//                    clear the presence flags of level l+1.
// The root is two: init_root (sentinels, gid 0, parents 0, n_real[0] = 1)
// and reduce_level.  The launch boundaries left are the grid-wide
// dependencies: keys need the previous level's bounds complete, ranks need
// the whole scan, and the scan needs every key marked.  So a build is
// 3L - 1 launches (32 at L 11; the first port made 93).
//
// Key space per level.  Level l's keys are gid_prev*5 + q with gid_prev <
// n_real[l-1] <= min(n, 5^(l-1)), so they lie below K_l = min(5n, 5^l), a
// bound the host knows without a sync, and level l has at most
// G_l = min(n, 5^l) groups.  The presence flags, their clearing and the scan
// cover K_l keys, not 5n: 7.4e6 keys in all at n = 1e6, L 11, where the
// first port zeroed and scanned 5.5e7 ints.
//
// No contended atomics.  The first port made six atomics per object and
// level (four bounds, a member count, the parent), and at the top levels
// they fell on a few addresses (the root: 1e6 objects onto 6 words), which
// the L2 serialises.  Now:
// * the counts are gone (make_keys) and the parents are written once per
//   group from the keys, so four atomics an object are left;
// * where neighbouring lanes of a warp share a group, the warp merges each
//   group's lanes first (__match_any_sync on the gid, then
//   __reduce_min_sync / __reduce_max_sync on ordered bits) and one leader
//   per group carries it on; where they share none (objects in no order,
//   deep levels) each object makes its own;
// * on levels with G_l <= SMALL (the root and levels 1-5 at n = 1e6) the
//   leaders reduce into a shared-memory table of the four bounds, and the
//   block then flushes it, one atomic per touched group and field: the root
//   becomes a block reduction.  The grid there is a few blocks per SM, each
//   walking many objects, so few tables are flushed;
// * where many objects share a slot (at least 4 an object's group or key,
//   on average, and every flush), a bound or presence flag is read before
//   its atomic or store, which is skipped where it would change nothing:
//   once a slot has settled, its objects only read it.  The flags of such
//   a level are int32, not bytes, so their stores spread over four times
//   the 32-byte sectors (with bytes, the marks of level 6, 15,625 keys at
//   n = 1e6, were the build's slowest launch: PERF.md §6), and its objects
//   are walked by a few blocks per SM, so that an object's mark sees those
//   of the objects before it.
// Floats are reduced as ordered int32 bits (`ordered`: IEEE bits order like
// sign-magnitude integers, and flipping the magnitude bits of negative ones
// gives a two's-complement order), and the global atomics keep the first
// port's trick: a min over non-negative floats is an atomicMin on the bits
// as int, over negative ones an atomicMax on the bits as unsigned (the max
// case mirrors).  Both follow the one total order with -0.0 < +0.0, so each
// bound is exact and independent of the order the atomics land in: the
// build is deterministic (zero signs: ROADMAP C12).
//
// What bounds it on an H100: bytes and latency.  The arrays it writes are
// 24 bytes per object per level (0.084 ms at n = 1e6, L 11, at the data
// sheet's 3.35 TB/s); a level also reads the objects twice and gathers
// their groups' bounds and ranks, and its atomics land on random slots of
// the level.  Ranks are integers, where the TPU used a float cumsum, and
// every array lives in device memory, so the TPU kernel's VMEM cap
// (PALLAS_BUILD_MAX_N = 4096) has no counterpart.
// Measured times: PERF.md §6.
#include "common.cuh"

#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int SMALL = 4096;              // a level with at most this many groups (keys)
                                         // is reduced (marked) in shared memory
constexpr int SMALL_TABLE = 1024;        // up to this many groups, 8 blocks per SM walk
                                         // the objects of a shared-memory level, else 4
constexpr unsigned int FULL = 0xffffffffu;

// Float bits as an int32 whose signed order is the float order (-0 < +0).
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!signbit(v)) atomicMin((int*)addr, __float_as_int(v));
  else atomicMax((unsigned int*)addr, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!signbit(v)) atomicMax((int*)addr, __float_as_int(v));
  else atomicMin((unsigned int*)addr, __float_as_uint(v));
}

// Lower (raise) the bound at addr to the ordered bits v.  With `check` the
// bound is read first and the atomic skipped where it is already at or
// below (above) v: bounds only move one way, so a stale read costs at most
// a needless atomic, and once a contended slot has settled most of its
// objects skip theirs.
__device__ __forceinline__ void lower_to(float* addr, int v, bool check) {
  if (check && ordered(__ldcg(addr)) <= v) return;
  atomic_min_f32(addr, unordered(v));
}
__device__ __forceinline__ void raise_to(float* addr, int v, bool check) {
  if (check && ordered(__ldcg(addr)) >= v) return;
  atomic_max_f32(addr, unordered(v));
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

// Level 0: sentinel bounds and parent 0 in every slot, gid 0; the presence
// flags of level 1 cleared; n_real[0] = 1.
__global__ void init_root(float* bounds, int* parent, int* gid, int* pres, int* n_real,
                          long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    bounds[i] = INFINITY;
    bounds[n + i] = INFINITY;
    bounds[2 * n + i] = -INFINITY;
    bounds[3 * n + i] = -INFINITY;
    parent[i] = 0;
    gid[i] = 0;
  }
  if (i < 5) pres[i] = 0;  // level 1 has at most 5 keys, int flags
  if (i == 0) *n_real = 1;
}

struct KeyArgs {
  const float* mbrs;         // (n, 4) objects
  const int* gid_prev;       // (n) level l-1 gids
  const float* bounds_prev;  // (4, n) level l-1 bounds
  int* key;                  // (n) level l keys
  void* pres;                // (keys) presence flags (F), zero at launch
  float* bounds;             // (4, n) level l bounds, set to sentinels here
  unsigned long long* scan_state;  // the scan's state, cleared here
  long long scan_words, keys, n;
  int check;                 // many objects a key: read a mark before storing it
};

// key = gid*5 + the quadrant code of the object's centroid about its
// group's MBR centroid.  The reference gives a singleton gid*5; its group
// MBR is its own box, so its code is EQ (4) here, and gid*5 + 4 ranks
// among the level's keys exactly as gid*5 does (keys of other groups
// differ by at least 5): the member counts the reference keeps for that
// rule are not needed.
template <bool SMALL_KEYS, typename F>
__global__ void __launch_bounds__(THREADS) make_keys(const KeyArgs a) {
  __shared__ uint8_t seen[SMALL_KEYS ? SMALL : 1];
  const long long n = a.n;
  F* pres = static_cast<F*>(a.pres);
  if (SMALL_KEYS) {
    for (int k = threadIdx.x; k < a.keys; k += THREADS) seen[k] = 0;
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (long long w = threadIdx.x; w < a.scan_words; w += THREADS) a.scan_state[w] = 0ULL;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const int g = a.gid_prev[i];
    const float cx = (a.mbrs[4 * i] + a.mbrs[4 * i + 2]) * 0.5f;
    const float cy = (a.mbrs[4 * i + 1] + a.mbrs[4 * i + 3]) * 0.5f;
    const float gcx = (a.bounds_prev[g] + a.bounds_prev[2 * n + g]) * 0.5f;
    const float gcy = (a.bounds_prev[n + g] + a.bounds_prev[3 * n + g]) * 0.5f;
    const int k = g * 5 + quad_code(cx, cy, gcx, gcy);
    a.key[i] = k;
    a.bounds[i] = INFINITY;
    a.bounds[n + i] = INFINITY;
    a.bounds[2 * n + i] = -INFINITY;
    a.bounds[3 * n + i] = -INFINITY;
    if (SMALL_KEYS) seen[k] = 1;  // every writer stores the same value
    else if (!a.check || __ldcg(&pres[k]) == 0) pres[k] = 1;
  }
  if (SMALL_KEYS) {
    __syncthreads();
    for (int k = threadIdx.x; k < a.keys; k += THREADS)
      if (seen[k] && __ldcg(&pres[k]) == 0) pres[k] = 1;
  }
}

struct ReduceArgs {
  const float* mbrs;      // (n, 4) objects
  const int* key;         // (n) level keys; null at the root (every gid 0)
  const int* rank;        // (keys + 1) exclusive prefix of the presence flags
  int* gid;               // (n) group_of of this level
  float* bounds;          // (4, n)
  int* parent;            // (n)
  uint4* pres_next;       // presence flags of level l+1, cleared here
  long long clear_words;  // 16-byte words of them
  int* n_real;            // n_real[l] = rank[keys]; null at the root
  long long keys, n;
  int groups;             // SMALL_GROUPS: G_l, the table's rows
  int check;              // many objects a group: read a bound before its atomic
};

// Segment min/max of the four coordinates into level l's slots, and the
// level's group_of and parents.  On a SMALL_GROUPS level the block's
// leaders reduce into a shared table (4 rows of `groups` ordered ints) that
// the block then flushes, one checked atomic per touched group and field.
template <bool SMALL_GROUPS>
__global__ void __launch_bounds__(THREADS) reduce_level(const ReduceArgs a) {
  extern __shared__ int table[];
  const int lane = threadIdx.x & 31, G = a.groups;
  if (SMALL_GROUPS) {
    for (int g = threadIdx.x; g < G; g += THREADS) {
      table[g] = INT_MAX;
      table[G + g] = INT_MAX;
      table[2 * G + g] = INT_MIN;
      table[3 * G + g] = INT_MIN;
    }
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long base = (long long)blockIdx.x * THREADS; base < a.n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < a.n;
    int g = -1, lx = 0, ly = 0, hx = 0, hy = 0;
    if (valid) {
      g = 0;
      if (a.key != nullptr) {
        g = a.rank[a.key[i]];
        a.gid[i] = g;
      }
      lx = ordered(a.mbrs[4 * i]);
      ly = ordered(a.mbrs[4 * i + 1]);
      hx = ordered(a.mbrs[4 * i + 2]);
      hy = ordered(a.mbrs[4 * i + 3]);
    }
    // Where neighbouring lanes share a group, merge the lanes of each group
    // (the branch is uniform over the warp); one leader carries it on.
    unsigned int peers = 1u << lane;
    const int up = __shfl_up_sync(FULL, g, 1);
    if (__any_sync(FULL, lane > 0 && g >= 0 && up == g)) {
      peers = __match_any_sync(FULL, g);
      lx = __reduce_min_sync(peers, lx);
      ly = __reduce_min_sync(peers, ly);
      hx = __reduce_max_sync(peers, hx);
      hy = __reduce_max_sync(peers, hy);
    }
    if (!valid || lane != __ffs(peers) - 1) continue;
    if (SMALL_GROUPS) {
      atomicMin(&table[g], lx);
      atomicMin(&table[G + g], ly);
      atomicMax(&table[2 * G + g], hx);
      atomicMax(&table[3 * G + g], hy);
    } else {
      lower_to(&a.bounds[g], lx, a.check);
      lower_to(&a.bounds[a.n + g], ly, a.check);
      raise_to(&a.bounds[2 * a.n + g], hx, a.check);
      raise_to(&a.bounds[3 * a.n + g], hy, a.check);
    }
  }
  if (SMALL_GROUPS) {
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += THREADS) {  // untouched fields keep their sentinel
      if (table[g] != INT_MAX) lower_to(&a.bounds[g], table[g], true);
      if (table[G + g] != INT_MAX) lower_to(&a.bounds[a.n + g], table[G + g], true);
      if (table[2 * G + g] != INT_MIN) raise_to(&a.bounds[2 * a.n + g], table[2 * G + g], true);
      if (table[3 * G + g] != INT_MIN) raise_to(&a.bounds[3 * a.n + g], table[3 * G + g], true);
    }
  }
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (a.key != nullptr) {
    // Parents from the keys: present key k (rank[k + 1] > rank[k]) is group
    // rank[k], whose parent is k / 5; slots past n_real get 0.
    for (long long k = t; k < a.keys; k += stride) {
      const int r = a.rank[k];
      if (a.rank[k + 1] > r) a.parent[r] = (int)(k / 5);
    }
    for (long long g = a.rank[a.keys] + t; g < a.n; g += stride) a.parent[g] = 0;
  }
  for (long long k = t; k < a.clear_words; k += stride) a.pres_next[k] = make_uint4(0u, 0u, 0u, 0u);
  if (a.n_real != nullptr && t == 0) *a.n_real = a.rank[a.keys];
}

// min(cap, 5^l) without overflow.
long long pow5_capped(int l, long long cap) {
  long long v = 1;
  for (int i = 0; i < l && v < cap; ++i) v *= 5;
  return v < cap ? v : cap;
}

// Scratch of one build, each part 16-byte aligned: keys, presence flags
// (5n bytes, or K_l int32 flags where 4 K_l <= n, and at least level 1's
// 5 int32 flags), ranks and the scan's state.
struct Scratch {
  int* key;
  uint8_t* pres;
  int* rank;
  unsigned long long* state;
};

long long scratch_bytes(long long n, Scratch* s, char* base) {
  const long long keys = 5 * n;
  const long long sizes[4] = {4 * n, keys > 20 ? keys : 20, 4 * (keys + 1),
                              8 * (1 + repro_scan_parts(keys))};
  long long off[4], total = 0;
  for (int i = 0; i < 4; ++i) {
    off[i] = total;
    total += repro_round_up(sizes[i], 16);
  }
  if (s != nullptr) {
    s->key = (int*)(base + off[0]);
    s->pres = (uint8_t*)(base + off[1]);
    s->rank = (int*)(base + off[2]);
    s->state = (unsigned long long*)(base + off[3]);
  }
  return total;
}

}  // namespace

extern "C" {

// Bytes of scratch `repro_build_levels` needs for n objects.
long long repro_build_levels_workspace(long long n) {
  return scratch_bytes(n, nullptr, nullptr);
}

// mbrs: (n, 4) float32 row-major.  Outputs: group_of (L, n) int32,
// mbr_cm (L, 4, n) float32, parent (L, n) int32, n_real (L,) int32.
// workspace: repro_build_levels_workspace(n) bytes, 16-byte aligned.
// Returns 0 or the CUDA error of a launch.
int repro_build_levels(const void* mbrs_v, void* group_of_v, void* mbr_cm_v,
                       void* parent_v, void* n_real_v, void* workspace, long long n,
                       int levels, void* stream) {
  if (n == 0 || levels == 0) return 0;
  if ((uintptr_t)workspace % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* mbrs = (const float*)mbrs_v;
  int* group_of = (int*)group_of_v;
  float* mbr_cm = (float*)mbr_cm_v;
  int* parent = (int*)parent_v;
  int* n_real = (int*)n_real_v;
  Scratch w;
  scratch_bytes(n, &w, (char*)workspace);
  const cudaError_t attr = cudaFuncSetAttribute(
      reduce_level<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, 16 * SMALL);
  if (attr != cudaSuccess) return (int)attr;
  const long long full = (n + THREADS - 1) / THREADS;
  auto grid = [&](int per_sm) {
    const long long g = (long long)per_sm * repro_sm_count();
    return (unsigned int)(per_sm > 0 && g < full ? g : full);
  };
  // Flags are int32 where many objects share a key (4 or more a key, on
  // average), so their stores spread over 4x the sectors; else bytes.
  auto int_flags = [&](long long keys) { return 4 * keys <= n; };

  init_root<<<(unsigned int)full, THREADS, 0, s>>>(mbr_cm, parent, group_of, (int*)w.pres,
                                                   n_real, n);
  REPRO_LAUNCH_CHECK();
  ReduceArgs root{};
  root.mbrs = mbrs;
  root.bounds = mbr_cm;
  root.n = n;
  root.groups = 1;
  reduce_level<true><<<grid(8), THREADS, 16, s>>>(root);
  REPRO_LAUNCH_CHECK();
  for (int l = 1; l < levels; ++l) {
    const long long keys = pow5_capped(l, 5 * n), groups = pow5_capped(l, n);
    const bool ints = int_flags(keys);
    KeyArgs k{};
    k.mbrs = mbrs;
    k.gid_prev = group_of + (size_t)(l - 1) * n;
    k.bounds_prev = mbr_cm + (size_t)(l - 1) * 4 * n;
    k.key = w.key;
    k.pres = w.pres;
    k.bounds = mbr_cm + (size_t)l * 4 * n;
    k.scan_state = w.state;
    k.scan_words = 1 + repro_scan_parts(keys);
    k.keys = keys;
    k.n = n;
    k.check = ints;
    if (keys <= SMALL && ints)
      make_keys<true, int><<<grid(8), THREADS, 0, s>>>(k);
    else if (keys <= SMALL)
      make_keys<true, uint8_t><<<grid(8), THREADS, 0, s>>>(k);
    else if (ints)  // a few blocks per SM: an object's later marks see earlier ones
      make_keys<false, int><<<grid(4), THREADS, 0, s>>>(k);
    else
      make_keys<false, uint8_t><<<grid(0), THREADS, 0, s>>>(k);
    REPRO_LAUNCH_CHECK();
    const unsigned int parts = (unsigned int)repro_scan_parts(keys);
    if (ints)
      repro_flag_prefix_scan<<<parts, REPRO_SCAN_THREADS, 0, s>>>((const int*)w.pres, keys,
                                                                  w.rank, w.state);
    else
      repro_flag_prefix_scan<<<parts, REPRO_SCAN_THREADS, 0, s>>>(w.pres, keys, w.rank,
                                                                  w.state);
    REPRO_LAUNCH_CHECK();
    ReduceArgs r{};
    r.mbrs = mbrs;
    r.key = w.key;
    r.rank = w.rank;
    r.gid = group_of + (size_t)l * n;
    r.bounds = k.bounds;
    r.parent = parent + (size_t)l * n;
    r.pres_next = (uint4*)w.pres;
    if (l + 1 < levels) {
      const long long next = pow5_capped(l + 1, 5 * n);
      r.clear_words = (next * (int_flags(next) ? 4 : 1) + 15) / 16;
    }
    r.n_real = n_real + l;
    r.keys = keys;
    r.n = n;
    r.check = 4 * groups <= n;
    if (groups <= SMALL) {
      r.groups = (int)groups;
      reduce_level<true><<<grid(groups <= SMALL_TABLE ? 8 : 4), THREADS, (size_t)16 * groups,
                           s>>>(r);
    } else {
      reduce_level<false><<<grid(0), THREADS, 0, s>>>(r);
    }
    REPRO_LAUNCH_CHECK();
  }
  return 0;
}

}  // extern "C"
