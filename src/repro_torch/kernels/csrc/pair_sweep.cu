// Tree-vs-tree pair sweep of the spatial join: per-level pair-active mask.
//
// Replaces the Pallas kernel `_pair_sweep_kernel` of
// src/repro/kernels/join_scan.py (called from `pair_sweep`).
//
//   P[k, a, b] = ov(A[k, :, a], B[k, :, b]) & P[k-1, pa[k, a], pb[k, b]]
//
// with level 0 the overlap alone (every schedule flavour, roots included).
// The symmetric self-join variant keeps slot pairs a <= b only and reads
// the parent pair mirrored: P[k-1, pa, pb] | P[k-1, pb, pa].
//
// What bounds it on an H100: the stores.  Each level writes Wa*Wb mask
// bytes (1.73 GB a call for the 50k mqr-tree against the R-tree, 6.09 GB
// for a 50k pyramid against the mqr-tree) and reads only (Wa + Wb) *
// (16|8 + 4) tile and parent bytes; the parent gathers read back bytes of
// the previous level's mask, mostly from L2, and only where a pair's own
// MBRs overlap (0.014 % of the last level).  So the instructions issued
// per mask byte come second to the bytes: one byte a thread a store cost
// the first port ~3x its byte bound.  The design follows kernel #1's
// (level_sweep.cu), with a-rows in the place of queries:
// * One launch per level on the caller's stream; level k reads level
//   k-1's slice of the output as its parent mask.  Levels are ordered on
//   the stream, so nothing carries over between launches: the TPU's
//   sequential grid with (Wa, Wb) prev/cur masks in VMEM, and its VMEM
//   ceiling near 2k x 2k, have no counterpart.
// * Wide stores (Wb >= NARROW).  A block takes one item, a tile of TB
//   b-slots and a chunk of a-rows.  Thread (r, j) owns a 16-slot window of
//   the tile and the a-rows j, j + ROWS, ..., and writes each row's 16
//   mask bytes with one aligned 16-byte store.  Rows start at k*Wa*Wb +
//   a*Wb, which is 16-byte aligned only where Wb is a multiple of 16; else
//   (13,534 and 14,237 at the join path's trees) each row's windows shift
//   left by s = (row + t0) & 15 onto its own 16-byte boundaries, the block
//   also stages the previous tile's last run, and each row goes out in
//   aligned 16-byte chunks but for a partial one at its start and end
//   (`store_bytes`, mask_io.cuh).  Kernel #1 measured this the fastest of
//   the ways to write unaligned rows (PERF.md §6).  Blocks take their
//   items tiles fastest, so the blocks in flight write whole runs of rows;
//   a column band of many rows at a time measured slower (PERF.md §6).
// * Wide loads and a box per run.  The block stages its tile's four
//   coordinate rows and parents in shared memory with 16-byte loads, its
//   chunk's a boxes and parents beside them; the threads that load a run
//   reduce it to its bounding box with shuffles.  An a-row that misses the
//   box of a window's runs (almost every one: the mask is nearly all zero)
//   costs four compares and a 16-byte zero store; only where the box
//   passes are the 16 slots compared, and the parent byte is gathered only
//   for the slots whose own MBRs overlap, in independent loads.
// * Symmetric: a block whose tile lies wholly below its chunk's diagonal
//   (every b < every a) stores zeros and stages no tile; windows that
//   straddle the diagonal mask the slots b < a.
// * Narrow B sides (Wb < NARROW: a dozen geofence zones against a million
//   objects).  Each thread takes 16 consecutive bytes of the level's flat
//   (Wa, Wb) plane on a 16-byte boundary of the output, walks their (a, b)
//   pairs and stores them with one 16-byte store (the plane's ragged head
//   and tail, a few aligned smaller ones).  A block first stages the B side
//   and the a-rows its bytes touch in shared memory, in coalesced loads, so
//   the walk reads no device memory but the parent gates.
// * No padding: blocks bounds-check both widths, so the output is exactly
//   (K, Wa, Wb) and the pair set cannot depend on the tile shape.
// * float32 and uint16 (joint-grid) tiles share one template; both
//   compare exactly (no fast math, no flush to zero).
// Measured times, against the bound and the first port: PERF.md §6.
#include "mask_io.cuh"

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 16;                 // slots of one thread's window: one 16-byte store
constexpr int TB = 256;                 // b slots of a wide tile
constexpr int TPR = TB / RUN;           // threads of one a-row
constexpr int ROWS = THREADS / TPR;     // a-rows a block works on at once
constexpr int MAX_APT = 8;              // a-rows a thread takes per item, at most
constexpr int SW = TB + 2 * RUN;        // staged: the previous run, the tile, a run of slack
constexpr int NARROW = 128;             // narrower B sides take the flat path
constexpr int NARROW_ROWS = 1026;       // a-rows a flat block stages, at most
constexpr int STAGE = 4;                // a-rows a thread loads at once when staging them

struct PairLevel {
  const void* a_cm;         // (4, Wa) this level's A tiles
  const int32_t* a_par;     // (Wa) A parents
  const void* b_cm;         // (4, Wb)
  const int32_t* b_par;     // (Wb)
  const uint8_t* prev;      // (Wa, Wb) level k-1's mask; null at level 0
  uint8_t* out;             // (Wa, Wb) this level's mask
  long long wa, wb, n_tiles;
  int symmetric, apt;
  int flat_bytes;           // plane bytes of a flat block (a multiple of 16)
};

template <typename T>
using BoxOf = typename std::conditional<std::is_same<typename QueryOf<T>::type, float>::value,
                                        float4, int4>::type;

// A's slot a of a level as a widened box (lx, ly, hx, hy).
template <typename T>
__device__ __forceinline__ BoxOf<T> box_at(const T* cm, long long w, long long a) {
  using Q = typename QueryOf<T>::type;
  BoxOf<T> v;
  v.x = (Q)__ldg(cm + a);
  v.y = (Q)__ldg(cm + w + a);
  v.z = (Q)__ldg(cm + 2 * w + a);
  v.w = (Q)__ldg(cm + 3 * w + a);
  return v;
}

template <typename V>
__device__ __forceinline__ bool overlaps(V a, V b) {
  return (a.x <= b.z) & (b.x <= a.z) & (a.y <= b.w) & (b.y <= a.w);
}

// Block = THREADS threads on one item: a tile of TB b-slots at t0 and a
// chunk of ROWS * apt a-rows at a0.  Thread (r, j) owns the window
// [t0 + 16 r - s, t0 + 16 r - s + 16) of the a-rows j, j + ROWS, ...; s
// is 0 where rows are 16-byte aligned (ALIGNED), else the row's own
// (row + t0) & 15, and the block also stages and computes the previous
// tile's last run.  Staged slot i is slot t0 - 16 + i.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(THREADS) pair_wide(const PairLevel p) {
  using Q = typename QueryOf<T>::type;
  using QV = BoxOf<T>;
  __shared__ QV sa[ROWS * MAX_APT];          // the chunk's a boxes
  __shared__ int32_t spa[ROWS * MAX_APT];    // and parents
  __shared__ QV sbox[TPR + 1];               // run boxes: the previous run, the tile's
  __shared__ __align__(16) T stile[4 * SW];  // (4, SW) coordinates
  __shared__ __align__(16) int32_t spar[SW]; // parents
  const int r = threadIdx.x % TPR, j = threadIdx.x / TPR;
  const long long W = p.wb;
  const T* a_cm = static_cast<const T*>(p.a_cm);
  const T* b_cm = static_cast<const T*>(p.b_cm);
  const bool gated = p.prev != nullptr;

  // One (chunk, tile) item a block, tiles fastest: the blocks in flight
  // write whole runs of rows, not a column band of many rows.
  const unsigned int n_tiles = (unsigned int)p.n_tiles;
  const long long chunk = blockIdx.x / n_tiles, tile = blockIdx.x - chunk * n_tiles;
  const long long t0 = tile * TB, a0 = chunk * (ROWS * p.apt);
  const long long span = W - t0;  // slots from t0 to the row's end (> 0)
  const int na = (int)min((long long)ROWS * p.apt, p.wa - a0);
  for (int i = threadIdx.x; i < na; i += THREADS) {
    sa[i] = box_at(a_cm, p.wa, a0 + i);
    if (gated) spa[i] = p.a_par[a0 + i];
  }
  // Symmetric: every b of the tile (and of the previous run) below every a.
  const bool zero = p.symmetric && t0 + TB <= a0;
  const bool load_this = !zero;
  const bool load_prev = !ALIGNED && !zero && tile > 0;
  if (load_this || load_prev) {
    // Coordinate rows, 16 bytes a thread; the G = 16 / PER neighbouring
    // lanes that load one run's part of a row reduce it to that side of
    // the run's box (min of lx, ly, max of hx, hy) with shuffles, and
    // every lane runs every step.
    constexpr int PER = 16 / sizeof(T), G = RUN / PER;
    constexpr int PER_ROW = (TB + RUN) / PER;  // staged slots [0, TB + 16) hold data
    for (int base = 0; base < 4 * PER_ROW; base += THREADS) {
      const int i = base + threadIdx.x;
      const int c = i / PER_ROW, k = (i - c * PER_ROW) * PER;
      const long long w = t0 - RUN + k;
      const bool load = i < 4 * PER_ROW && w < W && (k < RUN ? load_prev : load_this);
      Q b = c < 2 ? highest(Q()) : lowest(Q());  // the empty box: not staged, or past Wb
      if (load) {
        const T* src = b_cm + c * W + w;
        const int n = (int)min((long long)PER, W - w);  // values before the row's end
        const uint4 u = load16(src, n * (int)sizeof(T) > 16 - (int)((uintptr_t)src & 15));
        *reinterpret_cast<uint4*>(stile + c * SW + k) = u;
#pragma unroll
        for (int e = 0; e < PER; ++e)
          if (e < n) b = c < 2 ? lo_of(b, value_of<T>(u, e)) : hi_of(b, value_of<T>(u, e));
      }
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const Q o = shfl_xor(b, d);
        b = c < 2 ? lo_of(b, o) : hi_of(b, o);
      }
      if (i < 4 * PER_ROW && (i - c * PER_ROW) % G == 0)
        reinterpret_cast<Q*>(sbox + k / RUN)[c] = b;
    }
    if (gated) {
      for (int i = threadIdx.x; i < (TB + RUN) / 4; i += THREADS) {
        const int k = i * 4;
        const long long w = t0 - RUN + k;
        if (w >= W || (k < RUN ? !load_prev : !load_this)) continue;
        const int n = (int)min(4LL, W - w);
        const int32_t* src = p.b_par + w;
        stage_parents(load16(src, n * 4 > 16 - (int)((uintptr_t)src & 15)), spar + k,
                      int32_t());
      }
    }
  }
  __syncthreads();  // sa, spa, stile, spar and sbox are filled

  const QV box_r = sbox[r + 1];  // this thread's run
  QV box_u = box_r;              // with the run before it: a window of a row with s > 0
  if (!ALIGNED) {
    const QV b = sbox[r];
    box_u.x = lo_of(box_u.x, b.x);
    box_u.y = lo_of(box_u.y, b.y);
    box_u.z = hi_of(box_u.z, b.z);
    box_u.w = hi_of(box_u.w, b.w);
  }
  // Mask bits of the slots t0 + start + k, k < 16, for chunk row ai (a-row
  // a): the valid slots (in the row; in the upper triangle), the box, the
  // slots where it passes, then the parent gate, read only where a pair's
  // own MBRs overlap.  `start` is relative to t0 and may be negative.
  auto window = [&](int start, QV box, int ai, long long a) -> uint32_t {
    if (zero) return 0u;
    const long long room = span - start;  // window slots before the row's end
    uint32_t valid = room >= RUN ? 0xffffu : room <= 0 ? 0u : (1u << (int)room) - 1u;
    if (!ALIGNED && start < 0 && t0 == 0) valid &= ~((1u << -start) - 1u);  // before the row
    if (p.symmetric) {  // b >= a: slot k >= a - (t0 + start)
      const long long d = a - (t0 + start);
      valid &= d <= 0 ? 0xffffu : d >= RUN ? 0u : (0xffffu << (int)d) & 0xffffu;
    }
    const QV av = sa[ai];
    if (valid == 0 || !overlaps(av, box)) return 0u;
    const T* v = stile + RUN + start;
    uint32_t m = 0;
#pragma unroll 4
    for (int k = 0; k < RUN; ++k) {
      const QV bv = {(Q)v[k], (Q)v[SW + k], (Q)v[2 * SW + k], (Q)v[3 * SW + k]};
      m |= (uint32_t)overlaps(av, bv) << k;
    }
    m &= valid;
    if (gated && m != 0) {
      const long long pa = spa[ai];
      const uint8_t* prow = p.prev + pa * W;
      const int32_t* par = spar + RUN + start;
      uint32_t keep = 0;
#pragma unroll
      for (int k = 0; k < RUN; ++k) {  // independent loads: one round trip
        if (m & (1u << k)) {
          const long long pb = par[k];
          uint8_t g = prow[pb];
          if (p.symmetric) g |= p.prev[pb * W + pa];
          keep |= (uint32_t)(g != 0) << k;
        }
      }
      m &= keep;
    }
    return m;
  };
  // Store window `start`'s bytes that lie in the row: whole and aligned, or
  // the row's first or last bytes.
  auto put = [&](uint8_t* row, int start, uint32_t m) {
    const uint4 bytes = m != 0 ? mask_bytes(m) : make_uint4(0u, 0u, 0u, 0u);
    const long long lo = t0 + start < 0 ? -(t0 + start) : 0;  // bytes before the row
    const long long hi = min((long long)RUN, span - start);   // bytes before its end
    if (lo == 0 && hi == RUN)
      *reinterpret_cast<uint4*>(row + start) = bytes;
    else if (lo < hi)
      store_bytes(row + start, bytes, (int)lo, (int)hi);
  };

#pragma unroll 2  // two rows a step: their compares and gate loads can overlap
  for (int i = 0; i < p.apt; ++i) {
    const int ai = j + i * ROWS;
    if (ai >= na) break;
    const long long a = a0 + ai;
    uint8_t* row = p.out + a * W + t0;  // this tile's part of the row
    const int s = ALIGNED ? 0 : (int)((uintptr_t)row & 15);
    const int start = r * RUN - s;
    if (start < span) put(row, start, window(start, s != 0 ? box_u : box_r, ai, a));
    // The last tile's windows end s slots early: its last thread takes the rest.
    if (!ALIGNED && r == TPR - 1 && span <= TB && span > TB - s)
      put(row, TB - s, window(TB - s, box_r, ai, a));
  }
}

// Thread = 16 consecutive bytes of the flat (Wa, Wb) plane, from a 16-byte
// boundary of the output; a block takes flat_bytes of them and first stages
// the boxes of the a-rows they touch and the whole B side (Wb < NARROW) in
// shared memory.  A parents are read only for the pairs that overlap.
template <typename T>
__global__ void __launch_bounds__(THREADS) pair_narrow(const PairLevel p) {
  using QV = BoxOf<T>;
  __shared__ QV sb[NARROW];
  __shared__ int32_t spb[NARROW];
  __shared__ QV sa[NARROW_ROWS];
  const long long wa = p.wa, wb = p.wb, plane = wa * wb;
  const bool gated = p.prev != nullptr;
  const long long f_block = (long long)blockIdx.x * p.flat_bytes -
                            (long long)((uintptr_t)p.out & 15);  // plane index of byte 0
  const long long a_lo = max(f_block, 0LL) / wb;
  const long long a_end = (min(f_block + p.flat_bytes, plane) - 1) / wb + 1;
  const int rows = (int)(a_end - a_lo);
  const T* a_cm = static_cast<const T*>(p.a_cm);
  for (int r0 = threadIdx.x; r0 < rows; r0 += STAGE * THREADS) {
    QV v[STAGE];  // the loads of STAGE rows in flight at once
#pragma unroll
    for (int u = 0; u < STAGE; ++u)
      if (r0 + u * THREADS < rows) v[u] = box_at(a_cm, wa, a_lo + r0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < STAGE; ++u)
      if (r0 + u * THREADS < rows) sa[r0 + u * THREADS] = v[u];
  }
  for (int b = threadIdx.x; b < wb; b += THREADS) {
    sb[b] = box_at(static_cast<const T*>(p.b_cm), wb, b);
    if (gated) spb[b] = p.b_par[b];
  }
  __syncthreads();
  const long long f0 = f_block + (long long)threadIdx.x * RUN;
  if ((int)threadIdx.x * RUN >= p.flat_bytes || f0 >= plane) return;
  const int p0 = f0 < 0 ? (int)-f0 : 0, p1 = (int)min((long long)RUN, plane - f0);
  const long long a_first = (f0 + p0) / wb;
  const int b_first = (int)(f0 + p0 - a_first * wb);
  // Byte k is pair (a, b): the overlap bits first, then the parent gates
  // of the overlapping pairs in independent loads (one round trip).
  uint32_t m = 0;
  int a = (int)(a_first - a_lo), b = b_first;  // a relative to a_lo
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    if (k < p0 || k >= p1) continue;
    bool act = overlaps(sa[a], sb[b]);
    if (p.symmetric) act &= a_lo + a <= b;
    m |= (uint32_t)act << k;
    if (++b == wb) {  // the next a-row
      b = 0;
      ++a;
    }
  }
  if (gated && m != 0) {
    uint32_t keep = 0;
    a = (int)(a_first - a_lo);
    b = b_first;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      if (k < p0 || k >= p1) continue;
      if (m & (1u << k)) {
        const long long pa = __ldg(p.a_par + a_lo + a), pb = spb[b];
        uint8_t g = p.prev[pa * wb + pb];
        if (p.symmetric) g |= p.prev[pb * wb + pa];
        keep |= (uint32_t)(g != 0) << k;
      }
      if (++b == wb) {
        b = 0;
        ++a;
      }
    }
    m &= keep;
  }
  uint8_t* g = p.out + f0;  // 16-byte aligned
  const uint4 bytes = mask_bytes(m);
  if (p0 == 0 && p1 == RUN)
    *reinterpret_cast<uint4*>(g) = bytes;
  else
    store_bytes(g, bytes, p0, p1);
}

template <typename T>
int sweep_pairs(const void* a_cm, const void* a_par, const void* b_cm, const void* b_par,
                void* act, int symmetric, int levels, long long wa, long long wb,
                cudaStream_t s) {
  if (levels == 0 || wa == 0 || wb == 0) return 0;
  const long long plane = wa * wb;
  const bool narrow = wb < NARROW;
  const bool aligned = wb % 16 == 0 && (uintptr_t)act % 16 == 0;
  // Wide: a-rows per thread, the most that keeps a chunk <= ROWS * MAX_APT,
  // halved until the (chunk, tile) items are at least twice the SMs.
  const long long tiles_b = (wb + TB - 1) / TB;
  int apt = MAX_APT;
  auto chunks = [&](int n) { return (wa + (long long)ROWS * n - 1) / ((long long)ROWS * n); };
  while (apt > 1 && tiles_b * chunks(apt) < 2LL * repro_sm_count()) apt /= 2;
  const long long items = tiles_b * chunks(apt);
  // Flat: a block's bytes touch at most NARROW_ROWS a-rows.
  const int flat_bytes =
      (int)min((long long)THREADS * RUN, (NARROW_ROWS - 2) * wb / RUN * RUN);
  const long long flat_blocks = (plane + 15) / flat_bytes + 1;
  if ((narrow ? flat_blocks : items) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  uint8_t* out = (uint8_t*)act;
  for (int k = 0; k < levels; ++k) {
    PairLevel lv{};
    lv.a_cm = (const T*)a_cm + 4LL * k * wa;
    lv.a_par = (const int32_t*)a_par + k * wa;
    lv.b_cm = (const T*)b_cm + 4LL * k * wb;
    lv.b_par = (const int32_t*)b_par + k * wb;
    lv.prev = k == 0 ? nullptr : out + (k - 1) * plane;
    lv.out = out + k * plane;
    lv.wa = wa;
    lv.wb = wb;
    lv.symmetric = symmetric;
    lv.apt = apt;
    lv.n_tiles = tiles_b;
    lv.flat_bytes = flat_bytes;
    if (narrow) {
      const long long bytes = plane + (long long)((uintptr_t)lv.out & 15);
      pair_narrow<T><<<(unsigned int)((bytes + flat_bytes - 1) / flat_bytes), THREADS, 0, s>>>(
          lv);
    } else if (aligned) {
      pair_wide<T, true><<<(unsigned int)items, THREADS, 0, s>>>(lv);
    } else {
      pair_wide<T, false><<<(unsigned int)items, THREADS, 0, s>>>(lv);
    }
    REPRO_LAUNCH_CHECK();
  }
  return 0;
}

}  // namespace

extern "C" {

// a_cm: (K, 4, Wa), b_cm: (K, 4, Wb), both float32 (tile_u16 = 0) or both
// uint16 (tile_u16 = 1); a_par: (K, Wa) and b_par: (K, Wb) int32; act:
// (K, Wa, Wb) uint8 output.  symmetric needs Wa == Wb (one schedule).
// Returns 0 or the CUDA error of a launch.
int repro_pair_sweep(const void* a_cm, const void* a_par, const void* b_cm, const void* b_par,
                     void* act, int tile_u16, int symmetric, int levels, long long wa,
                     long long wb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (symmetric && wa != wb) return (int)cudaErrorInvalidValue;
  if (tile_u16)
    return sweep_pairs<uint16_t>(a_cm, a_par, b_cm, b_par, act, symmetric, levels, wa, wb, s);
  return sweep_pairs<float>(a_cm, a_par, b_cm, b_par, act, symmetric, levels, wa, wb, s);
}

}  // extern "C"
