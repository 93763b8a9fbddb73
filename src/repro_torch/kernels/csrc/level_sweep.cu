// Fused level sweep of the region search: the per-level active mask.
//
//   act[l, q, w] = ov(q, mbr[l, :, w]) & act[l-1, q, parent[l, w]]
//
// with level 0 unconditional at the root slot (tree schedules) or plain
// `ov` (pyramid), and levels >= uncond_from flat (`ov` only), exactly as
// `_act_formula` of src/repro/kernels/pyramid_scan.py.
//
// One kernel body, `sweep_item`, serves three TPU kernels of that file:
// * `repro_level_sweep` replaces `_sweep_kernel` (`level_sweep`,
//   stream=False): float32 tiles with int32 parents, uint16 tiles with
//   uint16 or int32 parents;
// * `repro_level_sweep_hier` replaces `_hier_sweep_kernel`
//   (`level_sweep_hier`, precision="compact8"): levels below `split` read
//   uint8 tiles with the coarse queries, the rest uint16 tiles with the fine
//   ones, each on its own segment's pointer, so neither the TPU kernel's
//   clamped index maps nor its sentinel padding is needed; narrow levels
//   (the trees') all in one launch of a persistent grid (`sweep_hier_all`,
//   below), wide ones (the pyramid's) one launch a level;
// * `repro_level_sweep_stream` replaces `_stream_sweep_kernel`
//   (`level_sweep`, stream=True): the same mask, bit for bit, plus the
//   dead-window skip and its count (below).
// The TPU's sequential grid becomes one launch per level for #1 and #2
// (level order is the only dependency; ROADMAP C3) and, for #3 on narrow
// levels, one launch whose blocks wait on their parents' done flags; its
// MXU one-hot gather becomes a lazy gather of the previous level's mask.
//
// What bounds it on an H100: the stores.  Each level writes Q*W mask bytes
// (2.816 GB a call at L 11, Q 256, W 1e6: 0.84 ms at the data sheet's
// 3.35 TB/s) and reads W*(6..20) tile and parent bytes.  The compares are a
// few operations a byte, so the instructions issued per mask byte come
// second: one byte a thread a store would cost about ten.  What the design
// does:
// * Wide stores.  A block takes one item, a tile of block_w slots and a
//   chunk of queries.  Thread (r, j) owns a 16-slot window of the tile and
//   the queries j, j + rows, ... of the chunk, and writes each query's 16
//   mask bytes with one aligned 16-byte store: a warp stores 512
//   contiguous bytes of a row, or whole 32-byte sectors of several rows
//   when block_w < 512.  Rows start at q*W.  Where W is a multiple of 16
//   (the pyramid) the windows are the tile's runs of 16.  Otherwise
//   (the trees: W 13,534 is 2-byte aligned, 14,237 odd) each row's
//   windows shift left by s = (row + t0) & 15 onto the row's 16-byte
//   boundaries: the block also stages the previous tile's last run, so
//   every store is a whole aligned chunk but for a partial one at each
//   row's start and end (at most four aligned 1-8 byte stores each).
//   Staging the rows in shared memory instead, or joining the chunk that
//   straddles two tiles with a warp shuffle, measured slower (H100 80GB
//   HBM3, 700 W).
// * Wide tile loads.  The tile's four coordinate rows and its parents go
//   to shared memory in 16-byte loads, one or two aligned ones joined by
//   funnel shifts where a row is not 16-byte aligned; narrow tiles are
//   widened to int32 only when read, as `_overlap_tile` does.
// * A box per run.  The threads that load a run's part of a row reduce it
//   to that side of the run's bounding box with warp shuffles; a query
//   that misses the box (almost every one, on the pyramid) costs four
//   compares and the store of 16 zero bytes.  Exact: a slot that passes
//   all four compares makes the box pass them too (fminf/fmaxf skip NaN
//   slots, which never pass).  Only where the box passes are the 16 slots
//   compared, and the parent gate reads `prev` only for the slots that
//   overlap, in independent loads (one round trip a window).
// * Fat query chunks.  A chunk holds up to 256 queries, staged in shared
//   memory once, up to 8 a thread, one row pointer each.  The chunk
//   halves until the items are at least twice the SMs, so the trees'
//   narrow levels still fill the card, and the grid is one block an item:
//   a grid of a few blocks per SM walking the items measured slower (the
//   same card).
//
// The streaming sweep's dead-window skip, and what differs from the TPU:
// the MBR tile of (level l, tile t) is not read, and its mask is zero, when
//   * the tile is statically empty (win_off[l, t] < 0, at every level), or
//   * level l is gated (0 < l < uncond_from) and no slot of level l-1 in
//     [win_off[l, t], win_off[l, t] + win_w) survived for ANY query.
// A tile is block_w slots wide (the tiling of win_off), and a block takes
// the decision once for its tile, the same in every thread, before it
// reads the tile (and once for the previous tile, whose last run it
// stages where rows are not 16-byte aligned); a skipped tile's zeros go
// out with the same wide stores.  On the TPU one core walked the grid in
// order and tested each tile's prefetched parent window.  Here a block
// holds one query chunk, so "any query" spans blocks: a level whose
// successor is gated also marks a (W,) "any" row (bytes set to 1, no
// atomics), and the next level tests its windows on it:
// * narrow windows (win_w <= 8 block_w; the pyramid's are 128 slots): each
//   block ORs the window's bytes itself, at most 8 block_w bytes from L2,
//   and no launch is added;
// * wide windows (the mqr-tree's are 2,048 slots at block_w 128; a
//   Hilbert-ordered schedule's span the whole width, where a scan per tile
//   would cost O(T * W)): one single-pass scan with decoupled look-back
//   (`repro_flag_prefix_scan`, common.cuh) turns the row into an exclusive
//   prefix, and the window test is prefix[hi] == prefix[lo] in O(1).  Per
//   gated level that is one launch of ceil(W / 4,096) blocks reading W
//   bytes and writing 4 (W + 1): 4 blocks at W 13,534, 245 blocks and ~5 MB at W 1e6.
// The any rows rotate over three buffers: level l marks buffer l % 3,
// clears buffer (l+1) % 3 for level l+1 (its last reader, level l-1 or the
// scan of level l-2, is done), and clears the scan's state for its own
// scan.  So a call adds one memset (buffer 0) to its L sweep launches, and
// one scan launch per gated level only for wide windows.  Levels are
// separate launches on one stream, so level l-1 is complete before level l
// starts: the TPU kernel's rule "always fetch the first tile of a level"
// has no counterpart (ROADMAP C6).  The skip count is the kernel's own:
// one atomic per skipped (level, tile), made by the block of query chunk 0,
// into a caller's int64.  The skip saves tile and parent reads only; the
// (L, Q, W) mask is still written in full, because the epilogue reads it.
//
// Measured times, against the bound and the first port: PERF.md §6.
// Compares stay exact: no fast math, no flush to zero (ROADMAP C1).
#include "mask_io.cuh"

#include <type_traits>

namespace {

constexpr int THREADS = 256;    // threads of a sweep block
constexpr int RUN = 16;         // consecutive slots of one thread: one 16-byte store
constexpr int MAX_QPT = 8;      // queries a thread takes per item, at most
constexpr int MAX_CHUNK = 256;  // queries of a block's chunk, at most
constexpr int WIDE_WINDOW = 8;  // windows wider than this many tiles use the scan

enum Mode { ROOT_ONLY = 0, OVERLAP = 1, GATED = 2 };

__host__ __device__ inline int level_mode(int l, int root_unconditional, int uncond_from) {
  if (l == 0) return root_unconditional ? ROOT_ONLY : OVERLAP;
  return (l >= uncond_from) ? OVERLAP : GATED;
}

// One level of a sweep.  The kernel #2 fields are null / unused for #1, #3;
// `n_real` and `parents_done` are #3's.
struct SweepLevel {
  const void* queries;     // (Q, 4) float32 (float32 tiles) or int32 (grid cells)
  const void* mbr;         // (4, W) tiles of this level
  const void* parent;      // (W,) parent slots of this level
  const uint8_t* prev;     // (Q, W) mask of level l-1 (gated levels)
  uint8_t* act;            // (Q, W) mask of this level
  long long nq, width, n_chunks;
  const int32_t* n_real;   // #3: (L,) real slots a level, or null: slots past them are padding
  int level;
  int mode, tile_w, qpt;
  // #3, all levels in one launch: level l-1's item flags, (tile, chunk)
  // item i's at parents_done[i], set once the item is stored; a gated item
  // waits on those of the tiles its parents lie in before it reads `prev`
  // (null: levels are ordered by the stream)
  const unsigned int* parents_done;
  // kernel #2
  const int32_t* win_off;  // (T,) windows of this level
  int win_w;
  const uint8_t* any_prev; // narrow windows: level l-1's any row
  const int32_t* prefix;   // wide windows: its exclusive prefix, (W + 1,)
  uint8_t* any_out;        // this level's any row (its successor is gated)
  uint8_t* any_clear;      // the any row level l+1 marks, cleared here
  unsigned long long* scan_state;  // this level's scan state, cleared here
  int scan_words;
  unsigned long long* skipped;
};

// Kernel #2's rule for one tile of this level, the same in every thread:
// statically empty, or gated with no survivor of level l-1 in its window.
// Every thread of the block calls it.
__device__ __forceinline__ bool tile_skipped(const SweepLevel& a, long long tile) {
  const int off = a.win_off[tile];
  if (off < 0) return true;
  if (a.mode != GATED) return false;
  const long long lo = min((long long)off, a.width);
  const long long hi = min((long long)off + a.win_w, a.width);
  if (a.prefix != nullptr) return a.prefix[hi] == a.prefix[lo];
  int found = 0;
  for (long long w = lo + threadIdx.x; w < hi; w += THREADS) found |= a.any_prev[w];
  return !__syncthreads_or(found);
}

// Spin until *flag is set, with an acquire load (so the block's loads after
// the barrier that follows see what the flagged item stored) and
// __nanosleep back-off.
__device__ __forceinline__ void wait_flag(const unsigned int* flag) {
  unsigned int ns = 32;
  for (;;) {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
    if (v != 0) break;
    __nanosleep(ns);
    ns = ns < 256 ? 2 * ns : 256;
  }
}

// Set *flag with release semantics: the block's stores before the barrier
// that precedes it are visible to whoever acquires the flag.
__device__ __forceinline__ void publish(unsigned int* flag) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" : : "l"(flag), "r"(1u) : "memory");
}

// Warp 0 of a gated #3 item waits until the level l-1 items that stored
// the `prev` bytes its slots gate on are flagged: the items of this query
// chunk whose tiles hold the parents staged in spar[k0, k1).  A tile's
// block stores a row's slots [t*tw - s, (t+1)*tw - s), s < 16, so parent p
// lies in tile p / tw or (p + 15) / tw.
__device__ __forceinline__ void wait_parents(const unsigned int* parents_done,
                                             const int32_t* spar, int k0, int k1, int tw,
                                             long long n_tiles, long long n_chunks,
                                             long long chunk) {
  const int lane = threadIdx.x;
  int lo = INT32_MAX, hi = -1;
  for (int k = k0 + lane; k < k1; k += 32) {
    lo = min(lo, spar[k]);
    hi = max(hi, spar[k]);
  }
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  if (hi < 0) return;
  const long long t_hi = min((long long)(hi + RUN - 1) / tw, n_tiles - 1);
  for (long long t = max(lo, 0) / tw + lane; t <= t_hi; t += 32)
    wait_flag(parents_done + t * n_chunks + chunk);
  __syncwarp();
}

// Block = THREADS threads on one item (`item`: tile * n_chunks + chunk of
// its level): a tile of tw = block_w slots and a chunk of QC = rows * qpt
// queries.  The block copies the tile's four coordinate rows and its
// parents into shared memory in 16-byte loads, the threads that load a
// 16-slot run reduce it to its bounding box, and thread (r, j) then owns
// the 16-slot window
// [t0 + 16 r - s, t0 + 16 r - s + 16) of the queries j, j + rows, ...:
// the box first, the slots only where the box passes, one aligned 16-byte
// store.  s = (row + t0) & 15 puts the windows of a row on its 16-byte
// boundaries: 0 where W is a multiple of 16 (ALIGNED); else the block also
// stages and computes the previous tile's last run (and takes that tile's
// skip decision), so each row goes out in aligned 16-byte chunks but for
// a partial one at its start and one at its end.  Staged slot i is slot
// t0 - 16 + i.  HIER (#3) adds the padding skip: a tested level's slots at
// or past `real` are stored zero and never computed, so a tile wholly past
// it loads nothing (the previous tile's last run too, where it is wholly
// past it) and a tile that straddles it reads `prev` only for the slots
// before it; and the wait on its parents' items, for exactly those slots.
// Both are compiled out of #1 and #2, whose tree rows ran ~7 % slower with
// them in (H100 80GB HBM3, 700 W).
template <typename T, typename P, bool ALIGNED, bool STREAM, bool HIER>
__device__ __forceinline__ void sweep_item(const SweepLevel& a, long long item, uint4* smem) {
  using Q = typename QueryOf<T>::type;
  using QV = typename std::conditional<std::is_same<Q, float>::value, float4, int4>::type;
  const int tw = a.tile_w;
  const int tpr = tw / RUN;          // runs of a tile: threads per row
  const int rows = THREADS / tpr;    // rows a block works on at once
  const int qc = rows * a.qpt;       // queries of a chunk
  const int sw = tw + 2 * RUN;       // staged: the previous run, the tile, a run of slack
  QV* sq = reinterpret_cast<QV*>(smem);                         // (qc,) queries
  QV* sbox = sq + qc;                                            // (tpr + 1,) run boxes
  T* stile = reinterpret_cast<T*>(sbox + tpr + 1);               // (4, sw) coordinates
  int32_t* spar = reinterpret_cast<int32_t*>(stile + 4 * sw);  // (sw,) parents
  const int r = threadIdx.x % tpr, j = threadIdx.x / tpr;
  const long long W = a.width;
  const Q* queries = static_cast<const Q*>(a.queries);
  const T* mbr = static_cast<const T*>(a.mbr);
  const P* parent = static_cast<const P*>(a.parent);
  const bool gated = a.mode == GATED;

  if (STREAM && a.scan_state != nullptr && item == 0)
    for (int i = threadIdx.x; i < a.scan_words; i += THREADS) a.scan_state[i] = 0ULL;

  const unsigned int n_chunks = (unsigned int)a.n_chunks;
  const long long tile = item / n_chunks, chunk = item - tile * n_chunks;
  const long long t0 = tile * tw, q0 = chunk * qc;
  const long long span = W - t0;      // slots from t0 to the row's end (> 0)
  const int nqc = (int)min((long long)qc, a.nq - q0);
  const bool tested = a.mode != ROOT_ONLY;
  bool skip = false, skip_prev = false;  // uniform over the block
  // #3 (HIER): the level's slots [real, W) are padding (never-overlap tiles)
  const long long real = HIER && a.n_real != nullptr ? min((long long)a.n_real[a.level], W) : W;
  if (HIER && tested) {  // padding: this tile, the previous tile's last run
    skip = t0 >= real;
    skip_prev = t0 - RUN >= real;
  }
  if (!HIER || (tested && !(skip && (ALIGNED || tile == 0 || skip_prev))))
    for (int i = threadIdx.x; i < nqc; i += THREADS) sq[i] = query_vec(queries + (q0 + i) * 4);
  if (STREAM) {
    if (a.any_clear != nullptr && chunk == 0)
      for (long long w = t0 + threadIdx.x; w < t0 + min((long long)tw, span); w += THREADS)
        a.any_clear[w] = 0;
    skip = tile_skipped(a, tile);
    if (skip && chunk == 0 && threadIdx.x == 0) atomicAdd(a.skipped, 1ULL);
    if (!ALIGNED && tile > 0) skip_prev = tile_skipped(a, tile - 1);
  }
  const bool load_this = tested && !skip;
  const bool load_prev = !ALIGNED && tested && !skip_prev && tile > 0;
  if (load_this || load_prev) {
    // Coordinate rows, 16 bytes a thread.  The G = 16 / PER threads that
    // load one run's part of a row are neighbouring lanes: they reduce it
    // to that side of the run's box (min of lx, ly, max of hx, hy) with
    // shuffles, and every lane runs every step.
    constexpr int PER = 16 / sizeof(T), G = RUN / PER;
    const int per_row = (tw + RUN) / PER;  // staged slots [0, tw + 16) hold data
    for (int base = 0; base < 4 * per_row; base += THREADS) {
      const int i = base + threadIdx.x;
      const int c = i / per_row, k = (i - c * per_row) * PER;
      const long long w = t0 - RUN + k;
      const bool load = i < 4 * per_row && w < W && (k < RUN ? load_prev : load_this);
      Q b = c < 2 ? highest(Q()) : lowest(Q());  // the empty box: not staged, or past W
      if (load) {
        const T* src = mbr + c * W + w;
        const int n = (int)min((long long)PER, W - w);  // values before the row's end
        const uint4 u = load16(src, n * (int)sizeof(T) > 16 - (int)((uintptr_t)src & 15));
        *reinterpret_cast<uint4*>(stile + c * sw + k) = u;
#pragma unroll
        for (int e = 0; e < PER; ++e)
          if (e < n) b = c < 2 ? lo_of(b, value_of<T>(u, e)) : hi_of(b, value_of<T>(u, e));
      }
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const Q o = shfl_xor(b, d);
        b = c < 2 ? lo_of(b, o) : hi_of(b, o);
      }
      if (i < 4 * per_row && (i - c * per_row) % G == 0)
        reinterpret_cast<Q*>(sbox + k / RUN)[c] = b;
    }
    if (gated) {
      constexpr int PPER = 16 / sizeof(P);
      for (int i = threadIdx.x; i < (tw + RUN) / PPER; i += THREADS) {
        const int k = i * PPER;
        const long long w = t0 - RUN + k;
        if (w >= W || (k < RUN ? !load_prev : !load_this)) continue;
        const int n = (int)min((long long)PPER, W - w);
        const P* src = parent + w;
        stage_parents(load16(src, n * (int)sizeof(P) > 16 - (int)((uintptr_t)src & 15)), spar + k,
                      P());
      }
    }
  }
  __syncthreads();  // sq, stile, spar and sbox are filled
  if (HIER && a.parents_done != nullptr && gated && (load_this || load_prev)) {
    // #3: the staged real slots' parents, then their items' flags
    if (threadIdx.x < 32) {
      const long long last = real - (t0 - RUN);  // staged slots before `real`
      wait_parents(a.parents_done, spar, load_prev ? 0 : RUN,
                   (int)min((long long)(load_this ? tw + RUN : RUN), last), tw,
                   (W + tw - 1) / tw, a.n_chunks, chunk);
    }
    __syncthreads();  // the parents' items are stored: `prev` may be read
  }
  if (j >= rows) return;  // rows * tpr may fall short of THREADS

  const QV box_r = sbox[r + 1];  // this thread's run
  QV box_u = box_r;              // with the run before it: a window of a row with s > 0
  if (!ALIGNED) {
    const QV b = sbox[r];
    box_u.x = lo_of(box_u.x, b.x);
    box_u.y = lo_of(box_u.y, b.y);
    box_u.z = hi_of(box_u.z, b.z);
    box_u.w = hi_of(box_u.w, b.w);
  }
  // Mask bits of the 16 staged slots from staged slot `at` for query qv (row
  // q): the box first, the slots where it passes, then the parent gate on
  // row q of level l-1, read only where a node overlaps.
  auto test_slots = [&](int at, QV box, QV qv, uint32_t valid, long long q) -> uint32_t {
    if (valid == 0 || !((box.x <= qv.z) & (qv.x <= box.z) & (box.y <= qv.w) & (qv.y <= box.w)))
      return 0u;
    const T* v = stile + at;
    uint32_t m = 0;
#pragma unroll 4
    for (int k = 0; k < RUN; ++k) {
      const Q lx = (Q)v[k], ly = (Q)v[sw + k], hx = (Q)v[2 * sw + k], hy = (Q)v[3 * sw + k];
      m |= (uint32_t)((lx <= qv.z) & (qv.x <= hx) & (ly <= qv.w) & (qv.y <= hy)) << k;
    }
    m &= valid;
    if (gated && m != 0) {
      const uint8_t* prow = a.prev + q * W;
      const int32_t* par = spar + at;
      uint32_t keep = 0;
#pragma unroll
      for (int k = 0; k < RUN; ++k)  // independent loads: one round trip
        if (m & (1u << k)) keep |= (uint32_t)(prow[par[k]] != 0) << k;
      m &= keep;
    }
    return m;
  };
  // Mask bits of the slots t0 + start + k, k < 16, for query qi (row q);
  // `start` is relative to t0 and may be negative (the previous tile).
  auto window = [&](int start, QV box, int qi, long long q) -> uint32_t {
    const long long room = span - start;  // window slots before the row's end
    uint32_t valid = room >= RUN ? 0xffffu : room <= 0 ? 0u : (1u << (int)room) - 1u;
    if (!ALIGNED && start < 0) {  // slots of the previous tile, none before the row
      const uint32_t before = (1u << -start) - 1u;
      valid &= t0 == 0 || skip_prev ? ~before : 0xffffu;
    }
    if ((STREAM || HIER) && skip) valid &= start < 0 ? (1u << -start) - 1u : 0u;  // zero
    if (HIER && tested) {  // #3: the slots at or past `real` are stored zero, not computed
      const long long left = real - (t0 + start);
      valid &= left >= RUN ? 0xffffu : left <= 0 ? 0u : (1u << (int)left) - 1u;
    }
    if (a.mode == ROOT_ONLY) {  // only slot 0, bit -(t0 + start) of tile 0's first window
      const long long z = -(t0 + start);
      return z >= 0 && z < RUN ? valid & (1u << (int)z) : 0u;
    }
    return test_slots(RUN + start, box, sq[qi], valid, q);
  };
  // Store window `start`'s bytes that lie in the row: whole and aligned, or
  // the row's first or last bytes.  Kernel #2 also marks the survivors.
  auto put = [&](uint8_t* row, int start, uint32_t m) {
    if (STREAM && a.any_out != nullptr)
      for (uint32_t bits = m; bits != 0; bits &= bits - 1)
        a.any_out[t0 + start + __ffs(bits) - 1] = 1;
    const uint4 bytes = m != 0 ? mask_bytes(m) : make_uint4(0u, 0u, 0u, 0u);
    const long long lo = t0 + start < 0 ? -(t0 + start) : 0;  // bytes before the row
    const long long hi = min((long long)RUN, span - start);   // bytes before its end
    if (lo == 0 && hi == RUN)
      *reinterpret_cast<uint4*>(row + start) = bytes;
    else if (lo < hi)
      store_bytes(row + start, bytes, (int)lo, (int)hi);
  };

#pragma unroll 2  // two queries a step: their compares and gate loads can overlap
  for (int i = 0; i < a.qpt; ++i) {
    const int qi = j + i * rows;
    if (qi >= nqc) break;
    const long long q = q0 + qi;
    uint8_t* row = a.act + q * W + t0;  // this tile's part of the row
    const int s = ALIGNED ? 0 : (int)((uintptr_t)row & 15);
    const int start = r * RUN - s;
    if (start < span) put(row, start, window(start, s != 0 ? box_u : box_r, qi, q));
    // The last tile's windows end s slots early: its last thread takes the rest.
    if (!ALIGNED && r == tpr - 1 && span <= tw && span > tw - s)
      put(row, tw - s, window(tw - s, box_r, qi, q));
  }
}

// One launch a level (#1, #2): one item a block.
template <typename T, typename P, bool ALIGNED, bool STREAM, bool HIER>
__global__ void __launch_bounds__(THREADS, 4) sweep_level(const SweepLevel a) {
  extern __shared__ uint4 smem[];
  sweep_item<T, P, ALIGNED, STREAM, HIER>(a, blockIdx.x, smem);
}

// ---- launch plan, shared by the three entry points ----------------------

struct Plan {
  int qpt;
  long long n_chunks, n_items;  // one block an item
  bool aligned;  // W is a multiple of 16: rows start on 16-byte boundaries
};

// Queries per thread: the most that keeps a chunk <= MAX_CHUNK, halved
// until the (tile, chunk) items are at least twice the SMs.
inline Plan plan_sweep(long long nq, long long width, int block_w, const void* act) {
  const int rows = THREADS / (block_w / RUN);
  const long long n_tiles = (width + block_w - 1) / block_w;
  const long long sms = repro_sm_count();
  Plan p;
  p.aligned = width % 16 == 0 && (uintptr_t)act % 16 == 0;
  p.qpt = MAX_CHUNK / rows < MAX_QPT ? (MAX_CHUNK / rows > 0 ? MAX_CHUNK / rows : 1) : MAX_QPT;
  auto chunks = [&](int qpt) { return (nq + (long long)rows * qpt - 1) / ((long long)rows * qpt); };
  while (p.qpt > 1 && n_tiles * chunks(p.qpt) < 2 * sms) p.qpt /= 2;
  p.n_chunks = chunks(p.qpt);
  p.n_items = n_tiles * p.n_chunks;
  return p;
}

// Shared memory of a sweep block: queries, run boxes, the staged slots and
// their parents (< 27 KB).
inline size_t sweep_smem(const Plan& p, int block_w, size_t tile_bytes) {
  const int rows = THREADS / (block_w / RUN);
  const size_t staged = (size_t)block_w + 2 * RUN;  // the previous run, the tile, slack
  return (size_t)rows * p.qpt * 16 + (size_t)(block_w / RUN + 1) * 16 +
         4 * staged * tile_bytes + 4 * staged;
}

template <typename T, typename P, bool STREAM, bool HIER = false>
int launch(SweepLevel a, const Plan& p, int block_w, cudaStream_t stream) {
  a.tile_w = block_w;
  a.qpt = p.qpt;
  a.n_chunks = p.n_chunks;
  const size_t smem = sweep_smem(p, block_w, sizeof(T));
  const unsigned int grid = (unsigned int)p.n_items;
  if (p.aligned)
    sweep_level<T, P, true, STREAM, HIER><<<grid, THREADS, smem, stream>>>(a);
  else
    sweep_level<T, P, false, STREAM, HIER><<<grid, THREADS, smem, stream>>>(a);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// Level l of a sweep: every field but the plan's.
template <typename P>
__host__ __device__ inline SweepLevel level_args(const void* queries, const void* mbr_l,
                                                 const void* parent, void* act, long long nq,
                                                 int l, long long width, int mode) {
  const size_t plane = (size_t)nq * (size_t)width;  // mask bytes per level
  SweepLevel a{};
  a.queries = queries;
  a.mbr = mbr_l;
  a.parent = (const P*)parent + (size_t)l * (size_t)width;
  a.prev = l > 0 ? (const uint8_t*)act + (size_t)(l - 1) * plane : nullptr;
  a.act = (uint8_t*)act + (size_t)l * plane;
  a.nq = nq;
  a.width = width;
  a.mode = mode;
  return a;
}

template <typename T, typename P>
int sweep(const void* queries, const void* mbr_cm, const void* parent, void* act,
          long long nq, int levels, long long width, int root_unconditional,
          int uncond_from, int block_w, cudaStream_t stream) {
  if (nq == 0 || width == 0) return 0;
  const Plan plan = plan_sweep(nq, width, block_w, act);
  for (int l = 0; l < levels; ++l) {
    const SweepLevel a = level_args<P>(
        queries, (const T*)mbr_cm + (size_t)l * 4 * (size_t)width, parent, act, nq, l,
        width, level_mode(l, root_unconditional, uncond_from));
    const int rc = launch<T, P, false>(a, plan, block_w, stream);
    if (rc) return rc;
  }
  return 0;
}

// ---- kernel #3: every level of the hierarchical sweep in one launch ------
//
// Levels [0, split) read uint8 tiles with the coarse queries q8, levels
// [split, L) uint16 tiles with the fine queries q16.  A persistent grid,
// at most the blocks the SMs hold at once, walks the items (level, tile,
// query chunk) of every level in level order: a block takes the next item
// from a ticket, sweeps it with the body of #1 (`sweep_item`), and after a
// barrier sets the item's done flag with a release store.  A gated item
// (0 < l < uncond_from) that read its tile waits, before it reads `prev`,
// only on the level l-1 items of its own query chunk whose tiles hold its
// slots' parents (`wait_parents`: acquire loads with back-off), not on the
// whole level.  Items at or past n_real[l] (padding on the trees' upper
// levels: 5^l or fewer of the mqr-tree's 13,534 slots are real at level l)
// store their zeros, read nothing and wait for nothing; in an item that
// straddles n_real[l] the slots past it are stored zero too, so no slot
// reads a `prev` byte its wait did not cover.  n_real is the caller's
// promise that the mask is zero there (a schedule's padding never overlaps
// a query): then the result is the plain mask.  The persistent
// loop holds two blocks an SM (128 registers a thread: with 64 it spilled).
//
// A sweep whose levels each hold more than WIDE_LEVEL grids of items (the
// pyramid: 7,813 items a level at W 1e6) runs as one launch a level of #1's
// kernel instead, with the same skip of padding tiles: there the launch gap
// is ~1 % of a level, and #1's four blocks an SM hide more latency than the
// persistent loop's two: on the pyramid the persistent grid, even with
// several tiles an item, was slower than these launches (H100 80GB HBM3,
// 700 W; PERF.md §6).  On the trees it is the other way round: there
// those launches, with the same skip, took 0.0760-0.0778 ms at Q 256 and
// 0.0435-0.0441 ms at Q 16 against the persistent grid's 0.0626-0.0629
// and 0.0302-0.0304 (mqr-tree, W 13,534; same card,
// scripts/time_scan_pair.py --wide-level 0), since a level's time there is
// one item's latency, which the skip does not shorten.
//
// Why the persistent grid cannot deadlock, however many blocks are resident
// (the argument of the decoupled look-back scan in common.cuh): a ticket is
// taken only by a block that is running, and items are handed out in level
// order, so the items a waiting item waits on (level l-1's) hold lower
// tickets, each taken by a running block that waits only on items with
// lower tickets still.  The lowest unfinished item waits on nothing
// unfinished, so it finishes, and by induction every item does.  Two calls
// on two streams cannot hold each other up either: neither waits on an
// item it has not handed to a running block.  The grid is sized from the
// occupancy only so that no block sits unscheduled while the SMs have room.
//
// `prev` is stored by other blocks of the same launch, so it is read with
// plain coherent loads after the acquire, never through the read-only
// path (`__ldg`, ld.global.nc): `SweepLevel::prev` is not restrict, and
// tiles and parents, which no block writes, are the only `__ldg` reads.
// The ticket and the flags live in the caller's scratch, zeroed by a
// memset on the call's stream before the launch, so calls on one stream
// or on two (each with its own scratch) never see each other's flags.

// The arguments of a hierarchical sweep call.
struct HierArgs {
  const void* q8;
  const void* q16;
  const uint8_t* mbr8;    // (split, 4, W)
  const uint16_t* mbr16;  // (L - split, 4, W)
  const void* parent;     // (L, W)
  void* act;              // (L, Q, W)
  const int32_t* n_real;  // (L,) or null
  long long nq, width;
  int levels, split, root_unconditional, uncond_from;
};

// Level l of a hierarchical sweep: every field but the plan's.
template <typename P>
__host__ __device__ inline SweepLevel hier_level(const HierArgs& h, int l) {
  const bool coarse = l < h.split;
  SweepLevel a = level_args<P>(
      coarse ? h.q8 : h.q16,
      coarse ? (const void*)(h.mbr8 + (size_t)l * 4 * (size_t)h.width)
             : (const void*)(h.mbr16 + (size_t)(l - h.split) * 4 * (size_t)h.width),
      h.parent, h.act, h.nq, l, h.width, level_mode(l, h.root_unconditional, h.uncond_from));
  a.n_real = h.n_real;
  a.level = l;
  return a;
}

struct HierSweep {
  HierArgs hier;
  unsigned int* counts;   // the ticket, then a done flag an item (hier_scratch_bytes)
  long long per_level, n_items;
  Plan plan;
  int block_w;
};

constexpr int TICKET_WORDS = 32;  // the ticket's own 128-byte line, then the flags
constexpr int HIER_BLOCKS = 2;    // blocks an SM of the persistent sweep: 128 registers
constexpr int WIDE_LEVEL = 4;     // levels of more items than this many grids launch alone

template <typename P, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, HIER_BLOCKS) sweep_hier_all(const HierSweep h) {
  extern __shared__ uint4 smem[];
  __shared__ unsigned int s_item;
  unsigned int* done = h.counts + TICKET_WORDS;  // item i's flag at done[i]
  for (;;) {
    __syncthreads();  // the previous item is done with shared memory and s_item
    if (threadIdx.x == 0) s_item = atomicAdd(h.counts, 1u);
    __syncthreads();
    const long long item = s_item;
    if (item >= h.n_items) return;
    const int l = (int)(item / h.per_level);
    SweepLevel a = hier_level<P>(h.hier, l);
    a.tile_w = h.block_w;
    a.qpt = h.plan.qpt;
    a.n_chunks = h.plan.n_chunks;
    a.parents_done = l > 0 ? done + (size_t)(l - 1) * h.per_level : nullptr;
    const long long in_level = item - (long long)l * h.per_level;
    if (l < h.hier.split)
      sweep_item<uint8_t, P, ALIGNED, false, true>(a, in_level, smem);
    else
      sweep_item<uint16_t, P, ALIGNED, false, true>(a, in_level, smem);
    __syncthreads();  // every store of the item is made
    // Only a gated level reads the flags of the level above it.
    if (threadIdx.x == 0 && l + 1 < h.hier.levels &&
        level_mode(l + 1, h.hier.root_unconditional, h.hier.uncond_from) == GATED)
      publish(done + item);
  }
}

// Scratch of a persistent call: the ticket's line and a flag an item.
inline long long hier_scratch_bytes(long long n_items) { return 4LL * (TICKET_WORDS + n_items); }

template <typename P>
int sweep_hier(const HierArgs& args, void* scratch, int block_w, cudaStream_t stream) {
  if (args.nq == 0 || args.width == 0 || args.levels == 0) return 0;
  const Plan plan = plan_sweep(args.nq, args.width, block_w, args.act);
  // the uint16 levels stage the larger tiles
  const size_t smem = sweep_smem(plan, block_w, sizeof(uint16_t));
  auto kernel = plan.aligned ? sweep_hier_all<P, true> : sweep_hier_all<P, false>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * repro_sm_count();
  if (plan.n_items > WIDE_LEVEL * resident) {
    // A level of many waves (the pyramid's 7,813 items at W 1e6): one
    // launch a level of #1's kernel, 4 blocks an SM, with the same skip of
    // padding tiles; its launch gap is ~1 % of such a level's time.
    for (int l = 0; l < args.levels; ++l) {
      const int rc = l < args.split
          ? launch<uint8_t, P, false, true>(hier_level<P>(args, l), plan, block_w, stream)
          : launch<uint16_t, P, false, true>(hier_level<P>(args, l), plan, block_w, stream);
      if (rc) return rc;
    }
    return 0;
  }
  HierSweep h{};
  h.hier = args;
  h.counts = (unsigned int*)scratch;
  h.plan = plan;
  h.block_w = block_w;
  h.per_level = plan.n_items;
  h.n_items = h.per_level * args.levels;
  if (h.n_items >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  e = cudaMemsetAsync(scratch, 0, (size_t)hier_scratch_bytes(h.n_items), stream);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned int)(h.n_items < resident ? h.n_items : resident), THREADS, smem,
           stream>>>(h);
  REPRO_LAUNCH_CHECK();
  return 0;
}

// Scratch of one streaming sweep, each part 16-byte aligned: three any
// rows, the prefix and the scan state (a ticket and one word a partition).
struct StreamScratch {
  uint8_t* any[3];
  int32_t* prefix;
  unsigned long long* state;
  int n_parts;
};

inline long long stream_workspace_bytes(long long width) {
  const long long n_parts = repro_scan_parts(width);
  return 3 * repro_round_up(width, 16) + repro_round_up((width + 1) * 4, 16) +
         repro_round_up((n_parts + 1) * 8, 16);
}

inline StreamScratch stream_scratch(void* workspace, long long width) {
  char* p = (char*)workspace;
  StreamScratch s;
  for (int i = 0; i < 3; ++i) s.any[i] = (uint8_t*)(p + i * repro_round_up(width, 16));
  p += 3 * repro_round_up(width, 16);
  s.prefix = (int32_t*)p;
  s.state = (unsigned long long*)(p + repro_round_up((width + 1) * 4, 16));
  s.n_parts = (int)repro_scan_parts(width);
  return s;
}

template <typename T, typename P>
int sweep_stream(const void* queries, const void* mbr_cm, const void* parent, void* act,
                 const void* win_off, int win_w, void* skipped, void* workspace,
                 long long nq, int levels, long long width, int root_unconditional,
                 int uncond_from, int block_w, cudaStream_t stream) {
  if (nq == 0 || width == 0) return 0;
  const long long n_tiles = (width + block_w - 1) / block_w;
  const StreamScratch s = stream_scratch(workspace, width);
  const bool wide = (long long)win_w > (long long)WIDE_WINDOW * block_w;
  const Plan plan = plan_sweep(nq, width, block_w, act);
  const size_t plane = (size_t)nq * (size_t)width;
  // Only a level whose successor is gated marks its any row.
  auto marks = [&](int l) {
    return l + 1 < levels && level_mode(l + 1, root_unconditional, uncond_from) == GATED;
  };
  if (marks(0)) {
    const cudaError_t e = cudaMemsetAsync(s.any[0], 0, (size_t)width, stream);
    if (e != cudaSuccess) return (int)e;
  }
  for (int l = 0; l < levels; ++l) {
    const int mode = level_mode(l, root_unconditional, uncond_from);
    SweepLevel a{};
    a.queries = queries;
    a.mbr = (const T*)mbr_cm + (size_t)l * 4 * (size_t)width;
    a.parent = (const P*)parent + (size_t)l * (size_t)width;
    a.prev = l > 0 ? (const uint8_t*)act + (size_t)(l - 1) * plane : nullptr;
    a.act = (uint8_t*)act + (size_t)l * plane;
    a.nq = nq;
    a.width = width;
    a.mode = mode;
    a.win_off = (const int32_t*)win_off + (size_t)l * (size_t)n_tiles;
    a.win_w = win_w;
    a.any_prev = mode == GATED && !wide ? s.any[(l + 2) % 3] : nullptr;
    a.prefix = mode == GATED && wide ? s.prefix : nullptr;
    a.any_out = marks(l) ? s.any[l % 3] : nullptr;
    a.any_clear = marks(l + 1) ? s.any[(l + 1) % 3] : nullptr;
    a.scan_state = marks(l) && wide ? s.state : nullptr;
    a.scan_words = s.n_parts + 1;
    a.skipped = (unsigned long long*)skipped;
    const int rc = launch<T, P, true>(a, plan, block_w, stream);
    if (rc) return rc;
    if (marks(l) && wide) {
      repro_flag_prefix_scan<<<s.n_parts, REPRO_SCAN_THREADS, 0, stream>>>(
          s.any[l % 3], width, s.prefix, s.state);
      REPRO_LAUNCH_CHECK();
    }
  }
  return 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// queries: (Q, 4) float32 for float32 tiles, int32 for uint16 tiles.
// mbr_cm: (L, 4, W) float32 or uint16; parent: (L, W) int32 or uint16;
// act: (L, Q, W) uint8 output.  Returns 0 or the CUDA error of a launch.
int repro_level_sweep(const void* queries, const void* mbr_cm, const void* parent,
                      void* act, int tile_u16, int parent_u16, long long nq,
                      int levels, long long width, int root_unconditional,
                      int uncond_from, int block_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (block_w % 32 || block_w < 32 || block_w > 1024) return (int)cudaErrorInvalidValue;
  if (!tile_u16 && !parent_u16)
    return sweep<float, int32_t>(queries, mbr_cm, parent, act, nq, levels, width,
                                 root_unconditional, uncond_from, block_w, s);
  if (tile_u16 && parent_u16)
    return sweep<uint16_t, uint16_t>(queries, mbr_cm, parent, act, nq, levels, width,
                                     root_unconditional, uncond_from, block_w, s);
  if (tile_u16)
    return sweep<uint16_t, int32_t>(queries, mbr_cm, parent, act, nq, levels, width,
                                    root_unconditional, uncond_from, block_w, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of scratch `repro_level_sweep_hier` needs for this shape.
long long repro_level_sweep_hier_scratch(long long nq, long long width, int levels,
                                         int block_w) {
  if (block_w % 32 || block_w < 32 || block_w > 1024 || nq == 0 || width == 0) return 0;
  return hier_scratch_bytes(plan_sweep(nq, width, block_w, nullptr).n_items * levels);
}

// q8, q16: (Q, 4) int32 coarse / fine grid-cell queries; mbr8: (split, 4, W)
// uint8; mbr16: (L - split, 4, W) uint16; parent: (L, W) int32 or uint16;
// n_real: (L,) int32 real slots a level (slots past them hold padding that
// never overlaps), or null; scratch: repro_level_sweep_hier_scratch(Q, W,
// L, block_w) bytes, 4-byte aligned, used by this call alone; act: (L, Q,
// W) uint8 output.  One memset and one launch.  Returns 0 or the CUDA
// error.
int repro_level_sweep_hier(const void* q8, const void* q16, const void* mbr8,
                           const void* mbr16, const void* parent, void* act,
                           const void* n_real, void* scratch, int parent_u16,
                           long long nq, int levels, int split, long long width,
                           int root_unconditional, int uncond_from, int block_w,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (split < 0 || split > levels) return (int)cudaErrorInvalidValue;
  if (block_w % 32 || block_w < 32 || block_w > 1024) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)scratch % 4) return (int)cudaErrorInvalidValue;
  HierArgs args{};
  args.q8 = q8;
  args.q16 = q16;
  args.mbr8 = (const uint8_t*)mbr8;
  args.mbr16 = (const uint16_t*)mbr16;
  args.parent = parent;
  args.act = act;
  args.n_real = (const int32_t*)n_real;
  args.nq = nq;
  args.width = width;
  args.levels = levels;
  args.split = split;
  args.root_unconditional = root_unconditional;
  args.uncond_from = uncond_from;
  return parent_u16 ? sweep_hier<uint16_t>(args, scratch, block_w, s)
                    : sweep_hier<int32_t>(args, scratch, block_w, s);
}

// Bytes of scratch `repro_level_sweep_stream` needs at this width.
long long repro_level_sweep_stream_workspace(long long width) {
  return stream_workspace_bytes(width);
}

// queries, mbr_cm, parent, act as `repro_level_sweep` (float32 or uint16
// tiles, each with int32 or uint16 parents); win_off: (L, T) int32 with
// T = ceil(W / block_w), win_w as `parent_windows` gives them; skipped:
// one int64 the count of skipped (level, tile) pairs is added to;
// workspace: repro_level_sweep_stream_workspace(W) bytes, 16-byte aligned.
// Returns 0 or the CUDA error of a launch.
int repro_level_sweep_stream(const void* queries, const void* mbr_cm, const void* parent,
                             void* act, const void* win_off, int win_w, void* skipped,
                             void* workspace, int tile_u16, int parent_u16, long long nq,
                             int levels, long long width, int root_unconditional,
                             int uncond_from, int block_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (win_w < 1) return (int)cudaErrorInvalidValue;
  if (block_w % 32 || block_w < 32 || block_w > 1024) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)workspace % 16) return (int)cudaErrorInvalidValue;
#define REPRO_STREAM(T, P)                                                              \
  return sweep_stream<T, P>(queries, mbr_cm, parent, act, win_off, win_w, skipped,      \
                            workspace, nq, levels, width, root_unconditional,           \
                            uncond_from, block_w, s)
  if (!tile_u16 && !parent_u16) REPRO_STREAM(float, int32_t);
  if (!tile_u16 && parent_u16) REPRO_STREAM(float, uint16_t);
  if (tile_u16 && !parent_u16) REPRO_STREAM(uint16_t, int32_t);
  REPRO_STREAM(uint16_t, uint16_t);
#undef REPRO_STREAM
}

}  // extern "C"
