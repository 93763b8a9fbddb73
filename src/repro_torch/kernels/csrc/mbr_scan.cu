// One-level overlap scan: (Q, N) mask of N float32 MBRs against Q queries.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/mbr_scan.py
// (called from `mbr_scan`), the kernel of the per-level launch plan
// (`per_level_region_search`) that the autotuner may pick.
//
//   out[q, n] = lx[n] <= qhx[q] & qlx[q] <= hx[n] & ly[n] <= qhy[q] & qly[q] <= hy[n]
//
// Exact IEEE float32 compares (no arithmetic, built without fast math).
//
// What bounds it on an H100: the stores.  It writes Q mask bytes per MBR
// and reads 16 (256 MB against 16 MB at Q 256 on the pyramid's widest
// level), about four compares a mask byte, so the instructions issued per
// mask byte come second: one byte a thread a store, the first port's
// design, ran at 30 % of the byte bound.  The design is kernel #1's
// (level_sweep.cu) for one level with no parent gate:
// * Wide stores.  A block takes one item, a tile of tile_w MBRs and a
//   chunk of queries.  Thread (r, j) owns a 16-MBR window of the tile and
//   the queries j, j + rows, ... of the chunk, and writes each query's 16
//   mask bytes with one aligned 16-byte store.  Rows start at q*N; where
//   N is not a multiple of 16 (the trees' 13,534 and 14,237) each row's
//   windows shift left by s = (row + t0) & 15 onto its own 16-byte
//   boundaries, the block also stages the previous tile's last run, and a
//   row's ragged head and tail go out in a few aligned smaller stores
//   (`store_window`, with `store_bytes` of mask_io.cuh).
// * Wide loads and a box per run.  The block stages its tile in shared
//   memory with 16-byte loads, in either layout the wrapper passes: a
//   coordinate-major level (4, W) read in place, four rows of one load
//   per 4 MBRs, or a row-major (N, 4) array, one load per MBR.  The
//   threads that load a 16-MBR run reduce it to its bounding box with warp
//   shuffles (fminf / fmaxf skip NaN coordinates, and a NaN MBR never
//   passes).  A query that misses a window's box, almost every one for a
//   region query, costs four compares and a 16-byte zero store; only
//   where the box passes are the 16 MBRs compared.  Exact: an MBR that
//   passes all four compares makes its run's box pass them too.
// * A tile from the query count.  Queries are staged once per block, 8 a
//   thread; the tile is the widest (256 to 1,024 MBRs) whose chunk of
//   rows * 8 queries still takes all queries, or 128 of them, so few query
//   rows leave no thread idle and many read each MBR once or twice.  With
//   the caller's `block_n` as the tile, the autotuner's 16-query probes at
//   `block_n` 64 and 128 ran slower than the first port (H100 80GB HBM3,
//   700 W).  The chunk halves until the items are at least twice the SMs.
//   One block an item, query chunks fastest, so the chunks that read one
//   tile run together.
// * No padding: the TPU kernel padded N to its tile with +inf rows; here
//   windows bound-check N, so the (Q, N) output has no padding.
// `block_n` (a multiple of 32 in [32, 1024]) is accepted and checked; the
// tile follows the query count.
// Measured times, against the bound and the first port: PERF.md §6.
#include "mask_io.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 16;           // MBRs of one thread's window: one 16-byte store
constexpr int MAX_QPT = 8;        // queries a thread takes per item, at most
constexpr int MAX_TILE = 1024;    // MBRs of a tile, at most
constexpr int WHOLE_CHUNK = 128;  // a chunk takes this many queries, or all

struct Scan {
  const float* mbrs;   // coordinate c of MBR i at mbrs[c * cstride + i * estride]
  long long cstride;   // coordinate-major: W (estride 1); row-major: 1 (estride 4)
  const float* queries;  // (Q, 4)
  uint8_t* out;          // (Q, N)
  long long n, nq, n_chunks;
  int tile_w, qpt;
};

__device__ __forceinline__ bool box_overlaps(float4 b, float4 q) {
  return (b.x <= q.z) & (q.x <= b.z) & (b.y <= q.w) & (q.y <= b.w);
}

// The bytes of mask bits m (MBR k in bit k) for the 16-MBR window at
// `start` of a row: `row` is the row's byte t0 (the window's tile start),
// `span` the row's MBRs from t0.  The window is whole and aligned, or
// holds the row's first bytes (t0 + start < 0) or last (span - start < 16).
__device__ __forceinline__ void store_window(uint8_t* row, long long t0, int start,
                                             long long span, uint32_t m) {
  const uint4 bytes = m != 0 ? mask_bytes(m) : make_uint4(0u, 0u, 0u, 0u);
  const long long lo = t0 + start < 0 ? -(t0 + start) : 0;  // bytes before the row
  const long long hi = span - start < RUN ? span - start : RUN;  // bytes before its end
  if (lo == 0 && hi == RUN)
    *reinterpret_cast<uint4*>(row + start) = bytes;
  else if (lo < hi)
    store_bytes(row + start, bytes, (int)lo, (int)hi);
}

// Block = THREADS threads on one item: a tile of tw MBRs from t0 and a
// chunk of rows * qpt queries from q0.  Staged MBR i is MBR t0 - 16 + i
// (the previous tile's last run, the tile, a run of slack); sbox[0] is the
// previous run's box, sbox[1 + r] run r's.  CM: coordinate-major MBRs.
template <bool ALIGNED, bool CM>
__global__ void __launch_bounds__(THREADS) mbr_scan(const Scan a) {
  extern __shared__ uint4 smem[];
  const int tw = a.tile_w;
  const int tpr = tw / RUN;        // runs of a tile: threads per row
  const int rows = THREADS / tpr;  // query rows a block works on at once
  const int qc = rows * a.qpt;     // queries of a chunk
  const int sw = tw + 2 * RUN;
  float4* sq = reinterpret_cast<float4*>(smem);                 // (qc,) queries
  float4* sbox = sq + qc;                                       // (tpr + 1,) run boxes
  float* stile = reinterpret_cast<float*>(sbox + tpr + 1);      // (4, sw) coordinates
  const int r = threadIdx.x % tpr, j = threadIdx.x / tpr;
  const long long N = a.n;
  const unsigned int n_chunks = (unsigned int)a.n_chunks;
  const long long tile = blockIdx.x / n_chunks, chunk = blockIdx.x - tile * n_chunks;
  const long long t0 = tile * tw, q0 = chunk * qc;
  const long long span = N - t0;  // MBRs from t0 to the row's end (> 0)
  const int nqc = (int)min((long long)qc, a.nq - q0);
  for (int i = threadIdx.x; i < nqc; i += THREADS) sq[i] = query_vec(a.queries + (q0 + i) * 4);
  const bool load_prev = !ALIGNED && tile > 0;
  const float inf = highest(0.0f);
  if (CM) {
    // Coordinate rows, 16 bytes (4 MBRs) a thread; the 4 neighbouring lanes
    // that load one run's part of a row reduce it to that side of the run's
    // box (min of lx, ly, max of hx, hy), and every lane runs every step.
    const int per_row = (tw + RUN) / 4;  // staged MBRs [0, tw + 16) hold data
    for (int base = 0; base < 4 * per_row; base += THREADS) {
      const int i = base + threadIdx.x;
      const int c = i / per_row, k = (i - c * per_row) * 4;
      const long long w = t0 - RUN + k;
      const bool load = i < 4 * per_row && w < N && (k >= RUN || load_prev);
      float b = c < 2 ? inf : -inf;  // the empty box: not staged, or past N
      if (load) {
        const float* src = a.mbrs + c * a.cstride + w;
        const int n = (int)min(4LL, N - w);  // values before the row's end
        const uint4 u = load16(src, n * 4 > 16 - (int)((uintptr_t)src & 15));
        *reinterpret_cast<uint4*>(stile + c * sw + k) = u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < n) b = c < 2 ? fminf(b, value_of<float>(u, e)) : fmaxf(b, value_of<float>(u, e));
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        const float o = shfl_xor(b, d);
        b = c < 2 ? fminf(b, o) : fmaxf(b, o);
      }
      if (i < 4 * per_row && (i - c * per_row) % 4 == 0)
        reinterpret_cast<float*>(sbox + k / RUN)[c] = b;
    }
  } else {
    // One MBR (16 bytes) a thread; the 16 lanes of a run reduce its box.
    for (int base = 0; base < tw + RUN; base += THREADS) {
      const int k = base + threadIdx.x;
      const long long w = t0 - RUN + k;
      float4 v = make_float4(inf, inf, -inf, -inf);
      if (k < tw + RUN && w < N && (k >= RUN || load_prev)) {
        const uint4 u = load16(a.mbrs + w * 4, true);
        v = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                        __uint_as_float(u.w));
        stile[k] = v.x;
        stile[sw + k] = v.y;
        stile[2 * sw + k] = v.z;
        stile[3 * sw + k] = v.w;
      }
#pragma unroll
      for (int d = 1; d < RUN; d <<= 1) {
        v.x = fminf(v.x, shfl_xor(v.x, d));
        v.y = fminf(v.y, shfl_xor(v.y, d));
        v.z = fmaxf(v.z, shfl_xor(v.z, d));
        v.w = fmaxf(v.w, shfl_xor(v.w, d));
      }
      if (k < tw + RUN && k % RUN == 0) sbox[k / RUN] = v;
    }
  }
  __syncthreads();  // sq, stile and sbox are filled
  if (j >= rows) return;  // rows * tpr may fall short of THREADS

  const float4 box_r = sbox[r + 1];  // this thread's run
  float4 box_u = box_r;              // with the run before it: a window of a row with s > 0
  if (!ALIGNED) {
    const float4 b = sbox[r];
    box_u = make_float4(fminf(box_u.x, b.x), fminf(box_u.y, b.y), fmaxf(box_u.z, b.z),
                        fmaxf(box_u.w, b.w));
  }
  // Mask bits of the MBRs t0 + start + k, k < 16, for query qv: the valid
  // ones (in the row), the box, then the MBRs where it passes.  `start` is
  // relative to t0 and may be negative (the previous tile).
  auto window = [&](int start, float4 box, float4 qv) -> uint32_t {
    const long long room = span - start;  // window MBRs before the row's end
    uint32_t valid = room >= RUN ? 0xffffu : room <= 0 ? 0u : (1u << (int)room) - 1u;
    if (!ALIGNED && start < 0 && t0 == 0) valid &= ~((1u << -start) - 1u);  // before the row
    if (valid == 0 || !box_overlaps(box, qv)) return 0u;
    const float* v = stile + RUN + start;
    uint32_t m = 0;
#pragma unroll 4
    for (int k = 0; k < RUN; ++k) {
      const float lx = v[k], ly = v[sw + k], hx = v[2 * sw + k], hy = v[3 * sw + k];
      m |= (uint32_t)((lx <= qv.z) & (qv.x <= hx) & (ly <= qv.w) & (qv.y <= hy)) << k;
    }
    return m & valid;
  };

#pragma unroll 2  // two queries a step: their compares and stores can overlap
  for (int i = 0; i < a.qpt; ++i) {
    const int qi = j + i * rows;
    if (qi >= nqc) break;
    const float4 qv = sq[qi];
    uint8_t* row = a.out + (q0 + qi) * N + t0;  // this tile's part of the row
    const int s = ALIGNED ? 0 : (int)((uintptr_t)row & 15);
    const int start = r * RUN - s;
    if (start < span)
      store_window(row, t0, start, span, window(start, s != 0 ? box_u : box_r, qv));
    // The last tile's windows end s MBRs early: its last thread takes the rest.
    if (!ALIGNED && r == tpr - 1 && span <= tw && span > tw - s)
      store_window(row, t0, tw - s, span, window(tw - s, box_r, qv));
  }
}

}  // namespace

extern "C" {

// mbrs: N float32 MBRs, coordinate c of MBR i at mbrs[c * cstride + i * estride],
// either coordinate-major (cstride = W >= N, estride = 1) or row-major
// (cstride = 1, estride = 4); queries: (Q, 4) float32; out: (Q, N) uint8;
// block_n: a multiple of 32 in [32, 1024], checked (the tile follows Q).
// Returns 0 or the CUDA error of the launch.
int repro_mbr_scan(const void* mbrs, long long cstride, long long estride,
                   const void* queries, void* out, long long n, long long nq,
                   int block_n, void* stream) {
  if (block_n % 32 || block_n < 32 || block_n > 1024) return (int)cudaErrorInvalidValue;
  const bool cm = estride == 1;
  if (!cm && !(cstride == 1 && estride == 4)) return (int)cudaErrorInvalidValue;
  if (n == 0 || nq == 0) return 0;
  // The tile: 1,024 MBRs, halved while its chunk (rows = 4096 / tile query
  // rows, 8 queries each) would not take min(Q, 128) queries: 256 at most.
  int tw = MAX_TILE;
  while ((long long)(THREADS * RUN / tw) * MAX_QPT < (nq < WHOLE_CHUNK ? nq : WHOLE_CHUNK)) tw /= 2;
  // Queries a thread: 8, halved until the (tile, chunk) items are at
  // least twice the SMs.
  const int rows = THREADS / (tw / RUN);
  const long long tiles = (n + tw - 1) / tw;
  int qpt = MAX_QPT;
  auto chunks = [&](int k) { return (nq + (long long)rows * k - 1) / ((long long)rows * k); };
  while (qpt > 1 && tiles * chunks(qpt) < 2LL * repro_sm_count()) qpt /= 2;
  const long long items = tiles * chunks(qpt);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Scan a;
  a.mbrs = (const float*)mbrs;
  a.cstride = cstride;
  a.queries = (const float*)queries;
  a.out = (uint8_t*)out;
  a.n = n;
  a.nq = nq;
  a.n_chunks = chunks(qpt);
  a.tile_w = tw;
  a.qpt = qpt;
  const size_t smem = (size_t)rows * qpt * 16 + (size_t)(tw / RUN + 1) * 16 +
                      4 * ((size_t)tw + 2 * RUN) * sizeof(float);
  const bool aligned = n % 16 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = (unsigned int)items;
  if (aligned && cm) mbr_scan<true, true><<<grid, THREADS, smem, s>>>(a);
  else if (aligned) mbr_scan<true, false><<<grid, THREADS, smem, s>>>(a);
  else if (cm) mbr_scan<false, true><<<grid, THREADS, smem, s>>>(a);
  else mbr_scan<false, false><<<grid, THREADS, smem, s>>>(a);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
