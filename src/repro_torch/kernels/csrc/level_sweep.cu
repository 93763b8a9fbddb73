// Fused level sweep of the region search: per-level active mask.
//
// Replaces the Pallas kernel `_sweep_kernel` of
// src/repro/kernels/pyramid_scan.py (called from `level_sweep`, stream=False).
// On the GPU the survivor masks of every level live in device memory,
// which has no VMEM cap, so this resident sweep takes any width.
// `repro_level_sweep_stream` (below) replaces `_stream_sweep_kernel`
// (stream=True), whose dead-window skip is a separate kernel.
//
//   act[l, q, w] = ov(q, mbr[l, :, w]) & act[l-1, q, parent[l, w]]
//
// with level 0 unconditional at the root slot (tree schedules) or plain
// `ov` (pyramid), and levels >= uncond_from flat (`ov` only), exactly as
// `_act_formula`.
//
// What bounds it on an H100: bytes.  Each level writes Q*W mask bytes and
// reads W*(16 + 4) tile and parent bytes (W*(8 + 2|4) for uint16 tiles), and
// the gather reads back surviving parents of the previous level; the
// compares are ~4 operations per mask byte, far below the card's ratio.
//
// What the design does about it:
// * One launch per level from the host loop; level order is the only
//   dependency and blocks run in no order, so the TPU's sequential grid
//   becomes that loop.
// * No one-hot matmul (the TPU's MXU gather costs O(Q*W^2/block_w) per
//   level): the parent lookup is a plain gather of the previous level's
//   mask, read only when the node itself overlaps.
// * Each thread owns one slot w for a chunk of QCHUNK queries: the four
//   coordinate-major tile rows and the parent are loaded once (coalesced
//   across w) and reused for every query of the chunk; mask stores are
//   coalesced across w for each query.  Query chunks are the fastest grid
//   dimension, so the chunks that share a tile run together and the tile
//   is read from device memory about once.
// * uint16 and uint8 tiles are widened to int32 after the load, as
//   `_overlap_tile` does, so device memory streams the narrow form.
//
// `repro_level_sweep_hier` replaces `_hier_sweep_kernel` (called from
// `level_sweep_hier`, the sweep of precision="compact8"): levels below
// `split` read uint8 tiles on the coarse grid with the coarse queries,
// levels from `split` on read uint16 tiles with the fine queries.  It is
// the same per-level launch with another tile type, so every mode (root
// only, overlap, gated, flat levels) is shared.  The TPU kernel clamped
// both tile index maps into their own segment and padded W to block_w
// with sentinels; here each launch gets its own segment's pointer and
// threads bound-check w, so neither is needed.
//
// `repro_level_sweep_stream` replaces `_stream_sweep_kernel` (called from
// `level_sweep`, stream=True).  It computes the same mask, bit for bit,
// and adds the TPU kernel's one semantic change, the dead-window skip:
// the MBR and parent tile of (level l, tile t) are not read when
//   * the tile is statically empty (win_off[l, t] < 0, at every level), or
//   * level l is gated (0 < l < uncond_from) and no slot of level l-1 in
//     [win_off[l, t], win_off[l, t] + win_w) survived for ANY query.
// A skipped tile's mask is all zero; sentinel MBRs and the parent gate make
// that exact.  What differs from the TPU kernel, and why:
// * On the TPU one core walked the grid in order, prefetching the next
//   tile's parent window into VMEM and testing it for a live slot.  Here a
//   block holds one QCHUNK-query chunk, so "any query" spans blocks.  Level
//   l-1's launch therefore also writes a (W,) byte row "some query survived
//   at slot w" (zeroed before the launch; blocks only store 1, so no
//   atomics), three small kernels turn it into an exclusive prefix count,
//   and every block of level l tests its window in O(1) as
//   prefix[hi] == prefix[lo].  win_w may be the full width (a Hilbert-
//   ordered tree), so a scan of the window per tile would cost O(T * W).
// * Levels are separate launches on one stream, so level l-1 is complete
//   before level l starts: the TPU kernel's rule "always fetch the first
//   tile of a level" (its previous write-back could still be in flight)
//   has no counterpart.
// * The skip count is the kernel's own: one atomic per skipped (level,
//   tile), made by the block of query chunk 0, into a caller's int64.
// What bounds it: bytes, as the resident sweep.  The skip saves tile and
// parent reads only; the (L, Q, W) mask is still written in full, because
// the epilogue reads it, and those stores are most of the bytes.
#include "common.cuh"

namespace {

constexpr int QCHUNK = 8;

enum Mode { ROOT_ONLY = 0, OVERLAP = 1, GATED = 2 };

template <typename T> struct QueryOf { using type = float; };
template <> struct QueryOf<uint16_t> { using type = int32_t; };
template <> struct QueryOf<uint8_t> { using type = int32_t; };

inline int level_mode(int l, int root_unconditional, int uncond_from) {
  if (l == 0) return root_unconditional ? ROOT_ONLY : OVERLAP;
  return (l >= uncond_from) ? OVERLAP : GATED;
}

template <typename T, typename P>
__global__ void sweep_level(const typename QueryOf<T>::type* __restrict__ queries,
                            const T* __restrict__ mbr,        // (4, W) of level l
                            const P* __restrict__ parent,     // (W,) of level l
                            const uint8_t* __restrict__ prev, // (Q, W) of level l-1
                            uint8_t* __restrict__ act,        // (Q, W) of level l
                            long long nq, long long width, int mode) {
  using Q = typename QueryOf<T>::type;
  const long long q0 = (long long)blockIdx.x * QCHUNK;
  const int nqc = (nq - q0 < QCHUNK) ? (int)(nq - q0) : QCHUNK;
  for (long long w = (long long)blockIdx.y * blockDim.x + threadIdx.x; w < width;
       w += (long long)gridDim.y * blockDim.x) {
    if (mode == ROOT_ONLY) {
      for (int k = 0; k < nqc; ++k) act[(q0 + k) * width + w] = (w == 0);
      continue;
    }
    const Q lx = (Q)mbr[w];
    const Q ly = (Q)mbr[width + w];
    const Q hx = (Q)mbr[2 * width + w];
    const Q hy = (Q)mbr[3 * width + w];
    const long long pw = (mode == GATED) ? (long long)parent[w] : 0;
    for (int k = 0; k < nqc; ++k) {
      const Q* qr = queries + (q0 + k) * 4;
      bool a = (lx <= qr[2]) & (qr[0] <= hx) & (ly <= qr[3]) & (qr[1] <= hy);
      if (mode == GATED) a = a && prev[(q0 + k) * width + pw] != 0;
      act[(q0 + k) * width + w] = a;
    }
  }
}

inline dim3 sweep_grid(long long nq, long long width, int block_w) {
  const long long tiles = (width + block_w - 1) / block_w;
  return dim3((unsigned int)((nq + QCHUNK - 1) / QCHUNK),
              (unsigned int)(tiles < 65535 ? tiles : 65535));
}

// Launch level l of a sweep whose tiles of that level start at `mbr_l`.
template <typename T, typename P>
int launch_level(const void* queries, const T* mbr_l, const void* parent, void* act,
                 long long nq, int l, long long width, int mode, int block_w,
                 cudaStream_t stream) {
  const size_t plane = (size_t)nq * (size_t)width;  // mask bytes per level
  const uint8_t* prev = l > 0 ? (const uint8_t*)act + (size_t)(l - 1) * plane : nullptr;
  sweep_level<T, P><<<sweep_grid(nq, width, block_w), block_w, 0, stream>>>(
      (const typename QueryOf<T>::type*)queries, mbr_l,
      (const P*)parent + (size_t)l * (size_t)width, prev,
      (uint8_t*)act + (size_t)l * plane, nq, width, mode);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <typename T, typename P>
int sweep(const void* queries, const void* mbr_cm, const void* parent, void* act,
          long long nq, int levels, long long width, int root_unconditional,
          int uncond_from, int block_w, cudaStream_t stream) {
  if (nq == 0 || width == 0) return 0;
  for (int l = 0; l < levels; ++l) {
    const int rc = launch_level<T, P>(
        queries, (const T*)mbr_cm + (size_t)l * 4 * (size_t)width, parent, act, nq, l,
        width, level_mode(l, root_unconditional, uncond_from), block_w, stream);
    if (rc) return rc;
  }
  return 0;
}

// Levels [0, split) on uint8 tiles with q8, levels [split, L) on uint16
// tiles with q16.
template <typename P>
int sweep_hier(const void* q8, const void* q16, const void* mbr8, const void* mbr16,
               const void* parent, void* act, long long nq, int levels, int split,
               long long width, int root_unconditional, int uncond_from, int block_w,
               cudaStream_t stream) {
  if (nq == 0 || width == 0) return 0;
  for (int l = 0; l < levels; ++l) {
    const int mode = level_mode(l, root_unconditional, uncond_from);
    const int rc = l < split
        ? launch_level<uint8_t, P>(
              q8, (const uint8_t*)mbr8 + (size_t)l * 4 * (size_t)width, parent, act,
              nq, l, width, mode, block_w, stream)
        : launch_level<uint16_t, P>(
              q16, (const uint16_t*)mbr16 + (size_t)(l - split) * 4 * (size_t)width,
              parent, act, nq, l, width, mode, block_w, stream);
    if (rc) return rc;
  }
  return 0;
}

// ---- kernel #2: the streaming sweep with the dead-window skip ----------

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;
constexpr long long SCAN_SEG = (long long)SCAN_THREADS * SCAN_ITEMS;  // slots per block

inline long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// Exclusive scan of one int per thread over a block of SCAN_THREADS
// threads: returns this thread's exclusive prefix, the block's total in
// *total.  Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < SCAN_THREADS / 32 ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < SCAN_THREADS / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const int r = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[SCAN_THREADS / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return r;
}

// seg[b] = number of set bytes of any[b*SCAN_SEG, (b+1)*SCAN_SEG).
__global__ void any_segment_sums(const uint8_t* __restrict__ any, long long width,
                                 int* __restrict__ seg) {
  const long long base = (long long)blockIdx.x * SCAN_SEG + (long long)threadIdx.x * SCAN_ITEMS;
  int s = 0;
  for (int i = 0; i < SCAN_ITEMS; ++i)
    if (base + i < width) s += any[base + i];
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) seg[blockIdx.x] = total;
}

// In place: seg[b] = sum of seg[0, b) (one block).
__global__ void scan_segments(int* __restrict__ seg, int n_seg) {
  int carry = 0;
  for (int base = 0; base < n_seg; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < n_seg ? seg[i] : 0;
    int total;
    const int e = block_exclusive_scan(v, &total);
    if (i < n_seg) seg[i] = carry + e;
    carry += total;
  }
}

// prefix[w] = number of set bytes of any[0, w), for w in [0, width].
__global__ void any_prefix(const uint8_t* __restrict__ any, long long width,
                           const int* __restrict__ seg_off, int* __restrict__ prefix) {
  const long long base = (long long)blockIdx.x * SCAN_SEG + (long long)threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int s = 0;
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    v[i] = base + i < width ? any[base + i] : 0;
    s += v[i];
  }
  int total;
  int run = seg_off[blockIdx.x] + block_exclusive_scan(s, &total);
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long w = base + i;
    if (w < width) {
      prefix[w] = run;
      run += v[i];
      if (w == width - 1) prefix[width] = run;
    }
  }
}

// One level of the streaming sweep.  Block (x, y) holds query chunk x and
// walks tiles t = y, y + gridDim.y, ...; a tile is blockDim.x (= block_w)
// slots wide, the tiling of win_off.
template <typename T, typename P>
__global__ void stream_sweep_level(const typename QueryOf<T>::type* __restrict__ queries,
                                   const T* __restrict__ mbr,          // (4, W) of level l
                                   const P* __restrict__ parent,       // (W,) of level l
                                   const uint8_t* __restrict__ prev,   // (Q, W) of level l-1
                                   uint8_t* __restrict__ act,          // (Q, W) of level l
                                   const int32_t* __restrict__ win_off,     // (T,) of level l
                                   const int32_t* __restrict__ prev_prefix, // (W+1,) or null
                                   uint8_t* __restrict__ any_out,      // (W,) or null
                                   unsigned long long* __restrict__ skipped,
                                   long long nq, long long width, int n_tiles, int win_w,
                                   int mode) {
  using Q = typename QueryOf<T>::type;
  const long long q0 = (long long)blockIdx.x * QCHUNK;
  const int nqc = (nq - q0 < QCHUNK) ? (int)(nq - q0) : QCHUNK;
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const long long w = (long long)t * blockDim.x + threadIdx.x;
    const int off = win_off[t];
    bool skip = off < 0;  // statically empty tile
    if (!skip && mode == GATED) {  // dead parent window
      const long long lo = off < width ? off : width;
      const long long end = (long long)off + win_w;
      skip = prev_prefix[end < width ? end : width] == prev_prefix[lo];
    }
    if (skip) {
      if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(skipped, 1ULL);
      if (w < width)
        for (int k = 0; k < nqc; ++k) act[(q0 + k) * width + w] = 0;
      continue;
    }
    if (w >= width) continue;
    bool any = false;
    if (mode == ROOT_ONLY) {
      for (int k = 0; k < nqc; ++k) act[(q0 + k) * width + w] = (w == 0);
      any = (w == 0) && nqc > 0;
    } else {
      const Q lx = (Q)mbr[w];
      const Q ly = (Q)mbr[width + w];
      const Q hx = (Q)mbr[2 * width + w];
      const Q hy = (Q)mbr[3 * width + w];
      const long long pw = (mode == GATED) ? (long long)parent[w] : 0;
      for (int k = 0; k < nqc; ++k) {
        const Q* qr = queries + (q0 + k) * 4;
        bool a = (lx <= qr[2]) & (qr[0] <= hx) & (ly <= qr[3]) & (qr[1] <= hy);
        if (mode == GATED) a = a && prev[(q0 + k) * width + pw] != 0;
        act[(q0 + k) * width + w] = a;
        any = any || a;
      }
    }
    if (any_out != nullptr && any) any_out[w] = 1;
  }
}

// Scratch of one streaming sweep: the any row, its prefix and the segment
// sums, each 16-byte aligned.
struct StreamScratch {
  uint8_t* any;
  int* prefix;
  int* seg;
  int n_seg;
};

inline long long stream_workspace_bytes(long long width) {
  const long long n_seg = (width + SCAN_SEG - 1) / SCAN_SEG;
  return round_up(width, 16) + round_up((width + 1) * 4, 16) + round_up(n_seg * 4, 16);
}

inline StreamScratch stream_scratch(void* workspace, long long width) {
  char* p = (char*)workspace;
  StreamScratch s;
  s.any = (uint8_t*)p;
  s.prefix = (int*)(p + round_up(width, 16));
  s.seg = (int*)(p + round_up(width, 16) + round_up((width + 1) * 4, 16));
  s.n_seg = (int)((width + SCAN_SEG - 1) / SCAN_SEG);
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
  const size_t plane = (size_t)nq * (size_t)width;
  const dim3 grid((unsigned int)((nq + QCHUNK - 1) / QCHUNK),
                  (unsigned int)(n_tiles < 65535 ? n_tiles : 65535));
  for (int l = 0; l < levels; ++l) {
    const int mode = level_mode(l, root_unconditional, uncond_from);
    // Only a level whose successor is gated needs its any row.
    const bool write_any =
        l + 1 < levels && level_mode(l + 1, root_unconditional, uncond_from) == GATED;
    if (write_any) {
      const cudaError_t e = cudaMemsetAsync(s.any, 0, (size_t)width, stream);
      if (e != cudaSuccess) return (int)e;
    }
    stream_sweep_level<T, P><<<grid, block_w, 0, stream>>>(
        (const typename QueryOf<T>::type*)queries,
        (const T*)mbr_cm + (size_t)l * 4 * (size_t)width,
        (const P*)parent + (size_t)l * (size_t)width,
        l > 0 ? (const uint8_t*)act + (size_t)(l - 1) * plane : nullptr,
        (uint8_t*)act + (size_t)l * plane,
        (const int32_t*)win_off + (size_t)l * (size_t)n_tiles,
        mode == GATED ? s.prefix : nullptr, write_any ? s.any : nullptr,
        (unsigned long long*)skipped, nq, width, (int)n_tiles, win_w, mode);
    REPRO_LAUNCH_CHECK();
    if (write_any) {
      any_segment_sums<<<s.n_seg, SCAN_THREADS, 0, stream>>>(s.any, width, s.seg);
      REPRO_LAUNCH_CHECK();
      scan_segments<<<1, SCAN_THREADS, 0, stream>>>(s.seg, s.n_seg);
      REPRO_LAUNCH_CHECK();
      any_prefix<<<s.n_seg, SCAN_THREADS, 0, stream>>>(s.any, width, s.seg, s.prefix);
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

// q8, q16: (Q, 4) int32 coarse / fine grid-cell queries; mbr8: (split, 4, W)
// uint8; mbr16: (L - split, 4, W) uint16; parent: (L, W) int32 or uint16;
// act: (L, Q, W) uint8 output.  Returns 0 or the CUDA error of a launch.
int repro_level_sweep_hier(const void* q8, const void* q16, const void* mbr8,
                           const void* mbr16, const void* parent, void* act,
                           int parent_u16, long long nq, int levels, int split,
                           long long width, int root_unconditional, int uncond_from,
                           int block_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (split < 0 || split > levels) return (int)cudaErrorInvalidValue;
  if (parent_u16)
    return sweep_hier<uint16_t>(q8, q16, mbr8, mbr16, parent, act, nq, levels, split,
                                width, root_unconditional, uncond_from, block_w, s);
  return sweep_hier<int32_t>(q8, q16, mbr8, mbr16, parent, act, nq, levels, split,
                             width, root_unconditional, uncond_from, block_w, s);
}

// Bytes of scratch `repro_level_sweep_stream` needs at this width.
long long repro_level_sweep_stream_workspace(long long width) {
  return stream_workspace_bytes(width);
}

// queries, mbr_cm, parent, act as `repro_level_sweep` (float32 or uint16
// tiles, each with int32 or uint16 parents); win_off: (L, T) int32 with
// T = ceil(W / block_w), win_w as `parent_windows` gives them; skipped:
// one int64 the count of skipped (level, tile) pairs is added to;
// workspace: repro_level_sweep_stream_workspace(W) bytes.  Returns 0 or
// the CUDA error of a launch.
int repro_level_sweep_stream(const void* queries, const void* mbr_cm, const void* parent,
                             void* act, const void* win_off, int win_w, void* skipped,
                             void* workspace, int tile_u16, int parent_u16, long long nq,
                             int levels, long long width, int root_unconditional,
                             int uncond_from, int block_w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (win_w < 1) return (int)cudaErrorInvalidValue;
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
