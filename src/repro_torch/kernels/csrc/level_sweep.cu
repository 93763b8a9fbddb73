// Fused level sweep of the region search: per-level active mask.
//
// Replaces the Pallas kernel `_sweep_kernel` of
// src/repro/kernels/pyramid_scan.py (called from `level_sweep`, stream=False),
// and takes over the reason `_stream_sweep_kernel` exists: on the GPU the
// survivor masks live in device memory, which has no VMEM cap.
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

}  // extern "C"
