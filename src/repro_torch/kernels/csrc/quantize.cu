// Conservative quantization of the schedule's MBR tiles: uint16 tiles of
// every level and, in the same pass, uint8 tiles of the upper levels.
//
// Replaces the Pallas kernel `_quantize_kernel` of
// src/repro/kernels/quantize.py (called from `quantize_cm_pallas`), and
// the reference's `quantize_cm_jnp` at cells = CELLS8 for the uint8 tiles
// of the compact8 form, which is the same function on a coarser grid.
// Per element of the (L, 4, W) coordinate-major float32 grid:
//   t = (v - origin[c]) * inv_cell[c];  lo rows floor, hi rows ceil;
//   clip to [0, cells];  a lo coordinate of +inf (unused slot) -> cells + 1.
//
// The clip happens BEFORE the integer cast, since casting an infinite
// float to an integer is undefined on the GPU.  Built with --fmad=false,
// and the subtract and multiply are separate round-to-nearest operations,
// as in the float32 reference.  The uint8 grid shares the subtraction.
//
// What bounds it on an H100: bytes (read 4, write 2, or 3 with the uint8
// tiles, per element, a few operations each).  The first port ran one
// thread an element with a 4-byte load, a 2-byte store and a 64-bit
// division for the coordinate row, at 46 % of the byte bound.  Design:
// * The row from the launch shape.  A 2-D grid: blockIdx.y is the row
//   r = l * 4 + c of the grid, blockIdx.x a chunk of it, so c, origin,
//   scales and n_real[l] sit in registers and nothing divides.
// * Groups of 8 elements.  Groups are aligned on the element index of the
//   whole array, so with aligned bases a group is two 16-byte loads, one
//   16-byte store of 8 uint16 and one 8-byte store of 8 uint8.  Where the
//   grid makes 4 blocks an SM with 4 groups a thread (the pyramid), a
//   thread takes 4 and issues their loads before its first store; on the
//   trees' one short wave it takes 1: more blocks in flight beat more
//   loads a thread there, and the reverse on the pyramid (PERF.md §6).
//   Rows start at r * W; where W is not a multiple of 8 (the trees' 13,534
//   and 14,237) a row's head before its first group and its tail after its
//   last, at most 7 elements each, go to one thread of the row, element by
//   element.  A base that is not aligned (the tiles as a view into a larger
//   buffer) is found at launch, and then the groups load, or store,
//   element by element in this same kernel.
// * Padding written, not read.  Every schedule keeps a level's padding at
//   its tail as NEVER_MBR, and `n_real` (optional) says where it starts:
//   the kernel reads no slot at or past n_real[l] and writes the
//   sentinel's cells there (lo cells + 1, hi 0: +inf and -inf quantized),
//   a group wholly past it without any arithmetic.  On the 1e6 pyramid
//   8,237 of the 85,943 level-tiles of 128 slots hold real slots, so the
//   reads shrink to a fifth of the writes.
// * Both grids from one load: rows of levels below `split` also write the
//   uint8 tile on the coarse grid, from the same loads and subtraction.
// Measured times, against both bounds and the first port: PERF.md §6.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;  // elements of a group: two 16-byte loads, one 16-byte store

struct Quant {
  const float* in;         // (L, 4, W) float32
  uint16_t* out16;         // (L, 4, W)
  uint8_t* out8;           // (split, 4, W), or null with split 0
  const float* origin;     // (4,)
  const float* inv_cell;   // (4,)
  const float* inv_cell8;  // (4,), or null with split 0
  const int32_t* n_real;   // (L,), or null: every slot is read
  long long width;
  int split, cells, cells8;
  bool vec_in, vec_out;    // 16-byte loads; 16- and 8-byte stores
};

// One coordinate onto a grid; d = v - origin, already rounded.
__device__ __forceinline__ uint32_t grid_cell(float v, float d, float inv, bool lo,
                                              int cells) {
  const float t = __fmul_rn(d, inv);
  float cell = lo ? floorf(t) : ceilf(t);
  cell = fminf(fmaxf(cell, 0.0f), (float)cells);
  if (lo && v == INFINITY) return (uint32_t)cells + 1u;
  return (uint32_t)cell;
}

// GROUPS groups a thread, THREADS apart; their loads go out together.
template <int GROUPS>
__global__ void __launch_bounds__(THREADS) quantize(Quant p) {
  const int r = blockIdx.y;  // the row l * 4 + c of the grid
  const int l = r >> 2, c = r & 3;
  const long long w = p.width;
  const long long s = (long long)r * w;                     // the row's first element
  const long long to_aligned = (-s) & (GROUP - 1);
  const long long head = to_aligned < w ? to_aligned : w;  // elements before the first group
  const long long groups = (long long)((unsigned long long)(w - head) / GROUP);
  const long long g0 = (long long)blockIdx.x * (THREADS * GROUPS) + threadIdx.x;
  if (g0 > groups) return;
  const bool lo = c < 2, coarse = l < p.split;
  long long nr = p.n_real ? (long long)p.n_real[l] : w;  // slots read: [0, nr)
  nr = nr < 0 ? 0 : (nr > w ? w : nr);
  const float o = p.origin[c], inv = p.inv_cell[c];
  const float inv8 = coarse ? p.inv_cell8[c] : 0.0f;
  const float pad = lo ? INFINITY : -INFINITY;  // NEVER_MBR's coordinate on this row
  // ... and its cells: a group wholly past nr stores these, computing nothing
  const uint32_t never16 = lo ? (uint32_t)p.cells + 1u : 0u;
  const uint32_t never8 = lo ? (uint32_t)p.cells8 + 1u : 0u;
  const float* __restrict__ row_in = p.in + s;
  uint16_t* __restrict__ row16 = p.out16 + s;
  uint8_t* __restrict__ row8 = coarse ? p.out8 + s : nullptr;

  // Every load first, then every store.
  float v[GROUPS][GROUP];
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const long long g = g0 + (long long)k * THREADS;
    const long long e0 = head + g * GROUP;
    const long long lim = g < groups ? nr : 0;  // read [e0, lim) of the group
    if (p.vec_in && e0 + GROUP <= lim) {
      const float4 a = reinterpret_cast<const float4*>(row_in + e0)[0];
      const float4 b = reinterpret_cast<const float4*>(row_in + e0)[1];
      v[k][0] = a.x; v[k][1] = a.y; v[k][2] = a.z; v[k][3] = a.w;
      v[k][4] = b.x; v[k][5] = b.y; v[k][6] = b.z; v[k][7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) v[k][j] = e0 + j < lim ? row_in[e0 + j] : pad;
    }
  }
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const long long g = g0 + (long long)k * THREADS;
    const long long e0 = head + g * GROUP;
    if (g == groups) {  // the row's head and tail, element by element
      auto one = [&](long long e) {
        const float x = e < nr ? row_in[e] : pad;
        const float d = __fsub_rn(x, o);
        row16[e] = (uint16_t)grid_cell(x, d, inv, lo, p.cells);
        if (coarse) row8[e] = (uint8_t)grid_cell(x, d, inv8, lo, p.cells8);
      };
      for (long long e = 0; e < head; ++e) one(e);
      for (long long e = head + groups * GROUP; e < w; ++e) one(e);
    }
    if (g >= groups) continue;
    uint32_t q16[GROUP], q8[GROUP];
    if (e0 >= nr) {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        q16[j] = never16;
        q8[j] = never8;
      }
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const float d = __fsub_rn(v[k][j], o);
        q16[j] = grid_cell(v[k][j], d, inv, lo, p.cells);
        q8[j] = coarse ? grid_cell(v[k][j], d, inv8, lo, p.cells8) : 0u;
      }
    }
    if (p.vec_out) {
      *reinterpret_cast<uint4*>(row16 + e0) =
          make_uint4(q16[0] | q16[1] << 16, q16[2] | q16[3] << 16,
                     q16[4] | q16[5] << 16, q16[6] | q16[7] << 16);
      if (coarse)
        *reinterpret_cast<uint2*>(row8 + e0) =
            make_uint2(q8[0] | q8[1] << 8 | q8[2] << 16 | q8[3] << 24,
                       q8[4] | q8[5] << 8 | q8[6] << 16 | q8[7] << 24);
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        row16[e0 + j] = (uint16_t)q16[j];
        if (coarse) row8[e0 + j] = (uint8_t)q8[j];
      }
    }
  }
}

}  // namespace

extern "C" {

// mbr_cm: (L, 4, W) float32; origin, inv_cell: (4,) float32 on the device;
// out16: (L, 4, W) uint16.  n_real: (L,) int32 or null.  With split > 0,
// inv_cell8 (4,) float32 and out8 (split, 4, W) uint8 (the levels below
// split on the cells8 grid); else both may be null.  Returns 0 or the CUDA
// error of the launch.
int repro_quantize_cm(const void* mbr_cm, const void* origin, const void* inv_cell,
                      const void* inv_cell8, const void* n_real, void* out16, void* out8,
                      int levels, long long width, int split, int cells, int cells8,
                      void* stream) {
  if (levels == 0 || width == 0) return 0;
  if (levels > 65535 / 4 || split < 0 || split > levels || (split > 0 && (!out8 || !inv_cell8)))
    return (int)cudaErrorInvalidValue;
  Quant p;
  p.in = (const float*)mbr_cm;
  p.out16 = (uint16_t*)out16;
  p.out8 = (uint8_t*)out8;
  p.origin = (const float*)origin;
  p.inv_cell = (const float*)inv_cell;
  p.inv_cell8 = (const float*)inv_cell8;
  p.n_real = (const int32_t*)n_real;
  p.width = width;
  p.split = split;
  p.cells = cells;
  p.cells8 = cells8;
  p.vec_in = ((uintptr_t)mbr_cm & 15) == 0;
  p.vec_out = ((uintptr_t)out16 & 15) == 0 && ((uintptr_t)out8 & 7) == 0;
  // 4 groups a thread where that still makes 4 blocks an SM (the pyramid's
  // rows of 1e6), else 1: the trees' grids are one short wave, where more
  // blocks in flight beat more loads a thread.
  const long long slots = width / GROUP + 1;  // groups of a row, and its head and tail
  const unsigned int rows = (unsigned int)levels * 4;
  if ((long long)repro_blocks(slots, THREADS * 4) * rows >= 4LL * repro_sm_count())
    quantize<4><<<dim3(repro_blocks(slots, THREADS * 4), rows), THREADS, 0,
                  (cudaStream_t)stream>>>(p);
  else
    quantize<1><<<dim3(repro_blocks(slots, THREADS), rows), THREADS, 0,
                  (cudaStream_t)stream>>>(p);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
