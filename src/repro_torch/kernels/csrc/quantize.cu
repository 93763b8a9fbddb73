// Conservative uint16 quantization of the schedule's MBR tiles.
//
// Replaces the Pallas kernel `_quantize_kernel` of
// src/repro/kernels/quantize.py (called from `quantize_cm_pallas`).
// Per element of the (L, 4, W) coordinate-major float32 grid:
//   t = (v - origin[c]) * inv_cell[c];  lo rows floor, hi rows ceil;
//   clip to [0, cells];  a lo coordinate of +inf (unused slot) -> cells + 1.
//
// The clip happens BEFORE the cast to uint16, since casting an infinite
// float to an integer is undefined on the GPU.  Built with --fmad=false,
// and the subtract and multiply are separate round-to-nearest operations,
// as in the float32 reference.
//
// What bounds it on an H100: bytes (read 4, write 2 per element, a few
// operations each).  One thread per element; consecutive threads touch
// consecutive elements, so loads and stores are coalesced.  A fused
// elementwise pass like this one is all the design needs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void quantize(const float* __restrict__ in, uint16_t* __restrict__ out,
                         const float* __restrict__ origin,
                         const float* __restrict__ inv_cell, long long total,
                         long long width, int cells) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)((i / width) & 3);
  const float v = in[i];
  const float t = __fmul_rn(__fsub_rn(v, origin[c]), inv_cell[c]);
  const bool is_lo = c < 2;
  float cell = is_lo ? floorf(t) : ceilf(t);
  cell = fminf(fmaxf(cell, 0.0f), (float)cells);
  if (is_lo && v == INFINITY) cell = (float)(cells + 1);
  out[i] = (uint16_t)cell;
}

}  // namespace

extern "C" {

// mbr_cm: (L, 4, W) float32; origin, inv_cell: (4,) float32 on the device;
// out: (L, 4, W) uint16.  Returns 0 or the CUDA error of the launch.
int repro_quantize_cm(const void* mbr_cm, const void* origin, const void* inv_cell,
                      void* out, long long total, long long width, int cells,
                      void* stream) {
  if (total == 0) return 0;
  quantize<<<repro_blocks(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)mbr_cm, (uint16_t*)out, (const float*)origin,
      (const float*)inv_cell, total, width, cells);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
