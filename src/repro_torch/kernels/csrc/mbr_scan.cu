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
// What bounds it on an H100: bytes.  It reads 16 bytes per MBR and writes
// Q mask bytes per MBR, about 4 compares per mask byte.
//
// What the design does about it:
// * Each thread owns one MBR n for a chunk of QCHUNK queries: the four
//   coordinates are loaded once and reused, and the mask stores coalesce
//   across n for each query.  Query chunks are the fastest grid dimension,
//   so the chunks that share MBRs run together.
// * The MBR layout is given by two strides (coordinate and element), so a
//   coordinate-major level `mbr_cm[l]` (4, W) is scanned in place, without
//   the (W, 4) copy the TPU caller made; a row-major (N, 4) array passes
//   strides (1, 4).
// * The TPU kernel padded N to its tile width with +inf rows; here threads
//   bound-check n instead.
#include "common.cuh"

namespace {

constexpr int QCHUNK = 8;

__global__ void mbr_scan(const float* __restrict__ mbrs, long long cstride,
                         long long estride, const float* __restrict__ queries,
                         uint8_t* __restrict__ out, long long n, long long nq) {
  const long long q0 = (long long)blockIdx.x * QCHUNK;
  const int nqc = (nq - q0 < QCHUNK) ? (int)(nq - q0) : QCHUNK;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.y * blockDim.x) {
    const float* m = mbrs + i * estride;
    const float lx = m[0];
    const float ly = m[cstride];
    const float hx = m[2 * cstride];
    const float hy = m[3 * cstride];
    for (int k = 0; k < nqc; ++k) {
      const float* qr = queries + (q0 + k) * 4;
      out[(q0 + k) * n + i] =
          (lx <= qr[2]) & (qr[0] <= hx) & (ly <= qr[3]) & (qr[1] <= hy);
    }
  }
}

}  // namespace

extern "C" {

// mbrs: N float32 MBRs, coordinate c of MBR i at mbrs[c * cstride + i * estride];
// queries: (Q, 4) float32; out: (Q, N) uint8.  Returns 0 or the CUDA error
// of the launch.
int repro_mbr_scan(const void* mbrs, long long cstride, long long estride,
                   const void* queries, void* out, long long n, long long nq,
                   int block_n, void* stream) {
  if (n == 0 || nq == 0) return 0;
  const long long tiles = (n + block_n - 1) / block_n;
  dim3 grid((unsigned int)((nq + QCHUNK - 1) / QCHUNK),
            (unsigned int)(tiles < 65535 ? tiles : 65535));
  mbr_scan<<<grid, block_n, 0, (cudaStream_t)stream>>>(
      (const float*)mbrs, cstride, estride, (const float*)queries, (uint8_t*)out, n, nq);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
