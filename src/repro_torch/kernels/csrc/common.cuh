// Shared helpers of the repro_torch kernels (plain C interface, no torch headers).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Return the launch error (as a nonzero int) from the enclosing C entry
// point right after a launch; the Python wrapper raises on it.
#define REPRO_LAUNCH_CHECK()                       \
  do {                                             \
    cudaError_t err_ = cudaGetLastError();         \
    if (err_ != cudaSuccess) return (int)err_;     \
  } while (0)

static inline unsigned int repro_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}
