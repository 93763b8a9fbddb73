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
// What bounds it on an H100: bytes.  Each level writes Wa*Wb mask bytes
// and reads only (Wa + Wb) * (16|8 + 4) tile and parent bytes; the parent
// gathers read back bytes of the previous level's mask (mostly from L2:
// sibling slots share parents), and the compares are ~8 operations per
// mask byte, far below the card's ratio.
//
// What the design does about it:
// * One launch per level on the caller's stream; level k reads level
//   k-1's slice of the output as its parent mask.  Levels are ordered on
//   the stream, so nothing carries over between launches: the TPU's
//   sequential grid with (Wa, Wb) prev/cur masks in VMEM, and its
//   VMEM ceiling near 2k x 2k, have no counterpart.
// * A block owns a tile of TA a-rows x TB b-columns.  It stages the
//   tile's A coordinates and parents in shared memory; each thread owns
//   one b (its coordinates and parent in registers) and walks the TA rows,
//   so the mask stores of a warp are 32 consecutive bytes of one row.
// * A narrow B side (Wb < TB / 2: a dozen geofence zones against a
//   million objects) would leave most threads of such a tile past the
//   edge (on an H100, 0.77 ms against the plain version's 0.35 at
//   1e6 x 3 x 3 levels).  There each thread takes one (a, b) pair of the
//   row-major plane instead, so consecutive threads store consecutive
//   mask bytes.
// * The parent byte is gathered only where the pair's own MBRs overlap
//   (the TPU kernel's two one-hot matmuls cost O(Wa * Wb * (Wa + Wb))).
// * No padding: a block bounds-checks both widths, so the output is
//   exactly (K, Wa, Wb) and the pair set cannot depend on the tile shape.
// * Symmetric tiles wholly below the diagonal store zeros and test
//   nothing; diagonal tiles apply the slot-granular a <= b mask.
// * float32 and uint16 (joint-grid) tiles share one template; both
//   compare exactly (no fast math, no flush to zero).
#include "common.cuh"

namespace {

constexpr int TA = 32;   // a rows per block
constexpr int TB = 256;  // b columns per block (one thread each)

template <typename T>
__global__ void pair_level(const T* __restrict__ a_cm, const int32_t* __restrict__ a_par,
                           long long wa, const T* __restrict__ b_cm,
                           const int32_t* __restrict__ b_par, long long wb,
                           const uint8_t* __restrict__ prev, uint8_t* __restrict__ out,
                           int symmetric, long long tiles_b) {
  __shared__ T sa[4][TA];
  __shared__ int32_t spa[TA];
  const long long a0 = ((long long)blockIdx.x / tiles_b) * TA;
  const long long b0 = ((long long)blockIdx.x % tiles_b) * TB;
  const int na = (int)(wa - a0 < TA ? wa - a0 : TA);
  for (int i = threadIdx.x; i < 4 * TA; i += blockDim.x) {
    const int c = i / TA, r = i % TA;
    if (r < na) sa[c][r] = a_cm[c * wa + a0 + r];
  }
  if (prev != nullptr && (int)threadIdx.x < na) spa[threadIdx.x] = a_par[a0 + threadIdx.x];
  __syncthreads();
  const long long bj = b0 + threadIdx.x;
  if (bj >= wb) return;
  uint8_t* o = out + a0 * wb + bj;
  if (symmetric && b0 + TB <= a0) {  // every b of the tile is below every a
    for (int r = 0; r < na; ++r) o[r * wb] = 0;
    return;
  }
  const T blx = b_cm[bj], bly = b_cm[wb + bj], bhx = b_cm[2 * wb + bj],
          bhy = b_cm[3 * wb + bj];
  const long long pb = prev != nullptr ? (long long)b_par[bj] : 0;
  for (int r = 0; r < na; ++r) {
    bool act = (sa[0][r] <= bhx) & (blx <= sa[2][r]) & (sa[1][r] <= bhy) & (bly <= sa[3][r]);
    if (symmetric) act &= (a0 + r <= bj);
    if (act && prev != nullptr) {
      const long long pa = spa[r];
      uint8_t p = prev[pa * wb + pb];
      if (symmetric) p |= prev[pb * wb + pa];
      act = p != 0;
    }
    o[r * wb] = act;
  }
}

// One thread per (a, b) pair of the flat (Wa, Wb) plane, for narrow B sides.
template <typename T>
__global__ void pair_level_flat(const T* __restrict__ a_cm, const int32_t* __restrict__ a_par,
                                long long wa, const T* __restrict__ b_cm,
                                const int32_t* __restrict__ b_par, long long wb,
                                const uint8_t* __restrict__ prev, uint8_t* __restrict__ out,
                                int symmetric) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wa * wb) return;
  const long long a = i / wb, b = i - a * wb;
  bool act = (a_cm[a] <= b_cm[2 * wb + b]) & (b_cm[b] <= a_cm[2 * wa + a]) &
             (a_cm[wa + a] <= b_cm[3 * wb + b]) & (b_cm[wb + b] <= a_cm[3 * wa + a]);
  if (symmetric) act &= (a <= b);
  if (act && prev != nullptr) {
    const long long pa = a_par[a], pb = b_par[b];
    uint8_t p = prev[pa * wb + pb];
    if (symmetric) p |= prev[pb * wb + pa];
    act = p != 0;
  }
  out[i] = act;
}

template <typename T>
int sweep_pairs(const void* a_cm, const void* a_par, const void* b_cm, const void* b_par,
                void* act, int symmetric, int levels, long long wa, long long wb,
                cudaStream_t s) {
  if (levels == 0 || wa == 0 || wb == 0) return 0;
  const bool narrow = wb < TB / 2;
  const long long plane = wa * wb;
  const long long tiles_b = (wb + TB - 1) / TB;
  const long long tiles = narrow ? (plane + TB - 1) / TB : ((wa + TA - 1) / TA) * tiles_b;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  uint8_t* out = (uint8_t*)act;
  for (int k = 0; k < levels; ++k) {
    const T* ak = (const T*)a_cm + 4LL * k * wa;
    const T* bk = (const T*)b_cm + 4LL * k * wb;
    const int32_t* pak = (const int32_t*)a_par + k * wa;
    const int32_t* pbk = (const int32_t*)b_par + k * wb;
    const uint8_t* prev = k == 0 ? nullptr : out + (k - 1) * plane;
    if (narrow)
      pair_level_flat<T><<<(unsigned int)tiles, TB, 0, s>>>(ak, pak, wa, bk, pbk, wb, prev,
                                                             out + k * plane, symmetric);
    else
      pair_level<T><<<(unsigned int)tiles, TB, 0, s>>>(ak, pak, wa, bk, pbk, wb, prev,
                                                        out + k * plane, symmetric, tiles_b);
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
