// Causal flash-attention backward: (q, k, v, lse, dO) -> (dq, dk, dv).
//
// The backward of kernel #8 (flash_attention.cu).  The reference computes
// no backward in a kernel: it trains through `flash_attention_jnp`
// (src/repro/models/attention.py) under jax.grad, so this kernel replaces
// no Pallas kernel; it exists so that training on the card runs the same
// attention kernel as serving, behind `FlashAttention`
// (kernels/flash_attention.py).  q, k, v, dO (BH, S, D) float32 or
// bfloat16, kv heads already broadcast; lse (BH, S) float32, the forward's
// per-row log-sum-exp of the scaled logits.  With scale = 1/sqrt(D),
//   P  = exp(q.k^T * scale - lse)  (0 where key > query),  dP = dO.V^T,
//   Di = rowsum(P o dP),  dS = P o (dP - Di),
//   dV = round(P)^T.dO,  dQ = scale * dS.K,  dK = scale * dS^T.Q,
// all in float32 and stored in q's type; round(P) is P rounded to v's
// type, the p the forward multiplied V by.  Di equals rowsum(dO o O) in
// exact arithmetic; taken from a bfloat16 O it would carry O's rounding
// into every dS of the row, which in rows over few keys (where dS cancels)
// is several percent of the row's gradient, so it is summed from P and dP
// in float32 instead and the forward's output is not needed.
//
// What bounds it on an H100: operations, about 5 causal products of
// BH*S(S+1)/2*D multiply-adds each against 8 (BH, S, D) arrays moved.
//
// What the design does about it (a first kernel, right before fast):
// * Two launches and no atomics, so every sum has one fixed order and the
//   result is the same on every run.  The first, one block per (64-row
//   query tile, bh), walks the key tiles up to its diagonal twice: once
//   for Di of its rows, which it stores (BH, S) for the second launch, and
//   once for its dQ rows.  The second, one block per (64-key tile, bh),
//   walks the query tiles from its diagonal to S and owns its dK and dV
//   rows.  Each recomputes the logits of its tile pairs (9 products where
//   one kernel with atomics and a stored Di would do 5).
// * CUDA cores in float32 (fmaf): 256 threads as a 16 x 16 grid over a
//   64 x 64 tile, each thread 4 x 4 logits (rows ty + 16 i, keys tx + 16 j)
//   and 4 x D/16 accumulator entries.  Tiles live in shared memory as
//   float32 rows padded to D + 1 floats, so the 16 rows a half-warp reads
//   at one column fall in 16 distinct banks.  bf16 inputs are widened on
//   the way in.  No tensor cores yet (mma.sync or wgmma) and no
//   double buffering of the tiles: both are later work.
// * Rows and keys past S are zero-filled and never stored; any S works.
//   D is 64 or 128 (at 256 the five tiles of a block do not fit shared
//   memory in float32; the wrapper raises for it).
#include "common.cuh"

namespace {

constexpr int BT = 64;        // query rows and keys per tile
constexpr int THREADS = 256;  // a 16 x 16 grid
constexpr int TS = 16;        // threads along each side of the grid

template <int D>
struct Cfg {
  static constexpr int LD = D + 1;    // a padded tile row
  static constexpr int LP = BT + 1;   // a padded row of the (64, 64) P / dS tiles
  static constexpr int CPT = D / TS;  // accumulator columns per thread
  // dq kernel: Q, dO, K, V tiles and dS; dkdv kernel: K, V, Q, dO tiles, P^T, dS^T
  static constexpr int SMEM_DQ = (4 * BT * LD + BT * LP + 2 * BT) * 4;
  static constexpr int SMEM_DKDV = (4 * BT * LD + 2 * BT * LP + 2 * BT) * 4;
};

// rows [r0, r0 + 64) of a (s, D) array into a padded float32 tile, zeros past s
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int s) {
  constexpr int LD = Cfg<D>::LD;
  for (int i = threadIdx.x; i < BT * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < s ? repro_f32(src[(long long)(r0 + r) * D + c]) : 0.0f;
  }
}

// acc[i][j] = sum_d a[ra(i)][d] * b[rb(j)][d] for the thread's 4 x 4 pairs:
// a row ty + 16 i of tile a against row tx + 16 j of tile b
template <int D>
__device__ __forceinline__ void dot_tiles(float (&acc)[4][4], const float* a, const float* b,
                                          int ty, int tx) {
  constexpr int LD = Cfg<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + TS * i) * LD + d];
      bv[i] = b[(tx + TS * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r p[ty + 16 i][r] * t[r][tx + 16 j] over the 64 rows r
// of tile t (p a padded (64, 64) tile)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][Cfg<D>::CPT], const float* p,
                                           const float* t, int ty, int tx) {
  constexpr int LD = Cfg<D>::LD, LP = Cfg<D>::LP, CPT = Cfg<D>::CPT;
#pragma unroll 4
  for (int r = 0; r < BT; ++r) {
    float pv[4], tv[CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + TS * i) * LP + r];
#pragma unroll
    for (int j = 0; j < CPT; ++j) tv[j] = t[r * LD + tx + TS * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], tv[j], acc[i][j]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[4][Cfg<D>::CPT],
                                           int r0, int s, float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + TS * i;
    if (r >= s) continue;
#pragma unroll
    for (int j = 0; j < Cfg<D>::CPT; ++j)
      dst[(long long)r * D + tx + TS * j] = repro_from_f32<T>(acc[i][j] * mul);
  }
}

// dQ of one 64-row query tile, and Di of its rows
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ lse, const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ delta, long long nbh, int s, float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, LP = C::LP, CPT = C::CPT;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sO = sQ + BT * LD;  // dO
  float* sK = sO + BT * LD;
  float* sV = sK + BT * LD;
  float* sS = sV + BT * LD;  // dS (64, 64)
  float* sL = sS + BT * LP;  // lse of the rows
  float* sD = sL + BT;       // Di of the rows
  const long long n_qt = gridDim.x / nbh;
  const int qt = (int)(n_qt - 1 - blockIdx.x / nbh);  // heaviest tiles first
  const long long bh = blockIdx.x % nbh;
  const int q0 = qt * BT;
  const int tid = threadIdx.x, ty = tid / TS, tx = tid % TS;
  const long long off = bh * (long long)s * D;
  load_tile<T, D>(sQ, q + off, q0, s);
  load_tile<T, D>(sO, dout + off, q0, s);
  if (tid < BT) sL[tid] = q0 + tid < s ? lse[bh * s + q0 + tid] : 0.0f;
  const int n_kt = min(qt + 1, (s + BT - 1) / BT);  // up to the diagonal
  float sc[4][4], dp[4][4];
  // P and dP of key tile kt for the thread's 4 x 4 (row, key) pairs; P is 0
  // past the diagonal and for rows past S
  auto tile = [&](int kt) {
    const int k0 = kt * BT;
    __syncthreads();  // every thread is done with the previous K, V (and dS)
    load_tile<T, D>(sK, k + off, k0, s);
    load_tile<T, D>(sV, v + off, k0, s);
    __syncthreads();
    dot_tiles<D>(sc, sQ, sK, ty, tx);
    dot_tiles<D>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + TS * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = k0 + tx + TS * j <= q0 + row && q0 + row < s;
        sc[i][j] = live ? expf(sc[i][j] * scale - sL[row]) : 0.0f;
      }
    }
  };
  // pass 1: Di = rowsum(P o dP); a thread's keys in order, then the 16
  // threads of the row (one half-warp) by a fixed shuffle tree
  float di[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int kt = 0; kt < n_kt; ++kt) {
    tile(kt);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) di[i] = fmaf(sc[i][j], dp[i][j], di[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int x = 1; x < TS; x <<= 1) di[i] += __shfl_xor_sync(0xffffffffu, di[i], x);
    const int row = ty + TS * i;
    if (tx == 0) {
      sD[row] = di[i];
      if (q0 + row < s) delta[bh * s + q0 + row] = di[i];
    }
  }
  // pass 2: dS = P o (dP - Di), dQ += dS.K
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  for (int kt = 0; kt < n_kt; ++kt) {
    tile(kt);  // its first barrier also publishes sD
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + TS * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) sS[row * LP + tx + TS * j] = sc[i][j] * (dp[i][j] - sD[row]);
    }
    __syncthreads();
    accumulate<D>(acc, sS, sK, ty, tx);
  }
  store_rows<T, D>(dq + off, acc, q0, s, scale, ty, tx);
}

// dK and dV of one 64-key tile
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                   long long nbh, int s, float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, LP = C::LP, CPT = C::CPT;
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;   // dO
  float* sP = sO + BT * LD;   // round(P)^T (keys, rows)
  float* sS = sP + BT * LP;   // dS^T (keys, rows)
  float* sL = sS + BT * LP;   // lse of the tile's rows
  float* sD = sL + BT;        // Di of the tile's rows
  const int kt = (int)(blockIdx.x / nbh);  // heaviest first: key tile 0 walks every query tile
  const long long bh = blockIdx.x % nbh;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, ty = tid / TS, tx = tid % TS;
  const long long off = bh * (long long)s * D;
  load_tile<T, D>(sK, k + off, k0, s);
  load_tile<T, D>(sV, v + off, k0, s);
  float adk[4][CPT], adv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) adk[i][j] = adv[i][j] = 0.0f;
  const int n_qt = (s + BT - 1) / BT;
  for (int qt = kt; qt < n_qt; ++qt) {  // query tiles from the diagonal on
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's P^T, dS^T, Q and dO are read
    load_tile<T, D>(sQ, q + off, q0, s);
    load_tile<T, D>(sO, dout + off, q0, s);
    if (tid < BT) {
      const bool in = q0 + tid < s;
      sL[tid] = in ? lse[bh * s + q0 + tid] : 0.0f;
      sD[tid] = in ? delta[bh * s + q0 + tid] : 0.0f;
    }
    __syncthreads();
    float sc[4][4], dp[4][4];  // transposed: key ty + 16 i, row tx + 16 j
    dot_tiles<D>(sc, sK, sQ, ty, tx);
    dot_tiles<D>(dp, sV, sO, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = ty + TS * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = tx + TS * j;
        const bool live = k0 + key <= q0 + row && q0 + row < s;
        const float p = live ? expf(sc[i][j] * scale - sL[row]) : 0.0f;
        sP[key * LP + row] = repro_round_to<T>(p);
        sS[key * LP + row] = p * (dp[i][j] - sD[row]);
      }
    }
    __syncthreads();
    accumulate<D>(adv, sP, sO, ty, tx);
    accumulate<D>(adk, sS, sQ, ty, tx);
  }
  store_rows<T, D>(dk + off, adk, k0, s, scale, ty, tx);
  store_rows<T, D>(dv + off, adv, k0, s, 1.0f, ty, tx);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* lse, const void* dout,
           void* dq, void* dk, void* dv, float* delta, long long bh, int s, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  const long long blocks = (long long)((s + BT - 1) / BT) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_DKDV);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T, D><<<(unsigned int)blocks, THREADS, C::SMEM_DQ, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, (const T*)dout, (T*)dq, delta, bh, s, scale);
  REPRO_LAUNCH_CHECK();
  flash_bwd_dkdv<T, D><<<(unsigned int)blocks, THREADS, C::SMEM_DKDV, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, delta, (const T*)dout, (T*)dk, (T*)dv, bh, s,
      scale);
  REPRO_LAUNCH_CHECK();
  return 0;
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const float* lse, const void* dout,
             void* dq, void* dk, void* dv, float* delta, long long bh, int s, int d, float scale,
             cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(q, k, v, lse, dout, dq, dk, dv, delta, bh, s, scale, stream);
  if (d == 128) return launch<T, 128>(q, k, v, lse, dout, dq, dk, dv, delta, bh, s, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: (bh, s, d) contiguous, of dtype code REPRO_F32
// or REPRO_BF16; lse and delta (scratch, written): (bh, s) float32; d is 64
// or 128.  Two launches on `stream`: dq (and delta), then dk and dv.
// Returns 0 or the CUDA error of a launch.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv, void* delta,
                              long long bh, int s, int d, int dtype, float scale, void* stream) {
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (dtype == REPRO_F32)
    return launch_d<float>(q, k, v, l, dout, dq, dk, dv, dl, bh, s, d, scale, st);
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16>(q, k, v, l, dout, dq, dk, dv, dl, bh, s, d, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
