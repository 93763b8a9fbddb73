// Causal flash-attention forward: q, k, v (BH, S, D) -> (BH, S, D).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/flash_attention.py
// (called from `flash_attention`, kernel #8).  kv heads are already
// broadcast to BH; scale 1/sqrt(D); online softmax in float32 with the
// reference's finite mask value -1e30 and its running max starting there;
// p rounded to v's type before P.V, as the reference casts it; the output
// is acc / max(l, 1e-30) in q's type.  D is 64 or 128.
//
// What bounds it on an H100: operations.  The causal QK^T and P.V products
// are about 2*BH*S^2*D FLOPs against 4*BH*S*D elements of q, k, v and out.
//
// What the design does about it:
// * One block per (query tile of 64 rows, bh), heaviest (last) query tiles
//   first; the block loops over 64-key tiles up to the diagonal only, with
//   the K and V tiles staged in shared memory.  Only the diagonal tile is
//   masked (key > query, or key past S).  Any S works: rows and keys past
//   S are zero-filled and never stored (the wrapper keeps the reference's
//   rule that S is a multiple of its block_q and block_k).
// * bfloat16: the tensor cores, through mma.sync.aligned.m16n8k16 (bf16 in,
//   float32 accumulate).  Four warps own 16 query rows each; Q stays in
//   registers as A fragments; K and V tiles stream through two shared
//   buffers (cp.async, the next tile in flight while one is computed) and
//   reach the tensor cores through ldmatrix (.trans for V); the QK^T
//   accumulators become the P fragments of P.V in registers (no round trip
//   through shared memory); rows are padded by 16 bytes, so the 8 rows an
//   ldmatrix reads hit distinct banks.
// * float32: the CUDA cores in full float32 (fmaf; no TF32), so the
//   reference's float32 tolerance holds as it is.  256 threads, each owning
//   a 4 x 4 block of the 64 x 64 logit tile and a 4 x D/16 block of the
//   output; Q, K, V and the logits in shared memory (padded rows).
// Not yet: wgmma, TMA, a deeper K/V ring, warp specialisation.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per kv tile

__device__ __forceinline__ int kv_tiles(int q0, int s) {
  const int diag = (q0 + BM - 1) / BN + 1;
  const int all = (s + BN - 1) / BN;
  return diag < all ? diag : all;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;  // 16 query rows each

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without a register round trip; zero-filled
// when !valid (a source size of 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives row l / 4, columns 2(l % 4), +1 of
// each (transposed with .trans): the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(TC_WARPS * 32)
    flash_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
               long long nbh, int s, float scale) {
  constexpr int LD = D + 8;       // padded shared row, in elements (16 bytes of pad)
  constexpr int TILE = BN * LD;  // elements of one staged K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // two tiles
  __nv_bfloat16* sV = sK + 2 * TILE;                                // two tiles
  const long long n_qt = gridDim.x / nbh;
  const int qt = (int)(n_qt - 1 - blockIdx.x / nbh);
  const long long bh = blockIdx.x % nbh;
  const int q0 = qt * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const long long off = bh * (long long)s * D;
  const __nv_bfloat16* qb = q + off;
  const __nv_bfloat16* kb = k + off;
  const __nv_bfloat16* vb = v + off;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + tg * 2;
    qf[ks][0] = r0 < s ? ld32(qb + (long long)r0 * D + c) : 0u;
    qf[ks][1] = r1 < s ? ld32(qb + (long long)r1 * D + c) : 0u;
    qf[ks][2] = r0 < s ? ld32(qb + (long long)r0 * D + c + 8) : 0u;
    qf[ks][3] = r1 < s ? ld32(qb + (long long)r1 * D + c + 8) : 0u;
  }
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m0 = REPRO_NEG, m1 = REPRO_NEG, l0 = 0.0f, l1 = 0.0f;  // rows r0, r1

  // K and V tiles stream through two shared buffers: tile kt + 1 is in
  // flight (cp.async) while tile kt is computed.
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * BN;
    for (int i = tid; i < BN * D / 8; i += TC_WARPS * 32) {
      const int row = i / (D / 8), cv = (i % (D / 8)) * 8;
      const bool valid = k0 + row < s;
      const long long src = (long long)(valid ? k0 + row : 0) * D + cv;
      cp_async16(sK + buf * TILE + row * LD + cv, kb + src, valid);
      cp_async16(sV + buf * TILE + row * LD + cv, vb + src, valid);
    }
    cp_async_commit();
  };
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row within, and which matrix
  const int nt_kv = kv_tiles(q0, s);
  stage(0, 0);
  for (int kt = 0; kt < nt_kv; ++kt) {
    const int k0 = kt * BN;
    const int buf = kt & 1;
    if (kt + 1 < nt_kv) {
      stage(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * TILE;
    const __nv_bfloat16* tV = sV + buf * TILE;

    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        // the B fragments of k-steps ks and ks + 1: K rows nt*8.., columns ks*16 + 8 * lm
        uint32_t b[4];
        ldmatrix_x4(b, tK + (nt * 8 + lr) * LD + ks * 16 + lm * 8);
        mma_bf16(sc[nt], qf[ks], b[0], b[1]);
        mma_bf16(sc[nt], qf[ks + 1], b[2], b[3]);
      }
    }
    const bool diag = k0 + BN > q0;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + nt * 8 + tg * 2 + (e & 1);
        float x = sc[nt][e] * scale;
        if (diag && (col > row || col >= s)) x = REPRO_NEG;
        sc[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {  // the 4 lanes of a quad share rows
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt][0] = expf(sc[nt][0] - mn0);
      sc[nt][1] = expf(sc[nt][1] - mn0);
      sc[nt][2] = expf(sc[nt][2] - mn1);
      sc[nt][3] = expf(sc[nt][3] - mn1);
      ps0 += sc[nt][0] + sc[nt][1];
      ps1 += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o_);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o_);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0;
      o[dt][1] *= a0;
      o[dt][2] *= a1;
      o[dt][3] *= a1;
    }
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      // the C fragments of logit tiles 2kc, 2kc+1 are the A fragment of P
      const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        // the B fragments (V^T, via .trans) of output columns dt*8.. and (dt+1)*8..
        uint32_t b[4];
        ldmatrix_x4_trans(b, tV + (kc * 16 + (lm & 1) * 8 + lr) * LD + (dt + (lm >> 1)) * 8);
        mma_bf16(o[dt], pa, b[0], b[1]);
        mma_bf16(o[dt + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + off;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (r0 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + c) =
          pack_bf16(o[dt][0] / L0, o[dt][1] / L0);
    if (r1 < s)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + c) =
          pack_bf16(o[dt][2] / L1, o[dt][3] / L1);
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;  // 16 x 16

template <int D>
constexpr size_t f32_smem_floats() {
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D + (size_t)BM * (BN + 1) +
         3 * BM;
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, long long nbh, int s,
              float scale) {
  constexpr int LQ = D + 1, LK = D + 1, LS = BN + 1;  // padded rows: no bank conflicts
  extern __shared__ float sm[];
  float* sQ = sm;               // BM x LQ
  float* sK = sQ + BM * LQ;     // BN x LK
  float* sV = sK + BN * LK;     // BN x D
  float* sS = sV + BN * D;      // BM x LS: logits, then p
  float* sM = sS + BM * LS;     // running max per row
  float* sL = sM + BM;          // running sum per row
  float* sA = sL + BM;          // this tile's alpha per row
  const long long n_qt = gridDim.x / nbh;
  const int qt = (int)(n_qt - 1 - blockIdx.x / nbh);
  const long long bh = blockIdx.x % nbh;
  const int q0 = qt * BM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long off = bh * (long long)s * D;
  const float* qb = q + off;
  const float* kb = k + off;
  const float* vb = v + off;

  for (int i = tid; i < BM * D; i += F_THREADS) {
    const int row = i / D, c = i % D;
    sQ[row * LQ + c] = q0 + row < s ? qb[(long long)(q0 + row) * D + c] : 0.0f;
  }
  for (int i = tid; i < BM; i += F_THREADS) {
    sM[i] = REPRO_NEG;
    sL[i] = 0.0f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;

  const int nt_kv = kv_tiles(q0, s);
  for (int kt = 0; kt < nt_kv; ++kt) {
    const int k0 = kt * BN;
    for (int i = tid; i < BN * D; i += F_THREADS) {
      const int row = i / D, c = i % D;
      const bool in = k0 + row < s;
      sK[row * LK + c] = in ? kb[(long long)(k0 + row) * D + c] : 0.0f;
      sV[row * D + c] = in ? vb[(long long)(k0 + row) * D + c] : 0.0f;
    }
    __syncthreads();

    float st[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LQ + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * LK + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = fmaf(a[i], b[j], st[i][j]);
    }
    const bool diag = k0 + BN > q0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        float x = st[i][j] * scale;
        if (diag && (col > row || col >= s)) x = REPRO_NEG;
        sS[(ty + 16 * i) * LS + tx + 16 * j] = x;
      }
    __syncthreads();

    {  // online softmax statistics: 4 neighbouring lanes per row
      const int row = tid >> 2, sub = tid & 3;
      float* srow = sS + row * LS + sub * (BN / 4);
      float mx = -INFINITY;
      for (int c = 0; c < BN / 4; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      float ps = 0.0f;
      for (int c = 0; c < BN / 4; ++c) {
        const float p = expf(srow[c] - m_new);
        ps += p;
        srow[c] = p;  // float32 p: the cast to v's type is the identity
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      __syncwarp();
      if (sub == 0) {
        const float alpha = expf(m_old - m_new);
        sA[row] = alpha;
        sL[row] = sL[row] * alpha + ps;
        sM[row] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float p[4], vv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // every tile array is rewritten by the next tile
  }
  float* ob = out + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= s) continue;
    const float L = fmaxf(sL[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) ob[(long long)(q0 + row) * D + tx + 16 * j] = acc[i][j] / L;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, long long bh, int s,
           int dtype, float scale, cudaStream_t stream) {
  const long long blocks = (long long)((s + BM - 1) / BM) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_BF16) {
    const int smem = 4 * BN * (D + 8) * (int)sizeof(__nv_bfloat16);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16<D><<<(unsigned int)blocks, TC_WARPS * 32, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)out, bh, s, scale);
  } else if (dtype == REPRO_F32) {
    const int smem = (int)(f32_smem_floats<D>() * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32<D><<<(unsigned int)blocks, F_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, bh, s, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// q, k, v, out: (bh, s, d), contiguous and 16-byte aligned, of dtype code
// REPRO_F32 or REPRO_BF16; d is 64 or 128.  Returns 0 or the CUDA error of
// the launch.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                          long long bh, int s, int d, int dtype, float scale, void* stream) {
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) return launch<64>(q, k, v, out, bh, s, dtype, scale, st);
  if (d == 128) return launch<128>(q, k, v, out, bh, s, dtype, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
