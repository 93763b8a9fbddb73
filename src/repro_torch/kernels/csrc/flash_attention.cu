// Causal flash-attention forward: q, k, v (BH, S, D) -> (BH, S, D).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/flash_attention.py
// (called from `flash_attention`, kernel #8).  kv heads are already
// broadcast to BH; scale 1/sqrt(D); online softmax in float32 with the
// reference's finite mask value -1e30 and its running max starting there;
// p rounded to v's type before P.V, as the reference casts it; the output
// is acc / max(l, 1e-30) in q's type.  D is 64, 128 or 256; any S.
// Optionally (training) it also stores each row's log-sum-exp m + log(l),
// float32 (BH, S), for the backward kernels of flash_attention_bwd.cu; a
// null pointer (serving) stores nothing.
//
// What bounds it on an H100: operations.  The causal QK^T and P.V products
// are about 2*BH*S^2*D FLOPs against 4*BH*S*D elements of q, k, v and out.
// At D = 64 the exponentials of the softmax (one per causal logit, on the
// SFU's 16 a clock per SM) take about as long as the bf16 products at the
// tensor-core peak, so the two have to overlap.
//
// What the design does about it:
// * Both types: one block per (query tile, bh), heaviest (last) query tiles
//   first; a block walks the key tiles up to its diagonal only, and only
//   tiles that reach past a row are masked (key > query).  Rows and keys
//   past S are zero-filled and never stored, so any S works (the wrapper
//   keeps the reference's rule that S is a multiple of block_q and block_k).
//   exp(x - m) is ex2(fmaf(s, scale*log2e, -m*log2e)) on the raw dot
//   product s: one FFMA and one SFU instruction (ex2.approx.ftz), written
//   out because the library is built without fast math or contraction
//   (--fmad=false, for the sweeps) and exp2f would add a range fix-up
//   around the SFU op.  It flushes a p below 2^-126, which no row sum can
//   see next to the row max's exp(0) = 1.
// * bfloat16, on the tensor cores through Hopper's wgmma (bf16 in, float32
//   accumulate), warp-specialised.  Warpgroup 0 is the producer: one thread
//   issues TMA loads (cp.async.bulk.tensor over a 3-D tensor map of
//   (BH, S, D), so rows past S, or before 0, come back as zeros and never
//   from another head) of Q once and of K and V tiles of 128 keys (64 at
//   D = 256) into a ring of stages (4 at D = 64, 2 at D = 128 and 256),
//   each completed on an mbarrier and handed back by the consumers on
//   another.  Consumer warpgroups own 64 query rows each: three at D = 64
//   (a 192-row block, so each K/V tile read from L2 feeds 192 rows), two at
//   D = 128 and 256, whose accumulators need the registers (setmaxnreg:
//   24/160 and 40/232 for producer/consumers; at D = 256 the 64 x 256
//   output accumulator is 128 registers a thread, so its key tiles are
//   64 keys, whose logits and P take 48).  S = Q.K^T reads Q and K from shared memory through
//   descriptors (128-byte swizzle, as TMA writes it; K as stored is the
//   K-major B operand); P.V takes P from registers (the S accumulators
//   rounded to bf16) and V as the MN-major B operand.  The consumers take
//   turns at the tensor cores through named barriers, so one's softmax runs
//   while another's products do, and each issues tile j's QK^T and tile
//   j-1's P.V in one turn, before tile j's softmax.  O is rescaled only
//   when a row of the warp has a new max (otherwise every factor is exactly
//   1), and a masked logit's p is computed once per row.  Query tiles end
//   at row S, so a partial tile is the lightest one, not one walking every
//   key.
// * float32, on the CUDA cores in full float32 (fmaf; no TF32), so the
//   reference's float32 tolerance holds as it is.  256 threads over 64-key
//   tiles: at D = 64 a 32 x 8 grid over 256 query rows, each thread an
//   8 x 8 block of logits and of the output in registers (16 FMAs per
//   16-byte shared read); at D = 128 a 16 x 16 grid over 64 rows, 4 x 4
//   logits and 4 x 8 outputs (4 x 16 at D = 256).  Q and K are kept
//   transposed in shared memory, (D, rows) and (D, keys), so QK^T reads
//   them 16 bytes at a time; V is read 16 bytes along D.  K and V tiles are
//   double-buffered with cp.async (K transposed by 4-byte copies, V by
//   16-byte ones), one barrier per tile.  At D = 256 two buffers of each do
//   not fit beside Q: one K and one V buffer, each refilled as soon as the
//   product that reads it is done (K's next tile loads during the softmax
//   and P.V, V's during the next QK^T).  A row's max and sum stay in registers (shuffles
//   across the threads of the row, all in one warp); p goes through a
//   slice of shared memory private to each warp, so it needs only
//   __syncwarp.
// Not yet: a persistent grid with a tile scheduler (the block start-up and
// the last wave are not overlapped), TMA stores of the output, skipping the
// key tiles that are wholly masked for one warpgroup, and fp8.  The backward
// pass is flash_attention_bwd.cu (the reference has none).
#include "hopper.cuh"

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: a TMA producer and wgmma consumer warpgroups
// ---------------------------------------------------------------------------

namespace hop {

constexpr int ROW_BYTES = 128;  // one swizzled row of a 64-column slab
constexpr int BAR_TURN = 1;     // named barriers 1..NWG: the consumers' turns (0 is __syncthreads)

template <int D>
struct Cfg {
  // Consumer warpgroups of 64 query rows each: three at D = 64 (each K/V
  // tile read from L2 feeds 192 rows), two at D = 128, whose accumulators
  // need the registers.  Warpgroup 0 is the producer.
  static constexpr int NWG = D == 64 ? 3 : 2;
  static constexpr int BN = D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int BM = 64 * NWG;  // query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int REG_LOAD = NWG == 3 ? 24 : 40;    // setmaxnreg: 65,536 registers in all
  static constexpr int REG_MMA = NWG == 3 ? 160 : 232;
  static constexpr int SLABS = D / 64;  // 64-column slabs of a tile: a 128-byte swizzle row each
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int Q_SLAB = BM * ROW_BYTES;
  static constexpr int KV_SLAB = BN * ROW_BYTES;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;  // one K or V tile
  // 1,024 bytes of slack to align the tiles, Q, the K and V rings, then the
  // mbarriers: Q, and K full, V full and empty per stage.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int nbh, int s, float scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t bQ = sV + C::STAGES * C::KV_BYTES;
  const uint32_t bK = bQ + 8, bV = bK + 8 * C::STAGES, bE = bV + 8 * C::STAGES;
  constexpr int BM = C::BM, NWG = C::NWG, BN = C::BN;
  // Query tiles end at row S, heaviest (last) first: only the lightest one
  // starts before row 0 (TMA fills those rows with zeros; they are never
  // stored), so a partial tile costs one key tile, not a diagonal's worth.
  const int q0 = s - ((int)blockIdx.x / nbh + 1) * BM;
  const int bh = (int)blockIdx.x % nbh;
  const int n_kv = min((q0 + BM - 1) / BN + 1, (s + BN - 1) / BN);  // up to the diagonal
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bQ, 1);
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(bK + 8 * i, 1);
      mbar_init(bV + 8 * i, 1);
      mbar_init(bE + 8 * i, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer: one thread issues every load
    setmaxnreg_dec<C::REG_LOAD>();
    if (tid == 0) {
      mbar_expect_tx(bQ, C::Q_BYTES);
      for (int g = 0; g < C::SLABS; ++g) tma_load_3d(sQ + g * C::Q_SLAB, &tq, bQ, g * 64, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % C::STAGES;
        mbar_wait(bE + 8 * st, ((j / C::STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(bK + 8 * st, C::KV_BYTES);
        for (int g = 0; g < C::SLABS; ++g)
          tma_load_3d(sK + st * C::KV_BYTES + g * C::KV_SLAB, &tk, bK + 8 * st, g * 64, j * BN,
                      bh);
        mbar_expect_tx(bV + 8 * st, C::KV_BYTES);
        for (int g = 0; g < C::SLABS; ++g)
          tma_load_3d(sV + st * C::KV_BYTES + g * C::KV_SLAB, &tv, bV + 8 * st, g * 64, j * BN,
                      bh);
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows q0 + 64w .. + 63
  setmaxnreg_inc<C::REG_MMA>();
  const int w = tid / 128 - 1;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = q0 + 64 * w + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const float c = scale * LOG2E;
  float o[C::SLABS][32];
#pragma unroll
  for (int g = 0; g < C::SLABS; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[g][i] = 0.0f;
  float sacc[BN / 2];       // S: chunk n of 8 keys in sacc[4n..4n+3] (rows row0, row0 + 8)
  uint32_t pf[BN / 16][4];  // P as the bf16 A fragments of the 16-key steps of P.V
  float m0 = REPRO_NEG, m1 = REPRO_NEG, l0 = 0.0f, l1 = 0.0f, a0 = 1.0f, a1 = 1.0f;
  const uint32_t qa = sQ + 64 * w * ROW_BYTES;

  // S = Q.K^T for the tile in stage `st`, 16 columns of D a step
  auto issue_s = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint64_t a = desc_sw128(qa + (ks / 4) * C::Q_SLAB + (ks % 4) * 32);
      const uint64_t b = desc_sw128(sK + st * C::KV_BYTES + (ks / 4) * C::KV_SLAB + (ks % 4) * 32);
      if constexpr (BN == 128) {
        wgmma_ss_n128(sacc, a, b, ks > 0);
      } else {
        wgmma_ss_n64(sacc, a, b, ks > 0);
      }
    }
  };
  // O += P.V for the tile in stage `st`: V (keys, D) is the MN-major B operand
  auto issue_pv = [&](int st) {
    const uint32_t vb = sV + st * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int g = 0; g < C::SLABS; ++g)
        wgmma_rs_n64(o[g], pf[kk], desc_sw128(vb + g * C::KV_SLAB + kk * 16 * ROW_BYTES));
  };
  // Online softmax of tile j in sacc: rows row0 (entries with bit 1 of the
  // index clear) and row0 + 8; the 4 lanes of a quad share the rows.  Leaves
  // p in sacc, the new max in m, the rescale factors in a0, a1, and the sums
  // in l.  Only tiles that reach past the warpgroup's first row (DIAG) are
  // masked.
  auto softmax = [&](auto diag_tag, int j) {
    constexpr bool DIAG = decltype(diag_tag)::value;
    if constexpr (DIAG) {
      const int k0 = j * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
        if (col > row0 + ((i >> 1) & 1) * 8) sacc[i] = -INFINITY;  // masked: -1e30 below
      }
    }
    // four partial maxima (and sums) per row: short dependency chains, so
    // one warpgroup's softmax ends soon after its QK^T does
    float t0[4], t1[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      t0[n] = fmaxf(sacc[4 * n], sacc[4 * n + 1]);
      t1[n] = fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]);
    }
#pragma unroll
    for (int n = 4; n < BN / 8; ++n) {
      t0[n % 4] = fmaxf(t0[n % 4], fmaxf(sacc[4 * n], sacc[4 * n + 1]));
      t1[n % 4] = fmaxf(t1[n % 4], fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
    }
    float mx0 = fmaxf(fmaxf(t0[0], t0[1]), fmaxf(t0[2], t0[3]));
    float mx1 = fmaxf(fmaxf(t1[0], t1[1]), fmaxf(t1[2], t1[3]));
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // the running max of the logits s * scale (rounding is monotonic, so
    // max(s) * scale is the max of the rounded logits)
    const float mn0 = fmaxf(m0, mx0 * scale), mn1 = fmaxf(m1, mx1 * scale);
    const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;
    a0 = exp2f((m0 - mn0) * LOG2E);
    a1 = exp2f((m1 - mn1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    const float pm0 = exp_masked(mn0), pm1 = exp_masked(mn1);  // a masked logit's p
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const bool hi = (i >> 1) & 1;
      float p = exp_logit(sacc[i], c, hi ? ml1 : ml0);
      if constexpr (DIAG) {
        if (sacc[i] == -INFINITY) p = hi ? pm1 : pm0;
      }
      sacc[i] = p;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      t0[n] = sacc[4 * n] + sacc[4 * n + 1];
      t1[n] = sacc[4 * n + 2] + sacc[4 * n + 3];
    }
#pragma unroll
    for (int n = 4; n < BN / 8; ++n) {
      t0[n % 4] += sacc[4 * n] + sacc[4 * n + 1];
      t1[n % 4] += sacc[4 * n + 2] + sacc[4 * n + 3];
    }
    float ps0 = (t0[0] + t0[1]) + (t0[2] + t0[3]);
    float ps1 = (t1[0] + t1[1]) + (t1[2] + t1[3]);
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, x);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, x);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
  };
  auto softmax_tile = [&](int j) {
    if (j * BN + BN - 1 > q0 + 64 * w) {
      softmax(std::true_type{}, j);
    } else {
      softmax(std::false_type{}, j);
    }
  };
  // Pin every register a wgmma will own before its fence, so the compiler
  // cannot sink the rescale of O or the packing of P past it.
  auto fence_operands = [&]() {
#pragma unroll
    for (int g = 0; g < C::SLABS; ++g) fence_regs(o[g]);
    fence_regs(pf);
    fence_regs(sacc);
  };
  auto pack_p = [&]() {  // 8-key chunks 2kk and 2kk + 1 make one A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pf[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
      pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
  };

  mbar_wait(bQ, 0);
  // The warpgroups take turns in order, each handing the next its turn;
  // the last one hands warpgroup 0 the first turn, and keeps its final one.
  // Each walks every key tile of the block; the tiles past its own rows are
  // wholly masked for it.
  const int next = BAR_TURN + (w + 1) % NWG;
  if (w == NWG - 1) named_arrive(BAR_TURN);
  // tile 0: its QK^T alone
  mbar_wait(bK, 0);
  named_sync(BAR_TURN + w);  // this warpgroup's turn at the tensor cores
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  named_arrive(next);  // the next warpgroup's turn
  wgmma_wait<0>();
  fence_regs(sacc);
  softmax_tile(0);
  pack_p();
  // tile j's QK^T and tile j-1's P.V issued in one turn; tile j's softmax
  // runs while the P.V (and the other warpgroups' products) do
  for (int j = 1; j < n_kv; ++j) {
    const int st = j % C::STAGES, pst = (j - 1) % C::STAGES;
    mbar_wait(bK + 8 * st, (j / C::STAGES) & 1);
    named_sync(BAR_TURN + w);
    fence_operands();
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    mbar_wait(bV + 8 * pst, ((j - 1) / C::STAGES) & 1);
    issue_pv(pst);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<1>();
    fence_regs(sacc);
    softmax_tile(j);
    wgmma_wait<0>();  // the previous P.V is done: O, P and its stage are free
#pragma unroll
    for (int g = 0; g < C::SLABS; ++g) fence_regs(o[g]);
    fence_regs(pf);
    if (lane == 0) mbar_arrive(bE + 8 * pst);
    // Rescale O only if a row of the warp has a new max: otherwise every
    // factor is exactly 1, and after the first tiles most are.
    if (__any_sync(0xffffffffu, a0 != 1.0f || a1 != 1.0f)) {
#pragma unroll
      for (int g = 0; g < C::SLABS; ++g)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[g][i] *= ((i >> 1) & 1) ? a1 : a0;
    }
    pack_p();
  }
  // the last tile's P.V, in a final turn each
  named_sync(BAR_TURN + w);
  {
    const int st = (n_kv - 1) % C::STAGES;
    mbar_wait(bV + 8 * st, ((n_kv - 1) / C::STAGES) & 1);
    fence_operands();
    wgmma_fence();
    issue_pv(st);
    wgmma_commit();
  }
  if (w != NWG - 1) named_arrive(next);
  wgmma_wait<0>();
#pragma unroll
  for (int g = 0; g < C::SLABS; ++g) fence_regs(o[g]);

  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // the quad's lanes share the rows' m and l
    float* lb = lse + (long long)bh * s;
    if (row0 >= 0 && row0 < s) lb[row0] = m0 + logf(L0);
    if (row0 + 8 >= 0 && row0 + 8 < s) lb[row0 + 8] = m1 + logf(L1);
  }
  __nv_bfloat16* ob = out + (long long)bh * s * D;
#pragma unroll
  for (int g = 0; g < C::SLABS; ++g)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = g * 64 + n * 8 + 2 * (lane & 3);
      if (row0 >= 0 && row0 < s)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * D + col) =
            pack_bf16(o[g][4 * n] / L0, o[g][4 * n + 1] / L0);
      if (row0 + 8 >= 0 && row0 + 8 < s)
        *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * D + col) =
            pack_bf16(o[g][4 * n + 2] / L1, o[g][4 * n + 3] / L1);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, long long bh,
           int s, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long blocks = (long long)((s + C::BM - 1) / C::BM) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, bh, s, D, C::BM);
  if (rc == 0) rc = make_map(&mk, k, bh, s, D, C::BN);
  if (rc == 0) rc = make_map(&mv, v, bh, s, D, C::BN);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bf16<D><<<(unsigned int)blocks, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, lse, (int)bh, s, scale);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace hop

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // TY x TX: ty = tid / TX picks rows, tx = tid % TX keys and columns
constexpr int LDK = BN + 4;   // K^T and p rows, padded: the transposed 4-byte copies hit
constexpr int LDP = BN + 4;   // distinct banks; a multiple of 4 for 16-byte reads

// Thread i of a row group owns rows 4 TY g + 4 ty + (0..3), keys 4 TX h +
// 4 tx + (0..3) and output columns 4 TX h + 4 tx + (0..3), so every shared
// read is 16 bytes and a row's keys lie in the TX lanes of one warp.
template <int D>
struct Cfg {
  static constexpr int TX = D == 64 ? 8 : 16;  // threads across the keys and the columns
  static constexpr int TY = THREADS / TX;      // threads across the rows
  static constexpr int RM = D == 64 ? 8 : 4;   // rows per thread
  static constexpr int BM = TY * RM;           // query rows per block: 256 or 64
  static constexpr int KPT = BN / TX;          // keys per thread: 8 or 4
  static constexpr int CPT = D / TX;           // output columns per thread: 8 (16 at D = 256)
  static constexpr bool ONE_BUF = D == 256;    // one K and one V buffer (shared memory)
  static constexpr int BUFS = ONE_BUF ? 1 : 2;
  // Q^T (D, BM); K^T tiles (D, LDK); V tiles (BN, D); p (BM, LDP)
  static constexpr int SMEM = (D * BM + BUFS * D * LDK + BUFS * BN * D + BM * LDP) * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
              long long nbh, int s, float scale) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, RM = C::RM, TX = C::TX, TY = C::TY, KPT = C::KPT, CPT = C::CPT;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;                       // (D, BM): Q transposed
  float* sK = sQ + D * BM;              // BUFS x (D, LDK): K tiles transposed
  float* sV = sK + C::BUFS * D * LDK;   // BUFS x (BN, D)
  float* sP = sV + C::BUFS * BN * D;    // (BM, LDP): each warp reads back only its own rows
  const long long n_qt = gridDim.x / nbh;
  const int qt = (int)(n_qt - 1 - blockIdx.x / nbh);
  const long long bh = blockIdx.x % nbh;
  const int q0 = qt * BM;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long off = bh * (long long)s * D;
  const float* qb = q + off;
  const float* kb = k + off;
  const float* vb = v + off;
  auto row_of = [&](int i) { return (i / 4) * 4 * TY + ty * 4 + (i % 4); };  // within the block
  auto key_of = [&](int j) { return (j / 4) * 4 * TX + tx * 4 + (j % 4); };  // within the tile

  for (int i = tid; i < BM * D / 4; i += THREADS) {  // Q^T: 16-byte reads along D
    const int row = i % BM, c4 = (i / BM) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + row < s) x = *reinterpret_cast<const float4*>(qb + (long long)(q0 + row) * D + c4);
    sQ[(c4 + 0) * BM + row] = x.x;
    sQ[(c4 + 1) * BM + row] = x.y;
    sQ[(c4 + 2) * BM + row] = x.z;
    sQ[(c4 + 3) * BM + row] = x.w;
  }
  auto stage_k = [&](int kt, int buf) {
    const int k0 = kt * BN;
    float* tK = sK + buf * D * LDK;
    // K^T: a warp copies 4 keys x 8 columns a step (32-byte runs of global
    // memory; 32 distinct banks)
    for (int i = tid; i < BN * D; i += THREADS) {
      const int rest = i >> 5;
      const int key = (rest % (BN / 4)) * 4 + ((i >> 3) & 3);
      const int col = (rest / (BN / 4)) * 8 + (i & 7);
      const bool valid = k0 + key < s;
      cp_async4(tK + col * LDK + key, kb + (long long)(valid ? k0 + key : 0) * D + col, valid);
    }
  };
  auto stage_v = [&](int kt, int buf) {
    const int k0 = kt * BN;
    float* tV = sV + buf * BN * D;
    for (int i = tid; i < BN * D / 4; i += THREADS) {
      const int key = i / (D / 4), c4 = (i % (D / 4)) * 4;
      const bool valid = k0 + key < s;
      cp_async16(tV + key * D + c4, vb + (long long)(valid ? k0 + key : 0) * D + c4, valid);
    }
  };
  auto stage = [&](int kt, int buf) {
    stage_k(kt, buf);
    stage_v(kt, buf);
    cp_async_commit();
  };

  float acc[RM][CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = REPRO_NEG;
    l[i] = 0.0f;
  }
  const float c = scale * LOG2E;
  const int n_kv = min((q0 + BM - 1) / BN + 1, (s + BN - 1) / BN);
  if constexpr (C::ONE_BUF) {  // K and V as two groups of copies, each refilled on its own
    stage_k(0, 0);
    cp_async_commit();
    stage_v(0, 0);
    cp_async_commit();
  } else {
    stage(0, 0);
  }
  for (int kt = 0; kt < n_kv; ++kt) {
    const int buf = C::ONE_BUF ? 0 : kt & 1, k0 = kt * BN;
    if constexpr (C::ONE_BUF) {
      cp_async_wait_one();  // K of tile kt is in (its V may still be loading)
      __syncthreads();
    } else {
      cp_async_wait_all();
      __syncthreads();  // tile kt is in, and every thread is done with the other buffer
      if (kt + 1 < n_kv) stage(kt + 1, buf ^ 1);
    }
    const float* tK = sK + buf * D * LDK;
    const float* tV = sV + buf * BN * D;

    float sc[RM][KPT];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.0f;
#pragma unroll 2
    for (int dd = 0; dd < D; ++dd) {
      float kv[KPT], qv[RM];
      ld_f4(kv, tK + dd * LDK + tx * 4, 4 * TX);
      ld_f4(qv, sQ + dd * BM + ty * 4, 4 * TY);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    if constexpr (C::ONE_BUF) {
      __syncthreads();  // every thread is done with K: load the next tile's
      if (kt + 1 < n_kv) stage_k(kt + 1, 0);
      cp_async_commit();  // possibly empty: one group a tile
    }

    // softmax: a row is spread over the TX lanes of its warp that share ty
    const bool diag = k0 + BN - 1 > q0;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (diag) {
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          if (k0 + key_of(j) > q0 + row_of(i)) sc[i][j] = -INFINITY;  // masked: -1e30 below
      }
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int x = 1; x < TX; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float mn = fmaxf(m[i], mx * scale);
      const float ml = mn * LOG2E;
      const float alpha = exp2f((m[i] - mn) * LOG2E);
      const float pm = diag ? exp_masked(mn) : 0.0f;  // a masked logit's p
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        float p = exp_logit(sc[i][j], c, ml);
        if (diag && sc[i][j] == -INFINITY) p = pm;
        sc[i][j] = p;  // float32 p: the cast to v's type is the identity
        ps += p;
      }
#pragma unroll
      for (int x = 1; x < TX; x <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, x);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int h = 0; h < KPT / 4; ++h)
        *reinterpret_cast<float4*>(sP + row_of(i) * LDP + 4 * TX * h + tx * 4) =
            make_float4(sc[i][4 * h], sc[i][4 * h + 1], sc[i][4 * h + 2], sc[i][4 * h + 3]);
    }
    __syncwarp();  // a warp reads back only the p rows it wrote
    if constexpr (C::ONE_BUF) {
      cp_async_wait_one();  // V of tile kt is in (the next K may still be loading)
      __syncthreads();
    }

#pragma unroll 1
    for (int c4 = 0; c4 < BN; c4 += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + row_of(i) * LDP + c4);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[CPT];
        ld_f4(vv, tV + (c4 + cc) * D + tx * 4, 4 * TX);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
    if constexpr (C::ONE_BUF) {
      __syncthreads();  // every thread is done with V: load the next tile's
      if (kt + 1 < n_kv) stage_v(kt + 1, 0);
      cp_async_commit();
    }
  }
  float* ob = out + off;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + row_of(i);
    if (row >= s) continue;
    const float L = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[bh * s + row] = m[i] + logf(L);  // the row's TX lanes agree
#pragma unroll
    for (int h = 0; h < CPT / 4; ++h)
      *reinterpret_cast<float4*>(ob + (long long)row * D + 4 * TX * h + tx * 4) =
          make_float4(acc[i][4 * h] / L, acc[i][4 * h + 1] / L, acc[i][4 * h + 2] / L,
                      acc[i][4 * h + 3] / L);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, long long bh,
           int s, float scale, cudaStream_t stream) {
  const long long blocks = (long long)((s + Cfg<D>::BM - 1) / Cfg<D>::BM) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_f32<D><<<(unsigned int)blocks, THREADS, Cfg<D>::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, bh, s, scale);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace fp32

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, long long bh,
           int s, int dtype, float scale, cudaStream_t stream) {
  if (dtype == REPRO_BF16) return hop::launch<D>(q, k, v, out, lse, bh, s, scale, stream);
  if (dtype == REPRO_F32) return fp32::launch<D>(q, k, v, out, lse, bh, s, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, out: (bh, s, d), contiguous and 16-byte aligned, of dtype code
// REPRO_F32 or REPRO_BF16; d is 64, 128 or 256.  lse: (bh, s) float32, or
// null to store no log-sum-exp.  Returns 0 or the CUDA error of the launch
// (cudaErrorNotSupported if the driver has no tensor-map encoder).
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, void* lse,
                          long long bh, int s, int d, int dtype, float scale, void* stream) {
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (d == 64) return launch<64>(q, k, v, out, l, bh, s, dtype, scale, st);
  if (d == 128) return launch<128>(q, k, v, out, l, bh, s, dtype, scale, st);
  if (d == 256) return launch<256>(q, k, v, out, l, bh, s, dtype, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
