// Causal flash-attention backward: (q, k, v, lse, dO) -> (dq, dk, dv).
//
// The backward of kernel #8 (flash_attention.cu).  The reference computes
// no backward in a kernel: it trains through `flash_attention_jnp`
// (src/repro/models/attention.py) under jax.grad, so this kernel replaces
// no Pallas kernel; it exists so that training on the card runs the same
// attention kernel as serving, behind `FlashAttention`
// (kernels/flash_attention.py).  q, k, v, dO (BH, S, D) float32 or
// bfloat16, kv heads already broadcast, D 64, 128 or 256, any S; lse
// (BH, S) float32, the forward's per-row log-sum-exp of the scaled logits.
// With scale = 1/sqrt(D),
//   P  = 2^(s*scale*log2e - lse*log2e)  (0 where key > query),  dP = dO.V^T,
//   Di = rowsum(P o dP),  dS = P o (dP - Di),
//   dV = round(P)^T.dO,  dQ = scale * dS.K,  dK = scale * dS^T.Q,
// stored in q's type; round(P) is P rounded to v's type, the p the forward
// multiplied V by.  Di equals rowsum(dO o O) in exact arithmetic; taken
// from a bfloat16 O it would carry O's rounding into every dS of the row,
// which in rows over few keys (where dS cancels) is several percent of the
// row's gradient, so it is summed in float32 from the unrounded P and dP
// and the forward's output is not needed.
//
// What bounds it on an H100: operations, 5 causal products of
// BH*S(S+1)/2*D multiply-adds each against 8 (BH, S, D) arrays moved; in
// bfloat16 the tensor cores' 989 TFLOP/s, in float32 the CUDA cores' 67.
//
// What the design does about it:
// * Two launches and no atomics, so every sum has one fixed order and two
//   runs are bit-equal.  The first owns query rows: it walks its key tiles
//   up to the diagonal twice, once for Di (S and dP) and once for dQ (S, dP
//   and dS.K), and stores Di and lse*log2e for the second, padded to 64
//   rows.  The second owns keys: it walks the query tiles from its diagonal
//   on, computing S^T = K.Q^T and dP^T = V.dO^T directly, and accumulates
//   dV += round(P)^T.dO and dK += dS^T.Q.  7 products where one launch with
//   atomics would do 5; the two extra are the Di walk's, the price of Di
//   from the unrounded P.  Wholly masked tiles of a warpgroup are skipped.
// * bfloat16 on the tensor cores (wgmma, bf16 in, float32 accumulate),
//   warp-specialised as the forward: warpgroup 0's first thread issues TMA
//   loads over 3-D (BH, S, D) tensor maps (rows past S, or before 0, come
//   back as zeros, so any S works and nothing past S is stored) into a ring
//   of stages completed on mbarriers and handed back by the consumers on
//   others; consumer warpgroups own 64 rows (or keys) each: two, and three
//   in the dQ launch at D = 64 (measured faster there; three in the dK/dV
//   launch, with the 32-row tiles their registers allow, were slower).  The
//   resident operand (Q and dO, or K and V) and each streamed tile are
//   read by wgmma through 128-byte-swizzled descriptors, K-major as stored
//   for S and dP; the P (or dS) accumulators of one product are, as they
//   lie in registers, the A fragments of the next (rounded to bf16), whose
//   B operand (K, dO or Q) is MN-major as stored.  P is computed through
//   ex2 (one FFMA and one SFU instruction).  dS is rounded to bf16 before
//   its products, P to bf16 before dV: the two roundings beside the float32
//   kernel this replaces.  The consumer warpgroups take turns at the
//   tensor cores through named barriers, as the forward's do, so that one's
//   exponentials run while another's products do; in each turn a
//   warpgroup issues one tile's S and dP (or S^T and dP^T) and the previous
//   tile's products that read them, and forms the tile's P and dS while
//   those run.  Registers bound the tiles: the dQ launch holds S, dP, the
//   previous tile's dS fragments and a 64 x D float32 dQ a thread's
//   warpgroup (64-key tiles; 32 at D = 256, where dQ alone is 128
//   registers a thread); the dK/dV launch holds dK and dV, 64 x D each,
//   beside S^T, dP^T and the previous tile's fragments of 64-row query
//   tiles at D = 64 and 32-row ones at D = 128.  At D = 256, where dK and
//   dV would be 256 registers a thread, it walks the query tiles twice:
//   dV first (S^T and the dV product), then dK (S^T, dP^T and the dK
//   product), one extra S^T product rather than a split of D across
//   warpgroups that would have to hand P and dS to each other through
//   shared memory.
// * float32 on the CUDA cores in full float32 (fmaf, no TF32), as the
//   forward's float32 path: 256 threads as a 16 x 16 grid over 64 x 64
//   tiles (32 x 32 at D = 256, so that four tiles of 32 x 256 and their
//   second buffers fit shared memory), each thread a 4 x 4 (2 x 2) block of
//   logits and 4 x D/16 (2 x 16) accumulators in registers.  Every shared
//   read is 16 bytes: rows padded to D + 4 floats for the products over D,
//   P and dS tiles padded to 16 extra floats for the products over rows.
//   Streamed tiles are double-buffered with cp.async (the dK/dV launch's Q
//   and dO single-buffered at D = 128, where two buffers do not fit).
#include "hopper.cuh"

namespace {

constexpr int PAD = 64;  // the rows of the stored Di and lse*log2e, padded to a multiple of this

long long padded_rows(int s) { return (long long)(s + PAD - 1) / PAD * PAD; }

template <int SLABS>
__device__ __forceinline__ void zero_acc(float (&a)[SLABS][32]) {
#pragma unroll
  for (int g = 0; g < SLABS; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) a[g][i] = 0.0f;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace hop {

constexpr int ROW_BYTES = 128;            // one swizzled row of a 64-column slab
constexpr int NWG = 2;                    // consumer warpgroups of a dK/dV block, 64 keys each
constexpr int THREADS = 128 * (NWG + 1);  // warpgroup 0 loads
constexpr int REG_LOAD = 40, REG_MMA = 232;
constexpr int BLOCK = 64 * NWG;           // keys of a dK/dV block
constexpr int BAR_TURN = 1;  // named barriers 1..NWG: the consumers' turns (0 is __syncthreads)

template <int D>
struct Cfg {
  static constexpr int SLABS = D / 64;  // 64-column slabs of a row: a 128-byte swizzle row each
  static constexpr int STAGES = D == 256 ? 3 : 4;  // D = 256: three fill 227 KB
  // Streamed tiles: keys of a dQ block's K and V tiles (TQ), query rows of
  // a dK/dV block's Q and dO tiles (TK), sized so that the accumulators,
  // the logits of one tile and the fragments of the previous one fit a
  // thread's registers.
  static constexpr int TQ = D == 256 ? 32 : 64;
  static constexpr int TK = D == 64 ? 64 : 32;
  // A dQ block's consumer warpgroups, 64 query rows each: three at D = 64
  // (each K and V tile read feeds 192 rows, and three take turns at the
  // tensor cores), two at D 128 and 256, whose accumulators need the
  // registers; setmaxnreg shares the 65,536 registers out.
  static constexpr int NWG_Q = D == 64 ? 3 : 2;
  static constexpr int BLOCK_Q = 64 * NWG_Q;
  static constexpr int THREADS_Q = 128 * (NWG_Q + 1);
  static constexpr int REG_LOAD_Q = NWG_Q == 3 ? 24 : 40;
  static constexpr int REG_MMA_Q = NWG_Q == 3 ? 160 : 232;
  static constexpr int Q_SLAB = BLOCK_Q * ROW_BYTES;  // a dQ block's resident Q and dO
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int B_SLAB = BLOCK * ROW_BYTES;    // a dK/dV block's resident K and V
  static constexpr int B_BYTES = SLABS * B_SLAB;
  // 1,024 bytes of slack to align the tiles, two resident tiles, the rings
  // of streamed tiles (and of lse*log2e and Di of their rows, dK/dV), the
  // mbarriers: resident, then full and empty per stage.
  static constexpr int SMEM_DQ =
      1024 + 2 * Q_BYTES + STAGES * 2 * SLABS * TQ * ROW_BYTES + 8 * (1 + 2 * STAGES);
  static constexpr int SMEM_KV = 1024 + 2 * B_BYTES +
                                 STAGES * (2 * SLABS * TK * ROW_BYTES + 2 * TK * 4) +
                                 8 * (1 + 2 * STAGES);
};

// dQ of BLOCK_Q query rows, with Di and lse*log2e of the rows stored
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS_Q, 1)
    bwd_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
           const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
           float* __restrict__ lse2, float* __restrict__ delta, int nbh, int s, int s_pad,
           float scale) {
  using C = Cfg<D>;
  constexpr int BN = C::TQ, SLABS = C::SLABS, STAGES = C::STAGES;
  constexpr int NWG = C::NWG_Q, BLOCK = C::BLOCK_Q;
  constexpr int T_SLAB = BN * ROW_BYTES, T_BYTES = SLABS * T_SLAB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + C::Q_BYTES;
  const uint32_t sK = sO + C::Q_BYTES;
  const uint32_t sV = sK + STAGES * T_BYTES;
  const uint32_t bR = sV + STAGES * T_BYTES;
  const uint32_t bF = bR + 8, bE = bF + 8 * STAGES;
  // Query tiles end at row S, heaviest (last) first, as in the forward: only
  // the lightest one starts before row 0.
  const int q0 = s - ((int)blockIdx.x / nbh + 1) * BLOCK;
  const int bh = (int)blockIdx.x % nbh;
  const int n_kv = (q0 + BLOCK - 1) / BN + 1;  // key tiles up to the diagonal
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bR, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bF + 8 * i, 1);
      mbar_init(bE + 8 * i, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer: one thread issues every load; the key tiles twice
    setmaxnreg_dec<C::REG_LOAD_Q>();
    if (tid == 0) {
      mbar_expect_tx(bR, 2 * C::Q_BYTES);
      for (int g = 0; g < SLABS; ++g) {
        tma_load_3d(sQ + g * C::Q_SLAB, &tq, bR, g * 64, q0, bh);
        tma_load_3d(sO + g * C::Q_SLAB, &tdo, bR, g * 64, q0, bh);
      }
      for (int t = 0; t < 2 * n_kv; ++t) {
        const int st = t % STAGES, j = t < n_kv ? t : t - n_kv;
        mbar_wait(bE + 8 * st, ((t / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(bF + 8 * st, 2 * T_BYTES);
        for (int g = 0; g < SLABS; ++g) {
          tma_load_3d(sK + st * T_BYTES + g * T_SLAB, &tk, bF + 8 * st, g * 64, j * BN, bh);
          tma_load_3d(sV + st * T_BYTES + g * T_SLAB, &tv, bF + 8 * st, g * 64, j * BN, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows q0 + 64w .. + 63
  setmaxnreg_inc<C::REG_MMA_Q>();
  const int w = tid / 128 - 1;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int r_lo = q0 + 64 * w;
  const int row0 = r_lo + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const long long lrow = (long long)bh * s;
  const float ml0 = row0 >= 0 ? lse[lrow + row0] * LOG2E : 0.0f;
  const float ml1 = row0 + 8 >= 0 ? lse[lrow + row0 + 8] * LOG2E : 0.0f;
  const float c = scale * LOG2E;
  const uint32_t qa = sQ + 64 * w * ROW_BYTES, oa = sO + 64 * w * ROW_BYTES;
  float sacc[BN / 2];   // S, then P: chunk n of 8 keys in sacc[4n..4n+3] (rows row0, row0 + 8)
  float dacc[BN / 2];   // dP, then dS
  uint32_t dsf[BN / 16][4];  // dS of the previous tile as the bf16 A fragments of dS.K
  float acc[SLABS][32];      // dQ, 64 columns a slab
  zero_acc(acc);

  // S = Q.K^T and dP = dO.V^T for the tile in stage `st`, 16 columns of D a step
  auto issue_sdp = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t at = (ks / 4) * C::Q_SLAB + (ks % 4) * 32;
      const uint32_t bt = st * T_BYTES + (ks / 4) * T_SLAB + (ks % 4) * 32;
      wgmma_ss<BN>(sacc, desc_sw128(qa + at), desc_sw128(sK + bt), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t at = (ks / 4) * C::Q_SLAB + (ks % 4) * 32;
      const uint32_t bt = st * T_BYTES + (ks / 4) * T_SLAB + (ks % 4) * 32;
      wgmma_ss<BN>(dacc, desc_sw128(oa + at), desc_sw128(sV + bt), ks > 0);
    }
  };
  // dQ += dS.K for the tile in stage `st` (K as the MN-major B operand)
  auto issue_dq = [&](int st) {
    const uint32_t kb = sK + st * T_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int g = 0; g < SLABS; ++g)
        wgmma_rs_n64(acc[g], dsf[kk], desc_sw128(kb + g * T_SLAB + kk * 16 * ROW_BYTES));
  };
  // P = 2^(s c - lse log2e) of key tile j in sacc, 0 where key > row (every
  // key, for rows before 0)
  auto probs = [&](int j) {
    const int k0 = j * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
      const bool hi = (i >> 1) & 1;
      const float p = exp_logit(sacc[i], c, hi ? ml1 : ml0);
      sacc[i] = col > (hi ? row0 + 8 : row0) ? 0.0f : p;
    }
  };
  // The warpgroups take turns at the tensor cores, in order, each handing
  // the next its turn, so that one's exponentials run while the other's
  // products do; every warpgroup takes one turn a tile of each walk and a
  // last one.  The key tiles past a warpgroup's rows are wholly masked for
  // it: it takes their turns and stages and computes nothing (the last
  // warpgroup has none).  No product is issued under a condition, which
  // would make ptxas serialize every wgmma: the tiles with products are a
  // loop of their own, the first n_live of each walk (one at least).
  const int next = BAR_TURN + (w + 1) % NWG;
  const int n_live = r_lo + 63 < 0 ? 1 : min(n_kv, (r_lo + 63) / BN + 1);
  auto empty_turn = [&](int t, bool arrive) {
    const int st = t % STAGES;
    mbar_wait(bF + 8 * st, (t / STAGES) & 1);
    named_sync(BAR_TURN + w);
    if (arrive) named_arrive(next);
    if (lane == 0) mbar_arrive(bE + 8 * st);
  };
  if (w == NWG - 1) named_arrive(BAR_TURN);
  mbar_wait(bR, 0);

  // walk 1: Di = rowsum(P o dP), a thread's keys in order, then the quad
  float di0 = 0.0f, di1 = 0.0f;
  for (int j = 0; j < n_live; ++j) {
    const int st = j % STAGES;
    mbar_wait(bF + 8 * st, (j / STAGES) & 1);
    named_sync(BAR_TURN + w);
    fence_regs(sacc);
    fence_regs(dacc);
    wgmma_fence();
    issue_sdp(st);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dacc);
    if (lane == 0) mbar_arrive(bE + 8 * st);
    probs(j);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if ((i >> 1) & 1) {
        di1 = __fmaf_rn(sacc[i], dacc[i], di1);
      } else {
        di0 = __fmaf_rn(sacc[i], dacc[i], di0);
      }
    }
  }
  for (int j = n_live; j < n_kv; ++j) empty_turn(j, true);
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    di0 += __shfl_xor_sync(0xffffffffu, di0, x);
    di1 += __shfl_xor_sync(0xffffffffu, di1, x);
  }
  if ((lane & 3) == 0) {  // the quad's lanes share the rows
    const long long prow = (long long)bh * s_pad;
    if (row0 >= 0) {
      delta[prow + row0] = di0;
      lse2[prow + row0] = ml0;
    }
    if (row0 + 8 >= 0) {
      delta[prow + row0 + 8] = di1;
      lse2[prow + row0 + 8] = ml1;
    }
  }
  if ((int)blockIdx.x < nbh && w == 0) {  // the block of the last rows zeroes the padding
    const long long prow = (long long)bh * s_pad;
    for (int r = s + (tid - 128); r < s_pad; r += 128) delta[prow + r] = lse2[prow + r] = 0.0f;
  }

  // walk 2: dS = P o (dP - Di) in float32, rounded to bf16 as the A
  // fragments of dQ += dS.K; tile j's S and dP are issued in one turn with
  // tile j-1's dS.K, and tile j's dS is formed while that product runs.
  // a turn's start: S and dP of tile j (round n_kv + j) issued
  auto sdp = [&](int j, int st) {
    mbar_wait(bF + 8 * st, ((n_kv + j) / STAGES) & 1);
    named_sync(BAR_TURN + w);
    fence_regs(sacc);
    fence_regs(dacc);
    fence_regs(acc);
    fence_regs(dsf);
    wgmma_fence();
    issue_sdp(st);
    wgmma_commit();
  };
  auto form_ds = [&](int j) {
    fence_regs(sacc);
    fence_regs(dacc);
    probs(j);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      dacc[i] = sacc[i] * (dacc[i] - (((i >> 1) & 1) ? di1 : di0));
  };
  {  // tile 0 alone
    const int st = n_kv % STAGES;
    sdp(0, st);
    named_arrive(next);
    wgmma_wait<0>();
    form_ds(0);
    pack_a<BN>(dsf, dacc);
  }
  for (int j = 1; j < n_live; ++j) {
    const int st = (n_kv + j) % STAGES, pst = (n_kv + j - 1) % STAGES;
    sdp(j, st);
    issue_dq(pst);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<1>();  // S and dP are in; the previous dS.K may still run
    form_ds(j);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dsf);
    if (lane == 0) mbar_arrive(bE + 8 * pst);
    pack_a<BN>(dsf, dacc);
  }
  {  // the last live tile's dS.K, in a turn of its own
    const int pst = (n_kv + n_live - 1) % STAGES;
    named_sync(BAR_TURN + w);
    fence_regs(acc);
    fence_regs(dsf);
    wgmma_fence();
    issue_dq(pst);
    wgmma_commit();
    // the last warpgroup's last turn hands on nothing (no tile is masked for it)
    if (w != NWG - 1 || n_live < n_kv) named_arrive(next);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(bE + 8 * pst);
  }
  for (int j = n_live; j < n_kv; ++j) empty_turn(n_kv + j, w != NWG - 1 || j < n_kv - 1);

  __nv_bfloat16* out = dq + (long long)bh * s * D;
#pragma unroll
  for (int g = 0; g < SLABS; ++g)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = g * 64 + n * 8 + 2 * (lane & 3);
      if (row0 >= 0)
        *reinterpret_cast<uint32_t*>(out + (long long)row0 * D + col) =
            pack_bf16(acc[g][4 * n] * scale, acc[g][4 * n + 1] * scale);
      if (row0 + 8 >= 0)
        *reinterpret_cast<uint32_t*>(out + (long long)(row0 + 8) * D + col) =
            pack_bf16(acc[g][4 * n + 2] * scale, acc[g][4 * n + 3] * scale);
    }
}

// What a dK/dV consumer thread walks the query tiles with.
struct KvWalk {
  uint32_t ka, va;      // its warpgroup's 64 keys of the resident K and V tiles
  uint32_t sQ, sO;      // the rings of Q and dO tiles
  uint32_t bF, bE;      // full and empty mbarriers of the first stage
  const float* fL;      // the rings of lse*log2e and Di of the tiles' rows
  const float* fD;
  int qt0, n_qt;        // the first query tile and the number of them
  int kw, key0, lane;   // the warpgroup's first key, the thread's keys key0 and key0 + 8
  int w, s;
  float c;              // scale * log2e
};

// One walk of a dK/dV consumer over the query tiles, rounds t0 .. t0 + n_qt
// - 1 of the ring, one turn a tile and a last one (`last`: the kernel's
// last turn).  MODE 0 accumulates dV into av and dK into ak, 1 dV alone, 2
// dK alone.  Tile i's S^T (and dP^T) are issued in one turn with tile
// i-1's products, and tile i's P and dS are formed while those run.
// n_qt >= 1.
template <int D, int MODE>
__device__ __forceinline__ void kv_walk(const KvWalk& wk, float (&av)[D / 64][32],
                                        float (&ak)[D / 64][32], int t0, bool last) {
  using C = Cfg<D>;
  constexpr int BM = C::TK, SLABS = C::SLABS, STAGES = C::STAGES;
  constexpr int T_SLAB = BM * ROW_BYTES, T_BYTES = SLABS * T_SLAB;
  float sacc[BM / 2];  // S^T, then P^T: chunk n of 8 rows in sacc[4n..4n+3] (keys key0, key0 + 8)
  float dacc[BM / 2];  // dP^T, then dS^T
  uint32_t pf[BM / 16][4], sf[BM / 16][4];  // round(P)^T and dS^T of the previous tile, bf16
  const int lane = wk.lane, next = BAR_TURN + (wk.w + 1) % NWG;
  auto fence_b = [&]() {  // what the previous tile's products own
    if constexpr (MODE != 2) {
      fence_regs(av);
      fence_regs(pf);
    }
    if constexpr (MODE != 1) {
      fence_regs(ak);
      fence_regs(sf);
    }
  };
  auto issue_b = [&](int st) {
    const uint32_t qb = wk.sQ + st * T_BYTES, ob = wk.sO + st * T_BYTES;
    if constexpr (MODE != 2) {  // dV += round(P)^T.dO
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int g = 0; g < SLABS; ++g)
          wgmma_rs_n64(av[g], pf[kk], desc_sw128(ob + g * T_SLAB + kk * 16 * ROW_BYTES));
    }
    if constexpr (MODE != 1) {  // dK += dS^T.Q
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int g = 0; g < SLABS; ++g)
          wgmma_rs_n64(ak[g], sf[kk], desc_sw128(qb + g * T_SLAB + kk * 16 * ROW_BYTES));
    }
  };
  // a turn's start: S^T (and dP^T) of tile i (round t0 + i) issued
  auto issue_a = [&](int i, int st) {
    const uint32_t qb = wk.sQ + st * T_BYTES, ob = wk.sO + st * T_BYTES;
    mbar_wait(wk.bF + 8 * st, ((t0 + i) / STAGES) & 1);
    named_sync(BAR_TURN + wk.w);
    fence_regs(sacc);
    if constexpr (MODE != 1) fence_regs(dacc);
    fence_b();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t at = (ks / 4) * C::B_SLAB + (ks % 4) * 32;
      const uint32_t bt = (ks / 4) * T_SLAB + (ks % 4) * 32;
      wgmma_ss<BM>(sacc, desc_sw128(wk.ka + at), desc_sw128(qb + bt), ks > 0);
    }
    if constexpr (MODE != 1) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t at = (ks / 4) * C::B_SLAB + (ks % 4) * 32;
        const uint32_t bt = (ks / 4) * T_SLAB + (ks % 4) * 32;
        wgmma_ss<BM>(dacc, desc_sw128(wk.va + at), desc_sw128(ob + bt), ks > 0);
      }
    }
    wgmma_commit();
  };
  // P^T (and dS^T) of tile i in sacc (dacc); 0 where key > row or row >= s
  auto form = [&](int i, int st) {
    fence_regs(sacc);
    if constexpr (MODE != 1) fence_regs(dacc);
    const int q0 = (wk.qt0 + i) * BM;
    const float* ls = wk.fL + st * BM;
    const float* ds = wk.fD + st * BM;
#pragma unroll
    for (int i2 = 0; i2 < BM / 2; ++i2) {
      const int col = (i2 >> 2) * 8 + 2 * (lane & 3) + (i2 & 1);
      const int row = q0 + col;
      const int key = ((i2 >> 1) & 1) ? wk.key0 + 8 : wk.key0;
      const bool in = key <= row && row < wk.s;
      const float p = exp_logit(sacc[i2], wk.c, ls[col]);
      sacc[i2] = in ? p : 0.0f;
      if constexpr (MODE != 1) dacc[i2] = in ? p * (dacc[i2] - ds[col]) : 0.0f;
    }
  };
  auto pack = [&]() {
    if constexpr (MODE != 2) pack_a<BM>(pf, sacc);
    if constexpr (MODE != 1) pack_a<BM>(sf, dacc);
  };
  // The first query tiles may lie wholly before the warpgroup's keys: it
  // takes their turns and stages and computes nothing.  No product is
  // issued under a condition, which would make ptxas serialize every
  // wgmma: the tiles with products, i_first on (one at least), are a loop
  // of their own.
  const int i_first = min(wk.kw / BM - wk.qt0, wk.n_qt - 1);
  for (int i = 0; i < i_first; ++i) {
    const int st = (t0 + i) % STAGES;
    mbar_wait(wk.bF + 8 * st, ((t0 + i) / STAGES) & 1);
    named_sync(BAR_TURN + wk.w);
    named_arrive(next);
    if (lane == 0) mbar_arrive(wk.bE + 8 * st);
  }
  {  // tile i_first alone
    const int st = (t0 + i_first) % STAGES;
    issue_a(i_first, st);
    named_arrive(next);
    wgmma_wait<0>();
    form(i_first, st);
    pack();
  }
  for (int i = i_first + 1; i < wk.n_qt; ++i) {
    const int st = (t0 + i) % STAGES, pst = (t0 + i - 1) % STAGES;
    issue_a(i, st);
    issue_b(pst);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<1>();  // S^T (and dP^T) are in; the previous products may still run
    form(i, st);
    wgmma_wait<0>();
    fence_b();
    if (lane == 0) mbar_arrive(wk.bE + 8 * pst);
    pack();
  }
  // the last tile's products, in a last turn each
  const int pst = (t0 + wk.n_qt - 1) % STAGES;
  named_sync(BAR_TURN + wk.w);
  fence_b();
  wgmma_fence();
  issue_b(pst);
  wgmma_commit();
  if (!last || wk.w != NWG - 1) named_arrive(next);
  wgmma_wait<0>();
  fence_b();
  if (lane == 0) mbar_arrive(wk.bE + 8 * pst);
}

// The rows key0 and key0 + 8 of a (s, D) bf16 array from a 64 x D
// accumulator, times `mul`; keys past s are not stored.
template <int D>
__device__ __forceinline__ void store_keys(__nv_bfloat16* o, const float (&a)[D / 64][32],
                                           float mul, const KvWalk& wk) {
#pragma unroll
  for (int g = 0; g < D / 64; ++g)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = g * 64 + n * 8 + 2 * (wk.lane & 3);
      if (wk.key0 < wk.s)
        *reinterpret_cast<uint32_t*>(o + (long long)wk.key0 * D + col) =
            pack_bf16(a[g][4 * n] * mul, a[g][4 * n + 1] * mul);
      if (wk.key0 + 8 < wk.s)
        *reinterpret_cast<uint32_t*>(o + (long long)(wk.key0 + 8) * D + col) =
            pack_bf16(a[g][4 * n + 2] * mul, a[g][4 * n + 3] * mul);
    }
}

// dK and dV of BLOCK keys
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int nbh, int s,
             int s_pad, float scale) {
  using C = Cfg<D>;
  constexpr int BM = C::TK, SLABS = C::SLABS, STAGES = C::STAGES;
  constexpr int T_SLAB = BM * ROW_BYTES, T_BYTES = SLABS * T_SLAB, F_BYTES = BM * 4;
  // at D = 256 dV, then dK: the two 64 x 256 accumulators would be 256 registers a thread
  constexpr bool TWO_WALKS = D == 256;
  constexpr int WALKS = TWO_WALKS ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (((smem_addr(smem_raw) + 1023u) & ~1023u) - smem_addr(smem_raw));
  const uint32_t sK = smem_addr(base);
  const uint32_t sV = sK + C::B_BYTES;
  const uint32_t sQ = sV + C::B_BYTES;
  const uint32_t sO = sQ + STAGES * T_BYTES;
  const uint32_t sL = sO + STAGES * T_BYTES;
  const uint32_t sD = sL + STAGES * F_BYTES;
  const uint32_t bR = sD + STAGES * F_BYTES;
  const uint32_t bF = bR + 8, bE = bF + 8 * STAGES;
  const int k0 = ((int)blockIdx.x / nbh) * BLOCK;  // heaviest first: keys 0.. walk every query tile
  const int bh = (int)blockIdx.x % nbh;
  const int qt0 = k0 / BM;                         // query tiles from the diagonal on
  const int n_qt = (s + BM - 1) / BM - qt0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bR, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bF + 8 * i, 1);
      mbar_init(bE + 8 * i, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer
    setmaxnreg_dec<REG_LOAD>();
    if (tid == 0) {
      mbar_expect_tx(bR, 2 * C::B_BYTES);
      for (int g = 0; g < SLABS; ++g) {
        tma_load_3d(sK + g * C::B_SLAB, &tk, bR, g * 64, k0, bh);
        tma_load_3d(sV + g * C::B_SLAB, &tv, bR, g * 64, k0, bh);
      }
      const float* l2 = lse2 + (long long)bh * s_pad;
      const float* dl = delta + (long long)bh * s_pad;
      for (int t = 0; t < WALKS * n_qt; ++t) {
        const int st = t % STAGES, q0 = (qt0 + t % n_qt) * BM;
        mbar_wait(bE + 8 * st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(bF + 8 * st, 2 * T_BYTES + 2 * F_BYTES);
        for (int g = 0; g < SLABS; ++g) {
          tma_load_3d(sQ + st * T_BYTES + g * T_SLAB, &tq, bF + 8 * st, g * 64, q0, bh);
          tma_load_3d(sO + st * T_BYTES + g * T_SLAB, &tdo, bF + 8 * st, g * 64, q0, bh);
        }
        bulk_load(sL + st * F_BYTES, l2 + q0, F_BYTES, bF + 8 * st);
        bulk_load(sD + st * F_BYTES, dl + q0, F_BYTES, bF + 8 * st);
      }
    }
    return;
  }

  // consumers: warpgroup w owns keys k0 + 64w .. + 63
  setmaxnreg_inc<REG_MMA>();
  KvWalk wk;
  wk.lane = tid & 31;
  wk.w = tid / 128 - 1;
  const int warp = (tid >> 5) & 3;
  wk.kw = k0 + 64 * wk.w;
  wk.key0 = wk.kw + 16 * warp + (wk.lane >> 2);  // this thread's keys: key0, key0 + 8
  wk.ka = sK + 64 * wk.w * ROW_BYTES;
  wk.va = sV + 64 * wk.w * ROW_BYTES;
  wk.sQ = sQ;
  wk.sO = sO;
  wk.bF = bF;
  wk.bE = bE;
  wk.fL = reinterpret_cast<const float*>(base + (sL - sK));
  wk.fD = reinterpret_cast<const float*>(base + (sD - sK));
  wk.qt0 = qt0;
  wk.n_qt = n_qt;
  wk.s = s;
  wk.c = scale * LOG2E;
  const long long off = (long long)bh * s * D;
  if (wk.w == NWG - 1) named_arrive(BAR_TURN);  // warpgroup 0 takes the first turn
  mbar_wait(bR, 0);
  if constexpr (TWO_WALKS) {
    float acc[SLABS][32];
    zero_acc(acc);
    kv_walk<D, 1>(wk, acc, acc, 0, false);
    store_keys<D>(dv + off, acc, 1.0f, wk);
    zero_acc(acc);
    kv_walk<D, 2>(wk, acc, acc, n_qt, true);
    store_keys<D>(dk + off, acc, scale, wk);
  } else {
    float adv[SLABS][32], adk[SLABS][32];
    zero_acc(adv);
    zero_acc(adk);
    kv_walk<D, 0>(wk, adv, adk, 0, true);
    store_keys<D>(dv + off, adv, 1.0f, wk);
    store_keys<D>(dk + off, adk, scale, wk);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* lse, const void* dout,
           void* dq, void* dk, void* dv, float* lse2, float* delta, long long bh, int s,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long blocks_q = (long long)((s + C::BLOCK_Q - 1) / C::BLOCK_Q) * bh;
  const long long blocks_k = (long long)((s + BLOCK - 1) / BLOCK) * bh;
  if (blocks_q > 0x7fffffffLL || blocks_k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // boxes of the resident tiles' rows (BLOCK_Q, BLOCK) and of the streamed ones' (TQ, TK)
  CUtensorMap q_b, do_b, k_t, v_t, k_b, v_b, q_t, do_t;
  int rc = make_map(&q_b, q, bh, s, D, C::BLOCK_Q);
  if (rc == 0) rc = make_map(&do_b, dout, bh, s, D, C::BLOCK_Q);
  if (rc == 0) rc = make_map(&k_t, k, bh, s, D, C::TQ);
  if (rc == 0) rc = make_map(&v_t, v, bh, s, D, C::TQ);
  if (rc == 0) rc = make_map(&k_b, k, bh, s, D, BLOCK);
  if (rc == 0) rc = make_map(&v_b, v, bh, s, D, BLOCK);
  if (rc == 0) rc = make_map(&q_t, q, bh, s, D, C::TK);
  if (rc == 0) rc = make_map(&do_t, dout, bh, s, D, C::TK);
  if (rc != 0) return rc;
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM_KV);
  if (err != cudaSuccess) return (int)err;
  const int s_pad = (int)padded_rows(s);
  bwd_dq<D><<<(unsigned int)blocks_q, C::THREADS_Q, C::SMEM_DQ, stream>>>(
      q_b, do_b, k_t, v_t, lse, (__nv_bfloat16*)dq, lse2, delta, (int)bh, s, s_pad, scale);
  REPRO_LAUNCH_CHECK();
  bwd_dkdv<D><<<(unsigned int)blocks_k, THREADS, C::SMEM_KV, stream>>>(
      k_b, v_b, q_t, do_t, lse2, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (int)bh, s,
      s_pad, scale);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace hop

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace fp32 {

constexpr int THREADS = 256;
constexpr int TS = 16;  // a 16 x 16 grid: ty = tid / 16 picks rows, tx = tid % 16 keys and columns

template <int D>
struct Cfg {
  static constexpr int BT = D == 256 ? 32 : 64;  // query rows and keys a tile
  static constexpr int LD = D + 4;               // a padded (BT, D) tile row: 16-byte reads
  static constexpr int LP = BT + 16;             // a padded row of a (BT, BT) tile of P or dS
  static constexpr int R = BT / TS;              // rows (or keys) of a tile a thread
  static constexpr int CPT = D / TS;             // accumulator columns a thread: 4 tx + 64 h + e
  static constexpr int TILE = BT * LD;           // floats of a (BT, D) tile
  static constexpr int QO_BUFS = D == 128 ? 1 : 2;  // the dK/dV launch's Q and dO buffers
  // dQ: Q, dO, two buffers of K and V, dS, lse*log2e and Di of the rows
  static constexpr int SMEM_DQ = (6 * TILE + BT * LP + 2 * BT) * 4;
  // dK/dV: K, V, the buffers of Q and dO, P^T and dS^T, lse*log2e and Di per buffer
  static constexpr int SMEM_DKDV = (2 * TILE + 2 * QO_BUFS * TILE + 2 * BT * LP + 2 * QO_BUFS * BT) * 4;
};

// rows [r0, r0 + BT) of a (s, D) array into a padded tile with 16-byte
// cp.async copies; rows past s are zero-filled
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int r0,
                                           int s) {
  using C = Cfg<D>;
  for (int i = threadIdx.x; i < C::BT * D / 4; i += THREADS) {
    const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
    const bool valid = r0 + r < s;
    cp_async16(dst + r * C::LD + c4, src + (long long)(valid ? r0 + r : 0) * D + c4, valid);
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d]: a product over D of
// two padded (BT, D) tiles, 16-byte reads of both
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[Cfg<D>::R][Cfg<D>::R], const float* a,
                                         const float* b, int ty, int tx) {
  using C = Cfg<D>;
  constexpr int R = C::R, LD = C::LD;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + TS * i) * LD + d);
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + TS * j) * LD + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 tx + 64 h + e] += sum_r p[ty + 16 i][r] * t[r][4 tx + 64 h + e]: a
// product over the BT rows r of a padded (BT, D) tile t, with p a padded
// (BT, BT) tile
template <int D>
__device__ __forceinline__ void acc_rows(float (&acc)[Cfg<D>::R][Cfg<D>::CPT], const float* p,
                                         const float* t, int ty, int tx) {
  using C = Cfg<D>;
  constexpr int R = C::R, CPT = C::CPT, LD = C::LD, LP = C::LP;
#pragma unroll 1
  for (int r = 0; r < C::BT; r += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ty + TS * i) * LP + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float tv[CPT];
      ld_f4(tv, t + (r + rr) * LD + 4 * tx, 64);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pe = rr == 0 ? pv[i].x : rr == 1 ? pv[i].y : rr == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pe, tv[j], acc[i][j]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[Cfg<D>::R][Cfg<D>::CPT], int r0,
                                           int s, float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < Cfg<D>::R; ++i) {
    const int r = r0 + ty + TS * i;
    if (r >= s) continue;
#pragma unroll
    for (int h = 0; h < Cfg<D>::CPT / 4; ++h)
      *reinterpret_cast<float4*>(dst + (long long)r * D + 64 * h + 4 * tx) =
          make_float4(acc[i][4 * h] * mul, acc[i][4 * h + 1] * mul, acc[i][4 * h + 2] * mul,
                      acc[i][4 * h + 3] * mul);
  }
}

// dQ of one query tile, with Di and lse*log2e of its rows stored
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ lse2,
               float* __restrict__ delta, long long nbh, int s, int s_pad, float scale) {
  using C = Cfg<D>;
  constexpr int BT = C::BT, R = C::R, CPT = C::CPT, LP = C::LP, TILE = C::TILE;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sO = sQ + TILE;  // dO
  float* sK = sO + TILE;  // two buffers
  float* sV = sK + 2 * TILE;
  float* sS = sV + 2 * TILE;  // dS (BT, LP)
  float* sL = sS + BT * LP;   // lse*log2e of the rows
  float* sD = sL + BT;        // Di of the rows
  const long long n_qt = gridDim.x / nbh;
  const int qt = (int)(n_qt - 1 - blockIdx.x / nbh);  // heaviest tiles first
  const long long bh = blockIdx.x % nbh;
  const int q0 = qt * BT;
  const int tid = threadIdx.x, ty = tid / TS, tx = tid % TS;
  const long long off = bh * (long long)s * D;
  stage_tile<D>(sQ, q + off, q0, s);
  stage_tile<D>(sO, dout + off, q0, s);
  if (tid < BT) sL[tid] = q0 + tid < s ? lse[bh * s + q0 + tid] * LOG2E : 0.0f;
  const int n_kv = qt + 1;  // up to the diagonal
  auto stage = [&](int t, int buf) {
    const int k0 = (t < n_kv ? t : t - n_kv) * BT;
    stage_tile<D>(sK + buf * TILE, k + off, k0, s);
    stage_tile<D>(sV + buf * TILE, v + off, k0, s);
    cp_async_commit();
  };
  stage(0, 0);
  const float c = scale * LOG2E;
  float di[R], acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    di[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  }
  for (int t = 0; t < 2 * n_kv; ++t) {  // walk 1 (Di), then walk 2 (dQ)
    const int buf = t & 1, k0 = (t < n_kv ? t : t - n_kv) * BT;
    cp_async_wait_all();
    __syncthreads();  // tile t is in, and every thread is done with the other buffer and dS
    if (t + 1 < 2 * n_kv) stage(t + 1, buf ^ 1);
    const float* tK = sK + buf * TILE;
    float sc[R][R], dp[R][R];
    dot_rows<D>(sc, sQ, tK, ty, tx);
    dot_rows<D>(dp, sO, sV + buf * TILE, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + TS * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ex2(__fmaf_rn(sc[i][j], c, -sL[ty + TS * i]));
        sc[i][j] = k0 + tx + TS * j <= row && row < s ? p : 0.0f;
      }
    }
    if (t < n_kv) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) di[i] = fmaf(sc[i][j], dp[i][j], di[i]);
      if (t == n_kv - 1) {  // Di: a thread's keys in order, then the 16 lanes of the row
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int x = 1; x < TS; x <<= 1) di[i] += __shfl_xor_sync(0xffffffffu, di[i], x);
          const int r = ty + TS * i;
          if (tx == 0) {
            sD[r] = di[i];
            if (q0 + r < s) {
              delta[bh * s_pad + q0 + r] = di[i];
              lse2[bh * s_pad + q0 + r] = sL[r];
            }
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        sS[(ty + TS * i) * LP + tx + TS * j] = sc[i][j] * (dp[i][j] - sD[ty + TS * i]);
    __syncthreads();
    acc_rows<D>(acc, sS, tK, ty, tx);
  }
  store_rows<D>(dq + off, acc, q0, s, scale, ty, tx);
}

// dK and dV of one key tile
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lse2,
                 const float* __restrict__ delta, const float* __restrict__ dout,
                 float* __restrict__ dk, float* __restrict__ dv, long long nbh, int s, int s_pad,
                 float scale) {
  using C = Cfg<D>;
  constexpr int BT = C::BT, R = C::R, CPT = C::CPT, LP = C::LP, TILE = C::TILE;
  constexpr int BUFS = C::QO_BUFS;
  extern __shared__ __align__(16) float sm[];
  float* sK = sm;
  float* sV = sK + TILE;
  float* sQ = sV + TILE;          // BUFS buffers
  float* sO = sQ + BUFS * TILE;   // dO, BUFS buffers
  float* sP = sO + BUFS * TILE;   // round(P)^T (keys, rows)
  float* sS = sP + BT * LP;       // dS^T (keys, rows)
  float* sL = sS + BT * LP;       // lse*log2e of the rows, BUFS x BT
  float* sD = sL + BUFS * BT;     // Di of the rows, BUFS x BT
  const int kt = (int)(blockIdx.x / nbh);  // heaviest first: key tile 0 walks every query tile
  const long long bh = blockIdx.x % nbh;
  const int k0 = kt * BT;
  const int tid = threadIdx.x, ty = tid / TS, tx = tid % TS;
  const long long off = bh * (long long)s * D;
  const int n_t = (s + BT - 1) / BT;
  auto stage = [&](int qt, int buf) {
    stage_tile<D>(sQ + buf * TILE, q + off, qt * BT, s);
    stage_tile<D>(sO + buf * TILE, dout + off, qt * BT, s);
    if (tid < BT / 4) {  // the padded rows: always in range
      cp_async16(sL + buf * BT + 4 * tid, lse2 + bh * s_pad + qt * BT + 4 * tid, true);
      cp_async16(sD + buf * BT + 4 * tid, delta + bh * s_pad + qt * BT + 4 * tid, true);
    }
  };
  stage_tile<D>(sK, k + off, k0, s);
  stage_tile<D>(sV, v + off, k0, s);
  stage(kt, 0);
  cp_async_commit();
  const float c = scale * LOG2E;
  float adk[R][CPT], adv[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) adk[i][j] = adv[i][j] = 0.0f;
  for (int qt = kt; qt < n_t; ++qt) {  // query tiles from the diagonal on
    const int buf = BUFS == 2 ? (qt - kt) & 1 : 0, q0 = qt * BT;
    cp_async_wait_all();
    __syncthreads();  // tile qt is in; every thread is done with the other buffer, P^T and dS^T
    if (BUFS == 2 && qt + 1 < n_t) {
      stage(qt + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* tQ = sQ + buf * TILE;
    const float* tO = sO + buf * TILE;
    const float* tL = sL + buf * BT;
    const float* tD = sD + buf * BT;
    float sc[R][R], dp[R][R];  // transposed: key ty + 16 i, row tx + 16 j
    dot_rows<D>(sc, sK, tQ, ty, tx);
    dot_rows<D>(dp, sV, tO, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = k0 + ty + TS * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int rr = tx + TS * j, row = q0 + rr;
        const bool live = key <= row && row < s;
        const float p = ex2(__fmaf_rn(sc[i][j], c, -tL[rr]));
        sP[(ty + TS * i) * LP + rr] = live ? p : 0.0f;  // float32 P: the cast to v's type is the identity
        sS[(ty + TS * i) * LP + rr] = live ? p * (dp[i][j] - tD[rr]) : 0.0f;
      }
    }
    __syncthreads();
    acc_rows<D>(adv, sP, tO, ty, tx);
    acc_rows<D>(adk, sS, tQ, ty, tx);
    if (BUFS == 1 && qt + 1 < n_t) {
      __syncthreads();  // every thread is done with Q, dO, P^T and dS^T
      stage(qt + 1, 0);
      cp_async_commit();
    }
  }
  store_rows<D>(dk + off, adk, k0, s, scale, ty, tx);
  store_rows<D>(dv + off, adv, k0, s, 1.0f, ty, tx);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* lse, const void* dout,
           void* dq, void* dk, void* dv, float* lse2, float* delta, long long bh, int s,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long blocks = (long long)((s + C::BT - 1) / C::BT) * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bwd_dq_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM_DKDV);
  if (err != cudaSuccess) return (int)err;
  const int s_pad = (int)padded_rows(s);
  bwd_dq_f32<D><<<(unsigned int)blocks, THREADS, C::SMEM_DQ, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, lse, (const float*)dout, (float*)dq,
      lse2, delta, bh, s, s_pad, scale);
  REPRO_LAUNCH_CHECK();
  bwd_dkdv_f32<D><<<(unsigned int)blocks, THREADS, C::SMEM_DKDV, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, lse2, delta, (const float*)dout,
      (float*)dk, (float*)dv, bh, s, s_pad, scale);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace fp32

template <int D>
int launch(const void* q, const void* k, const void* v, const float* lse, const void* dout,
           void* dq, void* dk, void* dv, float* lse2, float* delta, long long bh, int s,
           int dtype, float scale, cudaStream_t stream) {
  if (dtype == REPRO_BF16)
    return hop::launch<D>(q, k, v, lse, dout, dq, dk, dv, lse2, delta, bh, s, scale, stream);
  if (dtype == REPRO_F32)
    return fp32::launch<D>(q, k, v, lse, dout, dq, dk, dv, lse2, delta, bh, s, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Floats of scratch that repro_flash_attention_bwd needs: Di and lse*log2e
// of every row, each (bh, s padded to a multiple of 64).
long long repro_flash_attention_bwd_workspace(long long bh, int s) {
  return 2 * bh * padded_rows(s);
}

// q, k, v, dout, dq, dk, dv: (bh, s, d) contiguous and 16-byte aligned, of
// dtype code REPRO_F32 or REPRO_BF16; d is 64, 128 or 256.  lse: (bh, s)
// float32.  workspace: repro_flash_attention_bwd_workspace(bh, s) floats,
// written.  Two launches on `stream`: dq (with Di), then dk and dv.
// Returns 0 or the CUDA error of a launch (cudaErrorNotSupported if the
// driver has no tensor-map encoder).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* lse,
                              const void* dout, void* dq, void* dk, void* dv, void* workspace,
                              long long bh, int s, int d, int dtype, float scale, void* stream) {
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* delta = (float*)workspace;
  float* lse2 = delta + bh * padded_rows(s);
  if (d == 64)
    return launch<64>(q, k, v, l, dout, dq, dk, dv, lse2, delta, bh, s, dtype, scale, st);
  if (d == 128)
    return launch<128>(q, k, v, l, dout, dq, dk, dv, lse2, delta, bh, s, dtype, scale, st);
  if (d == 256)
    return launch<256>(q, k, v, l, dout, dq, dk, dv, lse2, delta, bh, s, dtype, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
