// mqr-KV block-table decode attention over the K blocks the index selected.
//
// Replaces the Pallas kernel `_kernel` of
// src/repro/kernels/mqr_sparse_attention.py (called from
// `mqr_sparse_attention`, kernel #9).  q (BH, D); k and v blocks
// (BH / group, nb, bs, D); ids (BH, K) int32; pos (a device int32: the
// inclusive causal limit) -> out (BH, D).  float32 or bfloat16.  Query row r
// reads kv row r / group, so grouped-query attention reads the KV cache in
// place (group 1 is the reference's one kv row per query row).
//
// Per query row, over the K ids (the TPU kernel walks them in order):
//   logits_j = (q . k_j) * (1/sqrt(D)), products of the input type summed
//              in float32; key id*bs + j > pos -> -1e30 (finite: a first
//              block wholly past pos weighs in with exp(0) = 1 until a
//              later block wipes it, and a fully masked row averages
//              uniformly, as the reference does);
//   out = sum_j cast(p_j) v_j / max(sum_j p_j, 1e-30), p_j = exp(logit_j - m)
//   with m the running max, p rounded to v's type before the product, as
//   the reference casts it, and the output in q's type.
// Repeated ids are attended each time they appear.  An id outside [0, nb)
// reads the block that the reference's jnp gather (`ref.py`) reads — a
// negative id counts from the end, then the index is clamped to [0, nb) —
// and masks with the id as given.  That softmax does not depend on the
// order of the keys, so the kernel takes them in another order: each
// distinct selected block once, weighed by how often each head selected it
// (ROADMAP C30: the result differs from the walk by rounding only).
//
// What bounds it on an H100: bytes.  Each distinct (kv row, block) among the
// selected ones is read once, k and v, bs x D each, for all the heads of
// the group that selected it; about G / 2 float32 FMAs a byte in bf16 (4 at
// G 8), under the card's ~10.
//
// What the design does about it:
// * Grid: one block (4 warps) per (query group, split), as many as fit on
//   the card at once (one wave: a second, partial wave would double the
//   time).  A query group is GS consecutive query rows of one kv row (GS
//   the largest power of two <= 8 dividing `group`).  Each block loads the
//   group's GS x K ids, marks the in-range ones in a bitmap over [0, nb),
//   and numbers the distinct ids by a prefix count of the bitmap (ids out
//   of range are numbered after them, one item per appearance, in order).
//   Every block of the group finds the same numbering; the items' sub-tiles
//   of tk keys are cut into `splits` equal shares, and a block counts, per
//   head, how often each item of its share was selected.
// * Loads: each warp streams its sub-tiles (units w, w + 4, ... of the
//   block's share) through its own ring of STAGES shared-memory stages; one
//   lane issues two TMA bulk copies (cp.async.bulk, k and v, tk x D
//   contiguous each) per stage, completed on the stage's mbarrier, STAGES
//   ahead of the computation.  A sub-tile holds 2-8 KB of k, so any bs and
//   any D up to 256 fit, in float32 too, and many warps fit on an SM.
// * Compute, on the CUDA cores in float32: a lane owns CW consecutive
//   columns of D and keeps q of every head of the group for them in
//   registers.  A batch of NB = 32 / GS keys gives 32 (key, head) dot
//   products; each lane forms its partial sums of all 32 from k read once
//   from shared memory, and a reduce-scatter over the warp (31 shuffles and
//   adds: slot s of lane l holds pair s ^ l, so no lane selects what it
//   keeps) leaves lane l the whole logit of pair l.  The online softmax
//   then runs one pair a lane in base 2 (logit * log2 e, ex2 on the SFU; a
//   head's max over its lanes by shuffles); p rounded to v's type and times
//   the head's count goes through 32 floats of shared memory, and each lane
//   adds p . v for its columns and every head, v read once from shared
//   memory.
// * Merge: each warp keeps (m, l, acc) per head; a block merges its warps in
//   shared memory and writes one partial per head; a second launch, one
//   block per (group, head) and a thread a column, merges the group's
//   partials in split order:
//   out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30),
//   M = max_s m_s.  An empty share keeps m = -1e30, l = 0 and weighs
//   nothing.  The host never reads ids or pos.
#include "hopper.cuh"

namespace {

// Chosen on the H100 at the models' shapes: the kernel is bound by how many
// warps hide its latencies, so 2 stages of 2-8 KB sub-tiles (3-5 blocks an
// SM) beat deeper rings, smaller or larger sub-tiles and 8-warp blocks.
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;          // ring stages of each warp
constexpr int ITEM_CAP = 256;      // items (distinct blocks) one share may touch
constexpr int MAX_NB = 65536;      // blocks the in-range bitmap covers
constexpr int MAX_SPLITS = 1024;
constexpr int STAGE_MIN = 2048;    // bytes of one k (or v) sub-tile: at least,
constexpr int STAGE_MAX = 8192;    // and at most (also at most 32 keys)
constexpr int MERGE_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

template <int BYTES> struct Vec;
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };

// Columns col0 .. col0 + CW - 1 of a row of T as floats (0 past d), in
// vector loads of up to 16 bytes; d is a multiple of each load's width.
template <typename T, int CW>
__device__ __forceinline__ void load_cols(float (&x)[CW], const T* row, int col0, int d) {
  constexpr int UNIT = CW * (int)sizeof(T) < 16 ? CW : 16 / (int)sizeof(T);
  using V = typename Vec<UNIT * (int)sizeof(T)>::type;
#pragma unroll
  for (int u = 0; u < CW; u += UNIT) {
    if (col0 + u < d) {
      const V w = *reinterpret_cast<const V*>(row + col0 + u);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < UNIT; ++i) x[u + i] = repro_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < UNIT; ++i) x[u + i] = 0.0f;
    }
  }
}

// GS floats at p (16-byte aligned for GS >= 4, 8 for GS 2).
template <int GS>
__device__ __forceinline__ void load_weights(float (&w)[GS], const float* p) {
  if constexpr (GS >= 4) {
#pragma unroll
    for (int i = 0; i < GS / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      w[4 * i] = t.x;
      w[4 * i + 1] = t.y;
      w[4 * i + 2] = t.z;
      w[4 * i + 3] = t.w;
    }
  } else if constexpr (GS == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    w[0] = p[0];
  }
}

// One level of the warp's reduce-scatter.  Slot s of lane l holds the
// partial sum of pair s ^ l, so the lower OFF slots are the ones a lane
// keeps and the upper OFF the ones its partner l ^ OFF keeps: slot s + OFF
// of the partner holds the same pair as slot s here.
template <int OFF>
__device__ __forceinline__ void scatter_level(float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < OFF; ++i) v[i] += __shfl_xor_sync(FULL, v[i + OFF], OFF);
}

// Exclusive prefix of v over the block; every thread gets the block's total.
// `scratch` holds WARPS ints; the trailing barrier frees it at once.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Bytes at the start of shared memory that hold the warps' rings, then
// their partials; a multiple of 128 so that the mbarriers after it are
// aligned.
__host__ __device__ __forceinline__ size_t scratch_of(size_t ring, int gs, int d) {
  size_t b = (size_t)WARPS * gs * (d + 2) * sizeof(float);
  if (ring > b) b = ring;
  return (b + 127) / 128 * 128;
}

// The launch's shape decisions, made the same way by the workspace query
// and the launch.
struct Plan {
  int gs, cw, tk, splits;
  long long groups;
  size_t smem;
};

template <typename T, int GS, int CW>
__global__ void __launch_bounds__(THREADS)
    sparse_groups(const T* __restrict__ q, const T* __restrict__ kb, const T* __restrict__ vb,
                  const int* __restrict__ ids, const int* __restrict__ pos_ptr,
                  long long pos_value, float* __restrict__ part, int nb, int bs, int kk,
                  int d, int group, int tk, int splits, float scale) {
  constexpr int NB = 32 / GS;  // keys of a batch: NB x GS (key, head) pairs, one a lane
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long g = blockIdx.x / splits;
  const int sp = blockIdx.x % splits;
  const long long row0 = g * GS;       // the group's first query row
  const long long kv = row0 / group;   // the kv row all of them read
  const int n_ids = GS * kk;
  const int* gids = ids + row0 * kk;   // the group's ids, head-major
  const int nwords = (nb + 31) >> 5;
  const int pitch = d + 4;             // a partial: m, l, 2 unused, acc[d]
  const size_t sub_elems = (size_t)tk * d;
  const size_t sub_bytes = sub_elems * sizeof(T);
  const size_t ring_bytes = (size_t)WARPS * STAGES * 2 * sub_bytes;
  const size_t scratch = scratch_of(ring_bytes, GS, d);
  unsigned char* ring = smem;  // the warps' rings, later the warps' partials
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + scratch);
  float* s_w = reinterpret_cast<float*>(bars + WARPS * STAGES);  // WARPS x 32 weights
  int* s_cnt = reinterpret_cast<int*>(s_w + WARPS * 32);         // ITEM_CAP x GS counts
  int* s_raw = s_cnt + ITEM_CAP * GS;                            // ITEM_CAP raw ids
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_raw + ITEM_CAP);
  int* s_pre = reinterpret_cast<int*>(s_bits + nwords);          // ranks before each word
  int* s_misc = s_pre + nwords;  // n_out, then WARPS of scan scratch

  // q of the group's heads for this lane's columns, its loads in flight
  // while the ids are numbered.  Batch slot (a, b) of lane l (slot index
  // a * GS + b) holds pair (key a ^ la, head b ^ lb), l = la * GS + lb, so
  // head b ^ lb's q is kept in qr[b].
  constexpr int LG = GS == 1 ? 0 : (GS == 2 ? 1 : (GS == 4 ? 2 : 3));
  const int la = lane >> LG, lb = lane & (GS - 1);
  const int col0 = lane * CW;
  float qr[GS][CW], acc[GS][CW];
#pragma unroll
  for (int b = 0; b < GS; ++b)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      qr[b][c] = col0 + c < d ? repro_f32(q[(row0 + (b ^ lb)) * d + col0 + c]) : 0.0f;
      acc[b][c] = 0.0f;
    }
  const long long pos = pos_ptr ? (long long)*pos_ptr : pos_value;

  // -- the group's distinct ids --------------------------------------------
  for (int w = tid; w < nwords; w += THREADS) s_bits[w] = 0u;
  if (tid == 0) {
    s_misc[0] = 0;
    for (int i = 0; i < WARPS * STAGES; ++i) mbar_init(smem_addr(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int mine_out = 0;
  for (int e = tid; e < n_ids; e += THREADS) {
    const int raw = gids[e];
    if (raw >= 0 && raw < nb)
      atomicOr(&s_bits[raw >> 5], 1u << (raw & 31));
    else
      ++mine_out;
  }
  if (mine_out) atomicAdd(&s_misc[0], mine_out);
  __syncthreads();
  const int per = (nwords + THREADS - 1) / THREADS;
  const int w0 = min(nwords, tid * per), w1 = min(nwords, w0 + per);
  int ones = 0;
  for (int w = w0; w < w1; ++w) ones += __popc(s_bits[w]);
  int n_in;
  int run = block_exclusive_scan(ones, &n_in, s_misc + 1);
  for (int w = w0; w < w1; ++w) {
    s_pre[w] = run;
    run += __popc(s_bits[w]);
  }
  const int n_out = s_misc[0];
  const int per_block = bs / tk;  // sub-tiles of a block
  const long long units = (long long)(n_in + n_out) * per_block;
  const long long u0 = units * sp / splits, u1 = units * (sp + 1) / splits;
  const int i0 = (int)(u0 / per_block);
  const int i1 = (int)((u1 + per_block - 1) / per_block);
  for (int i = tid; i < (i1 - i0) * GS; i += THREADS) s_cnt[i] = 0;
  __syncthreads();
  // the items of this share: raw id and selections per head
  int out_base = 0;
  for (int c0 = 0; c0 < n_ids; c0 += THREADS) {
    const int e = c0 + tid;
    const int raw = e < n_ids ? gids[e] : 0;
    const bool in_range = raw >= 0 && raw < nb;
    int rank = 0, chunk_out = 0;
    if (n_out)  // uniform: every thread reads the same count
      rank = block_exclusive_scan(e < n_ids && !in_range, &chunk_out, s_misc + 1);
    if (e < n_ids) {
      int item;
      if (in_range) {
        const int w = raw >> 5;
        item = s_pre[w] + __popc(s_bits[w] & ((1u << (raw & 31)) - 1u));
      } else {
        item = n_in + out_base + rank;
      }
      if (item >= i0 && item < i1 && item - i0 < ITEM_CAP) {
        atomicAdd(&s_cnt[(item - i0) * GS + e / kk], 1);
        s_raw[item - i0] = raw;
      }
    }
    out_base += chunk_out;
  }
  __syncthreads();

  // -- each warp streams its sub-tiles ---------------------------------------
  // After a batch's reduction lane l holds pair l: key la, head lb.  m is
  // head lb's running max of the logits in base 2 (logit * log2 e), lsum
  // this lane's share of its sum.
  const int head = lb;
  const float scale2 = scale * 1.4426950408889634f;
  float m = REPRO_NEG, lsum = 0.0f;
  unsigned char* my_ring = ring + (size_t)warp * STAGES * 2 * sub_bytes;
  const uint32_t my_bars = smem_addr(bars + warp * STAGES);
  float* w_buf = s_w + warp * 32;
  const long long first = u0 + warp;
  const int n_mine = first < u1 ? (int)((u1 - 1 - first) / WARPS + 1) : 0;
  auto issue = [&](int it) {  // one lane: the stage of the warp's it-th unit
    const long long u = first + (long long)it * WARPS;
    const int raw = s_raw[(int)(u / per_block) - i0];
    const int wrapped = raw < 0 ? raw + nb : raw;
    const int id = wrapped < 0 ? 0 : (wrapped >= nb ? nb - 1 : wrapped);
    const size_t off = (((size_t)kv * nb + id) * bs + (size_t)(u % per_block) * tk) * d;
    const int st = it % STAGES;
    const uint32_t bar = my_bars + 8 * st;
    unsigned char* dst = my_ring + (size_t)st * 2 * sub_bytes;
    mbar_expect_tx(bar, (uint32_t)(2 * sub_bytes));
    bulk_load(smem_addr(dst), kb + off, (uint32_t)sub_bytes, bar);
    bulk_load(smem_addr(dst + sub_bytes), vb + off, (uint32_t)sub_bytes, bar);
  };
  if (lane == 0)
    for (int it = 0; it < min(STAGES, n_mine); ++it) issue(it);

  for (int it = 0; it < n_mine; ++it) {
    const long long u = first + (long long)it * WARPS;
    const int li = (int)(u / per_block) - i0;
    const int j0 = (int)(u % per_block) * tk;
    const long long key0 = (long long)s_raw[li] * bs + j0;  // masks use the raw id
    const int cnt = s_cnt[li * GS + head];
    const int st = it % STAGES;
    mbar_wait(my_bars + 8 * st, (it / STAGES) & 1);
    const T* sk = reinterpret_cast<const T*>(my_ring + (size_t)st * 2 * sub_bytes);
    const T* sv = sk + sub_elems;
    for (int jb = 0; jb < tk; jb += NB) {
      // logits of NB keys x GS heads: partial sums over this lane's columns
      float v[32];
#pragma unroll
      for (int a = 0; a < NB; ++a) {
        float kf[CW];
        if (jb + (a ^ la) < tk) {
          load_cols<T, CW>(kf, sk + (size_t)(jb + (a ^ la)) * d, col0, d);
        } else {
#pragma unroll
          for (int c = 0; c < CW; ++c) kf[c] = 0.0f;
        }
#pragma unroll
        for (int b = 0; b < GS; ++b) {
          float s = 0.0f;
#pragma unroll
          for (int c = 0; c < CW; ++c) s = fmaf(qr[b][c], kf[c], s);
          v[a * GS + b] = s;
        }
      }
      scatter_level<16>(v);
      scatter_level<8>(v);
      scatter_level<4>(v);
      scatter_level<2>(v);
      scatter_level<1>(v);
      // lane = pair (key jb + la, head lb), its logit in base 2
      const int j = jb + la;
      const bool key_ok = j < tk;
      float s = v[0] * scale2;
      if (key0 + j > pos) s = REPRO_NEG;
      float bm = key_ok ? s : -INFINITY;
#pragma unroll
      for (int o = GS; o < 32; o <<= 1) bm = fmaxf(bm, __shfl_xor_sync(FULL, bm, o));
      float alpha = 1.0f, p = 0.0f;
      if (cnt > 0) {  // a head that did not select the block skips it
        const float mn = fmaxf(m, bm);
        alpha = ex2(m - mn);
        if (key_ok) p = ex2(s - mn);
        m = mn;
      }
      lsum = fmaf(lsum, alpha, (float)cnt * p);
      w_buf[lane] = (float)cnt * repro_round_to<T>(p);
      __syncwarp();
      if (__any_sync(FULL, alpha != 1.0f)) {  // a head's max moved: rescale its sums
#pragma unroll
        for (int h = 0; h < GS; ++h) {
          const float a = __shfl_sync(FULL, alpha, h);  // lane h: key 0, head h
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[h][c] *= a;
        }
      }
#pragma unroll
      for (int jj = 0; jj < NB; ++jj) {
        if (jb + jj < tk) {
          float vf[CW], wv[GS];
          load_cols<T, CW>(vf, sv + (size_t)(jb + jj) * d, col0, d);
          load_weights<GS>(wv, w_buf + jj * GS);
#pragma unroll
          for (int h = 0; h < GS; ++h)
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[h][c] = fmaf(wv[h], vf[c], acc[h][c]);
        }
      }
      __syncwarp();  // w_buf is rewritten by the next batch
    }
    if (lane == 0 && it + STAGES < n_mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(it + STAGES);
    }
  }
#pragma unroll
  for (int o = GS; o < 32; o <<= 1) lsum += __shfl_xor_sync(FULL, lsum, o);

  // -- this block's partial: its warps merged --------------------------------
  __syncthreads();  // every ring is drained: its bytes hold the warps' partials
  float* s_ml = reinterpret_cast<float*>(ring);  // WARPS x GS x (m, l)
  float* s_acc = s_ml + WARPS * GS * 2;          // WARPS x GS x d
  if (lane < GS) {
    s_ml[(warp * GS + lane) * 2] = m;
    s_ml[(warp * GS + lane) * 2 + 1] = lsum;
  }
#pragma unroll
  for (int h = 0; h < GS; ++h)
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (col0 + c < d) s_acc[(warp * GS + h) * d + col0 + c] = acc[h][c];
  __syncthreads();
  float* mine = part + (size_t)blockIdx.x * GS * pitch;
  for (int i = tid; i < GS * pitch; i += THREADS) {
    const int h = i / pitch, c = i % pitch;
    if (c == 2 || c == 3) continue;
    float mx = REPRO_NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_ml[(w * GS + h) * 2]);
    float r = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float x = c == 1 ? s_ml[(w * GS + h) * 2 + 1] : s_acc[(w * GS + h) * d + c - 4];
      r = fmaf(ex2(s_ml[(w * GS + h) * 2] - mx), x, r);
    }
    mine[i] = c == 0 ? mx : r;
  }
}

// The group's partials merged in split order, one block per (group, head),
// a thread a column: out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M)
// l_s, 1e-30), M = max_s m_s (base-2 logits).  Every thread reads the same
// m_s and l_s (one broadcast load each), so no thread waits on another.  An
// empty share (m = -1e30, l = 0, acc = 0) weighs nothing.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
    sparse_merge(const float* __restrict__ part, T* __restrict__ out, int gs, int d,
                 int splits) {
  const long long g = blockIdx.x / gs;
  const int h = blockIdx.x % gs;
  const size_t step = (size_t)gs * (d + 4);  // one split's partial of this head to the next
  const float* gp = part + g * splits * step + (size_t)h * (d + 4);
  float mx = REPRO_NEG;
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, gp[sp * step]);
  float l = 0.0f;
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) l = fmaf(ex2(gp[sp * step] - mx), gp[sp * step + 1], l);
  l = fmaxf(l, 1e-30f);
  for (int c = threadIdx.x; c < d; c += MERGE_THREADS) {
    float o = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      o = fmaf(ex2(gp[sp * step] - mx), gp[sp * step + 4 + c], o);
    out[(g * gs + h) * d + c] = repro_from_f32<T>(o / l);
  }
}

template <typename T, int GS, int CW>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&sparse_groups<T, GS, CW>);
}

const void* pick(int dtype, int gs, int cw) {
#define REPRO_PICK(T, G)                        \
  if (cw == 2) return kernel_of<T, G, 2>();     \
  if (cw == 4) return kernel_of<T, G, 4>();     \
  if (cw == 8) return kernel_of<T, G, 8>();     \
  return nullptr;
  if (dtype == REPRO_F32) {
    if (gs == 1) { REPRO_PICK(float, 1) }
    if (gs == 2) { REPRO_PICK(float, 2) }
    if (gs == 4) { REPRO_PICK(float, 4) }
    if (gs == 8) { REPRO_PICK(float, 8) }
  } else if (dtype == REPRO_BF16) {
    if (gs == 1) { REPRO_PICK(__nv_bfloat16, 1) }
    if (gs == 2) { REPRO_PICK(__nv_bfloat16, 2) }
    if (gs == 4) { REPRO_PICK(__nv_bfloat16, 4) }
    if (gs == 8) { REPRO_PICK(__nv_bfloat16, 8) }
  }
#undef REPRO_PICK
  return nullptr;
}

size_t smem_of(int es, int gs, int d, int tk, int nb) {
  const size_t scratch = scratch_of((size_t)WARPS * STAGES * 2 * tk * d * es, gs, d);
  const int nwords = (nb + 31) / 32;
  return scratch + (size_t)WARPS * STAGES * 8 + (size_t)WARPS * 32 * sizeof(float) +
         (size_t)ITEM_CAP * (gs + 1) * sizeof(int) + 2 * (size_t)nwords * 4 +
         (1 + WARPS) * sizeof(int);
}

// 0, or cudaErrorInvalidValue for a shape the kernel does not take.
int plan_of(long long bh, int nb, int bs, int kk, int d, int group, int dtype, Plan* p) {
  const int es = dtype == REPRO_F32 ? 4 : (dtype == REPRO_BF16 ? 2 : 0);
  if (es == 0 || bh <= 0 || nb <= 0 || nb > MAX_NB || bs <= 0 || kk <= 0 || d <= 0 ||
      d > 256 || (d * es) % 16 || group <= 0 || bh % group)
    return (int)cudaErrorInvalidValue;
  int gs = 8;
  while (group % gs) gs >>= 1;
  p->gs = gs;
  p->cw = d <= 64 ? 2 : (d <= 128 ? 4 : 8);
  const int row = d * es;
  int want = STAGE_MIN / row;
  if (want < 32 / gs) want = 32 / gs;  // a whole batch where it fits
  if (want > STAGE_MAX / row) want = STAGE_MAX / row;
  if (want > 32) want = 32;
  int tk = 1;
  while (tk * 2 <= want && bs % (tk * 2) == 0) tk *= 2;
  p->tk = tk;
  p->groups = bh / gs;
  const long long n_ids = (long long)gs * kk;
  const long long units_max = n_ids * (bs / tk);
  // One wave of blocks: as many as the card holds at once (a second,
  // partial wave would double the time), and shares of at most ITEM_CAP
  // items.
  const void* kernel = pick(dtype, gs, p->cw);
  p->smem = smem_of(es, gs, d, tk, nb);
  int per_sm = 0;
  if (kernel == nullptr || p->smem > 232448 ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p->smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, p->smem) !=
          cudaSuccess ||
      per_sm < 1)
    return (int)cudaErrorInvalidValue;
  long long splits = (long long)repro_sm_count() * per_sm / p->groups;
  if (splits < 1) splits = 1;
  const long long by_items = (n_ids + ITEM_CAP - 5) / (ITEM_CAP - 4);
  if (splits < by_items) splits = by_items;
  if (splits > units_max) splits = units_max;
  if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  if (splits < by_items || p->groups * splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p->splits = (int)splits;
  return 0;
}

int launch(const Plan& p, const void* kernel, const void* q, const void* kb, const void* vb,
           const void* ids, const void* pos, long long pos_value, void* part, int nb, int bs,
           int kk, int d, int group, float scale, cudaStream_t stream) {
  int tk = p.tk, splits = p.splits;
  void* args[] = {(void*)&q,  (void*)&kb, (void*)&vb, (void*)&ids, (void*)&pos,
                  (void*)&pos_value, (void*)&part, (void*)&nb, (void*)&bs, (void*)&kk,
                  (void*)&d, (void*)&group, (void*)&tk, (void*)&splits, (void*)&scale};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned int)(p.groups * p.splits)), dim3(THREADS),
                               args, p.smem, stream);
}

}  // namespace

extern "C" {

// Float32 elements of the partials workspace that a launch of
// repro_mqr_sparse_attention at this shape needs, or a negative CUDA error
// for a shape the kernel does not take.
long long repro_mqr_sparse_attention_workspace(long long bh, int nb, int bs, int kk, int d,
                                               int group, int dtype) {
  Plan p;
  const int rc = plan_of(bh, nb, bs, kk, d, group, dtype, &p);
  if (rc != 0) return -(long long)rc;
  return p.groups * p.splits * p.gs * (long long)(d + 4);
}

// q: (bh, d); k_blocks, v_blocks: (bh / group, nb, bs, d), 16-byte aligned;
// ids: (bh, kk) int32; pos: one int32 in device memory, or null and the
// limit in pos_value; part: float32
// workspace of repro_mqr_sparse_attention_workspace(...) elements, 16-byte
// aligned; out: (bh, d).  dtype: REPRO_F32 or REPRO_BF16 for q, k, v and
// out alike; d a multiple of 16 bytes' worth of elements, at most 256; nb
// at most 65,536.  Two launches, the partials and their merge; returns 0 or
// the CUDA error of either.
int repro_mqr_sparse_attention(const void* q, const void* k_blocks, const void* v_blocks,
                               const void* ids, const void* pos, long long pos_value,
                               void* part, void* out, long long bh, int nb, int bs, int kk, int d,
                               int group, int dtype, float scale, void* stream) {
  if (bh == 0) return 0;
  Plan p;
  const int rc = plan_of(bh, nb, bs, kk, d, group, dtype, &p);
  if (rc != 0) return rc;
  const void* kernel = pick(dtype, p.gs, p.cw);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = (cudaError_t)launch(p, kernel, q, k_blocks, v_blocks, ids, pos, pos_value, part, nb,
                            bs, kk, d, group, scale, st);
  if (err != cudaSuccess) return (int)err;
  const unsigned int merges = (unsigned int)(p.groups * p.gs);
  if (dtype == REPRO_F32)
    sparse_merge<float><<<merges, MERGE_THREADS, 0, st>>>((const float*)part, (float*)out, p.gs,
                                                          d, p.splits);
  else
    sparse_merge<__nv_bfloat16><<<merges, MERGE_THREADS, 0, st>>>(
        (const float*)part, (__nv_bfloat16*)out, p.gs, d, p.splits);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
