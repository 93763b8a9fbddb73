// mqr-KV block-table decode attention over the K blocks the index selected.
//
// Replaces the Pallas kernel `_kernel` of
// src/repro/kernels/mqr_sparse_attention.py (called from
// `mqr_sparse_attention`, kernel #9).  q (BH, D); k and v blocks
// (BH / group, nb, bs, D); ids (BH, K) int32; pos (a device int32: the
// inclusive causal limit) -> out (BH, D).  float32 or bfloat16.  Query row r
// reads kv row r / group, so grouped-query attention reads the KV cache in
// place, each kv head's blocks once per query head of its group (group 1
// is the reference's one kv row per query row).
//
// Per (b, h), over the K ids in order (the TPU kernel's sequential grid
// axis; here cut into chunks that are merged in order, see below):
//   logits_j = (q . k_j) * (1/sqrt(D)), products of the input type summed
//              in float32; key id*bs + j > pos -> -1e30 (finite: a first
//              block wholly past pos then weighs in with exp(0) = 1 until a
//              later block wipes it through alpha = 0, and a fully masked
//              row averages uniformly, as the reference does);
//   m' = max(m, max_j logits), alpha = exp(m - m'), p_j = exp(logits_j - m'),
//   l = l * alpha + sum_j p_j, acc = acc * alpha + sum_j cast(p_j) v_j
//   (p rounded to v's type before the product, as the reference casts it);
// and out = acc / max(l, 1e-30) in q's type.  Repeated ids are attended
// each time they appear.  An id outside [0, nb) reads the block that the
// reference's jnp gather (`ref.py`) reads — a negative id counts from the
// end, then the index is clamped to [0, nb) — and masks with the id as given.
//
// What bounds it on an H100: bytes, K*bs*D elements each of k and v per
// (b, h), each read once; a few operations per element.
//
// What the design does about it: the K ids of a (b, h) are split into
// chunks of a few ids, one block (128 threads) per (b, h, chunk), so enough
// blocks are in flight to keep the loads of many blocks outstanding at
// once; a first version with one block per (b, h) walking all K blocks in
// order was latency-bound (PERF.md).  Per id, the block stages the whole
// k and v block (bs x D, contiguous) in shared memory with 16-byte loads,
// all issued before any is used; rows are padded by 16 bytes so that the
// per-key reads below hit distinct banks.  Logits: one thread per key,
// dot product from shared memory.  P.V: thread t owns output column t % D
// for keys j = t / D (mod 128 / D).  Each chunk leaves its own (m, l,
// acc[D]) in a float32 workspace; a second kernel merges the chunks in
// order, out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M) l_c, 1e-30)
// with M = max_c m_c, which is the sequential walk's result up to rounding
// (a chunk wholly past pos keeps m = -1e30 and weighs exactly as it would
// have in the walk).  The block reads its ids and pos from device memory
// (the TPU scalar-prefetched them; the host never reads either).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sparse_partial(const T* __restrict__ q, const T* __restrict__ kb,
                   const T* __restrict__ vb, const int* __restrict__ ids,
                   const int* __restrict__ pos_ptr, float* __restrict__ part, int nb, int bs,
                   int kk, int d, int chunk, int splits, int group, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int vec = 16 / (int)sizeof(T);          // elements per 16-byte load
  const int row_vecs = d / vec;
  const int row_bytes = d * (int)sizeof(T) + 16;  // padded shared row
  unsigned char* sK = smem;
  unsigned char* sV = sK + (size_t)bs * row_bytes;
  float* s_q = reinterpret_cast<float*>(sV + (size_t)bs * row_bytes);  // d
  float* s_p = s_q + d;      // bs: logits, then p rounded to T
  float* s_red = s_p + bs;   // 32
  const long long bh = blockIdx.x / splits;
  const long long kv = bh / group;  // the kv row this query row reads
  const int sp = blockIdx.x % splits;
  const int t0 = sp * chunk, t1 = min(kk, t0 + chunk);
  const int tid = threadIdx.x;
  const int groups = THREADS / d, grp = tid / d, col = tid % d;

  for (int i = tid; i < d; i += THREADS) s_q[i] = repro_f32(q[bh * d + i]);
  const long long pos = *pos_ptr;
  float m = REPRO_NEG, l = 0.0f, acc = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const int raw = ids[bh * kk + t];
    const int wrapped = raw < 0 ? raw + nb : raw;
    const int id = wrapped < 0 ? 0 : (wrapped >= nb ? nb - 1 : wrapped);
    const long long base = ((kv * nb + id) * (long long)bs) * d;
    const uint4* kg = reinterpret_cast<const uint4*>(kb + base);
    const uint4* vg = reinterpret_cast<const uint4*>(vb + base);
    for (int i = tid; i < bs * row_vecs; i += THREADS) {
      const int j = i / row_vecs, c = i % row_vecs;
      const uint4 kv = kg[i], vv = vg[i];
      *reinterpret_cast<uint4*>(sK + (size_t)j * row_bytes + c * 16) = kv;
      *reinterpret_cast<uint4*>(sV + (size_t)j * row_bytes + c * 16) = vv;
    }
    __syncthreads();  // also publishes s_q on the first id
    for (int j = tid; j < bs; j += THREADS) {
      const uint4* kr = reinterpret_cast<const uint4*>(sK + (size_t)j * row_bytes);
      float s = 0.0f;
      for (int c = 0; c < row_vecs; ++c) {
        const uint4 w = kr[c];
        const T* e = reinterpret_cast<const T*>(&w);
        for (int u = 0; u < vec; ++u) s = fmaf(s_q[c * vec + u], repro_f32(e[u]), s);
      }
      const long long kpos = (long long)raw * bs + j;
      s_p[j] = kpos <= pos ? s * scale : REPRO_NEG;
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int j = tid; j < bs; j += THREADS) mx = fmaxf(mx, s_p[j]);
    const float m_new = fmaxf(m, repro_block_max(mx, s_red));
    const float alpha = expf(m - m_new);
    float ps = 0.0f;
    for (int j = tid; j < bs; j += THREADS) {
      const float p = expf(s_p[j] - m_new);
      ps += p;
      s_p[j] = repro_round_to<T>(p);
    }
    l = l * alpha + repro_block_sum(ps, s_red);  // its barrier publishes s_p
    acc *= alpha;
    for (int j = grp; j < bs; j += groups)
      acc = fmaf(s_p[j], repro_f32(reinterpret_cast<const T*>(sV + (size_t)j * row_bytes)[col]),
                 acc);
    m = m_new;
    __syncthreads();  // sK, sV and s_p are rewritten for the next id
  }
  float* s_acc = reinterpret_cast<float*>(sK);  // THREADS floats, free now
  s_acc[tid] = acc;
  __syncthreads();
  float* out = part + (bh * splits + sp) * (long long)(d + 2);
  if (tid < d) {
    float sum = 0.0f;
    for (int g = 0; g < groups; ++g) sum += s_acc[g * d + tid];
    out[2 + tid] = sum;
  }
  if (tid == 0) {
    out[0] = m;
    out[1] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sparse_combine(const float* __restrict__ part, T* __restrict__ out, int splits, int d) {
  const long long bh = blockIdx.x;
  const float* p = part + bh * splits * (long long)(d + 2);
  float mx = REPRO_NEG;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, p[s * (d + 2)]);
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float l = 0.0f, o = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = p + s * (d + 2);
      const float w = expf(ps[0] - mx);
      l += w * ps[1];
      o += w * ps[2 + c];
    }
    out[bh * d + c] = repro_from_f32<T>(o / fmaxf(l, 1e-30f));
  }
}

template <typename T>
size_t smem_bytes(int bs, int d) {
  return 2 * (size_t)bs * (d * sizeof(T) + 16) + sizeof(float) * ((size_t)d + bs + 32);
}

template <typename T>
int launch(const void* q, const void* kb, const void* vb, const void* ids, const void* pos,
           void* part, void* out, long long bh, int nb, int bs, int kk, int d, int chunk,
           int splits, int group, float scale, cudaStream_t stream) {
  if (d % (16 / (int)sizeof(T))) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(bs, d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sparse_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sparse_partial<T><<<(unsigned int)(bh * splits), THREADS, smem, stream>>>(
      (const T*)q, (const T*)kb, (const T*)vb, (const int*)ids, (const int*)pos,
      (float*)part, nb, bs, kk, d, chunk, splits, group, scale);
  REPRO_LAUNCH_CHECK();
  sparse_combine<T><<<(unsigned int)bh, THREADS, 0, stream>>>((const float*)part, (T*)out,
                                                              splits, d);
  REPRO_LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// q: (bh, d); k_blocks, v_blocks: (bh / group, nb, bs, d), 16-byte aligned;
// ids: (bh, kk) int32; pos: one int32 in device memory; part: float32
// workspace of bh * splits * (d + 2); out: (bh, d).  The ids of a row are
// cut into `splits` chunks of `chunk` (the last may be shorter, none
// empty).  group >= 1 divides bh: query row r reads kv row r / group.
// dtype: REPRO_F32 or REPRO_BF16 for q, k, v and out alike.  d
// must divide 128 and be a multiple of 16 bytes' worth of elements (the
// wrapper checks).  Returns 0 or the CUDA error of the launches.
int repro_mqr_sparse_attention(const void* q, const void* k_blocks, const void* v_blocks,
                               const void* ids, const void* pos, void* part, void* out,
                               long long bh, int nb, int bs, int kk, int d, int chunk,
                               int splits, int group, int dtype, float scale, void* stream) {
  if (bh == 0) return 0;
  if (d <= 0 || THREADS % d || nb <= 0 || bs <= 0 || kk <= 0 || chunk <= 0 ||
      splits <= 0 || (long long)(splits - 1) * chunk >= kk || group <= 0 || bh % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_F32)
    return launch<float>(q, k_blocks, v_blocks, ids, pos, part, out, bh, nb, bs, kk, d, chunk,
                         splits, group, scale, s);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k_blocks, v_blocks, ids, pos, part, out, bh, nb, bs, kk,
                                 d, chunk, splits, group, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
