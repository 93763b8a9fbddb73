// Tile loads and mask stores shared by the sweep kernels (level_sweep.cu:
// #1-#3; pair_sweep.cu: #6): 16-byte loads of rows at any alignment,
// widening of narrow tile values, and 16-slot mask windows written as one
// aligned 16-byte store or, at a row's ends, as a few aligned smaller ones.
#pragma once

#include "common.cuh"

namespace {

// Compare type of a tile value: float32 tiles compare as float, grid-cell
// tiles (uint16, uint8) widened to int32.
template <typename T> struct QueryOf { using type = float; };
template <> struct QueryOf<uint16_t> { using type = int32_t; };
template <> struct QueryOf<uint8_t> { using type = int32_t; };

__device__ __forceinline__ float lowest(float) { return -__int_as_float(0x7f800000); }
__device__ __forceinline__ float highest(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ int32_t lowest(int32_t) { return INT32_MIN; }
__device__ __forceinline__ int32_t highest(int32_t) { return INT32_MAX; }
__device__ __forceinline__ float lo_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float hi_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int32_t lo_of(int32_t a, int32_t b) { return min(a, b); }
__device__ __forceinline__ int32_t hi_of(int32_t a, int32_t b) { return max(a, b); }

__device__ __forceinline__ float shfl_xor(float v, int d) {
  return __shfl_xor_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ int32_t shfl_xor(int32_t v, int d) {
  return __shfl_xor_sync(0xffffffffu, v, d);
}

__device__ __forceinline__ float4 query_vec(const float* q) {
  return make_float4(q[0], q[1], q[2], q[3]);
}
__device__ __forceinline__ int4 query_vec(const int32_t* q) {
  return make_int4(q[0], q[1], q[2], q[3]);
}

// The 16 bytes at p, any alignment, from one aligned 16-byte load (two
// where p is not aligned and `second` says bytes of the next chunk are
// needed).  Each aligned chunk read holds at least one byte the caller
// needs, so it lies inside the caller's allocation.
__device__ __forceinline__ uint4 load16(const void* p, bool second) {
  const uintptr_t at = (uintptr_t)p;
  const int sh = (int)(at & 15);
  const uint4* q = reinterpret_cast<const uint4*>(at - sh);
  const uint4 lo = __ldg(q);
  if (sh == 0) return lo;
  const uint4 hi = second ? __ldg(q + 1) : make_uint4(0u, 0u, 0u, 0u);
  const int ws = sh >> 2, bs = (sh & 3) * 8;  // bytes sh .. sh + 15 of lo ++ hi
  const uint32_t w0 = ws == 0 ? lo.x : ws == 1 ? lo.y : ws == 2 ? lo.z : lo.w;
  const uint32_t w1 = ws == 0 ? lo.y : ws == 1 ? lo.z : ws == 2 ? lo.w : hi.x;
  const uint32_t w2 = ws == 0 ? lo.z : ws == 1 ? lo.w : ws == 2 ? hi.x : hi.y;
  const uint32_t w3 = ws == 0 ? lo.w : ws == 1 ? hi.x : ws == 2 ? hi.y : hi.z;
  const uint32_t w4 = ws == 0 ? hi.x : ws == 1 ? hi.y : ws == 2 ? hi.z : hi.w;
  return make_uint4(__funnelshift_r(w0, w1, bs), __funnelshift_r(w1, w2, bs),
                    __funnelshift_r(w2, w3, bs), __funnelshift_r(w3, w4, bs));
}

// Tile value e of 16 loaded bytes, widened (e a constant after unrolling).
template <typename T>
__device__ __forceinline__ typename QueryOf<T>::type value_of(uint4 u, int e) {
  const int byte = e * (int)sizeof(T);
  const uint32_t w = byte < 4 ? u.x : byte < 8 ? u.y : byte < 12 ? u.z : u.w;
  if (sizeof(T) == 4) return (typename QueryOf<T>::type)__uint_as_float(w);
  const uint32_t v = (w >> (8 * (byte & 3))) & (sizeof(T) == 2 ? 0xffffu : 0xffu);
  return (typename QueryOf<T>::type)v;
}

// Parent slots of one 16-byte load, widened to int32 in shared memory.
__device__ __forceinline__ void stage_parents(uint4 u, int32_t* dst, int32_t) {
  *reinterpret_cast<int4*>(dst) = make_int4((int)u.x, (int)u.y, (int)u.z, (int)u.w);
}
__device__ __forceinline__ void stage_parents(uint4 u, int32_t* dst, uint16_t) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<int4*>(dst + 4 * i) =
        make_int4((int)(w[2 * i] & 0xffffu), (int)(w[2 * i] >> 16),
                  (int)(w[2 * i + 1] & 0xffffu), (int)(w[2 * i + 1] >> 16));
}

// 16 mask bits -> 16 bytes of 0 / 1, slot k in byte k.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t m) {
  return ((m & 0xfu) * 0x00204081u) & 0x01010101u;
}
__device__ __forceinline__ uint4 mask_bytes(uint32_t m) {
  return make_uint4(nibble_bytes(m), nibble_bytes(m >> 4), nibble_bytes(m >> 8),
                    nibble_bytes(m >> 12));
}

// Bytes p .. p + 7 of v (0 <= p < 16; past byte 15 they are zero).
__device__ __forceinline__ unsigned long long bytes_from(uint4 v, int p) {
  const unsigned long long lo = ((unsigned long long)v.y << 32) | v.x;
  const unsigned long long hi = ((unsigned long long)v.w << 32) | v.z;
  return p == 0 ? lo : p < 8 ? (lo >> (8 * p)) | (hi << (64 - 8 * p)) : hi >> (8 * (p - 8));
}

// Bytes [p0, p1) of v (0 <= p0 < p1 <= 16, not both 0 and 16) to g + p0,
// g 16-byte aligned.  A row's first bytes end on a 16-byte boundary and its
// last start on one, so each goes out in at most four aligned stores of 1,
// 2, 4 and 8 bytes whose places follow from p0 or p1 alone; a row shorter
// than 16 bytes, byte by byte.
__device__ __forceinline__ void store_bytes(uint8_t* g, uint4 v, int p0, int p1) {
  if (p1 == 16) {  // [p0, 16)
    if (p0 & 1) g[p0] = (uint8_t)bytes_from(v, p0);
    const int p2 = (p0 + 1) & ~1, p4 = (p0 + 3) & ~3, p8 = (p0 + 7) & ~7;
    if ((p2 & 2) && p2 < 16) *reinterpret_cast<uint16_t*>(g + p2) = (uint16_t)bytes_from(v, p2);
    if ((p4 & 4) && p4 < 16) *reinterpret_cast<uint32_t*>(g + p4) = (uint32_t)bytes_from(v, p4);
    if ((p8 & 8) && p8 < 16) *reinterpret_cast<unsigned long long*>(g + p8) = bytes_from(v, p8);
  } else if (p0 == 0) {  // [0, p1)
    if (p1 & 8) *reinterpret_cast<unsigned long long*>(g) = bytes_from(v, 0);
    if (p1 & 4) *reinterpret_cast<uint32_t*>(g + (p1 & 8)) = (uint32_t)bytes_from(v, p1 & 8);
    if (p1 & 2) *reinterpret_cast<uint16_t*>(g + (p1 & 12)) = (uint16_t)bytes_from(v, p1 & 12);
    if (p1 & 1) g[p1 & 14] = (uint8_t)bytes_from(v, p1 & 14);
  } else {
    for (int p = p0; p < p1; ++p) g[p] = (uint8_t)bytes_from(v, p);
  }
}

}  // namespace
