// The cached row minimum of K1 and K3 (merge_update_argmin.cu,
// merge_update_argmin_batched.cu) as one comparable key.
//
// A row's minimum in ic::take's (d, max birth, min birth) order is kept as
// a 64-bit key (d mapped to an order-preserving code with -0 onto +0,
// which `==` finds equal, then the max birth as an order-preserving 32-bit
// code) and the min birth's code. Births keep all 32 bits. No key
// (kNoKey, kNoLo) is above every pair's.

#pragma once

#include "lexmin.cuh"

namespace ic {

using u64 = unsigned long long;  // the __ldcg overloads name this type

constexpr int kNone = -1;  // the column of a row with no feasible pair
constexpr u64 kNoKey = ~0ull;
constexpr uint32_t kNoLo = ~0u;
constexpr uint32_t kFull = 0xffffffffu;

// order-preserving codes: a key compares as an unsigned integer
static __device__ __forceinline__ uint32_t dcode(float d) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
static __device__ __forceinline__ float dvalue(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
static __device__ __forceinline__ uint32_t bcode(int32_t b) {
  return static_cast<uint32_t>(b) ^ 0x80000000u;
}
static __device__ __forceinline__ int32_t bvalue(uint32_t u) {
  return static_cast<int32_t>(u ^ 0x80000000u);
}

struct Key {
  u64 k;        // dcode << 32 | bcode(max birth)
  uint32_t lo;  // bcode(min birth)
};

static __device__ __forceinline__ Key no_key() { return Key{kNoKey, kNoLo}; }

static __device__ __forceinline__ bool less(const Key& a, const Key& b) {
  return a.k < b.k || (a.k == b.k && a.lo < b.lo);
}

// The key of the pair (d, births b1 and b2).
static __device__ __forceinline__ Key pair_key(float d, int32_t b1, int32_t b2) {
  return Key{(static_cast<u64>(dcode(d)) << 32) | bcode(max(b1, b2)), bcode(min(b1, b2))};
}

// ic::take's Best as a key; the identity (no pair taken) as no_key.
static __device__ __forceinline__ Key to_key(const Best& b, int col) {
  if (col == kNone) return no_key();
  return Key{(static_cast<u64>(dcode(b.d)) << 32) | bcode(b.hi), bcode(b.lo)};
}

// ic::take, remembering the column of the pair taken.
static __device__ __forceinline__ void take_at(Best& b, int& col, float d, int32_t hi, int32_t lo,
                                               int c) {
  if (d < b.d || (d == b.d && (hi < b.hi || (hi == b.hi && lo < b.lo)))) {
    b = Best{d, hi, lo};
    col = c;
  }
}

// Warp minimum of (key, a, b), in every lane; among equal keys, the lowest
// lane's (a, b).
static __device__ __forceinline__ void warp_min(Key& key, int& a, int& b) {
  const uint32_t w0 = static_cast<uint32_t>(key.k >> 32);
  const uint32_t w1 = static_cast<uint32_t>(key.k);
  const uint32_t m0 = __reduce_min_sync(kFull, w0);
  const uint32_t m1 = __reduce_min_sync(kFull, w0 == m0 ? w1 : kFull);
  const bool top = w0 == m0 && w1 == m1;
  const uint32_t m2 = __reduce_min_sync(kFull, top ? key.lo : kNoLo);
  const uint32_t won = __ballot_sync(kFull, top && key.lo == m2);
  const int src = __ffs(won) - 1;
  a = __shfl_sync(kFull, a, src);
  b = __shfl_sync(kFull, b, src);
  key = Key{(static_cast<u64>(m0) << 32) | m1, m2};
}

}  // namespace ic
