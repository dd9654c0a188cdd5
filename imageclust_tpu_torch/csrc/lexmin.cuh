// Lexicographic (d, bhi, blo) minimum shared by the port's merge kernels.
//
// The feasible-pair argmin of every merge loop picks the smallest distance,
// ties broken by the smallest (max birth, min birth): the Go scan order of
// the reference engine. Only `<` and `==` are used, so a NaN never wins and
// results are bit-identical to the plain PyTorch twins' amin/where reduce.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ic {

constexpr int32_t kBig = 2147483647;

struct Best {
  float d;
  int32_t hi;
  int32_t lo;
};

static __device__ __forceinline__ Best identity() { return Best{CUDART_INF_F, kBig, kBig}; }

static __device__ __forceinline__ void take(Best& b, float d, int32_t hi, int32_t lo) {
  if (d < b.d || (d == b.d && (hi < b.hi || (hi == b.hi && lo < b.lo)))) {
    b.d = d;
    b.hi = hi;
    b.lo = lo;
  }
}

static __device__ __forceinline__ Best warp_reduce(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float d = __shfl_xor_sync(0xffffffffu, b.d, off);
    const int32_t hi = __shfl_xor_sync(0xffffffffu, b.hi, off);
    const int32_t lo = __shfl_xor_sync(0xffffffffu, b.lo, off);
    take(b, d, hi, lo);
  }
  return b;
}

// Block-wide minimum of a block of kWarps warps; the result is valid in
// thread 0. Contains one __syncthreads(); a caller that reduces again must
// pass another barrier first, so warp 0 has read the staging arrays.
template <int kWarps>
static __device__ __forceinline__ Best block_reduce(Best b) {
  __shared__ float s_d[kWarps];
  __shared__ int32_t s_hi[kWarps];
  __shared__ int32_t s_lo[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  b = warp_reduce(b);
  if (lane == 0) {
    s_d[warp] = b.d;
    s_hi[warp] = b.hi;
    s_lo[warp] = b.lo;
  }
  __syncthreads();
  if (warp == 0) {
    Best c = identity();
    if (lane < kWarps) {
      c.d = s_d[lane];
      c.hi = s_hi[lane];
      c.lo = s_lo[lane];
    }
    b = warp_reduce(c);
  }
  return b;
}

}  // namespace ic
