// Fused constrained-Ward merge step for Hopper (sm_90a).
//
// Replaces imageclust_tpu/ops/pallas_kernels.py:merge_update_argmin (kernel
// body _merge_step_kernel). One call:
//   1. applies the PENDING row/column update of slot `sa` to the n x n Ward
//      matrix D in place when *do_update != 0: D[sa, :] = dvec and
//      D[:, sa] = dvec (the row write wins at D[sa, sa], as in the Pallas
//      body);
//   2. reduces the next feasible pair: the minimum of D[r, c] over pairs with
//      active[r] > 0, active[c] > 0, r != c and sizes[r] + sizes[c] <=
//      max_size, ties broken by the lexicographically smallest
//      (max(births[r], births[c]), min(births[r], births[c])) -- the Go scan
//      order of the reference engine.
// Outputs (dmin f32, bhi i32, blo i32); (+inf, INT32_MAX, INT32_MAX) when no
// pair is feasible.
//
// What bounds it on this card: device-memory bytes. Each merge reads the
// active rows of D once (n^2 * 4 bytes when every slot is active: 64 MiB at
// n = 4096, more than the 50 MB L2, so the main path streams from HBM; at
// n <= 2048 the 16 MiB matrix can stay L2-resident across merges) and writes
// O(n) elements. There is no arithmetic on D: only `<` / `==` compares and
// selects, so results are bit-identical to the plain PyTorch twin.
//
// Design, for the card rather than the TPU's 128-row VMEM stripes (which
// would give 32 blocks for 132 SMs at n = 4096):
//   * Kernel A (merge_step_rows): one 256-thread block per 8 rows, so n / 8
//     blocks (512 at n = 4096). The block walks its rows together, column
//     group by column group: each thread loads one float4 of each of the 8
//     rows (8 independent 16-byte loads in flight per thread, neighbouring
//     threads on neighbouring addresses) plus the column metadata (births,
//     sizes, active) for those 4 columns once for all 8 rows.
//   * The update is applied IN PLACE and only where D changes: row sa in
//     full, and one element per other row (column sa). The Pallas kernel
//     rewrites every stripe because its output is an aliased block; here the
//     full-matrix write is saved. The new values are substituted in
//     registers, so the reduction never re-reads what it wrote.
//   * Rows whose slot is inactive contribute no candidate pair, so their D
//     values are never read (they still receive the column-sa write). The
//     merge loop deactivates one slot per merge, so the bytes read per merge
//     fall as the job proceeds.
//   * Each block reduces to one partial (dmin, bhi, blo) with warp shuffles
//     and then shared memory. Kernel B (reduce_partials), one block, reduces
//     the partials into the 3-element device output. Nothing synchronises
//     with the host; both kernels launch on the caller's stream and allocate
//     nothing (the wrapper passes outputs and scratch).
//
// Built with -fmad=false like every kernel of the port, although this one
// does no floating-point arithmetic at all.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 8;
constexpr int32_t kBig = 2147483647;

struct Best {
  float d;
  int32_t hi;
  int32_t lo;
};

__device__ __forceinline__ Best identity() { return Best{CUDART_INF_F, kBig, kBig}; }

// Lexicographic (d, hi, lo) order with `<` and `==` only: NaN never wins.
__device__ __forceinline__ void take(Best& b, float d, int32_t hi, int32_t lo) {
  if (d < b.d || (d == b.d && (hi < b.hi || (hi == b.hi && lo < b.lo)))) {
    b.d = d;
    b.hi = hi;
    b.lo = lo;
  }
}

__device__ __forceinline__ Best warp_reduce(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float d = __shfl_xor_sync(0xffffffffu, b.d, off);
    const int32_t hi = __shfl_xor_sync(0xffffffffu, b.hi, off);
    const int32_t lo = __shfl_xor_sync(0xffffffffu, b.lo, off);
    take(b, d, hi, lo);
  }
  return b;
}

// Block-wide lexicographic min; the result is valid in thread 0.
__device__ __forceinline__ Best block_reduce(Best b) {
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

__device__ __forceinline__ void consider(Best& best, float v, int32_t r, int32_t c,
                                         int32_t b_r, int32_t s_r, int32_t b_c,
                                         int32_t s_c, int32_t a_c, int max_size) {
  if (a_c > 0 && r != c && s_r + s_c <= max_size) {
    take(best, v, max(b_r, b_c), min(b_r, b_c));
  }
}

__global__ void __launch_bounds__(kThreads)
merge_step_rows(float* __restrict__ D, const float* __restrict__ dvec,
                const int32_t* __restrict__ births, const int32_t* __restrict__ sizes,
                const int32_t* __restrict__ active, const int32_t* __restrict__ sa_ptr,
                const int32_t* __restrict__ do_ptr, int n, int max_size,
                float* __restrict__ part_d, int32_t* __restrict__ part_hi,
                int32_t* __restrict__ part_lo) {
  const int sa = *sa_ptr;
  const bool upd = *do_ptr != 0;
  const int row0 = blockIdx.x * kRowsPerBlock;

  int32_t b_r[kRowsPerBlock], s_r[kRowsPerBlock], a_r[kRowsPerBlock];
  float dv_r[kRowsPerBlock];
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    const int r = row0 + i;  // n % 128 == 0, so every row of the block exists
    b_r[i] = births[r];
    s_r[i] = sizes[r];
    a_r[i] = active[r];
    dv_r[i] = dvec[r];
  }

  Best best = identity();
  const int groups = n >> 2;  // float4 column groups
  const int sa_group = sa >> 2;
  const int sa_lane = sa & 3;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const int c0 = g << 2;
    float4 v[kRowsPerBlock];
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i) {
      const int r = row0 + i;
      if (upd && r == sa) {
        v[i] = reinterpret_cast<const float4*>(dvec)[g];
      } else if (a_r[i] > 0) {
        v[i] = reinterpret_cast<const float4*>(D + static_cast<size_t>(r) * n)[g];
      } else {
        v[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // never a candidate, never stored
      }
    }
    const int4 bc = reinterpret_cast<const int4*>(births)[g];
    const int4 sc = reinterpret_cast<const int4*>(sizes)[g];
    const int4 ac = reinterpret_cast<const int4*>(active)[g];
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i) {
      const int r = row0 + i;
      float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      if (upd && r == sa) {
        reinterpret_cast<float4*>(D + static_cast<size_t>(r) * n)[g] = v[i];
      } else if (upd && g == sa_group) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // constant indices keep x in registers
          if (k == sa_lane) x[k] = dv_r[i];
        }
        D[static_cast<size_t>(r) * n + sa] = dv_r[i];
      }
      if (a_r[i] <= 0) continue;
      consider(best, x[0], r, c0 + 0, b_r[i], s_r[i], bc.x, sc.x, ac.x, max_size);
      consider(best, x[1], r, c0 + 1, b_r[i], s_r[i], bc.y, sc.y, ac.y, max_size);
      consider(best, x[2], r, c0 + 2, b_r[i], s_r[i], bc.z, sc.z, ac.z, max_size);
      consider(best, x[3], r, c0 + 3, b_r[i], s_r[i], bc.w, sc.w, ac.w, max_size);
    }
  }

  best = block_reduce(best);
  if (threadIdx.x == 0) {
    part_d[blockIdx.x] = best.d;
    part_hi[blockIdx.x] = best.hi;
    part_lo[blockIdx.x] = best.lo;
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part_d, const int32_t* __restrict__ part_hi,
                const int32_t* __restrict__ part_lo, int m, float* __restrict__ out_d,
                int32_t* __restrict__ out_pair) {
  Best best = identity();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    take(best, part_d[i], part_hi[i], part_lo[i]);
  }
  best = block_reduce(best);
  if (threadIdx.x == 0) {
    *out_d = best.d;
    out_pair[0] = best.hi;
    out_pair[1] = best.lo;
  }
}

}  // namespace

extern "C" {

// Rows of D per block of kernel A; the caller sizes the partials to n / this.
int ic_merge_rows_per_block() { return kRowsPerBlock; }

const char* ic_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All pointers are device pointers; `sa` and `do_update` point to one int32
// each, so the merge loop never reads them on the host. Returns the
// cudaError_t of the launches (0 on success).
int ic_merge_update_argmin(void* D, const void* dvec, const void* births,
                           const void* sizes, const void* active, const void* sa,
                           const void* do_update, int n, int max_size, void* part_d,
                           void* part_hi, void* part_lo, void* out_d, void* out_pair,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n / kRowsPerBlock;
  merge_step_rows<<<blocks, kThreads, 0, s>>>(
      static_cast<float*>(D), static_cast<const float*>(dvec),
      static_cast<const int32_t*>(births), static_cast<const int32_t*>(sizes),
      static_cast<const int32_t*>(active), static_cast<const int32_t*>(sa),
      static_cast<const int32_t*>(do_update), n, max_size, static_cast<float*>(part_d),
      static_cast<int32_t*>(part_hi), static_cast<int32_t*>(part_lo));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int32_t*>(part_hi),
      static_cast<const int32_t*>(part_lo), blocks, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_pair));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
