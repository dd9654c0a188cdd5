// Batched fused constrained-Ward merge step for Hopper (sm_90a).
//
// Replaces imageclust_tpu/ops/pallas_kernels.py:merge_update_argmin_batched
// (kernel body _merge_step_kernel_batched, per-bucket reduce at :342-350).
// One call works on a chunk of C buckets, each with its own (B, B) Ward
// matrix D[c] and its own pending update (sa[c], do_update[c]):
//   1. when do_update[c] != 0, applies the pending row/column update of slot
//      sa[c] to D[c] in place: D[c, sa, :] = dvec[c] and D[c, :, sa] =
//      dvec[c] (the row write wins at [sa, sa]);
//   2. reduces bucket c's next feasible pair: the minimum of D[c, r, s] over
//      pairs with active > 0 on both sides, r != s, sizes[r] + sizes[s] <=
//      max_size and, when absorb_min > 0, sizes[r] < absorb_min or sizes[s]
//      < absorb_min (the absorb phase), ties broken by the lexicographically
//      smallest (max birth, min birth).
// Outputs per bucket (dmin f32, bhi i32, blo i32); (+inf, INT32_MAX,
// INT32_MAX) when no pair is feasible.
//
// What bounds it on this card: device-memory bytes. Each call reads the
// active rows of every bucket matrix once (a 100k-image job's one chunk is
// 261 buckets of 512 x 512 f32, 274 MB, well above the 50 MB L2) and writes
// one row and one column per bucket. There is no arithmetic on D, only
// compares and selects, so results are bit-identical to the plain twin.
//
// Design: K1's (csrc/merge_update_argmin.cu) with a bucket axis in the grid.
//   * Kernel A (batched_step_rows): grid (ceil(B / 8), C), one 256-thread
//     block per 8 rows of one bucket. Each block reads its bucket's (sa, do)
//     from device memory, so the merge loop never synchronises with the host.
//     Columns are walked one float per thread per row (neighbouring threads
//     on neighbouring addresses, 8 independent loads in flight per thread),
//     which takes any B; the column metadata is read once for all 8 rows.
//   * The update is written in place and only where D changes (row sa, and
//     column sa of every row). Rows of inactive slots are never read.
//   * Each block reduces to one partial with warp shuffles and shared
//     memory. Kernel B (reduce_bucket_partials), one block per bucket,
//     reduces the bucket's partials into its (dmin, bhi, blo).

#include "lexmin.cuh"

namespace {

using ic::Best;
using ic::identity;
using ic::take;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(kThreads)
batched_step_rows(float* __restrict__ D, const float* __restrict__ dvec,
                  const int32_t* __restrict__ births, const int32_t* __restrict__ sizes,
                  const int32_t* __restrict__ active, const int32_t* __restrict__ sa_ptr,
                  const int32_t* __restrict__ do_ptr, int B, int max_size, int amin,
                  float* __restrict__ part_d, int32_t* __restrict__ part_hi,
                  int32_t* __restrict__ part_lo) {
  const int c = blockIdx.y;
  const size_t base = static_cast<size_t>(c) * B;
  float* Dc = D + base * B;
  const float* dv = dvec + base;
  const int32_t* bc = births + base;
  const int32_t* sc = sizes + base;
  const int32_t* ac = active + base;
  const int sa = sa_ptr[c];
  const bool upd = do_ptr[c] != 0;
  const int row0 = blockIdx.x * kRowsPerBlock;

  int32_t b_r[kRowsPerBlock], s_r[kRowsPerBlock], a_r[kRowsPerBlock];
  float dv_r[kRowsPerBlock];
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    const int r = row0 + i;
    const bool in = r < B;
    b_r[i] = in ? bc[r] : 0;
    s_r[i] = in ? sc[r] : 0;
    a_r[i] = in ? ac[r] : 0;
    dv_r[i] = in ? dv[r] : 0.f;
  }

  Best best = identity();
  for (int col = threadIdx.x; col < B; col += kThreads) {
    float v[kRowsPerBlock];
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i) {
      const int r = row0 + i;
      if (r >= B) {
        v[i] = 0.f;
      } else if (upd && r == sa) {
        v[i] = dv[col];
      } else if (upd && col == sa) {
        v[i] = dv_r[i];
      } else if (a_r[i] > 0) {
        v[i] = Dc[static_cast<size_t>(r) * B + col];
      } else {
        v[i] = 0.f;  // never a candidate, never stored
      }
    }
    const int32_t b_c = bc[col];
    const int32_t s_c = sc[col];
    const int32_t a_c = ac[col];
    const bool under_c = s_c < amin;
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i) {
      const int r = row0 + i;
      if (r >= B) continue;
      if (upd && (r == sa || col == sa)) {
        Dc[static_cast<size_t>(r) * B + col] = v[i];
      }
      if (a_r[i] <= 0 || a_c <= 0 || r == col || s_r[i] + s_c > max_size) continue;
      if (amin > 0 && !(s_r[i] < amin || under_c)) continue;
      take(best, v[i], max(b_r[i], b_c), min(b_r[i], b_c));
    }
  }

  best = ic::block_reduce<kWarps>(best);
  if (threadIdx.x == 0) {
    const size_t p = static_cast<size_t>(c) * gridDim.x + blockIdx.x;
    part_d[p] = best.d;
    part_hi[p] = best.hi;
    part_lo[p] = best.lo;
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_bucket_partials(const float* __restrict__ part_d, const int32_t* __restrict__ part_hi,
                       const int32_t* __restrict__ part_lo, int m, float* __restrict__ out_d,
                       int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo) {
  const int c = blockIdx.x;
  const size_t base = static_cast<size_t>(c) * m;
  Best best = identity();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    take(best, part_d[base + i], part_hi[base + i], part_lo[base + i]);
  }
  best = ic::block_reduce<kWarps>(best);
  if (threadIdx.x == 0) {
    out_d[c] = best.d;
    out_hi[c] = best.hi;
    out_lo[c] = best.lo;
  }
}

}  // namespace

extern "C" {

// Rows of one bucket per block of kernel A; the caller sizes the partials
// to C * ceil(B / this).
int ic_batched_rows_per_block() { return kRowsPerBlock; }

// All pointers are device pointers. D is (C, B, B) f32; dvec (C, B) f32;
// births, sizes, active (C, B) int32; sa and do_update (C,) int32. Returns
// the cudaError_t of the launches (0 on success).
int ic_merge_update_argmin_batched(void* D, const void* dvec, const void* births,
                                   const void* sizes, const void* active, const void* sa,
                                   const void* do_update, int C, int B, int max_size,
                                   int absorb_min, void* part_d, void* part_hi,
                                   void* part_lo, void* out_d, void* out_hi, void* out_lo,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  batched_step_rows<<<dim3(m, C), kThreads, 0, s>>>(
      static_cast<float*>(D), static_cast<const float*>(dvec),
      static_cast<const int32_t*>(births), static_cast<const int32_t*>(sizes),
      static_cast<const int32_t*>(active), static_cast<const int32_t*>(sa),
      static_cast<const int32_t*>(do_update), B, max_size, absorb_min,
      static_cast<float*>(part_d), static_cast<int32_t*>(part_hi),
      static_cast<int32_t*>(part_lo));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_bucket_partials<<<C, kThreads, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int32_t*>(part_hi),
      static_cast<const int32_t*>(part_lo), m, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
