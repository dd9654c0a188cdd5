// Whole per-bucket Lance-Williams merge loop for Hopper (sm_90a).
//
// Replaces imageclust_tpu/ops/pallas_kernels.py:merge_loop_whole (kernel
// body _whole_loop_kernel, :354-487). One block runs one bucket's complete
// constrained-Ward merge loop, the TPU grid step's work:
//   * main phase: at most B - 1 trips, each while the last trip found a pair
//     and num_active > target;
//   * absorb phase (absorb_min > 0 only): `found` is reset to 1, then at most
//     B - 1 trips while the last trip found a pair and an active cluster is
//     under absorb_min; only pairs with an under-min side are feasible.
// Each trip takes the feasible pair with the smallest Ward distance (ties:
// smallest (max birth, min birth), the Go scan order), merges it with the
// Lance-Williams recurrence, writes its log row (bhi, blo, new birth) and
// updates sizes, births and active. Outputs: log (C, B - 1, 3), step (C,),
// births, sizes, active (C, B), all int32.
//
// The TPU kernel keeps the (B, B) matrix in VMEM. A block here has at most
// 227 KB of shared memory and the default bucket (B = 512) is 1 MiB of f32,
// so the matrix stays in DEVICE memory: it is the caller's (C, B, B)
// temporary, updated in place (row and column sa per merge). births, sizes
// and active (3 * B * 4 bytes, dynamic shared memory) and the loop scalars
// live in shared memory. Each trip:
//   1. scan: warp w takes rows w, w + 32, ... of active slots; its lanes walk
//      the columns with 4 coalesced loads in flight each, and keep the
//      lexicographic (d, bhi, blo) minimum over feasible pairs (the masks of
//      pallas_kernels.py:412-416);
//   2. a warp-shuffle then block reduction gives the trip's pair; `found` is
//      whether its distance is finite;
//   3. sa and sb are the lowest slots whose birth is m1 and m2;
//   4. every thread computes dvec for its slots with the expression tree of
//      pallas_kernels.py:440-443, ((s_a + sz) * d_a + (s_b + sz) * d_b -
//      sz * d_ab) / (s_new + sz), each operation rounded once (the library
//      is built with -fmad=false, IEEE division and no flush to zero), then
//      writes column and row sa;
//   5. thread 0 updates sizes, births, active and the log row.
// __syncthreads() separates the phases. Like the Pallas body, the whole
// B x B mask is scanned (no triangle): D from a Gram product need not be
// bit-symmetric.
//
// What bounds it on this card: the scans. A trip reads active rows x B
// floats (L2 or device memory) and evaluates the masks for each; there is
// no matrix arithmetic. One block per bucket leaves the chunk's parallelism
// at C blocks of 1024 threads. Making it fast (a thread-block cluster holding
// the matrix in distributed shared memory, or an L2-aware schedule) is later
// work; this version is the simple, exact one.

#include "lexmin.cuh"

namespace {

using ic::Best;
using ic::identity;
using ic::kBig;
using ic::take;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 4096;                    // 48 KB of shared state
constexpr int kPerThread = kMaxB / kThreads;   // dvec slots per thread
constexpr int kUnroll = 4;                     // loads in flight per lane

struct LoopState {
  Best best;
  int32_t counter;     // next birth stamp
  int32_t num_active;
  int32_t step;        // merges performed
  int32_t found;
  int32_t sa;
  int32_t sb;
};

// One trip: find the pair; if there is one, merge it. Every thread of the
// block calls it.
__device__ __forceinline__ void merge_once(float* __restrict__ Dc, const int B,
                                           const int max_size, const int amin,
                                           const bool use_amin, int32_t* births,
                                           int32_t* sizes, int32_t* active,
                                           int32_t* __restrict__ logc, LoopState& st) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  Best best = identity();
  for (int r = warp; r < B; r += kWarps) {
    if (active[r] <= 0) continue;
    const int32_t b_r = births[r];
    const int32_t s_r = sizes[r];
    const bool under_r = s_r < amin;
    const float* row = Dc + static_cast<size_t>(r) * B;
    for (int c0 = lane; c0 < B; c0 += 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        v[u] = c < B ? row[c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c >= B || c == r || active[c] <= 0) continue;
        const int32_t s_c = sizes[c];
        if (s_r + s_c > max_size) continue;
        if (use_amin && !(under_r || s_c < amin)) continue;
        const int32_t b_c = births[c];
        take(best, v[u], max(b_r, b_c), min(b_r, b_c));
      }
    }
  }
  best = ic::block_reduce<kWarps>(best);
  if (tid == 0) {
    st.best = best;
    st.found = isfinite(best.d) ? 1 : 0;
    st.sa = kBig;
    st.sb = kBig;
  }
  __syncthreads();
  if (!st.found) return;

  const int32_t m1 = st.best.hi;
  const int32_t m2 = st.best.lo;
  for (int j = tid; j < B; j += kThreads) {
    const int32_t b = births[j];
    if (b == m1) atomicMin(&st.sa, j);
    if (b == m2) atomicMin(&st.sb, j);
  }
  __syncthreads();

  const int sa = st.sa;
  const int sb = st.sb;
  const int32_t s_a = sizes[sa];
  const int32_t s_b = sizes[sb];
  const float sa_f = static_cast<float>(s_a);
  const float sb_f = static_cast<float>(s_b);
  const float sn_f = static_cast<float>(s_a + s_b);
  const float* row_a = Dc + static_cast<size_t>(sa) * B;
  const float* row_b = Dc + static_cast<size_t>(sb) * B;
  const float d_ab = row_a[sb];
  float dv[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = tid + k * kThreads;
    dv[k] = 0.f;
    if (j < B && j != sa) {
      const float sz = static_cast<float>(sizes[j]);
      const float t_a = (sa_f + sz) * row_a[j];
      const float t_b = (sb_f + sz) * row_b[j];
      const float t_ab = sz * d_ab;
      dv[k] = ((t_a + t_b) - t_ab) / (sn_f + sz);
    }
  }
  __syncthreads();  // rows sa and sb are read before either is written

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = tid + k * kThreads;
    if (j < B) {
      Dc[static_cast<size_t>(j) * B + sa] = dv[k];  // column, then row
      Dc[static_cast<size_t>(sa) * B + j] = dv[k];
    }
  }
  if (tid == 0) {
    sizes[sa] = s_a + s_b;
    sizes[sb] = 0;
    births[sa] = st.counter;
    active[sb] = 0;
    int32_t* row = logc + static_cast<size_t>(st.step) * 3;
    row[0] = m1;
    row[1] = m2;
    row[2] = st.counter;
    st.counter += 1;
    st.num_active -= 1;
    st.step += 1;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
merge_loop_whole_kernel(float* __restrict__ D, const int32_t* __restrict__ counts,
                        const int32_t* __restrict__ targets, int B, int max_size, int amin,
                        int32_t* __restrict__ log, int32_t* __restrict__ step_out,
                        int32_t* __restrict__ births_out, int32_t* __restrict__ sizes_out,
                        int32_t* __restrict__ active_out) {
  extern __shared__ int32_t state[];
  int32_t* births = state;
  int32_t* sizes = state + B;
  int32_t* active = state + 2 * B;
  __shared__ LoopState st;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int cnt = counts[c];
  const int tgt = targets[c];
  const int n_log = B - 1;
  float* Dc = D + static_cast<size_t>(c) * B * B;
  int32_t* logc = log + static_cast<size_t>(c) * n_log * 3;

  for (int j = tid; j < B; j += kThreads) {
    const bool a = j < cnt;
    births[j] = a ? j : kBig - B + j;
    sizes[j] = a ? 1 : 0;
    active[j] = a ? 1 : 0;
  }
  for (int j = tid; j < n_log * 3; j += kThreads) logc[j] = 0;
  if (tid == 0) {
    st.counter = cnt;
    st.num_active = cnt;
    st.step = 0;
    st.found = 1;
  }
  __syncthreads();

  for (int trip = 0; trip < B - 1; ++trip) {
    if (!(st.found && st.num_active > tgt)) break;  // uniform: read after a barrier
    merge_once(Dc, B, max_size, amin, false, births, sizes, active, logc, st);
  }
  __syncthreads();  // every thread has left the loop before `found` changes

  if (amin > 0) {
    if (tid == 0) st.found = 1;
    __syncthreads();
    for (int trip = 0; trip < B - 1; ++trip) {
      int under = 0;
      for (int j = tid; j < B; j += kThreads) {
        under |= (active[j] > 0 && sizes[j] < amin) ? 1 : 0;
      }
      const int has_under = __syncthreads_or(under);
      if (!(st.found && has_under)) break;
      merge_once(Dc, B, max_size, amin, true, births, sizes, active, logc, st);
    }
    __syncthreads();
  }

  const size_t base = static_cast<size_t>(c) * B;
  for (int j = tid; j < B; j += kThreads) {
    births_out[base + j] = births[j];
    sizes_out[base + j] = sizes[j];
    active_out[base + j] = active[j];
  }
  if (tid == 0) step_out[c] = st.step;
}

}  // namespace

extern "C" {

// Largest bucket width the kernel takes (its shared state is 12 * B bytes).
int ic_merge_loop_whole_max_b() { return kMaxB; }

// All pointers are device pointers. D is (C, B, B) f32, updated in place;
// counts and targets (C,) int32; log (C, B - 1, 3), step (C,), births,
// sizes, active (C, B) int32 outputs. 2 <= B <= kMaxB. Returns the
// cudaError_t of the launch (0 on success).
int ic_merge_loop_whole(void* D, const void* counts, const void* targets, int C, int B,
                        int max_size, int absorb_min, void* log, void* step, void* births,
                        void* sizes, void* active, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 3 * B * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      merge_loop_whole_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_loop_whole_kernel<<<C, kThreads, smem, s>>>(
      static_cast<float*>(D), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(targets), B, max_size, absorb_min,
      static_cast<int32_t*>(log), static_cast<int32_t*>(step),
      static_cast<int32_t*>(births), static_cast<int32_t*>(sizes),
      static_cast<int32_t*>(active));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
