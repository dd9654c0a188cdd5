// Fused nearest-centroid top-k scan for the bucketed engine on Hopper (sm_90a).
//
// Replaces imageclust_tpu/ops/pallas_kernels.py:pref_topk_block (kernel body
// _pref_topk_kernel). For rows x (n, d) and centroids c (k, d) of one
// residency dtype (f32, bf16 or int8), with cn (k,) the f32 squared norms of
// the stored centroids and xx[r] the f32 squared norm of row r (summed here),
// it computes for every row r and every centroid j < k
//   s = max((xx[r] + cn[j]) - 2 * g[r, j], 0)      g = <x_r, c_j>
// and keeps the kk smallest s of each row, ordered lexicographically by
// (s, j): ties go to the lower centroid index, as lax.top_k's stable order
// does. It writes idx (n, kk) int32 and vals (n, kk) f32, ascending. The
// (n, k) score matrix never reaches device memory.
//
// Grams by dtype, each exact where the JAX package's is:
//   bf16: mma.sync m16n8k16, bf16 in, f32 accumulate (a bf16 product is exact
//         in f32; the sum rounds in the tensor core's order);
//   int8: mma.sync m16n8k32, s8 in, s32 accumulate (exact integers), turned
//         into f32 once per tile (the same rounding as JAX's int32 -> f32);
//   f32:  scalar __fmaf_rn register tiles in ascending k (IEEE f32; TF32
//         would not be, and the Pallas body's f32 gram is plain f32).
// The score is formed with explicit round-to-nearest intrinsics, in the
// Pallas body's order, so no contraction changes it.
//
// What bounds it on this card: operations for bf16 and int8 (2 n k d of them;
// at the 2M-row summarize pass with k = 5209, d = 512 that is 10.7 TFLOP,
// 10.8 ms at 989 TFLOP/s, against 2.1 GB of rows read in 0.6 ms), and the f32
// pipe for f32 (159 ms at 67 TFLOP/s).
//
// Design (a simple one that is right; wgmma, TMA and larger row tiles are
// later work):
//   * One 128-thread CTA per 64 rows. It walks the centroids in tiles of 64
//     and each tile's gram in d-slices of 128 bytes (32 f32, 64 bf16, 128
//     int8): the slice of the 64 rows and of the 64 centroids is copied into
//     shared memory by cp.async (16-byte copies when rows are 16-byte
//     multiples, 4-byte ones when 4-byte multiples, else byte by byte), two
//     stages deep, so the next slice lands while this one is multiplied.
//     Rows past n, centroids past k and bytes past d are zero-filled.
//     Shared rows are 144 bytes apart, so ldmatrix hits disjoint banks.
//   * Tensor-core paths: warp w owns rows 16w..16w+15 and all 64 columns
//     (8 n-tiles); A and B fragments by ldmatrix. The int8 fragments have the
//     byte layout of the bf16 ones (a 32-byte k-step either way), so both
//     dtypes share the addressing.
//   * Before the tiles, each warp sums the squared norms of 16 of the rows:
//     lane l adds the squares of elements l, l + 32, ... in f32 (one rounding
//     a term), then a fixed butterfly of shuffles adds the 32 partial sums.
//     That read leaves the CTA's rows in L2 for the first tile's copies, so
//     the rows come from device memory about once, norms included; a norm
//     pass inside the tile loop instead slowed the f32 gram there.
//   * At a tile's last slice the owners of the accumulators form the scores
//     and stage the 64 x 64 tile in shared memory. Two threads per row then
//     scan it, each over 32 of the columns, keeping a sorted list of the
//     kKmax (8 >= kk) smallest (s, j) in registers: a score at or above the
//     list's last is rejected before any insertion work.
//   * After the last tile the two lists of a row merge lexicographically
//     into the row's kk outputs. No atomics: a rerun gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;          // rows of x per CTA
constexpr int kCols = 64;          // centroids per tile
constexpr int kThreads = 128;
constexpr int kSliceBytes = 128;   // bytes of a row per d-slice
constexpr int kLd = kSliceBytes + 16;  // shared row stride in bytes
constexpr int kTileBytes = kRows * kLd;
constexpr int kStageBytes = 2 * kTileBytes;  // the rows' and centroids' slice
constexpr int kScoreLd = kCols + 1;  // floats
constexpr int kKmax = 8;             // the longest kept list (the engine's kk)
constexpr int kSmemBytes =
    2 * kStageBytes + (kRows * kScoreLd + kRows) * static_cast<int>(sizeof(float));

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes [cb, cb + 128) of rows [0, 64) of a row-major source with row_bytes
// bytes a row into a shared tile; rows >= rows_left and bytes >= row_bytes
// are zero. mode: 16 or 4 (cp.async of that many bytes; row_bytes and the
// base are multiples of it), else byte by byte.
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src, long long row_bytes,
                                          int rows_left, int cb, int mode) {
  if (mode == 16) {
    for (int q = threadIdx.x; q < kRows * (kSliceBytes / 16); q += kThreads) {
      const int r = q / (kSliceBytes / 16);
      const int b = (q % (kSliceBytes / 16)) * 16;
      uint8_t* s = dst + r * kLd + b;
      if (r < rows_left && cb + b < row_bytes)
        cp_async16(s, src + static_cast<size_t>(r) * row_bytes + cb + b);
      else
        *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else if (mode == 4) {
    for (int q = threadIdx.x; q < kRows * (kSliceBytes / 4); q += kThreads) {
      const int r = q / (kSliceBytes / 4);
      const int b = (q % (kSliceBytes / 4)) * 4;
      uint8_t* s = dst + r * kLd + b;
      if (r < rows_left && cb + b < row_bytes)
        cp_async4(s, src + static_cast<size_t>(r) * row_bytes + cb + b);
      else
        *reinterpret_cast<uint32_t*>(s) = 0u;
    }
  } else {
    for (int q = threadIdx.x; q < kRows * kSliceBytes; q += kThreads) {
      const int r = q / kSliceBytes;
      const int b = q % kSliceBytes;
      dst[r * kLd + b] = (r < rows_left && cb + b < row_bytes)
                             ? src[static_cast<size_t>(r) * row_bytes + cb + b]
                             : static_cast<uint8_t>(0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators
__device__ __forceinline__ void mma(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// The f32 squared norm of the row x (d elements of type T) from one warp:
// lane l sums elements l, l + 32, ... in order, a fixed butterfly adds the
// lanes. Every lane returns the same bits.
template <typename T>
__device__ __forceinline__ float warp_row_norm(const T* __restrict__ x, int d, int lane) {
  float part = 0.0f;
  for (int e = lane; e < d; e += 32) {
    const float f = to_f32(x[e]);
    part = __fmaf_rn(f, f, part);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  return part;
}

// the Pallas body's score: max((xx + cn) - 2 g, 0), each step rounded once
__device__ __forceinline__ float score(float xr, float cj, float g) {
  return fmaxf(__fsub_rn(__fadd_rn(xr, cj), __fmul_rn(2.0f, g)), 0.0f);
}

// (s, j) lexicographically before (v, x)
__device__ __forceinline__ bool before(float s, int j, float v, int x) {
  return s < v || (s == v && j < x);
}

// One 64-row block against every centroid tile (see the header).
template <int DT>
__global__ void __launch_bounds__(kThreads)
pref_topk_kernel(const uint8_t* __restrict__ rows, const uint8_t* __restrict__ cents,
                 const float* __restrict__ cn, int n, int k, int d, int kk, int mode,
                 int* __restrict__ out_idx, float* __restrict__ out_val) {
  using Acc = typename std::conditional<DT == kI8, int, float>::type;
  using Elem = typename std::conditional<
      DT == kF32, float, typename std::conditional<DT == kBF16, __nv_bfloat16, int8_t>::type>::type;
  constexpr int kEsize = static_cast<int>(sizeof(Elem));
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* S = reinterpret_cast<float*>(smem + 2 * kStageBytes);  // kRows x kScoreLd
  float* xs = S + kRows * kScoreLd;                              // kRows

  const int tid = threadIdx.x;
  const long long row_bytes = static_cast<long long>(d) * kEsize;
  const int row0 = blockIdx.x * kRows;
  const int rows_left = n - row0;
  const uint8_t* a_src = rows + static_cast<size_t>(row0) * row_bytes;
  const int n_dsl = static_cast<int>((row_bytes + kSliceBytes - 1) / kSliceBytes);
  const int n_ct = (k + kCols - 1) / kCols;
  const int total = n_ct * n_dsl;

  load_tile(smem, a_src, row_bytes, rows_left, 0, mode);
  load_tile(smem + kTileBytes, cents, row_bytes, k, 0, mode);
  cp_async_commit();
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the row norms (rows past n read 0); the loop's first barrier publishes them
  constexpr int kWarpRows = kRows / (kThreads / 32);
  for (int r = warp * kWarpRows; r < (warp + 1) * kWarpRows; ++r) {
    const float v = r < rows_left
                        ? warp_row_norm(reinterpret_cast<const Elem*>(a_src) +
                                            static_cast<size_t>(r) * d,
                                        d, lane)
                        : 0.0f;
    if (lane == 0) xs[r] = v;
  }

  // the running list of this thread: row my_r, columns my_h * 32 .. + 31 of
  // every tile, sorted by (value, index); empty slots are (+inf, INT_MAX)
  const int my_r = tid % kRows;
  const int my_h = tid / kRows;
  float lv[kKmax];
  int lx[kKmax];
#pragma unroll
  for (int i = 0; i < kKmax; ++i) {
    lv[i] = INFINITY;
    lx[i] = 0x7fffffff;
  }

  // accumulators: tensor cores [n-tile][4]; scalar [row i][col j]
  constexpr int kA0 = DT == kF32 ? 4 : kCols / 8;
  constexpr int kA1 = DT == kF32 ? 8 : 4;
  Acc acc[kA0][kA1];

  for (int t = 0; t < total; ++t) {
    const int ct = t / n_dsl;
    const int ds = t - ct * n_dsl;
    if (t + 1 < total) {  // prefetch the next slice into the other stage
      const int ct1 = (t + 1) / n_dsl;
      const int cb1 = ((t + 1) - ct1 * n_dsl) * kSliceBytes;
      uint8_t* buf = smem + ((t + 1) & 1) * kStageBytes;
      load_tile(buf, a_src, row_bytes, rows_left, cb1, mode);
      load_tile(buf + kTileBytes, cents + static_cast<size_t>(ct1) * kCols * row_bytes,
                row_bytes, k - ct1 * kCols, cb1, mode);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* As = smem + (t & 1) * kStageBytes;
    const uint8_t* Bs = As + kTileBytes;

    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < kA0; ++i)
#pragma unroll
        for (int j = 0; j < kA1; ++j) acc[i][j] = 0;
    }

    if constexpr (DT == kF32) {
      const float* Af = reinterpret_cast<const float*>(As);
      const float* Bf = reinterpret_cast<const float*>(Bs);
      const int tx = tid % 8;  // columns tx + 8 j
      const int ty = tid / 8;  // rows ty + 16 i
#pragma unroll 4
      for (int q = 0; q < kSliceBytes / 4; ++q) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Af[(ty + 16 * i) * (kLd / 4) + q];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bf[(tx + 8 * j) * (kLd / 4) + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
    } else {
      const int mi = lane / 8;   // the 8x8 matrix this lane addresses
      const int mrow = lane % 8;  // its row in that matrix
#pragma unroll
      for (int kb = 0; kb < kSliceBytes; kb += 32) {  // one 32-byte k-step
        uint32_t a[4];  // (rows +0, k +0), (+8, +0), (+0, +16 B), (+8, +16 B)
        ldmatrix_x4(a, As + (warp * 16 + mrow + (mi % 2) * 8) * kLd + kb + (mi / 2) * 16);
#pragma unroll
        for (int jt = 0; jt < kCols / 16; ++jt) {
          uint32_t b[4];  // cols +0 (k +0, +16 B), cols +8 (k +0, +16 B)
          ldmatrix_x4(b, Bs + (jt * 16 + mrow + (mi / 2) * 8) * kLd + kb + (mi % 2) * 16);
          mma(acc[2 * jt], a, b[0], b[1]);
          mma(acc[2 * jt + 1], a, b[2], b[3]);
        }
      }
    }

    if (ds == n_dsl - 1) {
      // the tile's scores into shared memory (columns >= k read +inf)
      const int j0 = ct * kCols;
      if constexpr (DT == kF32) {
        const int tx = tid % 8;
        const int ty = tid / 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tx + 8 * j;
          const float cj = j0 + col < k ? __ldg(cn + j0 + col) : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = ty + 16 * i;
            S[row * kScoreLd + col] =
                j0 + col < k ? score(xs[row], cj, acc[i][j]) : INFINITY;
          }
        }
      } else {
        const int g = lane / 4;
        const int tq = lane % 4;
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * 8 + 2 * tq + e;
            const float cj = j0 + col < k ? __ldg(cn + j0 + col) : 0.0f;
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int row = warp * 16 + g + 8 * r2;
              S[row * kScoreLd + col] =
                  j0 + col < k ? score(xs[row], cj, to_f32(acc[nt][2 * r2 + e])) : INFINITY;
            }
          }
      }
      __syncthreads();
      // scan this thread's 32 columns in ascending index
      const int c_end = min(kCols / 2, k - j0 - my_h * (kCols / 2));
      const float* srow = S + my_r * kScoreLd + my_h * (kCols / 2);
      for (int c = 0; c < c_end; ++c) {
        float cv = srow[c];
        if (!(cv < lv[kKmax - 1])) continue;  // at or above the list's last
        int cx = j0 + my_h * (kCols / 2) + c;
#pragma unroll
        for (int i = 0; i < kKmax; ++i) {  // bubble (cv, cx) into place
          if (before(cv, cx, lv[i], lx[i])) {
            const float tv = lv[i];
            const int tx2 = lx[i];
            lv[i] = cv;
            lx[i] = cx;
            cv = tv;
            cx = tx2;
          }
        }
      }
    }
    __syncthreads();  // this stage and S are rewritten by the next slices
  }

  // merge the two lists of each row (the stages are free now)
  float* Lv = reinterpret_cast<float*>(smem);
  int* Lx = reinterpret_cast<int*>(smem + kKmax * kThreads * sizeof(float));
#pragma unroll
  for (int i = 0; i < kKmax; ++i) {
    Lv[i * kThreads + tid] = lv[i];
    Lx[i * kThreads + tid] = lx[i];
  }
  __syncthreads();
  if (tid < kRows && tid < rows_left) {
    const int a = tid;
    const int b = tid + kRows;
    int pa = 0, pb = 0;
    const size_t base = static_cast<size_t>(row0 + tid) * kk;
    for (int i = 0; i < kk; ++i) {
      const float va = Lv[pa * kThreads + a];
      const int xa = Lx[pa * kThreads + a];
      const float vb = Lv[pb * kThreads + b];
      const int xb = Lx[pb * kThreads + b];
      const bool take_a = before(va, xa, vb, xb);
      out_idx[base + i] = take_a ? xa : xb;
      out_val[base + i] = take_a ? va : vb;
      if (take_a)
        ++pa;
      else
        ++pb;
    }
  }
}

template <int DT>
cudaError_t launch(const void* rows, const void* cents, const float* cn, int n, int k, int d,
                   int kk, int mode, int* idx, float* val, cudaStream_t s) {
  auto kernel = pref_topk_kernel<DT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, kSmemBytes, s>>>(static_cast<const uint8_t*>(rows),
                                               static_cast<const uint8_t*>(cents), cn, n, k, d,
                                               kk, mode, idx, val);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (n, d), cents (k, d): contiguous device tensors of one dtype (0 f32,
// 1 bf16, 2 int8); cn (k,) f32; idx (n, kk) int32 and vals (n, kk) f32 are
// written. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for n < 0, k < 1, d < 1, kk outside [1, min(k, 8)]
// or an unknown dtype. n = 0 launches nothing.
int ic_pref_topk_block(const void* rows, const void* cents, const void* cn, int n, int k, int d,
                       int kk, int dtype, void* idx, void* vals, void* stream) {
  if (n < 0 || k < 1 || d < 1 || kk < 1 || kk > kKmax || kk > k || dtype < kF32 || dtype > kI8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int esize = dtype == kF32 ? 4 : (dtype == kBF16 ? 2 : 1);
  const long long row_bytes = static_cast<long long>(d) * esize;
  const uintptr_t both = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(cents);
  int mode = 1;
  if (row_bytes % 16 == 0 && both % 16 == 0)
    mode = 16;
  else if (row_bytes % 4 == 0 && both % 4 == 0)
    mode = 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cn);
  int* oi = static_cast<int*>(idx);
  float* ov = static_cast<float*>(vals);
  cudaError_t err;
  if (dtype == kBF16)
    err = launch<kBF16>(rows, cents, c, n, k, d, kk, mode, oi, ov, s);
  else if (dtype == kI8)
    err = launch<kI8>(rows, cents, c, n, k, d, kk, mode, oi, ov, s);
  else
    err = launch<kF32>(rows, cents, c, n, k, d, kk, mode, oi, ov, s);
  return static_cast<int>(err);
}

}  // extern "C"
