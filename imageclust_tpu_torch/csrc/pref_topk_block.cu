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
//   bf16: wgmma m64n128k16, bf16 in, f32 accumulate (a bf16 product is exact
//         in f32; the sum rounds in the tensor core's order);
//   int8: wgmma m64n128k32, s8 in, s32 accumulate (exact integers), turned
//         into f32 once per tile (the same rounding as JAX's int32 -> f32);
//   f32:  one __fmaf_rn chain per (row, centroid) in ascending d from 0 (IEEE
//         f32; TF32 would not be, and the Pallas body's f32 gram is plain
//         f32). With the norms below, f32 and int8 outputs do not depend on
//         the tiling: any version of this kernel gives the same bits.
// The score is formed with explicit round-to-nearest intrinsics, in the
// Pallas body's order, so no contraction changes it.
//
// What bounds it on this card: operations. At the 2M-row summarize pass
// (k = 5209, d = 512) 2 n k d is 10.7 TFLOP: 10.8 ms at 989 TFLOP/s in bf16
// (int8 at d = 1024: 10.8 ms at 1979 TOP/s), 159 ms at 67 TFLOP/s in f32,
// against 2.1 GB of rows read in 0.6 ms. What stands in the way is feeding
// the tensor cores (every row block re-reads every centroid from L2) and,
// once they are fed, the top-k epilogue: 10.4 G scores a call, each formed,
// compared and sometimes inserted by the thread that holds it.
//
// Design of the tensor-core paths (bf16, int8):
//   * One CTA per 128 rows: two consumer warpgroups of 64 rows each and one
//     producer warpgroup (384 threads). 128 rows halve the L2 re-reads of
//     the centroids against 64 (about 83 GB a 2M-row bf16 call); the
//     accumulator of an m64n128 tile is 64 registers a thread, which leaves
//     room for the top-k lists under the 168-register cap of 384 threads.
//   * Centroid tiles of 128 x one 128-byte k-slab (64 bf16, 128 int8) are
//     copied by TMA (cp.async.bulk.tensor, 128-byte swizzle) into a ring of
//     kStages stages; the copies complete on "full" mbarriers, each consumer
//     warp releases a stage on its "empty" mbarrier after the wgmma that
//     read it has retired. TMA needs 16-byte-aligned rows: the wrapper hands
//     over a zero-padded copy of the centroids when d x elem is not a
//     multiple of 16 (zeros add nothing to products or norms). The tensor
//     map is encoded on the host by cuTensorMapEncodeTiled, fetched with
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
//   * Rows stay resident in shared memory when 128 of them fit in
//     kResidentSlabs slabs (128 KB: bf16 d <= 512, int8 d <= 1024), loaded
//     once by the consumers. Wider rows stream: the producer warpgroup
//     copies each row slab beside its centroid slab, and the stage's full
//     barrier also waits for those copies (cp.async.mbarrier.arrive). Rows
//     are never copied on the host: they arrive by cp.async (16- or 4-byte
//     copies when rows are multiples of that, byte by byte otherwise),
//     written into the swizzled layout wgmma's descriptors read, with zeros
//     past d and n. A proxy fence orders those writes before wgmma.
//   * Each consumer keeps one wgmma group in flight: it issues a slab's four
//     k-steps, then waits for the previous slab's and releases its stage.
//     Both warpgroups reach a tile's epilogue together; the tensor cores
//     idle meanwhile (overlapping the two is later work: it needs a deeper
//     ring than shared memory leaves beside resident rows).
//
// Design of the f32 path: 256 threads, 128 rows x 128 centroids a tile,
// 32-float k-slabs copied by cp.async (row-major, 144-byte rows) through a
// ring of kF32Stages. Thread t owns rows t / 8 + 32 h (h < 4) and columns
// t % 8 + 8 m (m < 16) of each tile; it reads its operands as float4 along
// k, conflict-free: per 4 k-steps 4 row vectors and 16 centroid vectors
// feed 256 FMAs, one __fmaf_rn chain per (row, centroid) in ascending d.
// The gram runs at about half the FP32 peak; a 2 x 32 thread tile (more
// loads per FMA) ran slower and an 8 x 8 one (fewer) no faster, so the
// operand loads do not set that pace (PERF.md).
//
// The epilogue, shared by all paths, stays in registers. On the
// tensor-core paths thread t of a warpgroup owns rows 16 (t / 32) +
// (t % 32) / 4 and +8 and the columns 8 i + 2 (t % 4) + {0, 1} of every
// tile (wgmma's m64nN accumulator layout); the 4 lanes of a quad share
// their rows. Per owned row a thread keeps a sorted list of the kKmax
// (8 >= kk) smallest (s, j). It meets its columns in ascending j (within a
// tile in accumulator order, tiles in ascending order), so a score equal
// to its list's last, or to the group's bound (below), can be rejected:
// a later j never wins a tie. The insertion shifts the larger entries down
// with eight independent compares. Scores that pass the bound wait in the
// thread's queue in shared memory and are inserted after each 16 (see
// drain). After the last tile the lanes that share a row merge their
// lists lexicographically by shuffles (the 8 smallest of two sorted lists
// form a bitonic sequence; a 3-stage bitonic network sorts it). No atomics:
// a rerun gives the same bits.
//
// Before the tiles, each warp sums the squared norms of 16 of the rows from
// device memory: lane l adds the squares of elements l, l + 32, ... in f32
// (one rounding a term), then a fixed butterfly of shuffles adds the 32
// partial sums.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 128;     // rows of x per CTA
constexpr int kCols = 128;     // centroids per tile
constexpr int kKmax = 8;       // the longest kept list (the engine's kk)
constexpr int kSlab = 128;     // bytes of a row per k-slab (tensor-core paths)
constexpr int kSlabTile = kRows * kSlab;  // 16 KB: 128 rows of one slab
constexpr int kStages = 4;
constexpr int kResidentSlabs = 8;  // rows stay resident up to 1 KB a row
constexpr int kTcThreads = 384;    // two consumer warpgroups, one producer
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kQueue = 16;  // candidates a thread queues before it inserts them

constexpr int kF32Threads = 256;
constexpr int kF32Slab = 32;           // floats of a row per k-slab
constexpr int kF32Ld = kF32Slab + 4;   // shared row stride in floats
constexpr int kF32Tile = kRows * kF32Ld * 4;  // bytes of one operand's slab
constexpr int kF32Stages = 3;
constexpr int kF32Halves = 2;  // the centroid vectors of a k-step, loaded in halves
constexpr int kF32Smem = kF32Stages * 2 * kF32Tile + kRows * 4 + kQueue * kF32Threads * 8;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__host__ __device__ constexpr int tc_smem_bytes(int a_tiles) {
  // A tiles, the centroid ring, 1 KB of slack to align to the swizzle's
  // 1024 bytes, the barriers, the row norms and the candidate queues
  return (a_tiles + kStages) * kSlabTile + 1024 + 2 * kStages * 8 + kRows * 4 +
         kQueue * kConsumers * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- asynchronous copies ------------------------------------------------------

// src_bytes 0 writes 16 (4) zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes of this thread before later async-proxy (wgmma) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Byte b of row r in a tile of 128-byte rows under the 128-byte swizzle
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout 1): the 16-byte chunk
// b / 16 lands at chunk (b / 16) ^ (r % 8). The tile is 1024-byte aligned.
__device__ __forceinline__ int swz(int r, int b) {
  return r * kSlab + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

// Bytes [cb, cb + 128) of rows [0, 128) of a row-major source with row_bytes
// bytes a row into a swizzled tile, by threads t, t + nthr, ...; rows >=
// rows_left and bytes >= row_bytes are zero. mode 16 or 4: cp.async of that
// many bytes (row_bytes and the base are multiples of it); else byte by
// byte with plain loads and stores.
__device__ __forceinline__ void load_slab_swz(uint8_t* dst, const uint8_t* src,
                                              long long row_bytes, int rows_left, long long cb,
                                              int mode, int t, int nthr) {
  if (mode == 16) {
    for (int q = t; q < kRows * (kSlab / 16); q += nthr) {
      const int r = q / (kSlab / 16);
      const int b = (q % (kSlab / 16)) * 16;
      const bool ok = r < rows_left && cb + b < row_bytes;
      cp_async16(dst + swz(r, b), ok ? src + static_cast<size_t>(r) * row_bytes + cb + b : src,
                 ok ? 16 : 0);
    }
  } else if (mode == 4) {
    for (int q = t; q < kRows * (kSlab / 4); q += nthr) {
      const int r = q / (kSlab / 4);
      const int b = (q % (kSlab / 4)) * 4;
      const bool ok = r < rows_left && cb + b < row_bytes;
      cp_async4(dst + swz(r, b), ok ? src + static_cast<size_t>(r) * row_bytes + cb + b : src,
                ok ? 4 : 0);
    }
  } else {
    for (int q = t; q < kRows * kSlab; q += nthr) {
      const int r = q / kSlab;
      const int b = q % kSlab;
      dst[swz(r, b)] = (r < rows_left && cb + b < row_bytes)
                           ? src[static_cast<size_t>(r) * row_bytes + cb + b]
                           : static_cast<uint8_t>(0);
    }
  }
}

// Bytes [cb, cb + 128) of rows [0, 128) into a plain tile of kF32Ld-float
// rows (the f32 path); as load_slab_swz, with zero fill by stores.
__device__ __forceinline__ void load_slab_f32(uint8_t* dst, const uint8_t* src,
                                              long long row_bytes, int rows_left, long long cb,
                                              int mode) {
  constexpr int kLdB = kF32Ld * 4;
  if (mode == 16) {
    for (int q = threadIdx.x; q < kRows * (kSlab / 16); q += kF32Threads) {
      const int r = q / (kSlab / 16);
      const int b = (q % (kSlab / 16)) * 16;
      const bool ok = r < rows_left && cb + b < row_bytes;
      cp_async16(dst + r * kLdB + b, ok ? src + static_cast<size_t>(r) * row_bytes + cb + b : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int q = threadIdx.x; q < kRows * (kSlab / 4); q += kF32Threads) {
      const int r = q / (kSlab / 4);
      const int b = (q % (kSlab / 4)) * 4;
      const bool ok = r < rows_left && cb + b < row_bytes;
      cp_async4(dst + r * kLdB + b, ok ? src + static_cast<size_t>(r) * row_bytes + cb + b : src,
                ok ? 4 : 0);
    }
  }
}

// -- mbarriers and TMA --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

// an arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(b))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------

// K-major operand under the 128-byte swizzle: 8-row groups 1024 bytes apart
// (SBO), leading offset unused for this layout (1), layout type 1 (B128).
// A k-step of 32 bytes advances the start address by 2 (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a fence
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define IC_ACC8(C, B)                                                                   \
  C(d[B + 0]), C(d[B + 1]), C(d[B + 2]), C(d[B + 3]), C(d[B + 4]), C(d[B + 5]), C(d[B + 6]), \
      C(d[B + 7])
#define IC_ACC64(C)                                                                        \
  IC_ACC8(C, 0), IC_ACC8(C, 8), IC_ACC8(C, 16), IC_ACC8(C, 24), IC_ACC8(C, 32), IC_ACC8(C, 40), \
      IC_ACC8(C, 48), IC_ACC8(C, 56)
#define IC_REGS64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = A (64 x 16 bf16) B^T (+ d when acc_in)
__device__ __forceinline__ void wgmma_k(float (&d)[64], uint64_t da, uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IC_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : IC_ACC64("+f")
      : "l"(da), "l"(db), "r"(acc_in));
}

// d (64 x 128, s32) = A (64 x 32 s8) B^T (+ d when acc_in)
__device__ __forceinline__ void wgmma_k(int (&d)[64], uint64_t da, uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " IC_REGS64 ", %64, %65, p;\n}\n"
      : IC_ACC64("+r")
      : "l"(da), "l"(db), "r"(acc_in));
}

#undef IC_ACC8
#undef IC_ACC64
#undef IC_REGS64

// -- the epilogue -------------------------------------------------------------

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

// Norms of rows [0, 128) of the block (rows past rows_left read 0) into xs,
// warp w of 8 taking rows 16 w .. 16 w + 15.
template <typename T>
__device__ __forceinline__ void block_row_norms(const uint8_t* a_src, int d, int rows_left,
                                                float* xs, int warp, int lane) {
  for (int r = warp * (kRows / 8); r < (warp + 1) * (kRows / 8); ++r) {
    const float v =
        r < rows_left
            ? warp_row_norm(reinterpret_cast<const T*>(a_src) + static_cast<size_t>(r) * d, d, lane)
            : 0.0f;
    if (lane == 0) xs[r] = v;
  }
}

// The Pallas body's score max((xx + cn) - 2 g, 0), each step rounded once:
// 2 g is exact, so one fused multiply-add rounds the difference as its
// subtraction does.
__device__ __forceinline__ float score(float xr, float cj, float g) {
  return fmaxf(__fmaf_rn(-2.0f, g, __fadd_rn(xr, cj)), 0.0f);
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float a, int b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(__float_as_int(a)), "r"(b)
               : "memory");
}

// (s, j) lexicographically before (v, x)
__device__ __forceinline__ bool before(float s, int j, float v, int x) {
  return s < v || (s == v && j < x);
}

// The running lists of a thread: R rows, each shared with the other lanes
// of an aligned group of L, which hold other columns of it.
template <int R, int L>
struct TopK {
  float v[R][kKmax];  // per owned row, ascending by (v, x); empty: (+inf, INT_MAX)
  int x[R][kKmax];
  float t[R];  // per row, the group's bound (below)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      t[r] = INFINITY;
#pragma unroll
      for (int i = 0; i < kKmax; ++i) {
        v[r][i] = INFINITY;
        x[r][i] = 0x7fffffff;
      }
    }
  }

  // The group's bound, taken where its lanes have scanned the same columns
  // (a tile's start or a drain): the least last entry of its lanes' lists,
  // or the largest of their first kKmax / L entries if less. Either way the
  // group holds kKmax entries at or below it, all of lower index than any
  // column still to come, so a later score at or above it cannot reach the
  // row's kKmax smallest.
  __device__ __forceinline__ void bound() {
    static_assert(kKmax % L == 0, "a group's firsts must make kKmax entries");
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float lo = v[r][kKmax - 1];
      float hi = v[r][kKmax / L - 1];
#pragma unroll
      for (int o = 1; o < L; o *= 2) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      t[r] = fminf(lo, hi);
    }
  }

  // whether a score of the columns still to come may reach row r's kKmax
  // smallest (the bound is at most the list's last)
  __device__ __forceinline__ bool wants(int r, float s) const { return s < t[r]; }

  // (s, j) into row r's list. j exceeds every index the list holds, so
  // (s, j) goes after every entry of value <= s: a score at or above the
  // last is rejected, and the others shift the larger entries down by one
  // (eight independent compares, no chain of swaps).
  __device__ __forceinline__ void offer(int r, float s, int j) {
    if (s < v[r][kKmax - 1]) {
      bool c[kKmax];
#pragma unroll
      for (int i = 0; i < kKmax; ++i) c[i] = s < v[r][i];
#pragma unroll
      for (int i = kKmax - 1; i > 0; --i) {
        v[r][i] = c[i - 1] ? v[r][i - 1] : (c[i] ? s : v[r][i]);
        x[r][i] = c[i - 1] ? x[r][i - 1] : (c[i] ? j : x[r][i]);
      }
      if (c[0]) {
        v[r][0] = s;
        x[r][0] = j;
      }
    }
  }

  // merge with the lists of the lane at xor distance m (same rows)
  __device__ __forceinline__ void merge(int m) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ov[kKmax];
      int ox[kKmax];
#pragma unroll
      for (int i = 0; i < kKmax; ++i) {
        ov[i] = __shfl_xor_sync(0xffffffffu, v[r][i], m);
        ox[i] = __shfl_xor_sync(0xffffffffu, x[r][i], m);
      }
      // the kKmax smallest of the two: a bitonic sequence
#pragma unroll
      for (int i = 0; i < kKmax; ++i) {
        if (before(ov[kKmax - 1 - i], ox[kKmax - 1 - i], v[r][i], x[r][i])) {
          v[r][i] = ov[kKmax - 1 - i];
          x[r][i] = ox[kKmax - 1 - i];
        }
      }
#pragma unroll
      for (int dd = kKmax / 2; dd > 0; dd /= 2)
#pragma unroll
        for (int i = 0; i < kKmax; ++i) {
          if ((i & dd) == 0 && before(v[r][i + dd], x[r][i + dd], v[r][i], x[r][i])) {
            const float tv = v[r][i];
            const int tx = x[r][i];
            v[r][i] = v[r][i + dd];
            x[r][i] = x[r][i + dd];
            v[r][i + dd] = tv;
            x[r][i + dd] = tx;
          }
        }
    }
  }

  // The group's merged lists; lane g == h of the group writes its row h
  // (row[h] of the block, if below rows_left).
  __device__ __forceinline__ void finish(int g, const int (&row)[R], int row0, int rows_left,
                                         int kk, int* __restrict__ out_idx,
                                         float* __restrict__ out_val) {
#pragma unroll
    for (int m = 1; m < L; m *= 2) merge(m);
#pragma unroll
    for (int h = 0; h < R; ++h) {
      if (g == h && row[h] < rows_left) {
        const size_t base = (static_cast<size_t>(row0) + row[h]) * kk;
#pragma unroll
        for (int i = 0; i < kKmax; ++i)
          if (i < kk) {
            out_idx[base + i] = x[h][i];
            out_val[base + i] = v[h][i];
          }
      }
    }
  }
};

// Candidates of one tile that a thread has not offered yet, in its own
// slots of shared memory: per row r, kQueue / R entries (score, column) at
// queue[(r * kQueue / R + i) * stride]. The scan of a tile only compares
// each score with its list's bounds and appends it when it passes; after
// each 16 scores a loop per row inserts the queued ones and the group
// takes its bound anew. A warp thus pays for the longest queue of its
// lanes, not for every score that some lane inserts, as it would if each
// lane inserted as it scanned; and the unrolled scan holds four copies of
// the insertion code, not one per score.
template <int R, int L>
__device__ __forceinline__ void drain(TopK<R, L>& top, const int2* __restrict__ queue,
                                      int stride, int (&nq)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int c = 0; c < nq[r]; ++c) {
      const int2 e = queue[(r * (kQueue / R) + c) * stride];
      top.offer(r, __int_as_float(e.x), e.y);
    }
    nq[r] = 0;
  }
  top.bound();
}

// Score s of row r, column col into the queue (shared address qa of the
// thread's first slot) if it passes the group's bound.
template <int R, int L>
__device__ __forceinline__ void enqueue(const TopK<R, L>& top, uint32_t qa, int stride,
                                        int (&nq)[R], int r, float s, int col) {
  if (top.wants(r, s)) st_shared_v2(qa + ((r * (kQueue / R) + nq[r]) * stride) * 8, s, col);
  nq[r] += top.wants(r, s);
}

// One tile's scores from the accumulators a[4 i + 2 h + e] (row h, column
// 8 i + 2 q + e of the tile at j0) of a tensor-core consumer, in ascending
// column. cn holds +inf past k, so those columns never pass.
template <typename Acc>
__device__ __forceinline__ void tc_tile(TopK<2, 4>& top, int2* __restrict__ queue,
                                        const Acc (&a)[64], int j0, int q, float x0, float x1,
                                        const float* __restrict__ cn) {
  const uint32_t qa = smem_addr(queue);
  const float* cq = cn + j0 + 2 * q;
  int nq[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < kCols / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j0 + 8 * i + 2 * q + e;
      const float cj = __ldg(cq + 8 * i + e);
      enqueue(top, qa, kConsumers, nq, 0, score(x0, cj, to_f32(a[4 * i + e])), col);
      enqueue(top, qa, kConsumers, nq, 1, score(x1, cj, to_f32(a[4 * i + 2 + e])), col);
    }
    if (i % 4 == 3) drain(top, queue, kConsumers, nq);  // after each 16 scores
  }
}

// -- the tensor-core kernel (bf16, int8) --------------------------------------

template <int DT>
__global__ void __launch_bounds__(kTcThreads, 1)
pref_topk_wgmma(const __grid_constant__ CUtensorMap cmap, const uint8_t* __restrict__ rows,
                const float* __restrict__ cn, int n, int k, int d, int kk, int mode, int resident,
                int* __restrict__ out_idx, float* __restrict__ out_val) {
  using Acc = typename std::conditional<DT == kI8, int, float>::type;
  using Elem = typename std::conditional<DT == kBF16, __nv_bfloat16, int8_t>::type;
  constexpr int kEsize = static_cast<int>(sizeof(Elem));
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const long long row_bytes = static_cast<long long>(d) * kEsize;
  const int n_slabs = static_cast<int>((row_bytes + kSlab - 1) / kSlab);
  const int n_ct = (k + kCols - 1) / kCols;
  const int total = n_ct * n_slabs;
  const int row0 = blockIdx.x * kRows;
  const int rows_left = n - row0;
  const uint8_t* a_src = rows + static_cast<size_t>(row0) * row_bytes;

  uint8_t* A = smem;  // resident: n_slabs tiles; streaming: one per stage
  uint8_t* B = A + (resident ? n_slabs : kStages) * kSlabTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(B + kStages * kSlabTile);
  uint64_t* empty = full + kStages;
  float* xs = reinterpret_cast<float*>(empty + kStages);
  int2* queue = reinterpret_cast<int2*>(xs + kRows) + tid;  // consumers only

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], resident ? 1 : 1 + 128);  // the TMA's arrival (+ the row copiers)
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup
    const int pt = tid - kConsumers;
    if (resident && pt != 0) return;
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
      const int ct = it / n_slabs;
      const int s = it - ct * n_slabs;
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[st], kSlabTile);
        tma_load_2d(B + st * kSlabTile, &cmap, &full[st], s * (kSlab / kEsize), ct * kCols);
      }
      if (!resident) {
        load_slab_swz(A + st * kSlabTile, a_src, row_bytes, rows_left,
                      static_cast<long long>(s) * kSlab, mode, pt, 128);
        if (mode == 16 || mode == 4)
          mbar_arrive_cp_async(&full[st]);
        else
          mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = tid / 128;
  if (resident) {
    for (int s = 0; s < n_slabs; ++s)
      load_slab_swz(A + s * kSlabTile, a_src, row_bytes, rows_left,
                    static_cast<long long>(s) * kSlab, mode, tid, kConsumers);
    cp_async_commit();
  }
  block_row_norms<Elem>(a_src, d, rows_left, xs, warp, lane);
  cp_async_wait<0>();
  fence_proxy_async();
  consumer_sync();

  const int q = lane % 4;
  const int r0 = 16 * warp + lane / 4;
  const float x0 = xs[r0];
  const float x1 = xs[r0 + 8];
  TopK<2, 4> top;
  top.init();
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  int it = 0;
  for (int ct = 0; ct < n_ct; ++ct) {
    for (int s = 0; s < n_slabs; ++s, ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      if (!resident) fence_proxy_async();
      const uint64_t da =
          sw128_desc((resident ? A + s * kSlabTile : A + st * kSlabTile) + wg * 64 * kSlab);
      const uint64_t db = sw128_desc(B + st * kSlabTile);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSlab / 32; ++ks)
        wgmma_k(acc, da + 2 * ks, db + 2 * ks, (s > 0 || ks > 0) ? 1 : 0);
      wgmma_commit();
      fence_regs(acc);
      if (s > 0) {  // the previous slab's group has retired: free its stage
        wgmma_wait<1>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    tc_tile(top, queue, acc, ct * kCols, q, x0, x1, cn);
  }
  const int rows_of[2] = {r0, r0 + 8};
  top.finish(q, rows_of, row0, rows_left, kk, out_idx, out_val);
}

// -- the f32 kernel -----------------------------------------------------------

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(kF32Threads, 1)
pref_topk_ffma(const uint8_t* __restrict__ rows, const uint8_t* __restrict__ cents,
               long long c_row_bytes, const float* __restrict__ cn, int n, int k, int d, int kk,
               int mode, int* __restrict__ out_idx, float* __restrict__ out_val) {
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* xs = reinterpret_cast<float*>(smem + kF32Stages * 2 * kF32Tile);

  const int tid = threadIdx.x;
  const long long row_bytes = static_cast<long long>(d) * 4;
  const int row0 = blockIdx.x * kRows;
  const int rows_left = n - row0;
  const uint8_t* a_src = rows + static_cast<size_t>(row0) * row_bytes;
  const int n_ds = (d + kF32Slab - 1) / kF32Slab;
  const int n_ct = (k + kCols - 1) / kCols;
  const int total = n_ct * n_ds;

  auto issue = [&](int it) {  // slab it's rows and centroids into its stage
    if (it < total) {
      const int ct = it / n_ds;
      const long long cb = static_cast<long long>(it - ct * n_ds) * kSlab;
      uint8_t* buf = smem + (it % kF32Stages) * 2 * kF32Tile;
      load_slab_f32(buf, a_src, row_bytes, rows_left, cb, mode);
      load_slab_f32(buf + kF32Tile, cents + static_cast<size_t>(ct) * kCols * c_row_bytes,
                    c_row_bytes, k - ct * kCols, cb, mode);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) issue(s);

  const int warp = tid / 32;
  const int lane = tid % 32;
  block_row_norms<float>(a_src, d, rows_left, xs, warp, lane);  // published by the first barrier

  // rows rg + 32 h and columns cg + 8 m of every tile; the 8 lanes of an
  // aligned group share their rows
  const int cg = lane % 8;
  const int rg = tid / 8;
  const int rows_of[4] = {rg, rg + 32, rg + 64, rg + 96};
  int2* queue = reinterpret_cast<int2*>(xs + kRows) + tid;
  TopK<4, 8> top;
  top.init();
  float acc[4][kCols / 8];

  const uint32_t qa = smem_addr(queue);
  int it = 0;
  for (int ct = 0; ct < n_ct; ++ct) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int m = 0; m < kCols / 8; ++m) acc[h][m] = 0.0f;
    for (int ds = 0; ds < n_ds; ++ds, ++it) {
      cp_async_wait<kF32Stages - 2>();
      __syncthreads();  // slab it has landed; slab it - 1's stage is free
      issue(it + kF32Stages - 1);
      const float* As = reinterpret_cast<const float*>(smem + (it % kF32Stages) * 2 * kF32Tile);
      const float* Bs = As + kF32Tile / 4;
#pragma unroll 1
      for (int kq = 0; kq < kF32Slab; kq += 4) {
        float4 a[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          a[h] = *reinterpret_cast<const float4*>(As + rows_of[h] * kF32Ld + kq);
#pragma unroll
        for (int half = 0; half < kF32Halves; ++half) {  // independent sums a k-step
          constexpr int kB = kCols / 8 / kF32Halves;
          float4 b[kB];
#pragma unroll
          for (int m = 0; m < kB; ++m)
            b[m] = *reinterpret_cast<const float4*>(Bs + (cg + 8 * (kB * half + m)) * kF32Ld + kq);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int m = 0; m < kB; ++m)
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                float& g = acc[h][kB * half + m];
                g = __fmaf_rn(lane4(a[h], c), lane4(b[m], c), g);
              }
        }
      }
    }
    // the tile's scores, in ascending column (cn holds +inf past k)
    const int j0 = ct * kCols;
    float xr[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) xr[h] = xs[rows_of[h]];
    int nq[4] = {0, 0, 0, 0};
#pragma unroll
    for (int m = 0; m < kCols / 8; ++m) {
      const int col = j0 + cg + 8 * m;
      const float cj = __ldg(cn + col);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        enqueue(top, qa, kF32Threads, nq, h, score(xr[h], cj, acc[h][m]), col);
      if (m % 4 == 3) drain(top, queue, kF32Threads, nq);  // after each 16 scores
    }
  }
  top.finish(cg, rows_of, row0, rows_left, kk, out_idx, out_val);
}

// -- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime (null if absent)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <int DT>
cudaError_t launch_tc(const void* rows, const void* cents, int c_ld, const float* cn, int n,
                      int k, int d, int kk, int mode, int* idx, float* val, cudaStream_t s) {
  constexpr int kEsize = DT == kBF16 ? 2 : 1;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c_ld), static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c_ld) * kEsize};
  const cuuint32_t box[2] = {kSlab / kEsize, kCols};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      &map, DT == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(cents), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const long long row_bytes = static_cast<long long>(d) * kEsize;
  const int n_slabs = static_cast<int>((row_bytes + kSlab - 1) / kSlab);
  const int resident = n_slabs <= kResidentSlabs ? 1 : 0;
  const int smem = tc_smem_bytes(resident ? n_slabs : kStages);
  auto kernel = pref_topk_wgmma<DT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  kernel<<<blocks, kTcThreads, smem, s>>>(map, static_cast<const uint8_t*>(rows), cn, n, k, d, kk,
                                          mode, resident, idx, val);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* rows, const void* cents, int c_ld, const float* cn, int n,
                       int k, int d, int kk, int mode, int* idx, float* val, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(pref_topk_ffma, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  pref_topk_ffma<<<blocks, kF32Threads, kF32Smem, s>>>(
      static_cast<const uint8_t*>(rows), static_cast<const uint8_t*>(cents),
      static_cast<long long>(c_ld) * 4, cn, n, k, d, kk, mode, idx, val);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows (n, d) contiguous, cents (k, c_ld) with c_ld >= d and zeros past d,
// both device tensors of one dtype (0 f32, 1 bf16, 2 int8); cn the f32
// norms of the centroids, +inf from k to the next multiple of 128;
// idx (n, kk) int32 and vals (n, kk) f32 are written. For bf16 and int8
// the centroid rows (c_ld x elem bytes) and base must be 16-byte aligned
// (TMA's rule). Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for n < 0, k < 1, d < 1, c_ld < d, kk outside
// [1, min(k, 8)], an unknown dtype or misaligned centroids;
// cudaErrorNotSupported when cuTensorMapEncodeTiled cannot be fetched.
// n = 0 launches nothing.
int ic_pref_topk_block(const void* rows, const void* cents, const void* cn, int n, int k, int d,
                       int c_ld, int kk, int dtype, void* idx, void* vals, void* stream) {
  if (n < 0 || k < 1 || d < 1 || c_ld < d || kk < 1 || kk > kKmax || kk > k || dtype < kF32 ||
      dtype > kI8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == kF32 ? 4 : (dtype == kBF16 ? 2 : 1);
  if (dtype != kF32 && ((static_cast<long long>(c_ld) * esize) % 16 != 0 ||
                        reinterpret_cast<uintptr_t>(cents) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long row_bytes = static_cast<long long>(d) * esize;
  const long long c_bytes = static_cast<long long>(c_ld) * esize;
  uintptr_t both = reinterpret_cast<uintptr_t>(rows);
  if (dtype == kF32) both |= reinterpret_cast<uintptr_t>(cents);
  const bool rows16 = row_bytes % 16 == 0 && (dtype != kF32 || c_bytes % 16 == 0);
  const bool rows4 = row_bytes % 4 == 0 && (dtype != kF32 || c_bytes % 4 == 0);
  int mode = 1;
  if (rows16 && both % 16 == 0)
    mode = 16;
  else if (rows4 && both % 4 == 0)
    mode = 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cn);
  int* oi = static_cast<int*>(idx);
  float* ov = static_cast<float*>(vals);
  cudaError_t err;
  if (dtype == kBF16)
    err = launch_tc<kBF16>(rows, cents, c_ld, c, n, k, d, kk, mode, oi, ov, s);
  else if (dtype == kI8)
    err = launch_tc<kI8>(rows, cents, c_ld, c, n, k, d, kk, mode, oi, ov, s);
  else
    err = launch_f32(rows, cents, c_ld, c, n, k, d, kk, mode, oi, ov, s);
  return static_cast<int>(err);
}

}  // extern "C"
