// Short-sequence attention for the ViT towers on Hopper (sm_90a).
//
// Replaces imageclust_tpu/ops/attention.py:short_seq_attention (kernel body
// _attn_kernel). For q, k, v of shape (B, T, H, Dh), bf16 or f32, it computes
// per (batch, head) pair
//   s = (q k^T) * scale       f32 accumulation, scale = 1/sqrt(Dh) in f32
//   p = exp(s - rowmax(s));  p = p / rowsum(p)   (normalised BEFORE the cast)
//   o = cast(p, v.dtype) @ v  f32 accumulation, cast to q's dtype
// and writes o in the same (B, T, H, Dh) layout. T <= 128, Dh <= 128 and
// Dh % 8 == 0; the host function refuses anything else.
//
// What bounds it on this card: device-memory bytes. At ViT-B/32 (T = 50,
// H = 12, Dh = 64, batch 1024) one read of q, k, v and one write of o move
// 315 MB (0.094 ms at 3.35 TB/s); the two products are 7.9 GFLOP (0.008 ms
// on the bf16 tensor cores). The (T, T) logits never leave the SM.
//
// Two kernels, one per case; both read q, k and v in place from the strided
// (B, T, H, Dh) layout (16-byte loads; no transposes through device memory),
// run one 128-thread block per (batch, head) pair, and write o in place.
//
// short_seq_attention_mma_kernel: bf16 with Dh = 64 (the ViT-B/32 path).
//   * cp.async stages the pair's q, k and v rows as bf16 in shared memory,
//     rows padded to 72 elements (144 bytes) so that the eight 16-byte rows
//     an ldmatrix reads fall in disjoint banks. Rows T .. ceil16(T) are
//     zero-filled.
//   * Warp w takes query tiles of 16 rows (w, w + 4, ...). S = q k^T runs on
//     the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate: the
//     products are exact and summed in f32, as the Pallas body's
//     preferred_element_type=f32), A and B fragments by ldmatrix.
//   * Softmax in registers: each row's values sit in the four lanes of a
//     quad; max and sum by two shuffles each. Padded keys (j >= T) are set
//     to -inf before the max, so they add nothing to the sum. p is divided
//     by the sum, then rounded to bf16: that rounding is the cast the
//     Pallas body makes, and the rounded values are exactly the A fragments
//     of P @ V (the accumulator layout of two n-tiles is the A layout of one
//     k-tile), so P never leaves the registers.
//   * O = P V on the tensor cores, B fragments by ldmatrix.trans from the
//     row-major v tile; f32 accumulators rounded to bf16 and stored as pairs.
//
// short_seq_attention_kernel: every other case (f32, or bf16 with another
// head width), with scalar arithmetic.
//   * The pair's q, k and v are kept in shared memory as f32; q and k rows
//     are padded to Dh + 4 floats: with Dh % 8 == 0 that stride is an odd
//     number of 16-byte words, so the eight lanes of a quarter-warp reading
//     one float4 each of eight different k rows hit disjoint banks.
//   * Each warp takes groups of kRows query rows. Lane j owns keys
//     j, j + 32, ... (NKC = ceil(T / 32) of them): per step of four columns
//     it loads one float4 of each of its keys and a broadcast float4 of each
//     query row, and does 4 * kRows * NKC multiply-adds.
//   * Row max and row sum by warp shuffles; padded keys are left out of
//     both. p is divided by the sum, rounded to v's dtype and put in the
//     warp's own slice of shared memory.
//   * Lane d owns output columns d, d + 32, ...: per key it reads p of the
//     kRows rows (broadcast float4 over four keys) and one element of v's
//     row, then multiply-adds into kRows x 4 accumulators.
//   * Products are formed with explicit fmaf. For bf16 inputs a product is
//     exact in f32, so fmaf equals the separate multiply and add that
//     -fmad=false would otherwise force.
// Both use expf (not __expf) and IEEE division, so the softmax keeps f32
// accuracy. The two kernels and the plain twin sum in different orders:
// they agree to a tolerance, not bit for bit.
//
// Later work: several pairs per block (a pair's tile is 28 KB of the SM's
// 228 KB) and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;  // query rows a warp holds at once
constexpr int kMaxT = 128;
constexpr int kMaxDh = 128;
constexpr int kColChunks = kMaxDh / 32;
constexpr int kMmaDh = 64;         // the head width of the tensor-core path
constexpr int kMmaLd = kMmaDh + 8;  // its shared-memory row, in bf16

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i in the low half (little endian)
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// p.astype(v.dtype) of the Pallas body, back in f32 for the product
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Rows [0, T) of one pair's tensor into shared memory (row stride ld);
// rows [T, rows) are zero-filled.
template <typename Scalar>
__device__ void stage(const Scalar* __restrict__ src, float* dst, int ld, int T,
                      int rows, int H, int Dh, size_t row0, int h) {
  const int per_row = Dh / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int t = i / per_row;
    const int c = (i - t * per_row) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t < T) load8(src + ((row0 + t) * H + h) * Dh + c, v);
    float4* d = reinterpret_cast<float4*>(dst + t * ld + c);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename Scalar, int NKC>
__global__ void __launch_bounds__(kThreads)
short_seq_attention_kernel(const Scalar* __restrict__ q, const Scalar* __restrict__ k,
                           const Scalar* __restrict__ v, Scalar* __restrict__ o, int T,
                           int H, int Dh, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldqk = Dh + 4;
  const int t4 = (T + 3) & ~3;  // p rows and v rows padded to a float4
  float* Qs = smem;              // T x ldqk
  float* Ks = Qs + T * ldqk;     // T x ldqk
  float* Vs = Ks + T * ldqk;     // t4 x Dh (rows >= T zero)
  float* Ps = Vs + t4 * Dh;      // kWarps x kRows x t4

  const int pair = blockIdx.x;
  const int b = pair / H;
  const int h = pair - b * H;
  const size_t row0 = static_cast<size_t>(b) * T;
  stage(q, Qs, ldqk, T, T, H, Dh, row0, h);
  stage(k, Ks, ldqk, T, T, H, Dh, row0, h);
  stage(v, Vs, Dh, T, t4, H, Dh, row0, h);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* P = Ps + warp * kRows * t4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int r0 = warp * kRows; r0 < T; r0 += kWarps * kRows) {
    // -- logits: s[r][c] = q[r0 + r] . k[lane + 32 c]
    float s[kRows][NKC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < NKC; ++c) s[r][c] = 0.f;
    for (int d = 0; d < Dh; d += 4) {
      float4 kv[NKC];
#pragma unroll
      for (int c = 0; c < NKC; ++c) {
        const int j = lane + 32 * c;
        kv[c] = j < T ? *reinterpret_cast<const float4*>(Ks + j * ldqk + d) : zero4;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = r0 + r;
        const float4 qv =
            row < T ? *reinterpret_cast<const float4*>(Qs + row * ldqk + d) : zero4;
#pragma unroll
        for (int c = 0; c < NKC; ++c) {
          s[r][c] = fmaf(qv.x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv.y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv.z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv.w, kv[c].w, s[r][c]);
        }
      }
    }
    // -- softmax over the T real keys of each row, normalised before the cast
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < NKC; ++c) {
        s[r][c] *= scale;
        if (lane + 32 * c < T) m = fmaxf(m, s[r][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < NKC; ++c) {
        s[r][c] = lane + 32 * c < T ? expf(s[r][c] - m) : 0.f;
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int c = 0; c < NKC; ++c) {
        const int j = lane + 32 * c;
        if (j < t4) P[r * t4 + j] = round_to(s[r][c] / sum, q);
      }
    }
    __syncwarp();

    // -- o[r][cd] = sum_j p[r][j] * v[j][lane + 32 cd]
    float acc[kRows][kColChunks];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cd = 0; cd < kColChunks; ++cd) acc[r][cd] = 0.f;
    for (int j = 0; j < t4; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = *reinterpret_cast<const float4*>(P + r * t4 + j);
#pragma unroll
      for (int cd = 0; cd < kColChunks; ++cd) {
        const int col = lane + 32 * cd;
        if (32 * cd >= Dh) break;
        const bool on = col < Dh;
        const float v0 = on ? Vs[(j + 0) * Dh + col] : 0.f;
        const float v1 = on ? Vs[(j + 1) * Dh + col] : 0.f;
        const float v2 = on ? Vs[(j + 2) * Dh + col] : 0.f;
        const float v3 = on ? Vs[(j + 3) * Dh + col] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][cd] = fmaf(pv[r].x, v0, acc[r][cd]);
          acc[r][cd] = fmaf(pv[r].y, v1, acc[r][cd]);
          acc[r][cd] = fmaf(pv[r].z, v2, acc[r][cd]);
          acc[r][cd] = fmaf(pv[r].w, v3, acc[r][cd]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r;
      if (row >= T) break;
      Scalar* out = o + ((row0 + row) * H + h) * Dh;
#pragma unroll
      for (int cd = 0; cd < kColChunks; ++cd) {
        const int col = lane + 32 * cd;
        if (col < Dh) store(out + col, acc[r][cd]);
      }
    }
    __syncwarp();  // P is rewritten by the next row group
  }
}

// -- the tensor-core path (bf16, Dh = 64) --------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 register, the first value in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// KT = ceil(T / 16): key tiles of 16 (two mma n-tiles of 8 each)
template <int KT>
__global__ void __launch_bounds__(kThreads)
short_seq_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ o, int T, int H, float scale) {
  constexpr int kRowsPad = 16 * KT;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + kRowsPad * kMmaLd;
  __nv_bfloat16* Vs = Ks + kRowsPad * kMmaLd;

  const int pair = blockIdx.x;
  const int b = pair / H;
  const int h = pair - b * H;
  const size_t row0 = static_cast<size_t>(b) * T;
  constexpr int kChunks = kMmaDh / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < kRowsPad * kChunks; i += kThreads) {
    const int t = i / kChunks;
    const int c = (i - t * kChunks) * 8;
    const int off = t * kMmaLd + c;
    if (t < T) {
      const size_t g = ((row0 + t) * H + h) * kMmaDh + c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(Qs + off)),
                   "l"(q + g));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(Ks + off)),
                   "l"(k + g));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(Vs + off)),
                   "l"(v + g));
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Qs + off) = z;
      *reinterpret_cast<uint4*>(Ks + off) = z;
      *reinterpret_cast<uint4*>(Vs + off) = z;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;       // accumulator column pair within an n-tile
  const int lrow = lane / 4;       // accumulator row (and row + 8)
  const int mi = lane / 8;         // the 8x8 matrix this lane addresses
  const int mrow = lane % 8;       // the row of that matrix it addresses
  for (int m0 = warp * 16; m0 < T; m0 += kWarps * 16) {
    // -- S = q k^T for 16 query rows and all kRowsPad keys
    float s[2 * KT][4];
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaDh; kk += 16) {
      uint32_t a[4];  // matrices: (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8)
      ldmatrix_x4(a, Qs + (m0 + mrow + (mi % 2) * 8) * kMmaLd + kk + (mi / 2) * 8);
#pragma unroll
      for (int jt = 0; jt < KT; ++jt) {
        uint32_t bk[4];  // keys +0 (cols +0, +8), keys +8 (cols +0, +8)
        ldmatrix_x4(bk, Ks + (jt * 16 + mrow + (mi / 2) * 8) * kMmaLd + kk + (mi % 2) * 8);
        mma_bf16(s[2 * jt], a, bk[0], bk[1]);
        mma_bf16(s[2 * jt + 1], a, bk[2], bk[3]);
      }
    }
    // -- softmax of rows lrow (s[n][0..1]) and lrow + 8 (s[n][2..3])
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + quad * 2 + (e % 2);
        s[n][e] = j < T ? s[n][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mx[e / 2]);  // exp(-inf) = 0 for padded keys
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    // -- O = cast(p) v: key tile jt's A fragment is n-tiles 2 jt, 2 jt + 1
    float acc[kMmaDh / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaDh / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int jt = 0; jt < KT; ++jt) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * jt][0] / sum[0], s[2 * jt][1] / sum[0]);
      a[1] = pack_bf16(s[2 * jt][2] / sum[1], s[2 * jt][3] / sum[1]);
      a[2] = pack_bf16(s[2 * jt + 1][0] / sum[0], s[2 * jt + 1][1] / sum[0]);
      a[3] = pack_bf16(s[2 * jt + 1][2] / sum[1], s[2 * jt + 1][3] / sum[1]);
#pragma unroll
      for (int dp = 0; dp < kMmaDh; dp += 16) {
        uint32_t bv[4];  // cols +0 (keys +0, +8), cols +8 (keys +0, +8)
        ldmatrix_x4_trans(bv, Vs + (jt * 16 + mrow + (mi % 2) * 8) * kMmaLd + dp + (mi / 2) * 8);
        mma_bf16(acc[dp / 8], a, bv[0], bv[1]);
        mma_bf16(acc[dp / 8 + 1], a, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + lrow + 8 * r;
      if (row >= T) continue;
      __nv_bfloat16* out = o + ((row0 + row) * H + h) * kMmaDh + quad * 2;
#pragma unroll
      for (int n = 0; n < kMmaDh / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <int KT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int T,
                       int H, float scale, cudaStream_t s) {
  auto kernel = short_seq_attention_mma_kernel<KT>;
  const int smem = 3 * 16 * KT * kMmaLd * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, H, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, int B,
                         int T, int H, float scale, cudaStream_t s) {
  switch ((T + 15) / 16) {
    case 1: return launch_mma<1>(q, k, v, o, B, T, H, scale, s);
    case 2: return launch_mma<2>(q, k, v, o, B, T, H, scale, s);
    case 3: return launch_mma<3>(q, k, v, o, B, T, H, scale, s);
    case 4: return launch_mma<4>(q, k, v, o, B, T, H, scale, s);
    case 5: return launch_mma<5>(q, k, v, o, B, T, H, scale, s);
    case 6: return launch_mma<6>(q, k, v, o, B, T, H, scale, s);
    case 7: return launch_mma<7>(q, k, v, o, B, T, H, scale, s);
    default: return launch_mma<8>(q, k, v, o, B, T, H, scale, s);
  }
}

// -- the scalar path ---------------------------------------------------------------

int smem_bytes(int T, int Dh) {
  const int t4 = (T + 3) & ~3;
  return static_cast<int>(sizeof(float)) *
         (2 * T * (Dh + 4) + t4 * Dh + kWarps * kRows * t4);
}

template <typename Scalar, int NKC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int T,
                   int H, int Dh, float scale, cudaStream_t s) {
  auto kernel = short_seq_attention_kernel<Scalar, NKC>;
  const int smem = smem_bytes(T, Dh);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, s>>>(
      static_cast<const Scalar*>(q), static_cast<const Scalar*>(k),
      static_cast<const Scalar*>(v), static_cast<Scalar*>(o), T, H, Dh, scale);
  return cudaGetLastError();
}

template <typename Scalar>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int T,
                     int H, int Dh, float scale, cudaStream_t s) {
  switch ((T + 31) / 32) {
    case 1: return launch<Scalar, 1>(q, k, v, o, B, T, H, Dh, scale, s);
    case 2: return launch<Scalar, 2>(q, k, v, o, B, T, H, Dh, scale, s);
    case 3: return launch<Scalar, 3>(q, k, v, o, B, T, H, Dh, scale, s);
    default: return launch<Scalar, 4>(q, k, v, o, B, T, H, Dh, scale, s);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers to contiguous (B, T, H, Dh) tensors of one
// dtype (is_bf16: bf16, else f32), 16-byte aligned. Returns the cudaError_t
// of the launch (0 on success); cudaErrorInvalidValue for shapes outside
// 1 <= T <= 128, 8 <= Dh <= 128, Dh % 8 == 0.
int ic_short_seq_attention(const void* q, const void* k, const void* v, void* o, int B,
                           int T, int H, int Dh, float scale, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || T < 1 || T > kMaxT || Dh < 8 || Dh > kMaxDh || Dh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && Dh == kMmaDh)
    err = dispatch_mma(q, k, v, o, B, T, H, scale, s);
  else if (is_bf16)
    err = dispatch<__nv_bfloat16>(q, k, v, o, B, T, H, Dh, scale, s);
  else
    err = dispatch<float>(q, k, v, o, B, T, H, Dh, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
