// K6: the ResNet50 tower's inference BatchNorm, residual and ReLU in one pass.
//
// Replaces no TPU kernel: on the TPU, XLA fused each BatchNorm into its
// convolution's output. The port leaves the convolutions to cuDNN, and the
// float32 BatchNorm of models/resnet50.py (widen, subtract, multiply, add,
// narrow, then ReLU and the residual add, each its own PyTorch pass) moved
// about 40 bytes of device memory per activation element. This kernel reads
// each element once and writes it once.
//
// For x of shape (N, C, H, W) in channels_last memory (the channel is the
// innermost, contiguous index) it computes, per element of channel c,
//   y = round_out(((float(x) - mean[c]) * mul[c]) + bias[c])
// as three separately rounded float32 operations (the intrinsics below; the
// build also passes -fmad=false), rounded to the output dtype. Then, by mode:
//   kNone      nothing more;
//   kRaw       r = float(res), res the block's input in the output dtype;
//   kProjected r = round_out(((float(res) - rmean[c]) * rmul[c]) + rbias[c]),
//              res the projection conv's output in the input dtype,
// and y = round_out(float(y) + float(r)). Last, with relu, y = max(y, 0),
// NaN kept as it is. These are the rounding points of the plain twin
// (ops/bn_act.py:bn_act_plain), so kernel and twin agree bit for bit.
//
// What bounds it on this card: device-memory bytes. At the ResNet50 stem
// (512 x 64 x 112 x 112, bf16 in and out) one read and one write move 822 MB
// each, 0.49 ms at 3.35 TB/s; a few float operations per element are far
// below the card's rate.
//
// Design: a block of (C / 8, 256 / (C / 8)) threads; thread (tx, ty) owns the
// eight channels 8 tx .. 8 tx + 7 of pixel rows ty, ty + rows a block, ... in
// a grid-stride loop over N * H * W pixels. Its channels never change, so it
// loads its 8 (or, projected, 16) per-channel constants once into registers.
// Consecutive threads cover consecutive 16-byte chunks of memory: a bf16
// thread loads and stores 16 bytes, a float32 thread twice 16 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kVec = 8;             // channels a thread owns
constexpr int kBlockThreads = 256;  // threads a block (at most, see launch)
constexpr int kMaxChunks = kBlockThreads;  // C / 8 at most: one block row
constexpr int kBlocksPerSm = 8;     // grid cap for the grid-stride loop

enum Mode { kNone = 0, kRaw = 1, kProjected = 2 };

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// v already holds bf16-representable values (round_to below), so the
// conversion is exact.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

// The value x takes once stored as T and read back as float.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float normalize(float x, float mean, float mul, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

template <typename TIn, typename TOut, int kMode>
__global__ void __launch_bounds__(kBlockThreads)
    bn_act_kernel(const TIn* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ mul, const float* __restrict__ bias,
                  const void* __restrict__ residual, const float* __restrict__ rmean,
                  const float* __restrict__ rmul, const float* __restrict__ rbias,
                  TOut* __restrict__ out, long long pixels, int C, int relu) {
  // The residual's dtype follows from the mode: the block's input is in the
  // output dtype, the projection conv's output in the input dtype.
  using TRes = typename std::conditional<kMode == kRaw, TOut, TIn>::type;
  const TRes* res = static_cast<const TRes*>(residual);
  const int c0 = threadIdx.x * kVec;
  float m[kVec], k[kVec], b[kVec];
  load8(mean + c0, m);
  load8(mul + c0, k);
  load8(bias + c0, b);
  float rm[kVec], rk[kVec], rb[kVec];
  if (kMode == kProjected) {
    load8(rmean + c0, rm);
    load8(rmul + c0, rk);
    load8(rbias + c0, rb);
  }
  const TOut* tag = nullptr;  // selects round_to's overload
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
       p < pixels; p += step) {
    const long long off = p * C + c0;
    float v[kVec];
    load8(x + off, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = round_to(normalize(v[i], m[i], k[i], b[i]), tag);
    if (kMode != kNone) {
      float r[kVec];
      load8(res + off, r);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float ri = kMode == kProjected ? normalize(r[i], rm[i], rk[i], rb[i]) : r[i];
        v[i] = round_to(__fadd_rn(v[i], round_to(ri, tag)), tag);
      }
    }
    if (relu) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = isnan(v[i]) ? v[i] : fmaxf(v[i], 0.0f);
    }
    store8(out + off, v);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const float* mean, const float* mul, const float* bias,
                   const void* res, const float* rmean, const float* rmul,
                   const float* rbias, void* out, long long pixels, int C, int mode,
                   int relu, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int chunks = C / kVec;
  const int rows = kBlockThreads / chunks;
  const dim3 block(chunks, rows);
  const long long need = (pixels + rows - 1) / rows;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const dim3 grid(static_cast<unsigned>(need < cap ? need : cap));
  const TIn* xi = static_cast<const TIn*>(x);
  TOut* o = static_cast<TOut*>(out);
  if (mode == kNone)
    bn_act_kernel<TIn, TOut, kNone><<<grid, block, 0, s>>>(
        xi, mean, mul, bias, res, rmean, rmul, rbias, o, pixels, C, relu);
  else if (mode == kRaw)
    bn_act_kernel<TIn, TOut, kRaw><<<grid, block, 0, s>>>(
        xi, mean, mul, bias, res, rmean, rmul, rbias, o, pixels, C, relu);
  else
    bn_act_kernel<TIn, TOut, kProjected><<<grid, block, 0, s>>>(
        xi, mean, mul, bias, res, rmean, rmul, rbias, o, pixels, C, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (pixels, C) in channels_last order, bf16 (x_bf16) or float32; mean, mul,
// bias: float32 (C,). mode 0: no residual; 1: res (pixels, C), in out's
// dtype, added as it is; 2: res (pixels, C), in x's dtype, normalised with
// rmean, rmul, rbias first. out_bf16 gives out's dtype. Every pointer 16-byte
// aligned. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for C not a multiple of 8 or above 2048, pixels < 1,
// or a mode outside 0-2.
int ic_bn_act(const void* x, const void* mean, const void* mul, const void* bias,
              const void* res, const void* rmean, const void* rmul, const void* rbias,
              void* out, long long pixels, int C, int mode, int relu, int x_bf16,
              int out_bf16, void* stream) {
  if (pixels < 1 || C < kVec || C % kVec || C / kVec > kMaxChunks || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(mean),  static_cast<const float*>(mul),
                       static_cast<const float*>(bias),  static_cast<const float*>(rmean),
                       static_cast<const float*>(rmul),  static_cast<const float*>(rbias)};
  cudaError_t err;
  if (x_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, f[0], f[1], f[2], res, f[3], f[4], f[5],
                                               out, pixels, C, mode, relu, s);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, f[0], f[1], f[2], res, f[3], f[4], f[5], out,
                                       pixels, C, mode, relu, s);
  else if (out_bf16)
    err = launch<float, __nv_bfloat16>(x, f[0], f[1], f[2], res, f[3], f[4], f[5], out,
                                       pixels, C, mode, relu, s);
  else
    err = launch<float, float>(x, f[0], f[1], f[2], res, f[3], f[4], f[5], out, pixels,
                               C, mode, relu, s);
  return static_cast<int>(err);
}

}  // extern "C"
