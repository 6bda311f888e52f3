// Shared device helpers, the flax LayerNorm row kernel, and the int8 row
// quantizers.
//
// Everything here has internal linkage (anonymous namespace): each .cu file
// of the library gets its own copy, so the translation units link without
// relocatable device code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {
namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
// __float2bfloat16 rounds to nearest even, as JAX's astype(bfloat16).
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// cp.async: 16 bytes global -> shared, bypassing L1, zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
// The copies issued since the last commit become one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N groups (the newest) are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One row of x -> one row of y (bf16, or fp32 on the fp32 routes of kernels 2,
// 7 and 8), by one warp (lane `lane` of 32).
//
// With `scale` set: flax.linen.LayerNorm's exact formula in fp32 (fast
// variance, the scale folded into the reciprocal square root):
//   var = max(0, E[x^2] - mean^2); mul = rsqrt(var + eps) * scale;
//   y = (x - mean) * mul + bias.
// This is not F.layer_norm, whose two-pass variance rounds differently.
// With `scale` NULL the row is only converted to y's type (the MLP without
// LN). y may lie in shared memory (the fused window block's xn tile).
template <typename T, typename Y>
__device__ __forceinline__ void ln_row(const T* __restrict__ xr, const float* __restrict__ scale,
                                       const float* __restrict__ bias, Y* yr, int D, float eps,
                                       int lane) {
  if (scale == nullptr) {
    for (int c = lane; c < D; c += 32) store_as(yr + c, to_f32(xr[c]));
    return;
  }
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / D;
  const float var = fmaxf(0.f, ss / D - mean * mean);
  const float inv = 1.0f / sqrtf(var + eps);
  for (int c = lane; c < D; c += 32) {
    const float mul = inv * scale[c];
    const float b = bias != nullptr ? bias[c] : 0.f;
    store_as(yr + c, (to_f32(xr[c]) - mean) * mul + b);
  }
}

// Rows of x -> rows of y (ln_row), one warp per row. Memory-bound (reads D
// values, writes D per row).
template <typename T, typename Y>
__global__ void ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               const float* __restrict__ bias, Y* __restrict__ y,
                               int rows, int D, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= rows) return;
  ln_row(x + (size_t)row * D, scale, bias, y + (size_t)row * D, D, eps, threadIdx.x % 32);
}

template <typename T, typename Y>
cudaError_t ln_rows(const T* x, const float* scale, const float* bias, Y* y, int rows,
                    int D, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int kRowsPerBlock = kThreads / 32;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_rows_kernel<T, Y><<<blocks, kThreads, 0, stream>>>(x, scale, bias, y, rows, D, eps);
  return cudaGetLastError();
}

// -- the repo's one symmetric int8 recipe (vit_tpu/ops/quant.py:31-46) ------
//   scale = max(amax, 1e-12) / 127;  code = clip(round_half_even(v / scale), +-127)
// A true division (not v * (127 / amax)) and rintf (half to even; roundf
// rounds half away from zero), so the codes are the JAX package's.
__device__ __forceinline__ float row_quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}
__device__ __forceinline__ int8_t quant_code(float v, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f));
}

// One flax LayerNorm value with every rounding spelled out (no fused
// multiply-add), as the twins compute it op by op: (x - mean) * (inv * s) + b.
__device__ __forceinline__ float ln_value(float x, float mean, float inv, float s, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), __fmul_rn(inv, s)), b);
}

// Rows of x -> flax LayerNorm in fp32 -> int8 codes + one fp32 scale per row,
// one warp per row: the int8 blocks' "LN then quant" (quant_block.py:59-65,
// :205-209). The LN output is quantized from fp32, never rounded to bf16
// first (that would move codes). The row is read three times (statistics,
// amax, codes); the second and third reads hit L1. Memory-bound.
template <typename T>
__global__ void ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                     const float* __restrict__ bias, int8_t* __restrict__ q,
                                     float* __restrict__ row_scale, int rows, int D, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = __fdiv_rn(s, static_cast<float>(D));
  const float var = fmaxf(0.f, __fsub_rn(__fdiv_rn(ss, static_cast<float>(D)), __fmul_rn(mean, mean)));
  const float inv = __fdiv_rn(1.0f, sqrtf(var + eps));
  float amax = 0.f;
  for (int c = lane; c < D; c += 32)
    amax = fmaxf(amax, fabsf(ln_value(to_f32(xr[c]), mean, inv, scale[c], bias[c])));
  const float rs = row_quant_scale(warp_max(amax));
  if (lane == 0) row_scale[row] = rs;
  int8_t* qr = q + (size_t)row * D;
  for (int c = lane; c < D; c += 32)
    qr[c] = quant_code(ln_value(to_f32(xr[c]), mean, inv, scale[c], bias[c]), rs);
}

// Rows of an fp32 activation -> int8 codes + row scales, one warp per row
// (quant_block.py:101 and :218: the attention output and the GELU hidden,
// whose row max spans every head / all of the hidden width). Memory-bound.
__global__ void quant_rows_kernel(const float* __restrict__ v, int8_t* __restrict__ q,
                                  float* __restrict__ row_scale, int rows, int K) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* vr = v + (size_t)row * K;
  float amax = 0.f;
  for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(vr[c]));
  const float rs = row_quant_scale(warp_max(amax));
  if (lane == 0) row_scale[row] = rs;
  int8_t* qr = q + (size_t)row * K;
  for (int c = lane; c < K; c += 32) qr[c] = quant_code(vr[c], rs);
}

template <typename T>
cudaError_t ln_quant_rows(const T* x, const float* scale, const float* bias, int8_t* q,
                          float* row_scale, int rows, int D, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  ln_quant_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(x, scale, bias, q, row_scale, rows, D,
                                                           eps);
  return cudaGetLastError();
}

inline cudaError_t quant_rows(const float* v, int8_t* q, float* row_scale, int rows, int K,
                              cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  quant_rows_kernel<<<blocks, kThreads, 0, stream>>>(v, q, row_scale, rows, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
