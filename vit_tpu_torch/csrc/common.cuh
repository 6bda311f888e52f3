// Shared device helpers and the flax LayerNorm row kernel.
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

// Rows of x -> bf16 rows of y, one warp per row.
//
// With `scale` set: flax.linen.LayerNorm's exact formula in fp32 (fast
// variance, the scale folded into the reciprocal square root):
//   var = max(0, E[x^2] - mean^2); mul = rsqrt(var + eps) * scale;
//   y = (x - mean) * mul + bias.
// This is not F.layer_norm, whose two-pass variance rounds differently.
// With `scale` NULL the row is only rounded to bf16 (the MLP without LN).
//
// Memory-bound (reads D values, writes D bf16 per row). A later PR fuses
// this into the GEMM's A-tile prologue and drops the xn round trip.
template <typename T>
__global__ void ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               const float* __restrict__ bias, bf16* __restrict__ y,
                               int rows, int D, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  bf16* yr = y + (size_t)row * D;
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

template <typename T>
cudaError_t ln_rows(const T* x, const float* scale, const float* bias, bf16* y, int rows,
                    int D, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int kRowsPerBlock = kThreads / 32;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(x, scale, bias, y, rows, D, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
