// Tiled fp32 x fp32 -> fp32 GEMM on the CUDA cores, with a fused epilogue:
//
//   C[M, N] = act(A[M, K] @ B[K, N] + bias[N]) + residual[M, N]
//
// The fp32 route of the kernels whose TPU versions run fp32 weights at
// Precision.HIGHEST (vit_tpu/ops/fused_mlp.py:83-90,
// vit_tpu/ops/reattention_block.py:61, :176): kernel 2's two products and
// kernels 7 and 8's qkv and out products when x and the weights are fp32.
// Every operand stays fp32 and every product is an fp32 fused multiply-add:
// no TF32, no bf16 operand, no rounding but fp32's own. The later fp32 routes
// of kernels 1, 3, 6 and 9 take the same GEMM.
//
// A and B are row-major fp32; B is a weight in vit_tpu's [in, out] layout.
// bias is fp32 [N] (NULL: none), residual fp32 [M, N] (NULL: none).
//
// Bound: operations, 2 M N K over the card's fp32 rate (67 TFLOP/s on the
// H100 SXM5): at CaiT-S24/384's MLP (M = 73,728, K 384, N 1,536) the tile
// reads each operand ~K / 8 times from shared memory against 64 FMAs a load.
// Design (simple first): 128 x 128 block tiles over K steps of 8, 256 threads
// each owning an 8 x 8 block of outputs (rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, columns likewise, so that the float4 reads of the A and B panels in
// shared memory are conflict-free), the next K step's panels fetched into
// registers while this one is multiplied (two shared-memory buffers). A is
// stored transposed (k-major) in shared memory. Panels are read with 16-byte
// loads where K, N and the operand starts allow it (VEC), else one float at a
// time with bounds checks (T2T's tokenizer widths 147 and 1,323). Each output
// sums its K products in order k = 0..K-1, so a row's result does not depend
// on the batch it rides in.
#pragma once

#include "common.cuh"
#include "gemm.cuh"  // Act, activate

namespace vt {
namespace {

namespace gemmf32 {
constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;
}

template <bool VEC>
__global__ void __launch_bounds__(gemmf32::THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                const float* __restrict__ bias, const float* __restrict__ residual, int act, int M,
                int N, int K) {
  using namespace gemmf32;
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // loaders: A row m0 + t / 2, k cols (t % 2) * 4 + 0..3; B row t / 32, cols (t % 32) * 4 + 0..3
  const int a_row = t / 2, a_col = (t % 2) * 4, b_row = t / 32, b_col = (t % 32) * 4;
  float ra[4], rb[4];
  const auto fetch = [&](int k0) {
    const int am = m0 + a_row, ak = k0 + a_col, bk = k0 + b_row, bn = n0 + b_col;
    if (VEC && am < M && ak + 3 < K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(A + (size_t)am * K + ak));
      ra[0] = v.x, ra[1] = v.y, ra[2] = v.z, ra[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = am < M && ak + i < K ? __ldg(A + (size_t)am * K + ak + i) : 0.f;
    }
    if (VEC && bk < K && bn + 3 < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(B + (size_t)bk * N + bn));
      rb[0] = v.x, rb[1] = v.y, rb[2] = v.z, rb[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rb[i] = bk < K && bn + i < N ? __ldg(B + (size_t)bk * N + bn + i) : 0.f;
    }
  };
  const auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][a_col + i][a_row] = ra[i];
    *reinterpret_cast<float4*>(&Bs[buf][b_row][b_col]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = (K + BK - 1) / BK;
  fetch(0);
  put(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) fetch((s + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < steps) {
      put(buf ^ 1);  // the other buffer: every thread finished reading it a step ago
      __syncthreads();
    }
  }

  // epilogue: bias, activation, residual on the fp32 sums, four columns at a time
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n + j;
        float h = acc[i][half * 4 + j];
        if (c < N) {
          if (bias != nullptr) h += bias[c];
          if (act != kActNone) h = activate(h, act);
          if (residual != nullptr) h += residual[(size_t)m * N + c];
        }
        v[j] = h;
      }
      float* out = C + (size_t)m * N + n;
      if (VEC && n + 3 < N) {
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) out[j] = v[j];
      }
    }
  }
}

// C = act(A @ B + bias) + residual in fp32 on the current stream.
inline cudaError_t gemm_f32(const float* A, const float* B, float* C, const float* bias,
                            const float* residual, int act, int M, int N, int K,
                            cudaStream_t stream) {
  using namespace gemmf32;
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned(A) && aligned(B) && aligned(C) &&
                   aligned(residual);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (vec)
    gemm_f32_kernel<true><<<grid, THREADS, 0, stream>>>(A, B, C, bias, residual, act, M, N, K);
  else
    gemm_f32_kernel<false><<<grid, THREADS, 0, stream>>>(A, B, C, bias, residual, act, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
