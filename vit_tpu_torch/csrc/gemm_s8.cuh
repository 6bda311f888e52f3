// Tiled int8 x int8 -> int32 GEMM with a dequant epilogue, under the W8A8
// MLP (quant_block.cu, kernel 10). The W8A8 attention block (kernel 9) runs
// its products on the s8 wgmma GEMM of gemm_s8_sm90.cuh, which keeps this
// epilogue's op order; kernel 10 moves there in its own PR.
//
//   acc[M, N] = A[M, K] @ B[K, N]                      (int32, exact)
//   C = round_once( act((acc * s_row[m]) * s_col[n] + bias[n]) + residual )
//
// A holds per-row int8 codes (the quantized activations), B a weight's
// per-output-channel int8 codes in vit_tpu's [in, out] = [K, N] layout, as
// stored; no transposed copy is kept. The tensor-core int8 product wants B
// K-major; WMMA's row-major signed-char B fragment does that transpose on
// the way from shared memory into registers.
//
// The epilogue follows the TPU kernels' op order (quant_block.py:70, :103-105,
// :211, :220-221): the int32 sum to fp32, times the row scale, times the
// column scale, plus the bias, the activation, plus the residual in fp32,
// one rounding to the output type. Each step is an explicit round-to-nearest
// intrinsic, so no fused multiply-add makes it differ from the twins' ops.
// OutT = int32_t skips the epilogue and stores the raw sums (the exactness
// check against torch._int_mm).
//
// Bound: compute. At ViT-L (M = B*197, K and N of 1024..4096) each product
// is far above the int8 ridge (~590 op/byte) from batch 8 up. Design: the
// structure of the bf16 GEMM (gemm.cuh) with int8 operands: 128x128x64
// block tiles, a 3-stage cp.async ring, 8 warps of WMMA 16x16x16 (each warp
// a 64x32 tile). In shared memory
// every operand is kept in 16-byte-wide column panels, so that each 16x16
// WMMA tile is 256 contiguous bytes (load_matrix_sync wants 32-byte-aligned
// tiles; a 16-byte K step of a row-major int8 tile would not be). No split-K,
// so results are batch-invariant.
#pragma once

#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "gemm.cuh"

namespace vt {
namespace {

namespace s8 {
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int A_STAGE = BM * BK;  // bytes: [BK/16][BM][16]
constexpr int B_STAGE = BK * BN;  // bytes: [BN/16][BK][16]
constexpr int C_LD = BN + 4;      // int32 staging row
constexpr size_t PIPE_BYTES = size_t(STAGES) * (A_STAGE + B_STAGE);
constexpr size_t C_BYTES = size_t(BM) * C_LD * sizeof(int);
constexpr size_t SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
}  // namespace s8

// K and N must be multiples of 16 (16-byte rows of copy); M is free.
template <typename OutT>
__global__ void __launch_bounds__(s8::THREADS)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, OutT* __restrict__ C,
               const float* __restrict__ s_row, const float* __restrict__ s_col,
               const float* __restrict__ bias, const OutT* __restrict__ residual, int act, int M,
               int N, int K) {
  using namespace nvcuda;
  using namespace s8;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + STAGES * A_STAGE;
  int* Cs = reinterpret_cast<int*>(smem);  // reuses the ring after the loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    int8_t* as = As + stage * A_STAGE;
    int8_t* bs = Bs + stage * B_STAGE;
    for (int c = tid; c < BM * (BK / 16); c += THREADS) {
      const int r = c / (BK / 16), kc = c % (BK / 16);
      const int gm = m0 + r, gk = k0 + kc * 16;
      const bool ok = gm < M && gk < K;
      cp_async16(as + kc * (BM * 16) + r * 16, ok ? A + (size_t)gm * K + gk : A, ok);
    }
    for (int c = tid; c < BK * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16), nc = c % (BN / 16);
      const int gk = k0 + r, gn = n0 + nc * 16;
      const bool ok = gk < K && gn < N;
      cp_async16(bs + nc * (BK * 16) + r * 16, ok ? B + (size_t)gk * N + gn : B, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... and every warp is done with tile kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_tile(nk % STAGES, nk);
    cp_async_commit();

    const int8_t* as = As + (kt % STAGES) * A_STAGE;
    const int8_t* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + kk * (BM * 16) + (wm * 64 + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + (wn * 2 + j) * (BK * 16) + kk * 16 * 16, 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      const size_t o = (size_t)gm * N + gn;
      if constexpr (std::is_same<OutT, int32_t>::value) {
        C[o] = Cs[r * C_LD + c];
      } else {
        float v = __fmul_rn(__fmul_rn(static_cast<float>(Cs[r * C_LD + c]), s_row[gm]), s_col[gn]);
        if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
        if (act != kActNone) v = activate(v, act);
        if (residual != nullptr) v = __fadd_rn(v, to_f32(residual[o]));
        store_as(C + o, v);
      }
    }
  }
}

template <typename OutT>
cudaError_t gemm_s8(const int8_t* A, const int8_t* B, OutT* C, const float* s_row,
                    const float* s_col, const float* bias, const OutT* residual, int act, int M,
                    int N, int K, cudaStream_t stream) {
  using namespace s8;
  if (K % 16 != 0 || N % 16 != 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gemm_s8_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_s8_kernel<OutT><<<grid, THREADS, SMEM_BYTES, stream>>>(A, B, C, s_row, s_col, bias,
                                                               residual, act, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
