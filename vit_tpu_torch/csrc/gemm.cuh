// Tiled bf16 x bf16 -> fp32 GEMM with a fused epilogue, shared by both kernels.
//
//   C[M, N] = round_once( act(A[M, K] @ B[K, N] + bias[N]) + residual[M, N] )
//
// A and B are row-major bf16; B is a weight in vit_tpu's [in, out] layout.
// The accumulator is fp32; bias (fp32) and residual (the output dtype) are
// added to it before the one rounding to the output dtype, as the TPU kernels
// do on their fp32 accumulators.
//
// Bound: compute. At ViT-L (M = B*197, K and N of 1024..4096) every product
// of the encoder is above the H100's ~295 FLOP/byte ridge from batch 8 up.
// Design: 128x128x32 block tiles, a 3-stage cp.async ring in shared memory,
// 8 warps of WMMA 16x16x16 (each warp a 64x32 tile), and the epilogue
// through shared memory so the stores are coalesced. No split-K: each output
// row's reduction runs over K in one fixed order, so a request's logits do
// not depend on the batch it rides in. Later PRs replace WMMA with wgmma fed
// by TMA, fuse the LayerNorm into the A-tile prologue, and walk the tiles
// with a persistent schedule.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vt {
namespace {

enum Act : int { kActNone = 0, kActGelu = 1, kActGeluExact = 2, kActHardSwish = 3 };

// The activations of vit_tpu/ops/fused_mlp.py:_activate, in JAX's op order.
__device__ __forceinline__ float activate(float h, int act) {
  switch (act) {
    case kActGelu:  // jax.nn.gelu(approximate=True)
      return h * (0.5f * (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * (h * h * h)))));
    case kActGeluExact:  // jax.nn.gelu(approximate=False)
      return h * (erff(h / 1.4142135623730951f) + 1.0f) / 2.0f;
    case kActHardSwish:
      return h * fminf(fmaxf(h + 3.0f, 0.0f), 6.0f) / 6.0f;
    default:
      return h;
  }
}

namespace gemm {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;  // +8 bf16 per row staggers shared-memory banks
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr size_t PIPE_BYTES = size_t(STAGES) * (A_STAGE + B_STAGE) * sizeof(bf16);
constexpr size_t C_BYTES = size_t(BM) * C_LD * sizeof(float);
constexpr size_t SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
}  // namespace gemm

// 16-byte global -> shared copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K and N must be multiples of 8 (16-byte rows of copy); M is free.
template <typename OutT>
__global__ void __launch_bounds__(gemm::THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, OutT* __restrict__ C,
                 const float* __restrict__ bias, const OutT* __restrict__ residual, int act,
                 int M, int N, int K) {
  using namespace nvcuda;
  using namespace gemm;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);  // reuses the ring after the loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async16(as + r * A_LD + kc, ok ? A + (size_t)gm * K + gk : A, ok);
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(bs + r * B_LD + nc, ok ? B + (size_t)gk * N + gn : B, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

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

    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * B_LD + wn * 32 + j * 16, B_LD);
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
      float v = Cs[r * C_LD + c];
      if (bias != nullptr) v += bias[gn];
      if (act != kActNone) v = activate(v, act);
      const size_t o = (size_t)gm * N + gn;
      if (residual != nullptr) v += to_f32(residual[o]);
      store_as(C + o, v);
    }
  }
}

template <typename OutT>
cudaError_t gemm_bf16(const bf16* A, const bf16* B, OutT* C, const float* bias,
                      const OutT* residual, int act, int M, int N, int K, cudaStream_t stream) {
  using namespace gemm;
  cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<OutT><<<grid, THREADS, SMEM_BYTES, stream>>>(A, B, C, bias, residual, act, M,
                                                                 N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
