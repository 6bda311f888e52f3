// Tiled bf16 x bf16 -> fp32 GEMM with a fused epilogue, under the MLP at
// widths that are not multiples of 8 (fused_mlp.cu, kernel 2: T2T's
// tokenizer) and the window attention block's four-launch route (kernel 6).
// Kernels 1, 2 (elsewhere), 7 and 8 run their products on the wgmma GEMM of
// gemm_sm90.cuh, which takes the activations (Act, activate) from here.
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
// Rows of A and B are copied 16 bytes at a time with cp.async when K and N
// are multiples of 8 and the operands 16-byte aligned; otherwise (T2T's
// tokenizer MLPs, D = F = 147 and 1323) with 2-byte loads, zero past K and N,
// into the same tiles: the arithmetic is the same either way.
// Design: 128x128x32 block tiles, a 3-stage cp.async ring in shared memory,
// 8 warps of WMMA 16x16x16 (each warp a 64x32 tile), and the epilogue
// through shared memory so the stores are coalesced. No split-K: each output
// row's reduction runs over K in one fixed order, so a request's logits do
// not depend on the batch it rides in. Later PRs move these kernels onto
// gemm_sm90.cuh (its epilogue takes the same activations), fuse the
// LayerNorm into the A-tile prologue, and walk the tiles with a persistent
// schedule.
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

// The 8 bf16 at columns [col, col + 8) of a row into shared memory with
// 2-byte loads, zero past `ncols` or when !ok: rows that are not 16-byte
// aligned.
__device__ __forceinline__ void copy8_narrow(bf16* smem, const bf16* row, bool ok, int col,
                                             int ncols) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(row);
  unsigned int w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col + 2 * j;
    const unsigned int lo = ok && c < ncols ? __ldg(s + c) : 0u;
    const unsigned int hi = ok && c + 1 < ncols ? __ldg(s + c + 1) : 0u;
    w[j] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(smem) = make_uint4(w[0], w[1], w[2], w[3]);
}

// kAligned: K and N multiples of 8 and A, B 16-byte aligned (cp.async rows);
// otherwise any K and N. M is free.
template <typename OutT, bool kAligned>
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
      if (kAligned) {
        const bool ok = gm < M && gk < K;
        cp_async16(as + r * A_LD + kc, ok ? A + (size_t)gm * K + gk : A, ok);
      } else {
        copy8_narrow(as + r * A_LD + kc, A + (size_t)(gm < M ? gm : 0) * K, gm < M, gk, K);
      }
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      if (kAligned) {
        const bool ok = gk < K && gn < N;
        cp_async16(bs + r * B_LD + nc, ok ? B + (size_t)gk * N + gn : B, ok);
      } else {
        copy8_narrow(bs + r * B_LD + nc, B + (size_t)(gk < K ? gk : 0) * N, gk < K, gn, N);
      }
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
  const bool aligned = K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(B) % 16 == 0;
  auto kernel = aligned ? gemm_bf16_kernel<OutT, true> : gemm_bf16_kernel<OutT, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(A, B, C, bias, residual, act, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
