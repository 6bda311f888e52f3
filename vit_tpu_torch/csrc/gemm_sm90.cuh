// bf16 x bf16 -> fp32 GEMM for Hopper on wgmma fed by TMA, with the fused
// epilogue of gemm.cuh:
//
//   C[M, N] = round_once( act(A[M, K] @ B[K, N] + bias[N]) + residual[M, N] )
//
// A is row-major bf16 (activations); B is a weight in vit_tpu's [in, out]
// layout, row-major [K, N]. bias is fp32, residual has C's type, and the fp32
// adds run in that order before the one rounding to OutT (bf16 or fp32), as
// gemm_bf16 and the TPU kernels do on their fp32 accumulators. It serves the
// two products of the float attention block (attention_block.cu, kernel 1).
//
// Bound: compute. Kernel 1's qkv product at ViT-L batch 128 is 25,216 x
// 3,072 x 1,024 (158.6 GFLOP), far above the H100's ~295 FLOP/byte ridge;
// gemm.cuh's WMMA 16x16x16 fragments fed by cp.async reach ~16% of the 989
// TFLOP/s bf16 peak, and only wgmma reaches the rest.
//
// Design: one block computes a 128 x 128 tile of C over BK = 64 slices of K.
// - Two consumer warpgroups and a producer warp (288 threads, 90 registers,
//   97 KB of shared memory: two blocks an SM). Each consumer warpgroup owns an
//   m64 slab and issues wgmma.mma_async m64n128k16 (fp32 accumulators in 64
//   registers a thread), A and B read from shared memory through matrix
//   descriptors. One thread of the producer warp issues TMA 2-D loads
//   (cp.async.bulk.tensor) into a 3-stage ring, each stage guarded by a full
//   and an empty mbarrier. The consumers keep one wgmma group in flight and
//   release a stage when the group that read it has retired.
// - Layouts. A's box is 64 K-columns (128 bytes) x 128 rows with TMA's
//   128-byte swizzle: K-major, the canonical SW128 layout, 8-row atoms 1024 B
//   apart (SBO), a k16 step 32 B along the row. B [K, N] has N contiguous:
//   MN-major, read with wgmma's transpose-B bit. A 128-column N tile arrives
//   as two boxes of 64 N-columns (128 B) x 64 K-rows, 8 KB apart, each with
//   the 128-byte swizzle: an MN atom is 64 columns x 8 K-rows (1024 B), the
//   next 64 columns are LBO = 8 KB away, the next 8 K-rows SBO = 1 KB, and a
//   k16 step is 16 K-rows (2 KB). Every stage is 1024-byte aligned, so the
//   swizzle phase of each atom is 0.
// - Tails. M is free; N and K must be multiples of 8 (TMA's 16-byte global
//   strides) and every operand 16-byte aligned. TMA zero-fills the rows and
//   columns past M, N and K, so a partial tile adds zeros; the epilogue
//   masks its stores at M and N.
// - The tensor maps are encoded on the host for each call (the activation
//   pointers change) with cuTensorMapEncodeTiled, fetched through
//   cudaGetDriverEntryPoint so the library needs no -lcuda, and passed as
//   __grid_constant__ parameters.
// - Epilogue: the accumulators go to the free ring as an fp32 tile; then
//   each warp walks its rows four columns a lane (bias, activation, residual
//   in fp32, one rounding), so residual loads and output stores cover whole
//   rows. In development sweeps on the card, stores straight from the
//   accumulator layout (8 rows of 16 bytes a warp instruction), a 4-stage
//   ring (one block an SM) and 128 x 256 tiles (m64n256k16) were each
//   slower.
// - No split-K and one fixed K order: a row's sums do not depend on the
//   other rows of A or on the tile, so the product is batch-invariant.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "gemm.cuh"  // Act, activate

namespace vt {
namespace {

namespace g90 {
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;  // two consumer warpgroups and a producer warp
constexpr int BOX_N = 64;                      // B columns a TMA box (128 bytes)
constexpr uint32_t A_BYTES = BM * BK * 2;      // 16 KB
constexpr uint32_t B_BOX_BYTES = BK * BOX_N * 2;  // 8 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + (BN / BOX_N) * B_BOX_BYTES;
constexpr int C_LD = BN + 8;  // fp32 staging row: conflict-free float2 writes per half-warp
static_assert(size_t(BM) * C_LD * 4 <= size_t(STAGES) * STAGE_BYTES, "C tile fits the ring");
constexpr size_t SMEM_BYTES = size_t(STAGES) * STAGE_BYTES + 1024 + 2 * STAGES * 8;

// Matrix descriptor of a 128-byte-swizzled operand in shared memory
// (address, leading and stride byte offsets in 16-byte units; layout 1 =
// 128-byte swizzle in bits 62-63).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The box at (c0 innermost, c1) of `map` into shared memory at `dst`,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
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
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] (K-major) @ B[16 x 128] (MN-major: transpose-B).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
}  // namespace g90

template <typename OutT>
__global__ void __launch_bounds__(g90::THREADS, 1)
gemm_bf16_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b, OutT* __restrict__ C,
                      const float* __restrict__ bias, const OutT* __restrict__ residual, int act,
                      int M, int N, int K) {
  using namespace g90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // stages 1024-byte aligned (swizzle atoms)
  const uint32_t full = base + STAGES * STAGE_BYTES;
  const uint32_t empty = full + STAGES * 8;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);  // passes at once in round 0
        const uint32_t stage = base + s * STAGE_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(stage, &tma_a, bar, kt * BK, m0);
#pragma unroll
        for (int h = 0; h < BN / BOX_N; ++h)
          tma_load_2d(stage + A_BYTES + h * B_BOX_BYTES, &tma_b, bar, n0 + h * BOX_N, kt * BK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + wg * (64 * BK * 2);
    const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_m64n128k16(d, sw128_desc(a + 32 * k, 16, 1024),
                       sw128_desc(b + k * 16 * BOX_N * 2, B_BOX_BYTES, 1024));
    wgmma_commit();
    fence_acc(d);
    wgmma_wait<1>();  // the group of slice kt - 1 has retired: release its stage
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(d);

  // Epilogue. Both consumer warpgroups are past their last wgmma, so the ring
  // is free: each warp stages its 16 fp32 rows there (d[4j + {0, 1}] is (r, c
  // + {0, 1}), d[4j + {2, 3}] is (r + 8, c + {0, 1}), r = lane / 4, c = 8 j +
  // 2 (lane % 4)), then walks them, four columns a lane, so the residual
  // loads and the output stores cover whole rows.
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  float* stage_c = reinterpret_cast<float*>(smem_raw + (base - raw)) + wg * 64 * C_LD;
  const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = stage_c + (16 * warp + lane / 4 + 8 * h) * C_LD + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(p) = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  __syncwarp();
  const int col = n0 + 4 * lane;  // N % 8 == 0: col < N covers col + 3
  if (col >= N) return;
  float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) bv = *reinterpret_cast<const float4*>(bias + col);
  for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
    const int row = m0 + wg * 64 + r;
    if (row >= M) break;
    float4 v = *reinterpret_cast<const float4*>(stage_c + r * C_LD + 4 * lane);
    if (bias != nullptr) v.x += bv.x, v.y += bv.y, v.z += bv.z, v.w += bv.w;
    if (act != kActNone) {
      v.x = activate(v.x, act), v.y = activate(v.y, act);
      v.z = activate(v.z, act), v.w = activate(v.w, act);
    }
    const size_t o = (size_t)row * N + col;
    if (residual != nullptr) {
      const float2 r01 = load2(residual + o), r23 = load2(residual + o + 2);
      v.x += r01.x, v.y += r01.y, v.z += r23.x, v.w += r23.y;
    }
    store2(C + o, v.x, v.y);
    store2(C + o + 2, v.z, v.w);
  }
}

using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no libcuda link).
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, cols] matrix read in boxes of box_cols x box_rows
// with the 128-byte swizzle; elements past the edges read as zero.
inline bool encode_sw128(CUtensorMap* map, const bf16* ptr, int rows, int cols, int box_cols,
                         int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
cudaError_t gemm_bf16_sm90(const bf16* A, const bf16* B, OutT* C, const float* bias,
                           const OutT* residual, int act, int M, int N, int K,
                           cudaStream_t stream) {
  using namespace g90;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 8 || (M + BM - 1) / BM > 65535 || misaligned(A) ||
      misaligned(B) || misaligned(C) || (bias != nullptr && misaligned(bias)) ||
      (residual != nullptr && misaligned(residual)))
    return cudaErrorInvalidValue;
  CUtensorMap tma_a, tma_b;
  if (!encode_sw128(&tma_a, A, M, K, BK, BM) || !encode_sw128(&tma_b, B, K, N, BOX_N, BK))
    return cudaErrorInvalidValue;
  const auto kernel = gemm_bf16_sm90_kernel<OutT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(tma_a, tma_b, C, bias, residual, act, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
