// int8 x int8 -> int32 GEMM for Hopper on wgmma fed by TMA, with a dequant
// epilogue:
//
//   acc[M, N] = A[M, K] @ B[N, K]^T                    (int32, exact)
//   C = round_once( act((acc * s_row[m]) * s_col[n] + bias[n]) + residual )
//
// A holds per-row int8 codes (the quantized activations), row-major [M, K].
// B holds a weight's per-output-channel codes K-major, [N, K]: the transpose
// of vit_tpu's [in, out] = [K, N] layout. Hopper's 8-bit wgmma reads both
// operands K-major (its transpose bits exist only for 16-bit types), so the
// owner of the weight keeps a K-major copy (QuantViT derives one when it is
// built or loaded); nothing is transposed per call. The epilogue keeps the
// TPU kernels' op order (quant_block.py:70, :103-105, :211, :220-221): the
// int32 sum to fp32, __fmul_rn by the row scale, then by the column scale, +
// bias, activation, + residual in fp32, one rounding to OutT. OutT = int32_t
// stores the raw sums (the exactness check against torch._int_mm).
//
// kRowMax (kernel 10's fc1 only): the epilogue also writes, for each row of
// the tile, max |C| over the tile's BN columns to amax_part[row * gridDim.x +
// blockIdx.x]. The next pass takes the max of a row's partials and quantizes
// the row with one read of it; a max is exact in any order, so its codes and
// scale are those of a whole-row quantizer. Kernel 9's instantiations have
// kRowMax false and compile to the code they had without it.
//
// Bound: compute. Kernel 9's qkv product at ViT-L batch 128 is 25,216 x
// 3,072 x 1,024 (159 G int8 ops), far above the H100's ~590 op/byte int8
// ridge; WMMA 16x16x16 fragments fed by cp.async reached ~175 TOPS of the
// 1,979 TOP/s peak (NVIDIA H100 80GB HBM3, 700.00 W), and only wgmma
// reaches the rest.
//
// Design: gemm_sm90.cuh's, with 8-bit operands. One block computes a 128 x
// 128 tile of C over BK = 128 K-bytes a slice.
// - Two consumer warpgroups and a producer warp (288 threads, 97 KB of shared
//   memory: two blocks an SM). Each consumer warpgroup owns an m64 slab and
//   issues wgmma.mma_async m64n128k32 .s32.s8.s8 (int32 accumulators in 64
//   registers a thread), A and B read from shared memory through matrix
//   descriptors. One producer thread issues TMA 2-D loads into a 3-stage
//   ring, each stage guarded by a full and an empty mbarrier.
// - Layouts. Both boxes are 128 K-bytes x 128 rows (16 KB) with TMA's 128-byte
//   swizzle: K-major, the canonical SW128 layout, 8-row atoms 1024 B apart
//   (SBO), a k32 step 32 B along the row, for A and for B alike.
// - Tails. M is free; N and K must be multiples of 16 (TMA's 16-byte global
//   strides) and every operand 16-byte aligned. TMA zero-fills the rows and
//   columns past M, N and K, so a partial tile adds zeros; the epilogue masks
//   its stores at M and N (and, with kRowMax, lets the lanes past N join the
//   row's warp max with 0).
// - Epilogue: the int32 accumulators go to the free ring; each warp then
//   walks its rows four columns a lane, so scale, bias and residual loads and
//   the output stores cover whole rows.
// - No split-K and one fixed K order: the sums are exact and a row's do not
//   depend on the other rows, so the product is batch-invariant.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "gemm_sm90.cuh"  // g90: mbarriers, TMA, wgmma fences, SW128 descriptors, tensor maps

namespace vt {
namespace {

namespace s8_90 {
constexpr int BM = 128, BN = 128, BK = 128, STAGES = 3, CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;  // two consumer warpgroups and a producer warp
constexpr uint32_t A_BYTES = BM * BK;          // 16 KB
constexpr uint32_t B_BYTES = BN * BK;          // 16 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int C_LD = BN + 8;  // int32 staging row: conflict-free int2 writes per half-warp
static_assert(size_t(BM) * C_LD * 4 <= size_t(STAGES) * STAGE_BYTES, "C tile fits the ring");
constexpr size_t SMEM_BYTES = size_t(STAGES) * STAGE_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 32] (K-major) @ B[128 x 32]^T (K-major), int8 in, int32 sums.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Four consecutive outputs of a row: the dequant epilogue's values, stored.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p + 2) = __floats2bfloat162_rn(c, d);
}
}  // namespace s8_90

template <typename OutT, bool kRowMax = false>
__global__ void __launch_bounds__(s8_90::THREADS, 1)
gemm_s8_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b, OutT* __restrict__ C,
                    const float* __restrict__ s_row, const float* __restrict__ s_col,
                    const float* __restrict__ bias, const OutT* __restrict__ residual, int act,
                    float* __restrict__ amax_part, int M, int N, int K) {
  using namespace s8_90;
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
      g90::mbar_init(full + 8 * s, 1);
      g90::mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        g90::mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);  // passes at once in round 0
        const uint32_t stage = base + s * STAGE_BYTES, bar = full + 8 * s;
        g90::mbar_expect_tx(bar, STAGE_BYTES);
        g90::tma_load_2d(stage, &tma_a, bar, kt * BK, m0);
        g90::tma_load_2d(stage + A_BYTES, &tma_b, bar, kt * BK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    g90::mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + wg * (64 * BK);
    const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
    fence_acc(d);
    g90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 32; ++k)
      wgmma_m64n128k32_s8(d, g90::sw128_desc(a + 32 * k, 16, 1024),
                          g90::sw128_desc(b + 32 * k, 16, 1024));
    g90::wgmma_commit();
    fence_acc(d);
    g90::wgmma_wait<1>();  // the group of slice kt - 1 has retired: release its stage
    if (kt > 0 && threadIdx.x % 128 == 0) g90::mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  g90::wgmma_wait<0>();
  fence_acc(d);

  // Epilogue. Both consumer warpgroups are past their last wgmma, so the ring
  // is free: each warp stages its 16 int32 rows there (d[4j + {0, 1}] is (r,
  // c + {0, 1}), d[4j + {2, 3}] is (r + 8, c + {0, 1}), r = lane / 4, c = 8 j
  // + 2 (lane % 4)), then walks them, four columns a lane.
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
  int* stage_c = reinterpret_cast<int*>(smem_raw + (base - raw)) + wg * 64 * C_LD;
  const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int* p = stage_c + (16 * warp + lane / 4 + 8 * h) * C_LD + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<int2*>(p) = make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  __syncwarp();
  const int col = n0 + 4 * lane;  // N % 16 == 0: col < N covers col + 3
  const bool live = col < N;
  if constexpr (!kRowMax) {
    if (!live) return;
  }
  float4 sc = make_float4(0.f, 0.f, 0.f, 0.f), bv = sc;
  if constexpr (!std::is_same<OutT, int32_t>::value) {
    if (live) {
      sc = *reinterpret_cast<const float4*>(s_col + col);
      if (bias != nullptr) bv = *reinterpret_cast<const float4*>(bias + col);
    }
  }
  for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
    const int row = m0 + wg * 64 + r;
    if (row >= M) break;  // the same for the whole warp
    const size_t o = (size_t)row * N + col;
    if constexpr (std::is_same<OutT, int32_t>::value) {
      *reinterpret_cast<int4*>(C + o) = *reinterpret_cast<const int4*>(stage_c + r * C_LD + 4 * lane);
    } else {
      float amax = 0.f;  // lanes past N join the row's max with 0
      if (live) {
        const int4 acc = *reinterpret_cast<const int4*>(stage_c + r * C_LD + 4 * lane);
        const float sr = s_row[row];
        float v[4] = {__fmul_rn(__fmul_rn(static_cast<float>(acc.x), sr), sc.x),
                      __fmul_rn(__fmul_rn(static_cast<float>(acc.y), sr), sc.y),
                      __fmul_rn(__fmul_rn(static_cast<float>(acc.z), sr), sc.z),
                      __fmul_rn(__fmul_rn(static_cast<float>(acc.w), sr), sc.w)};
        if (bias != nullptr)
          v[0] = __fadd_rn(v[0], bv.x), v[1] = __fadd_rn(v[1], bv.y),
          v[2] = __fadd_rn(v[2], bv.z), v[3] = __fadd_rn(v[3], bv.w);
        if (act != kActNone) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = activate(v[i], act);
        }
        if (residual != nullptr) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], to_f32(residual[o + i]));
        }
        store4(C + o, v[0], v[1], v[2], v[3]);
        if constexpr (kRowMax)
          amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
      }
      if constexpr (kRowMax) {
        amax = warp_max(amax);
        if (lane == 0) amax_part[(size_t)row * gridDim.x + blockIdx.x] = amax;
      }
    }
  }
}

// A row-major int8 [rows, cols] matrix read in boxes of box_cols x box_rows
// bytes with the 128-byte swizzle; elements past the edges read as zero.
inline bool encode_sw128_s8(CUtensorMap* map, const int8_t* ptr, int rows, int cols, int box_cols,
                            int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [M, K] int8 row-major, B [N, K] int8 (K-major), C [M, N] of OutT. With
// kRowMax, amax_part [M, ceil(N / 128)] fp32 receives each row's max |C| by
// 128-column tile (gemm_s8_sm90_parts gives the count).
inline int gemm_s8_sm90_parts(int N) { return (N + s8_90::BN - 1) / s8_90::BN; }

template <typename OutT, bool kRowMax = false>
cudaError_t gemm_s8_sm90(const int8_t* A, const int8_t* B, OutT* C, const float* s_row,
                         const float* s_col, const float* bias, const OutT* residual, int act,
                         int M, int N, int K, cudaStream_t stream, float* amax_part = nullptr) {
  using namespace s8_90;
  static_assert(!(kRowMax && std::is_same<OutT, int32_t>::value), "row max of a dequant output");
  const auto misaligned = [](const void* p) {
    return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (M < 1 || N < 1 || K < 1 || N % 16 || K % 16 || (M + BM - 1) / BM > 65535 || A == nullptr ||
      B == nullptr || misaligned(A) || misaligned(B) || misaligned(C) || misaligned(s_col) ||
      misaligned(bias) || misaligned(residual) || (kRowMax && amax_part == nullptr))
    return cudaErrorInvalidValue;
  if (!std::is_same<OutT, int32_t>::value && (s_row == nullptr || s_col == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tma_a, tma_b;
  if (!encode_sw128_s8(&tma_a, A, M, K, BK, BM) || !encode_sw128_s8(&tma_b, B, N, K, BK, BN))
    return cudaErrorInvalidValue;
  const auto kernel = gemm_s8_sm90_kernel<OutT, kRowMax>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid(gemm_s8_sm90_parts(N), (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(tma_a, tma_b, C, s_row, s_col, bias, residual,
                                                act, amax_part, M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
