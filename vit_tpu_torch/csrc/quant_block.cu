// The two W8A8 encoder kernels for Hopper.
//
// Replace vit_tpu/ops/quant_block.py::_kernel (the W8A8 attention block) and
// ::_mlp_kernel (the W8A8 MLP), the Pallas TPU kernels. On the TPU each is one
// program with the int8 weight tables resident in VMEM and every quantize /
// dequantize pair in VMEM. An H100 block has 227 KB of shared memory, and the
// activations are quantized per row over rows that span many tiles (the
// attention output over all H*Dh columns, across every head; the GELU hidden
// over all 4096 columns, 16 KB of fp32 a token at ViT-L), so each op splits
// where the TPU kernel itself quantizes or rounds, and the fp32 rows it
// quantizes are written out whole and quantized in a row pass. Both run on
// Hopper's own pieces, their products on the s8 wgmma GEMM fed by TMA
// (gemm_s8_sm90.cuh), which reads the int8 weights K-major ([out, in]):
//
//   attention block (x bf16 or fp32 [B*N, D]):
//     1. ln_quant_rows: flax LN in fp32 -> int8 codes + row scale  (memory)
//     2. gemm_s8_sm90:  codes @ Wqkv_i8 -> (acc*s_row)*s_col -> qkv in x's
//                        dtype (the TPU kernel's acc_dtype, quant_block.py:122)
//     3. bf16: attention_core_sm90, the register-resident core of kernels 1,
//                        3 and 4; fp32: the fp32 core of attention_f32.cuh
//                        on the same fused rows (kernel 3's fp32 route: every
//                        product fp32, P never rounded). fp32 rows out, padded
//                        keys col >= true_n masked to -1e30 (quant_block.py:88)
//     4. quant_rows:    fp32 attention rows -> int8 + row scale     (memory)
//     5. gemm_s8_sm90:  codes @ Wout_i8 -> (acc*s)*s_col + bout + x -> x.dtype
//   MLP (x bf16 or fp32 [T, D]):
//     1. ln_quant_rows
//     2. gemm_s8_sm90<float, kRowMax>: codes @ W1_i8 -> (acc*s)*s1 + b1 ->
//                        gelu -> fp32 h, and each row's max |h| by 128-column
//                        tile (the partials)
//     3. quant_rows_parts: the row max from the partials, then h -> int8 +
//                        row scale in one read of h              (memory)
//     4. gemm_s8_sm90:  codes @ W2_i8 -> (acc*s)*s2 + b2 + x -> x.dtype
//
// The GEMMs are compute-bound (int8 tensor cores, exact int32 sums). The
// row passes and the fp32 intermediates (the attention rows, 4 B per value;
// the hidden) are the cost of the split; a later PR quantizes kernel 9's
// attention rows in the next GEMM's prologue, or gives one block all heads
// of a query tile, and keeps them on chip. The MLP's hidden is 2 MB of fp32
// for a 128-row tile, so it stays in device memory; taking its row max in
// fc1's epilogue lets the quantizer read it once instead of twice.

#include "attention_core_sm90.cuh"
#include "attention_f32.cuh"
#include "common.cuh"
#include "gemm_s8_sm90.cuh"

namespace vt {
namespace {

// T: the stream's dtype (x, qkv, out), bf16 or fp32.
template <typename T>
cudaError_t quant_attention_block(const T* x, const float* ln_scale, const float* ln_bias,
                                  const int8_t* wqkv, const float* sqkv, const int8_t* wout,
                                  const float* sout, const float* bout, T* out, int8_t* xq,
                                  float* s_row, T* qkv, float* attn_out, int8_t* aq,
                                  float* s_row2, int B, int N, int D, int H, int Dh, float scale,
                                  float eps, int true_n, cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(wqkv) || misaligned(sqkv) || misaligned(wout) ||
      misaligned(sout) || misaligned(bout) || misaligned(out) || misaligned(xq) ||
      misaligned(qkv) || misaligned(attn_out) || misaligned(aq))
    return cudaErrorInvalidValue;  // checked before any launch: nothing half done
  cudaError_t e = ln_quant_rows<T>(x, ln_scale, ln_bias, xq, s_row, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_s8_sm90<T>(xq, wqkv, qkv, s_row, sqkv, nullptr, nullptr, kActNone, rows, 3 * HD, D,
                      stream);
  if (e != cudaSuccess) return e;
  const attn::ScoreTerms keys{nullptr, 0, 0, true_n, N};
  if constexpr (std::is_same<T, float>::value)
    e = attention_f32(qkv, attn_out, B, N, H, Dh, scale, keys, stream);
  else
    e = attention_core_sm90(qkv, attn_out, B, N, H, Dh, scale, keys, stream);
  if (e != cudaSuccess) return e;
  e = quant_rows(attn_out, aq, s_row2, rows, HD, stream);
  if (e != cudaSuccess) return e;
  return gemm_s8_sm90<T>(aq, wout, out, s_row2, sout, bout, x, kActNone, rows, D, HD, stream);
}

// Rows of kernel 10's fp32 hidden -> int8 codes + row scales, one warp a
// row, from fc1's partial row maxes (amax_part [rows, parts]): the row max
// is the max of the row's partials, exact in any order, so the codes and
// scales are quant_rows' and the row is read once. A warp step covers 512
// values: each lane loads four float4s 128 values apart (every load 512
// contiguous bytes across the warp) and stores each one's four codes as one
// word (every store 128 contiguous bytes). K % 16 == 0 and v, q 16-byte
// aligned. Memory-bound: at ViT-L batch 128 it reads 413 MB and writes 103 MB
// (0.154 ms at 3.35 TB/s), where quant_rows_kernel reads the rows twice with
// 4-byte loads.
__global__ void quant_rows_parts_kernel(const float* __restrict__ v,
                                        const float* __restrict__ amax_part, int parts,
                                        int8_t* __restrict__ q, float* __restrict__ row_scale,
                                        int rows, int K) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float amax = 0.f;
  for (int p = lane; p < parts; p += 32) amax = fmaxf(amax, amax_part[(size_t)row * parts + p]);
  const float rs = row_quant_scale(warp_max(amax));
  if (lane == 0) row_scale[row] = rs;
  const float4* vr = reinterpret_cast<const float4*>(v + (size_t)row * K);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * K);
  const auto pack = [rs](float4 f) {
    return static_cast<uint32_t>(static_cast<uint8_t>(quant_code(f.x, rs))) |
           static_cast<uint32_t>(static_cast<uint8_t>(quant_code(f.y, rs))) << 8 |
           static_cast<uint32_t>(static_cast<uint8_t>(quant_code(f.z, rs))) << 16 |
           static_cast<uint32_t>(static_cast<uint8_t>(quant_code(f.w, rs))) << 24;
  };
  const int n4 = K / 4;  // float4s in the row
  for (int c = lane; c < n4; c += 128) {
    float4 f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + 32 * j < n4) f[j] = vr[c + 32 * j];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + 32 * j < n4) qr[c + 32 * j] = pack(f[j]);
  }
}

inline cudaError_t quant_rows_parts(const float* v, const float* amax_part, int parts, int8_t* q,
                                    float* row_scale, int rows, int K, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (K % 16 || misaligned(v) || misaligned(q)) return cudaErrorInvalidValue;
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  quant_rows_parts_kernel<<<blocks, kThreads, 0, stream>>>(v, amax_part, parts, q, row_scale,
                                                           rows, K);
  return cudaGetLastError();
}

// w1 [F, D] and w2 [D, F] int8, K-major; amax_part [rows, ceil(F / 128)].
template <typename T>
cudaError_t quant_mlp(const T* x, const float* ln_scale, const float* ln_bias, const int8_t* w1,
                      const float* s1, const float* b1, const int8_t* w2, const float* s2,
                      const float* b2, T* out, int8_t* xq, float* s_row, float* h, int8_t* hq,
                      float* s_row2, float* amax_part, int rows, int D, int F, int act, float eps,
                      cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (D % 16 || F % 16 || amax_part == nullptr || misaligned(x) || misaligned(w1) ||
      misaligned(s1) || misaligned(b1) || misaligned(w2) || misaligned(s2) || misaligned(b2) ||
      misaligned(out) || misaligned(xq) || misaligned(h) || misaligned(hq))
    return cudaErrorInvalidValue;  // checked before any launch: nothing half done
  cudaError_t e = ln_quant_rows<T>(x, ln_scale, ln_bias, xq, s_row, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_s8_sm90<float, true>(xq, w1, h, s_row, s1, b1, nullptr, act, rows, F, D, stream,
                                amax_part);
  if (e != cudaSuccess) return e;
  e = quant_rows_parts(h, amax_part, gemm_s8_sm90_parts(F), hq, s_row2, rows, F, stream);
  if (e != cudaSuccess) return e;
  return gemm_s8_sm90<T>(hq, w2, out, s_row2, s2, b2, x, kActNone, rows, D, F, stream);
}

}  // namespace
}  // namespace vt

// x_is_fp32: x, qkv and out fp32 (the fp32 stream), else bf16.
extern "C" int vt_quant_attention_block(const void* x, int x_is_fp32, const void* ln_scale,
                                        const void* ln_bias, const void* wqkv, const void* sqkv,
                                        const void* wout, const void* sout, const void* bout,
                                        void* out, void* xq, void* s_row, void* qkv, void* attn,
                                        void* aq, void* s_row2, int B, int N, int D, int H, int Dh,
                                        float scale, float eps, int true_n, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  int8_t* xq_ = static_cast<int8_t*>(xq);
  int8_t* aq_ = static_cast<int8_t*>(aq);
  float* sr = static_cast<float*>(s_row);
  float* sr2 = static_cast<float*>(s_row2);
  float* attn_ = static_cast<float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::quant_attention_block<float>(
        f(x), f(ln_scale), f(ln_bias), i8(wqkv), f(sqkv), i8(wout), f(sout), f(bout),
        static_cast<float*>(out), xq_, sr, static_cast<float*>(qkv), attn_, aq_, sr2, B, N, D, H,
        Dh, scale, eps, true_n, s);
  else
    e = vt::quant_attention_block<bf16>(
        static_cast<const bf16*>(x), f(ln_scale), f(ln_bias), i8(wqkv), f(sqkv), i8(wout),
        f(sout), f(bout), static_cast<bf16*>(out), xq_, sr, static_cast<bf16*>(qkv), attn_, aq_,
        sr2, B, N, D, H, Dh, scale, eps, true_n, s);
  return static_cast<int>(e);
}

extern "C" int vt_quant_mlp(const void* x, int x_is_fp32, const void* ln_scale,
                            const void* ln_bias, const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2, void* out, void* xq,
                            void* s_row, void* h, void* hq, void* s_row2, void* amax_part, int T,
                            int D, int F, int act, float eps, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xq_ = static_cast<int8_t*>(xq);
  int8_t* hq_ = static_cast<int8_t*>(hq);
  float* sr = static_cast<float*>(s_row);
  float* sr2 = static_cast<float*>(s_row2);
  float* h_ = static_cast<float*>(h);
  float* parts = static_cast<float*>(amax_part);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::quant_mlp<float>(f(x), f(ln_scale), f(ln_bias), i8(w1), f(s1), f(b1), i8(w2), f(s2),
                             f(b2), static_cast<float*>(out), xq_, sr, h_, hq_, sr2, parts, T, D, F,
                             act, eps, s);
  else
    e = vt::quant_mlp<bf16>(static_cast<const bf16*>(x), f(ln_scale), f(ln_bias), i8(w1), f(s1),
                            f(b1), i8(w2), f(s2), f(b2), static_cast<bf16*>(out), xq_, sr, h_,
                            hq_, sr2, parts, T, D, F, act, eps, s);
  return static_cast<int>(e);
}

// The row quantizers alone (fp32 rows -> int8 codes + row scales; the second
// from partial row maxes amax_part [rows, parts]): their checks against
// quantize_rows on rows built to land on halves (chip_smoke.py, tests). Not
// on any model path.
extern "C" int vt_quant_rows(const void* v, void* q, void* row_scale, int rows, int K,
                             void* stream) {
  return static_cast<int>(vt::quant_rows(static_cast<const float*>(v), static_cast<int8_t*>(q),
                                         static_cast<float*>(row_scale), rows, K,
                                         static_cast<cudaStream_t>(stream)));
}

extern "C" int vt_quant_rows_parts(const void* v, const void* amax_part, int parts, void* q,
                                   void* row_scale, int rows, int K, void* stream) {
  return static_cast<int>(vt::quant_rows_parts(
      static_cast<const float*>(v), static_cast<const float*>(amax_part), parts,
      static_cast<int8_t*>(q), static_cast<float*>(row_scale), rows, K,
      static_cast<cudaStream_t>(stream)));
}

// The s8 wgmma GEMM alone (b [N, K], K-major): raw int32 sums, the exactness
// check against torch._int_mm; and fp32 out through the dequant epilogue
// (bias and activation optional) with, where amax_part is given, the partial
// row maxes of kernel 10's fc1 (chip_smoke.py, tests). Not on any model path.
extern "C" int vt_gemm_s8_sm90_i32(const void* a, const void* b_nk, void* c, int M, int N, int K,
                                   void* stream) {
  return static_cast<int>(vt::gemm_s8_sm90<int32_t>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b_nk), static_cast<int32_t*>(c),
      nullptr, nullptr, nullptr, nullptr, vt::kActNone, M, N, K,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int vt_gemm_s8_sm90_f32(const void* a, const void* b_nk, void* c, const void* s_row,
                                   const void* s_col, const void* bias, int act, void* amax_part,
                                   int M, int N, int K, void* stream) {
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* out = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (amax_part != nullptr)
    return static_cast<int>(vt::gemm_s8_sm90<float, true>(
        i8(a), i8(b_nk), out, f(s_row), f(s_col), f(bias), nullptr, act, M, N, K, s,
        static_cast<float*>(amax_part)));
  return static_cast<int>(vt::gemm_s8_sm90<float>(i8(a), i8(b_nk), out, f(s_row), f(s_col),
                                                  f(bias), nullptr, act, M, N, K, s));
}
