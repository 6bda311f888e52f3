// The two W8A8 encoder kernels for Hopper.
//
// Replace vit_tpu/ops/quant_block.py::_kernel (the W8A8 attention block) and
// ::_mlp_kernel (the W8A8 MLP), the Pallas TPU kernels. On the TPU each is one
// program with the int8 weight tables resident in VMEM and every quantize /
// dequantize pair in VMEM. An H100 block has 227 KB of shared memory, and the
// activations are quantized per row over rows that span many tiles (the
// attention output over all H*Dh columns, across every head; the GELU hidden
// over all 4096 columns), so each op splits where the TPU kernel itself
// quantizes or rounds, and the fp32 rows it quantizes are written out whole
// and quantized in a row pass:
//
//   attention block (x bf16 [B*N, D]; weights K-major, [out, in]):
//     1. ln_quant_rows: flax LN in fp32 -> int8 codes + row scale  (memory)
//     2. gemm_s8_sm90:  codes @ Wqkv_i8 -> (acc*s_row)*s_col -> bf16 qkv
//     3. attention_core_sm90: the register-resident core, fp32 rows out
//                        (padded keys col >= true_n masked to -1e30)
//     4. quant_rows:    fp32 attention rows -> int8 + row scale     (memory)
//     5. gemm_s8_sm90:  codes @ Wout_i8 -> (acc*s)*s_col + bout + x -> x.dtype
//   MLP (x bf16 or fp32 [T, D]; weights [in, out]):
//     1. ln_quant_rows
//     2. gemm_s8:       codes @ W1_i8 -> (acc*s)*s1 + b1 -> gelu -> fp32 h
//     3. quant_rows:    h -> int8 + row scale                        (memory)
//     4. gemm_s8:       codes @ W2_i8 -> (acc*s)*s2 + b2 + x -> x.dtype
//
// The GEMMs are compute-bound (int8 tensor cores, exact int32 sums). The
// row passes and the fp32 intermediates (the attention rows, 4 B per value;
// the hidden, 16 KB per token at ViT-L) are the cost of the split; a later
// PR quantizes in the next GEMM's prologue or gives one block all heads of a
// query tile, and keeps them on chip.
//
// The attention block runs on Hopper's own pieces: its two products on the
// s8 wgmma GEMM fed by TMA (gemm_s8_sm90.cuh), which reads the weights
// K-major, and its attention on the register-resident core of kernels 1, 3
// and 4 (attention_core_sm90.cuh) with fp32 rows out. The MLP keeps the WMMA
// GEMM of gemm_s8.cuh and vit_tpu's [in, out] weights until its own PR.

#include "attention_core_sm90.cuh"
#include "common.cuh"
#include "gemm_s8.cuh"
#include "gemm_s8_sm90.cuh"

namespace vt {
namespace {

cudaError_t quant_attention_block(const bf16* x, const float* ln_scale, const float* ln_bias,
                                  const int8_t* wqkv, const float* sqkv, const int8_t* wout,
                                  const float* sout, const float* bout, bf16* out, int8_t* xq,
                                  float* s_row, bf16* qkv, float* attn_out, int8_t* aq,
                                  float* s_row2, int B, int N, int D, int H, int Dh, float scale,
                                  float eps, int true_n, cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(wqkv) || misaligned(sqkv) || misaligned(wout) ||
      misaligned(sout) || misaligned(bout) || misaligned(out) || misaligned(xq) ||
      misaligned(qkv) || misaligned(attn_out) || misaligned(aq))
    return cudaErrorInvalidValue;  // checked before any launch: nothing half done
  cudaError_t e = ln_quant_rows<bf16>(x, ln_scale, ln_bias, xq, s_row, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_s8_sm90<bf16>(xq, wqkv, qkv, s_row, sqkv, nullptr, nullptr, kActNone, rows, 3 * HD, D,
                         stream);
  if (e != cudaSuccess) return e;
  e = attention_core_sm90(qkv, attn_out, B, N, H, Dh, scale,
                          attn::ScoreTerms{nullptr, 0, 0, true_n, N}, stream);
  if (e != cudaSuccess) return e;
  e = quant_rows(attn_out, aq, s_row2, rows, HD, stream);
  if (e != cudaSuccess) return e;
  return gemm_s8_sm90<bf16>(aq, wout, out, s_row2, sout, bout, x, kActNone, rows, D, HD, stream);
}

template <typename T>
cudaError_t quant_mlp(const T* x, const float* ln_scale, const float* ln_bias, const int8_t* w1,
                      const float* s1, const float* b1, const int8_t* w2, const float* s2,
                      const float* b2, T* out, int8_t* xq, float* s_row, float* h, int8_t* hq,
                      float* s_row2, int rows, int D, int F, int act, float eps,
                      cudaStream_t stream) {
  cudaError_t e = ln_quant_rows<T>(x, ln_scale, ln_bias, xq, s_row, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_s8<float>(xq, w1, h, s_row, s1, b1, nullptr, act, rows, F, D, stream);
  if (e != cudaSuccess) return e;
  e = quant_rows(h, hq, s_row2, rows, F, stream);
  if (e != cudaSuccess) return e;
  return gemm_s8<T>(hq, w2, out, s_row2, s2, b2, x, kActNone, rows, D, F, stream);
}

}  // namespace
}  // namespace vt

extern "C" int vt_quant_attention_block(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* wqkv, const void* sqkv, const void* wout,
                                        const void* sout, const void* bout, void* out, void* xq,
                                        void* s_row, void* qkv, void* attn, void* aq,
                                        void* s_row2, int B, int N, int D, int H, int Dh,
                                        float scale, float eps, int true_n, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const cudaError_t e = vt::quant_attention_block(
      static_cast<const bf16*>(x), f(ln_scale), f(ln_bias), i8(wqkv), f(sqkv), i8(wout), f(sout),
      f(bout), static_cast<bf16*>(out), static_cast<int8_t*>(xq), static_cast<float*>(s_row),
      static_cast<bf16*>(qkv), static_cast<float*>(attn), static_cast<int8_t*>(aq),
      static_cast<float*>(s_row2), B, N, D, H, Dh, scale, eps, true_n,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

extern "C" int vt_quant_mlp(const void* x, int x_is_fp32, const void* ln_scale,
                            const void* ln_bias, const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2, void* out, void* xq,
                            void* s_row, void* h, void* hq, void* s_row2, int T, int D, int F,
                            int act, float eps, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xq_ = static_cast<int8_t*>(xq);
  int8_t* hq_ = static_cast<int8_t*>(hq);
  float* sr = static_cast<float*>(s_row);
  float* sr2 = static_cast<float*>(s_row2);
  float* h_ = static_cast<float*>(h);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::quant_mlp<float>(f(x), f(ln_scale), f(ln_bias), i8(w1), f(s1), f(b1), i8(w2), f(s2),
                             f(b2), static_cast<float*>(out), xq_, sr, h_, hq_, sr2, T, D, F, act,
                             eps, s);
  else
    e = vt::quant_mlp<bf16>(static_cast<const bf16*>(x), f(ln_scale), f(ln_bias), i8(w1), f(s1),
                            f(b1), i8(w2), f(s2), f(b2), static_cast<bf16*>(out), xq_, sr, h_,
                            hq_, sr2, T, D, F, act, eps, s);
  return static_cast<int>(e);
}

// The row quantizer alone (fp32 rows -> int8 codes + row scales): its check
// against quantize_rows on rows built to land on halves (chip_smoke.py,
// tests). Not on any model path.
extern "C" int vt_quant_rows(const void* v, void* q, void* row_scale, int rows, int K,
                             void* stream) {
  return static_cast<int>(vt::quant_rows(static_cast<const float*>(v), static_cast<int8_t*>(q),
                                         static_cast<float*>(row_scale), rows, K,
                                         static_cast<cudaStream_t>(stream)));
}

// The int8 GEMMs alone, raw int32 sums out: the exactness checks of gemm_s8
// (b [K, N]) and gemm_s8_sm90 (b [N, K]) against torch._int_mm (chip_smoke.py,
// tests). Not on any model path.
extern "C" int vt_gemm_s8_i32(const void* a, const void* b, void* c, int M, int N, int K,
                              void* stream) {
  return static_cast<int>(vt::gemm_s8<int32_t>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int32_t*>(c),
      nullptr, nullptr, nullptr, nullptr, vt::kActNone, M, N, K,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int vt_gemm_s8_sm90_i32(const void* a, const void* b_nk, void* c, int M, int N, int K,
                                   void* stream) {
  return static_cast<int>(vt::gemm_s8_sm90<int32_t>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b_nk), static_cast<int32_t*>(c),
      nullptr, nullptr, nullptr, nullptr, vt::kActNone, M, N, K,
      static_cast<cudaStream_t>(stream)));
}
