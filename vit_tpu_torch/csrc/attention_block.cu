// Fused self-attention block for Hopper:
//   out = x + (softmax(q k^T * scale, masked) v) @ Wout + bout,  qkv = LN(x) @ Wqkv
//
// Replaces vit_tpu/ops/block_attention.py::_kernel (the Pallas TPU kernel).
// The TPU kernel keeps Wqkv + Wout (~8 MB bf16 at ViT-L) resident in 16 MB of
// VMEM; an H100 block has 227 KB of shared memory, so this version splits the
// op at its GEMM boundaries, into four launches:
//   1. ln_rows:             flax LayerNorm in fp32 -> bf16 xn    (memory-bound)
//   2. gemm_bf16_sm90:      xn @ Wqkv -> bf16 qkv                (compute-bound;
//                           wgmma fed by TMA, gemm_sm90.cuh)
//   3. attention_core_sm90: the register-resident exact softmax of
//                           attention_core_sm90.cuh on the fused qkv rows,
//                           with the true_n / block_tokens key mask
//                           (memory- and latency-bound at n = 197)
//   4. gemm_bf16_sm90:      attn @ Wout + bout + x -> x.dtype    (compute-bound)
// It stores only what the TPU kernel itself rounds to bf16 before its next
// use (xn, qkv at block_attention.py:81, the attention output at :120), so
// the arithmetic is the TPU kernel's: the out product's fp32 accumulator
// plus bout, then plus x, rounded once to x's dtype (:125-130).
// At ViT-L batch 128 the two products are 211.5 of the block's 231.8 GFLOP:
// the block is bound by the tensor cores (0.23 ms at 989 TFLOP/s).
//
// The fp32 route (vt_attention_block_f32): with fp32 x and weights the TPU
// kernel runs both products and the attention at Precision.HIGHEST
// (block_attention.py:62-66), and rounds nothing to bf16. The same four
// launches on fp32 throughout: ln_rows to an fp32 xn, the qkv product on
// gemm_f32.cuh (fp32 FMAs on the CUDA cores), the fp32 core of
// attention_f32.cuh with the same true_n / block_tokens key mask, the out
// product with bout and x in gemm_f32's epilogue. Bound: operations at the
// card's fp32 rate (ViT-L batch 128: 232 GFLOP, 3.5 ms at 67 TFLOP/s).

#include "attention_core_sm90.cuh"
#include "attention_f32.cuh"
#include "common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

namespace vt {
namespace {

template <typename T>
cudaError_t attention_block(const T* x, const float* ln_scale, const float* ln_bias,
                            const bf16* wqkv, const bf16* wout, const float* bout, T* out,
                            bf16* xn, bf16* qkv, bf16* attn_out, int B, int N, int D, int H,
                            int Dh, float scale, float eps, int true_n, int bt,
                            cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  cudaError_t e = ln_rows<T>(x, ln_scale, ln_bias, xn, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_bf16_sm90<bf16>(xn, wqkv, qkv, nullptr, nullptr, kActNone, rows, 3 * HD, D, stream);
  if (e != cudaSuccess) return e;
  e = attention_core_sm90(qkv, attn_out, B, N, H, Dh, scale,
                          attn::ScoreTerms{nullptr, 0, 0, true_n, bt}, stream);
  if (e != cudaSuccess) return e;
  return gemm_bf16_sm90<T>(attn_out, wout, out, bout, x, kActNone, rows, D, HD, stream);
}

}  // namespace
}  // namespace vt

extern "C" int vt_attention_block(const void* x, int x_is_fp32, const void* ln_scale,
                                  const void* ln_bias, const void* wqkv, const void* wout,
                                  const void* bout, void* out, void* xn, void* qkv, void* attn,
                                  int B, int N, int D, int H, int Dh, float scale, float eps,
                                  int true_n, int bt, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::attention_block<float>(f(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                   static_cast<float*>(out), static_cast<bf16*>(xn),
                                   static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D, H,
                                   Dh, scale, eps, true_n, bt, s);
  else
    e = vt::attention_block<bf16>(h(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                  static_cast<bf16*>(out), static_cast<bf16*>(xn),
                                  static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D, H,
                                  Dh, scale, eps, true_n, bt, s);
  return static_cast<int>(e);
}

// The fp32 route: x, the weights, the scratch (xn, qkv, attn) and out all fp32.
extern "C" int vt_attention_block_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                      const void* wqkv, const void* wout, const void* bout,
                                      void* out, void* xn, void* qkv, void* attn, int B, int N,
                                      int D, int H, int Dh, float scale, float eps, int true_n,
                                      int bt, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* y = static_cast<float*>(xn);
  float* qkv_ = static_cast<float*>(qkv);
  float* attn_ = static_cast<float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * N, HD = H * Dh;
  cudaError_t e = vt::ln_rows<float>(f(x), f(ln_scale), f(ln_bias), y, rows, D, eps, s);
  if (e == cudaSuccess)
    e = vt::gemm_f32(y, f(wqkv), qkv_, nullptr, nullptr, vt::kActNone, rows, 3 * HD, D, s);
  if (e == cudaSuccess)
    e = vt::attention_f32(qkv_, attn_, B, N, H, Dh, scale,
                          vt::attn::ScoreTerms{nullptr, 0, 0, true_n, bt}, s);
  if (e == cudaSuccess)
    e = vt::gemm_f32(attn_, f(wout), static_cast<float*>(out), f(bout), f(x), vt::kActNone, rows,
                     D, HD, s);
  return static_cast<int>(e);
}

// The block's GEMM alone, for checks against an fp32 product:
// C = round_once(act(A @ B + bias) + residual), C and residual fp32 or bf16;
// act is gemm.cuh's Act code (0 none, 1 gelu, 2 gelu_exact, 3 hard_swish).
extern "C" int vt_gemm_bf16_sm90(const void* a, const void* b, void* c, const void* bias,
                                 const void* residual, int act, int out_is_fp32, int M, int N,
                                 int K, void* stream) {
  using vt::bf16;
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < vt::kActNone || act > vt::kActHardSwish) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (out_is_fp32)
    e = vt::gemm_bf16_sm90<float>(h(a), h(b), static_cast<float*>(c), bi,
                                  static_cast<const float*>(residual), act, M, N, K, s);
  else
    e = vt::gemm_bf16_sm90<bf16>(h(a), h(b), static_cast<bf16*>(c), bi, h(residual), act, M, N,
                                 K, s);
  return static_cast<int>(e);
}

extern "C" const char* vt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
