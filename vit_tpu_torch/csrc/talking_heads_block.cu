// CaiT's talking-heads attention block for Hopper:
//   out = (softmax(mask(mix_pre^T-mixed (q k^T * scale))) mixed by mix_post) v @ Wout + bout [+ x],
//   qkv = LN(x) @ Wqkv
//
// Replaces vit_tpu/ops/reattention_block.py::_th_kernel (the Pallas TPU
// kernel). As attention_block.cu, it splits at the GEMM boundaries, storing
// only what the TPU kernel rounds to bf16 before its next use (xn, qkv at
// :191-193, each head's P V at :230-234):
//   1. ln_rows:            flax LayerNorm in fp32 (eps 1e-5 in CaiT) -> bf16 xn
//   2. gemm_bf16_sm90:     xn @ Wqkv -> bf16 qkv                  (compute-bound)
//   3. head_mix_core:      per (query tile, sample), all heads: scores, the
//                          pre-softmax mix, mask, softmax, the post-softmax
//                          mix, P V                      (latency-bound)
//   4. gemm_bf16_sm90:     attn @ Wout + bout [+ x] -> x.dtype    (compute-bound)
// CaiT's patch stage calls it without the residual: LayerScale gates the
// delta outside (vit_tpu/nn/attention.py:258-271).
//
// Bound: operations. At the CaiT preset (64 tokens, dim 1024, 16 heads of
// 64) the two products are 68.7 of the block's 70.9 tensor-core GFLOP at
// batch 128. On the WMMA GEMM of gemm.cuh (~160 TFLOP/s) they took half the
// kernel; both run on gemm_sm90.cuh (wgmma fed by TMA, the GEMM of kernels 1 and 2). Its TMA
// needs every row stride and operand start 16-byte aligned: the wrapper
// requires D % 8 == 0 and dim_head % 16 == 0, and a misaligned operand
// fails the call before any launch (cudaErrorInvalidValue).
//
// The fp32 route (vt_talking_heads_block_f32): with fp32 x and weights the TPU
// kernel runs its products at Precision.HIGHEST (reattention_block.py:176) and
// rounds nothing to bf16. The same four launches, each fp32 end to end:
// ln_rows to an fp32 xn, the qkv product on gemm_f32.cuh (fp32 FMAs on the
// CUDA cores), the fp32 head-mix core (head_mix_f32_kernel), the out
// product with bout [+ x] on gemm_f32.cuh.

#include "common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"
#include "head_mix_core.cuh"

namespace vt {
namespace {

template <typename T>
cudaError_t talking_heads_block(const T* x, const float* ln_scale, const float* ln_bias,
                                const bf16* wqkv, const bf16* wout, const float* bout,
                                const hmix::Params& prm, T* out, bf16* xn, bf16* qkv,
                                bf16* attn_out, int B, int N, int D, int H, int Dh, float scale,
                                float eps, int residual, int true_n, cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  const auto misaligned = [](const void* p) {
    return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (misaligned(x) || misaligned(wqkv) || misaligned(wout) || misaligned(bout) ||
      misaligned(out) || misaligned(xn) || misaligned(qkv) || misaligned(attn_out))
    return cudaErrorInvalidValue;  // checked before any launch: nothing half done
  cudaError_t e = ln_rows<T>(x, ln_scale, ln_bias, xn, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_bf16_sm90<bf16>(xn, wqkv, qkv, nullptr, nullptr, kActNone, rows, 3 * HD, D, stream);
  if (e != cudaSuccess) return e;
  e = head_mix_core<hmix::kTalkingHeads>(qkv, attn_out, B, N, H, Dh, scale, true_n, prm, stream);
  if (e != cudaSuccess) return e;
  return gemm_bf16_sm90<T>(attn_out, wout, out, bout, residual ? x : nullptr, kActNone, rows, D,
                           HD, stream);
}

cudaError_t talking_heads_block_f32(const float* x, const float* ln_scale, const float* ln_bias,
                                    const float* wqkv, const float* wout, const float* bout,
                                    const hmix::Params& prm, float* out, float* xn, float* qkv,
                                    float* attn_out, int B, int N, int D, int H, int Dh,
                                    float scale, float eps, int residual, int true_n,
                                    cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  cudaError_t e = ln_rows<float>(x, ln_scale, ln_bias, xn, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_f32(xn, wqkv, qkv, nullptr, nullptr, kActNone, rows, 3 * HD, D, stream);
  if (e != cudaSuccess) return e;
  e = head_mix_core_f32<hmix::kTalkingHeads>(qkv, attn_out, B, N, H, Dh, scale, true_n, prm,
                                             stream);
  if (e != cudaSuccess) return e;
  return gemm_f32(attn_out, wout, out, bout, residual ? x : nullptr, kActNone, rows, D, HD,
                  stream);
}

}  // namespace
}  // namespace vt

extern "C" int vt_talking_heads_block(const void* x, int x_is_fp32, const void* ln_scale,
                                      const void* ln_bias, const void* wqkv, const void* wout,
                                      const void* bout, const void* mix_pre, const void* mix_post,
                                      void* out, void* xn, void* qkv, void* attn, void* dbg_mixed,
                                      void* dbg_p, int B, int N, int D, int H, int Dh, float scale,
                                      float eps, int residual, int true_n, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  const vt::hmix::Params prm{f(mix_pre), f(mix_post), nullptr, nullptr, 0.0f, 0.0f,
                             static_cast<float*>(dbg_mixed), static_cast<float*>(dbg_p)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::talking_heads_block<float>(f(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                       prm, static_cast<float*>(out), static_cast<bf16*>(xn),
                                       static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D,
                                       H, Dh, scale, eps, residual, true_n, s);
  else
    e = vt::talking_heads_block<bf16>(h(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                      prm, static_cast<bf16*>(out), static_cast<bf16*>(xn),
                                      static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D,
                                      H, Dh, scale, eps, residual, true_n, s);
  return static_cast<int>(e);
}

// The fp32 route: x, the weights, the scratch (xn, qkv, attn) and out all fp32.
extern "C" int vt_talking_heads_block_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                          const void* wqkv, const void* wout, const void* bout,
                                          const void* mix_pre, const void* mix_post, void* out,
                                          void* xn, void* qkv, void* attn, void* dbg_mixed,
                                          void* dbg_p, int B, int N, int D, int H, int Dh,
                                          float scale, float eps, int residual, int true_n,
                                          void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  const vt::hmix::Params prm{f(mix_pre), f(mix_post), nullptr, nullptr, 0.0f, 0.0f,
                             w(dbg_mixed), w(dbg_p)};
  return static_cast<int>(vt::talking_heads_block_f32(
      f(x), f(ln_scale), f(ln_bias), f(wqkv), f(wout), f(bout), prm, w(out), w(xn), w(qkv),
      w(attn), B, N, D, H, Dh, scale, eps, residual, true_n, static_cast<cudaStream_t>(stream)));
}
