// Multi-window attention block for Hopper, no residual:
//   out = (softmax(q k^T * scale + bias[h|0]) v per window) @ Wout + bout,
//   qkv = LN(xw) @ Wqkv,  xw [NW, S, C] (NW = batch * windows)
//
// Replaces vit_tpu/ops/window_attention.py::_kernel (the Pallas TPU kernel).
// The TPU kernel packs G windows into one (G*Sp)^2 block-diagonal score tile
// with MASK_VALUE off the blocks, so every dot is MXU-shaped; the off-block
// entries are exactly 0 after exp. That packing is a Mosaic device and is not
// carried over: each window's softmax runs on its own S keys. The op is the
// attention block's pipeline (attention_block.cu) with B = NW and N = S, in
// four launches, storing only what the TPU kernel rounds to bf16:
//   1. ln_rows:        flax LayerNorm in fp32 -> bf16 xn            (memory)
//   2. gemm_bf16:      xn @ Wqkv -> bf16 qkv                        (compute)
//   3. attention_core: per (window, head, 32-query tile), the shared
//                      per-window bias [1|H, S, S] added to every window's
//                      scores (memory / latency)
//   4. gemm_bf16:      attn @ Wout + bout -> xw.dtype, no residual  (compute)
//
// Bound: operations. At Twins-SVT's stage 1 (S = 49, C = 64, inner 512) a
// token costs ~2*64*1536 + 4*49*512 + 2*512*64 ~ 360 KFLOP for 256 B of
// input and output. The attention core's 1-D grid takes every (window, head)
// pair: 128 images x 64 windows x 8 heads = 65,536 of them at batch 128, one
// past what a grid's y dimension holds.

#include "attention_core.cuh"
#include "common.cuh"
#include "gemm.cuh"

namespace vt {
namespace {

template <typename T>
cudaError_t window_attention_block(const T* x, const float* ln_scale, const float* ln_bias,
                                   const bf16* wqkv, const bf16* wout, const float* bout,
                                   const float* bias, int bias_h, T* out, bf16* xn, bf16* qkv,
                                   bf16* attn_out, int NW, int S, int C, int H, int Dh,
                                   float scale, float eps, cudaStream_t stream) {
  const int rows = NW * S, HD = H * Dh;
  cudaError_t e = ln_rows<T>(x, ln_scale, ln_bias, xn, rows, C, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_bf16<bf16>(xn, wqkv, qkv, nullptr, nullptr, kActNone, rows, 3 * HD, C, stream);
  if (e != cudaSuccess) return e;
  e = attention_core<bf16>(qkv, attn_out, NW, S, H, Dh, scale,
                           attn::ScoreTerms{bias, 0, bias_h, S, S, 0}, stream);
  if (e != cudaSuccess) return e;
  return gemm_bf16<T>(attn_out, wout, out, bout, nullptr, kActNone, rows, C, HD, stream);
}

}  // namespace
}  // namespace vt

extern "C" int vt_window_attention_block(const void* x, int x_is_fp32, const void* ln_scale,
                                         const void* ln_bias, const void* wqkv, const void* wout,
                                         const void* bout, const void* bias, int bias_h,
                                         void* out, void* xn, void* qkv, void* attn, int NW,
                                         int S, int C, int H, int Dh, float scale, float eps,
                                         void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* xn_ = static_cast<bf16*>(xn);
  bf16* qkv_ = static_cast<bf16*>(qkv);
  bf16* attn_ = static_cast<bf16*>(attn);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::window_attention_block<float>(f(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout),
                                          f(bout), f(bias), bias_h, static_cast<float*>(out), xn_,
                                          qkv_, attn_, NW, S, C, H, Dh, scale, eps, s);
  else
    e = vt::window_attention_block<bf16>(h(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout),
                                         f(bout), f(bias), bias_h, static_cast<bf16*>(out), xn_,
                                         qkv_, attn_, NW, S, C, H, Dh, scale, eps, s);
  return static_cast<int>(e);
}
