// DeepViT's re-attention block for Hopper:
//   out = x + (HeadLN(mix^T-mixed softmax(q k^T * scale, masked)) v) @ Wout + bout,
//   qkv = LN(x) @ Wqkv
//
// Replaces vit_tpu/ops/reattention_block.py::_kernel (the Pallas TPU kernel),
// split at its GEMM boundaries as attention_block.cu is (xn, qkv at :69-78
// and each head's P V at :128-134 are what the TPU kernel rounds to bf16):
//   1. ln_rows:            flax LayerNorm in fp32 (eps 1e-6) -> bf16 xn
//   2. gemm_bf16_sm90:     xn @ Wqkv -> bf16 qkv                  (compute-bound)
//   3. head_mix_core:      per (query tile, sample), all heads: softmax, the
//                          head mix, the LayerNorm across heads (eps 1e-6),
//                          padded key columns zeroed, P V (latency-bound)
//   4. gemm_bf16_sm90:     attn @ Wout + bout + x -> x.dtype      (compute-bound)
// The head LayerNorm divides small differences between heads by a small
// deviation, so it amplifies rounding (PARITY.md "Re-attention
// conditioning"); chip_smoke.py holds this kernel stage by stage.
//
// Bound: operations. At the DeepViT preset (65 tokens, dim 1024, 16 heads of
// 64) the two products are 69.8 of the block's 72.0 tensor-core GFLOP at
// batch 128. They run on gemm_sm90.cuh (wgmma fed by TMA), as kernel 7's do;
// its TMA needs every row stride and operand start 16-byte aligned: the
// wrapper requires D % 8 == 0 and dim_head % 16 == 0, and a misaligned
// operand fails the call before any launch (cudaErrorInvalidValue).
//
// The fp32 route (vt_reattention_block_f32): with fp32 x and weights the TPU
// kernel runs its products at Precision.HIGHEST (reattention_block.py:61) and
// rounds nothing to bf16: ln_rows to an fp32 xn, the qkv product on
// gemm_f32.cuh, the fp32 head-mix core (head_mix_f32_kernel), the out product
// with bout + x on gemm_f32.cuh.

#include "common.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"
#include "head_mix_core.cuh"

namespace vt {
namespace {

template <typename T>
cudaError_t reattention_block(const T* x, const float* ln_scale, const float* ln_bias,
                              const bf16* wqkv, const bf16* wout, const float* bout,
                              const hmix::Params& prm, T* out, bf16* xn, bf16* qkv, bf16* attn_out,
                              int B, int N, int D, int H, int Dh, float scale, float eps,
                              int true_n, cudaStream_t stream) {
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
  e = head_mix_core<hmix::kReattention>(qkv, attn_out, B, N, H, Dh, scale, true_n, prm, stream);
  if (e != cudaSuccess) return e;
  return gemm_bf16_sm90<T>(attn_out, wout, out, bout, x, kActNone, rows, D, HD, stream);
}

cudaError_t reattention_block_f32(const float* x, const float* ln_scale, const float* ln_bias,
                                  const float* wqkv, const float* wout, const float* bout,
                                  const hmix::Params& prm, float* out, float* xn, float* qkv,
                                  float* attn_out, int B, int N, int D, int H, int Dh, float scale,
                                  float eps, int true_n, cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  cudaError_t e = ln_rows<float>(x, ln_scale, ln_bias, xn, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_f32(xn, wqkv, qkv, nullptr, nullptr, kActNone, rows, 3 * HD, D, stream);
  if (e != cudaSuccess) return e;
  e = head_mix_core_f32<hmix::kReattention>(qkv, attn_out, B, N, H, Dh, scale, true_n, prm,
                                            stream);
  if (e != cudaSuccess) return e;
  return gemm_f32(attn_out, wout, out, bout, x, kActNone, rows, D, HD, stream);
}

}  // namespace
}  // namespace vt

extern "C" int vt_reattention_block(const void* x, int x_is_fp32, const void* ln_scale,
                                    const void* ln_bias, const void* wqkv, const void* wout,
                                    const void* bout, const void* mix, const void* rln_scale,
                                    const void* rln_bias, void* out, void* xn, void* qkv,
                                    void* attn, void* dbg_mixed, void* dbg_p, int B, int N, int D,
                                    int H, int Dh, float scale, float eps, float reattn_eps,
                                    int true_n, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  // 1/H as the TPU kernel's weakly typed Python float, rounded to fp32
  const vt::hmix::Params prm{f(mix), nullptr, f(rln_scale), f(rln_bias), reattn_eps,
                             static_cast<float>(1.0 / H), static_cast<float*>(dbg_mixed),
                             static_cast<float*>(dbg_p)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::reattention_block<float>(f(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                     prm, static_cast<float*>(out), static_cast<bf16*>(xn),
                                     static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D, H,
                                     Dh, scale, eps, true_n, s);
  else
    e = vt::reattention_block<bf16>(h(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                    prm, static_cast<bf16*>(out), static_cast<bf16*>(xn),
                                    static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D, H,
                                    Dh, scale, eps, true_n, s);
  return static_cast<int>(e);
}

// The fp32 route: x, the weights, the scratch (xn, qkv, attn) and out all fp32.
extern "C" int vt_reattention_block_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                        const void* wqkv, const void* wout, const void* bout,
                                        const void* mix, const void* rln_scale,
                                        const void* rln_bias, void* out, void* xn, void* qkv,
                                        void* attn, void* dbg_mixed, void* dbg_p, int B, int N,
                                        int D, int H, int Dh, float scale, float eps,
                                        float reattn_eps, int true_n, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  const vt::hmix::Params prm{f(mix), nullptr, f(rln_scale), f(rln_bias), reattn_eps,
                             static_cast<float>(1.0 / H), w(dbg_mixed), w(dbg_p)};
  return static_cast<int>(vt::reattention_block_f32(
      f(x), f(ln_scale), f(ln_bias), f(wqkv), f(wout), f(bout), prm, w(out), w(xn), w(qkv),
      w(attn), B, N, D, H, Dh, scale, eps, true_n, static_cast<cudaStream_t>(stream)));
}

// The head-mix core's plan for a shape (kernels 7 and 8): out[0] resident (1)
// or streamed (0), out[1] the slab's width in 16-key tiles, out[2] ring
// stages a warp, out[3] shared-memory bytes a block. ops/reattention_block.py
// head_mix_plan mirrors it.
extern "C" int vt_head_mix_plan(int N, int H, int Dh, int* out) {
  const vt::hmix::Plan p = vt::hmix::plan_for(N, H, Dh);
  out[0] = p.resident;
  out[1] = p.ct;
  out[2] = p.stages;
  out[3] = static_cast<int>(p.bytes);
  return 0;
}

// The fp32 core's plan (always streamed, no ring): out as vt_head_mix_plan's.
extern "C" int vt_head_mix_plan_f32(int N, int H, int* out) {
  const vt::hmix::Plan p = vt::hmix::plan_f32(N, H);
  out[0] = p.resident;
  out[1] = p.ct;
  out[2] = p.stages;
  out[3] = static_cast<int>(p.bytes);
  return 0;
}
