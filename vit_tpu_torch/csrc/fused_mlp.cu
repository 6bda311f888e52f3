// Fused transformer MLP for Hopper:
//   out = act(LN(x) @ W1 + b1) @ W2 + b2 (+ x)
//
// Replaces vit_tpu/ops/fused_mlp.py::_mlp_kernel (the Pallas TPU kernel). The
// TPU kernel streams W1/W2 panels through VMEM and keeps an fp32 accumulator
// over hidden-dim tiles; here the op splits at its GEMM boundary into three
// launches:
//   1. ln_rows: optional flax LayerNorm in fp32 -> bf16 xn    (memory-bound)
//   2. GEMM:    xn @ W1 + b1 -> gelu / gelu_exact / hard_swish -> bf16 h
//   3. GEMM:    h @ W2 + b2 (+ x) -> x.dtype, rounded once
// Both GEMMs are compute-bound at ViT-L from batch 8 up (K, N of 1024/4096).
// The route of the two GEMMs follows the widths, before any launch
// (ops/fused_mlp.py gemm_route mirrors it):
// - D and F multiples of 8 (ViT-L's 1024 / 4096, Twins', CaiT's, DeepViT's
//   and T2T's encoder widths): gemm_bf16_sm90 (gemm_sm90.cuh: wgmma fed by
//   TMA, the activation in its epilogue). Every operand must start on a
//   16-byte boundary; a misaligned one fails the call (cudaErrorInvalidValue),
//   it never falls through to the other route.
// - other widths (T2T's tokenizer widths 147 and 1323: rows not 16-byte
//   aligned): gemm_bf16 (gemm.cuh: WMMA, tiles loaded 2 bytes at a time).
// The LayerNorm runs over the true width.
// The hidden h is stored in bf16, exactly where the TPU kernel rounds it
// (fused_mlp.py:98), so the arithmetic is unchanged; its round trip through
// device memory (2 x T x F bf16) is the cost of the split. A later PR keeps h
// on chip (the hidden dim blocked inside one persistent kernel, as the TPU
// kernel does) and the LayerNorm in the GEMM prologue.
//
// The fp32 route (vt_fused_mlp_f32): with fp32 x and weights the TPU kernel
// runs both products at Precision.HIGHEST (fused_mlp.py:83-90) and keeps the
// hidden in fp32. The same three launches on fp32 throughout: ln_rows to an
// fp32 xn (or the copy without LN), fc1 with b1 and the activation in the
// epilogue of gemm_f32.cuh (fp32 FMAs on the CUDA cores), fc2 with b2 [+ x].
// Any D and F (T2T's 147 / 1,323 too): gemm_f32 reads unaligned rows one
// float at a time.

#include "common.cuh"
#include "gemm.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

namespace vt {
namespace {

// The wgmma route takes both products when every width is a multiple of 8
// (TMA's 16-byte row strides); else the WMMA route takes both.
inline bool mlp_route_wgmma(int D, int F) { return D % 8 == 0 && F % 8 == 0; }

template <typename T>
cudaError_t fused_mlp(const T* x, const float* ln_scale, const float* ln_bias, const bf16* w1,
                      const float* b1, const bf16* w2, const float* b2, T* out, bf16* xn,
                      bf16* h, int rows, int D, int F, int act, int residual, float eps,
                      cudaStream_t stream) {
  const bool wgmma = mlp_route_wgmma(D, F);
  const auto misaligned = [](const void* p) {
    return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (wgmma && (misaligned(x) || misaligned(w1) || misaligned(b1) || misaligned(w2) ||
                misaligned(b2) || misaligned(out) || misaligned(xn) || misaligned(h)))
    return cudaErrorInvalidValue;  // checked before any launch: nothing half done
  cudaError_t e = ln_rows<T>(x, ln_scale, ln_bias, xn, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  if (wgmma) {
    e = gemm_bf16_sm90<bf16>(xn, w1, h, b1, nullptr, act, rows, F, D, stream);
    if (e != cudaSuccess) return e;
    return gemm_bf16_sm90<T>(h, w2, out, b2, residual ? x : nullptr, kActNone, rows, D, F,
                             stream);
  }
  e = gemm_bf16<bf16>(xn, w1, h, b1, nullptr, act, rows, F, D, stream);
  if (e != cudaSuccess) return e;
  return gemm_bf16<T>(h, w2, out, b2, residual ? x : nullptr, kActNone, rows, D, F, stream);
}

}  // namespace
}  // namespace vt

extern "C" int vt_fused_mlp(const void* x, int x_is_fp32, const void* ln_scale,
                            const void* ln_bias, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, void* xn, void* h, int T, int D, int F,
                            int act, int residual, float eps, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::fused_mlp<float>(f(x), f(ln_scale), f(ln_bias), w(w1), f(b1), w(w2), f(b2),
                             static_cast<float*>(out), static_cast<bf16*>(xn),
                             static_cast<bf16*>(h), T, D, F, act, residual, eps, s);
  else
    e = vt::fused_mlp<bf16>(w(x), f(ln_scale), f(ln_bias), w(w1), f(b1), w(w2), f(b2),
                            static_cast<bf16*>(out), static_cast<bf16*>(xn),
                            static_cast<bf16*>(h), T, D, F, act, residual, eps, s);
  return static_cast<int>(e);
}

// 1 when vt_fused_mlp runs its two products on the wgmma GEMM at these
// widths, 0 for the WMMA GEMM (ops/fused_mlp.py gemm_route pins the rule).
extern "C" int vt_fused_mlp_route_wgmma(int D, int F) { return vt::mlp_route_wgmma(D, F); }

// The fp32 route: x, w1, w2, the scratch (xn, h) and out all fp32.
extern "C" int vt_fused_mlp_f32(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* out, void* xn, void* h, int T, int D, int F, int act,
                                int residual, float eps, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* y = static_cast<float*>(xn);
  float* hid = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = vt::ln_rows<float>(f(x), f(ln_scale), f(ln_bias), y, T, D, eps, s);
  if (e == cudaSuccess) e = vt::gemm_f32(y, f(w1), hid, f(b1), nullptr, act, T, F, D, s);
  if (e == cudaSuccess)
    e = vt::gemm_f32(hid, f(w2), static_cast<float*>(out), f(b2), residual ? f(x) : nullptr,
                     vt::kActNone, T, D, F, s);
  return static_cast<int>(e);
}

// The fp32 GEMM alone (gemm_f32.cuh): c [M, N] = act(a [M, K] @ b [K, N] +
// bias) + residual, fp32 throughout; bias and residual may be NULL.
extern "C" int vt_gemm_f32(const void* a, const void* b, void* c, const void* bias,
                           const void* residual, int act, int M, int N, int K, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return static_cast<int>(vt::gemm_f32(f(a), f(b), static_cast<float*>(c), f(bias), f(residual),
                                       act, M, N, K, static_cast<cudaStream_t>(stream)));
}
