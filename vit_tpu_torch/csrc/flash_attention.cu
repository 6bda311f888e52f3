// Multi-head attention with separate q, k, v for Hopper:
//   out[b, h] = softmax(q[b, h] k[b, h]^T * scale + bias[b|0, h|0], mask_self) v[b, h]
// q [B, H, Nq, D], k [B, H, Nk, D], v [B, H, Nk, Dv] bf16, out [B, H, Nq, Dv]
// bf16, each read or written through its own strides.
//
// Replaces vit_tpu/ops/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel). The TPU kernel keeps one (b, h)'s whole K and V resident in VMEM
// and does one exact softmax per Q tile; here one block takes 1-8 query
// tiles of 16 rows of one (b, h) and streams K and V through a cp.async ring
// in 64-key chunks (attention_core_sm90.cuh): the same exact softmax, the
// same bf16 rounding of the normalised P. Keys past Nk do not exist in the
// kernel (their P is 0), which is the TPU kernel's true_nk mask of its
// padded keys.
//
// No copies: the strides let the kernel read the [B, H, N, D] views that
// split_heads makes of [B, N, H*D] rows (Twins' GSA queries: 411 MB at stage
// 1 and batch 128), and write its output as [B, Nq, H, Dv] rows, so that
// merge_heads is a view.
//
// Bound: memory. At Twins-SVT's stage 1 (Nq = 3136, Nk = 64, D = 64) a query
// row reads 128 B and writes 128 B for ~16 KFLOP, below the H100's ~295
// FLOP/byte ridge: the op is a stream of q rows in and output rows out. The
// core loads 128 query rows a block with 16-byte cp.async copies, keeps the
// 64-key score rows in registers, and writes the output in 16-byte stores;
// K and V (16 KB per (b, h)) are read from L2 by 25 blocks per (b, h), where
// 32-row tiles read them 98 times.
//
// The fp32 route (vt_flash_attention_f32): fp32 q, k and v, which the TPU
// kernel runs at Precision.HIGHEST (flash_attention.py:64-67) with P kept in
// fp32, go to the fp32 core of attention_f32.cuh through the same strides,
// with the same bias and mask_self, into fp32 out (Nq != Nk: CvT's 3,136
// queries against 784 keys; Dv != D: LeViT's 32 / 64). Bound: operations
// at the card's fp32 rate where keys are many, bytes where few (Twins' GSA:
// 64 keys).

#include "attention_core_sm90.cuh"
#include "attention_f32.cuh"
#include "common.cuh"

extern "C" int vt_flash_attention(const void* q, long long q_sb, long long q_sh, long long q_sr,
                                  const void* k, long long k_sb, long long k_sh, long long k_sr,
                                  const void* v, long long v_sb, long long v_sh, long long v_sr,
                                  void* out, long long o_sb, long long o_sh, long long o_sr,
                                  int B, int H, int Nq, int Nk, int D, int Dv, float scale,
                                  const void* bias, int bias_b, int bias_h, int mask_self,
                                  void* stream) {
  using vt::bf16;
  using namespace vt::attn;
  const auto in = [](const void* p, long long sb, long long sh, long long sr) {
    return Operand<const bf16>{static_cast<const bf16*>(p), sb, sh, sr};
  };
  const ScoreTerms st{static_cast<const float*>(bias), bias_b, bias_h, Nk, Nk, mask_self};
  const cudaError_t e = vt::attention_core_sm90(
      in(q, q_sb, q_sh, q_sr), in(k, k_sb, k_sh, k_sr), in(v, v_sb, v_sh, v_sr),
      Operand<bf16>{static_cast<bf16*>(out), o_sb, o_sh, o_sr}, Problem{B, H, Nq, Nk, D, Dv},
      scale, st, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// Warps a block of the core takes for this shape on the current card: the
// tile choice the card tests of batch invariance hold apart.
extern "C" int vt_attention_sm90_warps(int B, int H, int Nq, int Nk, int D, int Dv) {
  const vt::attn::Problem pr{B, H, Nq, Nk, D, Dv};
  return vt::attn90::plan_for(vt::attn90::variant(pr), pr).warps;
}

// The fp32 route: q, k, v and out fp32, the rest as vt_flash_attention's.
extern "C" int vt_flash_attention_f32(const void* q, long long q_sb, long long q_sh,
                                      long long q_sr, const void* k, long long k_sb,
                                      long long k_sh, long long k_sr, const void* v,
                                      long long v_sb, long long v_sh, long long v_sr, void* out,
                                      long long o_sb, long long o_sh, long long o_sr, int B,
                                      int H, int Nq, int Nk, int D, int Dv, float scale,
                                      const void* bias, int bias_b, int bias_h, int mask_self,
                                      void* stream) {
  using namespace vt::attn;
  const auto in = [](const void* p, long long sb, long long sh, long long sr) {
    return Operand<const float>{static_cast<const float*>(p), sb, sh, sr};
  };
  const ScoreTerms st{static_cast<const float*>(bias), bias_b, bias_h, Nk, Nk, mask_self};
  const cudaError_t e = vt::attention_f32(
      in(q, q_sb, q_sh, q_sr), in(k, k_sb, k_sh, k_sr), in(v, v_sb, v_sh, v_sr),
      Operand<float>{static_cast<float*>(out), o_sb, o_sh, o_sr}, Problem{B, H, Nq, Nk, D, Dv},
      scale, st, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// The fp32 core's plan for Nk keys of widths D, Dv (attention_f32.cuh):
// out[0] query rows a block, out[1] threads a block, out[2] shared-memory
// bytes. ops/flash_attention.py f32_core_bytes mirrors it.
extern "C" int vt_attention_f32_plan(int Nk, int D, int Dv, int* out) {
  out[0] = vt::af32::QT;
  out[1] = vt::af32::THREADS;
  out[2] = static_cast<int>(vt::af32::layout(Nk, D, Dv).bytes);
  return 0;
}
