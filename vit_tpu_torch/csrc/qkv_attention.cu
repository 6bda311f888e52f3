// Fused-qkv self-attention for Hopper:
//   out[b, i, h*Dh:(h+1)*Dh] = softmax(q_h k_h^T * scale + bias[b|0, h|0]) v_h
// straight off the fused [B, N, 3*H*Dh] bf16 projection, out [B, N, H*Dh] bf16.
//
// Replaces vit_tpu/ops/qkv_attention.py::_kernel (the Pallas TPU kernel).
// The TPU kernel holds one sample's whole fused row panel in VMEM and loops
// over heads; here one block takes 1-8 query tiles of 16 rows of one (batch,
// head) and reads its head panels out of the fused rows through their
// strides (attention_core_sm90.cuh), so no head transpose or pad copy touches
// device memory either way.
//
// Bound: memory and latency. At ViT-L (n = 197, H = 16, Dh = 64) the op
// reads the qkv rows once (3 KB a token) and writes the output once (2 KB a
// token) for ~50 KFLOP a token per head set, far below the H100's ~295
// FLOP/byte ridge. Its real callers (the int8 `w8` / `w8a8` modes) run it at
// batch 1-7, where 16-112 (b, h) pairs cannot fill 132 SMs with large tiles.
// The core keeps each warp's 197-key score row in registers, streams K and V
// through a cp.async ring, and picks its tile by the work: one warp a block
// (208 blocks) at batch 1, seven at batch 128, so each block reads its K and
// V once or twice. The bias, when given, is another N*N fp32 per (batch,
// head) it varies over.
//
// The fp32 route (vt_qkv_attention_f32): fp32 qkv, which the TPU kernel runs
// at Precision.HIGHEST (qkv_attention.py:44-48) with P kept in fp32, goes to
// the fp32 core of attention_f32.cuh on the same fused rows, with the same
// bias, into fp32 out. Bound: operations at the card's fp32 rate (NesT's
// level 0 at batch 128: 2,048 blocks of 196 tokens, 3 heads of 32).

#include "attention_core_sm90.cuh"
#include "attention_f32.cuh"
#include "common.cuh"

extern "C" int vt_qkv_attention(const void* qkv, const void* bias, int bias_b, int bias_h,
                                void* out, int B, int N, int H, int Dh, float scale,
                                void* stream) {
  using vt::bf16;
  const vt::attn::ScoreTerms st{static_cast<const float*>(bias), bias_b, bias_h, N, N};
  const cudaError_t e = vt::attention_core_sm90(static_cast<const bf16*>(qkv),
                                                static_cast<bf16*>(out), B, N, H, Dh, scale, st,
                                                static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// The fp32 route: qkv [B, N, 3*H*Dh] and out [B, N, H*Dh] fp32.
extern "C" int vt_qkv_attention_f32(const void* qkv, const void* bias, int bias_b, int bias_h,
                                    void* out, int B, int N, int H, int Dh, float scale,
                                    void* stream) {
  const vt::attn::ScoreTerms st{static_cast<const float*>(bias), bias_b, bias_h, N, N};
  return static_cast<int>(vt::attention_f32(static_cast<const float*>(qkv),
                                            static_cast<float*>(out), B, N, H, Dh, scale, st,
                                            static_cast<cudaStream_t>(stream)));
}
