// The fp32 softmax-attention core for Hopper, under the fp32 routes of
// kernels 1 (attention_block.cu), 3 (qkv_attention.cu), 4
// (flash_attention.cu) and 6 (window_attention_block.cu); its row loader and
// score tile (load_rows, score_tile) are also those of kernel 5's fp32 route
// (flash_attention_kv_blocked.cu).
//
// With fp32 operands the TPU kernels run every product at Precision.HIGHEST
// (vit_tpu/ops/block_attention.py:62-66, qkv_attention.py:44-48,
// flash_attention.py:64-67, window_attention.py:74-76), and P stays fp32
// (its astype to v's dtype is a no-op). Per query row, in jax.nn.softmax's
// order, with the score terms of attention_core.cuh:
//   s = __fmul_rn(q . k, scale) [__fadd_rn bias] [key mask -1e30]
//       [mask_self diagonal -0.7 FLT_MAX]; m = the exact row max;
//   e = expf(s - m); l = sum(e); p = e / l (IEEE division);
//   o = p @ v, fp32.
// Every product is an fp32 fused multiply-add on the CUDA cores: no TF32 and
// no bf16 operand. q . k sums its D products in order d = 0..D-1, p @ v its
// keys in order 0..Nk-1, and each row's max and sum reduce over one warp in
// one fixed order, so a row's result depends on nothing but its own (b, h)
// and the kernels stay batch-invariant.
//
// Bound: operations. At ViT-L/16 (197 tokens, 16 heads of 64) a (b, h)
// takes 2 x 2 x 197^2 x 64 = 9.9 MFLOP for 151 KB of q, k, v and out: ~65
// FLOP a byte, above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design (simple first; no wgmma, no TMA): one block of 256 threads owns 32
// query rows of one (b, h) (a 1-D grid, the query tiles of a (b, h) next to
// each other, so that they find its K and V in L2). Operands are read through
// their (sb, sh, sr) strides (attn::Operand): kernels 1 and 3 read the head
// panels of the fused [B*N, 3*H*Dh] qkv rows, kernel 4 the [B, H, N, D]
// views of split_heads (Nq != Nk, Dv != D), kernel 6 takes its windows as
// the batch axis. Shared memory holds the Q tile, one chunk of 64 K or V
// rows, and the fp32 score rows of the tile over all Nk keys (Nk up to
// 1,088 at D 64: 140 KB), so the softmax is exact and no score is
// recomputed:
//   1. Q K^T chunk by chunk: a thread owns 2 rows x 4 keys of the 32 x 64
//      chunk, reading a float4 of each of its rows and keys a step of four
//      d (6 shared loads for 32 FMAs; the row strides, D + 4 floats, keep
//      the 16-byte reads free of bank conflicts).
//   2. The softmax, a warp a row, written back as p in place.
//   3. P V chunk by chunk: a thread owns a float4 of output columns of up to
//      4 rows, reading a float4 of p of each row and of V of each key.
// Rows past Nq read zeros and are not stored; keys past Nk are zeros in the
// chunk and get p = 0. The fp32 head-mix core's products
// (head_mix_core.cuh score_tile_f32) are not shared: they read qkv rows
// through L1 into the bf16 core's fragment positions, which its slab and
// mixes need; here the score rows sit in shared memory in row order.
#pragma once

#include <float.h>
#include <math.h>

#include "attention_core.cuh"  // attn::Operand, Problem, ScoreTerms, MASK_SELF, align128
#include "common.cuh"

namespace vt {
namespace {

namespace af32 {
constexpr int QT = 32;  // query rows a block
constexpr int KC = 64;  // keys a K or V chunk
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most one block may use

struct Layout {
  int n_pad, ldq, ldkv, lds;
  size_t q_off, kv_off, s_off, bytes;
};

// Shared memory (floats): the Q tile [QT][D + 4], one K or V chunk [KC][max(D,
// Dv) + 4], the score rows [QT][n_pad + 4]. ops/flash_attention.py
// f32_core_bytes mirrors it.
__host__ __device__ inline Layout layout(int Nk, int D, int Dv) {
  Layout L;
  L.n_pad = (Nk + KC - 1) / KC * KC;
  L.ldq = D + 4;
  L.ldkv = (D > Dv ? D : Dv) + 4;
  L.lds = L.n_pad + 4;
  L.q_off = 0;
  L.kv_off = attn::align128(size_t(QT) * L.ldq * sizeof(float));
  L.s_off = attn::align128(L.kv_off + size_t(KC) * L.ldkv * sizeof(float));
  L.bytes = attn::align128(L.s_off + size_t(QT) * L.lds * sizeof(float));
  return L;
}

// Rows [row0, row0 + rows) x columns [col0, col0 + cols4) of fp32 src (row
// stride sr) into shared memory at row stride ld; rows past n and columns
// past ncols are zeros. vec: 16 bytes at a time, the tile's float4s spread
// over the block (src, sr, col0 and cols4 multiples of 4 floats, col0 + cols4
// <= ncols); else 4 bytes at a time, a warp a row.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long sr,
                                          int row0, int rows, int n, int col0, int cols4,
                                          int ncols, bool vec) {
  if (vec) {
    const int chunks = cols4 / 4;
    for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
      const int r = c / chunks, dc = (c % chunks) * 4;
      const int g = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < n) v = __ldg(reinterpret_cast<const float4*>(src + g * sr + col0 + dc));
      *reinterpret_cast<float4*>(dst + r * ld + dc) = v;
    }
    return;
  }
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rows; r += blockDim.x / 32) {
    const int g = row0 + r;
    const float* s = src + (long long)g * sr + col0;
    for (int c = lane; c < cols4; c += 32)
      dst[r * ld + c] = g < n && col0 + c < ncols ? __ldg(s + c) : 0.f;
  }
}

// The 32 x 64 score tile's products over columns [0, cols4) (a multiple of 4)
// of the Q rows at Qs (row stride ldq) and the 64 K rows at Ks (row stride
// ldk), added to s0 and s1: thread (ty, tx) = (t / 16, t % 16) of 256 owns
// rows ty, ty + 16 and keys tx + 16 j, reading a float4 of each a step of
// four columns (6 shared loads for 32 FMAs), the columns summed in order.
__device__ __forceinline__ void score_tile(float (&s0)[4], float (&s1)[4], const float* Qs,
                                           int ldq, const float* Ks, int ldk, int cols4) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qa = Qs + ty * ldq;
  const float* qb = Qs + (ty + 16) * ldq;
  const float* kr = Ks + tx * ldk;
  for (int d = 0; d < cols4; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(qa + d);
    const float4 c = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + j * 16 * ldk + d);
      s0[j] = fmaf(a.x, kk.x, s0[j]);
      s0[j] = fmaf(a.y, kk.y, s0[j]);
      s0[j] = fmaf(a.z, kk.z, s0[j]);
      s0[j] = fmaf(a.w, kk.w, s0[j]);
      s1[j] = fmaf(c.x, kk.x, s1[j]);
      s1[j] = fmaf(c.y, kk.y, s1[j]);
      s1[j] = fmaf(c.z, kk.z, s1[j]);
      s1[j] = fmaf(c.w, kk.w, s1[j]);
    }
  }
}
}  // namespace af32

__global__ void __launch_bounds__(af32::THREADS)
attention_f32_kernel(attn::Operand<const float> q, attn::Operand<const float> k,
                     attn::Operand<const float> v, attn::Operand<float> out, attn::Problem pr,
                     float scale, attn::ScoreTerms st) {
  using namespace af32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(pr.Nk, pr.D, pr.Dv);
  float* Qs = reinterpret_cast<float*>(smem + L.q_off);
  float* KVs = reinterpret_cast<float*>(smem + L.kv_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);

  const int qtiles = (pr.Nq + QT - 1) / QT;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / pr.H, h = bh % pr.H;
  const int q0 = (blockIdx.x % qtiles) * QT;
  const int Nk = pr.Nk, D = pr.D, Dv = pr.Dv;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int chunks = L.n_pad / KC;

  load_rows(Qs, L.ldq, q.at(b, h), q.sr, q0, QT, pr.Nq, 0, D, D, true);

  // 1. S = Q K^T, chunk by chunk (score_tile).
  {
    const int tx = t % 16, ty = t / 16;
    for (int ch = 0; ch < chunks; ++ch) {
      __syncthreads();  // the Q tile is in; the last chunk's readers are done
      load_rows(KVs, L.ldkv, k.at(b, h), k.sr, ch * KC, KC, Nk, 0, D, D, true);
      __syncthreads();
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      score_tile(s0, s1, Qs, L.ldq, KVs, L.ldkv, D);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ss[ty * L.lds + ch * KC + tx + 16 * j] = s0[j];
        Ss[(ty + 16) * L.lds + ch * KC + tx + 16 * j] = s1[j];
      }
    }
  }
  __syncthreads();

  // 2. Scale, bias, masks and the softmax, a warp a row; p written in place,
  // 0 for the keys past Nk.
  const bool masked = st.true_n != st.bt || st.bt != Nk;
  const float* bias_bh = nullptr;
  if (st.bias != nullptr) {
    const int nbh = st.bias_h ? pr.H : 1;
    bias_bh = st.bias + ((size_t)(st.bias_b ? b : 0) * nbh + (st.bias_h ? h : 0)) *
                            (size_t)pr.Nq * Nk;
  }
  for (int r = warp; r < QT; r += WARPS) {
    const int qr = q0 + r;
    float* srow = Ss + r * L.lds;
    const float* brow = (bias_bh != nullptr && qr < pr.Nq) ? bias_bh + (size_t)qr * Nk : nullptr;
    float m = -INFINITY;
    for (int c = lane; c < Nk; c += 32) {
      float s = __fmul_rn(srow[c], scale);
      if (brow != nullptr) s = __fadd_rn(s, __ldg(brow + c));
      if (masked && !((c % st.bt) < st.true_n && (st.bt == Nk || c / st.bt == qr / st.bt)))
        s = -1e30f;
      if (st.mask_self && c == qr) s = attn::MASK_SELF;
      srow[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < Nk; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int c = lane; c < L.n_pad; c += 32) srow[c] = c < Nk ? __fdiv_rn(srow[c], l) : 0.f;
  }

  // 3. O = P V: thread t owns the float4 of columns 4 g (g = t % GP) of rows
  // t / GP + u * (THREADS / GP), u = 0..3 while below QT (GP, the column
  // groups rounded up to a power of two, 4 to 32).
  const int G = Dv / 4;
  const int GP = G <= 4 ? 4 : G <= 8 ? 8 : G <= 16 ? 16 : 32;
  const int g = t % GP, r0 = t / GP, rs = THREADS / GP;
  float4 o[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();  // the softmax, or the last chunk's readers, are done
    load_rows(KVs, L.ldkv, v.at(b, h), v.sr, ch * KC, KC, Nk, 0, Dv, Dv, true);
    __syncthreads();
    if (g >= G) continue;
    const float* vc = KVs + 4 * g;
    for (int j = 0; j < KC; j += 4) {
      float4 vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = *reinterpret_cast<const float4*>(vc + (j + i) * L.ldkv);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u * rs;
        if (r < QT) {
          const float4 p = *reinterpret_cast<const float4*>(Ss + r * L.lds + ch * KC + j);
          const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[u].x = fmaf(pj[i], vv[i].x, o[u].x);
            o[u].y = fmaf(pj[i], vv[i].y, o[u].y);
            o[u].z = fmaf(pj[i], vv[i].z, o[u].z);
            o[u].w = fmaf(pj[i], vv[i].w, o[u].w);
          }
        }
      }
    }
  }
  if (g >= G) return;
  float* op = out.at(b, h);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + u * rs, qr = q0 + r;
    if (r < QT && qr < pr.Nq) *reinterpret_cast<float4*>(op + qr * out.sr + 4 * g) = o[u];
  }
}

// The general entry: q [B, H, Nq, D], k [B, H, Nk, D], v [B, H, Nk, Dv],
// out [B, H, Nq, Dv], fp32, each through its own strides (unit column
// stride; base, sb, sh and sr multiples of 16 bytes). D, Dv multiples of 4
// up to 128; the score rows of Nk keys must fit shared memory (layout).
inline cudaError_t attention_f32(attn::Operand<const float> q, attn::Operand<const float> k,
                                 attn::Operand<const float> v, attn::Operand<float> out,
                                 attn::Problem pr, float scale, attn::ScoreTerms st,
                                 cudaStream_t stream) {
  using namespace af32;
  const Layout L = layout(pr.Nk, pr.D, pr.Dv);
  const auto aligned = [](const void* p, long long sb, long long sh, long long sr) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 && sr % 4 == 0;
  };
  const long long blocks = (long long)pr.B * pr.H * ((pr.Nq + QT - 1) / QT);
  if (pr.D % 4 != 0 || pr.D < 4 || pr.D > 128 || pr.Dv % 4 != 0 || pr.Dv < 4 || pr.Dv > 128 ||
      pr.Nk < 1 || pr.Nq < 1 || blocks < 1 || blocks > 0x7fffffffLL ||
      L.bytes > size_t(MAX_SMEM) || !aligned(q.base, q.sb, q.sh, q.sr) ||
      !aligned(k.base, k.sb, k.sh, k.sr) || !aligned(v.base, v.sb, v.sh, v.sr) ||
      !aligned(out.base, out.sb, out.sh, out.sr))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.bytes));
  if (e != cudaSuccess) return e;
  attention_f32_kernel<<<static_cast<unsigned>(blocks), THREADS, L.bytes, stream>>>(
      q, k, v, out, pr, scale, st);
  return cudaGetLastError();
}

// Self-attention on fused fp32 [B*N, 3*H*Dh] qkv rows ([q | k | v], each
// [H, Dh]) into fp32 out [B*N, H*Dh]: kernels 1, 3 and 6.
inline cudaError_t attention_f32(const float* qkv, float* out, int B, int N, int H, int Dh,
                                 float scale, attn::ScoreTerms st, cudaStream_t stream) {
  using attn::Operand;
  const long long HD = (long long)H * Dh, row = 3 * HD;
  const Operand<const float> q{qkv, N * row, Dh, row};
  const Operand<const float> k{qkv + HD, N * row, Dh, row};
  const Operand<const float> v{qkv + 2 * HD, N * row, Dh, row};
  const Operand<float> o{out, N * HD, Dh, HD};
  return attention_f32(q, k, v, o, attn::Problem{B, H, N, N, Dh, Dh}, scale, st, stream);
}

}  // namespace
}  // namespace vt
