// The softmax-attention core of the window attention block's four-launch
// route (window_attention_block.cu, kernel 6, windows of more than 64 tokens
// or tiles past 227 KB): one window per batch entry, a per-window bias shared
// by every window. Kernels 1, 3, 4 and 9 run on the register-resident core of
// attention_core_sm90.cuh, which computes the same softmax and takes its
// Operand, Problem and ScoreTerms from here.
//
// One block: batch b, head h, query rows [q0, q0 + QT). It reads the q, k and
// v head panels through their own strides (Operand: the fused [B*N, 3*H*Dh]
// rows of the blocks, or the [B, H, N, D] views of split_heads) and writes
// rows of out through its strides. Per query row, in jax.nn.softmax's order:
//   s = (q . k) * scale [+ bias] [masked]; m = max; e = exp(s - m);
//   l = sum(e); p = e / l, rounded to bf16; o = p @ v in fp32.
// This is the arithmetic of vit_tpu/ops/block_attention.py:105-120,
// qkv_attention.py:54-70, quant_block.py:81-97, flash_attention.py:74-108 and
// window_attention.py:105-129. The scale, bias and mask are applied with
// explicit round-to-nearest intrinsics, so no fused multiply-add changes a
// score against the twins' separate ops.
//
// Bound: at n = 197 the core moves ~3 KB of qkv per query row and does
// ~50 KFLOP on it, below the ridge: memory- and latency-bound. Design: the
// fp32 score rows of the tile over all keys stay in shared memory (exact
// softmax, no online rescale), K and V stream through in 64-key chunks, and
// the query tiles of one (b, h) launch next to each other (a 1-D grid, query
// tile fastest) so the K/V panels they share stay in L2. The 1-D grid has no
// 65535 limit on the (b, h) pairs.
#pragma once

#include <float.h>
#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace vt {
namespace {

namespace attn {
constexpr int QT = 32;  // query rows per block
constexpr int KC = 64;  // keys per K/V chunk in shared memory
constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most one block may use
// flash_attention.py:40: the mask_self diagonal. The key mask (kernels 1 and
// 9, on attention_core_sm90.cuh) keeps block_attention.py's -1e30.
constexpr float MASK_SELF = -0.7f * FLT_MAX;

struct Layout {
  int n_pad, ldq, ldkv, lds, ldp;
  size_t q_off, kv_off, s_off, p_off, bytes;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// Shared memory: the Q tile, one K or V chunk, the fp32 score rows of the
// tile over all Nk keys (reused to stage the output), and the bf16 P rows.
// With Dv == D it is the fused-qkv layout's (kernel 6).
__host__ __device__ inline Layout layout(int Nk, int D, int Dv) {
  Layout L;
  L.n_pad = (Nk + KC - 1) / KC * KC;
  L.ldq = D + 8;
  L.ldkv = (D > Dv ? D : Dv) + 8;
  L.lds = (L.n_pad > Dv ? L.n_pad : Dv) + 4;
  L.ldp = L.n_pad + 8;
  L.q_off = 0;
  L.kv_off = align128(L.q_off + size_t(QT) * L.ldq * sizeof(bf16));
  L.s_off = align128(L.kv_off + size_t(KC) * L.ldkv * sizeof(bf16));
  L.p_off = align128(L.s_off + size_t(QT) * L.lds * sizeof(float));
  L.bytes = align128(L.p_off + size_t(QT) * L.ldp * sizeof(bf16));
  return L;
}

// One operand: element (b, h, row, col) at base + b*sb + h*sh + row*sr + col
// (strides in elements; base, sb, sh and sr 16-byte aligned).
template <typename T>
struct Operand {
  T* base;
  long long sb, sh, sr;
  __device__ __forceinline__ T* at(int b, int h) const { return base + b * sb + h * sh; }
};

struct Problem {
  int B, H, Nq, Nk, D, Dv;
};

// What a caller adds to the scores: an fp32 bias [Bb, Bh, Nq, Nk] (NULL:
// none; bias_b / bias_h say whether its batch / head axis is full or
// broadcast), the key mask (col % bt < true_n, and same sample when bt < Nk;
// -1e30), and the mask_self diagonal (col == row; MASK_SELF).
struct ScoreTerms {
  const float* bias;
  int bias_b, bias_h;
  int true_n, bt;
  int mask_self;
};
}  // namespace attn

// Copies rows [row0, row0 + rows) of `cols` columns at src (row stride `sr`)
// into shared memory; rows past n are zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, long long sr,
                                          int row0, int rows, int n, int cols) {
  const int chunks = cols / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks, dc = (c % chunks) * 8;
    const int g = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < n) v = *reinterpret_cast<const uint4*>(src + g * sr + dc);
    *reinterpret_cast<uint4*>(dst + r * ld + dc) = v;
  }
}

// One head panel (Dh columns from column `col`) of the [B*N, 3*H*Dh] rows.
__device__ __forceinline__ void load_panel(bf16* dst, int ld, const bf16* base, int row0,
                                           int rows, int N, int stride, int col, int Dh) {
  load_rows(dst, ld, base + col, stride, row0, rows, N, Dh);
}

template <typename OutT>
__global__ void __launch_bounds__(attn::THREADS)
attention_core_kernel(attn::Operand<const bf16> q, attn::Operand<const bf16> k,
                      attn::Operand<const bf16> v, attn::Operand<OutT> out, attn::Problem pr,
                      float scale, attn::ScoreTerms st) {
  using namespace nvcuda;
  using namespace attn;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(pr.Nk, pr.D, pr.Dv);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q_off);
  bf16* KVs = reinterpret_cast<bf16*>(smem + L.kv_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p_off);

  const int qtiles = (pr.Nq + QT - 1) / QT;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / pr.H, h = bh % pr.H;
  const int q0 = (blockIdx.x % qtiles) * QT;
  const int Nk = pr.Nk, D = pr.D, Dv = pr.Dv;
  const bf16* kp = k.at(b, h);
  const bf16* vp = v.at(b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = L.n_pad / KC;

  load_rows(Qs, L.ldq, q.at(b, h), q.sr, q0, QT, pr.Nq, D);

  // S = Q K^T in fp32, chunk by chunk of keys.
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();  // previous chunk's readers are done with KVs
    load_rows(KVs, L.ldkv, kp, k.sr, ch * KC, KC, Nk, D);
    __syncthreads();
    for (int t = warp; t < (QT / 16) * (KC / 16); t += WARPS) {
      const int ti = t / (KC / 16), tj = t % (KC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
        wmma::load_matrix_sync(a, Qs + ti * 16 * L.ldq + kk, L.ldq);
        wmma::load_matrix_sync(kt, KVs + tj * 16 * L.ldkv + kk, L.ldkv);  // K^T
        wmma::mma_sync(acc, a, kt, acc);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * L.lds + ch * KC + tj * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Scale, bias, masks, softmax; one warp per row. Columns >= Nk do not exist.
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
      if (brow != nullptr) s = __fadd_rn(s, brow[c]);
      if (masked && !((c % st.bt) < st.true_n && (st.bt == Nk || c / st.bt == qr / st.bt)))
        s = -1e30f;
      if (st.mask_self && c == qr) s = MASK_SELF;
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
    bf16* prow = Ps + r * L.ldp;
    for (int c = lane; c < L.n_pad; c += 32)
      prow[c] = __float2bfloat16(c < Nk ? srow[c] / l : 0.0f);
  }

  // O = P V, accumulated over the key chunks in fp32 fragments.
  const int dt = Dv / 16;
  const int otiles = (QT / 16) * dt;  // <= 16 for Dv <= 128: <= 4 per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) wmma::fill_fragment(oacc[u], 0.0f);
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();
    load_rows(KVs, L.ldkv, vp, v.sr, ch * KC, KC, Nk, Dv);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = warp + WARPS * u;
      if (t < otiles) {
        const int ti = t / dt, tj = t % dt;
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(p, Ps + ti * 16 * L.ldp + ch * KC + kk, L.ldp);
          wmma::load_matrix_sync(vf, KVs + kk * L.ldkv + tj * 16, L.ldkv);
          wmma::mma_sync(oacc[u], p, vf, oacc[u]);
        }
      }
    }
  }
  __syncthreads();  // the score rows are dead: stage the output there
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = warp + WARPS * u;
    if (t < otiles) {
      const int ti = t / dt, tj = t % dt;
      wmma::store_matrix_sync(Ss + ti * 16 * L.lds + tj * 16, oacc[u], L.lds,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  OutT* op = out.at(b, h);
  for (int e = threadIdx.x; e < QT * Dv; e += blockDim.x) {
    const int r = e / Dv, c = e % Dv;
    const int qr = q0 + r;
    if (qr < pr.Nq) store_as(op + qr * out.sr + c, Ss[r * L.lds + c]);
  }
}

// The general entry: q [B, H, Nq, D], k [B, H, Nk, D], v [B, H, Nk, Dv], out
// [B, H, Nq, Dv], each through its own strides. D, Dv <= 128 and multiples
// of 16; the score rows of Nk keys must fit shared memory.
template <typename OutT>
cudaError_t attention_core(attn::Operand<const bf16> q, attn::Operand<const bf16> k,
                           attn::Operand<const bf16> v, attn::Operand<OutT> out,
                           attn::Problem pr, float scale, attn::ScoreTerms st,
                           cudaStream_t stream) {
  using namespace attn;
  const Layout L = layout(pr.Nk, pr.D, pr.Dv);
  const long long blocks = (long long)pr.B * pr.H * ((pr.Nq + QT - 1) / QT);
  if (L.bytes > size_t(MAX_SMEM) || pr.D % 16 != 0 || pr.D > 128 || pr.Dv % 16 != 0 ||
      pr.Dv > 128 || pr.Nk < 1 || blocks < 1 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_core_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.bytes));
  if (e != cudaSuccess) return e;
  attention_core_kernel<OutT><<<static_cast<unsigned>(blocks), THREADS, L.bytes, stream>>>(
      q, k, v, out, pr, scale, st);
  return cudaGetLastError();
}

// Self-attention on the fused [B*N, 3*H*Dh] qkv rows ([q | k | v], each
// [H, Dh]) into out [B*N, H*Dh]: the layout of kernel 6's four-launch route.
template <typename OutT>
cudaError_t attention_core(const bf16* qkv, OutT* out, int B, int N, int H, int Dh, float scale,
                           attn::ScoreTerms st, cudaStream_t stream) {
  using namespace attn;
  const long long HD = (long long)H * Dh, row = 3 * HD;
  const Operand<const bf16> q{qkv, N * row, Dh, row};
  const Operand<const bf16> k{qkv + HD, N * row, Dh, row};
  const Operand<const bf16> v{qkv + 2 * HD, N * row, Dh, row};
  const Operand<OutT> o{out, N * HD, Dh, HD};
  return attention_core<OutT>(q, k, v, o, Problem{B, H, N, N, Dh, Dh}, scale, st, stream);
}

}  // namespace
}  // namespace vt
