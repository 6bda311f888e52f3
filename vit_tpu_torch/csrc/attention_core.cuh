// The softmax-attention core shared by three kernels:
//   - the float attention block (attention_block.cu): bf16 output, masks;
//   - the fused-qkv attention (qkv_attention.cu): bf16 output, optional bias;
//   - the W8A8 attention block (quant_block.cu): fp32 output, true_n mask.
//
// One block: batch b, head h, query rows [q0, q0 + QT). It reads the q/k/v
// head panels straight out of the fused [B*N, 3*H*Dh] bf16 rows and writes
// rows of out [B*N, H*Dh]. Per query row, in jax.nn.softmax's order:
//   s = (q . k) * scale [+ bias] [masked to -1e30]; m = max; e = exp(s - m);
//   l = sum(e); p = e / l, rounded to bf16; o = p @ v in fp32.
// This is the arithmetic of vit_tpu/ops/block_attention.py:105-120,
// qkv_attention.py:54-70 and quant_block.py:81-97. The scale, bias and mask
// are applied with explicit round-to-nearest intrinsics, so no fused
// multiply-add changes a score against the twins' separate ops.
//
// Bound: at n = 197 the core moves ~3 KB of qkv per query row and does
// ~50 KFLOP on it, below the ridge: memory- and latency-bound. Design: the
// fp32 score rows of the tile over all keys stay in shared memory (exact
// softmax, no online rescale), K and V stream through in 64-key chunks, and
// the query tiles of one (b, h) launch next to each other so the K/V panels
// they share stay in L2.
#pragma once

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

struct Layout {
  int n_pad, ldq, lds, ldp;
  size_t q_off, kv_off, s_off, p_off, bytes;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// Shared memory: the Q tile, one K or V chunk, the fp32 score rows of the
// tile over all keys (reused to stage the output), and the bf16 P rows.
__host__ __device__ inline Layout layout(int N, int Dh) {
  Layout L;
  L.n_pad = (N + KC - 1) / KC * KC;
  L.ldq = Dh + 8;
  L.lds = (L.n_pad > Dh ? L.n_pad : Dh) + 4;
  L.ldp = L.n_pad + 8;
  L.q_off = 0;
  L.kv_off = align128(L.q_off + size_t(QT) * L.ldq * sizeof(bf16));
  L.s_off = align128(L.kv_off + size_t(KC) * L.ldq * sizeof(bf16));
  L.p_off = align128(L.s_off + size_t(QT) * L.lds * sizeof(float));
  L.bytes = align128(L.p_off + size_t(QT) * L.ldp * sizeof(bf16));
  return L;
}

// What a caller adds to the scores: an fp32 bias [Bb, Bh, N, N] (NULL: none;
// bias_b / bias_h say whether its batch / head axis is full or broadcast),
// and the key mask (col % bt < true_n, and same sample when bt < N).
struct ScoreTerms {
  const float* bias;
  int bias_b, bias_h;
  int true_n, bt;
};
}  // namespace attn

// Copies rows [row0, row0 + rows) of one head panel (Dh columns starting at
// column `col`) of the [B*N, 3*H*Dh] qkv buffer into shared memory; rows past
// N are zero-filled.
__device__ __forceinline__ void load_panel(bf16* dst, int ld, const bf16* base, int row0,
                                           int rows, int N, int stride, int col, int Dh) {
  const int chunks = Dh / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks, dc = (c % chunks) * 8;
    const int g = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < N) v = *reinterpret_cast<const uint4*>(base + (size_t)g * stride + col + dc);
    *reinterpret_cast<uint4*>(dst + r * ld + dc) = v;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(attn::THREADS)
attention_core_kernel(const bf16* __restrict__ qkv, OutT* __restrict__ out, int N, int H, int Dh,
                      float scale, attn::ScoreTerms st) {
  using namespace nvcuda;
  using namespace attn;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(N, Dh);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q_off);
  bf16* KVs = reinterpret_cast<bf16*>(smem + L.kv_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p_off);

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * QT;
  const int HD = H * Dh, stride = 3 * HD;
  const bf16* base = qkv + (size_t)b * N * stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = L.n_pad / KC;

  load_panel(Qs, L.ldq, base, q0, QT, N, stride, h * Dh, Dh);

  // S = Q K^T in fp32, chunk by chunk of keys.
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();  // previous chunk's readers are done with KVs
    load_panel(KVs, L.ldq, base, ch * KC, KC, N, stride, HD + h * Dh, Dh);
    __syncthreads();
    for (int t = warp; t < (QT / 16) * (KC / 16); t += WARPS) {
      const int ti = t / (KC / 16), tj = t % (KC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < Dh; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
        wmma::load_matrix_sync(a, Qs + ti * 16 * L.ldq + kk, L.ldq);
        wmma::load_matrix_sync(kt, KVs + tj * 16 * L.ldq + kk, L.ldq);  // K^T
        wmma::mma_sync(acc, a, kt, acc);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * L.lds + ch * KC + tj * 16, acc, L.lds,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Scale, bias, mask, softmax; one warp per row. Columns >= N do not exist.
  const bool masked = st.true_n != st.bt || st.bt != N;
  const float* bias_bh = nullptr;
  if (st.bias != nullptr) {
    const int bh = st.bias_h ? H : 1;
    bias_bh = st.bias + ((size_t)(st.bias_b ? b : 0) * bh + (st.bias_h ? h : 0)) * N * N;
  }
  for (int r = warp; r < QT; r += WARPS) {
    const int q = q0 + r;
    float* srow = Ss + r * L.lds;
    const float* brow = (bias_bh != nullptr && q < N) ? bias_bh + (size_t)q * N : nullptr;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) {
      float s = __fmul_rn(srow[c], scale);
      if (brow != nullptr) s = __fadd_rn(s, brow[c]);
      if (masked && !((c % st.bt) < st.true_n && (st.bt == N || c / st.bt == q / st.bt)))
        s = -1e30f;
      srow[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    bf16* prow = Ps + r * L.ldp;
    for (int c = lane; c < L.n_pad; c += 32)
      prow[c] = __float2bfloat16(c < N ? srow[c] / l : 0.0f);
  }

  // O = P V, accumulated over the key chunks in fp32 fragments.
  const int dt = Dh / 16;
  const int otiles = (QT / 16) * dt;  // <= 16 for Dh <= 128: <= 4 per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) wmma::fill_fragment(oacc[u], 0.0f);
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();
    load_panel(KVs, L.ldq, base, ch * KC, KC, N, stride, 2 * HD + h * Dh, Dh);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = warp + WARPS * u;
      if (t < otiles) {
        const int ti = t / dt, tj = t % dt;
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v;
          wmma::load_matrix_sync(p, Ps + ti * 16 * L.ldp + ch * KC + kk, L.ldp);
          wmma::load_matrix_sync(v, KVs + kk * L.ldq + tj * 16, L.ldq);
          wmma::mma_sync(oacc[u], p, v, oacc[u]);
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
  for (int e = threadIdx.x; e < QT * Dh; e += blockDim.x) {
    const int r = e / Dh, c = e % Dh;
    const int q = q0 + r;
    if (q < N) store_as(out + ((size_t)b * N + q) * HD + h * Dh + c, Ss[r * L.lds + c]);
  }
}

template <typename OutT>
cudaError_t attention_core(const bf16* qkv, OutT* out, int B, int N, int H, int Dh, float scale,
                           attn::ScoreTerms st, cudaStream_t stream) {
  using namespace attn;
  const Layout L = layout(N, Dh);
  if (L.bytes > size_t(MAX_SMEM) || Dh % 16 != 0 || Dh > 128 || B * H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_core_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + QT - 1) / QT, B * H);
  attention_core_kernel<OutT><<<grid, THREADS, L.bytes, stream>>>(qkv, out, N, H, Dh, scale, st);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt
