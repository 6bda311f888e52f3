// The head-mixing attention core shared by two kernels:
//   - CaiT's talking heads (talking_heads_block.cu): scores -> pre-softmax
//     H x H head mix -> padded keys masked -> softmax -> post-softmax mix;
//   - DeepViT's re-attention (reattention_block.cu): masked softmax -> H x H
//     head mix -> LayerNorm across the heads at each (i, j) -> padded key
//     columns zeroed.
// Then P, rounded to bf16, times V per head, rounded to bf16 into the rows of
// out [B*N, H*Dh]. This is the arithmetic of
// vit_tpu/ops/reattention_block.py:90-135 and :202-235.
//
// A head mix couples all H heads at every (i, j), so one block owns one
// sample's query tile across every head: block (query tile, b). It writes the
// fp32 scores of all heads, S_h = Q_h K_h^T (QT rows x n_pad keys each), into
// a slab in shared memory, then works on the slab in place:
//   - a mix pass: each thread owns (i, j) positions, reads the H values into
//     registers and writes back the H mixed ones. Each mix is a sequential
//     sum over h = 0..H-1 with __fmul_rn / __fadd_rn, the head LayerNorm
//     spelled out the same way, so no fused multiply-add moves a value
//     against the twin's separate ops;
//   - softmax: one warp per (head, row), in jax.nn.softmax's order;
//   - each row of P rounded to bf16 in place (in its own fp32 storage).
// P @ V then streams V chunks through WMMA, as attention_core.cuh does.
//
// Shared memory: the slab is H * QT * (n_pad + 4) fp32. At H = 16 a 16-row
// query tile fits up to n_pad = 160; past that the tile is 8 rows (WMMA's
// 8x32x16 bf16 shape), 133 KB at n = 256. The mixes and the head LN
// parameters sit beside it.
//
// Bound: at the CaiT and DeepViT presets, batch 128, the whole block is
// bound by operations: ~69 GFLOP of qkv and out GEMMs around the core's ~2
// GFLOP of Q K^T and P V and ~0.5 GFLOP of fp32 head mixing. The core loads
// its K and V chunks one after another, without prefetch; a later PR
// overlaps them and keeps P in registers.
#pragma once

#include <math.h>
#include <mma.h>

#include "attention_core.cuh"
#include "common.cuh"

namespace vt {
namespace {

namespace hmix {
constexpr int MAX_H = 16;
constexpr int MAX_N = 256;
constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most one block may use
enum Mode : int { kTalkingHeads = 0, kReattention = 1 };

struct Layout {
  int n_pad, lds, ldq, dh_pad, ldkv, ldo;
  size_t q_off, kv_off, o_off, par_off, bytes;
};

// QT query rows per block; WMMA tiles of QT x TN with TN = 256 / QT, and
// K / V chunks of KC = 4 * TN keys (one tile per warp in the score product).
__host__ __device__ inline Layout layout(int qt, int N, int H, int Dh) {
  using attn::align128;
  const int tn = 256 / qt, kc = 4 * tn;
  Layout L;
  L.n_pad = (N + 31) / 32 * 32;
  L.lds = L.n_pad + 4;
  L.ldq = Dh + 8;
  L.dh_pad = (Dh + tn - 1) / tn * tn;  // V panel columns [Dh, dh_pad) stay zero
  L.ldkv = L.dh_pad + 8;
  L.ldo = L.dh_pad + 4;
  L.q_off = align128(size_t(H) * qt * L.lds * sizeof(float));
  L.kv_off = align128(L.q_off + size_t(qt) * L.ldq * sizeof(bf16));
  L.o_off = align128(L.kv_off + size_t(kc) * L.ldkv * sizeof(bf16));
  L.par_off = align128(L.o_off + size_t(qt) * L.ldo * sizeof(float));
  L.bytes = align128(L.par_off + size_t(2 * MAX_H * MAX_H + 2 * MAX_H) * sizeof(float));
  return L;
}

struct Params {
  const float* mix_a;     // [H, H]: the pre-softmax mix / the re-attention mix
  const float* mix_b;     // [H, H]: the post-softmax mix (talking heads only)
  const float* ln_scale;  // [H]: the head LayerNorm (re-attention only)
  const float* ln_bias;
  float ln_eps, inv_h;
  float* dbg_mixed;  // NULL or [B, H, N, N] fp32: the mixed scores / the mixed softmax r
  float* dbg_p;      // NULL or [B, H, N, N] fp32: the post-mixed P / the normalised r'
};
}  // namespace hmix

// y[g] = sum_h w[h * H + g] * x[h], in h order, each product and add rounded.
__device__ __forceinline__ void mix_heads(const float (&x)[hmix::MAX_H], const float* w, int H,
                                          float (&y)[hmix::MAX_H]) {
#pragma unroll
  for (int g = 0; g < hmix::MAX_H; ++g) {
    if (g < H) {
      float acc = __fmul_rn(w[g], x[0]);
#pragma unroll
      for (int h = 1; h < hmix::MAX_H; ++h)
        if (h < H) acc = __fadd_rn(acc, __fmul_rn(w[h * H + g], x[h]));
      y[g] = acc;
    }
  }
}

// Softmax of every (head, row) of the slab over the real keys (c < valid),
// scaling the scores first when `scale_first`; P is 0 on keys [valid, n_pad).
__device__ __forceinline__ void softmax_rows(float* S, int rows, int lds, int n_pad, int valid,
                                             bool scale_first, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += hmix::WARPS) {
    float* row = S + (size_t)r * lds;
    float m = -INFINITY;
    for (int c = lane; c < valid; c += 32) {
      float s = row[c];
      if (scale_first) s = __fmul_rn(s, scale);
      row[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < valid; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int c = lane; c < n_pad; c += 32) row[c] = c < valid ? row[c] / l : 0.0f;
  }
}

template <int QT, int MODE>
__global__ void __launch_bounds__(hmix::THREADS)
head_mix_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int Dh,
                float scale, int valid, hmix::Params prm) {
  using namespace nvcuda;
  using namespace hmix;
  constexpr int TN = 256 / QT, KC = 4 * TN;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(QT, N, H, Dh);
  float* S = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q_off);
  bf16* KVs = reinterpret_cast<bf16*>(smem + L.kv_off);
  float* Os = reinterpret_cast<float*>(smem + L.o_off);
  float* mix_a = reinterpret_cast<float*>(smem + L.par_off);
  float* mix_b = mix_a + MAX_H * MAX_H;
  float* lns = mix_b + MAX_H * MAX_H;
  float* lnb = lns + MAX_H;

  const int b = blockIdx.y, q0 = blockIdx.x * QT;
  const int HD = H * Dh, stride = 3 * HD;
  const bf16* base = qkv + (size_t)b * N * stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_pad = L.n_pad, lds = L.lds;
  const int chunks = (n_pad + KC - 1) / KC;

  for (int e = threadIdx.x; e < H * H; e += blockDim.x) {
    mix_a[e] = prm.mix_a[e];
    if (MODE == kTalkingHeads) mix_b[e] = prm.mix_b[e];
  }
  if (MODE == kReattention && threadIdx.x < H) {
    lns[threadIdx.x] = prm.ln_scale[threadIdx.x];
    lnb[threadIdx.x] = prm.ln_bias[threadIdx.x];
  }
  const int zc = L.dh_pad - Dh;
  for (int e = threadIdx.x; e < KC * zc; e += blockDim.x)
    KVs[(e / zc) * L.ldkv + Dh + e % zc] = __float2bfloat16(0.0f);

  // 1. S_h = Q_h K_h^T in fp32 for every head, chunk by chunk of keys.
  for (int h = 0; h < H; ++h) {
    for (int ch = 0; ch < chunks; ++ch) {
      __syncthreads();  // the previous readers of Qs / KVs are done
      if (ch == 0) load_panel(Qs, L.ldq, base, q0, QT, N, stride, h * Dh, Dh);
      load_panel(KVs, L.ldkv, base, ch * KC, KC, N, stride, HD + h * Dh, Dh);
      __syncthreads();
      const int col = ch * KC + warp * TN;
      if (col < n_pad) {
        wmma::fragment<wmma::accumulator, QT, TN, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < Dh; kk += 16) {
          wmma::fragment<wmma::matrix_a, QT, TN, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, QT, TN, 16, bf16, wmma::col_major> kt;
          wmma::load_matrix_sync(a, Qs + kk, L.ldq);
          wmma::load_matrix_sync(kt, KVs + warp * TN * L.ldkv + kk, L.ldkv);  // K^T
          wmma::mma_sync(acc, a, kt, acc);
        }
        wmma::store_matrix_sync(S + (size_t)h * QT * lds + col, acc, lds, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  // 2. The head mixes and softmax, in place on the slab.
  const auto at = [&](int g, int i, int j) -> float& { return S[((size_t)g * QT + i) * lds + j]; };
  const auto dbg = [&](float* d, int g, int i, int j, float v) {
    const int q = q0 + i;
    if (d != nullptr && q < N && j < N) d[(((size_t)b * H + g) * N + q) * N + j] = v;
  };
  float x[MAX_H], y[MAX_H];
  if (MODE == kTalkingHeads) {
    for (int e = threadIdx.x; e < QT * n_pad; e += blockDim.x) {
      const int i = e / n_pad, j = e % n_pad;
#pragma unroll
      for (int h = 0; h < MAX_H; ++h)
        if (h < H) x[h] = __fmul_rn(at(h, i, j), scale);
      mix_heads(x, mix_a, H, y);
#pragma unroll
      for (int g = 0; g < MAX_H; ++g) {
        if (g < H) {
          const float v = j < valid ? y[g] : -1e30f;  // masked after the pre-mix
          at(g, i, j) = v;
          dbg(prm.dbg_mixed, g, i, j, v);
        }
      }
    }
    __syncthreads();
    softmax_rows(S, H * QT, lds, n_pad, valid, false, 1.0f);
    __syncthreads();
    for (int e = threadIdx.x; e < QT * n_pad; e += blockDim.x) {
      const int i = e / n_pad, j = e % n_pad;
#pragma unroll
      for (int h = 0; h < MAX_H; ++h)
        if (h < H) x[h] = at(h, i, j);
      mix_heads(x, mix_b, H, y);
#pragma unroll
      for (int g = 0; g < MAX_H; ++g) {
        if (g < H) {
          at(g, i, j) = y[g];
          dbg(prm.dbg_p, g, i, j, y[g]);
        }
      }
    }
  } else {
    softmax_rows(S, H * QT, lds, n_pad, valid, true, scale);
    __syncthreads();
    for (int e = threadIdx.x; e < QT * n_pad; e += blockDim.x) {
      const int i = e / n_pad, j = e % n_pad;
#pragma unroll
      for (int h = 0; h < MAX_H; ++h)
        if (h < H) x[h] = at(h, i, j);
      mix_heads(x, mix_a, H, y);
      // LayerNorm across the heads (reattention_block.py:116-123)
      float sum = y[0], sq = __fmul_rn(y[0], y[0]);
#pragma unroll
      for (int g = 1; g < MAX_H; ++g) {
        if (g < H) {
          sum = __fadd_rn(sum, y[g]);
          sq = __fadd_rn(sq, __fmul_rn(y[g], y[g]));
        }
      }
      const float mean = __fmul_rn(sum, prm.inv_h);
      const float var = fmaxf(__fsub_rn(__fmul_rn(sq, prm.inv_h), __fmul_rn(mean, mean)), 0.0f);
      const float inv = rsqrtf(__fadd_rn(var, prm.ln_eps));
#pragma unroll
      for (int g = 0; g < MAX_H; ++g) {
        if (g < H) {
          // the LN bias turns padded key columns into bias_g: zero them
          const float v = j < valid ? ln_value(y[g], mean, inv, lns[g], lnb[g]) : 0.0f;
          at(g, i, j) = v;
          dbg(prm.dbg_mixed, g, i, j, y[g]);
          dbg(prm.dbg_p, g, i, j, v);
        }
      }
    }
  }
  __syncthreads();

  // 3. Each row of P rounded to bf16, in place: the bf16 row takes the first
  //    half of its own fp32 row's storage (row stride 2 * lds bf16).
  for (int r = warp; r < H * QT; r += WARPS) {
    float* row = S + (size_t)r * lds;
    float v[MAX_N / 32];
#pragma unroll
    for (int u = 0; u < MAX_N / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < n_pad) v[u] = row[c];
    }
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int u = 0; u < MAX_N / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < n_pad) prow[c] = __float2bfloat16(v[u]);
    }
  }

  // 4. O_g = P_g V_g per head, fp32 fragments over the key chunks; each
  //    head's rows rounded to bf16 into out.
  const int ldp = 2 * lds;
  const int otiles = L.dh_pad / TN;  // <= 8: at most 2 per warp
  for (int g = 0; g < H; ++g) {
    const bf16* P = reinterpret_cast<const bf16*>(S + (size_t)g * QT * lds);
    wmma::fragment<wmma::accumulator, QT, TN, 16, float> oacc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) wmma::fill_fragment(oacc[u], 0.0f);
    for (int ch = 0; ch < chunks; ++ch) {
      __syncthreads();  // KVs and Os are free
      load_panel(KVs, L.ldkv, base, ch * KC, KC, N, stride, 2 * HD + g * Dh, Dh);
      __syncthreads();
      const int keys = min(KC, n_pad - ch * KC);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = warp + WARPS * u;
        if (t < otiles) {
          for (int kk = 0; kk < keys; kk += 16) {
            wmma::fragment<wmma::matrix_a, QT, TN, 16, bf16, wmma::row_major> p;
            wmma::fragment<wmma::matrix_b, QT, TN, 16, bf16, wmma::row_major> v;
            wmma::load_matrix_sync(p, P + ch * KC + kk, ldp);
            wmma::load_matrix_sync(v, KVs + kk * L.ldkv + t * TN, L.ldkv);
            wmma::mma_sync(oacc[u], p, v, oacc[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = warp + WARPS * u;
      if (t < otiles) wmma::store_matrix_sync(Os + t * TN, oacc[u], L.ldo, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < QT * Dh; e += blockDim.x) {
      const int r = e / Dh, c = e % Dh;
      const int q = q0 + r;
      if (q < N) out[((size_t)b * N + q) * HD + g * Dh + c] = __float2bfloat16(Os[r * L.ldo + c]);
    }
  }
}

template <int QT, int MODE>
cudaError_t launch_head_mix(const bf16* qkv, bf16* out, int B, int N, int H, int Dh, float scale,
                            int valid, const hmix::Params& prm, cudaStream_t stream) {
  const hmix::Layout L = hmix::layout(QT, N, H, Dh);
  cudaError_t e = cudaFuncSetAttribute(head_mix_kernel<QT, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + QT - 1) / QT, B);
  head_mix_kernel<QT, MODE><<<grid, hmix::THREADS, L.bytes, stream>>>(qkv, out, N, H, Dh, scale,
                                                                     valid, prm);
  return cudaGetLastError();
}

// The 16-row query tile where its slab fits, else the 8-row one.
template <int MODE>
cudaError_t head_mix_core(const bf16* qkv, bf16* out, int B, int N, int H, int Dh, float scale,
                          int true_n, const hmix::Params& prm, cudaStream_t stream) {
  using namespace hmix;
  if (N < 1 || N > MAX_N || H < 1 || H > MAX_H || Dh % 16 != 0 || Dh > 128 || B < 1 ||
      B > 65535 || true_n < 1 || true_n > N)
    return cudaErrorInvalidValue;
  if (layout(16, N, H, Dh).bytes <= size_t(MAX_SMEM))
    return launch_head_mix<16, MODE>(qkv, out, B, N, H, Dh, scale, true_n, prm, stream);
  if (layout(8, N, H, Dh).bytes > size_t(MAX_SMEM)) return cudaErrorInvalidValue;
  return launch_head_mix<8, MODE>(qkv, out, B, N, H, Dh, scale, true_n, prm, stream);
}

}  // namespace
}  // namespace vt
