// Fused self-attention block for Hopper:
//   out = x + (softmax(q k^T * scale, masked) v) @ Wout + bout,  qkv = LN(x) @ Wqkv
//
// Replaces vit_tpu/ops/block_attention.py::_kernel (the Pallas TPU kernel).
// The TPU kernel keeps Wqkv + Wout (~8 MB bf16 at ViT-L) resident in 16 MB of
// VMEM; an H100 block has 227 KB of shared memory, so this version splits the
// op at its GEMM boundaries, into four launches:
//   1. ln_rows:       flax LayerNorm in fp32 -> bf16 xn          (memory-bound)
//   2. gemm_bf16:     xn @ Wqkv -> bf16 qkv                      (compute-bound)
//   3. attention_core: per (batch, head, 32-query tile)          (memory-bound
//                     at n=197: K/V panels and the score rows)
//   4. gemm_bf16:     attn @ Wout + bout + x -> x.dtype          (compute-bound)
// It stores only what the TPU kernel itself rounds to bf16 before its next
// use (xn, qkv at block_attention.py:81, the attention output at :120), so
// the arithmetic is the TPU kernel's. Later PRs fuse LN into the qkv GEMM's
// prologue, move the GEMMs to wgmma + TMA with a persistent schedule, and run
// the attention core from registers (an online softmax, held to a tolerance
// because it rounds differently).

#include <math.h>
#include <mma.h>

#include "common.cuh"
#include "gemm.cuh"

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

// One block: batch b, head h, query rows [q0, q0 + QT). Reads the q/k/v head
// panels straight out of qkv; writes bf16 rows of attn [B*N, H*Dh].
// Softmax in jax.nn.softmax's order: max, exp, sum, divide; P rounded to bf16
// before P @ V (fp32 accumulate), as block_attention.py:112-120.
__global__ void __launch_bounds__(attn::THREADS)
attention_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int Dh,
                      float scale, int true_n, int bt) {
  using namespace nvcuda;
  using namespace attn;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(N, Dh);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q_off);
  bf16* KVs = reinterpret_cast<bf16*>(smem + L.kv_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p_off);

  // The query tiles of one (b, h) are neighbours in launch order, so the
  // K/V panels they all read are still in L2 for the later tiles.
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

  // Scale, mask, softmax; one warp per row. Columns >= N do not exist.
  const bool masked = true_n != bt || bt != N;
  for (int r = warp; r < QT; r += WARPS) {
    const int q = q0 + r;
    float* srow = Ss + r * L.lds;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) {
      float s = srow[c] * scale;
      if (masked && !((c % bt) < true_n && (bt == N || c / bt == q / bt))) s = -1e30f;
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
    if (q < N) out[((size_t)b * N + q) * HD + h * Dh + c] = __float2bfloat16(Ss[r * L.lds + c]);
  }
}

cudaError_t attention_core(const bf16* qkv, bf16* out, int B, int N, int H, int Dh, float scale,
                           int true_n, int bt, cudaStream_t stream) {
  using namespace attn;
  const Layout L = layout(N, Dh);
  if (L.bytes > size_t(MAX_SMEM) || Dh % 16 != 0 || Dh > 128 || B * H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_core_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + QT - 1) / QT, B * H);
  attention_core_kernel<<<grid, THREADS, L.bytes, stream>>>(qkv, out, N, H, Dh, scale, true_n,
                                                            bt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_block(const T* x, const float* ln_scale, const float* ln_bias,
                            const bf16* wqkv, const bf16* wout, const float* bout, T* out,
                            bf16* xn, bf16* qkv, bf16* attn_out, int B, int N, int D, int H,
                            int Dh, float scale, float eps, int true_n, int bt,
                            cudaStream_t stream) {
  const int rows = B * N, HD = H * Dh;
  cudaError_t e = ln_rows<T>(x, ln_scale, ln_bias, xn, rows, D, eps, stream);
  if (e != cudaSuccess) return e;
  e = gemm_bf16<bf16>(xn, wqkv, qkv, nullptr, nullptr, kActNone, rows, 3 * HD, D, stream);
  if (e != cudaSuccess) return e;
  e = attention_core(qkv, attn_out, B, N, H, Dh, scale, true_n, bt, stream);
  if (e != cudaSuccess) return e;
  return gemm_bf16<T>(attn_out, wout, out, bout, x, kActNone, rows, D, HD, stream);
}

}  // namespace
}  // namespace vt

extern "C" int vt_attention_block(const void* x, int x_is_fp32, const void* ln_scale,
                                  const void* ln_bias, const void* wqkv, const void* wout,
                                  const void* bout, void* out, void* xn, void* qkv, void* attn,
                                  int B, int N, int D, int H, int Dh, float scale, float eps,
                                  int true_n, int bt, void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::attention_block<float>(f(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                   static_cast<float*>(out), static_cast<bf16*>(xn),
                                   static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D, H,
                                   Dh, scale, eps, true_n, bt, s);
  else
    e = vt::attention_block<bf16>(h(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout), f(bout),
                                  static_cast<bf16*>(out), static_cast<bf16*>(xn),
                                  static_cast<bf16*>(qkv), static_cast<bf16*>(attn), B, N, D, H,
                                  Dh, scale, eps, true_n, bt, s);
  return static_cast<int>(e);
}

extern "C" const char* vt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
