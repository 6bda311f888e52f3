// Online-softmax flash attention with K and V streamed in chunks, for Hopper:
//   out[b, h] = softmax(q[b, h] k[b, h]^T * scale + bias[b|0, h|0], mask_self) v[b, h]
// q [B, H, Nq, D], k [B, H, Nk, D], v [B, H, Nk, Dv] bf16, out [B, H, Nq, Dv]
// bf16, each read or written through its own strides.
//
// Replaces vit_tpu/ops/flash_attention.py::_kv_blocked_kernel (the Pallas TPU
// kernel, entry flash_attention_kv_blocked). Like the TPU kernel it keeps no
// score row over all keys: each 64-key chunk updates a running row max m, a
// running sum l and an fp32 accumulator, in the TPU kernel's op order
// (flash_attention.py:249-284):
//   s = (q . k) * scale [+ bias], masked to MASK_VALUE (keys past Nk, and the
//   mask_self diagonal); m_new = max(m, rowmax s); alpha = exp(m - m_new);
//   p = exp(s - m_new); l = alpha * l + rowsum p; acc = acc * alpha + bf16(p) v;
//   at the end out = acc / l (a true division), rounded once to bf16.
// The TPU kernel's sequential kv grid axis is the loop over chunks inside one
// block; the TPU's (block_q, Dv) VMEM accumulator lives in shared memory.
//
// Widths: D and Dv of any size (T2T's tokenizer runs D = Dv = 147 and 1323),
// zero-filled to a multiple of 16 in shared memory for the 16x16x16 WMMA
// tiles. Q K^T runs over column slices of 64 (one K slice of 64 keys x 64
// columns, 9 KB, in shared memory at a time), and P V over slices of 64
// output columns, so neither width bounds the K/V buffer. Rows need only be
// 2-byte aligned (T2T's fused qkv rows are 882 and 7938 bytes), so every
// load is a 2-byte load.
//
// Layout of one block (QT query rows, 4 warps): the Q tile (QT x D), one K or
// V slice (64 x 64), the fp32 scores (QT x 64), the bf16 p (QT x 64), the fp32
// accumulator (QT x Dv), and m, l, alpha per row. QT is 32 when the block fits
// half of the SM's 227 KB, else 16: at D = Dv = 147, QT = 32 and 54,656 B
// (four blocks an SM); at D = Dv = 1323, QT = 16 and 144,128 B (one block an
// SM; 32 rows would need 278,912 B). Warp w computes the scores of keys
// [16w, 16w + 16) of the chunk and the output columns [16w, 16w + 16) of each
// Dv slice, for all QT rows. Each thread loads its share of a K or V slice
// into registers before storing any of it, so a slice's loads are in flight
// together.
//
// Bound: operations. At T2T's stage 0 (Nq = Nk = 3136, D = 147) a query row
// does 4 * 3136 * 147 = 1.8 MFLOP on 294 B of q and out; at stage 1 (784
// keys, D = 1323) 4.1 MFLOP on 5.3 KB, both above the H100's ~295 FLOP/byte
// ridge. This first kernel uses WMMA and synchronous 2-byte loads, one chunk
// after another without prefetch; wgmma fed by TMA comes later.

#include <float.h>
#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace vt {
namespace {

namespace kvb {
constexpr int KC = 64;  // keys per chunk
constexpr int DS = 64;  // columns per D / Dv slice
constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most one block may use
// flash_attention.py:40: the fill of masked scores.
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr int LDKV = DS + 8;  // +8 bf16 a row staggers shared-memory banks
constexpr int LDS = KC + 4;
constexpr int LDP = KC + 8;

struct Layout {
  int dp, dvp, ldq, lda;
  size_t kv_off, s_off, p_off, acc_off, stat_off, bytes;
};

__host__ __device__ inline size_t align_128(size_t v) { return (v + 127) & ~size_t(127); }
__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int qt, int D, int Dv) {
  Layout L;
  L.dp = round16(D);
  L.dvp = round16(Dv);
  L.ldq = L.dp + 8;
  L.lda = L.dvp + 4;
  L.kv_off = align_128(size_t(qt) * L.ldq * sizeof(bf16));
  L.s_off = align_128(L.kv_off + size_t(KC) * LDKV * sizeof(bf16));
  L.p_off = align_128(L.s_off + size_t(qt) * LDS * sizeof(float));
  L.acc_off = align_128(L.p_off + size_t(qt) * LDP * sizeof(bf16));
  L.stat_off = align_128(L.acc_off + size_t(qt) * L.lda * sizeof(float));
  L.bytes = align_128(L.stat_off + 3 * size_t(qt) * sizeof(float));
  return L;
}

// Element (b, h, row, col) at base + b*sb + h*sh + row*sr + col (elements).
template <typename T>
struct Operand {
  T* base;
  long long sb, sh, sr;
  __device__ __forceinline__ T* at(int b, int h) const { return base + b * sb + h * sh; }
};

struct Problem {
  int B, H, Nq, Nk, D, Dv;
};
}  // namespace kvb

// Rows [row0, row0 + rows) x columns [0, w) of src (row stride sr) into dst
// (row stride ld); zero past n rows and past `valid` columns. The Q tile, once
// a block.
__device__ __forceinline__ void load_tile_2b(bf16* dst, int ld, const bf16* src, long long sr,
                                             int row0, int rows, int n, int w, int valid) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
    const int r = e / w, c = e % w;
    const int g = row0 + r;
    d[r * ld + c] = (g < n && c < valid) ? __ldg(s + g * sr + c) : 0;
  }
}

// Keys [row0, row0 + KC) x columns [col0, col0 + DS) of src (row stride sr)
// into a K or V slice (row stride LDKV); zero past n keys and past `valid`
// columns. Each thread issues all its loads before its stores, so that they
// are in flight together.
__device__ __forceinline__ void load_slice_2b(bf16* dst, const bf16* src, long long sr, int row0,
                                              int n, int col0, int valid) {
  using namespace kvb;
  constexpr int PER = KC * DS / THREADS, RSTEP = THREADS / DS;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
  const int c = threadIdx.x % DS, r0 = threadIdx.x / DS, gc = col0 + c;
  unsigned short v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int g = row0 + r0 + i * RSTEP;
    v[i] = (g < n && gc < valid) ? __ldg(s + g * sr + gc) : 0;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) d[(r0 + i * RSTEP) * LDKV + c] = v[i];
}

template <int QT>
__global__ void __launch_bounds__(kvb::THREADS)
kv_blocked_kernel(kvb::Operand<const bf16> q, kvb::Operand<const bf16> k,
                  kvb::Operand<const bf16> v, kvb::Operand<bf16> out, kvb::Problem pr,
                  float scale, const float* __restrict__ bias, int bias_b, int bias_h,
                  int mask_self) {
  using namespace nvcuda;
  using namespace kvb;
  constexpr int RT = QT / 16;  // 16-row tiles of the query tile
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(QT, pr.D, pr.Dv);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = reinterpret_cast<bf16*>(smem + L.kv_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p_off);
  float* Acc = reinterpret_cast<float*>(smem + L.acc_off);
  float* Ms = reinterpret_cast<float*>(smem + L.stat_off);
  float* Ls = Ms + QT;
  float* Al = Ls + QT;

  const int qtiles = (pr.Nq + QT - 1) / QT;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / pr.H, h = bh % pr.H;
  const int q0 = (blockIdx.x % qtiles) * QT;
  const int Nk = pr.Nk;
  const bf16* kp = k.at(b, h);
  const bf16* vp = v.at(b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile_2b(Qs, L.ldq, q.at(b, h), q.sr, q0, QT, pr.Nq, L.dp, pr.D);
  for (int r = 0; r < QT; ++r)
    for (int c = threadIdx.x; c < L.dvp; c += THREADS) Acc[r * L.lda + c] = 0.f;
  if (threadIdx.x < QT) {
    Ms[threadIdx.x] = -INFINITY;
    Ls[threadIdx.x] = 0.f;
  }
  const float* bias_bh = nullptr;
  if (bias != nullptr) {
    const int nbh = bias_h ? pr.H : 1;
    bias_bh = bias + ((size_t)(bias_b ? b : 0) * nbh + (bias_h ? h : 0)) * (size_t)pr.Nq * Nk;
  }

  const int chunks = (Nk + KC - 1) / KC;
  for (int ch = 0; ch < chunks; ++ch) {
    const int k0 = ch * KC;
    // s = Q K^T over D slices; warp w: keys [16w, 16w + 16) of the chunk.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) wmma::fill_fragment(sacc[i], 0.0f);
    for (int c0 = 0; c0 < L.dp; c0 += DS) {
      const int w = min(DS, L.dp - c0);
      __syncthreads();  // every warp is done with the previous slice (and p, s)
      load_slice_2b(KVs, kp, k.sr, k0, Nk, c0, pr.D);
      __syncthreads();
      for (int kk = 0; kk < w; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;  // K^T
        wmma::load_matrix_sync(kt, KVs + warp * 16 * LDKV + kk, LDKV);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, Qs + i * 16 * L.ldq + c0 + kk, L.ldq);
          wmma::mma_sync(sacc[i], a, kt, sacc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
      wmma::store_matrix_sync(Ss + i * 16 * LDS + warp * 16, sacc[i], LDS, wmma::mem_row_major);
    __syncthreads();

    // The online softmax of the chunk, one warp per row, two keys a lane.
    for (int r = warp; r < QT; r += WARPS) {
      const int qr = q0 + r;
      const float* brow = (bias_bh != nullptr && qr < pr.Nq) ? bias_bh + (size_t)qr * Nk : nullptr;
      float s[2];
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, gc = k0 + c;
        float x = __fmul_rn(Ss[r * LDS + c], scale);
        if (brow != nullptr && gc < Nk) x = __fadd_rn(x, brow[gc]);
        if (gc >= Nk || (mask_self && gc == qr)) x = MASK_VALUE;
        s[j] = x;
        mc = fmaxf(mc, x);
      }
      mc = warp_max(mc);
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mc);
      const float alpha = expf(m_prev - m_new);  // 0 at the first chunk (m_prev = -inf)
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[j] - m_new);
        Ps[r * LDP + lane + 32 * j] = __float2bfloat16(p);
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        Ls[r] = __fadd_rn(__fmul_rn(alpha, Ls[r]), ps);
        Ms[r] = m_new;
        Al[r] = alpha;
      }
    }
    __syncthreads();
    for (int r = 0; r < QT; ++r) {
      const float alpha = Al[r];
      for (int c = threadIdx.x; c < L.dvp; c += THREADS)
        Acc[r * L.lda + c] = __fmul_rn(Acc[r * L.lda + c], alpha);
    }

    // acc += bf16(p) V over Dv slices; warp w: columns [16w, 16w + 16) of each.
    for (int c0 = 0; c0 < L.dvp; c0 += DS) {
      const int w = min(DS, L.dvp - c0);
      __syncthreads();  // the slice buffer is free, the accumulator rescaled
      load_slice_2b(KVs, vp, v.sr, k0, Nk, c0, pr.Dv);
      __syncthreads();
      if (warp * 16 < w) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv, o;
          wmma::fill_fragment(pv, 0.0f);
#pragma unroll
          for (int kk = 0; kk < KC; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
            wmma::load_matrix_sync(p, Ps + i * 16 * LDP + kk, LDP);
            wmma::load_matrix_sync(vf, KVs + kk * LDKV + warp * 16, LDKV);
            wmma::mma_sync(pv, p, vf, pv);
          }
          float* at = Acc + i * 16 * L.lda + c0 + warp * 16;
          wmma::load_matrix_sync(o, at, L.lda, wmma::mem_row_major);
          // acc * alpha (above) + p V, as the TPU kernel adds them
#pragma unroll
          for (int t = 0; t < o.num_elements; ++t) o.x[t] = __fadd_rn(o.x[t], pv.x[t]);
          wmma::store_matrix_sync(at, o, L.lda, wmma::mem_row_major);
        }
      }
    }
  }
  __syncthreads();

  bf16* op = out.at(b, h);
  for (int e = threadIdx.x; e < QT * pr.Dv; e += THREADS) {
    const int r = e / pr.Dv, c = e % pr.Dv;
    const int qr = q0 + r;
    if (qr < pr.Nq) op[qr * out.sr + c] = __float2bfloat16(__fdiv_rn(Acc[r * L.lda + c], Ls[r]));
  }
}

template <int QT>
cudaError_t launch_kv_blocked(const kvb::Operand<const bf16>& q, const kvb::Operand<const bf16>& k,
                              const kvb::Operand<const bf16>& v, const kvb::Operand<bf16>& out,
                              const kvb::Problem& pr, float scale, const float* bias, int bias_b,
                              int bias_h, int mask_self, cudaStream_t stream) {
  const size_t bytes = kvb::layout(QT, pr.D, pr.Dv).bytes;
  const long long blocks = (long long)pr.B * pr.H * ((pr.Nq + QT - 1) / QT);
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kv_blocked_kernel<QT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  kv_blocked_kernel<QT><<<static_cast<unsigned>(blocks), kvb::THREADS, bytes, stream>>>(
      q, k, v, out, pr, scale, bias, bias_b, bias_h, mask_self);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt

// The query tile is 32 rows when a block fits half of 227 KB, else 16
// (ops/flash_attention.py kv_blocked_layout mirrors this choice).
extern "C" int vt_flash_attention_kv_blocked(
    const void* q, long long q_sb, long long q_sh, long long q_sr, const void* k, long long k_sb,
    long long k_sh, long long k_sr, const void* v, long long v_sb, long long v_sh, long long v_sr,
    void* out, long long o_sb, long long o_sh, long long o_sr, int B, int H, int Nq, int Nk, int D,
    int Dv, float scale, const void* bias, int bias_b, int bias_h, int mask_self, void* stream) {
  using vt::bf16;
  using namespace vt::kvb;
  const auto in = [](const void* p, long long sb, long long sh, long long sr) {
    return Operand<const bf16>{static_cast<const bf16*>(p), sb, sh, sr};
  };
  const Operand<bf16> o{static_cast<bf16*>(out), o_sb, o_sh, o_sr};
  const Problem pr{B, H, Nq, Nk, D, Dv};
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Nq < 1 || Nk < 1 || D < 1 || Dv < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (layout(32, D, Dv).bytes <= size_t(MAX_SMEM / 2))
    e = vt::launch_kv_blocked<32>(in(q, q_sb, q_sh, q_sr), in(k, k_sb, k_sh, k_sr),
                                  in(v, v_sb, v_sh, v_sr), o, pr, scale, bf, bias_b, bias_h,
                                  mask_self, s);
  else if (layout(16, D, Dv).bytes <= size_t(MAX_SMEM))
    e = vt::launch_kv_blocked<16>(in(q, q_sb, q_sh, q_sr), in(k, k_sb, k_sh, k_sr),
                                  in(v, v_sb, v_sh, v_sr), o, pr, scale, bf, bias_b, bias_h,
                                  mask_self, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
