// The register-resident softmax-attention core for Hopper, under kernels 1
// (attention_block.cu), 3 (qkv_attention.cu), 4 (flash_attention.cu) and 9
// (quant_block.cu, which takes its rows in fp32, unrounded: store_out's fp32
// overload; the bf16 instances are the same code as before it).
//
// What it computes is the exact softmax of attention_core.cuh, per query row
// in jax.nn.softmax's order (vit_tpu/ops/qkv_attention.py:54-70,
// flash_attention.py:74-108):
//   s = __fmul_rn(q . k, scale) [__fadd_rn bias] [true_n mask -1e30]
//       [mask_self diagonal -0.7 FLT_MAX]; m = the exact row max;
//   e = expf(s - m); l = sum(e); p = e / l (IEEE), rounded to bf16;
//   o = p @ v summed in fp32, rounded once to bf16.
// Keys past Nk do not exist (their e is 0). It is not an online softmax: p is
// normalised before P V, which is kernel 5's twin's other contract.
//
// Bound: bytes and latency, not tensor-core rate. At ViT-L (n = 197, Dh = 64)
// a token's head reads 384 B of qkv and writes 128 B for ~50 KFLOP; at
// Twins-SVT's GSA stage 1 (3136 queries, 64 keys) a query row reads and
// writes 128 B each for ~16 KFLOP: both under the H100's ~295 FLOP/byte
// ridge. attention_core.cuh spent its time on serial 16-byte copies between
// barriers, fp32 score rows and bf16 P rows round-tripping through shared
// memory, 2-byte output stores, and 32-row query tiles that re-read K and V.
//
// Design (one block: batch b, head h, W warps of 16 query rows each):
// - Q K^T and P V run on mma.sync.m16n8k16 (bf16 in, fp32 sums) from ldmatrix
//   fragments; V through ldmatrix.trans. A warp's Q fragments are loaded once.
// - The scores stay in the accumulator registers. Row max and sum come from
//   quad shuffles. The normalised, bf16-rounded P goes from the score
//   accumulators straight into the A fragments of P V (the C layout of
//   m16n8 equals the A layout of m16k16 two n-tiles at a time). No score or
//   P row touches shared memory.
// - Two variants, one arithmetic. At D = Dv = 64 and Nk <= 208 (ViT's 197
//   tokens, every Twins GSA layer) a warp keeps its whole score row in
//   registers (KT tiles of 16 keys): one pass of Q K^T finds m, a pass over
//   the registers sums l, one pass of P V. Otherwise (other widths up to
//   128, read at run time; Nk up to 1,088) the row is swept three times
//   over the K chunks: pass 1 takes the exact max, pass 2 recomputes s and
//   sums e, pass 3 recomputes s, forms p and runs P V. Recomputed scores are
//   bitwise the first ones (the same mma inputs in the same order), so the
//   two variants round alike.
// - K and V arrive in chunks of 64 keys by cp.async.cg (16 B, zero-filled
//   past Nk) into shared memory. The resident variants give every chunk its
//   own buffer and put all in flight at once (Q and K, then V), so a block
//   waits for memory once for each; the streamed variant keeps a two-stage
//   ring, chunk c + 1 in flight while chunk c is multiplied. Operands keep
//   their (sb, sh, sr) strides, so kernel 4 reads the split_heads views with
//   no copy and writes [B, Nq, H, Dv] rows.
// - Query tiles sized to the work (plan_for): W of 1-8 warps, 16-128 rows,
//   from Nk and B * H * ceil(Nq / 16). Where a block's K and V outweigh its
//   q and output rows (ViT's 197 keys), large blocks, since each reads K and
//   V whole; with few keys (Twins' GSA), blocks of 4 warps, more of them an
//   SM; and smaller blocks where the work would leave most SMs idle (ViT-L
//   at batch 1). A row's arithmetic does not depend on the plan or the
//   batch: the kernels stay batch-invariant.
// - p = e / l takes one reciprocal a row, and a product and two FMAs a
//   score, which round exactly as the IEEE division does (div_rn).
// - The output leaves the registers as bf16 pairs into the warp's own rows of
//   the Q tile, and goes to memory in 16-byte stores.
#pragma once

#include <float.h>
#include <math.h>

#include "attention_core.cuh"  // attn::Operand, Problem, ScoreTerms, MASK_SELF
#include "common.cuh"

namespace vt {
namespace {

namespace attn90 {
using attn::align128;
using attn::Operand;
using attn::Problem;
using attn::ScoreTerms;

constexpr int KC = 64;              // keys per chunk in shared memory
constexpr int MAX_WARPS = 8;        // query tiles of 16 rows in one block
constexpr int RESIDENT_TILES = 13;  // 208 keys of score row in registers

struct Layout {
  int ldq, ldk, ldv;
  size_t q_bytes, v_off, stage_bytes, bytes;
};

// Shared memory of a block of `warps` warps: the Q tile (reused to stage the
// output, so max(D, Dv) wide), then `stages` chunks of K (KC x D) and V
// (KC x Dv). +8 bf16 a row staggers the banks of ldmatrix's 8 row reads.
__host__ __device__ inline Layout layout(int warps, int D, int Dv, int stages) {
  Layout L;
  L.ldq = (D > Dv ? D : Dv) + 8;
  L.ldk = D + 8;
  L.ldv = Dv + 8;
  L.q_bytes = align128(size_t(warps) * 16 * L.ldq * sizeof(bf16));
  L.v_off = align128(size_t(KC) * L.ldk * sizeof(bf16));
  L.stage_bytes = align128(L.v_off + size_t(KC) * L.ldv * sizeof(bf16));
  L.bytes = L.q_bytes + stages * L.stage_bytes;
  return L;
}

// -- PTX: ldmatrix, mma.sync (cp.async: common.cuh) ----------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- the pieces of one warp's work ---------------------------------------------

// Rows [row0, row0 + rows) of `cols` columns at src (row stride sr) into
// shared memory (row stride ld), by every thread of the block; zeros past n.
// Inlined with constant widths, the index math is shifts.
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src, long long sr,
                                                int row0, int rows, int n, int cols) {
  const int per_row = cols / 8;
  if (blockDim.x % per_row == 0) {  // a thread keeps one column of every rstep-th row
    const int c = (threadIdx.x % per_row) * 8, rstep = blockDim.x / per_row;
    for (int r = threadIdx.x / per_row; r < rows; r += rstep) {
      const bool ok = row0 + r < n;
      cp_async16(dst + r * ld + c, ok ? src + (row0 + r) * sr + c : src, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const int g = row0 + r;
    const bool ok = g < n;
    cp_async16(dst + r * ld + c, ok ? src + g * sr + c : src, ok);
  }
}

// Everything a warp needs to turn a tile of Q K^T into scores.
struct Rows {
  int r0, t4;     // the thread's rows r0 and r0 + 8; its column pair 2 * t4
  int Nq, Nk;
  float scale;
  const float* bias;  // this (b, h)'s [Nq, Nk] fp32 bias, or NULL
  bool masked;        // the true_n / block mask applies
  bool plain;         // no bias, no mask: only the scale
  ScoreTerms st;
};

// Q K^T of the key tiles c*4 .. c*4 + 3 (those below min(NT, ntiles)) into
// s[t]: the m16n8 accumulators, s[t][0..1] row r0, keys 16 t + 2 t4 + {0, 1};
// s[t][2..3] row r0 + 8, the same keys; s[t][4..7] the same for keys + 8.
// kc: the chunk's K rows in shared memory. The four tiles' products are
// interleaved, eight independent accumulators deep.
template <int DK, int NT, bool FIXED>
__device__ __forceinline__ void score_chunk(float (&s)[NT][8], int c, int ntiles,
                                            const unsigned (&qf)[DK][4], const bf16* kc, int ldk,
                                            int dk, int lane) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = c * 4 + u;
    if (t < NT && t < ntiles) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[t][i] = 0.f;
    }
  }
  // lanes 0-7: keys 0-7, columns 0-7; 8-15: keys 0-7, columns 8-15;
  // 16-23 / 24-31: keys 8-15. Registers: b0b1 and b2b3 of n-tiles 0 and 1.
  const bf16* base = kc + ((lane & 7) + ((lane >> 4) << 3)) * ldk + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    if (FIXED || kk < dk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = c * 4 + u;
        if (t < NT && t < ntiles) {
          unsigned b[4];
          ldsm_x4(b, base + u * 16 * ldk + kk * 16);
          mma_bf16(s[t], qf[kk], b[0], b[1]);
          mma_bf16(s[t] + 4, qf[kk], b[2], b[3]);
        }
      }
    }
  }
}

// Scale, bias and masks of a score tile (attention_core.cuh's order); keys
// past Nk become -inf, so that they weigh nothing. lo0 and lo1 keep the
// least score of rows r0 and r0 + 8 above the masks' -1e30 (below it e is
// 0): Norm::exact reads them.
__device__ __forceinline__ void score_terms(float (&s)[8], int key0, const Rows& R, float& lo0,
                                            float& lo1) {
  if (R.plain && key0 + 16 <= R.Nk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = __fmul_rn(s[i], R.scale);
      if ((i >> 1) & 1) lo1 = fminf(lo1, s[i]);
      else lo0 = fminf(lo0, s[i]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = R.r0 + ((i >> 1) & 1) * 8;
    const int col = key0 + (i >> 2) * 8 + 2 * R.t4 + (i & 1);
    float x = __fmul_rn(s[i], R.scale);
    if (R.bias != nullptr && row < R.Nq && col < R.Nk)
      x = __fadd_rn(x, __ldg(R.bias + (size_t)row * R.Nk + col));
    if (R.masked &&
        !((col % R.st.bt) < R.st.true_n && (R.st.bt == R.Nk || col / R.st.bt == row / R.st.bt)))
      x = -1e30f;
    if (R.st.mask_self && col == row) x = attn::MASK_SELF;
    if (col >= R.Nk) x = -INFINITY;
    s[i] = x;
    if (x > -1e30f) {
      if ((i >> 1) & 1) lo1 = fminf(lo1, x);
      else lo0 = fminf(lo0, x);
    }
  }
}

// The row maxima of a tile folded into m0 (row r0) and m1 (row r0 + 8).
__device__ __forceinline__ void tile_max(const float (&s)[8], float& m0, float& m1) {
  m0 = fmaxf(m0, fmaxf(fmaxf(s[0], s[1]), fmaxf(s[4], s[5])));
  m1 = fmaxf(m1, fmaxf(fmaxf(s[2], s[3]), fmaxf(s[6], s[7])));
}

// e = expf(s - m) in place.
__device__ __forceinline__ void tile_exp(float (&s)[8], float m0, float m1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = expf(s[i] - (((i >> 1) & 1) ? m1 : m0));
}

// The row sums of a tile added to l0, l1, in one fixed order.
__device__ __forceinline__ void tile_sum(const float (&e)[8], float& l0, float& l1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if ((i >> 1) & 1) l1 += e[i];
    else l0 += e[i];
  }
}

// e / l correctly rounded (what __fdiv_rn gives), with y = RN(1 / l) taken
// once per row: q = RN(e y) lies within an ulp of e / l, and one FMA step
// q + (e - l q) y rounds to RN(e / l) (Markstein's theorem; e - l q is exact
// in an FMA). The theorem needs the quotient clear of the subnormal range:
// it holds for e = 0 and for e >= 2^-100 (l <= 2^11 here).
__device__ __forceinline__ float div_rn(float e, float l, float y) {
  const float q = __fmul_rn(e, y);
  return __fmaf_rn(__fmaf_rn(-l, q, e), y, q);
}

// Row sums, the reciprocals that divide by them, and whether some e of the
// warp's rows may lie in (0, 2^-100): a score more than 69 below its row's
// max (e^-69 > 2^-100). Then the warp divides with __fdiv_rn itself.
struct Norm {
  float l0, l1, y0, y1;
  bool exact;
};
__device__ __forceinline__ Norm make_norm(float l0, float l1, float m0, float m1, float lo0,
                                          float lo1) {
  const bool far = m0 - lo0 > 69.f || m1 - lo1 > 69.f;
  return Norm{l0, l1, __frcp_rn(l0), __frcp_rn(l1), __any_sync(0xffffffffu, far) != 0};
}

// p = e / l rounded to bf16, as the A fragment of P V for this 16-key tile:
// a0 row r0 keys 2t4.., a1 row r0 + 8, a2 row r0 keys 8 + 2t4.., a3 row r0 + 8.
__device__ __forceinline__ void tile_p(unsigned (&a)[4], const float (&e)[8], const Norm& n) {
  if (n.exact) {
    a[0] = pack_bf16(__fdiv_rn(e[0], n.l0), __fdiv_rn(e[1], n.l0));
    a[1] = pack_bf16(__fdiv_rn(e[2], n.l1), __fdiv_rn(e[3], n.l1));
    a[2] = pack_bf16(__fdiv_rn(e[4], n.l0), __fdiv_rn(e[5], n.l0));
    a[3] = pack_bf16(__fdiv_rn(e[6], n.l1), __fdiv_rn(e[7], n.l1));
    return;
  }
  a[0] = pack_bf16(div_rn(e[0], n.l0, n.y0), div_rn(e[1], n.l0, n.y0));
  a[1] = pack_bf16(div_rn(e[2], n.l1, n.y1), div_rn(e[3], n.l1, n.y1));
  a[2] = pack_bf16(div_rn(e[4], n.l0, n.y0), div_rn(e[5], n.l0, n.y0));
  a[3] = pack_bf16(div_rn(e[6], n.l1, n.y1), div_rn(e[7], n.l1, n.y1));
}

// o += P (16 rows x 16 keys) V (16 keys x Dv); vs: the tile's V rows.
template <int DVN, bool FIXED>
__device__ __forceinline__ void tile_pv(float (&o)[2 * DVN][4], const unsigned (&a)[4],
                                        const bf16* vs, int ldv, int dvn, int lane) {
  // lanes 0-7: keys 0-7, columns 0-7; 8-15: keys 8-15; 16-31: columns 8-15.
  // Transposed: b0b1 and b2b3 of the n-tiles of columns 0-7 and 8-15.
  const bf16* base = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldv + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < DVN; ++j) {
    if (FIXED || j < dvn) {
      unsigned b[4];
      ldsm_x4_trans(b, base + j * 16);
      mma_bf16(o[2 * j], a, b[0], b[1]);
      mma_bf16(o[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// The warp's Q fragments: rows q_warp (16 of the Q tile), D / 16 steps.
template <int DK, bool FIXED>
__device__ __forceinline__ void load_q(unsigned (&qf)[DK][4], const bf16* q_warp, int ldq, int dk,
                                       int lane) {
  const bf16* base = q_warp + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldq + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    if (FIXED || kk < dk) ldsm_x4(qf[kk], base + kk * 16);
}

// o rounded to bf16 into the warp's 16 rows of the Q tile, then 16-byte
// stores of the rows below Nq.
template <int DVN, bool FIXED>
__device__ __forceinline__ void store_out(const float (&o)[2 * DVN][4], bf16* q_warp, int ldq,
                                          bf16* dst, long long sr, int row0, int Nq, int Dv,
                                          int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * DVN; ++n) {
    if (FIXED || n < Dv / 8) {
      bf16* p = q_warp + g * ldq + n * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(p) = pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<unsigned*>(p + 8 * ldq) = pack_bf16(o[n][2], o[n][3]);
    }
  }
  __syncwarp();
  const int per_row = Dv / 8;
  for (int i = lane; i < 16 * per_row; i += 32) {
    const int r = i / per_row, c = (i % per_row) * 8;
    if (row0 + r < Nq)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * sr + c) =
          *reinterpret_cast<const uint4*>(q_warp + r * ldq + c);
  }
}

// o unrounded into fp32 rows (kernel 9's attention, quantized per row over
// all heads next): straight from the accumulators, a value pair a lane, so
// that a quad's four pairs fill one 32-byte sector.
template <int DVN, bool FIXED>
__device__ __forceinline__ void store_out(const float (&o)[2 * DVN][4], bf16*, int, float* dst,
                                          long long sr, int row0, int Nq, int Dv, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * DVN; ++n) {
    if (FIXED || n < Dv / 8) {
      float* p = dst + (row0 + g) * sr + n * 8 + 2 * t4;
      if (row0 + g < Nq) *reinterpret_cast<float2*>(p) = make_float2(o[n][0], o[n][1]);
      if (row0 + g + 8 < Nq) *reinterpret_cast<float2*>(p + 8 * sr) = make_float2(o[n][2], o[n][3]);
    }
  }
}

// What every thread of a block derives from blockIdx and the problem.
template <typename OutT>
struct Block {
  int W, warp, lane, row_block, row_warp, nkt, nc;
  bool active;  // the warp has query rows
  const bf16 *qp, *kp, *vp;
  OutT* op;
  Rows R;
};

template <typename OutT>
__device__ __forceinline__ Block<OutT> block_setup(const Operand<const bf16>& q,
                                                   const Operand<const bf16>& k,
                                                   const Operand<const bf16>& v,
                                                   const Operand<OutT>& out, const Problem& pr,
                                                   float scale, const ScoreTerms& st,
                                                   int groups) {
  Block<OutT> B;
  B.W = blockDim.x / 32;
  B.warp = threadIdx.x / 32;
  B.lane = threadIdx.x % 32;
  const int bh = blockIdx.x / groups;
  const int b = bh / pr.H, h = bh % pr.H;
  B.row_block = (blockIdx.x % groups) * B.W * 16;
  B.row_warp = B.row_block + B.warp * 16;
  B.active = B.row_warp < pr.Nq;
  B.nkt = (pr.Nk + 15) / 16;
  B.nc = (pr.Nk + KC - 1) / KC;
  B.qp = q.at(b, h);
  B.kp = k.at(b, h);
  B.vp = v.at(b, h);
  B.op = out.at(b, h);
  const float* bias = nullptr;
  if (st.bias != nullptr) {
    const int nbh = st.bias_h ? pr.H : 1;
    bias = st.bias +
           ((size_t)(st.bias_b ? b : 0) * nbh + (st.bias_h ? h : 0)) * (size_t)pr.Nq * pr.Nk;
  }
  const bool masked = st.true_n != st.bt || st.bt != pr.Nk;
  B.R = Rows{B.row_warp + (B.lane >> 2), B.lane & 3, pr.Nq, pr.Nk, scale, bias, masked,
             bias == nullptr && !masked && !st.mask_self, st};
  return B;
}
}  // namespace attn90

// The whole score row of each warp in registers: KT tiles of 16 keys (Nk <=
// 16 KT), at D = Dv = 64 (every caller on the serving paths), so that every
// width is a constant. Every K chunk and every V chunk has its own buffer
// (at most 4 + 4 chunks, 74 KB), and all are in flight from the start: Q and
// K in one cp.async group, V in the next, so the block waits for memory once
// for each while V arrives during passes 1 and 2.
template <int KT, typename OutT>
__global__ void __launch_bounds__(attn90::MAX_WARPS * 32)
attention_sm90_resident(attn90::Operand<const bf16> q, attn90::Operand<const bf16> k,
                        attn90::Operand<const bf16> v, attn90::Operand<OutT> out,
                        attn90::Problem pr, float scale, attn90::ScoreTerms st, int groups) {
  using namespace attn90;
  constexpr int NC = (KT + 3) / 4;  // chunks of KC keys
  constexpr int DK = 4, DVN = 4, D = 16 * DK, Dv = 16 * DVN;
  extern __shared__ __align__(128) unsigned char smem[];
  const Block<OutT> B = block_setup(q, k, v, out, pr, scale, st, groups);
  const Layout L = layout(B.W, D, Dv, 0);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* q_warp = Qs + B.warp * 16 * L.ldq;
  const auto kst = [&](int c) {
    return reinterpret_cast<bf16*>(smem + L.q_bytes + c * L.stage_bytes);
  };
  const auto vst = [&](int c) { return kst(c) + L.v_off / sizeof(bf16); };

  load_rows_async(Qs, L.ldq, B.qp, q.sr, B.row_block, B.W * 16, pr.Nq, D);
  for (int c = 0; c < B.nc; ++c) load_rows_async(kst(c), L.ldk, B.kp, k.sr, c * KC, KC, pr.Nk, D);
  cp_async_commit();
  for (int c = 0; c < B.nc; ++c) load_rows_async(vst(c), L.ldv, B.vp, v.sr, c * KC, KC, pr.Nk, Dv);
  cp_async_commit();
  cp_async_wait<1>();  // Q and K
  __syncthreads();

  unsigned qf[DK][4];
  float S[KT][8];
  float m0 = -INFINITY, m1 = -INFINITY, lo0 = INFINITY, lo1 = INFINITY;
  float l0 = 0.f, l1 = 0.f;
  Norm nm{};
  if (B.active) {
    // Pass 1: S = Q K^T with its terms, and the row max.
    load_q<DK, true>(qf, q_warp, L.ldq, DK, B.lane);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < B.nc) {
        score_chunk<DK, KT, true>(S, c, B.nkt, qf, kst(c), L.ldk, DK, B.lane);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = c * 4 + u;
          if (t < KT && t < B.nkt) {
            score_terms(S[t], t * 16, B.R, lo0, lo1);
            tile_max(S[t], m0, m1);
          }
        }
      }
    }
    // Pass 2, in registers: e and l.
    m0 = quad_max(m0);
    m1 = quad_max(m1);
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t < B.nkt) {
        tile_exp(S[t], m0, m1);
        tile_sum(S[t], l0, l1);
      }
    }
    nm = make_norm(quad_sum(l0), quad_sum(l1), m0, m1, lo0, lo1);
  }
  cp_async_wait<0>();  // V
  __syncthreads();
  if (!B.active) return;
  // Pass 3: P V.
  float o[2 * DVN][4];
#pragma unroll
  for (int n = 0; n < 2 * DVN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    if (t < B.nkt) {
      unsigned a[4];
      tile_p(a, S[t], nm);
      tile_pv<DVN, true>(o, a, vst(t / 4) + (t % 4) * 16 * L.ldv, L.ldv, DVN, B.lane);
    }
  }
  store_out<DVN, true>(o, q_warp, L.ldq, B.op, out.sr, B.row_warp, pr.Nq, Dv, B.lane);
}

// The score row swept three times over the K chunks (max; sum; P V), for
// rows too long or heads too wide to keep in registers. Step s of the ring
// is pass s / nc over chunk s % nc, in stage s % 2; pass 3's chunks carry K
// and V.
template <int DK, int DVN, typename OutT>
__global__ void __launch_bounds__(attn90::MAX_WARPS * 32)
attention_sm90_streamed(attn90::Operand<const bf16> q, attn90::Operand<const bf16> k,
                        attn90::Operand<const bf16> v, attn90::Operand<OutT> out,
                        attn90::Problem pr, float scale, attn90::ScoreTerms st, int groups) {
  using namespace attn90;
  extern __shared__ __align__(128) unsigned char smem[];
  const Block<OutT> B = block_setup(q, k, v, out, pr, scale, st, groups);
  const int D = pr.D, Dv = pr.Dv, dk = D / 16, dvn = Dv / 16;
  const Layout L = layout(B.W, D, Dv, 0);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* q_warp = Qs + B.warp * 16 * L.ldq;
  const auto kst = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L.q_bytes + (s & 1) * L.stage_bytes);
  };
  const auto vst = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L.q_bytes + (s & 1) * L.stage_bytes + L.v_off);
  };
  const int steps = 3 * B.nc;
  const auto fetch = [&](int s) {
    if (s < steps) {
      const int c = s % B.nc;
      load_rows_async(kst(s), L.ldk, B.kp, k.sr, c * KC, KC, pr.Nk, D);
      if (s >= 2 * B.nc) load_rows_async(vst(s), L.ldv, B.vp, v.sr, c * KC, KC, pr.Nk, Dv);
    }
    cp_async_commit();
  };

  load_rows_async(Qs, L.ldq, B.qp, q.sr, B.row_block, B.W * 16, pr.Nq, D);
  fetch(0);

  unsigned qf[DK][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, lo0 = INFINITY, lo1 = INFINITY;
  Norm nm{};
  float o[2 * DVN][4];
#pragma unroll
  for (int n = 0; n < 2 * DVN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int s = 0; s < steps; ++s) {
    fetch(s + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int pass = s / B.nc, c = s % B.nc;
    if (B.active) {
      if (s == 0) load_q<DK, false>(qf, q_warp, L.ldq, dk, B.lane);
      float e[4][8];
      score_chunk<DK, 4, false>(e, 0, B.nkt - c * 4, qf, kst(s), L.ldk, dk, B.lane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = c * 4 + u;
        if (t < B.nkt) {
          score_terms(e[u], t * 16, B.R, lo0, lo1);
          if (pass == 0) {
            tile_max(e[u], m0, m1);
            continue;
          }
          tile_exp(e[u], m0, m1);
          if (pass == 1) {
            tile_sum(e[u], l0, l1);
          } else {
            unsigned a[4];
            tile_p(a, e[u], nm);
            tile_pv<DVN, false>(o, a, vst(s) + u * 16 * L.ldv, L.ldv, dvn, B.lane);
          }
        }
      }
      if (c == B.nc - 1) {
        if (pass == 0) {
          m0 = quad_max(m0);
          m1 = quad_max(m1);
        } else if (pass == 1) {
          nm = make_norm(quad_sum(l0), quad_sum(l1), m0, m1, lo0, lo1);
        }
      }
    }
    __syncthreads();
  }
  if (B.active)
    store_out<DVN, false>(o, q_warp, L.ldq, B.op, out.sr, B.row_warp, pr.Nq, Dv, B.lane);
}

namespace attn90 {
constexpr int MAX_SMEM = 232448;  // 227 KB, the most one block may use
// A kernel of the core, by output type (bf16 rows; fp32 rows for kernel 9);
// the resident ones hold every chunk at once.
template <typename OutT>
struct Variant {
  void (*kernel)(Operand<const bf16>, Operand<const bf16>, Operand<const bf16>, Operand<OutT>,
                 Problem, float, ScoreTerms, int);
  bool resident;
};

template <typename OutT = bf16>
inline Variant<OutT> variant(const Problem& pr) {
  const int nkt = (pr.Nk + 15) / 16;
  if (pr.D == 64 && pr.Dv == 64 && nkt <= RESIDENT_TILES)
    return {nkt <= 4 ? attention_sm90_resident<4, OutT>
                     : attention_sm90_resident<RESIDENT_TILES, OutT>,
            true};
  if (pr.D <= 64 && pr.Dv <= 64) return {attention_sm90_streamed<4, 4, OutT>, false};
  return {attention_sm90_streamed<8, 8, OutT>, false};
}

// How a launch runs: warps a block and the shared memory a block takes.
struct Plan {
  int warps;
  size_t bytes;
};

// The plan for the work: B * H pairs of rt = ceil(Nq / 16) row tiles, split
// evenly into blocks of W warps. A row's arithmetic is the same in every
// plan. The rule follows a sweep of W = 1-8 on the H100 at batch 128:
// - where a block's K and V outweigh the q and output rows of four warps
//   (Nk > 64: ViT's 197 keys), the largest W, since each block reads its
//   (b, h)'s K and V whole; W = 7 (two blocks a (b, h)) was the fastest;
// - else (Twins' 64, 16, 4 and 1 keys) W = 4: more, smaller blocks an SM
//   overlap one block's copies with another's work better than fewer large
//   ones; W = 4 was the fastest at all four shapes;
// - then, while the blocks would leave more than three quarters of the SMs
//   idle (ViT-L at batch 1: 32 blocks of 7), smaller blocks.
template <typename OutT>
inline Plan plan_for(const Variant<OutT>& var, const Problem& pr) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long bh = (long long)pr.B * pr.H;
  const int rt = (pr.Nq + 15) / 16;
  const int nc = (pr.Nk + KC - 1) / KC;
  const auto groups = [&](int w) { return (rt + w - 1) / w; };
  const auto even = [&](int w) { return (rt + groups(w) - 1) / groups(w); };
  int w = even(pr.Nk > 4 * 16 ? MAX_WARPS : 4);
  while (w > 1 && bh * groups(w) * 4 < sms) w = even(w - 1);
  const int stages = var.resident ? nc : 2;
  return Plan{w, layout(w, pr.D, pr.Dv, stages).bytes};
}
}  // namespace attn90

// The general entry: q [B, H, Nq, D], k [B, H, Nk, D], v [B, H, Nk, Dv], out
// [B, H, Nq, Dv] (bf16, or fp32 unrounded), each through its own strides
// (unit column stride; base, sb, sh and sr 16-byte aligned). D, Dv multiples
// of 16 up to 128; any Nk >= 1.
template <typename OutT>
inline cudaError_t attention_core_sm90(attn::Operand<const bf16> q, attn::Operand<const bf16> k,
                                       attn::Operand<const bf16> v, attn::Operand<OutT> out,
                                       attn::Problem pr, float scale, attn::ScoreTerms st,
                                       cudaStream_t stream) {
  using namespace attn90;
  if (pr.D % 16 != 0 || pr.D < 16 || pr.D > 128 || pr.Dv % 16 != 0 || pr.Dv < 16 ||
      pr.Dv > 128 || pr.Nk < 1 || pr.Nq < 1 || pr.B < 1 || pr.H < 1)
    return cudaErrorInvalidValue;
  const Variant<OutT> var = variant<OutT>(pr);
  const Plan plan = plan_for(var, pr);
  const int groups = ((pr.Nq + 15) / 16 + plan.warps - 1) / plan.warps;
  const long long blocks = (long long)pr.B * pr.H * groups;
  if (blocks > 0x7fffffffLL || plan.bytes > size_t(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(var.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.bytes));
  if (e != cudaSuccess) return e;
  var.kernel<<<static_cast<unsigned>(blocks), plan.warps * 32, plan.bytes, stream>>>(
      q, k, v, out, pr, scale, st, groups);
  return cudaGetLastError();
}

// Self-attention on the fused [B*N, 3*H*Dh] qkv rows ([q | k | v], each
// [H, Dh]) into out [B*N, H*Dh] (bf16, or fp32 for kernel 9).
template <typename OutT>
inline cudaError_t attention_core_sm90(const bf16* qkv, OutT* out, int B, int N, int H, int Dh,
                                       float scale, attn::ScoreTerms st, cudaStream_t stream) {
  using attn::Operand;
  const long long HD = (long long)H * Dh, row = 3 * HD;
  const Operand<const bf16> q{qkv, N * row, Dh, row};
  const Operand<const bf16> k{qkv + HD, N * row, Dh, row};
  const Operand<const bf16> v{qkv + 2 * HD, N * row, Dh, row};
  const Operand<OutT> o{out, N * HD, Dh, HD};
  return attention_core_sm90(q, k, v, o, attn::Problem{B, H, N, N, Dh, Dh}, scale, st, stream);
}

}  // namespace
}  // namespace vt
