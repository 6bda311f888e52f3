// The head-mixing attention core shared by two kernels:
//   - CaiT's talking heads (talking_heads_block.cu): scores -> pre-softmax
//     H x H head mix -> padded keys masked -> softmax -> post-softmax mix;
//   - DeepViT's re-attention (reattention_block.cu): masked softmax -> H x H
//     head mix -> LayerNorm across the heads at each (i, j) -> padded key
//     columns zeroed.
// Then P, rounded to bf16, times V per head, rounded to bf16 into the rows of
// out [B*N, H*Dh]. This is the arithmetic of
// vit_tpu/ops/reattention_block.py:90-135 and :202-235, with the rounding
// sites of the twins:
//   - the scores in fp32 (mma.sync sums), scaled with __fmul_rn;
//   - the exact softmax per (head, row) in jax.nn.softmax's order: the row
//     max, e = expf(s - m), l = sum(e), p = e / l (IEEE division);
//   - each head mix a sequential sum over h = 0..H-1 of mix[h, g] * x_h with
//     __fmul_rn / __fadd_rn (no fused multiply-add), the head LayerNorm
//     spelled out the same way.
//
// Bound: at the CaiT and DeepViT presets (batch 128, 16 heads of 64, 64 / 65
// tokens) the core reads ~51 MB of qkv and writes ~17 MB for ~2.2 GFLOP of
// Q K^T and P V and ~0.3 G fp32 mix operations: ~0.02 ms on the H100. A
// first design took 1.109 ms at DeepViT (NVIDIA H100 80GB HBM3, 700.00 W):
// four warps a block walked the 16 heads one after another with synchronous
// copies between barriers, and the scores went through an fp32 slab in row
// order that every pass read and wrote again. This one takes 0.149 ms there
// on the same card (0.117 at CaiT), bound by its latency between barriers:
// one 16-warp block an SM.
//
// Design. A block owns 16 query rows of one sample across every head, since
// a mix couples all H heads at each (i, j): block (query tile, b), one warp a
// head (32 H threads).
// - Warp h computes S_h = Q_h K_h^T on mma.sync.m16n8k16 from ldmatrix
//   fragments (attention_core_sm90.cuh's helpers) and keeps the scores in its
//   accumulator registers; P_h V_h runs the same way, V through
//   ldmatrix.trans, with P_h's bf16 A fragments built from the fp32 values
//   in registers. Keys are padded to 16.
// - Each warp streams its own tiles (its Q tile, then 16-key K and V tiles
//   of its head) through a private ring of 2-4 stages in shared memory by
//   cp.async, the next tiles in flight while one is multiplied; no block
//   barrier guards a copy. The V tiles arrive during the softmax and the mix.
// - The mix crosses heads, so the values go through one fp32 slab [H][16
//   rows x keys] laid out in accumulator-fragment order: a warp writes and
//   reads its own head's plane as two float4 a key tile a lane, and the
//   mixing threads walk positions one a thread, neighbouring threads on
//   neighbouring positions, all without bank conflicts, keeping only the H
//   sums in registers. One write and one read of the slab a mix pass on each
//   side; query rows past N are not mixed.
// - The softmax runs in registers, row by row with quad shuffles.
// - The output leaves as bf16 pairs into a ring stage and goes to memory in
//   16-byte stores (attn90::store_out).
// - Two variants (plan_for): `resident`, for rows of up to RESIDENT_TILES
//   key tiles whose slab fits beside the rings (every preset: 64, 65 tokens),
//   keeps the scores in registers through the softmax and mixes the whole
//   row at once; `streamed` covers the rest of the domain (n <= 1,024, the
//   length up to which vit_tpu fuses a head-mixing layer; Dh up to 128) by
//   recomputing the scores, bitwise the same, in passes over the K tiles
//   (the max, the sum, then chunk by chunk of the slab's width: p, the mix,
//   P V; talking heads recompute the pre-mix in each pass). CaiT-S24/384's
//   576 tokens take 36 key tiles, CaiT-M48/448's 784 take 49, DeepViT's 577
//   at 384 px take 37.
//
// The fp32 route (head_mix_f32_kernel, below): with fp32 x and weights the
// TPU kernels run every product at Precision.HIGHEST, so qkv, P and each
// head's output stay fp32. The same block, warps, slab, mixes, softmax and
// passes as `streamed`, with Q K^T and P V as fp32 SIMT products (fused
// multiply-adds on the CUDA cores, operands read through L1 from the fp32 qkv
// rows) in place of the bf16 mma.sync tiles. A lane computes its eight
// scores of a tile at the accumulator-fragment positions of the bf16 core, so
// the slab, the mix passes and the softmax are shared as they are.
#pragma once

#include <math.h>

#include <type_traits>

#include "attention_core_sm90.cuh"  // attn90: ldmatrix, mma.sync, load_q, tile_pv, store_out
#include "common.cuh"

namespace vt {
namespace {

namespace hmix {
constexpr int MAX_H = 16;
constexpr int MAX_N = 1024;  // vit_tpu fuses a head-mixing layer up to 1,024 tokens
constexpr int RESIDENT_TILES = 8;  // score rows of up to 128 keys in registers
constexpr int MAX_SMEM = 232448;   // 227 KB, the most one block may use
constexpr size_t PARAM_BYTES = size_t(2 * MAX_H * MAX_H + 2 * MAX_H) * sizeof(float);
enum Mode : int { kTalkingHeads = 0, kReattention = 1 };

struct Params {
  const float* mix_a;     // [H, H]: the pre-softmax mix / the re-attention mix
  const float* mix_b;     // [H, H]: the post-softmax mix (talking heads only)
  const float* ln_scale;  // [H]: the head LayerNorm (re-attention only)
  const float* ln_bias;
  float ln_eps, inv_h;
  float* dbg_mixed;  // NULL or [B, H, N, N] fp32: the mixed scores / the mixed softmax r
  float* dbg_p;      // NULL or [B, H, N, N] fp32: the post-mixed P / the normalised r'
};

// How a launch runs: the variant, the slab's width in 16-key tiles, the ring
// stages of each warp and the shared memory of a block.
struct Plan {
  int resident, ct, stages;
  size_t bytes;
};

// Shared memory: the slab (H planes of 16 rows x 16 ct keys, fp32), the mix
// and head-LN parameters, then each warp's ring of 16 x (Dh + 8) bf16 stages
// (+8 staggers the banks of ldmatrix's row reads).
__host__ __device__ inline size_t stage_bytes(int Dh) { return size_t(16) * (Dh + 8) * 2; }
__host__ __device__ inline size_t ring_off(int H, int ct) {
  return size_t(H) * ct * 256 * sizeof(float) + PARAM_BYTES;
}
__host__ __device__ inline size_t smem_bytes(int H, int ct, int stages, int Dh) {
  return ring_off(H, ct) + size_t(H) * stages * stage_bytes(Dh);
}

// The plan of a shape (ops/reattention_block.py head_mix_plan mirrors it):
// resident where the row has at most RESIDENT_TILES key tiles and its whole
// slab fits beside rings of two stages, with the deepest ring (up to 4) that
// fits; else streamed, with a 3-stage ring where that leaves a slab of 4
// tiles (or the whole row), else 2 stages and the widest slab that fits.
inline Plan plan_for(int N, int H, int Dh) {
  const int nkt = (N + 15) / 16;
  if (nkt <= RESIDENT_TILES)
    for (int s = 4; s >= 2; --s)
      if (smem_bytes(H, nkt, s, Dh) <= size_t(MAX_SMEM))
        return Plan{1, nkt, s, smem_bytes(H, nkt, s, Dh)};
  for (int s = 3; s >= 2; --s) {
    const long long room =
        MAX_SMEM - (long long)(PARAM_BYTES + size_t(H) * s * stage_bytes(Dh));
    const int fit = room > 0 ? int(room / (H * 256 * sizeof(float))) : 0;
    const int ct = fit < nkt ? fit : nkt;
    if (ct >= (nkt < 4 ? nkt : 4) || (s == 2 && ct >= 1))
      return Plan{0, ct, s, smem_bytes(H, ct, s, Dh)};
  }
  return Plan{0, 0, 0, 0};
}
}  // namespace hmix

// cp.async.wait_group with a count known at run time (a ring of 2-4 stages).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// A tile's values in the slab: s[0..3] then s[4..7] of every lane, float4s.
__device__ __forceinline__ void put_tile(float* plane, int j, int lane, const float (&s)[8]) {
  float4* p = reinterpret_cast<float4*>(plane + j * 256);
  p[lane] = make_float4(s[0], s[1], s[2], s[3]);
  p[32 + lane] = make_float4(s[4], s[5], s[6], s[7]);
}
__device__ __forceinline__ void get_tile(const float* plane, int j, int lane, float (&s)[8]) {
  const float4* p = reinterpret_cast<const float4*>(plane + j * 256);
  const float4 a = p[lane], b = p[32 + lane];
  s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
  s[4] = b.x, s[5] = b.y, s[6] = b.z, s[7] = b.w;
}

// S (16 rows x 16 keys) = Q K^T of one K tile in shared memory: s[0..3] keys
// 0-7 (rows r0 and r0 + 8, columns 2 t4 + {0, 1}), s[4..7] keys 8-15.
template <int DK>
__device__ __forceinline__ void score_tile(float (&s)[8], const unsigned (&qf)[DK][4],
                                           const bf16* ks, int ld, int dk, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
  const bf16* base = ks + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    if (kk < dk) {
      unsigned b[4];
      attn90::ldsm_x4(b, base + kk * 16);
      attn90::mma_bf16(s, qf[kk], b[0], b[1]);
      attn90::mma_bf16(s + 4, qf[kk], b[2], b[3]);
    }
  }
}

// The head LayerNorm of one position's H mixed values, in place
// (reattention_block.py:116-123), padded key columns zeroed (the LN bias
// would turn them into bias_g).
__device__ __forceinline__ void head_ln(float (&y)[hmix::MAX_H], int H, const float* lns,
                                        const float* lnb, float inv_h, float eps, bool real) {
  float sum = y[0], sq = __fmul_rn(y[0], y[0]);
#pragma unroll
  for (int g = 1; g < hmix::MAX_H; ++g) {
    if (g < H) {
      sum = __fadd_rn(sum, y[g]);
      sq = __fadd_rn(sq, __fmul_rn(y[g], y[g]));
    }
  }
  const float mean = __fmul_rn(sum, inv_h);
  const float var = fmaxf(__fsub_rn(__fmul_rn(sq, inv_h), __fmul_rn(mean, mean)), 0.0f);
  const float inv = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int g = 0; g < hmix::MAX_H; ++g)
    if (g < H) y[g] = real ? ln_value(y[g], mean, inv, lns[g], lnb[g]) : 0.0f;
}

enum MixPass : int { kPreMix = 0, kPostMix = 1, kReMix = 2 };

// One mix pass over the slab's first `len` key tiles (keys from 16 * tile0),
// by every thread of the block, one position at a time, in place:
//   y[g] = sum_h w[h][g] * x[h], in h order, each product and add rounded,
// with x[h] read from plane h as the sum reaches it and the mix row h (16
// floats, rows MAX_H apart) as four float4 broadcasts, so that only the H
// sums stay in registers. Positions of query rows past N are left as they
// are: their rows are never stored. `dbg` writes the checked intermediates.
template <int PASS>
__device__ __forceinline__ void mix_slab(float* slab, int plane, int len, int tile0, int q0,
                                         int b, int N, int H, float scale, int valid,
                                         const float* w, const float* lns, const float* lnb,
                                         const hmix::Params& prm, bool dbg) {
  using hmix::MAX_H;
  for (int p = threadIdx.x; p < len * 256; p += blockDim.x) {
    // p = ((j * 2 + half) * 32 + lane) * 4 + e: value s[4 half + e] of that lane in tile j
    const int j = p >> 8, half = (p >> 7) & 1, ln = (p >> 2) & 31, e = p & 3;
    const int row = (ln >> 2) + ((e >> 1) & 1) * 8;
    const int col = (tile0 + j) * 16 + half * 8 + 2 * (ln & 3) + (e & 1);
    const int q = q0 + row;
    if (q >= N) continue;
    float y[MAX_H];
#pragma unroll
    for (int h = 0; h < MAX_H; ++h) {
      if (h < H) {
        float x = slab[h * plane + p];
        if (PASS == kPreMix) x = __fmul_rn(x, scale);
        const float4* wr = reinterpret_cast<const float4*>(w + h * MAX_H);
#pragma unroll
        for (int g4 = 0; g4 < MAX_H / 4; ++g4) {
          if (4 * g4 < H) {
            const float4 w4 = wr[g4];
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int g = 4 * g4 + u;
              if (g < H) y[g] = h == 0 ? __fmul_rn(wv[u], x) : __fadd_rn(y[g], __fmul_rn(wv[u], x));
            }
          }
        }
      }
    }
    float* first = PASS == kPostMix ? prm.dbg_p : prm.dbg_mixed;
    const bool keep = dbg && col < N;
    const size_t o = (((size_t)b * H) * N + q) * N + col;  // head 0's (q, col)
    if (PASS == kReMix) {
#pragma unroll
      for (int g = 0; g < MAX_H; ++g)
        if (g < H && keep && first != nullptr) first[o + (size_t)g * N * N] = y[g];
      head_ln(y, H, lns, lnb, prm.inv_h, prm.ln_eps, col < valid);
      first = prm.dbg_p;
    }
#pragma unroll
    for (int g = 0; g < MAX_H; ++g) {
      if (g < H) {
        if (PASS == kPreMix && col >= valid) y[g] = -1e30f;  // padded keys masked after the pre-mix
        slab[g * plane + p] = y[g];
        if (keep && first != nullptr) first[o + (size_t)g * N * N] = y[g];
      }
    }
  }
}

// The row softmax on a lane's eight values of a tile: value i belongs to
// query row r0 + 8 ((i >> 1) & 1), so (m0, l0) and (m1, l1) are the two rows'
// max and sum (a lane's partials; attn90::quad_max / quad_sum finish them).
__device__ __forceinline__ void fold_max(const float (&s)[8], float& m0, float& m1) {
  m0 = fmaxf(m0, fmaxf(fmaxf(s[0], s[1]), fmaxf(s[4], s[5])));
  m1 = fmaxf(m1, fmaxf(fmaxf(s[2], s[3]), fmaxf(s[6], s[7])));
}
__device__ __forceinline__ void exps(float (&s)[8], float m0, float m1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = expf(s[i] - (((i >> 1) & 1) ? m1 : m0));
}
__device__ __forceinline__ void add_sums(const float (&s)[8], float& l0, float& l1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if ((i >> 1) & 1) l1 += s[i];
    else l0 += s[i];
  }
}
__device__ __forceinline__ void divide(float (&s)[8], float l0, float l1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = __fdiv_rn(s[i], ((i >> 1) & 1) ? l1 : l0);
}

// Re-attention's softmax input for key tile t: the scores scaled, keys from
// `valid` on at -inf. Value i of lane quad t4 is key 16 t + 8 (i >> 2) + 2 t4 + (i & 1).
__device__ __forceinline__ void scale_keys(float (&s)[8], int t, int t4, float scale, int valid) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s[i] = 16 * t + (i >> 2) * 8 + 2 * t4 + (i & 1) < valid ? __fmul_rn(s[i], scale) : -INFINITY;
}

// One mix pass between block barriers: every warp's plane is written before
// it, the mixed values are in place after it.
__device__ __forceinline__ void mix_pass(int pass, float* slab, int plane, int len, int tile0,
                                         int q0, int b, int N, int H, float scale, int valid,
                                         const float* mix_a, const float* mix_b,
                                         const float* lns, const float* lnb,
                                         const hmix::Params& prm, bool dbg) {
  __syncthreads();
  if (pass == kPreMix)
    mix_slab<kPreMix>(slab, plane, len, tile0, q0, b, N, H, scale, valid, mix_a, lns, lnb, prm,
                      dbg);
  else if (pass == kPostMix)
    mix_slab<kPostMix>(slab, plane, len, tile0, q0, b, N, H, scale, valid, mix_b, lns, lnb, prm,
                       dbg);
  else
    mix_slab<kReMix>(slab, plane, len, tile0, q0, b, N, H, scale, valid, mix_a, lns, lnb, prm,
                     dbg);
  __syncthreads();
}

// The streamed variant's passes, shared by the bf16 and the fp32 core:
// passes 1 and 2 take the row max, then the row sum, each over every K tile;
// pass 3, chunk by chunk of the slab's width, puts p into the warp's plane,
// mixes it and adds P V. scores(s, t) gives key tile t's fp32 scores (the
// bf16 core takes its tiles from its ring in exactly this order); scaled(s, t)
// is scale_keys; mix(pass, len, tile0, dbg) is mix_pass; pv(j, t) adds slab
// tile j (key tile t) times V. Talking heads recompute the pre-mix each pass.
template <int MODE, class Scores, class Scaled, class Mix, class PV>
__device__ __forceinline__ void streamed_passes(float* own, int lane, int nkt, int ct,
                                                const Scores& scores, const Scaled& scaled,
                                                const Mix& mix, const PV& pv) {
  const int nch = (nkt + ct - 1) / ct;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      m0 = attn90::quad_max(m0);
      m1 = attn90::quad_max(m1);
    }
    for (int c = 0; c < nch; ++c) {
      const int len = min(ct, nkt - c * ct);
      for (int j = 0; j < len; ++j) {
        float s[8];
        scores(s, c * ct + j);
        if (MODE == hmix::kReattention) {
          scaled(s, c * ct + j);
          if (pass == 0) {
            fold_max(s, m0, m1);
          } else {
            exps(s, m0, m1);
            add_sums(s, l0, l1);
          }
        } else {
          put_tile(own, j, lane, s);
        }
      }
      if (MODE == hmix::kTalkingHeads) {
        mix(kPreMix, len, c * ct, false);
        for (int j = 0; j < len; ++j) {
          float s[8];
          get_tile(own, j, lane, s);
          if (pass == 0) {
            fold_max(s, m0, m1);
          } else {
            exps(s, m0, m1);
            add_sums(s, l0, l1);
          }
        }
      }
    }
  }
  l0 = attn90::quad_sum(l0);
  l1 = attn90::quad_sum(l1);
  for (int c = 0; c < nch; ++c) {
    const int len = min(ct, nkt - c * ct);
    for (int j = 0; j < len; ++j) {
      float s[8];
      scores(s, c * ct + j);
      if (MODE == hmix::kReattention) {
        scaled(s, c * ct + j);
        exps(s, m0, m1);
        divide(s, l0, l1);
      }
      put_tile(own, j, lane, s);
    }
    if (MODE == hmix::kTalkingHeads) {
      mix(kPreMix, len, c * ct, true);
      for (int j = 0; j < len; ++j) {
        float s[8];
        get_tile(own, j, lane, s);
        exps(s, m0, m1);
        divide(s, l0, l1);
        put_tile(own, j, lane, s);
      }
      mix(kPostMix, len, c * ct, true);
    } else {
      mix(kReMix, len, c * ct, true);
    }
    for (int j = 0; j < len; ++j) pv(j, c * ct + j);
  }
}

// Block (query tile of 16 rows, b), warp h = head h. KT > 0: the resident
// variant, whose scores stay in registers through the softmax (nkt <= KT,
// one slab chunk); KT = 0: the streamed one. DK: Dh / 16 at most (4 or 8).
template <int MODE, int KT, int DK>
__global__ void __launch_bounds__(hmix::MAX_H * 32, 1)
head_mix_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int Dh,
                float scale, int valid, hmix::Params prm, hmix::Plan plan) {
  using namespace hmix;
  constexpr bool RESIDENT = KT > 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ct = plan.ct, plane = ct * 256, stages = plan.stages;
  float* slab = reinterpret_cast<float*>(smem);
  float* mix_a = reinterpret_cast<float*>(smem + size_t(H) * plane * sizeof(float));
  float* mix_b = mix_a + MAX_H * MAX_H;
  float* lns = mix_b + MAX_H * MAX_H;
  float* lnb = lns + MAX_H;
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, q0 = blockIdx.x * 16;
  const int HD = H * Dh, stride = 3 * HD, ld = Dh + 8, dk = Dh / 16;
  const int nkt = (N + 15) / 16;
  const int steps = 1 + (RESIDENT ? 2 : 4) * nkt;
  bf16* ring = reinterpret_cast<bf16*>(smem + ring_off(H, ct)) + (size_t)h * stages * 16 * ld;
  const bf16* base = qkv + (size_t)b * N * stride + h * Dh;

  for (int e = threadIdx.x; e < H * H; e += blockDim.x) {  // rows MAX_H apart
    mix_a[e / H * MAX_H + e % H] = prm.mix_a[e];
    if (MODE == kTalkingHeads) mix_b[e / H * MAX_H + e % H] = prm.mix_b[e];
  }
  if (MODE == kReattention && threadIdx.x < H) {
    lns[threadIdx.x] = prm.ln_scale[threadIdx.x];
    lnb[threadIdx.x] = prm.ln_bias[threadIdx.x];
  }

  // The warp's stream: step 0 its Q tile; then (resident) K tiles 0..nkt-1
  // and V tiles 0..nkt-1; (streamed) the K tiles twice, then each chunk's K
  // tiles and V tiles. Rows past N are zero-filled.
  const auto stage = [&](int s) { return ring + (s % stages) * 16 * ld; };
  const auto fetch = [&](int s) {
    if (s < steps) {
      int col = 0, row0 = q0;  // Q
      if (s > 0) {
        int r = s - 1, which = 1, tile;
        if (RESIDENT) {
          which = r < nkt ? 1 : 2;
          tile = r < nkt ? r : r - nkt;
        } else if (r < 2 * nkt) {
          tile = r % nkt;
        } else {
          r -= 2 * nkt;
          const int c = r / (2 * ct), w = r % (2 * ct), len = min(ct, nkt - c * ct);
          which = w < len ? 1 : 2;
          tile = c * ct + (w < len ? w : w - len);
        }
        col = which * HD;
        row0 = tile * 16;
      }
      bf16* dst = stage(s);
      const int per_row = Dh / 8;
      for (int i = lane; i < 16 * per_row; i += 32) {
        const int r = i / per_row, c = (i % per_row) * 8;
        const bool ok = row0 + r < N;
        cp_async16(dst + r * ld + c, ok ? base + (size_t)(row0 + r) * stride + col + c : base, ok);
      }
    }
    cp_async_commit();
  };
  int step = 0;
  // The next step's stage, once it has landed; the stage of the step before
  // it is refilled (every lane is done reading it).
  const auto acquire = [&]() -> const bf16* {
    __syncwarp();
    fetch(step + stages - 1);
    cp_async_wait_upto(stages - 1);
    __syncwarp();
    return stage(step++);
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);

  unsigned qf[DK][4];
  attn90::load_q<DK, false>(qf, acquire(), ld, dk, lane);
  float* own = slab + h * plane;
  const int t4 = lane & 3;
  const auto scores = [&](float (&s)[8], int) {
    score_tile<DK>(s, qf, acquire(), ld, dk, lane);
  };
  const auto scaled = [&](float (&s)[8], int t) { scale_keys(s, t, t4, scale, valid); };
  // o += P (tile j of the warp's plane) V (the next step's tile)
  using Acc = float[2 * DK][4];
  const auto pv_from_slab = [&](Acc& o, int j) {
    float p[8];
    get_tile(own, j, lane, p);
    const unsigned a[4] = {attn90::pack_bf16(p[0], p[1]), attn90::pack_bf16(p[2], p[3]),
                           attn90::pack_bf16(p[4], p[5]), attn90::pack_bf16(p[6], p[7])};
    attn90::tile_pv<DK, false>(o, a, acquire(), ld, dk, lane);
  };
  const auto mix = [&](int pass, int len, int tile0, bool dbg) {
    mix_pass(pass, slab, plane, len, tile0, q0, b, N, H, scale, valid, mix_a, mix_b, lns, lnb,
             prm, dbg);
  };
  // o rounded to bf16 through a free ring stage, 16-byte stores
  const auto store = [&](const Acc& o) {
    __syncwarp();
    attn90::store_out<DK, false>(o, stage(step), ld, out + (size_t)b * N * HD + h * Dh, HD, q0,
                                 N, Dh, lane);
  };
  if constexpr (RESIDENT) {
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float S[KT][8];
    if (MODE == kReattention) {
#pragma unroll
      for (int t = 0; t < KT; ++t)
        if (t < nkt) {
          scores(S[t], t);
          scaled(S[t], t);
          fold_max(S[t], m0, m1);
        }
    } else {
#pragma unroll
      for (int t = 0; t < KT; ++t)
        if (t < nkt) {
          scores(S[t], t);
          put_tile(own, t, lane, S[t]);
        }
      mix(kPreMix, nkt, 0, true);
#pragma unroll
      for (int t = 0; t < KT; ++t)
        if (t < nkt) {
          get_tile(own, t, lane, S[t]);
          fold_max(S[t], m0, m1);
        }
    }
    m0 = attn90::quad_max(m0);
    m1 = attn90::quad_max(m1);
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (t < nkt) {
        exps(S[t], m0, m1);
        add_sums(S[t], l0, l1);
      }
    l0 = attn90::quad_sum(l0);
    l1 = attn90::quad_sum(l1);
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (t < nkt) {
        divide(S[t], l0, l1);
        put_tile(own, t, lane, S[t]);
      }
    if (MODE == kReattention) mix(kReMix, nkt, 0, true);
    else mix(kPostMix, nkt, 0, true);
    Acc o = {};
    for (int t = 0; t < nkt; ++t) pv_from_slab(o, t);
    store(o);
  } else {
    Acc o = {};
    streamed_passes<MODE>(own, lane, nkt, ct, scores, scaled, mix,
                          [&](int j, int) { pv_from_slab(o, j); });
    store(o);
  }
}

template <int MODE, int KT, int DK>
cudaError_t launch_head_mix(const bf16* qkv, bf16* out, int B, int N, int H, int Dh, float scale,
                            int valid, const hmix::Params& prm, const hmix::Plan& plan,
                            cudaStream_t stream) {
  const auto kernel = head_mix_kernel<MODE, KT, DK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + 15) / 16, B);
  kernel<<<grid, H * 32, plan.bytes, stream>>>(qkv, out, N, H, Dh, scale, valid, prm, plan);
  return cudaGetLastError();
}

// The core on the fused [B*N, 3*H*Dh] qkv rows into out [B*N, H*Dh]: n <= 1,024,
// H <= 16, Dh a multiple of 16 up to 128; keys from true_n on are padding.
template <int MODE>
cudaError_t head_mix_core(const bf16* qkv, bf16* out, int B, int N, int H, int Dh, float scale,
                          int true_n, const hmix::Params& prm, cudaStream_t stream) {
  using namespace hmix;
  if (N < 1 || N > MAX_N || H < 1 || H > MAX_H || Dh < 16 || Dh % 16 != 0 || Dh > 128 || B < 1 ||
      B > 65535 || true_n < 1 || true_n > N)
    return cudaErrorInvalidValue;
  const Plan plan = plan_for(N, H, Dh);
  if (plan.ct < 1) return cudaErrorInvalidValue;
  // the resident score row sized to the presets' 4-5 key tiles, or to 8
  const auto launch = [&](auto kt, auto dk) {
    return launch_head_mix<MODE, decltype(kt)::value, decltype(dk)::value>(
        qkv, out, B, N, H, Dh, scale, true_n, prm, plan, stream);
  };
  using K0 = std::integral_constant<int, 0>;
  using K5 = std::integral_constant<int, 5>;
  using K8 = std::integral_constant<int, RESIDENT_TILES>;
  using D4 = std::integral_constant<int, 4>;
  using D8 = std::integral_constant<int, 8>;
  const int nkt = (N + 15) / 16;
  if (Dh > 64) {
    if (!plan.resident) return launch(K0{}, D8{});
    return nkt <= 5 ? launch(K5{}, D8{}) : launch(K8{}, D8{});
  }
  if (!plan.resident) return launch(K0{}, D4{});
  return nkt <= 5 ? launch(K5{}, D4{}) : launch(K8{}, D4{});
}

// -- the fp32 route -----------------------------------------------------------

namespace hmix {
constexpr int F32_SLAB_TILES = 4;  // the slab's width: the rest of the SM's 256 KB is L1

// The fp32 core's plan: always streamed, a slab of up to F32_SLAB_TILES key
// tiles, no ring (ops/reattention_block.py head_mix_plan(fp32=True) mirrors it).
inline Plan plan_f32(int N, int H) {
  const int nkt = (N + 15) / 16;
  const int ct = nkt < F32_SLAB_TILES ? nkt : F32_SLAB_TILES;
  return Plan{0, ct, 0, size_t(H) * ct * 256 * sizeof(float) + PARAM_BYTES};
}
}  // namespace hmix

// S (16 rows x 16 keys) of head h at key tile `tile`, fp32, in the bf16
// core's fragment order: s[i] is row (lane / 4) + 8 ((i >> 1) & 1), key
// 16 tile + 8 (i >> 2) + 2 (lane % 4) + (i & 1). Each score sums its Dh
// products in order, four at a time. Rows and keys past N read row N - 1:
// their scores are masked or never stored.
__device__ __forceinline__ void score_tile_f32(float (&s)[8], const float* qkv, int row_q0,
                                               int tile, int N, int stride, int HD, int hoff,
                                               int Dh, int lane) {
  const int ra = min(row_q0 + (lane >> 2), N - 1), rb = min(row_q0 + (lane >> 2) + 8, N - 1);
  const int c0 = tile * 16 + 2 * (lane & 3);
  const float* qa = qkv + (size_t)ra * stride + hoff;
  const float* qb = qkv + (size_t)rb * stride + hoff;
  const float* kr[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    kr[u] = qkv + (size_t)min(c0 + (u & 1) + 8 * (u >> 1), N - 1) * stride + HD + hoff;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
  for (int d = 0; d < Dh; d += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(qa + d));
    const float4 b = __ldg(reinterpret_cast<const float4*>(qb + d));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 k = __ldg(reinterpret_cast<const float4*>(kr[u] + d));
      // key u: (u & 1) the +1 column, (u >> 1) the +8 half -> s index 4 (u >> 1) + (u & 1)
      const int ia = 4 * (u >> 1) + (u & 1), ib = ia + 2;
      s[ia] = fmaf(a.x, k.x, s[ia]);
      s[ia] = fmaf(a.y, k.y, s[ia]);
      s[ia] = fmaf(a.z, k.z, s[ia]);
      s[ia] = fmaf(a.w, k.w, s[ia]);
      s[ib] = fmaf(b.x, k.x, s[ib]);
      s[ib] = fmaf(b.y, k.y, s[ib]);
      s[ib] = fmaf(b.z, k.z, s[ib]);
      s[ib] = fmaf(b.w, k.w, s[ib]);
    }
  }
}

// Block (query tile of 16 rows, b), warp h = head h; the streamed passes of
// head_mix_kernel on fp32 qkv rows. NDC: output columns a lane, Dh <= 32 NDC
// (lane owns columns lane + 32 c of all 16 rows).
template <int MODE, int NDC>
__global__ void __launch_bounds__(hmix::MAX_H * 32, 1)
head_mix_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int H, int Dh,
                    float scale, int valid, hmix::Params prm, hmix::Plan plan) {
  using namespace hmix;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ct = plan.ct, plane = ct * 256;
  float* slab = reinterpret_cast<float*>(smem);
  float* mix_a = reinterpret_cast<float*>(smem + size_t(H) * plane * sizeof(float));
  float* mix_b = mix_a + MAX_H * MAX_H;
  float* lns = mix_b + MAX_H * MAX_H;
  float* lnb = lns + MAX_H;
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, q0 = blockIdx.x * 16;
  const int HD = H * Dh, stride = 3 * HD;
  const int nkt = (N + 15) / 16;
  const float* rows = qkv + (size_t)b * N * stride;  // this sample's qkv rows

  for (int e = threadIdx.x; e < H * H; e += blockDim.x) {  // rows MAX_H apart
    mix_a[e / H * MAX_H + e % H] = prm.mix_a[e];
    if (MODE == kTalkingHeads) mix_b[e / H * MAX_H + e % H] = prm.mix_b[e];
  }
  if (MODE == kReattention && threadIdx.x < H) {
    lns[threadIdx.x] = prm.ln_scale[threadIdx.x];
    lnb[threadIdx.x] = prm.ln_bias[threadIdx.x];
  }
  __syncthreads();

  float* own = slab + h * plane;
  const int t4 = lane & 3;
  const auto scores = [&](float (&s)[8], int t) {
    score_tile_f32(s, rows, q0, t, N, stride, HD, h * Dh, Dh, lane);
  };
  const auto scaled = [&](float (&s)[8], int t) { scale_keys(s, t, t4, scale, valid); };
  const auto mix = [&](int pass, int len, int tile0, bool dbg) {
    mix_pass(pass, slab, plane, len, tile0, q0, b, N, H, scale, valid, mix_a, mix_b, lns, lnb,
             prm, dbg);
  };
  // o[r][c] += sum_j P[r][j] V[j][lane + 32 c] over the 16 keys of slab tile j0
  // (key tile `tile`), keys in order; P read from the warp's plane (one
  // broadcast a key and row), V a coalesced row a key. Padded keys carry P = 0.
  // Every lane reads every lane's P, so the warp syncs before the next chunk
  // overwrites its plane.
  float o[16][NDC];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int c = 0; c < NDC; ++c) o[r][c] = 0.f;
  const auto pv = [&](int j0, int tile) {
    const float* pl = own + j0 * 256;
    for (int jj = 0; jj < 16; ++jj) {
      const float* vr = rows + (size_t)min(tile * 16 + jj, N - 1) * stride + 2 * HD + h * Dh;
      float v[NDC];
#pragma unroll
      for (int c = 0; c < NDC; ++c) v[c] = lane + 32 * c < Dh ? __ldg(vr + lane + 32 * c) : 0.f;
      const int half = jj >> 3, lo = (jj & 7) >> 1, odd = jj & 1;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        // (row r, key jj) in fragment order: lane (r & 7) * 4 + lo, value (r >> 3) * 2 + odd
        const float p = pl[(half << 7) | ((((r & 7) << 2) | lo) << 2) | (((r >> 3) << 1) | odd)];
#pragma unroll
        for (int c = 0; c < NDC; ++c) o[r][c] = fmaf(p, v[c], o[r][c]);
      }
    }
    __syncwarp();
  };
  streamed_passes<MODE>(own, lane, nkt, ct, scores, scaled, mix, pv);
  // each head's output rows, fp32, coalesced
  float* dst = out + (size_t)b * N * HD + h * Dh;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (q0 + r >= N) break;
#pragma unroll
    for (int c = 0; c < NDC; ++c)
      if (lane + 32 * c < Dh) dst[(size_t)(q0 + r) * HD + lane + 32 * c] = o[r][c];
  }
}

// The fp32 core on fused [B*N, 3*H*Dh] fp32 qkv rows into fp32 out [B*N,
// H*Dh]: the same domain as head_mix_core.
template <int MODE>
cudaError_t head_mix_core_f32(const float* qkv, float* out, int B, int N, int H, int Dh,
                              float scale, int true_n, const hmix::Params& prm,
                              cudaStream_t stream) {
  using namespace hmix;
  if (N < 1 || N > MAX_N || H < 1 || H > MAX_H || Dh < 16 || Dh % 16 != 0 || Dh > 128 || B < 1 ||
      B > 65535 || true_n < 1 || true_n > N || reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return cudaErrorInvalidValue;
  const Plan plan = plan_f32(N, H);
  const auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.bytes));
    if (e != cudaSuccess) return e;
    const dim3 grid((N + 15) / 16, B);
    kernel<<<grid, H * 32, plan.bytes, stream>>>(qkv, out, N, H, Dh, scale, true_n, prm, plan);
    return cudaGetLastError();
  };
  if (Dh <= 32) return launch(head_mix_f32_kernel<MODE, 1>);
  if (Dh <= 64) return launch(head_mix_f32_kernel<MODE, 2>);
  return launch(head_mix_f32_kernel<MODE, 4>);
}

}  // namespace
}  // namespace vt
