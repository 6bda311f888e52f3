// Online-softmax flash attention with K and V streamed in chunks, for Hopper:
//   out[b, h] = softmax(q[b, h] k[b, h]^T * scale + bias[b|0, h|0], mask_self) v[b, h]
// q [B, H, Nq, D], k [B, H, Nk, D], v [B, H, Nk, Dv] bf16, out [B, H, Nq, Dv]
// bf16, each read or written through its own strides (sections 1-3); or all
// fp32, the TPU kernel's Precision.HIGHEST body (section 4, the fp32 route).
//
// Replaces vit_tpu/ops/flash_attention.py::_kv_blocked_kernel (the Pallas TPU
// kernel, entry flash_attention_kv_blocked). Like the TPU kernel it keeps no
// score row over all keys: each 64-key chunk updates a running row max m, a
// running sum l and an fp32 accumulator, in the TPU kernel's op order
// (flash_attention.py:249-284):
//   s = (q . k) * scale [+ bias], masked to MASK_VALUE (keys past Nk, and the
//   mask_self diagonal); m_new = max(m, rowmax s); alpha = exp(m - m_new);
//   p = exp(s - m_new); l = alpha * l + rowsum p; acc = acc * alpha + pv with
//   pv = bf16(p) v formed apart for the chunk and then added, as the TPU
//   kernel adds its pv; at the end out = acc / l (a true division), rounded
//   once to bf16.
//
// Bound: operations. At T2T's stage 0 (Nq = Nk = 3136, D = 147) a query row
// does 4 * 3136 * 147 = 1.8 MFLOP on 294 B of q and out; at stage 1 (784
// keys, D = 1323) 4.1 MFLOP on 5.3 KB, both far above the H100's ~295
// FLOP/byte ridge. So the products run on the tensor cores (mma.sync
// m16n8k16 from ldmatrix fragments, the PTX of attention_core_sm90.cuh), fed
// by 16-byte cp.async copies into a ring of shared-memory stages, the next
// chunk in flight while this one is multiplied.
//
// Design, one launch of a layout pass and one of the attention:
// 1. The layout pass (pad_rows_kernel). T2T's fused qkv rows are 882 and
//    7938 bytes, only 2-byte aligned, so no 16-byte copy can read them as
//    they stand. The pass lays q, k and v of each (b, h) out in the caller's
//    scratch as contiguous rows zero-padded to a multiple of 16 columns
//    (147 -> 160, 1323 -> 1328). Zero columns add exact zeros to every dot
//    product. It reads each input once, a warp a row.
// 2. Heads up to 160 columns (D and Dv, padded): the register variant
//    (kv_blocked_registers), 8 warps of 16 query rows. A warp's Q fragments,
//    the scores of a 64-key chunk (32 floats a thread), m, l and the 16 x Dv
//    fp32 accumulator (80 registers a thread at Dv 160) stay in registers.
//    m, l and alpha come from quad shuffles; bf16 p goes from the score
//    accumulators straight into the A fragments of P V. acc * alpha is
//    taken first (skipped when no row max of the warp moved: acc * 1 is
//    acc), then pv, formed 32 output columns at a time in 16 registers, is
//    added, so the TPU's order costs no second accumulator. K and V chunks
//    arrive in a two-stage ring, one barrier a chunk. At T2T's widths every
//    offset and trip count is a constant (the FIXED instance).
// 3. Wider heads (T2T's stage 1): the two-phase variant (kv_blocked_wide).
//    Neither Q's fragments nor a 16 x 1328 accumulator fit a warp's
//    registers. A block of 8 warps owns 64 query rows.
//    - Phase 1 sweeps the chunks once. Each chunk's scores are summed over
//      slices of 128 columns of Q and K (cp.async ring, two or three
//      stages); warp w holds rows 16 (w % 4) .. + 16 against keys
//      32 (w / 4) .. + 32 of the chunk, and the two warps of a row range
//      meet in shared memory for the row max and the row sum. Each chunk's
//      bf16 p (64 rows x 64 keys) and alpha are stored, l kept in registers.
//    - Phase 2 walks Dv in passes of 256 columns, warp w owning 32 of them
//      for all 64 rows in registers, and for each pass sweeps the chunks
//      again: acc = acc * alpha_c + (p_c V_c[:, pass]), V slices through the
//      same ring. Q K^T is computed once, in the TPU kernel's order.
//    Up to 1,216 keys p and alpha stay in shared memory (64 rows x 784 keys
//    x 2 B = 100 KB at stage 1; three stages up to 896 keys, two beyond).
//    Past that (T2T's stage 1 at image_size 288 or 384: 1,296 or 2,304
//    keys) they go to the caller's scratch in device memory (the PG
//    instance), and each phase-2 step brings its chunk's p into the ring
//    stage beside the V slice; the arithmetic is the same. plan_for picks
//    the variant; ops/flash_attention.py kv_blocked_layout mirrors it.
// p = exp(s - m) is the hardware's ex2.approx (exp_p); alpha keeps expf.
// A row's arithmetic (its products' k order, the chunk order, the order of
// its sums) does not depend on the batch or on the block plan, so the
// kernel is batch-invariant.
//
// What holds it back (H100, mma.sync): a warp of 16 rows reads every K and
// V fragment from shared memory for 16 rows only, and at 255 registers a
// thread an SM runs 8 warps, too few to hide the softmax's dependency
// chains; wgmma (64-row warpgroups, B read once a warpgroup) is the next
// step.

#include <float.h>
#include <math.h>

#include <algorithm>
#include <type_traits>

#include "attention_core_sm90.cuh"  // load_rows_async, ldsm_x4(_trans), mma_bf16, quad_max/sum
#include "attention_f32.cuh"        // af32::load_rows, af32::score_tile (the fp32 route)
#include "common.cuh"                // cp_async_commit, cp_async_wait

namespace vt {
namespace {

namespace kvb {
using attn90::ldsm_x4;
using attn90::ldsm_x4_trans;
using attn90::load_rows_async;
using attn90::mma_bf16;
using attn90::pack_bf16;
using attn90::quad_max;
using attn90::quad_sum;

constexpr int KC = 64;  // keys per chunk
constexpr int MAX_SMEM = 232448;  // 227 KB, the most one block may use
// flash_attention.py:40: the fill of masked scores.
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
// The register variant: padded D and Dv up to this, W warps a block.
constexpr int REG_MAX = 160;
constexpr int REG_WARPS = 8;
constexpr int REG_JG = 2;  // pv formed REG_JG x 16 columns at a time
// The two-phase variant: 8 warps, 64 query rows, phase-1 slices of 128
// columns of Q and K, phase-2 passes of 256 columns of V.
constexpr int WIDE_WARPS = 8, WIDE_ROWS = 64, WIDE_DS = 128, WIDE_VS = 256;
constexpr int WIDE_LDS = WIDE_DS + 8, WIDE_LDV = WIDE_VS + 8;  // +8 bf16: ldmatrix banks
constexpr int WIDE_LDPC = KC + 8;  // a chunk's p in a ring stage (p in device memory)

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }
__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of the register variant: the Q tile (reused to stage the
// output), then two stages of a K chunk (KC x dp) and a V chunk (KC x dvp).
struct RegLayout {
  int ldq, ldk, ldv;
  size_t q_bytes, v_off, stage_bytes, bytes;
};
constexpr int REG_STAGES = 2;  // ring stages of the register variant
__host__ __device__ inline RegLayout reg_layout(int warps, int dp, int dvp) {
  RegLayout L;
  L.ldq = (dp > dvp ? dp : dvp) + 8;
  L.ldk = dp + 8;
  L.ldv = dvp + 8;
  L.q_bytes = align128(size_t(warps) * 16 * L.ldq * sizeof(bf16));
  L.v_off = align128(size_t(KC) * L.ldk * sizeof(bf16));
  L.stage_bytes = align128(L.v_off + size_t(KC) * L.ldv * sizeof(bf16));
  L.bytes = L.q_bytes + REG_STAGES * L.stage_bytes;
  return L;
}

// Shared memory of the two-phase variant: `stages` ring stages (a Q and a K
// slice; or a V slice, and with p in device memory (pg) the chunk's p after
// it at pst_off), then, with p in shared memory, the bf16 p of every chunk
// (row stride ldp) and alpha of every chunk; l, and the row partials the two
// warps of a row range exchange. With pg, ldp is p's row stride in the
// scratch.
struct WideLayout {
  int ldp;
  size_t pst_off, stage_bytes, p_off, alpha_off, l_off, red_off, bytes;
};
__host__ __device__ inline WideLayout wide_layout(int nc, int stages, bool pg) {
  WideLayout L;
  L.ldp = pg ? nc * KC : nc * KC + 8;
  const size_t qk = size_t(2) * WIDE_ROWS * WIDE_LDS * sizeof(bf16);
  const size_t v_bytes = size_t(KC) * WIDE_LDV * sizeof(bf16);
  L.pst_off = align128(v_bytes);
  const size_t vv = pg ? L.pst_off + size_t(WIDE_ROWS) * WIDE_LDPC * sizeof(bf16) : v_bytes;
  L.stage_bytes = align128(qk > vv ? qk : vv);
  L.p_off = size_t(stages) * L.stage_bytes;
  L.alpha_off = L.p_off + (pg ? 0 : align128(size_t(WIDE_ROWS) * L.ldp * sizeof(bf16)));
  L.l_off = L.alpha_off + (pg ? 0 : align128(size_t(nc) * WIDE_ROWS * sizeof(float)));
  L.red_off = L.l_off + align128(WIDE_ROWS * sizeof(float));
  L.bytes = L.red_off + align128(4 * WIDE_ROWS * sizeof(float));
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

// What the attention kernels read: the padded rows of the layout pass
// ([B*H, N, dp] and [B*H, Nk, dvp], contiguous), the scores' terms, and
// where the output goes.
struct Args {
  const bf16 *q, *k, *v;
  int dp, dvp;
  Operand<bf16> out;
  Problem pr;
  float scale;
  const float* bias;  // [B|1, H|1, Nq, Nk] fp32, or NULL
  int bias_b, bias_h, mask_self;
  int groups;  // blocks a (b, h)
  // The two-phase variant with p in device memory: [blocks][64][nc * KC]
  // bf16 p and [blocks][nc][64] fp32 alpha in the scratch; else NULL.
  bf16* p;
  float* alpha;
};

// The plan of a launch: which variant, warps and query rows a block, ring
// stages, shared memory (ops/flash_attention.py kv_blocked_layout mirrors it).
enum Variant : int { kRegisters = 1, kWide = 2, kWideGlobal = 3 };
struct Plan {
  Variant variant;
  int warps, rows, stages;
  size_t bytes;
};

inline Plan plan_for(int Nk, int D, int Dv) {
  const int dp = round16(D), dvp = round16(Dv), nc = (Nk + KC - 1) / KC;
  if (dp <= REG_MAX && dvp <= REG_MAX)
    return {kRegisters, REG_WARPS, REG_WARPS * 16, 2, reg_layout(REG_WARPS, dp, dvp).bytes};
  for (int stages = 3; stages >= 2; --stages) {
    const size_t bytes = wide_layout(nc, stages, false).bytes;
    if (bytes <= size_t(MAX_SMEM)) return {kWide, WIDE_WARPS, WIDE_ROWS, stages, bytes};
  }
  // p past shared memory (nc >= 20 here: a chunk's p is stored at least
  // STAGES - 1 ring steps before phase 2 fetches it, see kv_blocked_wide)
  return {kWideGlobal, WIDE_WARPS, WIDE_ROWS, 3, wide_layout(nc, 3, true).bytes};
}

// One score of row `row`, key `col`: scale, bias, masks.
__device__ __forceinline__ float score(float acc, int row, int col, const Args& a,
                                       const float* bias_bh) {
  float x = __fmul_rn(acc, a.scale);
  if (bias_bh != nullptr && row < a.pr.Nq && col < a.pr.Nk)
    x = __fadd_rn(x, __ldg(bias_bh + (size_t)row * a.pr.Nk + col));
  if (col >= a.pr.Nk || (a.mask_self && col == row)) x = MASK_VALUE;
  return x;
}

// The scores of T tiles of 16 keys from key0 (the m16n8 layout: s[t][0..1]
// row r0, keys key0 + 16 t + 2 t4 + {0, 1}; [2..3] row r0 + 8; [4..7] the
// same 8 keys on). `plain` (no bias, no mask_self, every key below Nk): the
// scale alone, in a loop of its own.
template <int T>
__device__ __forceinline__ void apply_terms(float (&s)[T][8], int key0, int r0, int t4,
                                            const Args& a, const float* bias_bh, bool plain) {
  if (plain) {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[t][i] = __fmul_rn(s[t][i], a.scale);
    return;
  }
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = key0 + 16 * t + (i >> 2) * 8 + 2 * t4 + (i & 1);
      s[t][i] = score(s[t][i], r0 + ((i >> 1) & 1) * 8, col, a, bias_bh);
    }
}

__device__ __forceinline__ const float* bias_of(const Args& a, int b, int h) {
  if (a.bias == nullptr) return nullptr;
  const int nbh = a.bias_h ? a.pr.H : 1;
  return a.bias + ((size_t)(a.bias_b ? b : 0) * nbh + (a.bias_h ? h : 0)) * (size_t)a.pr.Nq *
                      a.pr.Nk;
}

// p = exp(x) for x = s - m <= 0, by the hardware's ex2.approx of x log2(e)
// (__expf: within 2 + 1.16 |x| fp32 ulps of exp, CUDA's bound; p is then
// rounded to bf16, 2^16 ulps coarser), in 2 instructions where expf takes 8.
// exp(0) stays 1.
__device__ __forceinline__ float exp_p(float x) { return __expf(x); }

// ldmatrix lane offsets (rows, columns) of the fragment kinds: a_off, A of a
// 16 x 16 row-major tile, and (with .trans) B of two 8-column n-tiles from
// 16 V rows; k_off, B of two 8-key n-tiles from K rows.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int k_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
}  // namespace kvb


// -- 1. the layout pass --------------------------------------------------------

struct PadJob {
  kvb::Operand<const bf16> src;  // [B, H, n, d] through its strides, 2-byte aligned rows
  bf16* dst;                     // [B*H, n, dp], contiguous
  int n, d, dp;
};

// The rows of job blockIdx.y into zero-padded contiguous rows, a warp a row:
// lane i reads columns 2i and 2i + 1 of each 64-column step 2 bytes at a
// time (a warp's loads cover 128 contiguous bytes) and writes them as one
// 4-byte store; four steps' loads are issued before their stores, so that
// enough bytes are in flight to keep the copy near the memory's rate.
__global__ void __launch_bounds__(256) pad_rows_kernel(PadJob j0, PadJob j1, PadJob j2, int H,
                                                       int bh) {
  constexpr int STEPS = 4;
  const PadJob j = blockIdx.y == 0 ? j0 : (blockIdx.y == 1 ? j1 : j2);
  const int lane = threadIdx.x % 32, warps = gridDim.x * (blockDim.x / 32);
  const int rows = bh * j.n;
  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; row < rows; row += warps) {
    const int pair = row / j.n, r = row - pair * j.n;
    const unsigned short* __restrict__ s =
        reinterpret_cast<const unsigned short*>(j.src.at(pair / H, pair % H) + r * j.src.sr);
    unsigned* __restrict__ d = reinterpret_cast<unsigned*>(j.dst + (size_t)row * j.dp);
    for (int c0 = 2 * lane; c0 < j.dp; c0 += STEPS * 64) {
      unsigned w[STEPS];
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int c = c0 + 64 * u;
        const unsigned lo = c < j.d ? __ldg(s + c) : 0;
        const unsigned hi = c + 1 < j.d ? __ldg(s + c + 1) : 0;
        w[u] = lo | (hi << 16);
      }
#pragma unroll
      for (int u = 0; u < STEPS; ++u)
        if (c0 + 64 * u < j.dp) d[(c0 + 64 * u) / 2] = w[u];
    }
  }
}

// -- 2. the register variant -----------------------------------------------------

// One block: (b, h) = blockIdx.x / groups, W warps of 16 query rows each.
// DK and DVN bound dp / 16 and dvp / 16 (the registers kept); the loops stop
// at the problem's own widths.
template <int DK, int DVN, bool FIXED>
__global__ void __launch_bounds__(kvb::REG_WARPS * 32) kv_blocked_registers(kvb::Args a) {
  using namespace kvb;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int W = REG_WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / a.groups, b = bh / a.pr.H, h = bh % a.pr.H;
  const int Nq = a.pr.Nq, Nk = a.pr.Nk;
  // FIXED: the padded widths are DK and DVN tiles of 16, so every offset below
  // is a constant and no loop needs a guard.
  const int dp = FIXED ? 16 * DK : a.dp, dvp = FIXED ? 16 * DVN : a.dvp;
  const int dk = dp / 16, dvn = dvp / 16;
  const int row_block = (blockIdx.x % a.groups) * W * 16, row_warp = row_block + warp * 16;
  const bool active = row_warp < Nq;
  const RegLayout L = reg_layout(W, dp, dvp);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* q_warp = Qs + warp * 16 * L.ldq;
  const auto kst = [&](int c) {
    return reinterpret_cast<bf16*>(smem + L.q_bytes + (c % REG_STAGES) * L.stage_bytes);
  };
  const auto vst = [&](int c) { return kst(c) + L.v_off / sizeof(bf16); };
  const bf16* qp = a.q + (size_t)bh * Nq * dp;
  const bf16* kp = a.k + (size_t)bh * Nk * dp;
  const bf16* vp = a.v + (size_t)bh * Nk * dvp;
  const float* bias_bh = bias_of(a, b, h);
  const int nc = (Nk + KC - 1) / KC;
  const auto fetch = [&](int c) {
    if (c < nc) {
      load_rows_async(kst(c), L.ldk, kp, dp, c * KC, KC, Nk, dp);
      load_rows_async(vst(c), L.ldv, vp, dvp, c * KC, KC, Nk, dvp);
    }
    cp_async_commit();
  };

  load_rows_async(Qs, L.ldq, qp, dp, row_block, W * 16, Nq, dp);
#pragma unroll
  for (int c = 0; c < REG_STAGES - 1; ++c) fetch(c);

  constexpr int JG = REG_JG;
  unsigned qf[DK][4];
  float o[2 * DVN][4];
#pragma unroll
  for (int n = 0; n < 2 * DVN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int r0 = row_warp + g, r1 = r0 + 8;

  for (int c = 0; c < nc; ++c) {
    cp_async_wait<REG_STAGES - 2>();  // chunk c has landed
    __syncthreads();  // for every thread; and every warp is done with chunk c - 1
    fetch(c + REG_STAGES - 1);  // into the stage of chunk c - 1
    if (active) {
      if (c == 0) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          if (FIXED || kk < dk) ldsm_x4(qf[kk], q_warp + a_off(lane, L.ldq) + kk * 16);
      }
      // S = Q K^T of the chunk: s[u] covers keys 16u .. 16u + 15 (the m16n8
      // layout of score_chunk: [0..1] row r0, [2..3] row r1, [4..7] keys + 8).
      float s[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) s[u][i] = 0.f;
      const bf16* kb = kst(c) + k_off(lane, L.ldk);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (FIXED || kk < dk) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            unsigned bk[4];
            ldsm_x4(bk, kb + u * 16 * L.ldk + kk * 16);
            mma_bf16(s[u], qf[kk], bk[0], bk[1]);
            mma_bf16(s[u] + 4, qf[kk], bk[2], bk[3]);
          }
        }
      }
      // The chunk's online softmax, rows r0 and r1, in the TPU kernel's order.
      apply_terms(s, c * KC, r0, t4, a, bias_bh,
                  bias_bh == nullptr && !a.mask_self && (c + 1) * KC <= Nk);
      float mc0 = -INFINITY, mc1 = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((i >> 1) & 1) mc1 = fmaxf(mc1, s[u][i]);
          else mc0 = fmaxf(mc0, s[u][i]);
        }
      const float mn0 = fmaxf(m0, quad_max(mc0)), mn1 = fmaxf(m1, quad_max(mc1));
      const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);  // 0 at chunk 0
      float ps0 = 0.f, ps1 = 0.f;
      unsigned pa[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool hi = (i >> 1) & 1;
          s[u][i] = exp_p(s[u][i] - (hi ? mn1 : mn0));
          if (hi) ps1 += s[u][i];
          else ps0 += s[u][i];
        }
        // A fragment of P V for keys 16u ..: a0 row r0 keys 2t4.., a1 row r1,
        // a2 row r0 keys 8 + 2t4.., a3 row r1.
        pa[u][0] = pack_bf16(s[u][0], s[u][1]);
        pa[u][1] = pack_bf16(s[u][2], s[u][3]);
        pa[u][2] = pack_bf16(s[u][4], s[u][5]);
        pa[u][3] = pack_bf16(s[u][6], s[u][7]);
      }
      l0 = __fadd_rn(__fmul_rn(alpha0, l0), quad_sum(ps0));
      l1 = __fadd_rn(__fmul_rn(alpha1, l1), quad_sum(ps1));
      m0 = mn0;
      m1 = mn1;
      // acc = acc * alpha + pv: acc * alpha first (skipped where no row max
      // of the warp moved: acc * 1 is acc), then pv, formed JG x 16 columns
      // at a time, added.
      if (!__all_sync(0xffffffffu, alpha0 == 1.f && alpha1 == 1.f)) {
#pragma unroll
        for (int n = 0; n < 2 * DVN; ++n) {
          if (FIXED || n < 2 * dvn) {
            o[n][0] = __fmul_rn(o[n][0], alpha0);
            o[n][1] = __fmul_rn(o[n][1], alpha0);
            o[n][2] = __fmul_rn(o[n][2], alpha1);
            o[n][3] = __fmul_rn(o[n][3], alpha1);
          }
        }
      }
      const bf16* vb = vst(c) + a_off(lane, L.ldv);
#pragma unroll
      for (int j0 = 0; j0 < DVN; j0 += JG) {
        if (FIXED || j0 < dvn) {
          float pv[2 * JG][4];
#pragma unroll
          for (int n = 0; n < 2 * JG; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int jj = 0; jj < JG; ++jj)
              if (j0 + jj < DVN && (FIXED || j0 + jj < dvn)) {
                unsigned bv[4];
                ldsm_x4_trans(bv, vb + u * 16 * L.ldv + (j0 + jj) * 16);
                mma_bf16(pv[2 * jj], pa[u], bv[0], bv[1]);
                mma_bf16(pv[2 * jj + 1], pa[u], bv[2], bv[3]);
              }
#pragma unroll
          for (int n = 0; n < 2 * JG; ++n) {
            if (j0 * 2 + n < 2 * DVN) {
              float* acc = o[j0 * 2 + n];
              acc[0] = __fadd_rn(acc[0], pv[n][0]);
              acc[1] = __fadd_rn(acc[1], pv[n][1]);
              acc[2] = __fadd_rn(acc[2], pv[n][2]);
              acc[3] = __fadd_rn(acc[3], pv[n][3]);
            }
          }
        }
      }
    }
  }
  if (!active) return;
  // out = acc / l, staged as bf16 in the warp's rows of the Q tile, then
  // written a row at a time, 2 bytes a lane (the output rows need only be
  // 2-byte aligned).
#pragma unroll
  for (int n = 0; n < 2 * DVN; ++n) {
    if (FIXED || n < 2 * dvn) {
      bf16* p = q_warp + g * L.ldq + n * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(p) = pack_bf16(__fdiv_rn(o[n][0], l0), __fdiv_rn(o[n][1], l0));
      *reinterpret_cast<unsigned*>(p + 8 * L.ldq) =
          pack_bf16(__fdiv_rn(o[n][2], l1), __fdiv_rn(o[n][3], l1));
    }
  }
  __syncwarp();
  bf16* op = a.out.at(b, h);
  for (int r = 0; r < 16 && row_warp + r < Nq; ++r)
    for (int col = lane; col < a.pr.Dv; col += 32)
      op[(row_warp + r) * a.out.sr + col] = q_warp[r * L.ldq + col];
}

// -- 3. the two-phase variant ----------------------------------------------------

// One block: (b, h) = blockIdx.x / groups, 64 query rows, 8 warps. Ring step
// st < nc * s1 is phase 1's chunk st / s1, column slice st % s1 (a Q and a K
// slice); the steps after it are phase 2's pass t / nc, chunk t % nc (a V
// slice, and with PG the chunk's p), t = st - nc * s1.
// PG: p and alpha in device memory (a.p, a.alpha). Phase 2's step t fetches
// chunk c's p at ring step nc * s1 + t - (STAGES - 1), after the barrier of
// a step later than the one that stored it, as long as nc >= STAGES
// (plan_for takes PG only from 20 chunks).
template <int STAGES, bool PG>
__global__ void __launch_bounds__(kvb::WIDE_WARPS * 32, 1) kv_blocked_wide(kvb::Args a) {
  using namespace kvb;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int rt = warp & 3, kh = warp >> 2;  // phase 1: row tile, key half of the chunk
  const int bh = blockIdx.x / a.groups, b = bh / a.pr.H, h = bh % a.pr.H;
  const int Nq = a.pr.Nq, Nk = a.pr.Nk, dp = a.dp, dvp = a.dvp;
  const int row_block = (blockIdx.x % a.groups) * WIDE_ROWS;
  const int nc = (Nk + KC - 1) / KC;
  const WideLayout L = wide_layout(nc, STAGES, PG);
  const auto stage = [&](int st) {
    return reinterpret_cast<bf16*>(smem + (st % STAGES) * L.stage_bytes);
  };
  const size_t blk = blockIdx.x;
  // [64][ldp] bf16 p of every chunk, [nc][64] alpha
  bf16* P = PG ? a.p + blk * WIDE_ROWS * L.ldp : reinterpret_cast<bf16*>(smem + L.p_off);
  float* Alpha = PG ? a.alpha + blk * nc * WIDE_ROWS : reinterpret_cast<float*>(smem + L.alpha_off);
  float* Lrow = reinterpret_cast<float*>(smem + L.l_off);       // [64] the final l
  float* Red = reinterpret_cast<float*>(smem + L.red_off);      // [2][64] half-chunk maxima
  float* Sum = Red + 2 * WIDE_ROWS;                             // [2][64] half-chunk sums
  const bf16* qp = a.q + (size_t)bh * Nq * dp;
  const bf16* kp = a.k + (size_t)bh * Nk * dp;
  const bf16* vp = a.v + (size_t)bh * Nk * dvp;
  const float* bias_bh = bias_of(a, b, h);
  const int s1 = (dp + WIDE_DS - 1) / WIDE_DS, passes = (dvp + WIDE_VS - 1) / WIDE_VS;
  const int steps1 = nc * s1, steps = steps1 + passes * nc;
  const auto fetch = [&](int st) {
    if (st < steps1) {
      const int c = st / s1, col0 = (st % s1) * WIDE_DS, cols = min(WIDE_DS, dp - col0);
      bf16* d = stage(st);
      // (whole slices with a constant width: the copy's index math folds)
      if (cols == WIDE_DS) {
        load_rows_async(d, WIDE_LDS, qp + col0, dp, row_block, WIDE_ROWS, Nq, WIDE_DS);
        load_rows_async(d + WIDE_ROWS * WIDE_LDS, WIDE_LDS, kp + col0, dp, c * KC, KC, Nk, WIDE_DS);
      } else {
        load_rows_async(d, WIDE_LDS, qp + col0, dp, row_block, WIDE_ROWS, Nq, cols);
        load_rows_async(d + WIDE_ROWS * WIDE_LDS, WIDE_LDS, kp + col0, dp, c * KC, KC, Nk, cols);
      }
    } else if (st < steps) {
      const int t = st - steps1, col0 = (t / nc) * WIDE_VS, cols = min(WIDE_VS, dvp - col0);
      if (PG)
        load_rows_async(stage(st) + L.pst_off / sizeof(bf16), WIDE_LDPC, P + (t % nc) * KC, L.ldp,
                        0, WIDE_ROWS, WIDE_ROWS, KC);
      if (cols == WIDE_VS)
        load_rows_async(stage(st), WIDE_LDV, vp + col0, dvp, (t % nc) * KC, KC, Nk, WIDE_VS);
      else
        load_rows_async(stage(st), WIDE_LDV, vp + col0, dvp, (t % nc) * KC, KC, Nk, cols);
    }
    cp_async_commit();
  };

  // phase 1 state: this warp's 16 rows x 32 keys of the chunk, and m, l of
  // its rows (the two warps of a row range hold the same m and l)
  const int lr0 = rt * 16 + g, lr1 = lr0 + 8;
  const int r0 = row_block + lr0, r1 = row_block + lr1;
  float sacc[2][8];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // phase 2 state: rows 0-63 x this warp's 32 columns of the pass
  float acc[4][4][4];

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) fetch(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();  // step st has landed
    __syncthreads();  // for every thread; and every warp is done with step st - 1
    fetch(st + STAGES - 1);  // into the stage of step st - 1
    if (st < steps1) {
      const int c = st / s1, sl = st % s1;
      if (sl == 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 8; ++i) sacc[u][i] = 0.f;
      }
      const bf16* qs = stage(st) + rt * 16 * WIDE_LDS + a_off(lane, WIDE_LDS);
      const bf16* ks = stage(st) + (WIDE_ROWS + kh * 32) * WIDE_LDS + k_off(lane, WIDE_LDS);
      const int ksteps = min(WIDE_DS, dp - sl * WIDE_DS) / 16;
      const auto slice = [&](auto whole) {  // whole: a full slice, no guard
#pragma unroll
        for (int kk = 0; kk < WIDE_DS / 16; ++kk) {
          if (decltype(whole)::value || kk < ksteps) {
            unsigned qa[4];
            ldsm_x4(qa, qs + kk * 16);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              unsigned bk[4];
              ldsm_x4(bk, ks + u * 16 * WIDE_LDS + kk * 16);
              mma_bf16(sacc[u], qa, bk[0], bk[1]);
              mma_bf16(sacc[u] + 4, qa, bk[2], bk[3]);
            }
          }
        }
      };
      if (ksteps == WIDE_DS / 16) slice(std::true_type{});
      else slice(std::false_type{});
      if (sl == s1 - 1) {
        // The chunk's scores are whole: its online softmax, the two key
        // halves of a row range meeting in shared memory.
        apply_terms(sacc, c * KC + kh * 32, r0, t4, a, bias_bh,
                    bias_bh == nullptr && !a.mask_self && (c + 1) * KC <= Nk);
        float mc0 = -INFINITY, mc1 = -INFINITY;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if ((i >> 1) & 1) mc1 = fmaxf(mc1, sacc[u][i]);
            else mc0 = fmaxf(mc0, sacc[u][i]);
          }
        mc0 = quad_max(mc0);
        mc1 = quad_max(mc1);
        if (t4 == 0) {
          Red[kh * WIDE_ROWS + lr0] = mc0;
          Red[kh * WIDE_ROWS + lr1] = mc1;
        }
        __syncthreads();
        const float mn0 = fmaxf(m0, fmaxf(Red[lr0], Red[WIDE_ROWS + lr0]));
        const float mn1 = fmaxf(m1, fmaxf(Red[lr1], Red[WIDE_ROWS + lr1]));
        const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);  // 0 at chunk 0
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool hi = (i >> 1) & 1;
            sacc[u][i] = exp_p(sacc[u][i] - (hi ? mn1 : mn0));
            if (hi) ps1 += sacc[u][i];
            else ps0 += sacc[u][i];
          }
          bf16* pr = P + c * KC + kh * 32 + 16 * u + 2 * t4;
          *reinterpret_cast<unsigned*>(pr + lr0 * L.ldp) = pack_bf16(sacc[u][0], sacc[u][1]);
          *reinterpret_cast<unsigned*>(pr + lr1 * L.ldp) = pack_bf16(sacc[u][2], sacc[u][3]);
          *reinterpret_cast<unsigned*>(pr + lr0 * L.ldp + 8) = pack_bf16(sacc[u][4], sacc[u][5]);
          *reinterpret_cast<unsigned*>(pr + lr1 * L.ldp + 8) = pack_bf16(sacc[u][6], sacc[u][7]);
        }
        ps0 = quad_sum(ps0);
        ps1 = quad_sum(ps1);
        if (t4 == 0) {
          Sum[kh * WIDE_ROWS + lr0] = ps0;
          Sum[kh * WIDE_ROWS + lr1] = ps1;
        }
        __syncthreads();
        l0 = __fadd_rn(__fmul_rn(alpha0, l0), __fadd_rn(Sum[lr0], Sum[WIDE_ROWS + lr0]));
        l1 = __fadd_rn(__fmul_rn(alpha1, l1), __fadd_rn(Sum[lr1], Sum[WIDE_ROWS + lr1]));
        m0 = mn0;
        m1 = mn1;
        if (kh == 0 && t4 == 0) {
          Alpha[c * WIDE_ROWS + lr0] = alpha0;
          Alpha[c * WIDE_ROWS + lr1] = alpha1;
          if (c == nc - 1) {
            Lrow[lr0] = l0;
            Lrow[lr1] = l1;
          }
        }
      }
    } else {
      const int t = st - steps1, c = t % nc;
      const int col0 = (t / nc) * WIDE_VS + warp * 32;                   // padded column
      const int ng = col0 < dvp ? min(2, (dvp - col0) / 16) : 0;         // 16-column groups
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[r][n][0] = acc[r][n][1] = acc[r][n][2] = acc[r][n][3] = 0.f;
      }
      const auto pass = [&](auto whole) {  // whole: both 16-column groups, no guard
        const auto live = [&](int gg) { return decltype(whole)::value || gg < ng; };
        unsigned vf[4][2][4];
        const bf16* vs = stage(st) + a_off(lane, WIDE_LDV) + warp * 32;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int gg = 0; gg < 2; ++gg)
            if (live(gg)) ldsm_x4_trans(vf[kk][gg], vs + kk * 16 * WIDE_LDV + gg * 16);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float al0 = Alpha[c * WIDE_ROWS + r * 16 + g];
          const float al1 = Alpha[c * WIDE_ROWS + r * 16 + g + 8];
          float pv[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
          const bf16* ps = PG ? stage(st) + L.pst_off / sizeof(bf16) + r * 16 * WIDE_LDPC +
                                    a_off(lane, WIDE_LDPC)
                              : P + r * 16 * L.ldp + c * KC + a_off(lane, L.ldp);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            unsigned pa[4];
            ldsm_x4(pa, ps + kk * 16);
#pragma unroll
            for (int gg = 0; gg < 2; ++gg) {
              if (live(gg)) {
                mma_bf16(pv[2 * gg], pa, vf[kk][gg][0], vf[kk][gg][1]);
                mma_bf16(pv[2 * gg + 1], pa, vf[kk][gg][2], vf[kk][gg][3]);
              }
            }
          }
          // acc = acc * alpha + pv, as the TPU kernel adds its pv (acc * 1
          // skipped where no row max of the tile moved)
          if (!__all_sync(0xffffffffu, al0 == 1.f && al1 == 1.f)) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              float* o = acc[r][n];
              o[0] = __fmul_rn(o[0], al0);
              o[1] = __fmul_rn(o[1], al0);
              o[2] = __fmul_rn(o[2], al1);
              o[3] = __fmul_rn(o[3], al1);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float* o = acc[r][n];
            o[0] = __fadd_rn(o[0], pv[n][0]);
            o[1] = __fadd_rn(o[1], pv[n][1]);
            o[2] = __fadd_rn(o[2], pv[n][2]);
            o[3] = __fadd_rn(o[3], pv[n][3]);
          }
        }
      };
      if (ng > 0) {
        if (ng == 2) pass(std::true_type{});
        else pass(std::false_type{});
        if (c == nc - 1) {
          // out = acc / l for this pass's columns, 2 bytes at a time (the
          // output rows need only be 2-byte aligned)
          bf16* op = a.out.at(b, h);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int lr = r * 16 + g + 8 * hh, row = row_block + lr;
              if (row >= Nq) continue;
              const float l = Lrow[lr];
              bf16* orow = op + row * a.out.sr;
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                const int col = col0 + n * 8 + 2 * t4;
                if (n / 2 < ng && col < a.pr.Dv)
                  orow[col] = __float2bfloat16(__fdiv_rn(acc[r][n][2 * hh], l));
                if (n / 2 < ng && col + 1 < a.pr.Dv)
                  orow[col + 1] = __float2bfloat16(__fdiv_rn(acc[r][n][2 * hh + 1], l));
              }
            }
          }
        }
      }
    }
  }
}

// -- 4. the fp32 route -------------------------------------------------------------
//
// fp32 q, k and v, which the TPU kernel runs at Precision.HIGHEST
// (flash_attention.py:242-246, :272-274): both products in full fp32, p never
// rounded (its astype to v's dtype is a no-op). The same online softmax over
// 64-key chunks, every step in fp32:
//   s = __fmul_rn(q . k, scale) [__fadd_rn bias], keys past Nk left out (p =
//   0), the mask_self diagonal at MASK_VALUE; m_new = max(m, rowmax s);
//   alpha = expf(m - m_new); p = expf(s - m_new); l = alpha * l + rowsum p;
//   acc = acc * alpha + p v (pv formed apart for the chunk, then added); at
//   the end out = acc / l (a true division), fp32.
// Every product is an fp32 fused multiply-add on the CUDA cores, as in the
// fp32 core (attention_f32.cuh): no TF32, no bf16 operand.
//
// Design (simple first; no tensor cores, no cp.async ring): a block of 256
// threads owns 32 query rows of one (b, h). Nothing is laid out first: the
// loads (af32::load_rows, shared with the fp32 core) read q, k and v in
// place through their strides, 16 bytes at a time where an operand's base,
// strides and width are multiples of 4 floats (IWSA's fused-row views, SSA's
// rows), else 4 bytes at a time, a warp a row
// (T2T's fused rows are 588 and 5,292 bytes a head: no 16-byte load can read
// them, and padding them into a scratch first, as the bf16 route does, would
// cost a launch and a copy of q, k and v for loads that are coalesced
// either way and reused by all 32 rows of the block).
//   1. For each chunk, Q K^T summed over column slices of SLICE (160) floats
//      of Q and K in shared memory (Q loaded once where it is one slice):
//      the fp32 core's score tile (af32::score_tile: thread (ty, tx) owns
//      rows ty, ty + 16 and keys tx + 16 j), summed over the slices in order.
//   2. The chunk's online softmax, a warp for 4 rows, two keys a lane; p and
//      alpha go to shared memory (one pass) or to the caller's scratch in
//      device memory (two phases).
//   3. One pass (Dv padded to 4 up to SLICE): the V chunk in shared memory,
//      acc = acc * alpha + p V in registers, G = Dv / 4 float4 columns a
//      row, thread t owning columns 4 (t % G) of rows t / G + u (256 / G).
//      Two phases (wider Dv, T2T's stage 1): after the sweep, Dv in passes
//      of SLICE columns, each sweeping the chunks again with their p and
//      alpha brought back from the scratch. Q K^T is computed once.
// Rows past Nq read zeros and are not stored. A row's arithmetic depends on
// nothing but its own (b, h), so the route is batch-invariant.
namespace kvf {
constexpr int QT = 32;       // query rows a block
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int SLICE = 160;   // columns of a Q / K slice, and of a V pass
constexpr int MAX_U = 6;     // rows a thread accumulates: QT / (THREADS / (SLICE / 4)), rounded up
constexpr int LDS = kvb::KC + 4;  // row stride of the chunk's scores and p
enum Variant : int { kOnePass = 4, kTwoPhase = 5 };

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
// Row stride (floats) of a tile `w4` columns wide: a multiple of 4 that is
// odd in float4s, so that 8 rows' float4 reads hit 8 distinct bank groups.
__host__ __device__ inline int tile_ld(int w4) { return w4 + 4 + 4 * ((w4 / 4) & 1); }

struct Layout {
  int ldqk, ldv;
  size_t kv_off, s_off, alpha_off, l_off, bytes;
};
// Shared memory: the Q slice [QT][ldqk], one K slice or V pass of a chunk
// [KC][max(ldqk, ldv)], the chunk's scores / p [QT][LDS], alpha [QT], l [QT]
// (ops/flash_attention.py kv_blocked_layout(fp32=True) mirrors it).
__host__ __device__ inline Layout layout(int D, int Dv) {
  Layout L;
  const int d4 = round4(D), dv4 = round4(Dv);
  L.ldqk = tile_ld(d4 < SLICE ? d4 : SLICE);
  L.ldv = tile_ld(dv4 < SLICE ? dv4 : SLICE);
  const int ldkv = L.ldqk > L.ldv ? L.ldqk : L.ldv;
  L.kv_off = kvb::align128(size_t(QT) * L.ldqk * sizeof(float));
  L.s_off = L.kv_off + kvb::align128(size_t(kvb::KC) * ldkv * sizeof(float));
  L.alpha_off = L.s_off + kvb::align128(size_t(QT) * LDS * sizeof(float));
  L.l_off = L.alpha_off + kvb::align128(QT * sizeof(float));
  L.bytes = L.l_off + kvb::align128(QT * sizeof(float));
  return L;
}

struct Plan {
  Variant variant;
  size_t bytes;
};
inline Plan plan_for(int D, int Dv) {
  return {round4(Dv) <= SLICE ? kOnePass : kTwoPhase, layout(D, Dv).bytes};
}

struct Args {
  kvb::Operand<const float> q, k, v;
  kvb::Operand<float> out;
  kvb::Problem pr;
  float scale;
  const float* bias;  // [B|1, H|1, Nq, Nk], or NULL
  int bias_b, bias_h, mask_self;
  int groups;               // query tiles a (b, h)
  int vec_q, vec_k, vec_v;  // 16-byte loads
  // Two phases: [blocks][QT][nc * KC] p and [blocks][nc][QT] alpha; else NULL.
  float* p;
  float* alpha;
};

// acc[u] = acc[u] * alpha + p V for the rows of thread t: the columns 4 g
// (g = t % G) of rows t / G + u (THREADS / G), G float4 columns in the pass.
__device__ __forceinline__ void pv_chunk(float4 (&acc)[MAX_U], const float* Ss, const float* Vs,
                                         int ldv, const float* As, int G) {
  const int t = threadIdx.x, rs = THREADS / G, g = t % G, r0 = t / G;
  if (r0 >= rs) return;
  float4 pv[MAX_U];
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) pv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* vc = Vs + 4 * g;
  for (int j = 0; j < kvb::KC; j += 4) {
    float4 vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vv[i] = *reinterpret_cast<const float4*>(vc + (j + i) * ldv);
#pragma unroll
    for (int u = 0; u < MAX_U; ++u) {
      const int r = r0 + u * rs;
      if (r < QT) {
        const float4 p = *reinterpret_cast<const float4*>(Ss + r * LDS + j);
        const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[u].x = fmaf(pj[i], vv[i].x, pv[u].x);
          pv[u].y = fmaf(pj[i], vv[i].y, pv[u].y);
          pv[u].z = fmaf(pj[i], vv[i].z, pv[u].z);
          pv[u].w = fmaf(pj[i], vv[i].w, pv[u].w);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) {
    const int r = r0 + u * rs;
    if (r < QT) {
      const float al = As[r];
      acc[u].x = __fadd_rn(__fmul_rn(acc[u].x, al), pv[u].x);
      acc[u].y = __fadd_rn(__fmul_rn(acc[u].y, al), pv[u].y);
      acc[u].z = __fadd_rn(__fmul_rn(acc[u].z, al), pv[u].z);
      acc[u].w = __fadd_rn(__fmul_rn(acc[u].w, al), pv[u].w);
    }
  }
}

// out = acc / l for columns col0 + 4 g .. of the thread's rows (pv_chunk's
// mapping), 4 bytes at a time (the output rows need not be 16-byte aligned).
__device__ __forceinline__ void store_rows(const float4 (&acc)[MAX_U], const float* Ls,
                                           const Args& a, int b, int h, int q0, int col0, int G) {
  const int t = threadIdx.x, rs = THREADS / G, g = t % G, r0 = t / G;
  if (r0 >= rs) return;
  float* op = a.out.at(b, h);
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) {
    const int r = r0 + u * rs, qr = q0 + r, c = col0 + 4 * g;
    if (r >= QT || qr >= a.pr.Nq) continue;
    const float l = Ls[r];
    const float o[4] = {__fdiv_rn(acc[u].x, l), __fdiv_rn(acc[u].y, l), __fdiv_rn(acc[u].z, l),
                        __fdiv_rn(acc[u].w, l)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < a.pr.Dv) op[qr * a.out.sr + c + i] = o[i];
  }
}
}  // namespace kvf

template <bool ONE_PASS>
__global__ void __launch_bounds__(kvf::THREADS) kv_blocked_f32(kvf::Args a) {
  using namespace kvf;
  using af32::load_rows;
  using af32::score_tile;
  using kvb::KC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.pr.D, Dv = a.pr.Dv, Nq = a.pr.Nq, Nk = a.pr.Nk;
  const Layout L = layout(D, Dv);
  float* Qs = reinterpret_cast<float*>(smem);
  float* KVs = reinterpret_cast<float*>(smem + L.kv_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  float* As = reinterpret_cast<float*>(smem + L.alpha_off);
  float* Ls = reinterpret_cast<float*>(smem + L.l_off);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int bh = blockIdx.x / a.groups, b = bh / a.pr.H, h = bh % a.pr.H;
  const int q0 = (blockIdx.x % a.groups) * QT;
  const int nc = (Nk + KC - 1) / KC, d4 = round4(D), dv4 = round4(Dv);
  const int slices = (d4 + SLICE - 1) / SLICE;
  const float* qp = a.q.at(b, h);
  const float* kp = a.k.at(b, h);
  const float* vp = a.v.at(b, h);
  const float* bias_bh = nullptr;
  if (a.bias != nullptr) {
    const int nbh = a.bias_h ? a.pr.H : 1;
    bias_bh = a.bias + ((size_t)(a.bias_b ? b : 0) * nbh + (a.bias_h ? h : 0)) * (size_t)Nq * Nk;
  }
  float* Pg = ONE_PASS ? nullptr : a.p + (size_t)blockIdx.x * QT * nc * KC;
  float* Ag = ONE_PASS ? nullptr : a.alpha + (size_t)blockIdx.x * nc * QT;
  // the softmax state of rows warp + 8 i, the same in every lane
  float m[QT / WARPS], l[QT / WARPS];
#pragma unroll
  for (int i = 0; i < QT / WARPS; ++i) m[i] = -INFINITY, l[i] = 0.f;
  const int G1 = dv4 / 4;  // one pass: float4 columns of V
  float4 acc[MAX_U];
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int tx = t % 16, ty = t / 16;
  for (int c = 0; c < nc; ++c) {
    // 1. the chunk's scores, summed over the column slices
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sl = 0; sl < slices; ++sl) {
      const int col0 = sl * SLICE, cols4 = min(SLICE, d4 - col0);
      __syncthreads();  // the last readers of Qs, KVs and Ss are done
      if (slices > 1 || c == 0)
        load_rows(Qs, L.ldqk, qp, a.q.sr, q0, QT, Nq, col0, cols4, D, a.vec_q);
      load_rows(KVs, L.ldqk, kp, a.k.sr, c * KC, KC, Nk, col0, cols4, D, a.vec_k);
      __syncthreads();
      score_tile(s0, s1, Qs, L.ldqk, KVs, L.ldqk, cols4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Ss[ty * LDS + tx + 16 * j] = s0[j];
      Ss[(ty + 16) * LDS + tx + 16 * j] = s1[j];
    }
    __syncthreads();
    // 2. the chunk's online softmax: warp w, rows w + 8 i, keys lane, lane + 32
#pragma unroll
    for (int i = 0; i < QT / WARPS; ++i) {
      const int r = warp + WARPS * i, qr = q0 + r;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * KC + lane + 32 * e;
        float v = __fmul_rn(Ss[r * LDS + lane + 32 * e], a.scale);
        if (bias_bh != nullptr && qr < Nq && col < Nk)
          v = __fadd_rn(v, __ldg(bias_bh + (size_t)qr * Nk + col));
        if (a.mask_self && col == qr) v = kvb::MASK_VALUE;
        x[e] = col < Nk ? v : -INFINITY;  // a chunk always holds a key below Nk
      }
      const float mn = fmaxf(m[i], warp_max(fmaxf(x[0], x[1])));
      const float al = expf(m[i] - mn);  // 0 at chunk 0
      const float p0 = expf(x[0] - mn), p1 = expf(x[1] - mn);  // 0 past Nk
      l[i] = __fadd_rn(__fmul_rn(al, l[i]), warp_sum(__fadd_rn(p0, p1)));
      m[i] = mn;
      if (ONE_PASS) {
        Ss[r * LDS + lane] = p0;
        Ss[r * LDS + lane + 32] = p1;
        if (lane == 0) As[r] = al;
      } else {
        Pg[(size_t)r * nc * KC + c * KC + lane] = p0;
        Pg[(size_t)r * nc * KC + c * KC + lane + 32] = p1;
        if (lane == 0) Ag[c * QT + r] = al;
      }
    }
    if (ONE_PASS) {
      // 3. acc = acc * alpha + p V over the chunk's V rows
      __syncthreads();  // p and alpha are in; every warp is done with the K slice
      load_rows(KVs, L.ldv, vp, a.v.sr, c * KC, KC, Nk, 0, dv4, Dv, a.vec_v);
      __syncthreads();
      pv_chunk(acc, Ss, KVs, L.ldv, As, G1);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < QT / WARPS; ++i) Ls[warp + WARPS * i] = l[i];
  }
  if (ONE_PASS) {
    __syncthreads();
    store_rows(acc, Ls, a, b, h, q0, 0, G1);
    return;
  }
  // The second phase: Dv in passes of SLICE columns, each sweeping the chunks
  // with their p and alpha from the scratch (written by this block above:
  // plain loads, not the read-only path).
  for (int col0 = 0; col0 < dv4; col0 += SLICE) {
    const int cols4 = min(SLICE, dv4 - col0), G = cols4 / 4;
#pragma unroll
    for (int u = 0; u < MAX_U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // the last chunk's readers are done (and the scratch writes seen)
      load_rows(KVs, L.ldv, vp, a.v.sr, c * KC, KC, Nk, col0, cols4, Dv, a.vec_v);
      for (int i = t; i < QT * KC / 4; i += THREADS) {
        const int r = i / (KC / 4), c4 = i % (KC / 4);
        *reinterpret_cast<float4*>(Ss + r * LDS + 4 * c4) =
            *reinterpret_cast<const float4*>(Pg + (size_t)r * nc * KC + c * KC + 4 * c4);
      }
      if (t < QT) As[t] = Ag[c * QT + t];
      __syncthreads();
      pv_chunk(acc, Ss, KVs, L.ldv, As, G);
    }
    store_rows(acc, Ls, a, b, h, q0, col0, G);
  }
}

// -- launch ------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_attention(Kernel kernel, const kvb::Plan& plan, const kvb::Args& a,
                             long long blocks, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.bytes));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), plan.warps * 32, plan.bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vt

// The plan a shape gets (ops/flash_attention.py kv_blocked_layout mirrors
// it): out = {variant (1 registers, 2 two-phase, 3 two-phase with p in
// device memory), warps a block, query rows a block, ring stages,
// shared-memory bytes}.
extern "C" void vt_kv_blocked_plan(int Nk, int D, int Dv, int* out) {
  const vt::kvb::Plan p = vt::kvb::plan_for(Nk, D, Dv);
  out[0] = p.variant;
  out[1] = p.warps;
  out[2] = p.rows;
  out[3] = p.stages;
  out[4] = static_cast<int>(p.bytes);
}

// q, k, v, out through their (batch, head, row) strides in elements, unit
// column stride, 2-byte aligned. scratch: B*H*(Nq*dp + Nk*dp + Nk*dvp) bf16,
// 16-byte aligned, dp and dvp D and Dv rounded up to 16; under plan variant
// 3 followed by blocks*64*nc*64 bf16 of p and blocks*nc*64 fp32 of alpha
// (blocks = B*H*ceil(Nq/64), nc = ceil(Nk/64)). Launches the layout pass and
// then the attention of the shape's plan.
extern "C" int vt_flash_attention_kv_blocked(
    const void* q, long long q_sb, long long q_sh, long long q_sr, const void* k, long long k_sb,
    long long k_sh, long long k_sr, const void* v, long long v_sb, long long v_sh, long long v_sr,
    void* out, long long o_sb, long long o_sh, long long o_sr, int B, int H, int Nq, int Nk, int D,
    int Dv, float scale, const void* bias, int bias_b, int bias_h, int mask_self, void* scratch,
    void* stream) {
  using vt::bf16;
  using namespace vt::kvb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || D < 1 || Dv < 1 || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_for(Nk, D, Dv);
  const long long bh = (long long)B * H;
  const long long groups = (Nq + plan.rows - 1) / plan.rows;
  if (bh * groups > 0x7fffffffLL || bh * (Nq > Nk ? Nq : Nk) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = round16(D), dvp = round16(Dv);
  bf16* qs = static_cast<bf16*>(scratch);
  bf16* ks = qs + bh * Nq * dp;
  bf16* vs = ks + bh * Nk * dp;
  const auto in = [](const void* p, long long sb, long long sh, long long sr) {
    return Operand<const bf16>{static_cast<const bf16*>(p), sb, sh, sr};
  };
  const vt::PadJob jq{in(q, q_sb, q_sh, q_sr), qs, Nq, D, dp};
  const vt::PadJob jk{in(k, k_sb, k_sh, k_sr), ks, Nk, D, dp};
  const vt::PadJob jv{in(v, v_sb, v_sh, v_sr), vs, Nk, Dv, dvp};
  const long long most = bh * (Nq > Nk ? Nq : Nk);  // rows of the largest job, a warp each
  const dim3 pad_grid(static_cast<unsigned>(std::min<long long>((most + 7) / 8, 1 << 16)), 3);
  vt::pad_rows_kernel<<<pad_grid, 256, 0, s>>>(jq, jk, jv, H, static_cast<int>(bh));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long blocks = bh * groups;
  bf16* ps = nullptr;
  float* as = nullptr;
  if (plan.variant == kWideGlobal) {
    ps = vs + bh * Nk * dvp;
    const long long nc = (Nk + KC - 1) / KC;
    as = reinterpret_cast<float*>(ps + blocks * WIDE_ROWS * nc * KC);
  }
  const Args a{qs, ks, vs, dp, dvp, Operand<bf16>{static_cast<bf16*>(out), o_sb, o_sh, o_sr},
               Problem{B, H, Nq, Nk, D, Dv}, scale, static_cast<const float*>(bias), bias_b,
               bias_h, mask_self, static_cast<int>(groups), ps, as};
  using vt::kv_blocked_registers;
  using vt::kv_blocked_wide;
  if (plan.variant == kRegisters)
    e = dp == 160 && dvp == 160  // T2T's stage 0
            ? vt::launch_attention(kv_blocked_registers<10, 10, true>, plan, a, blocks, s)
            : vt::launch_attention(kv_blocked_registers<10, 10, false>, plan, a, blocks, s);
  else if (plan.variant == kWide)
    e = plan.stages == 3 ? vt::launch_attention(kv_blocked_wide<3, false>, plan, a, blocks, s)
                         : vt::launch_attention(kv_blocked_wide<2, false>, plan, a, blocks, s);
  else
    e = vt::launch_attention(kv_blocked_wide<3, true>, plan, a, blocks, s);
  return static_cast<int>(e);
}

// The fp32 route's plan (ops/flash_attention.py kv_blocked_layout(fp32=True)
// mirrors it): out = {variant (4 one pass, 5 two phases), warps a block,
// query rows a block, ring stages (1: none), shared-memory bytes}.
extern "C" void vt_kv_blocked_plan_f32(int Nk, int D, int Dv, int* out) {
  (void)Nk;  // any Nk: the chunks are streamed and p of two phases goes to the scratch
  const vt::kvf::Plan p = vt::kvf::plan_for(D, Dv);
  out[0] = p.variant;
  out[1] = vt::kvf::WARPS;
  out[2] = vt::kvf::QT;
  out[3] = 1;
  out[4] = static_cast<int>(p.bytes);
}

// The fp32 route: q, k, v and out fp32 through their (batch, head, row)
// strides in elements, unit column stride, 4-byte aligned. scratch: under
// plan variant 5, blocks*32*nc*64 floats of p then blocks*nc*32 of alpha
// (blocks = B*H*ceil(Nq/32), nc = ceil(Nk/64)), 16-byte aligned; else
// unused (may be NULL). One launch.
extern "C" int vt_flash_attention_kv_blocked_f32(
    const void* q, long long q_sb, long long q_sh, long long q_sr, const void* k, long long k_sb,
    long long k_sh, long long k_sr, const void* v, long long v_sb, long long v_sh, long long v_sr,
    void* out, long long o_sb, long long o_sh, long long o_sr, int B, int H, int Nq, int Nk, int D,
    int Dv, float scale, const void* bias, int bias_b, int bias_h, int mask_self, void* scratch,
    void* stream) {
  using namespace vt::kvf;
  using vt::kvb::KC;
  using vt::kvb::Operand;
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || D < 1 || Dv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_for(D, Dv);
  const long long bh = (long long)B * H, groups = (Nq + QT - 1) / QT, blocks = bh * groups;
  if (blocks > 0x7fffffffLL || bh * (Nq > Nk ? Nq : Nk) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan.variant == kTwoPhase &&
      (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto vec = [](const void* p, long long sb, long long sh, long long sr, int w) {
    return int(reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 &&
               sr % 4 == 0 && w % 4 == 0);
  };
  const auto in = [](const void* p, long long sb, long long sh, long long sr) {
    return Operand<const float>{static_cast<const float*>(p), sb, sh, sr};
  };
  float* ps = nullptr;
  float* as = nullptr;
  if (plan.variant == kTwoPhase) {
    ps = static_cast<float*>(scratch);
    as = ps + blocks * QT * ((Nk + KC - 1) / KC) * KC;
  }
  const Args a{in(q, q_sb, q_sh, q_sr), in(k, k_sb, k_sh, k_sr), in(v, v_sb, v_sh, v_sr),
               Operand<float>{static_cast<float*>(out), o_sb, o_sh, o_sr},
               vt::kvb::Problem{B, H, Nq, Nk, D, Dv}, scale, static_cast<const float*>(bias),
               bias_b, bias_h, mask_self, static_cast<int>(groups),
               vec(q, q_sb, q_sh, q_sr, D), vec(k, k_sb, k_sh, k_sr, D), vec(v, v_sb, v_sh, v_sr, Dv),
               ps, as};
  const auto kernel = plan.variant == kOnePass ? vt::kv_blocked_f32<true> : vt::kv_blocked_f32<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), THREADS, plan.bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
