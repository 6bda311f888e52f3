// Multi-window attention block for Hopper, no residual:
//   out = (softmax(q k^T * scale + bias[h|0]) v per window) @ Wout + bout,
//   qkv = LN(xw) @ Wqkv,  xw [NW, S, C] (NW = batch * windows)
//
// Replaces vit_tpu/ops/window_attention.py::_kernel (the Pallas TPU kernel),
// which fuses the whole block for G windows a program: LN, the qkv product,
// every head's attention and the out product, with nothing but x and the
// output in HBM (window_attention.py:10-15). It packs the G windows into one
// (G*Sp)^2 block-diagonal score tile with MASK_VALUE off the blocks, a
// device for the TPU's matrix unit (the off-block entries are exactly 0
// after exp); here each window's softmax runs on its own S keys.
//
// Bound: operations. At Twins-SVT's LSA stage 1 (S = 49, C = 64, 8 heads of
// 64) at batch 128, 8,192 windows cost 145.5 GFLOP (0.147 ms at 989 TFLOP/s)
// for 103 MB of x and output (0.031 ms at 3.35 TB/s). The four-launch
// pipeline this kernel replaces on windows of S <= 64 (ln_rows, the WMMA
// GEMM, attention_core, the WMMA GEMM) wrote and read back xn, qkv and the
// attention output: ~3.4 GB, ~1 ms of memory traffic before any arithmetic
// (qkv alone is 401,408 x 1,536 bf16), on a K = 64 GEMM that never filled
// its pipeline and 131,072 small core blocks.
//
// Design (window_block_fused): one block owns G windows, each padded to
// Sp = 16 ceil(S / 16) rows, one warp per 16 rows (G Sp / 16 warps, 8 at
// most), and every head. Nothing but x, the weights, the bias and the
// output touches device memory.
// - LN: the block's rows of x (contiguous) arrive by 16-byte cp.async into
//   the bytes that later hold the K, V and o tiles; each warp normalises
//   rows from there into a bf16 xn tile (ln_row of common.cuh, ln_rows' own
//   arithmetic). Rows S..Sp-1 and the columns past C are zeros.
// - Weights: the block walks one fixed sequence of weight tiles (a head's
//   q, k and v panels over 64 rows of C, or 128 where C > 64 and Dh <= 64,
//   then its Wout rows over 64 output columns) through a 3-stage cp.async
//   ring that all its windows share, so G windows divide the L2 weight
//   traffic by G. A barrier a tile keeps the block's warps in step.
// - qkv: xn (ldmatrix) times the ring tile (ldmatrix.trans) on
//   mma.sync.m16n8k16, bf16 in, fp32 sums, rounded once to bf16 (the twin's
//   rounding of qkv). q stays in registers: the m16n8 accumulators of two
//   column tiles are the A fragment of one k16 step (attention_core_sm90.cuh
//   tile_p's layout). k and v go to the window's K and V tiles in shared
//   memory for its other warps.
// - Attention: the helpers of attention_core_sm90.cuh's resident variant on
//   the window's <= 64 keys, scores in registers: __fmul_rn by the scale,
//   __fadd_rn of the fp32 bias [1|H, S, S] (read through L1, shared by all
//   windows), keys >= S at -inf, the exact row max, expf, the sum, the IEEE
//   division, P rounded to bf16 into A fragments, P V rounded once to bf16.
// - Out, two variants (plan_for):
//   * registers (Dh = 64 and C <= 256; Twins' three stages): each warp
//     keeps its 16 rows x C of fp32 sums in registers and adds o_h Wout_h
//     head by head, in the order 0..H-1;
//   * o-tile (other head widths, C up to 512 and beyond while it fits): o_h
//     goes to a bf16 [rows, H*Dh] tile in shared memory, and one product over
//     all H*Dh columns runs after the last head, 64 output columns at a time.
//   The TPU kernel and the twin sum the H*Dh columns in one product; the
//   per-head split changes only the order of the fp32 sums. Then bout is
//   added in fp32, the sum rounded once to xw's dtype, and the rows leave
//   through a staging tile in 16-byte stores.
// - A window's result does not depend on NW or G: each row's sums run in
//   one fixed order, and plan_for picks the variant from the shape alone.
//   The op is batch-invariant.
// Longer windows (S > 64, up to attention_core's limits), shapes whose tiles
// do not fit 227 KB and operands off 16-byte boundaries keep the four-launch
// pipeline, chosen by plan_for before any launch:
//   1. ln_rows: flax LayerNorm in fp32 -> bf16 xn
//   2. gemm_bf16: xn @ Wqkv -> bf16 qkv
//   3. attention_core: per (window, head, 32-query tile), the shared
//      per-window bias [1|H, S, S]; its 1-D grid takes more than 65,535
//      (window, head) pairs
//   4. gemm_bf16: attn @ Wout + bout -> xw.dtype
//
// The fp32 route (vt_window_attention_block_f32): with fp32 xw and weights
// the TPU kernel runs every product at Precision.HIGHEST
// (window_attention.py:74-76) and rounds nothing to bf16. Four launches on
// fp32 throughout, at any window size (CrossFormer's 1-token LDA windows to
// Twins' 49): ln_rows to an fp32 xn, the qkv product on gemm_f32.cuh (fp32
// FMAs on the CUDA cores), the fp32 core of attention_f32.cuh with the
// windows as its batch axis and the shared bias [1|H, S, S], the out product
// with bout in gemm_f32's epilogue, no residual. Bound: operations at the
// card's fp32 rate.

#include "attention_core.cuh"
#include "attention_core_sm90.cuh"
#include "attention_f32.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_f32.cuh"

namespace vt {
namespace {

namespace win {
using attn::align128;

constexpr int KR_MAX = 128;    // weight rows a ring tile: 64, or 128 where C > 64 and Dh <= 64
constexpr int NC = 64;         // output columns a chunk of the out product
constexpr int STAGES = 3;      // ring stages
constexpr int MAX_WARPS = 8;   // a block's warps: G windows x Sp / 16
constexpr int MAX_S = 64;      // the longest window of the fused kernel
constexpr int LD_STAGE = NC + 8;  // the output staging rows (elements)
enum Variant { kFourLaunch = 0, kRegisters = 1, kOTile = 2 };

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of a block of G windows: the bf16 xn tile [G Sp, round16(C)],
// the K and V tiles of each window (G x 2 x [Sp, Dh]; the output staging of
// every warp in the same bytes once the last head is done), the o tile
// [G Sp, H Dh] (o-tile variant), and the ring. +8 bf16 a row staggers the
// banks of ldmatrix's 8 row reads.
struct Layout {
  int sp, wpw, warps, cp, kr, ldx, ldkv, lds, ldo;
  size_t kv_off, o_off, ring_off, stage_bytes, bytes;
};

__host__ __device__ inline Layout layout(int variant, int G, int S, int C, int H, int Dh) {
  Layout L;
  L.sp = round16(S);
  L.wpw = L.sp / 16;
  L.warps = G * L.wpw;
  L.cp = round16(C);
  L.kr = C > 64 && Dh <= 64 ? KR_MAX : 64;
  L.ldx = L.cp + 8;
  L.ldkv = Dh + 8;
  L.lds = (Dh > NC ? Dh : NC) + 8;
  L.ldo = H * Dh + 8;
  const size_t rows = size_t(G) * L.sp;
  const size_t kv = 2 * rows * L.ldkv * sizeof(bf16);
  const size_t staging = size_t(L.warps) * 16 * LD_STAGE * sizeof(float);
  L.kv_off = align128(rows * L.ldx * sizeof(bf16));
  L.o_off = L.kv_off + align128(kv > staging ? kv : staging);
  L.ring_off = L.o_off + (variant == kOTile ? align128(rows * L.ldo * sizeof(bf16)) : 0);
  L.stage_bytes = align128(size_t(L.kr) * L.lds * sizeof(bf16));
  L.bytes = L.ring_off + STAGES * L.stage_bytes;
  return L;
}

struct Plan {
  int variant, G;
  size_t bytes;
};

// The route and block shape of a window shape (ops/window_attention.py
// plan_for mirrors it). The fused variants take S <= 64, Dh % 16 == 0 up to
// 128, C % 8 == 0 and operands on 16-byte boundaries (`aligned`: the
// cp.async copies and the output stores); registers also needs Dh = 64 and
// C <= 256. G: 8 warps a block (two windows of 49 or 64 rows), fewer while
// the tiles exceed 227 KB or an fp32 row of x exceeds the bytes that stage
// it.
inline Plan plan_for(int S, int C, int H, int Dh, bool aligned) {
  const Plan four{kFourLaunch, 0, 0};
  if (!aligned || S < 1 || S > MAX_S || Dh % 16 != 0 || Dh < 16 || Dh > 128 || C % 8 != 0 ||
      C < 8 || H < 1)
    return four;
  const auto fit = [&](int variant) {
    const int wpw = round16(S) / 16;
    for (int G = MAX_WARPS / wpw > 1 ? MAX_WARPS / wpw : 1; G >= 1; --G) {
      const Layout L = layout(variant, G, S, C, H, Dh);
      const bool x_row_fits = L.ring_off - L.kv_off >= size_t(C) * sizeof(float);
      if (L.bytes <= size_t(attn90::MAX_SMEM) && x_row_fits) return Plan{variant, G, L.bytes};
    }
    return four;
  };
  const Plan p = Dh == 64 && C <= 256 ? fit(kRegisters) : four;
  return p.variant == kFourLaunch ? fit(kOTile) : p;
}

// Rows [0, rows) x columns [0, cols) of a row-major bf16 matrix (row stride
// ld) into a ring stage, by every thread of the block; zeros at rows >=
// rows_ok or columns >= cols_ok.
__device__ __forceinline__ void load_tile(bf16* dst, int ldd, const bf16* src, long long ld,
                                          int rows, int rows_ok, int cols, int cols_ok) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const bool ok = r < rows_ok && c < cols_ok;
    cp_async16(dst + r * ldd + c, ok ? src + r * ld + c : src, ok);
  }
}

// fp32 m16n8 accumulators (N tiles of 8 columns) -> bf16 A fragments of the
// k16 steps: tiles 2j and 2j + 1 form step j (attn90::tile_p's layout).
template <int DK, bool FIXED>
__device__ __forceinline__ void to_frags(unsigned (&f)[DK][4], const float (&acc)[2 * DK][4],
                                         int dk) {
  using attn90::pack_bf16;
#pragma unroll
  for (int j = 0; j < DK; ++j) {
    if (FIXED || j < dk) {
      f[j][0] = pack_bf16(acc[2 * j][0], acc[2 * j][1]);
      f[j][1] = pack_bf16(acc[2 * j][2], acc[2 * j][3]);
      f[j][2] = pack_bf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
      f[j][3] = pack_bf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
    }
  }
}

// The warp's 16 rows of fp32 accumulators (the first n tiles of N) rounded
// to bf16 into a shared-memory tile at row0.
template <int N>
__device__ __forceinline__ void store_rows(bf16* tile, int ld, int row0, const float (&acc)[N][4],
                                           int n, int lane) {
  bf16* p = tile + (row0 + (lane >> 2)) * ld + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) {
      *reinterpret_cast<unsigned*>(p + j * 8) = attn90::pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<unsigned*>(p + 8 * ld + j * 8) = attn90::pack_bf16(acc[j][2], acc[j][3]);
    }
  }
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Columns [col0, col0 + 64) of the warp's 16 rows: acc + bout in fp32,
// rounded once to T into the warp's staging tile, then 16-byte stores of
// the rows below S of a window below NW and the columns below C.
template <typename T>
__device__ __forceinline__ void store_out(const float (&acc)[NC / 8][4], int col0, T* stg,
                                          const float* __restrict__ bout, T* __restrict__ out,
                                          int wi, int NW, int row0, int S, int C, int lane) {
  const int r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + j * 8 + c;  // C % 8 == 0: col < C covers col + 1
    const float b0 = col < C ? __ldg(bout + col) : 0.f, b1 = col < C ? __ldg(bout + col + 1) : 0.f;
    put2(stg + r * LD_STAGE + j * 8 + c, acc[j][0] + b0, acc[j][1] + b1);
    put2(stg + (r + 8) * LD_STAGE + j * 8 + c, acc[j][2] + b0, acc[j][3] + b1);
  }
  __syncwarp();
  constexpr int per16 = 16 / sizeof(T), chunks = NC / per16;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int rr = i / chunks, cc = (i % chunks) * per16;
    if (wi < NW && row0 + rr < S && col0 + cc < C)
      *reinterpret_cast<uint4*>(out + ((size_t)wi * S + row0 + rr) * C + col0 + cc) =
          *reinterpret_cast<const uint4*>(stg + rr * LD_STAGE + cc);
  }
  __syncwarp();
}
}  // namespace win

// The whole block for G windows (see the note above). DK: k16 steps of a
// head (Dh / 16; FIXED when Dh == 16 DK, else Dh is read at run time).
// NCH: the 64-column chunks of the output a warp keeps in registers
// (registers variant), 0 for the o-tile variant.
template <typename T, int DK, bool FIXED, int NCH>
__global__ void __launch_bounds__(win::MAX_WARPS * 32, (NCH <= 1 && DK <= 4) ? 2 : 1)
window_block_fused(const T* __restrict__ x, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, const bf16* __restrict__ wqkv,
                   const bf16* __restrict__ wout, const float* __restrict__ bout,
                   const float* __restrict__ bias, int bias_h, T* __restrict__ out, int NW, int S,
                   int C, int H, int Dh, float scale, float eps, int G) {
  using namespace attn90;
  using win::KR_MAX;
  using win::NC;
  using win::STAGES;
  constexpr bool REG = NCH > 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const win::Layout L = win::layout(REG ? win::kRegisters : win::kOTile, G, S, C, H, Dh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / L.wpw, row0 = (warp % L.wpw) * 16;  // window in the block, its rows
  const int wi = blockIdx.x * G + g;
  const int HD = H * Dh, dk = Dh / 16;
  bf16* xn = reinterpret_cast<bf16*>(smem);
  bf16* kwin = reinterpret_cast<bf16*>(smem + L.kv_off) + size_t(g) * L.sp * L.ldkv;
  bf16* vwin = kwin + size_t(G) * L.sp * L.ldkv;
  bf16* ot = reinterpret_cast<bf16*>(smem + L.o_off);
  T* stg = reinterpret_cast<T*>(smem + L.kv_off) + size_t(warp) * 16 * win::LD_STAGE;

  // The weight tiles, in the order the block consumes them: per head, q, k
  // and v over kc of C (3 KC tiles), then (registers) Wout_h over NCH column
  // chunks; after the heads (o-tile) Wout over nco column chunks x ko row
  // tiles.
  const int KR = L.kr, KC = (C + KR - 1) / KR, per_head = 3 * KC + NCH;
  const int nco = (C + NC - 1) / NC, ko = (HD + KR - 1) / KR;
  const int steps = H * per_head + (REG ? 0 : nco * ko);
  const auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + L.ring_off + (s % STAGES) * L.stage_bytes);
  };
  const auto issue = [&](int s) {
    if (s < steps) {
      if (s < H * per_head) {
        const int h = s / per_head, i = s % per_head;
        if (i < 3 * KC) {
          const int p = i / KC, kc = i % KC;
          win::load_tile(stage(s), L.lds, wqkv + (size_t)kc * KR * 3 * HD + p * HD + h * Dh,
                         3 * HD, min(KR, L.cp - kc * KR), C - kc * KR, Dh, Dh);
        } else {
          const int nc = i - 3 * KC;
          win::load_tile(stage(s), L.lds, wout + (size_t)h * Dh * C + nc * NC, C, Dh, Dh, NC,
                         C - nc * NC);
        }
      } else {
        const int j = s - H * per_head, nc = j / ko, kk = j % ko;
        const int rows = min(KR, HD - kk * KR);
        win::load_tile(stage(s), L.lds, wout + (size_t)kk * KR * C + nc * NC, C, rows, rows, NC,
                       C - nc * NC);
      }
    }
    cp_async_commit();
  };
  int step = 0;
  // The next tile: every thread's copies of it have landed and every warp is
  // done with the stage the tile STAGES - 1 ahead now fills.
  const auto next = [&]() {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(step + STAGES - 1);
    return stage(step++);
  };

  // The block's rows of x (contiguous in device memory) into shared memory
  // over the K, V and o tiles, which are free until the first head, by
  // 16-byte cp.async (as many rows as fit at a time); then LN, one warp a
  // row, into the xn tile. The ring's first tiles load meanwhile.
  const int x_rows = min(G, NW - blockIdx.x * G) * S;
  const size_t row_bytes = size_t(C) * sizeof(T);
  const int cap = static_cast<int>((L.ring_off - L.kv_off) / row_bytes);
  const char* xg = reinterpret_cast<const char*>(x + (size_t)blockIdx.x * G * S * C);
  for (int r0 = 0; r0 < x_rows; r0 += cap) {
    const int n = min(cap, x_rows - r0), chunks = static_cast<int>(n * row_bytes / 16);
    for (int i = threadIdx.x; i < chunks; i += blockDim.x)
      cp_async16(smem + L.kv_off + 16 * size_t(i), xg + r0 * row_bytes + 16 * size_t(i), true);
    cp_async_commit();
    if (r0 == 0) {
      for (int s = 0; s < STAGES - 1; ++s) issue(s);
      cp_async_wait<STAGES - 1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int r = r0 + warp; r < r0 + n; r += L.warps)
      ln_row(reinterpret_cast<const T*>(smem + L.kv_off + (r - r0) * row_bytes), ln_scale,
             ln_bias, xn + ((r / S) * L.sp + r % S) * L.ldx, C, eps, lane);
    __syncthreads();
  }
  // zeros: the padded rows, the windows past NW, the columns past C
  const bf16 zero = __float2bfloat16(0.f);
  for (int r = warp; r < G * L.sp; r += L.warps) {
    bf16* yr = xn + (size_t)r * L.ldx;
    if (r % L.sp >= S || blockIdx.x * G + r / L.sp >= NW)
      for (int c = lane; c < C; c += 32) yr[c] = zero;
    for (int c = C + lane; c < L.cp; c += 32) yr[c] = zero;
  }

  // A fragments of the warp's 16 xn rows (load_q's lane map)
  const bf16* xa =
      xn + (g * L.sp + row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldx + (lane >> 4) * 8;
  const int nkt = L.sp / 16;
  float acc_out[REG ? NCH : 1][NC / 8][4];
#pragma unroll
  for (int c = 0; c < (REG ? NCH : 1); ++c)
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      acc_out[c][j][0] = acc_out[c][j][1] = acc_out[c][j][2] = acc_out[c][j][3] = 0.f;

  for (int h = 0; h < H; ++h) {
    // q, k, v of head h for the warp's rows: xn @ the head's panels, rounded
    // once to bf16; q kept as A fragments, k and v into the window's tiles.
    unsigned qf[DK][4];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float acc[2 * DK][4];
#pragma unroll
      for (int j = 0; j < 2 * DK; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kc = 0; kc < KC; ++kc) {
        const bf16* st = next();
        const int ks_n = min(KR, L.cp - kc * KR) / 16;
#pragma unroll
        for (int ks = 0; ks < KR_MAX / 16; ++ks) {
          if (ks < ks_n) {
            unsigned a[4];
            ldsm_x4(a, xa + kc * KR + ks * 16);
            tile_pv<DK, FIXED>(acc, a, st + ks * 16 * L.lds, L.lds, dk, lane);
          }
        }
      }
      if (p == 0)
        win::to_frags<DK, FIXED>(qf, acc, dk);
      else
        win::store_rows(p == 1 ? kwin : vwin, L.ldkv, row0, acc, 2 * dk, lane);
    }
    __syncthreads();  // the window's K and V tiles

    // the window's attention for head h: scores, terms and softmax in
    // registers (attention_core_sm90.cuh), P V rounded once to bf16
    const float* hb = bias == nullptr ? nullptr : bias + (size_t)(bias_h ? h : 0) * S * S;
    const Rows R{row0 + (lane >> 2), lane & 3, S, S, scale, hb, false, hb == nullptr,
                 ScoreTerms{bias, 0, bias_h, S, S, 0}};
    float s[4][8];
    score_chunk<DK, 4, FIXED>(s, 0, nkt, qf, kwin, L.ldkv, dk, lane);
    float m0 = -INFINITY, m1 = -INFINITY, lo0 = INFINITY, lo1 = INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < nkt) {
        score_terms(s[t], t * 16, R, lo0, lo1);
        tile_max(s[t], m0, m1);
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < nkt) {
        tile_exp(s[t], m0, m1);
        tile_sum(s[t], l0, l1);
      }
    }
    const Norm nm = make_norm(quad_sum(l0), quad_sum(l1), m0, m1, lo0, lo1);
    float o[2 * DK][4];
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < nkt) {
        unsigned a[4];
        tile_p(a, s[t], nm);
        tile_pv<DK, FIXED>(o, a, vwin + t * 16 * L.ldkv, L.ldkv, dk, lane);
      }
    }

    if constexpr (REG) {
      // out += o_h Wout_h (Dh = 64: one 64-row tile a column chunk)
      unsigned of[DK][4];
      win::to_frags<DK, FIXED>(of, o, dk);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const bf16* st = next();
#pragma unroll
        for (int ks = 0; ks < DK; ++ks)
          tile_pv<NC / 16, true>(acc_out[c], of[ks], st + ks * 16 * L.lds, L.lds, NC / 16, lane);
      }
    } else {
      win::store_rows(ot + h * Dh, L.ldo, g * L.sp + row0, o, 2 * dk, lane);
    }
  }

  // Out. The staging tiles overlay the K and V tiles: every warp is past its
  // last attention once it has passed the barrier of a later ring step.
  if constexpr (REG) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      win::store_out(acc_out[c], c * NC, stg, bout, out, wi, NW, row0, S, C, lane);
  } else {
    // one product over all H Dh columns of the warp's o rows, 64 output
    // columns at a time
    const bf16* oa =
        ot + (g * L.sp + row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.ldo + (lane >> 4) * 8;
    for (int nc = 0; nc < nco; ++nc) {
      float acc[NC / 8][4];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kk = 0; kk < ko; ++kk) {
        const bf16* st = next();
        const int ks_n = min(KR, HD - kk * KR) / 16;
#pragma unroll
        for (int ks = 0; ks < KR_MAX / 16; ++ks) {
          if (ks < ks_n) {
            unsigned a[4];
            ldsm_x4(a, oa + kk * KR + ks * 16);
            tile_pv<NC / 16, true>(acc, a, st + ks * 16 * L.lds, L.lds, NC / 16, lane);
          }
        }
      }
      win::store_out(acc, nc * NC, stg, bout, out, wi, NW, row0, S, C, lane);
    }
  }
}

namespace win {
// An instance of window_block_fused, named by its template arguments.
template <int DK_, bool FIXED_, int NCH_>
struct Inst {
  static constexpr int DK = DK_, NCH = NCH_;
  static constexpr bool FIXED = FIXED_;
};

template <typename T, int DK, bool FIXED, int NCH>
cudaError_t launch(const Plan& plan, const T* x, const float* ln_scale, const float* ln_bias,
                   const bf16* wqkv, const bf16* wout, const float* bout, const float* bias,
                   int bias_h, T* out, int NW, int S, int C, int H, int Dh, float scale, float eps,
                   cudaStream_t stream) {
  const auto kernel = window_block_fused<T, DK, FIXED, NCH>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.bytes));
  if (e != cudaSuccess) return e;
  const int warps = plan.G * (round16(S) / 16);
  const unsigned blocks = static_cast<unsigned>((NW + plan.G - 1) / plan.G);
  kernel<<<blocks, warps * 32, plan.bytes, stream>>>(x, ln_scale, ln_bias, wqkv, wout, bout, bias,
                                                    bias_h, out, NW, S, C, H, Dh, scale, eps,
                                                    plan.G);
  return cudaGetLastError();
}
}  // namespace win

template <typename T>
cudaError_t window_attention_block(const T* x, const float* ln_scale, const float* ln_bias,
                                   const bf16* wqkv, const bf16* wout, const float* bout,
                                   const float* bias, int bias_h, T* out, bf16* xn, bf16* qkv,
                                   bf16* attn_out, int NW, int S, int C, int H, int Dh,
                                   float scale, float eps, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const win::Plan plan =
      win::plan_for(S, C, H, Dh, aligned(x) && aligned(wqkv) && aligned(wout) && aligned(out));
  if (NW < 1) return cudaErrorInvalidValue;
  if (plan.variant == win::kFourLaunch) {
    if (xn == nullptr || qkv == nullptr || attn_out == nullptr) return cudaErrorInvalidValue;
    const int rows = NW * S, HD = H * Dh;
    cudaError_t e = ln_rows<T>(x, ln_scale, ln_bias, xn, rows, C, eps, stream);
    if (e != cudaSuccess) return e;
    e = gemm_bf16<bf16>(xn, wqkv, qkv, nullptr, nullptr, kActNone, rows, 3 * HD, C, stream);
    if (e != cudaSuccess) return e;
    e = attention_core<bf16>(qkv, attn_out, NW, S, H, Dh, scale,
                             attn::ScoreTerms{bias, 0, bias_h, S, S, 0}, stream);
    if (e != cudaSuccess) return e;
    return gemm_bf16<T>(attn_out, wout, out, bout, nullptr, kActNone, rows, C, HD, stream);
  }
  const auto go = [&](auto kernel_tag) {
    using K = decltype(kernel_tag);
    return win::launch<T, K::DK, K::FIXED, K::NCH>(plan, x, ln_scale, ln_bias, wqkv, wout, bout,
                                                   bias, bias_h, out, NW, S, C, H, Dh, scale,
                                                   eps, stream);
  };
  if (plan.variant == win::kRegisters) {  // Dh == 64, C <= 256
    if (C <= 64) return go(win::Inst<4, true, 1>{});
    if (C <= 128) return go(win::Inst<4, true, 2>{});
    return go(win::Inst<4, true, 4>{});
  }
  if (Dh == 64) return go(win::Inst<4, true, 0>{});
  return go(win::Inst<8, false, 0>{});
}

}  // namespace
}  // namespace vt

extern "C" int vt_window_attention_block(const void* x, int x_is_fp32, const void* ln_scale,
                                         const void* ln_bias, const void* wqkv, const void* wout,
                                         const void* bout, const void* bias, int bias_h,
                                         void* out, void* xn, void* qkv, void* attn, int NW,
                                         int S, int C, int H, int Dh, float scale, float eps,
                                         void* stream) {
  using vt::bf16;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* xn_ = static_cast<bf16*>(xn);
  bf16* qkv_ = static_cast<bf16*>(qkv);
  bf16* attn_ = static_cast<bf16*>(attn);
  cudaError_t e;
  if (x_is_fp32)
    e = vt::window_attention_block<float>(f(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout),
                                          f(bout), f(bias), bias_h, static_cast<float*>(out), xn_,
                                          qkv_, attn_, NW, S, C, H, Dh, scale, eps, s);
  else
    e = vt::window_attention_block<bf16>(h(x), f(ln_scale), f(ln_bias), h(wqkv), h(wout),
                                         f(bout), f(bias), bias_h, static_cast<bf16*>(out), xn_,
                                         qkv_, attn_, NW, S, C, H, Dh, scale, eps, s);
  return static_cast<int>(e);
}

// The fp32 route: xw, the weights, the scratch (xn, qkv, attn) and out all fp32.
extern "C" int vt_window_attention_block_f32(const void* x, const void* ln_scale,
                                             const void* ln_bias, const void* wqkv,
                                             const void* wout, const void* bout,
                                             const void* bias, int bias_h, void* out, void* xn,
                                             void* qkv, void* attn, int NW, int S, int C, int H,
                                             int Dh, float scale, float eps, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* y = static_cast<float*>(xn);
  float* qkv_ = static_cast<float*>(qkv);
  float* attn_ = static_cast<float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = NW * S, HD = H * Dh;
  cudaError_t e = vt::ln_rows<float>(f(x), f(ln_scale), f(ln_bias), y, rows, C, eps, s);
  if (e == cudaSuccess)
    e = vt::gemm_f32(y, f(wqkv), qkv_, nullptr, nullptr, vt::kActNone, rows, 3 * HD, C, s);
  if (e == cudaSuccess)
    e = vt::attention_f32(qkv_, attn_, NW, S, H, Dh, scale,
                          vt::attn::ScoreTerms{f(bias), 0, bias_h, S, S, 0}, s);
  if (e == cudaSuccess)
    e = vt::gemm_f32(attn_, f(wout), static_cast<float*>(out), f(bout), nullptr, vt::kActNone,
                     rows, C, HD, s);
  return static_cast<int>(e);
}

// The plan of a window shape with aligned operands: out[0] the variant (0
// four launches, 1 registers, 2 o-tile), out[1] G, out[2] the shared-memory
// bytes of a block. ops/window_attention.py plan_for mirrors it.
extern "C" int vt_window_attention_plan(int S, int C, int H, int Dh, int* out) {
  const vt::win::Plan p = vt::win::plan_for(S, C, H, Dh, true);
  out[0] = p.variant;
  out[1] = p.G;
  out[2] = static_cast<int>(p.bytes);
  return 0;
}
