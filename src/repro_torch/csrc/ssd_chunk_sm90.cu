// The SSD intra-chunk block of Mamba-2 on Hopper's tensor cores: both
// products in 3xTF32 on wgmma, the C.B^T scores formed once for a group of
// heads, for sm_90a.
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/ssd_chunk.py::ssd_intra_pallas (body _ssd_intra_kernel),
// and computes what it computes, on the same tensors (all fp32, contiguous):
//   cc, bc (BC, Q, N)     C and B blocks per (batch x chunk), shared by heads
//   acum   (BC, H, Q)     cumulative log decays
//   xd     (BC, H, Q, P)  dt-weighted inputs
//   y      (BC, H, Q, P)  y[i] = sum_{j <= i} (c_i . b_j)
//                                 * exp(acum_i - acum_j) x_j
//
// What bounds it on the H100: at mamba2-130m's 2,048-token prefill (BC = 8,
// H = 24, Q = 256, N = 128, P = 64) the causal half of the two products is
// 0.876 GFLOP a launch (the scores once per chunk, single SSD group), which
// in 3xTF32 on the tensor cores takes 3 x 0.876 GFLOP / 495 TFLOP/s =
// 5.3 us; the fp32 inputs read once and the output written once are
// 27.46 MB, 8.2 us at 3.35 TB/s.  So bytes bound it.  On the fp32 FMA units
// (67 TFLOP/s) the operations would, at 13.3 us.
//
// Design.
// * The scores are shared across heads.  A block owns one (chunk, row tile
//   i of T = 64 rows, group of 2 or 4 heads); the grid is (head groups,
//   chunks, row tiles), the longest row tiles first (row tile r walks
//   r + 1 column tiles).  For each column tile j <= i it forms S = C_i
//   B_j^T once (one stage, k = N <= 128, each warpgroup 32 of its 64
//   columns), leaves it in shared memory in fp32, and then each warpgroup
//   takes one head of the group at a time: P = S o L_h, built in registers
//   as the A operand of wgmma, times X_{h,j} from shared memory, summed
//   into that head's 64 x 64 output in registers.  The heads a block come
//   from the wrapper's plan (kernels/ssd_chunk.py::launch_plan), which
//   weighs filling 132 SMs against forming the scores again per group.
// * C_i stays in shared memory for the whole block; B_j and the heads' X
//   pass through two stage slots.  Every operand is staged by the threads
//   themselves, split into tf32 and placed K-major in the 128-byte swizzle
//   (tf32 wgmma reads shared-memory operands K-major only, so X, whose p is
//   contiguous, is transposed on the way); the next stage's global loads
//   are issued before this stage's wgmmas.
// * Both products on tf32 wgmma, three products each: every fp32 operand is
//   split into hi = tf32(a) (cvt.rna) and lo = tf32(a - hi), and the block
//   accumulates lo*hi + hi*lo + hi*hi.  At mamba2-130m's chunk one TF32
//   product misses the kernel's tolerance (1e-4) by 24-184x; three use
//   5-35% of it (tests/test_torch_ssd_route.py emulates both).
// * The tensor cores add into their fp32 accumulator rounding toward zero,
//   so each head stage's 24 wgmmas start from zero and the stage sums meet
//   in registers, rounded to nearest (a score tile is one stage of 48).
// * The decays.  Below the diagonal (column tile j < row tile i) every j
//   precedes every i, and exp(acum_i - acum_j) = exp(acum_i - acum_ref)
//   exp(acum_ref - acum_j), ref the column tile's last j, both exponents
//   <= 0 (acum falls): P = S times 64 column factors, and 2 row factors a
//   thread scale the stage's sums; no exp and no mask per element.  On the
//   diagonal the mask comes before the exponential: for j > i, acum_i -
//   acum_j is positive and its exp may overflow to inf, so the exponent of
//   a masked pair is -inf, and its weight exp(-inf) = 0.
// * Ragged shapes are zeros in shared memory: rows and columns past Q, k
//   past N, and columns past P (at most 64); a ragged head group repeats
//   its last head and drops the result.
// * What limits it: the threads' staging (loads, splits, transposes, the
//   decays) and the wgmmas run one after the other in each warpgroup, and
//   an SM holds one block of 8 warps; the tensor cores are busy a fraction
//   of the time.
// * The opt-in to the block's dynamic shared memory is set once per
//   instantiation, not per launch; a plain launch, no cluster, no atomics:
//   two launches on the same inputs are bit-identical.
//
// The C entry returns the launch's cudaError_t, or cudaErrorInvalidValue for
// a shape or plan the kernel cannot take; the wrapper validates every shape.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int T = 64;              // rows (columns) of a row (column) tile
constexpr int PANEL = T * 128;     // 64 rows x 32 fp32 (one 128-byte row)
constexpr int WN = 32;             // score columns of a warpgroup
constexpr int THREADS = 256;       // two warpgroups
constexpr int MAXP = 64;
constexpr int MAXN = 128;          // the score product's k, in one stage
constexpr int HW_MAX = 2;          // head steps a column tile: heads / 2
constexpr int TILE = 2 * PANEL;    // 64 x 64 fp32, hi or lo: x^T, k = j
constexpr int CTILE = 4 * PANEL;   // 64 x 128 fp32, hi or lo: C or B, k = n
constexpr int STAGE = 2 * CTILE;   // score: B hi, lo; head: x^T per wg
constexpr int C_OFF = 2 * STAGE;   // C_i, hi and lo, for the whole block
constexpr int SROW = T + 4;        // floats a row of the fp32 score tile
constexpr int S_OFF = C_OFF + 2 * CTILE;
// a head stage's column decays, per warpgroup: acum_j, then the factors
// exp(acum_ref - acum_j), then acum_ref (ref = the column tile's last j)
constexpr int DECN = 2 * T + 4;
constexpr int DEC_OFF = S_OFF + T * SROW * 4;
constexpr int AI_OFF = DEC_OFF + 2 * 2 * DECN * 4;   // row decays, per head
constexpr int SMEM = AI_OFF + 2 * HW_MAX * T * 4 + 1024;   // + alignment
static_assert(PANEL % 1024 == 0 && WN * 128 % 1024 == 0, "swizzle atoms");
static_assert(2 * TILE == CTILE, "a head stage fills a score stage's slot");
static_assert(2 * HW_MAX * T <= THREADS, "a row decay a thread");

struct Ssd {
  const float* __restrict__ cc;
  const float* __restrict__ bc;
  const float* __restrict__ acum;
  const float* __restrict__ xd;
  float* __restrict__ y;
  int h, q, n, p;
  int tiles;                       // row tiles of a chunk
  int vec;                         // 16-byte loads of cc and bc
};

// 4 consecutive fp32 of row `row` from column `col` (zeros past the edges)
__device__ __forceinline__ float4 load4(const float* base, int row, int rows,
                                        int col, int cols, int vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows || col >= cols) return v;
  const float* r = base + (size_t)row * cols + col;
  if (vec) return __ldg(reinterpret_cast<const float4*>(r));
  v.x = __ldg(r);
  if (col + 1 < cols) v.y = __ldg(r + 1);
  if (col + 2 < cols) v.z = __ldg(r + 2);
  if (col + 3 < cols) v.w = __ldg(r + 3);
  return v;
}

// The byte offset of 16-byte chunk q of row r in a tile of 64 rows and
// panels of 32 fp32 k, each panel in the 128-byte swizzle.
__device__ __forceinline__ int chunk_at(int r, int q) {
  return (q / 8) * PANEL + sw128(r, q % 8);
}

template <int HW>
__global__ void __launch_bounds__(THREADS, 1)
ssd_sm90_kernel(const __grid_constant__ Ssd s) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  float* s_tile = reinterpret_cast<float*>(sm + S_OFF);
  float* dec = reinterpret_cast<float*>(sm + DEC_OFF);
  float* ai_s = reinterpret_cast<float*>(sm + AI_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128, tw = tid % 128;
  const int h0 = blockIdx.x * 2 * HW, nh = min(2 * HW, s.h - h0);
  const int g = blockIdx.y;
  const int rt = s.tiles - 1 - blockIdx.z;     // the longest rows first
  const int i0 = rt * T;
  // per column tile: a score stage, then HW head stages
  const int per = 1 + HW, nt = (rt + 1) * per;
  const size_t qp = (size_t)s.q * s.p;
  const float* cg = s.cc + (size_t)g * s.q * s.n;
  const float* bg = s.bc + (size_t)g * s.q * s.n;
  const float* ag = s.acum + ((size_t)g * s.h + h0) * s.q;
  const float* xg = s.xd + ((size_t)g * s.h + h0) * qp;
  float* yg = s.y + ((size_t)g * s.h + h0) * qp;

  // this thread's accumulator rows fr and fr + 8; its score columns
  // 32 wg + 8j + fc + e, its output columns 8j + fc + e
  const int fr = 16 * (warp % 4) + lane / 4, fc = 2 * (lane % 4);
  // a 64 x 128 operand: 16-byte chunks sq + 8v of rows sr and sr + 32
  const int sq = tid % 8, sr = tid / 8;
  // a head stage: row xp of its warpgroup's x^T (the p of x), chunks
  // xq + 2u
  const int xp = tw % T, xq = tw / T;

  float4 ld[8];                    // the next stage's operands, as loaded
  float laj = 0.f, laref = 0.f;    // and column decays (head stages)

  // 64 rows from row r0 of a (Q, N) matrix, all N <= 128, into ld
  auto load_rows = [&](const float* m, int r0) {
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        ld[2 * v + u] = load4(m, r0 + sr + 32 * u, s.q, 4 * (sq + 8 * v),
                              s.n, s.vec);
  };
  // ... split into tf32 hi and lo, into hi and hi + CTILE
  auto store_rows = [&](uint8_t* hi_t) {
    float4 hi, lo;
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int off = chunk_at(sr + 32 * u, sq + 8 * v);
        split(ld[2 * v + u], hi, lo);
        *reinterpret_cast<float4*>(hi_t + off) = hi;
        *reinterpret_cast<float4*>(hi_t + CTILE + off) = lo;
      }
  };

  // head step m's head for this warpgroup (a ragged group repeats its last
  // head, and discards the result)
  auto head_of = [&](int m) { return min(2 * m + wg, nh - 1); };

  // stage t: column tile t / per; its scores (t % per == 0: B_j), or head
  // step t % per - 1 (each warpgroup its head's x and column decays)
  auto load_head = [&](int t) {
    const int j0 = t / per * T, hh = head_of(t % per - 1);
    const float* xh = xg + hh * qp;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + 4 * (xq + 2 * u);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = j + e < s.q && xp < s.p
                   ? __ldg(xh + (size_t)(j + e) * s.p + xp) : 0.f;
      ld[u] = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (tw < T) {
      const float* ah = ag + hh * s.q;
      laj = j0 + tw < s.q ? __ldg(ah + j0 + tw) : 0.f;
      laref = __ldg(ah + min(j0 + T, s.q) - 1);
    }
  };

  auto store_head = [&](int t) {
    uint8_t* b_t = sm + (t & 1) * STAGE + wg * 2 * TILE;
    float4 hi, lo;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int off = chunk_at(xp, xq + 2 * u);
      split(ld[u], hi, lo);
      *reinterpret_cast<float4*>(b_t + off) = hi;
      *reinterpret_cast<float4*>(b_t + TILE + off) = lo;
    }
    if (tw < T) {
      float* dj = dec + ((t & 1) * 2 + wg) * DECN;
      dj[tw] = laj;
      dj[T + tw] = __expf(laref - laj);
      if (tw == 0) dj[2 * T] = laref;
    }
    fence_async_smem();            // visible to the wgmmas' proxy
  };
  auto load = [&](int t) {
    if (t % per == 0)
      load_rows(bg, t / per * T);
    else
      load_head(t);
  };
  auto store = [&](int t) {
    if (t % per == 0) {
      store_rows(sm + (t & 1) * STAGE);
      fence_async_smem();
    } else {
      store_head(t);
    }
  };

  // the block's rows of C, the first B_j and the row decays, their loads
  // all in flight together
  float4 c_ld[8];
  load_rows(cg, i0);
#pragma unroll
  for (int k = 0; k < 8; ++k) c_ld[k] = ld[k];
  load_rows(bg, 0);
  const int hk = tid / T, ik = i0 + tid % T;     // a row decay a thread
  const float ai = hk < nh && ik < s.q ? __ldg(ag + hk * s.q + ik) : 0.f;
  store_rows(sm);
#pragma unroll
  for (int k = 0; k < 8; ++k) ld[k] = c_ld[k];
  store_rows(sm + C_OFF);
  if (tid < 2 * HW * T) ai_s[tid] = ai;
  fence_async_smem();

  float sc[WN / 2];                // the scores, this warpgroup's columns
  float acc[HW][32];               // each head step's output, fp32
  float hp[32];                    // one head stage's sums
#pragma unroll
  for (int m = 0; m < HW; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  __syncthreads();
  int t = 0;
  for (int jt = 0; jt <= rt; ++jt) {
    // the scores S = C_i B_j^T (k = N, zeros past it) in one stage;
    // warpgroup wg forms columns 32 wg ... 32 wg + 31
    {
      load_head(t + 1);            // a column tile has head stages after
      const uint32_t b_s = base + (t & 1) * STAGE + wg * WN * 128;
      const uint64_t a_hi = sw128_desc(base + C_OFF, 16, 1024);
      const uint64_t a_lo = sw128_desc(base + C_OFF + CTILE, 16, 1024);
      const uint64_t b_hi = sw128_desc(b_s, 16, 1024);
      const uint64_t b_lo = sw128_desc(b_s + CTILE, 16, 1024);
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < MAXN / 8; ++kk) {
        const uint64_t o = ((kk / 4) * PANEL + (kk % 4) * 32) >> 4;
        wgmma_tf32(sc, a_lo + o, b_hi + o, kk > 0);
        wgmma_tf32(sc, a_hi + o, b_lo + o, 1);
        wgmma_tf32(sc, a_hi + o, b_hi + o, 1);
      }
      wg_commit();
      store_head(t + 1);
      wg_wait<0>();
      fence_regs(sc);
      // the finished scores, fp32, for both warpgroups' head steps
#pragma unroll
      for (int jj = 0; jj < WN / 8; ++jj)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          *reinterpret_cast<float2*>(
              s_tile + (fr + 8 * f) * SROW + wg * WN + 8 * jj + fc) =
              make_float2(sc[4 * jj + 2 * f], sc[4 * jj + 2 * f + 1]);
      __syncthreads();
      ++t;
    }
    // the heads: warpgroup wg takes head 2m + wg; A = P from the score
    // tile, in registers, and B = its head's x.  Below the diagonal
    // (jt < rt) every j precedes every i, and exp(acum_i - acum_j) =
    // exp(acum_i - acum_ref) exp(acum_ref - acum_j) with both exponents
    // <= 0: P = S times the column factors, and the row factors scale the
    // stage's sums.  On the diagonal P = S o L_h, masked before the exp.
    const int j0 = jt * T;
    const bool diag = jt == rt;
#pragma unroll 1
    for (int m = 0; m < HW; ++m, ++t) {
      const bool more = t + 1 < nt;
      if (more) load(t + 1);
      const int hh = head_of(m);
      const float* dj = dec + ((t & 1) * 2 + wg) * DECN;
      const float* di = ai_s + hh * T;
      uint32_t a_hi[T / 8][4], a_lo[T / 8][4];
      auto put = [&](int kk, int r, float pv) {
        const float ph = tf32(pv);
        a_hi[kk][r] = __float_as_uint(ph);
        a_lo[kk][r] = __float_as_uint(tf32(pv - ph));
      };
      float rf[2] = {1.f, 1.f};
      if (diag) {
#pragma unroll
        for (int kk = 0; kk < T / 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = fr + 8 * (r & 1);
            const int col = 8 * kk + lane % 4 + 4 * (r / 2);
            const int i = i0 + row, j = j0 + col;
            // the mask before the exponential: __expf(-inf) = 0
            const float d = j <= i && i < s.q ? di[row] - dj[col]
                                              : -INFINITY;
            put(kk, r, s_tile[row * SROW + col] * __expf(d));
          }
      } else {
#pragma unroll
        for (int f = 0; f < 2; ++f)
          rf[f] = __expf(di[fr + 8 * f] - dj[2 * T]);
#pragma unroll
        for (int kk = 0; kk < T / 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = fr + 8 * (r & 1);
            const int col = 8 * kk + lane % 4 + 4 * (r / 2);
            put(kk, r, s_tile[row * SROW + col] * dj[T + col]);
          }
      }
      const uint32_t b_s = base + (t & 1) * STAGE + wg * 2 * TILE;
      const uint64_t b_hi = sw128_desc(b_s, 16, 1024);
      const uint64_t b_lo = sw128_desc(b_s + TILE, 16, 1024);
      fence_regs(hp);
#pragma unroll
      for (int kk = 0; kk < T / 8; ++kk) {
        fence_regs(a_hi[kk]);
        fence_regs(a_lo[kk]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < T / 8; ++kk) {
        const uint64_t o = ((kk / 4) * PANEL + (kk % 4) * 32) >> 4;
        wgmma_tf32_rs(hp, a_lo[kk], b_hi + o, kk > 0);
        wgmma_tf32_rs(hp, a_hi[kk], b_lo + o, 1);
        wgmma_tf32_rs(hp, a_hi[kk], b_hi + o, 1);
      }
      wg_commit();
      if (more) store(t + 1);
      wg_wait<0>();
      fence_regs(hp);
#pragma unroll
      for (int kk = 0; kk < T / 8; ++kk) {
        fence_regs(a_hi[kk]);
        fence_regs(a_lo[kk]);
      }
      if (2 * m + wg < nh) {
#pragma unroll
        for (int k = 0; k < HW; ++k)
          if (k == m)
#pragma unroll
            for (int i = 0; i < 32; ++i)
              acc[k][i] = fmaf(rf[(i >> 1) & 1], hp[i], acc[k][i]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < HW; ++m) {
    if (2 * m + wg >= nh) continue;
    float* yh = yg + (2 * m + wg) * qp;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int i = i0 + fr + 8 * f, pc = 8 * jj + fc;
        if (i >= s.q || pc >= s.p) continue;
        float* at = yh + (size_t)i * s.p + pc;
        if (pc + 1 < s.p && (s.p & 1) == 0)
          *reinterpret_cast<float2*>(at) =
              make_float2(acc[m][4 * jj + 2 * f], acc[m][4 * jj + 2 * f + 1]);
        else
          *at = acc[m][4 * jj + 2 * f];
      }
  }
}

template <int HW>
int launch(const Ssd& s, int groups, int bcn, cudaStream_t st) {
  auto kern = ssd_sm90_kernel<HW>;
  // the opt-in to the block's shared memory, once per instantiation (a
  // runtime call on every launch would cost host time)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (opt_in != cudaSuccess) return (int)opt_in;
  kern<<<dim3(groups, bcn, s.tiles), THREADS, SMEM, st>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers, stream a
// cudaStream_t; heads is the plan's heads a block (2 or 4), vec 1 when cc
// and bc may be read 16 bytes at a time (N % 4 == 0, both 16-byte aligned).
extern "C" int ssd_intra_launch(const float* cc, const float* bc,
                                const float* acum, const float* xd, float* y,
                                int bcn, int h, int q, int n, int p,
                                int heads, int vec, void* stream) {
  if (p > MAXP || p < 1 || n > MAXN || n < 1 || q < 1 || h < 1 ||
      bcn < 1 || (heads != 2 && heads != 4) || bcn > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (q + T - 1) / T;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  Ssd s{cc, bc, acum, xd, y, h, q, n, p, tiles, vec};
  const int groups = (h + heads - 1) / heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return heads == 2 ? launch<1>(s, groups, bcn, st)
                    : launch<2>(s, groups, bcn, st);
}

// The dynamic shared memory (bytes) of a launch.
extern "C" int ssd_intra_smem() { return SMEM; }
