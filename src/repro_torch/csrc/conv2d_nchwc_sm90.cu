// Blocked convolution in NCHW[x]c with the fused conv_block epilogue, on
// Hopper's tensor cores: an implicit GEMM in 3xTF32 on wgmma, for sm_90a.
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/conv2d_nchwc.py::conv2d_nchwc_pallas (body _conv_kernel).
// It computes what that kernel computes, on the same tensors:
//   x     (N, CI, HP, WP, ICB)       input, already padded by the caller
//   w     (KO, CI, KH, KW, ICB, OCB) weight, KCRS[x]c[y]k
//   scale (KO, OCB), shift (KO, OCB) optional per-channel affine
//   res   (N, KO, OH, OW, OCB)       optional residual, at conv resolution
//   buf   (N, TOTC, PH, PW, OCB)     optional concat buffer
//   out   (N, KO or TOTC, PH, PW, OCB), a new tensor
// acc = sum over (ci, kh, kw, ic) in fp32, then in the reference's order
// (repro/kernels/ops.py::apply_epilogue_fp32): * scale, + shift, + residual,
// ReLU, pool, and the store at a channel offset into the concat buffer.
// Output chunks outside [off, off + KO) copy the buffer through, as the TPU
// kernel's grid does (conv2d_nchwc.py:82-85).  The TPU kernel's tile knobs
// (ow_bn, oh_bn, unroll_ker) have no meaning here.
//
// What bounds it on the H100: ResNet-50's batch-1 predict is 8.17 GFLOP of
// conv, on at most a few MB per layer, so operations bound it.  On the fp32
// FMA units (67 TFLOP/s) that is 0.124 ms; tf32 wgmma runs at 495 TFLOP/s,
// but one TF32 product keeps 11 of fp32's 24 significant bits.  So each
// fp32 operand a is split into hi = tf32(a) (cvt.rna) and lo = tf32(a - hi),
// and the block accumulates lo*hi + hi*lo + hi*hi in fp32 (3xTF32: the
// dropped lo*lo term is ~2^-22 of the product): three wgmmas per k step,
// 3 * 8.17 GFLOP / 495 TFLOP/s = 0.0496 ms per predict.  At batch 1 the
// layers are small (7x7 layers: M = 49 output pixels), so filling 132 SMs
// and the fixed cost of each launch set much of the time.
//
// Design.
// * Implicit GEMM: M = output pixels (across images: n, oh, ow), N = output
//   channels (ko, oc), K = (ci, dh, dw, ic) in the weight's own order.  A
//   block owns BM = 64 rows and BN = 64 columns (any OCB: a column's chunk
//   and lane are computed per column, so OCB = 512 is eight blocks), with
//   two warpgroups, each on 32 of the columns (m64n32k8).  Both gather,
//   split and store every stage: at batch 1 an SM holds one block, and
//   with one warpgroup the SM waited on each thread's chain of address,
//   split and store work.
// * The pixel offsets of the tile's 64 rows (in x, in out and in the
//   residual) go into tables in shared memory once per tile, so neither
//   the gather nor the epilogue divides per row.
// * No im2col tensor: the k offsets into x of the block's K range go into a
//   table in shared memory once; each A element is then x[pix(m) + koff(k)],
//   any stride, any ICB.  ICB % 4 == 0 loads 16 bytes at a time; the RGB
//   stem (ICB = 3, K = 147) loads 4 bytes at a time and pads K to a
//   multiple of 32 with zeros in shared memory.
// * wgmma takes tf32 operands from shared memory K-major only, so every
//   stage is staged by the threads themselves, not by TMA: A (64 pixels x
//   32 k) as loaded, B transposed from the weight's N-major (ic, oc) rows
//   to (oc, 32 k), each split into hi and lo on the way, stored 16 bytes at
//   a time in the 128-byte swizzle that sw128_desc describes.  Two stages
//   in shared memory and two tiles in registers: the global loads of tile
//   t + 2 are in flight while tile t's 12 wgmmas (4 k steps of 8 x 3
//   products) run and tile t + 1 (loaded a step earlier) is split and
//   stored.
// * The tensor cores add into their fp32 accumulator rounding toward zero,
//   so a sum over 3 * K / 8 wgmmas drifts toward 0: 1e-4 relative at
//   K = 4,608, and 4e-5 of ResNet-50's logits after 53 layers, against a
//   tolerance of 1e-5.  So each stage's 12 wgmmas start from zero and the
//   stage sums meet in registers, rounded to nearest.
// * Split K over a thread-block cluster where the output tiles alone would
//   leave most SMs idle (a 7x7 layer at batch 1 has 16 or fewer): the CS
//   blocks of a cluster (up to 8) take consecutive K slices, and each
//   stores its partial rows into the shared memory of the block that
//   finishes them, in the slot of its rank; that block sums the CS slots in
//   rank order.  No atomics, no workspace: two launches are bit-identical.
// * Epilogue on the fp32 sums: affine, residual, ReLU and the store, from
//   shared memory, a warp to 32 neighbouring channels of one pixel.
// * Fused pooling without recomputing each pooled output's window (which
//   costs 2.25x the conv work at the stem): a block owns a patch of PPH x
//   PPW pooled outputs (8 x 8), computes the conv window under it, CH x CW
//   = ((PPH - 1) * ps + pk) x ((PPW - 1) * ps + pk) conv pixels (17 x 17
//   at the stem), as ceil(CH * CW / 64) sub-tiles of 64 rows, into a patch
//   in shared memory, and pools from there: taps outside [0, OH) x [0, OW) are
//   padding, -inf for max and 0 for avg, the avg divides by pk * pk, as
//   repro_torch/core/epilogue.py::pool2d has it.  Neighbouring patches
//   share one conv row and column of the stem (1.11x its conv values, 1.25x
//   its wgmma rows); the conv-resolution tensor never reaches device
//   memory.
//
// The wide route (conv_sm90_kernel_wide): the unpooled convs at large M.
// At batch 32 the 64 x 64 tile above runs at a third of what 3xTF32
// allows: each of its m64n32k8 wgmmas reads 3 KB of shared memory for 16 K
// MACs, and the threads write every stage's A and B split into hi and lo,
// so shared memory (128 bytes a clock) needs about twice the tensor cores'
// time; and every stage ends with the whole block waiting on its wgmmas
// and a barrier.  The wide loop is bound by the tensor cores: at 1,024
// tf32 MACs a clock an SM, a stage's 24 m64n128k8 wgmmas take ~1,540
// clocks, and its shared-memory traffic (B read by the wgmmas 96 KB,
// written by TMA 32 KB) ~1,000.
// * A block owns 128 rows (two warpgroups of 64) and BN = 128 columns (64
//   where N is 64, or where the grid at 128 would leave SMs idle: the
//   wrapper's plan decides), wgmma m64nBNk8 with A in registers.  No
//   producer warp: with 8 warps a thread may have 255 registers (a ninth
//   warp caps them at 168, and the 128-column loop spilled there).
// * A never passes through shared memory.  Each thread loads its own A
//   values of a stage, two rows x 8 k, straight from x into registers
//   (icb % 32 == 0, so a stage's 32 k lie in one tap), two stages ahead:
//   16-byte loads, a warp's four lanes of a row on 64 neighbouring bytes.
//   It splits them into hi and lo there.  (Staged by one producer warp's
//   cp.async, A took longer to arrive than the products took to run.)
// * The weight is split once, by the wrapper, when a weight tensor first
//   takes this route (kernels/conv2d_nchwc.py::split_weight): hi and lo of
//   each column's K in a row of its own (K-major, what wgmma reads), each
//   stage's 32 k reordered so that slot j of k step kk holds
//   k = 16 (kk / 2) + 4 (j % 4) + 2 (kk % 2) + j / 4, the thread's own A
//   values in the order they load.  One thread has TMA load B's hi and lo
//   into a ring of 6 stages, 4 ahead; full and empty mbarriers pace it.
// * Each stage's 12 products a warpgroup (lo*hi, hi*lo, hi*hi for each k
//   step) start from zero and meet the fp32 sums in registers, rounded to
//   nearest, every 32 of K, as above.  The two warpgroups take turns to
//   issue a stage (two named barriers), so one sums its stage and splits
//   the next while the other's products run; no barrier spans the block
//   in the loop.
// * Epilogue straight from the registers: scale, shift, residual, ReLU,
//   two neighbouring channels of a row at a time, then the concat's
//   copy-through.  No atomics: two launches are bit-identical.
//
// The launch's plan (the route, the cluster size, the pooled patch, the
// wide tile) comes from the wrapper (kernels/conv2d_nchwc.py::launch_plan),
// which the CPU tests reach.  The C entry returns the launch's
// cudaError_t, 10000 + the CUresult of cuTensorMapEncodeTiled, 20000 when
// libcuda has no such encoder, or cudaErrorInvalidValue for a plan the
// kernel cannot take.

#include <math.h>
#include <string.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;          // GEMM rows per (sub-)tile: one wgmma's M
constexpr int BN = 64;          // GEMM columns per block
constexpr int BK = 32;          // k per stage: one 128-byte row of fp32
constexpr int WGS = 2;          // warpgroups, each on BN / WGS columns
constexpr int WN = BN / WGS;    // one wgmma's N
constexpr int THREADS = 128 * WGS;
constexpr int CS_MAX = 8;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have

constexpr int A_BYTES = BM * 128;        // an A tile, hi or lo
constexpr int B_BYTES = BN * 128;        // a B tile, hi or lo
constexpr int STAGE = 2 * A_BYTES + 2 * B_BYTES;
constexpr int RING = 2 * STAGE;
constexpr int ROWS_BYTES = 3 * BM * 4;   // the row tables
constexpr int PSTRIDE = BN + 4;          // floats a staged row
constexpr int A_CPT = BM * 8 / THREADS;  // 16-byte A chunks a thread, a stage
constexpr int B_CPT = BN * 8 / THREADS;  // and B chunks
constexpr int ROW_STEP = THREADS / 8;    // rows between a thread's A chunks
constexpr int KQ_STEP = THREADS / BN;    // chunks between its B chunks
static_assert(BM * PSTRIDE * 4 <= RING, "the partials fit the ring");
static_assert(STAGE % 1024 == 0 && WN * 128 % 1024 == 0, "swizzle atoms");

struct Conv {
  const float* __restrict__ x;
  const float* __restrict__ w;
  const float* __restrict__ scale;
  const float* __restrict__ shift;
  const float* __restrict__ res;
  const float* __restrict__ buf;
  float* __restrict__ out;
  int n, ci, hp, wp, icb;       // input
  int ko, kh, kw, ocb;          // weight
  int stride, oh, ow;           // conv output (conv resolution)
  int out_chunks, ph, pw;       // stored output
  int off_chunks;               // concat: first output chunk this conv owns
  int relu;
  int pool_kind;                // 0 none, 1 max, 2 avg
  int pool_k, pool_stride, pool_pad;
  int ktot, ncols, mrows;       // the GEMM's K and N; M (no pool)
  int kt_per;                   // k tiles of each cluster rank
  int pph, ppw, ch, cw, npr, npc;   // pooled patch, its conv window, counts
  int table_off, patch_off;     // shared-memory byte offsets
};

struct Pix {
  int n, oh, ow;
  bool ok;
};

// The conv pixel of row `row` of this block's M space: a pixel index
// across images, or, pooled, a position in the patch's conv window.
template <bool POOL>
__device__ __forceinline__ Pix pixel_of(const Conv& p, int row) {
  Pix px;
  if (!POOL) {
    const int m = blockIdx.z * BM + row;
    const int hw = p.oh * p.ow;
    px.ok = m < p.mrows;
    px.n = m / hw;
    const int r = m - px.n * hw;
    px.oh = r / p.ow;
    px.ow = r - px.oh * p.ow;
  } else {
    const int patch = blockIdx.z;
    const int per = p.npr * p.npc;
    px.n = patch / per;
    const int rem = patch - px.n * per;
    const int pr = rem / p.npc, pc = rem - pr * p.npc;
    const int lr = row / p.cw, lc = row - lr * p.cw;
    px.oh = pr * p.pph * p.pool_stride - p.pool_pad + lr;
    px.ow = pc * p.ppw * p.pool_stride - p.pool_pad + lc;
    px.ok = row < p.ch * p.cw && px.oh >= 0 && px.oh < p.oh && px.ow >= 0 &&
            px.ow < p.ow;
  }
  return px;
}

// The per-channel operands of the epilogue at column col: its scale and
// shift (1 and 0 where absent), and its offset in out (unpooled) and in the
// residual apart from the pixel's.
struct Col {
  float scale, shift;
  int off;
  bool ok;
};

__device__ __forceinline__ Col column_of(const Conv& p, int col) {
  Col c{1.f, 0.f, 0, col < p.ncols};
  if (!c.ok) return c;
  if (p.scale) c.scale = __ldg(p.scale + col);
  if (p.shift) c.shift = __ldg(p.shift + col);
  const int k = col / p.ocb;
  c.off = k * p.oh * p.ow * p.ocb + (col - k * p.ocb);
  return c;
}

// scale, shift, residual (r), ReLU on one fp32 sum, in the reference's
// order.  The operands come loaded: a load after a store through another
// pointer would wait for it, row after row.
__device__ __forceinline__ float epilogue(const Conv& p, float v,
                                          const Col& c, float r) {
  if (p.scale) v = v * c.scale;
  if (p.shift) v = v + c.shift;
  if (p.res) v = v + r;
  if (p.relu) v = fmaxf(v, 0.f);
  return v;
}

// concat: the chunks of the buffer that this conv does not own, copied
// through by every block of the grid (of `threads` threads), a share each
__device__ __forceinline__ void copy_through(const Conv& p, int threads) {
  const long long plane = (long long)p.ph * p.pw * p.ocb;
  const int others = p.out_chunks - p.ko;
  const long long total = (long long)p.n * others * plane;
  const long long blocks = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long b = blockIdx.x + gridDim.x * (blockIdx.y +
                                                (long long)gridDim.y *
                                                    blockIdx.z);
  for (long long i = b * threads + threadIdx.x; i < total;
       i += blocks * threads) {
    const long long e = i % plane, rest = i / plane;
    const int cj = (int)(rest % others), nn = (int)(rest / others);
    const int chunk = cj < p.off_chunks ? cj : cj + p.ko;
    const long long at = ((long long)nn * p.out_chunks + chunk) * plane + e;
    p.out[at] = p.buf[at];
  }
}

template <int VEC, bool POOL>
__global__ void __launch_bounds__(THREADS, 1)
conv_sm90_kernel(const __grid_constant__ Conv p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  float* part = reinterpret_cast<float*>(sm);    // the ring, once drained
  // per row of the (sub-)tile: its pixel's offset in x, in out (unpooled)
  // and in the residual, apart from the channel's; -1 for no pixel
  int* xrow = reinterpret_cast<int*>(sm + RING);
  int* orow = xrow + BM;
  int* rrow = orow + BM;
  int* koff = reinterpret_cast<int*>(sm + p.table_off);
  float* patch = reinterpret_cast<float*>(sm + p.patch_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128;              // columns [wg * WN, wg * WN + WN)
  const int cs = gridDim.x;
  const uint32_t rank = cs > 1 ? cluster_rank() : 0;

  // this rank's K slice, and the k offsets into x of its k range (-1 past
  // K: zeros in shared memory)
  const int kt_all = (p.ktot + BK - 1) / BK;
  const int t_lo = min(kt_all, (int)rank * p.kt_per);
  const int nt = min(kt_all, t_lo + p.kt_per) - t_lo;
  const int k_lo = t_lo * BK;
  for (int i = tid; i < nt * BK; i += THREADS) {
    const int k = k_lo + i;
    int off = -1;
    if (k < p.ktot) {
      const int tap = k / p.icb, ic = k - tap * p.icb;
      const int c = tap / (p.kh * p.kw), r = tap - c * (p.kh * p.kw);
      const int dh = r / p.kw, dw = r - dh * p.kw;
      off = ((c * p.hp + dh) * p.wp + dw) * p.icb + ic;
    }
    koff[i] = off;
  }

  // B: this thread's column, and chunks bq0 + KQ_STEP * j of each stage
  const int n0 = blockIdx.y * BN;
  const int bc = tid % BN, bq0 = tid / BN;
  const bool bcol_ok = n0 + bc < p.ncols;
  const float* wcol =
      p.w + (bcol_ok ? (size_t)((n0 + bc) / p.ocb) * p.ktot * p.ocb +
                           (n0 + bc) % p.ocb
                     : 0);
  // A: chunk aq of rows ar0 + ROW_STEP * i
  const int aq = tid % 8, ar0 = tid / 8;

  // pooled: the epilogue operands of this thread's 8 fragment columns
  Col fcol[POOL ? WN / 4 : 1];
  if constexpr (POOL) {
#pragma unroll
    for (int i = 0; i < WN / 4; ++i)
      fcol[i] = column_of(p, n0 + wg * WN + 8 * (i / 2) + 2 * (lane % 4) +
                                 (i & 1));
  }
  const int nsub = POOL ? (p.ch * p.cw + BM - 1) / BM : 1;
  float acc[WN / 2];                     // the fp32 sums, rounded to nearest
  float part_acc[WN / 2];                // one stage's, on the tensor cores
  for (int sub = 0; sub < nsub; ++sub) {
    if (tid < BM) {
      const Pix px = pixel_of<POOL>(p, sub * BM + tid);
      const int hw = px.oh * p.ow + px.ow;
      xrow[tid] = px.ok ? ((px.n * p.ci * p.hp + px.oh * p.stride) * p.wp +
                           px.ow * p.stride) * p.icb
                        : -1;
      orow[tid] = px.ok ? ((px.n * p.out_chunks + p.off_chunks) * p.oh *
                           p.ow + hw) * p.ocb
                        : -1;
      rrow[tid] = px.ok ? (px.n * p.ko * p.oh * p.ow + hw) * p.ocb : -1;
    }
    __syncthreads();                     // the tables are written
    int pix[A_CPT];
#pragma unroll
    for (int i = 0; i < A_CPT; ++i) pix[i] = xrow[ar0 + ROW_STEP * i];
    // two register sets, tiles t and t + 1 of the K loop: a tile's loads
    // are in flight for a whole step before its split and store
    float4 ra0[A_CPT], rb0[B_CPT], ra1[A_CPT], rb1[B_CPT];
    auto gload = [&](int t, float4 (&ra)[A_CPT], float4 (&rb)[B_CPT]) {
      const int kb = t * BK;             // into koff
#pragma unroll
      for (int i = 0; i < A_CPT; ++i) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (pix[i] >= 0) {
          if (VEC == 4) {
            const int o = koff[kb + 4 * aq];
            if (o >= 0)
              v = __ldg(reinterpret_cast<const float4*>(p.x + pix[i] + o));
          } else {
            const int* ko4 = koff + kb + 4 * aq;
            if (ko4[0] >= 0) v.x = __ldg(p.x + pix[i] + ko4[0]);
            if (ko4[1] >= 0) v.y = __ldg(p.x + pix[i] + ko4[1]);
            if (ko4[2] >= 0) v.z = __ldg(p.x + pix[i] + ko4[2]);
            if (ko4[3] >= 0) v.w = __ldg(p.x + pix[i] + ko4[3]);
          }
        }
        ra[i] = v;
      }
#pragma unroll
      for (int j = 0; j < B_CPT; ++j) {
        const int k = k_lo + kb + 4 * (bq0 + KQ_STEP * j);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (bcol_ok) {
          const float* wk = wcol + (size_t)k * p.ocb;
          if (k < p.ktot) v.x = __ldg(wk);
          if (k + 1 < p.ktot) v.y = __ldg(wk + p.ocb);
          if (k + 2 < p.ktot) v.z = __ldg(wk + 2 * p.ocb);
          if (k + 3 < p.ktot) v.w = __ldg(wk + 3 * p.ocb);
        }
        rb[j] = v;
      }
    };
    auto sstore = [&](int s, const float4 (&ra)[A_CPT],
                      const float4 (&rb)[B_CPT]) {
      uint8_t* st = sm + s * STAGE;
      float4 hi, lo;
#pragma unroll
      for (int i = 0; i < A_CPT; ++i) {
        const int off = sw128(ar0 + ROW_STEP * i, aq);
        split(ra[i], hi, lo);
        *reinterpret_cast<float4*>(st + off) = hi;
        *reinterpret_cast<float4*>(st + A_BYTES + off) = lo;
      }
#pragma unroll
      for (int j = 0; j < B_CPT; ++j) {
        const int off = 2 * A_BYTES + sw128(bc, bq0 + KQ_STEP * j);
        split(rb[j], hi, lo);
        *reinterpret_cast<float4*>(st + off) = hi;
        *reinterpret_cast<float4*>(st + B_BYTES + off) = lo;
      }
      fence_async_smem();                // visible to the wgmmas' proxy
    };

    // step t: the wgmmas of stage t & 1 (tile t), the loads of tile t + 2
    // into the set that held tile t, and the split and store of tile t + 1
    // (loaded a step ago) into the other stage, whose wgmmas (tile t - 1)
    // are done
    auto step = [&](int t, float4 (&ra_t)[A_CPT], float4 (&rb_t)[B_CPT],
                    const float4 (&ra_n)[A_CPT],
                    const float4 (&rb_n)[B_CPT]) {
      const int s = t & 1;
      if (t + 2 < nt) gload(t + 2, ra_t, rb_t);
      const uint32_t a_s = base + s * STAGE;
      const uint32_t b_s = a_s + 2 * A_BYTES + wg * WN * 128;
      fence_regs(part_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t a_hi = sw128_desc(a_s + kk * 32, 16, 1024);
        const uint64_t a_lo = sw128_desc(a_s + A_BYTES + kk * 32, 16, 1024);
        const uint64_t b_hi = sw128_desc(b_s + kk * 32, 16, 1024);
        const uint64_t b_lo = sw128_desc(b_s + B_BYTES + kk * 32, 16, 1024);
        wgmma_tf32(part_acc, a_lo, b_hi, kk > 0);
        wgmma_tf32(part_acc, a_hi, b_lo, 1);
        wgmma_tf32(part_acc, a_hi, b_hi, 1);
      }
      wg_commit();
      if (t + 1 < nt) sstore(s ^ 1, ra_n, rb_n);
      wg_wait<0>();
      fence_regs(part_acc);
      // the tensor cores' fp32 sums round toward zero, so a long K would
      // drift toward 0 (~1e-4 relative at K = 4,608): each stage's 12
      // products start afresh, and the stages meet here, rounded to nearest
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] += part_acc[i];
      __syncthreads();
    };

#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    if (nt > 0) {
      gload(0, ra0, rb0);
      if (nt > 1) gload(1, ra1, rb1);
      sstore(0, ra0, rb0);
    }
    __syncthreads();
    for (int t = 0; t < nt; t += 2) {
      step(t, ra0, rb0, ra1, rb1);
      if (t + 1 < nt) step(t + 1, ra1, rb1, ra0, rb0);
    }

    if constexpr (POOL) {
      // this sub-tile's conv values, epilogue up to ReLU, into the patch;
      // acc[4j + e] is row 16 (warp % 4) + lane / 4 (+ 8 for e >= 2),
      // column wg * WN + 8j + 2 (lane % 4) + (e & 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (warp % 4) + lane / 4 + 8 * h;
        if (rrow[r] < 0) continue;
        float res[WN / 4];               // the residual, all loads first
#pragma unroll
        for (int i = 0; i < WN / 4; ++i)
          res[i] = p.res && fcol[i].ok ? __ldg(p.res + rrow[r] + fcol[i].off)
                                       : 0.f;
#pragma unroll
        for (int j = 0; j < WN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            patch[(sub * BM + r) * PSTRIDE + wg * WN + 8 * j +
                  2 * (lane % 4) + e] =
                epilogue(p, acc[4 * j + 2 * h + e], fcol[2 * j + e],
                         res[2 * j + e]);
      }
      __syncthreads();                   // before the tables are rewritten
    }
  }

  const int bcol = n0 + bc;
  const int bk = bcol / p.ocb, boc = bcol - bk * p.ocb;
  if constexpr (POOL) {
    // pool the patch: pooled output (pr, pc) of the patch, channel bc
    const int patch_i = blockIdx.z;
    const int per = p.npr * p.npc;
    const int n = patch_i / per, rem = patch_i - n * per;
    const int gr0 = (rem / p.npc) * p.pph, gc0 = (rem % p.npc) * p.ppw;
    const int ch0 = gr0 * p.pool_stride - p.pool_pad;
    const int cw0 = gc0 * p.pool_stride - p.pool_pad;
    const bool is_max = p.pool_kind == 1;
    for (int pp = bq0; pp < p.pph * p.ppw; pp += KQ_STEP) {
      const int pr = pp / p.ppw, pc = pp - pr * p.ppw;
      if (gr0 + pr >= p.ph || gc0 + pc >= p.pw || !bcol_ok) continue;
      float v = is_max ? -INFINITY : 0.f;
      for (int dh = 0; dh < p.pool_k; ++dh) {
        const int lr = pr * p.pool_stride + dh;
        if (ch0 + lr < 0 || ch0 + lr >= p.oh) continue;
        for (int dw = 0; dw < p.pool_k; ++dw) {
          const int lc = pc * p.pool_stride + dw;
          if (cw0 + lc < 0 || cw0 + lc >= p.ow) continue;
          const float u = patch[(lr * p.cw + lc) * PSTRIDE + bc];
          v = is_max ? fmaxf(v, u) : v + u;
        }
      }
      if (!is_max) v = v / (float)(p.pool_k * p.pool_k);
      p.out[(((size_t)n * p.out_chunks + p.off_chunks + bk) * p.ph + gr0 +
             pr) * p.pw * p.ocb + (size_t)(gc0 + pc) * p.ocb + boc] = v;
    }
  } else {
    // every block of the cluster has drained its ring, which now receives
    // the partials of the rows this block finishes: row r goes to block
    // r / rows, into the slot of this block's rank
    if (cs > 1) cluster_sync(); else __syncthreads();
    const int rows = BM / cs;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (warp % 4) + lane / 4 + 8 * h;
      float* dst = part + ((int)rank * rows + r % rows) * PSTRIDE + wg * WN +
                   2 * (lane % 4);
      if (cs > 1) dst = map_rank(dst, r / rows);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    if (cs > 1) cluster_sync(); else __syncthreads();
    // block `rank` finishes rows [rank * rows, (rank + 1) * rows), its
    // threads on neighbouring channels of one pixel, U rows at a time: the
    // residual loads of U rows are in flight together
    constexpr int U = 4;
    const Col cc = column_of(p, bcol);
    for (int i0 = bq0; i0 < rows; i0 += KQ_STEP * U) {
      float v[U], r[U];
      int at[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + KQ_STEP * u;
        const int row = (int)rank * rows + i;
        at[u] = -1;
        v[u] = r[u] = 0.f;
        if (i >= rows || !cc.ok || orow[row] < 0) continue;
        v[u] = part[i * PSTRIDE + bc];
        for (int q = 1; q < cs; ++q)
          v[u] += part[(q * rows + i) * PSTRIDE + bc];
        if (p.res) r[u] = __ldg(p.res + rrow[row] + cc.off);
        at[u] = orow[row] + cc.off;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (at[u] >= 0) p.out[at[u]] = epilogue(p, v[u], cc, r[u]);
    }
  }

  if (p.out_chunks != p.ko) copy_through(p, THREADS);
}

// ---- the wide route --------------------------------------------------------

constexpr int WBM = 128;                 // rows a block: two warpgroups of 64
constexpr int WST = 6;                   // B's stages in the ring
constexpr int WLA = WST - 2;             // stages B is loaded ahead
constexpr int WPF = 2;                   // stages A is loaded ahead
constexpr int WTHREADS = 2 * 128;        // two consumer warpgroups
constexpr int PANEL = 64;                // B rows of one TMA box
constexpr int EMPTY_ARRIVALS = 8;        // a lane of each warp
constexpr int TURN0 = 1, TURN1 = 2;      // named barriers: a warpgroup's turn

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int BN>
struct Wide {
  static constexpr int B_BYTES = BN * 128;            // B's hi, or its lo
  static constexpr int STAGE = 2 * B_BYTES;
  static constexpr int BAR_OFF = WST * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * WST * 8 + 1024;
  static_assert(B_BYTES % 1024 == 0, "swizzle atoms");
};

template <int BN>
__global__ void __launch_bounds__(WTHREADS, 1)
conv_sm90_kernel_wide(const __grid_constant__ Conv p,
                      const __grid_constant__ CUtensorMap tb) {
  using W = Wide<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + W::BAR_OFF, empty = full + 8 * WST;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;               // rows [64 wg, 64 wg + 64)
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * WBM;
  const int nt = p.ktot / BK;
  const int hw = p.oh * p.ow;
  const int live = min(BN / PANEL, (p.ncols - n0 + PANEL - 1) / PANEL);
  // B of stage t, hi and lo, into its slot by TMA: the panels that hold a
  // column < N
  auto load_b = [&](int t) {
    const uint32_t st = base + (t % WST) * W::STAGE;
    const uint32_t bar = full + 8 * (t % WST);
    mbar_expect_tx(bar, 2 * live * PANEL * 128);
    for (int h = 0; h < 2; ++h)
      for (int pn = 0; pn < live; ++pn)
        tma_load_3d(st + h * W::B_BYTES + pn * PANEL * 128, &tb, bar, t * BK,
                    n0 + pn * PANEL, h);
  };
  if (tid == 0) {
    for (int s = 0; s < WST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, EMPTY_ARRIVALS);
    }
    mbar_init_fence();
    for (int t = 0; t < min(WLA, nt); ++t) load_b(t);
  }
  __syncthreads();

  // This thread's rows r0 and r0 + 8, and its k of each stage: 4 c4 .. +3
  // and 16 + 4 c4 .. +3, as slot c4 (a[0], a[1]) and c4 + 4 (a[2], a[3])
  // of its k steps (kernels/conv2d_nchwc.py::WIDE_K_ORDER)
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int c4 = lane % 4;
  int xrow[2];                           // the rows' offsets in x; -1 past M
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    const int n = m / hw, r = m - n * hw, oh = r / p.ow, ow = r - oh * p.ow;
    xrow[h] = m < p.mrows ? ((n * p.ci * p.hp + oh * p.stride) * p.wp +
                             ow * p.stride) * p.icb + 4 * c4
                          : -1;
  }
  // A of the next stage to load, from x straight into registers: its 32 k
  // lie in one tap (ci, dh, dw) from channel ic (icb % 32 == 0)
  int ic = 0, dw = 0, dh = 0, ci = 0;
  auto load_a = [&](float4 (&a)[4]) {
    const int koff = ((ci * p.hp + dh) * p.wp + dw) * p.icb + ic;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        a[2 * h + e] = xrow[h] >= 0
                           ? __ldg(reinterpret_cast<const float4*>(
                                 p.x + xrow[h] + koff + 16 * e))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    ic += BK;
    if (ic == p.icb) {
      ic = 0;
      if (++dw == p.kw) {
        dw = 0;
        if (++dh == p.kh) {
          dh = 0;
          ++ci;
        }
      }
    }
  };

  float acc[BN / 2];                     // the fp32 sums, rounded to nearest
  float part[BN / 2];                    // one stage's, on the tensor cores
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float4 ra[WPF][4];                     // A of stages t .. t + WPF - 1
#pragma unroll
  for (int j = 0; j < WPF; ++j)
    if (j < nt) load_a(ra[j]);
  // the warpgroups take turns to issue a stage's products, so that one
  // sums its stage and splits the next while the other's run
  if (wg == 1) bar_arrive(TURN0, WTHREADS);

  auto step = [&](int t, float4 (&cur)[4]) {
    const int s = t % WST;
    // k step kk: row r0's values in a[0] (slot c4) and a[2] (slot c4 + 4),
    // row r0 + 8's in a[1] and a[3]
    uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float4 u = cur[kk / 2], v = cur[2 + kk / 2];
      const float f[4] = {kk & 1 ? u.z : u.x, kk & 1 ? v.z : v.x,
                          kk & 1 ? u.w : u.y, kk & 1 ? v.w : v.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32(f[e]);
        ahi[kk][e] = __float_as_uint(hi);
        alo[kk][e] = __float_as_uint(tf32(f[e] - hi));
      }
    }
    if (t + WPF < nt) load_a(cur);
    mbar_wait(full + 8 * s, (t / WST) & 1);
    bar_sync(wg == 0 ? TURN0 : TURN1, WTHREADS);
    const uint32_t b_s = base + s * W::STAGE;
    fence_regs(part);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t b_hi = sw128_desc(b_s + kk * 32, 16, 1024);
      const uint64_t b_lo = sw128_desc(b_s + W::B_BYTES + kk * 32, 16, 1024);
      wgmma_tf32_rs(part, alo[kk], b_hi, kk > 0);
      wgmma_tf32_rs(part, ahi[kk], b_lo, 1);
      wgmma_tf32_rs(part, ahi[kk], b_hi, 1);
    }
    wg_commit();
    if (wg == 0 || t + 1 < nt) bar_arrive(wg == 0 ? TURN1 : TURN0, WTHREADS);
    // B of stage t + WLA, into the slot of stage t - 2: warpgroup 1 has
    // issued stage t - 1 (its turn came before this one), so it is done
    // with stage t - 2
    if (tid == 0 && t + WLA < nt) {
      if (t + WLA >= WST)
        mbar_wait(empty + 8 * ((t + WLA) % WST),
                  (((t + WLA) / WST) & 1) ^ 1);
      load_b(t + WLA);
    }
    wg_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      fence_regs(ahi[kk]);
      fence_regs(alo[kk]);
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);
    // the stage's 12 products summed on the tensor cores (toward zero),
    // the stages here, rounded to nearest
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  };
  for (int t0 = 0; t0 < nt; t0 += WPF)
#pragma unroll
    for (int j = 0; j < WPF; ++j)
      if (t0 + j < nt) step(t0 + j, ra[j]);

  // epilogue: acc[4j + e] is row r0 (+ 8 for e >= 2), column
  // n0 + 8j + 2 c4 + (e & 1); a group of 8 columns lies in one chunk
  // (ocb % 8 == 0)
  int orow[2], rrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    const int n = m / hw, r = m - n * hw;
    orow[h] = m < p.mrows
                  ? ((n * p.out_chunks + p.off_chunks) * hw + r) * p.ocb
                  : -1;
    rrow[h] = (n * p.ko * hw + r) * p.ocb;
  }
  int coff[BN / 8];                      // column 8j + 2 c4's offset
  {
    const int col = n0 + 2 * c4;
    int kc = col / p.ocb, oc = col - kc * p.ocb;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      coff[j] = kc * hw * p.ocb + oc;
      oc += 8;
      if (oc >= p.ocb) {
        oc -= p.ocb;
        ++kc;
      }
    }
  }
  float2 res[2][BN / 8];                 // the residual, all loads first
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      res[h][j] = make_float2(0.f, 0.f);
      if (p.res && orow[h] >= 0 && n0 + 8 * j + 2 * c4 < p.ncols)
        res[h][j] = __ldg(
            reinterpret_cast<const float2*>(p.res + rrow[h] + coff[j]));
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * c4;
    if (col >= p.ncols) continue;
    Col c0{1.f, 0.f, 0, true}, c1{1.f, 0.f, 0, true};
    if (p.scale) {
      c0.scale = __ldg(p.scale + col);
      c1.scale = __ldg(p.scale + col + 1);
    }
    if (p.shift) {
      c0.shift = __ldg(p.shift + col);
      c1.shift = __ldg(p.shift + col + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (orow[h] < 0) continue;
      *reinterpret_cast<float2*>(p.out + orow[h] + coff[j]) = make_float2(
          epilogue(p, acc[4 * j + 2 * h], c0, res[h][j].x),
          epilogue(p, acc[4 * j + 2 * h + 1], c1, res[h][j].y));
    }
  }
  if (p.out_chunks != p.ko) copy_through(p, WTHREADS);
}

int round16(int b) { return (b + 15) / 16 * 16; }

// The dynamic shared memory of a launch: the ring of two stages, the k
// offset table of kt_per k tiles, and (pooled) the patch of ch x cw conv
// pixels; plus the slack that aligns the ring to 1,024 bytes.
int smem_bytes(int kt_per, int patch_rows, int* table_off, int* patch_off) {
  *table_off = RING + ROWS_BYTES;
  *patch_off = *table_off + round16(kt_per * BK * 4);
  return *patch_off + patch_rows * PSTRIDE * 4 + 1024;
}

template <int VEC, bool POOL>
int launch(const Conv& p, int cs, int tiles_m, int smem, cudaStream_t st) {
  auto kern = conv_sm90_kernel<VEC, POOL>;
  // the opt-in to the most shared memory a block may have, once per
  // instantiation (a driver call on every launch would cost host time)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(cs, (p.ncols + BN - 1) / BN, tiles_m);
  if (cs == 1) {                       // no cluster: the plain launch
    kern<<<grid, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t ce = cudaLaunchKernelEx(&cfg, kern, p);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// A 3-D map over the split weight (2, ncols, ktot) fp32 (hi, then lo; K
// innermost), boxes of 32 k x 64 columns x 1, 128-byte swizzle; columns
// past ncols read as zeros.
int encode_wide(EncodeTiled fn, CUtensorMap* map, const float* b, int ncols,
                int ktot) {
  const cuuint64_t dims[3] = {(cuuint64_t)ktot, (cuuint64_t)ncols, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)ktot * 4,
                                 (cuuint64_t)ktot * ncols * 4};
  const cuuint32_t box[3] = {BK, PANEL, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(b), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int BN>
int launch_wide(const Conv& p, const CUtensorMap& tb, cudaStream_t st) {
  auto kern = conv_sm90_kernel_wide<BN>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Wide<BN>::SMEM);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((p.ncols + BN - 1) / BN, (p.mrows + WBM - 1) / WBM);
  kern<<<grid, WTHREADS, Wide<BN>::SMEM, st>>>(p, tb);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers (scale, shift, res
// and buf may be null); stream is a cudaStream_t.  geo holds 26 ints (the
// wrapper keeps one array per shape): n, ci, hp, wp, icb, ko, kh, kw, ocb,
// stride, oh, ow, out_chunks, ph, pw, off_chunks, relu, pool_kind, pool_k,
// pool_stride, pool_pad, and the launch plan: vec (16- or 4-byte loads of
// x; 16 needs ICB % 4 == 0 and x 16-byte aligned), cs (the cluster size
// along K: 1, 2, 4 or 8; 1 when pooled), pph and ppw (the pooled patch),
// wide (0, or the wide route's tile width BN: 64 or 128).  On the wide
// route w is the split weight (2, ncols, ktot) and wide_map the 128 bytes
// that conv2d_sm90_wide_map encoded for it; else wide_map is null.
// Returns the launch's cudaError_t (0 on success); the wrapper validates
// every shape.
extern "C" int conv2d_sm90_launch(const float* x, const float* w,
                                  const float* scale, const float* shift,
                                  const float* res, const float* buf,
                                  float* out, const int* geo,
                                  const void* wide_map, void* stream) {
  const int n = geo[0], ci = geo[1], hp = geo[2], wp = geo[3], icb = geo[4];
  const int ko = geo[5], kh = geo[6], kw = geo[7], ocb = geo[8];
  const int stride = geo[9], oh = geo[10], ow = geo[11];
  const int out_chunks = geo[12], ph = geo[13], pw = geo[14];
  const int off_chunks = geo[15], relu = geo[16], pool_kind = geo[17];
  const int pool_k = geo[18], pool_stride = geo[19], pool_pad = geo[20];
  const int vec = geo[21], cs = geo[22], pph = geo[23], ppw = geo[24];
  const int wide = geo[25];
  const bool pool = pool_kind != 0;
  if ((vec != 1 && vec != 4) || cs < 1 || cs > CS_MAX || (cs & (cs - 1)) ||
      (pool && cs != 1) || (vec == 4 && icb % 4) ||
      (pool && (pph < 1 || ppw < 1)))
    return (int)cudaErrorInvalidValue;
  if (wide && (pool || cs != 1 || vec != 4 || icb % BK || ocb % 8 ||
               (wide != 64 && wide != 128) || wide_map == nullptr))
    return (int)cudaErrorInvalidValue;
  Conv p{x, w, scale, shift, res, buf, out,
         n, ci, hp, wp, icb, ko, kh, kw, ocb, stride, oh, ow,
         out_chunks, ph, pw, off_chunks, relu, pool_kind,
         pool_k, pool_stride, pool_pad};
  p.ktot = ci * kh * kw * icb;
  p.ncols = ko * ocb;
  p.mrows = n * oh * ow;
  const int kt_all = (p.ktot + BK - 1) / BK;
  p.kt_per = (kt_all + cs - 1) / cs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    if (p.mrows == 0 || p.ncols == 0) return 0;
    if ((p.mrows + WBM - 1) / WBM > 65535) return (int)cudaErrorInvalidValue;
    alignas(64) CUtensorMap map;
    memcpy(&map, wide_map, sizeof map);
    return wide == 128 ? launch_wide<128>(p, map, st)
                       : launch_wide<64>(p, map, st);
  }
  int tiles_m;
  if (pool) {
    p.pph = pph;
    p.ppw = ppw;
    p.ch = (pph - 1) * pool_stride + pool_k;
    p.cw = (ppw - 1) * pool_stride + pool_k;
    p.npr = (ph + pph - 1) / pph;
    p.npc = (pw + ppw - 1) / ppw;
    tiles_m = n * p.npr * p.npc;
  } else {
    p.pph = p.ppw = p.ch = p.cw = p.npr = p.npc = 0;
    tiles_m = (p.mrows + BM - 1) / BM;
  }
  if (tiles_m == 0 || p.ncols == 0) return 0;
  if (tiles_m > 65535) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(p.kt_per, pool ? p.ch * p.cw : 0,
                              &p.table_off, &p.patch_off);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (pool)
    return vec == 4 ? launch<4, true>(p, cs, tiles_m, smem, st)
                    : launch<1, true>(p, cs, tiles_m, smem, st);
  return vec == 4 ? launch<4, false>(p, cs, tiles_m, smem, st)
                  : launch<1, false>(p, cs, tiles_m, smem, st);
}

// The dynamic shared memory (bytes) of a launch of kt_per k tiles a rank
// and a pooled patch of patch_rows conv pixels (0 unpooled).
extern "C" int conv2d_sm90_smem(int kt_per, int patch_rows) {
  int t, q;
  return smem_bytes(kt_per, patch_rows, &t, &q);
}

// The dynamic shared memory (bytes) of a wide launch of tile width bn (64 or
// 128): the ring of 6 stages of B's hi and lo, its barriers, and the slack
// that aligns the ring to 1,024 bytes.
extern "C" int conv2d_sm90_wide_smem(int bn) {
  return bn == 128 ? Wide<128>::SMEM : bn == 64 ? Wide<64>::SMEM : -1;
}

// Encodes into out (128 bytes of host memory) the tensor map of the wide
// route's split weight b (2, ncols, ktot) fp32, device memory, 16-byte
// aligned, ktot % 4 == 0.  Returns 0, 10000 + the CUresult of the encoder,
// or 20000 when libcuda has none.
extern "C" int conv2d_sm90_wide_map(const float* b, int ncols, int ktot,
                                    void* out) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return 20000;
  alignas(64) CUtensorMap map;
  const int err = encode_wide(fn, &map, b, ncols, ktot);
  if (!err) memcpy(out, &map, sizeof map);
  return err;
}
