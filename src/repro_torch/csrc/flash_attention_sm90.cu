// Forward attention with an online softmax (flash attention) on Hopper's
// tensor cores: bf16 in, fp32 softmax and accumulator, for sm_90a.
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/flash_attention.py::flash_attention_pallas (body
//   _attn_kernel) for bf16 tensors, and computes what repro/models/lm/
//   layers.py::flash_attention_xla computes, on the same tensors:
//   q (B, HQ, S, D), k and v (B, HKV, SK, D), contiguous bf16; o (B, HQ,
//   S, D) bf16.  SK != S is cross-attention (keys of another sequence;
//   the Pallas kernel asserts SK == S); the masks take absolute positions
//   from 0 on both sides.  GQA: query head h reads kv head h / (HQ / HKV); K and V are
//   never repeated.  Scale 1/sqrt(D) with the real D, causal and
//   local-window band masks, masked scores set to NEG_INF = -1e30 (never
//   -inf), the denominator clamped at 1e-30, fp32 statistics and
//   accumulator.  Any S and SK; D any multiple of 16 from 16 to 256.  fp32
//   tensors take the FMA kernel of flash_attention.cu.
//
// What bounds it on the H100: the two products, 4 * B * HQ * D * S^2 / 2
// FLOP under the causal mask, against the bytes of q, k, v and o read or
// written once: at qwen2-1.5b's prefill (D = 128, S = 2,048) some 1,000
// FLOP a byte, so the bf16 tensor cores (989 TFLOP/s) and not the memory
// (3.35 TB/s) bound it.  Behind them come the softmax's exponentials (one
// per score, 16 a clock on an SM's special-function units against 2,048
// multiply-adds a clock on its tensor cores) and keeping the tensor cores
// fed from shared memory.
//
// Design (the FlashAttention-3 shape):
// * One block per (q tile of BQ = 128 rows, q head, batch), 384 threads:
//   warpgroup 0 is the producer, which gives up registers (setmaxnreg 24)
//   and whose one thread issues TMA copies; warpgroups 1 and 2 are
//   consumers (setmaxnreg 240) of 64 q rows each.  blockIdx.y runs the q
//   tiles from the last, so the heaviest causal tiles start first, and
//   blockIdx.x the heads, so a GQA group's blocks start together.
// * Q is copied once.  K and V tiles of BK rows (128 for D <= 128, 64
//   above) go through a ring of two stages, each operand with a full
//   barrier (TMA completes its bytes there) and an empty barrier that the
//   256 consumer threads arrive at; K is loaded one tile ahead of V, as
//   the consumers read them.  The tensor maps are 3-D (D, S, B*H), so TMA
//   fills rows past S and columns past D with zeros.  A row of a tile is
//   stored as D / 64 panels of 64 columns (128 bytes), each in TMA's
//   128-byte swizzle, which is the layout wgmma's descriptors read.
// * S = Q K^T: wgmma m64nBKk16, A = Q and B = K both from shared memory,
//   both K-major.  Padded columns of q and k add 0 to every score.
// * O += P V: P is rounded to bf16 in registers and is wgmma's register A
//   operand (the accumulator layout of S is the A layout of the next
//   product); B = V read MN-major (the transpose bit), one m64n128k16 per
//   two 64-column panels.  The accumulator is 64 x D fp32 in registers.
// * A consumer's step t issues S(t) and P(t-1) V(t-1) as one turn on the
//   tensor cores, waits for S(t) only, and runs tile t's softmax while
//   P(t-1) V(t-1) is still in flight.  Named barriers pass the turn
//   between the two consumers, so one's softmax (its exponentials are
//   what the special-function units bound) overlaps the other's products.
// * The online softmax runs on the accumulator fragments: a thread holds
//   pieces of rows r and r + 8 of its warp's 16, and the row max reduces
//   over the four threads of a quad; the row sum is kept per thread and
//   reduced once at the end.  Scores are taken in base 2 (ex2.approx of
//   score * scale * log2 e), with the same m / l / alpha recurrence and
//   ascending kv order as flash_attention.cu and the references.  Masks
//   apply only on tiles that cross the diagonal, the window's edge or SK.
//   Tiles wholly above the diagonal or left of the window (for the whole
//   q tile) are never loaded, as the Pallas kernel skips them; a tile
//   that the mask empties for one consumer's 64 rows is still computed
//   by it, since a wgmma on a branch is serialized, and adds exactly
//   nothing (or only what the first real score wipes out).
// * Epilogue: multiply by 1 / max(l, 1e-30), round to bf16, store rows
//   < S and columns < D.
//
// The C entry returns the launch's cudaError_t, or 10000 + the CUresult of
// cuTensorMapEncodeTiled, or 20000 when libcuda has no such encoder.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 128;        // q rows per block: two consumers of 64
constexpr int PANEL = 64;      // bf16 columns of one 128-byte swizzle row
constexpr int ROW_BYTES = 128;
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;

template <int DP> struct Cfg {   // DP: the head dim padded to a multiple of 64
  static constexpr int BK = DP <= 128 ? 128 : 64;
  static constexpr int NP = DP / PANEL;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;   // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 9 * 8 + 1024;   // + 1024-B alignment
};

// ---- wgmma and named barriers ---------------------------------------------

// Named barriers 1 and 2 pass the tensor cores' turn between the two
// consumer warpgroups: the one whose turn it is syncs, the other arrives.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");
}

// d (64 x N fp32) = (acc ? d : 0) + A (64 x 16, smem) * B (16 x N, smem),
// both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(d, 0)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F32(d, 0), F32(d, 32)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem),
// B MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// The same over 128 columns, d0 the first 64 and d1 the next: B is two
// MN-major panels, the leading byte offset apart.
__device__ __forceinline__ void wgmma_rs_tb(float (&d0)[32],
                                            float (&d1)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(d0, 0), F32(d1, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- the consumer's steps --------------------------------------------------

// S = Q K^T for one consumer: 64 q rows (from row r0 of the q tile) against
// a K tile of BK rows, D / 16 wgmmas, both operands K-major panels.
template <int DP, int BK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t q_s,
                                        uint32_t ks, int r0) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // k16 step in the panel
    const uint64_t da = sw128_desc(
        q_s + (kk / 4) * BQ * ROW_BYTES + r0 * ROW_BYTES + off, 16, 1024);
    const uint64_t db =
        sw128_desc(ks + (kk / 4) * BK * ROW_BYTES + off, 16, 1024);
    wgmma_ss(sc, da, db, kk > 0);
  }
  wg_commit();
}

// O += P V: P (64 x BK, bf16 registers) times a V tile read MN-major, one
// m64n128k16 per pair of 64-column panels (and an m64n64k16 for an odd
// last panel) and k16 step.  Within a panel the 8-row groups of k are
// 1,024 bytes apart.
template <int NP, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[NP][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t v0 = vs + kk * 16 * ROW_BYTES;
#pragma unroll
    for (int p = 0; p + 1 < NP; p += 2) {
      const uint64_t db = sw128_desc(v0 + p * BK * ROW_BYTES,
                                     BK * ROW_BYTES, 1024);
      wgmma_rs_tb(acc[p], acc[p + 1], pa[kk], db);
    }
    if constexpr (NP % 2 == 1) {
      const uint64_t db =
          sw128_desc(v0 + (NP - 1) * BK * ROW_BYTES, 1024, 1024);
      wgmma_rs_tb(acc[NP - 1], pa[kk], db);
    }
  }
  wg_commit();
}

// The online softmax's first half on S's fragments, in base 2: sc[4j + e]
// is row qa (e < 2) or qa + 8, column k0 + 8j + cq + (e & 1).  Masks,
// takes the new row maxima (over the quad), leaves exp2(score - max) in
// sc, updates l, and returns each row's alpha = exp2(old max - new max).
// A tile of 128 keys with no mask folds the scale into the exponent's
// FFMA: each of its rows has a real maximum.  A masked tile scales first,
// so that a row it masks wholly gets exp2(NEG_INF - NEG_INF) = 1 exactly,
// as in the references.  (With BK = 64, for D > 128, the fold measured
// slower on the H100, so those tiles always scale first.)
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], float& m0, float& m1, float& l0, float& l1,
    float& al0, float& al1, bool masked, int k0, int qa, int cq, int sk,
    int causal, int window, float scale_log2) {
  const bool fold = BK == 128 && !masked;
  float mx0 = NEG_INF, mx1 = NEG_INF;
  if (!fold) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int kp = k0 + 8 * j + cq + (e & 1);
          const int qp = e < 2 ? qa : qa + 8;
          bool ok = kp < sk;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && qp - kp < window;
          x = ok ? x : NEG_INF;
        }
        sc[4 * j + e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
  } else {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = quad_max(mx0) * scale_log2;
    mx1 = quad_max(mx1) * scale_log2;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = ex2(m0 - mn0);
  al1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  // exp2(x * a - b): a = scale_log2 and b = the max, or a = 1 for scores
  // already scaled
  const float a = fold ? scale_log2 : 1.f;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * j + e], a, e < 2 ? -mn0 : -mn1));
      sc[4 * j + e] = p;
      if (e < 2)
        ps0 += p;
      else
        ps1 += p;
    }
  }
  l0 = l0 * al0 + ps0;
  l1 = l1 * al1 + ps1;
}

// The second half, once no product reads O or P: rescale O by alpha and
// round P to bf16 in the layout of wgmma's register A operand.
template <int NP, int BK>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[NP][32],
                                                 uint32_t (&pa)[BK / 16][4],
                                                 const float (&sc)[BK / 2],
                                                 float al0, float al1) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] *= (i & 2) ? al1 : al0;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
}

template <int NP, int BK>
__device__ __forceinline__ void fence_all(float (&sc)[BK / 2],
                                          float (&acc)[NP][32],
                                          uint32_t (&pa)[BK / 16][4]) {
  fence_regs(sc);
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
}

// ---- the kernel -----------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, int hq, int hkv, int s,
                 int sk, int d, int causal, int window, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK, NP = C::NP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t q_s = base, k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  // barriers: q_full; k_full[2]; v_full[2]; k_empty[2]; v_empty[2]
  const uint32_t q_full = base + C::BAR_OFF;
  const uint32_t k_full = q_full + 8, v_full = q_full + 24,
                 k_empty = q_full + 40, v_empty = q_full + 56;

  const int bh = blockIdx.x;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // kv tiles this q tile needs: up to its last row (causal), from the
  // first key its first row's window reaches (the wrapper keeps at least
  // one tile: a window comes with SK >= S)
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  const int t_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = (k_end + BK - 1) / BK - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, CONSUMERS);
      mbar_init(v_empty + 8 * st, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full, K one tile ahead of
    // V (a consumer's step t reads K(t) and V(t - 1)) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load_3d(q_s + p * BQ * ROW_BYTES, &tq, q_full, p * PANEL, q0, bh);
      for (int t = 0; t <= n_tiles; ++t) {
        if (t < n_tiles) {
          const int st = t & 1;
          if (t >= 2) mbar_wait(k_empty + 8 * st, ((t >> 1) & 1) ^ 1);
          mbar_expect_tx(k_full + 8 * st, C::KV_BYTES);
          for (int p = 0; p < NP; ++p)
            tma_load_3d(k_s + st * C::KV_BYTES + p * BK * ROW_BYTES, &tk,
                     k_full + 8 * st, p * PANEL, (t_lo + t) * BK, kvh);
        }
        if (t >= 1) {
          const int u = t - 1, st = u & 1;
          if (u >= 2) mbar_wait(v_empty + 8 * st, ((u >> 1) & 1) ^ 1);
          mbar_expect_tx(v_full + 8 * st, C::KV_BYTES);
          for (int p = 0; p < NP; ++p)
            tma_load_3d(v_s + st * C::KV_BYTES + p * BK * ROW_BYTES, &tv,
                     v_full + 8 * st, p * PANEL, (t_lo + u) * BK, kvh);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup.  Step t issues S(t) =
    // Q K(t)^T and O += P(t-1) V(t-1) as one turn on the tensor cores,
    // then runs tile t's softmax while P(t-1) V(t-1) is still in flight;
    // the first step has no P V and the last (t = n_tiles) only P V.
    // Named barriers 1 and 2 pass the turn between the two consumers, so
    // one's softmax overlaps the other's products.  No wgmma sits on a
    // branch, so none is serialized: every tile is computed, also one
    // that the mask empties for a consumer's 64 rows (it adds exactly
    // nothing, or only what the first real score wipes out) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int r_lo = q0 + cw * 64, r_hi = r_lo + 63;
    const int qa = r_lo + warp * 16 + (lane >> 2), qb = qa + 8;
    const int cq = 2 * (lane & 3);    // column of this thread in 8

    float acc[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    uint32_t pa[BK / 16][4];          // P of the previous tile, bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = 0u;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, al0, al1;
    // whether tile k0's scores need the mask for this consumer's rows
    auto masked = [&](int k0) {
      return (causal && k0 + BK - 1 > r_lo) ||
             (window > 0 && r_hi - k0 >= window) || k0 + BK > sk;
    };

    if (cw == 1) named_arrive(1);     // consumer 0 takes the first turn
    mbar_wait(q_full, 0);

    // step 0: S(0) only
    mbar_wait(k_full, 0);
    named_sync(1 + cw);
    fence_all<NP, BK>(sc, acc, pa);
    wg_fence();
    issue_s<DP, BK>(sc, q_s, k_s, cw * 64);
    named_arrive(2 - cw);
    wg_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty);
    softmax_tile<BK>(sc, m0, m1, l0, l1, al0, al1, masked(t_lo * BK),
                     t_lo * BK, qa, cq, sk, causal, window, scale_log2);
    rescale_and_pack<NP, BK>(acc, pa, sc, al0, al1);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t & 1, pst = (t - 1) & 1;
      const int k0 = (t_lo + t) * BK;
      mbar_wait(k_full + 8 * st, (t >> 1) & 1);
      mbar_wait(v_full + 8 * pst, ((t - 1) >> 1) & 1);
      named_sync(1 + cw);             // this consumer's turn
      fence_all<NP, BK>(sc, acc, pa);
      wg_fence();
      issue_s<DP, BK>(sc, q_s, k_s + st * C::KV_BYTES, cw * 64);
      issue_pv<NP, BK>(acc, pa, v_s + pst * C::KV_BYTES);
      named_arrive(2 - cw);           // the other consumer's turn
      wg_wait<1>();                   // S(t) is done, P(t-1) V(t-1) runs on
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * st);
      softmax_tile<BK>(sc, m0, m1, l0, l1, al0, al1, masked(k0), k0, qa, cq,
                       sk, causal, window, scale_log2);
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(v_empty + 8 * pst);
      rescale_and_pack<NP, BK>(acc, pa, sc, al0, al1);
    }

    // step n_tiles: P V of the last tile (consumer 1 hands no turn back
    // after it, so that every arrival meets a wait)
    {
      const int pst = (n_tiles - 1) & 1;
      mbar_wait(v_full + 8 * pst, ((n_tiles - 1) >> 1) & 1);
      named_sync(1 + cw);
      fence_all<NP, BK>(sc, acc, pa);
      wg_fence();
      issue_pv<NP, BK>(acc, pa, v_s + pst * C::KV_BYTES);
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      mbar_arrive(v_empty + 8 * pst);
      if (cw == 0) named_arrive(2);
    }

    // epilogue: rows < S, columns < D
    const float i0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
    const float i1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
    __nv_bfloat16* ob = o + (size_t)bh * s * d;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * PANEL + 8 * j + cq;
        if (col < d) {
          if (qa < s)
            *reinterpret_cast<uint32_t*>(ob + (size_t)qa * d + col) =
                pack_bf16(acc[p][4 * j] * i0, acc[p][4 * j + 1] * i0);
          if (qb < s)
            *reinterpret_cast<uint32_t*>(ob + (size_t)qb * d + col) =
                pack_bf16(acc[p][4 * j + 2] * i1, acc[p][4 * j + 3] * i1);
        }
      }
    }
  }
}

// ---- host -----------------------------------------------------------------

// A 3-D map over a (B*H, S, D) bf16 tensor, boxes of 64 columns x rows.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int bh, int s,
           int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {PANEL, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int sk, int d, int causal, int window,
           cudaStream_t stream) {
  using C = Cfg<DP>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return 20000;
  CUtensorMap tq, tk, tv;
  int err = encode(fn, &tq, q, b * hq, s, d, BQ);
  if (!err) err = encode(fn, &tk, k, b * hkv, sk, d, C::BK);
  if (!err) err = encode(fn, &tv, v, b * hkv, sk, d, C::BK);
  if (err) return err;
  auto kern = attn_sm90_kernel<DP>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(b * hq, (s + BQ - 1) / BQ);
  kern<<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq, hkv, s, sk, d, causal,
      window, LOG2E / sqrtf((float)d));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16, 16-byte aligned; d a multiple of 16 in
// [16, 256].  Returns 0 or an error code (see the header).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int hq, int hkv, int s, int sk,
                                           int d, int causal, int window,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 16 || d > 256 || d % 16) return (int)cudaErrorInvalidValue;
  // every q tile needs a kv tile (n_tiles >= 1 in the kernel)
  if (sk < 1 || (window > 0 && sk < s)) return (int)cudaErrorInvalidValue;
  switch ((d + PANEL - 1) / PANEL) {
    case 1:
      return launch<64>(q, k, v, o, b, hq, hkv, s, sk, d, causal, window, st);
    case 2:
      return launch<128>(q, k, v, o, b, hq, hkv, s, sk, d, causal, window, st);
    case 3:
      return launch<192>(q, k, v, o, b, hq, hkv, s, sk, d, causal, window, st);
    default:
      return launch<256>(q, k, v, o, b, hq, hkv, s, sk, d, causal, window, st);
  }
}

// The dynamic shared memory a launch at head dim d asks for (bytes).
extern "C" int flash_attention_sm90_smem(int d) {
  switch ((d + PANEL - 1) / PANEL) {
    case 1: return Cfg<64>::SMEM;
    case 2: return Cfg<128>::SMEM;
    case 3: return Cfg<192>::SMEM;
    default: return Cfg<256>::SMEM;
  }
}
