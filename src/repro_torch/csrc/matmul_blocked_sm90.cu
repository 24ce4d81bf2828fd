// Blocked matmul with the fused matmul tail on Hopper's tensor cores: bf16
// operands, fp32 accumulator, for sm_90a.
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/matmul_blocked.py::matmul_pallas (body _mm_kernel, with
//   the tail of repro/core/epilogue.py::apply_matmul_epilogue) for bf16
//   operands of 64 rows or more: the MoE router of a prefill (M = tokens,
//   K = d_model, N = experts).
// Computes out = tail(a @ b) as matmul_blocked.cu does (the same tail, in
// the reference's order, on the fp32 sums; NEG_INF = -1e30; out fp32 or
// bf16), for a (M, K) and b (K, N) bf16, row-major, contiguous and 16-byte
// aligned, K and N multiples of 8 (TMA's 16-byte strides), N <= 512.  The
// product of two bf16 numbers is exact in fp32, so this is the fp32
// kernel's function up to the order of the sums: the reference's router
// computes x.astype(f32) @ router.astype(f32) on bf16 values.
//
// What bounds it on the H100: at arctic-480b's prefill router (M = 2,048,
// K = 7,168, N = 128) the work is 3.8 GFLOP on 31 MB of operands, about 120
// FLOP a byte, under the 295 at which the bf16 tensor cores (989 TFLOP/s)
// would bound it: the bytes do, 9.4 us at 3.35 TB/s.  So the design keeps
// the tensor cores fed and every SM loading:
// * One block per (64-row tile, K slice): the 32 row tiles of the prefill
//   alone would leave 100 SMs idle, so a cluster of CS blocks (up to 4,
//   blockIdx.x) splits each tile's K, and reduces the partials through
//   distributed shared memory in rank order: two launches on the same
//   inputs are bit-identical.
// * A producer warp (the block's last) streams k tiles of 64 through a
//   ring of 2-4 stages with TMA: per stage an a tile (64 x 64) and b's
//   64 x N rows as panels of 64 columns, each in TMA's 128-byte swizzle;
//   TMA fills rows past M and K and columns past N with zeros.  Full and
//   empty mbarriers pace the ring.
// * One consumer warpgroup (two for N > 256, each with half the panels)
//   issues wgmma m64nNk16 (N = 64 per panel it owns), A = the a tile read
//   K-major, B = the b panels read MN-major (the transpose bit; the
//   leading byte offset is the 8,192-byte stride to the next 64-column
//   panel, the stride byte offset the 1,024 bytes to the next 8 k rows, as
//   B3's P V).  The fp32 accumulator, 64 x N, stays in registers (at most
//   128 a thread); one group of products stays in flight while the next
//   stage's are issued.
// * Epilogue: once every block of the cluster has left its ring, the
//   consumers store each row of their partial (64, N) into the ring of the
//   block that finishes the row (block `rank` finishes rows [rank * 64 /
//   CS, (rank + 1) * 64 / CS)), in the slot of their own rank: remote
//   stores, no round trips.  After a second cluster barrier each block
//   sums its rows' CS slots in rank order, eight lanes a row, applies the
//   whole tail (the softmax by shuffles) and stores the rows.
//
// The C entry returns the launch's cudaError_t (a refused cluster launch
// included), 10000 + the CUresult of cuTensorMapEncodeTiled, 20000 when
// libcuda has no such encoder, or cudaErrorInvalidValue for a shape the
// kernel cannot take.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 64;                  // rows per block: one wgmma
constexpr int BK = 64;                  // k per stage: one 128-byte panel
constexpr int PANEL = 64;               // bf16 columns of a 128-byte row
constexpr int PANEL_BYTES = 64 * 128;   // 64 rows of 128 bytes
constexpr int NMAX = 512;
constexpr int CS_MAX = 4;
constexpr int SMEM_RING = 220 * 1024;
constexpr int ROW_LANES = 8;            // lanes that finish one row

// NC consumer warpgroups of PPC panels each.
template <int NC, int PPC> struct Cfg {
  static constexpr int NP = NC * PPC;                  // b panels per stage
  static constexpr int STAGE = PANEL_BYTES * (1 + NP);
  static constexpr int ST = SMEM_RING / STAGE < 4 ? SMEM_RING / STAGE : 4;
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int PSTRIDE = NP * PANEL + 8;       // floats a partial row
  static constexpr int BAR_OFF = ST * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * ST * 8 + 1024;
  static_assert(BM * PSTRIDE * 4 <= ST * STAGE, "partial fits the ring");
};

// d (64 x 64P fp32) += A (64 x 16, smem, K-major) * B (16 x 64P, smem,
// MN-major)
__device__ __forceinline__ void wgmma_tb(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : F32(d, 0)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tb(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : F32(d, 0), F32(d, 32)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tb(float (&d)[96], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " R96
      ", %96, %97, p, 1, 1, 0, 1;\n}\n"
      : F32(d, 0), F32(d, 32), F32(d, 64)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tb(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " R128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : F32(d, 0), F32(d, 32), F32(d, 64), F32(d, 96)
      : "l"(da), "l"(db), "r"(1));
}

template <typename TO, int NC, int PPC>
__global__ void __launch_bounds__(Cfg<NC, PPC>::THREADS, 1)
matmul_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   TO* __restrict__ out, int M, int K, int N, Tail tail) {
  using C = Cfg<NC, PPC>;
  constexpr int ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  float* part =
      reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));
  const uint32_t full = base + C::BAR_OFF, empty = full + 8 * ST;

  const int cs = gridDim.x;
  const uint32_t rank = cluster_rank();
  const int m0 = blockIdx.y * BM;
  const int kt_all = (K + BK - 1) / BK, kt_per = (kt_all + cs - 1) / cs;
  const int t_lo = min(kt_all, (int)rank * kt_per);
  const int nt = min(kt_all, t_lo + kt_per) - t_lo;
  // b panels that hold a column < N (the others are never loaded, and the
  // columns they would give are never stored)
  const int np_live = min(C::NP, (N + PANEL - 1) / PANEL);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[PPC * 32];                   // a consumer's 64 x 64 PPC sums
#pragma unroll
  for (int i = 0; i < PPC * 32; ++i) acc[i] = 0.f;
  if (warp == 4 * NC) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(empty + 8 * s, ((t / ST) & 1) ^ 1);
        const uint32_t st = base + s * C::STAGE, bar = full + 8 * s;
        const int k0 = (t_lo + t) * BK;
        mbar_expect_tx(bar, PANEL_BYTES * (1 + np_live));
        tma_load_2d(st, &ta, bar, k0, m0);
        for (int p = 0; p < np_live; ++p)
          tma_load_2d(st + PANEL_BYTES * (1 + p), &tb, bar, p * PANEL, k0);
      }
    }
  } else {
    // ---- consumer c: columns [c * PPC * 64, (c + 1) * PPC * 64) ----
    const int c = warp / 4;
    for (int t = 0; t < nt; ++t) {
      const int s = t % ST;
      mbar_wait(full + 8 * s, (t / ST) & 1);
      const uint32_t a_s = base + s * C::STAGE;
      const uint32_t b_s = a_s + PANEL_BYTES * (1 + c * PPC);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = sw128_desc(a_s + kk * 32, 16, 1024);
        const uint64_t db = sw128_desc(b_s + kk * 16 * 128, PANEL_BYTES, 1024);
        wgmma_tb(acc, da, db);
      }
      wg_commit();
      wg_wait<1>();                      // stage t - 1's products are done
      fence_regs(acc);
      if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % ST));
    }
    wg_wait<0>();
    fence_regs(acc);
  }
  // every block of the cluster is done with its ring, which now receives
  // the partials of the rows this block finishes
  cluster_sync();
  const int rows = BM / cs;              // rows each block finishes
  if (warp < 4 * NC) {
    // acc[4j + e] is row 16w + lane / 4 (+ 8 for e >= 2), column
    // 8j + 2 (lane % 4) + (e & 1) of this consumer's columns; row r goes
    // to block r / rows, into the slot of this block's rank
    const int c = warp / 4;
    const int col0 = c * PPC * PANEL + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (warp % 4) + lane / 4 + 8 * h;
      float* dst = map_rank(
          part + ((int)rank * rows + r % rows) * C::PSTRIDE + col0,
          r / rows);
#pragma unroll
      for (int j = 0; j < PPC * 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  cluster_sync();

  // block `rank` finishes rows [rank * rows, (rank + 1) * rows), a group
  // of ROW_LANES lanes a row, from the cs partials it received
  constexpr int GROUPS = C::THREADS / ROW_LANES;
  const int grp = threadIdx.x / ROW_LANES, gl = threadIdx.x % ROW_LANES;
  for (int i0 = 0; i0 < rows; i0 += GROUPS) {   // the same trips for all
    const int i = min(i0 + grp, rows - 1);
    const int row = m0 + (int)rank * rows + i;
    const bool live = i0 + grp < rows && row < M;
    finish_row<ROW_LANES>(part + i * C::PSTRIDE, rows * C::PSTRIDE, cs, row,
                          live ? N : 0, tail, out + (size_t)row * N, gl);
  }
}

// A 2-D map over a row-major (rows, cols) bf16 matrix, boxes of 64 x 64,
// 128-byte swizzle.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
           int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {PANEL, 64};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// Blocks along K: enough to fill the SMs, each with at least 4 k tiles.
int cluster_for(int m, int k) {
  const int tiles = (m + BM - 1) / BM, kt = (k + BK - 1) / BK;
  int cs = 1;
  while (cs < CS_MAX && tiles * cs * 2 <= 132 && kt >= 2 * cs * 4) cs *= 2;
  return cs;
}

template <typename TO, int NC, int PPC>
int launch(const void* a, const void* b, void* out, int m, int k, int n,
           Tail tail, cudaStream_t stream) {
  using C = Cfg<NC, PPC>;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return 20000;
  CUtensorMap ta, tb;
  int err = encode(fn, &ta, a, m, k);
  if (!err) err = encode(fn, &tb, b, k, n);
  if (err) return err;
  auto kern = matmul_sm90_kernel<TO, NC, PPC>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const int cs = cluster_for(m, k);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (m + BM - 1) / BM);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  ce = cudaLaunchKernelEx(&cfg, kern, ta, tb, static_cast<TO*>(out), m, k,
                          n, tail);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// N <= 256: one consumer of ceil(N / 64) panels; wider: two of half each.
template <typename TO>
int dispatch_n(const void* a, const void* b, void* out, int m, int k, int n,
               Tail tail, cudaStream_t st) {
  switch ((n + PANEL - 1) / PANEL) {
    case 1: return launch<TO, 1, 1>(a, b, out, m, k, n, tail, st);
    case 2: return launch<TO, 1, 2>(a, b, out, m, k, n, tail, st);
    case 3: return launch<TO, 1, 3>(a, b, out, m, k, n, tail, st);
    case 4: return launch<TO, 1, 4>(a, b, out, m, k, n, tail, st);
    case 5:
    case 6: return launch<TO, 2, 3>(a, b, out, m, k, n, tail, st);
    default: return launch<TO, 2, 4>(a, b, out, m, k, n, tail, st);
  }
}

}  // namespace

// a, b: bf16; out_dtype: 0 = float32, 1 = bfloat16.  Returns 0 or an
// error code (see the header).
extern "C" int matmul_sm90_launch(const void* a, const void* b, void* out,
                                  int out_dtype, int m, int k, int n,
                                  int has_scale, float scale, int causal,
                                  int softmax, int relu, int n_valid,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || k < 8 || n < 8 || k % 8 || n % 8 || n > NMAX)
    return (int)cudaErrorInvalidValue;
  const Tail tail{has_scale, scale, causal, softmax, relu, n_valid};
  if (out_dtype == 0)
    return dispatch_n<float>(a, b, out, m, k, n, tail, st);
  if (out_dtype == 1)
    return dispatch_n<__nv_bfloat16>(a, b, out, m, k, n, tail, st);
  return (int)cudaErrorInvalidValue;
}

// The cluster size (blocks along K) of a launch of shape (m, k).
extern "C" int matmul_sm90_cluster(int m, int k) { return cluster_for(m, k); }

// The dynamic shared memory of a launch with n columns (bytes).
extern "C" int matmul_sm90_smem(int n) {
  switch ((n + PANEL - 1) / PANEL) {
    case 1: return Cfg<1, 1>::SMEM;
    case 2: return Cfg<1, 2>::SMEM;
    case 3: return Cfg<1, 3>::SMEM;
    case 4: return Cfg<1, 4>::SMEM;
    case 5:
    case 6: return Cfg<2, 3>::SMEM;
    default: return Cfg<2, 4>::SMEM;
  }
}
