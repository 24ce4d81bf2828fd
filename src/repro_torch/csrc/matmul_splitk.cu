// Blocked matmul with the fused matmul tail at decode shapes (M < 64):
// split K across a thread-block cluster, for Hopper (sm_90a).
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/matmul_blocked.py::matmul_pallas (body _mm_kernel, with
//   the tail of repro/core/epilogue.py::apply_matmul_epilogue) for few rows:
//   the MoE router of a decode step (M = batch, K = d_model, N = experts).
// Computes out = tail(a @ b) as matmul_blocked.cu does (the same tail, in
// the reference's order, on the fp32 sums; NEG_INF = -1e30; out fp32 or
// bf16), for a (M, K) and b (K, N) row-major and contiguous, both fp32 or
// both bf16, 16-byte aligned, with N * sizeof(element) a multiple of 16,
// N <= 512 and K <= 16,384.  Any M; the wrapper sends M < 64.
//
// What bounds it on the H100: at arctic-480b's decode router (M = 1 or 4,
// K = 7,168, N = 128, bf16) the work is 2MKN <= 7.3 MFLOP on the 1.8 MB of
// b, so bytes bound it: 0.55 us at 3.35 TB/s.  No single SM can pull that
// rate, and a block per M tile (matmul_blocked.cu's split) puts the whole
// of b on one SM.  So K is split across the SMs:
// * A cluster of CL blocks (the cluster's size in blockIdx.x) shares one
//   tile of R <= 8 rows (blockIdx.y); block `rank` owns the K slice
//   [rank * kb, (rank + 1) * kb), kb = ceil(K / CL).  CL is 16 for K >=
//   1,024 while a launch has at most four tiles, so M = 4 is one cluster of
//   16 blocks; M = 63 is eight clusters of 8 (eight of 16 do not all fit on
//   the card at once).  Each cluster reads all of b, the later ones from
//   L2.
// * One thread streams the block's slice of b into a ring of four 32 KB
//   stages with bulk copies (cp.async.bulk, completing on an mbarrier), so
//   all of the slice is in flight at once without a register per byte.  The
//   block's slice of a (R x kb) is staged once as fp32, transposed.
// * Thread (column group cg, k lane kl) owns 8 columns and every KL-th row
//   of each stage, reading them with 16-byte shared-memory loads, and keeps
//   an R x 8 fp32 accumulator.  The KL lanes' partials are summed in lane
//   order through shared memory into the block's (R, N) partial.
// * The cluster reduces the partials through distributed shared memory,
//   with no workspace and no memset: each block stores its partial of row
//   i into the shared memory of block i % CL (the row's finisher), in the
//   slot of its own rank; one cluster barrier later the finisher sums the
//   CL slots in rank order, so two launches on the same inputs are
//   bit-identical, applies the whole tail on the full row (one warp a row,
//   the softmax by warp shuffles) and stores it.  Remote stores need no
//   round trip, so no block waits on another's shared memory.
//
// The C entry returns the launch's cudaError_t (a refused cluster launch
// included) or cudaErrorInvalidValue for a shape the kernel cannot take.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 8;                  // columns per thread
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = 32768;
constexpr int NMAX = 512;
constexpr int CL_MAX = 16;
constexpr int KB_MAX = 1024;            // rows of a block's K slice
constexpr int RMAX = 8;
constexpr int A_LOADS = 8;             // a loads in flight per thread

__device__ __forceinline__ void load8(const float* p, float (&v)[CPT],
                                      bool hi) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  if (hi) {
    const float4 y = *reinterpret_cast<const float4*>(p + 4);
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
    v[4] = v[5] = v[6] = v[7] = 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[CPT], bool) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Dynamic shared memory: the ring (after the K loop, the k lanes'
// partials), a's slice, the partials that the cluster's blocks send for
// the rows this block finishes (rank-major: cl of each row), the barriers.
struct Smem {
  int a_off, recv_off, bar_off, bytes;
};

__host__ __device__ inline Smem smem_layout(int r, int n, int kb, int cl) {
  Smem s;
  s.a_off = STAGES * STAGE_BYTES;
  s.recv_off = s.a_off + ((kb * r * 4 + 15) & ~15);
  s.bar_off = s.recv_off + cl * ((r + cl - 1) / cl) * n * 4;
  s.bytes = s.bar_off + STAGES * 8;
  return s;
}

template <typename T, typename TO, int R>
__global__ void __launch_bounds__(THREADS, 1)
matmul_splitk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     TO* __restrict__ out, int M, int K, int N, int kb,
                     Tail tail) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int cl = gridDim.x;
  const uint32_t rank = cluster_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * R;
  const int g = (N + CPT - 1) / CPT, kls = THREADS / g;
  const int cg = tid % g, kl = tid / g;
  const Smem lay = smem_layout(R, N, kb, cl);
  float* red = reinterpret_cast<float*>(smem);        // the ring, reused
  float* as = reinterpret_cast<float*>(smem + lay.a_off);
  float* recv = reinterpret_cast<float*>(smem + lay.recv_off);
  const uint32_t ring = smem_addr(smem), full = smem_addr(smem + lay.bar_off);

  const int k_lo = min(K, (int)rank * kb), k_hi = min(K, k_lo + kb);
  const int rows = k_hi - k_lo;
  const int row_bytes = N * (int)sizeof(T);
  const int ch = STAGE_BYTES / row_bytes;              // rows per stage
  const int chunks = (rows + ch - 1) / ch;
  auto issue = [&](int c) {
    const int r0 = k_lo + c * ch, nr = min(ch, k_hi - r0);
    const uint32_t bar = full + 8 * (c % STAGES);
    mbar_expect_tx(bar, nr * row_bytes);
    bulk_load(ring + (c % STAGES) * STAGE_BYTES, b + (size_t)r0 * N,
              nr * row_bytes, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
    for (int c = 0; c < min(STAGES, chunks); ++c) issue(c);
  }
  // a's slice, fp32, as[kk][i] for row m0 + i and column k_lo + kk; a
  // thread issues A_LOADS loads before it stores the first
  for (int e0 = 0; e0 < R * rows; e0 += A_LOADS * THREADS) {
    float v[A_LOADS];
#pragma unroll
    for (int u = 0; u < A_LOADS; ++u) {
      const int e = e0 + u * THREADS + tid, i = e / rows, kk = e % rows;
      v[u] = e < R * rows && m0 + i < M
                 ? to_f(a[(size_t)(m0 + i) * K + k_lo + kk])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < A_LOADS; ++u) {
      const int e = e0 + u * THREADS + tid;
      if (e < R * rows) as[(e % rows) * R + e / rows] = v[u];
    }
  }
  __syncthreads();
  cluster_arrive_relaxed();              // this block has started

  float acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  const bool active = kl < kls;
  // fp32 rows hold N % 8 == 4 columns in their last group
  const bool hi = (cg + 1) * CPT <= N;

  for (int c = 0; c < chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(full + 8 * s, (c / STAGES) & 1);
    const int nr = min(ch, k_hi - (k_lo + c * ch));
    const T* bs = reinterpret_cast<const T*>(smem + s * STAGE_BYTES);
    const float* ak = as + c * ch * R;
    if (active) {
      for (int rr = kl; rr < nr; rr += kls) {
        float bv[CPT];
        load8(bs + rr * N + cg * CPT, bv, hi);
        float av[R];
        if constexpr (R % 4 == 0) {
#pragma unroll
          for (int i = 0; i < R; i += 4) {
            const float4 x = *reinterpret_cast<const float4*>(ak + rr * R + i);
            av[i] = x.x; av[i + 1] = x.y; av[i + 2] = x.z; av[i + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < R; ++i) av[i] = ak[rr * R + i];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();                     // stage s is consumed
    if (tid == 0 && c + STAGES < chunks) issue(c + STAGES);
  }

  // the k lanes' partials, summed in lane order; row i's sum goes to the
  // block that finishes the row (rank i % cl), into its slot for this rank
  if (active) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CPT; j += 4)
        *reinterpret_cast<float4*>(red + (kl * R + i) * g * CPT + cg * CPT +
                                   j) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]);
  }
  __syncthreads();
  cluster_wait();                        // every block has started
  for (int e = tid; e < R * N; e += THREADS) {
    const int i = e / N, col = e % N;
    float x = 0.f;
    for (int l = 0; l < kls; ++l) x += red[(l * R + i) * g * CPT + col];
    *map_rank(recv + ((i / cl) * cl + rank) * N + col, i % cl) = x;
  }
  cluster_sync();

  // block `rank` finishes rows i = rank, rank + cl, ...; its j-th such
  // row goes to warp j % WARPS
  for (int i = rank, j = 0; i < R; i += cl, ++j) {
    if (j % WARPS == warp && m0 + i < M)
      finish_row<32>(recv + j * cl * N, N, cl, m0 + i, N, tail,
                     out + (size_t)(m0 + i) * N, lane);
  }
}

int rows_for(int m) { return m == 1 ? 1 : m == 2 ? 2 : m <= 4 ? 4 : RMAX; }

// Blocks along K: up to 16 while the clusters of one launch hold at most
// 64 blocks (more clusters of 16 do not all fit on the card at once and
// run in two waves), else up to 8; each block at least 64 rows of K.
int cluster_for(int m, int k) {
  const int tiles = (m + rows_for(m) - 1) / rows_for(m);
  const int cap = tiles * CL_MAX <= 64 ? CL_MAX : 8;
  int cl = 1;
  while (cl < cap && k >= 2 * cl * 64) cl *= 2;
  return cl;
}

template <typename T, typename TO, int R>
int launch(const void* a, const void* b, void* out, int m, int k, int n,
           Tail tail, cudaStream_t stream) {
  const int cl = cluster_for(m, k);
  const int kb = (k + cl - 1) / cl;
  if (kb > KB_MAX) return (int)cudaErrorInvalidValue;
  const Smem lay = smem_layout(R, n, kb, cl);
  auto kern = matmul_splitk_kernel<T, TO, R>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (ce == cudaSuccess && cl > 8)
    ce = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, (m + R - 1) / R);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  ce = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a),
                          static_cast<const T*>(b), static_cast<TO*>(out), m,
                          k, n, kb, tail);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int dispatch_rows(const void* a, const void* b, void* out, int m, int k,
                  int n, Tail tail, cudaStream_t st) {
  switch (rows_for(m)) {
    case 1: return launch<T, TO, 1>(a, b, out, m, k, n, tail, st);
    case 2: return launch<T, TO, 2>(a, b, out, m, k, n, tail, st);
    case 4: return launch<T, TO, 4>(a, b, out, m, k, n, tail, st);
    default: return launch<T, TO, RMAX>(a, b, out, m, k, n, tail, st);
  }
}

template <typename T>
int dispatch_out(int out_dtype, const void* a, const void* b, void* out,
                 int m, int k, int n, Tail tail, cudaStream_t st) {
  if (out_dtype == 0)
    return dispatch_rows<T, float>(a, b, out, m, k, n, tail, st);
  if (out_dtype == 1)
    return dispatch_rows<T, __nv_bfloat16>(a, b, out, m, k, n, tail, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t.
extern "C" int matmul_splitk_launch(const void* a, const void* b, void* out,
                                    int in_dtype, int out_dtype, int m, int k,
                                    int n, int has_scale, float scale,
                                    int causal, int softmax, int relu,
                                    int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elt = in_dtype == 0 ? 4 : 2;
  if (m < 1 || k < 1 || n < 1 || n > NMAX || (n * elt) % 16 ||
      k > CL_MAX * KB_MAX)
    return (int)cudaErrorInvalidValue;
  const Tail tail{has_scale, scale, causal, softmax, relu, n_valid};
  if (in_dtype == 0)
    return dispatch_out<float>(out_dtype, a, b, out, m, k, n, tail, st);
  if (in_dtype == 1)
    return dispatch_out<__nv_bfloat16>(out_dtype, a, b, out, m, k, n, tail,
                                       st);
  return (int)cudaErrorInvalidValue;
}

// The cluster size (blocks along K) of a launch of shape (m, k).
extern "C" int matmul_splitk_cluster(int m, int k) {
  return cluster_for(m, k);
}
