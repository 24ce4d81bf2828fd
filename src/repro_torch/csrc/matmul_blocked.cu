// Blocked matmul with the fused matmul tail (scale, causal mask, n_valid
// column mask, row softmax, ReLU), for Hopper (sm_90a).
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/matmul_blocked.py::matmul_pallas (body _mm_kernel, with
//   the tail of repro/core/epilogue.py::apply_matmul_epilogue), and its
//   padding wrapper matmul_padded, which the kernel makes unnecessary.
// Computes out = tail(a @ b) for a (M, K) and b (K, N), both row-major and
// contiguous, fp32 or bf16 (one type for both), converted to fp32 as they
// are loaded; fp32 accumulation; out (M, N) fp32 or bf16.  The tail, in the
// reference's order, on the fp32 sums:
//   x *= scale;                        (has_scale)
//   x = row >= col ? x : NEG_INF;      (causal, absolute coordinates)
//   x = col < n_valid ? x : NEG_INF;   (softmax only, as in the reference)
//   x = softmax over the row;          (max-subtracted, sum clamped at 1e-30)
//   x = max(x, 0);                     (relu)
// NEG_INF is -1e30 (never -inf).  Any M, K, N: the ragged edges are masked
// here, where the Pallas kernel needs operands padded to its blocks.
//
// Work split.  The Pallas grid (M/bm, N/bn, K/bk) carries the accumulator
// across its sequential k axis and holds a softmax row in one N-block.
// Here one thread block owns BM = 16 whole rows and walks them in column
// tiles of BN = 128; inside a tile it loops over K in slices of BK = 32,
// staged in shared memory (a transposed, so that the two rows of a warp are
// one broadcast load; b as read) with the next slice prefetched into
// registers.  Warp w owns rows 2w and 2w+1 of the tile, lane l owns columns
// 4l..4l+3, so each thread keeps a 2 x 4 fp32 accumulator in registers and
// a row's 128 columns live in one warp.  Without a softmax the tail is
// applied and the tile is stored.  With one, the block writes the masked,
// scaled fp32 logits of each column tile (into out when out is fp32, else
// into a scratch of the wrapper's) and keeps each row's running max and
// exp-sum, rescaled as the max grows, through warp shuffles; a second sweep
// in the same block then normalises.  Each thread reads back only what it
// wrote itself, so the sweep needs no barrier and no (BM x N) tile has to
// fit shared memory: any N works.
//
// What bounds it on the H100: at the MoE router's prefill shape (M = 2048
// tokens, K = 7168, N = 128 experts, fp32) the work is 2MKN = 3.8 GFLOP on
// 62 MB of operands, so operations bound it: 0.056 ms at the 67 TFLOP/s of
// the fp32 FMA units (no fp32 tensor-core product exists; TF32 or bf16
// wgmma would need a tolerance decision).  At the decode shapes (M = 1 or
// 4) it is the 3.7 MB of b, about 1.1 us.  This first kernel feeds eight
// FMAs from one broadcast 8-byte and one 16-byte shared-memory load, so the
// shared-memory rate, not the FMA rate, is its ceiling; with 16 rows per
// block the prefill router fills 128 of the 132 SMs, but a decode step
// runs one block on one SM (split-K is a later change).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 16;           // rows per block
constexpr int BN = 128;          // columns per tile
constexpr int BK = 32;           // contraction slice in shared memory
constexpr int THREADS = 256;
constexpr int TM = 2;            // rows per warp (= per thread)
constexpr int TN = 4;            // columns per thread
constexpr int B_LOADS = BK * BN / THREADS;   // b elements each thread stages
// a's slice is stored transposed, rows padded by 2 floats: the staging
// stores of one warp then fall on 16 banks instead of one, and a row pair
// stays 8-byte aligned for the broadcast load
constexpr int AS_LD = BM + 2;
static_assert(BM == TM * THREADS / 32, "one warp per TM rows");
static_assert(BN == TN * 32, "one warp spans a column tile");
static_assert(BM * BK == 2 * THREADS, "two a elements per thread");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Tail {
  int has_scale;
  float scale;
  int causal;
  int softmax;
  int relu;
  int n_valid;                   // columns >= n_valid are NEG_INF (softmax)
};

// out and lg may alias (fp32 output with a softmax): not __restrict__
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
matmul_tail_kernel(const T* __restrict__ a, const T* __restrict__ b, TO* out,
                   float* lg, int M, int K, int N, Tail tail) {
  __shared__ __align__(16) float as[BK][AS_LD];
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  // the a elements this thread stages: row ar, columns ak and ak + 1
  const int ar = tid / (BK / 2), ak = (tid % (BK / 2)) * 2;
  const bool a_row_ok = row0 + ar < M;
  const T* a_row = a + (size_t)(row0 + ar) * K;

  float m_run[TM], l_run[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }

  for (int c0 = 0; c0 < N; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    float ra[2], rb[B_LOADS];
    auto load = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = k0 + ak + q;
        ra[q] = a_row_ok && k < K ? to_f(a_row[k]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < B_LOADS; ++e) {
        const int idx = e * THREADS + tid;
        const int k = k0 + idx / BN, c = c0 + idx % BN;
        rb[e] = k < K && c < N ? to_f(b[(size_t)k * N + c]) : 0.f;
      }
    };
    load(0);

    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();                     // the previous slice is consumed
      as[ak][ar] = ra[0];
      as[ak + 1][ar] = ra[1];
#pragma unroll
      for (int e = 0; e < B_LOADS; ++e) {
        const int idx = e * THREADS + tid;
        bs[idx / BN][idx % BN] = rb[e];
      }
      __syncthreads();
      if (k0 + BK < K) load(k0 + BK);      // in flight during the FMAs
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float2 av = *reinterpret_cast<const float2*>(&as[kk][warp * TM]);
        const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][lane * TN]);
        const float ai[TM] = {av.x, av.y};
        const float bj[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
      }
    }

    // the tail on this column tile
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + warp * TM + i;
      float v[TN];
      bool in[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + lane * TN + j;
        in[j] = c < N;
        float x = acc[i][j];
        if (tail.has_scale) x *= tail.scale;
        if (tail.causal && r < c) x = NEG_INF;
        if (tail.softmax && c >= tail.n_valid) x = NEG_INF;
        v[j] = x;
      }
      if (tail.softmax) {
        // columns past N are no part of the row: -inf for the max, 0 in
        // the sum; NEG_INF-masked ones take part, as in the reference
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (in[j]) tmax = fmaxf(tmax, v[j]);
        tmax = warp_max(tmax);
        const float m_new = fmaxf(m_run[i], tmax);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (in[j]) s += expf(v[j] - m_new);
        s = warp_sum(s);
        l_run[i] = l_run[i] * expf(m_run[i] - m_new) + s;
        m_run[i] = m_new;
        if (r < M) {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (in[j]) lg[(size_t)r * N + c0 + lane * TN + j] = v[j];
        }
      } else if (r < M) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (!in[j]) continue;
          const float x = tail.relu ? fmaxf(v[j], 0.f) : v[j];
          store(out + (size_t)r * N + c0 + lane * TN + j, x);
        }
      }
    }
  }

  if (!tail.softmax) return;
  // second sweep: each thread normalises the logits it wrote itself
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + warp * TM + i;
    if (r >= M) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    for (int c0 = 0; c0 < N; c0 += BN) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + lane * TN + j;
        if (c >= N) continue;
        const size_t off = (size_t)r * N + c;
        float p = expf(lg[off] - m_run[i]) / denom;
        if (tail.relu) p = fmaxf(p, 0.f);
        store(out + off, p);
      }
    }
  }
}

template <typename T, typename TO>
int launch(const void* a, const void* b, void* out, void* lg, int m, int k,
           int n, Tail tail, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM);
  matmul_tail_kernel<T, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<TO*>(out), static_cast<float*>(lg), m, k, n, tail);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_out(int out_dtype, const void* a, const void* b, void* out,
                 void* lg, int m, int k, int n, Tail tail, cudaStream_t st) {
  if (out_dtype == 0)
    return launch<T, float>(a, b, out, lg, m, k, n, tail, st);
  if (out_dtype == 1)
    return launch<T, __nv_bfloat16>(a, b, out, lg, m, k, n, tail, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in_dtype, out_dtype: 0 = float32, 1 = bfloat16.  lg: an fp32 (M, N)
// buffer for the softmax's logits (out itself when out is fp32; unused
// without a softmax).  Returns the launch's cudaError_t.
extern "C" int matmul_blocked_launch(const void* a, const void* b, void* out,
                                     void* lg, int in_dtype, int out_dtype,
                                     int m, int k, int n, int has_scale,
                                     float scale, int causal, int softmax,
                                     int relu, int n_valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tail tail{has_scale, scale, causal, softmax, relu, n_valid};
  if (in_dtype == 0)
    return dispatch_out<float>(out_dtype, a, b, out, lg, m, k, n, tail, st);
  if (in_dtype == 1)
    return dispatch_out<__nv_bfloat16>(out_dtype, a, b, out, lg, m, k, n,
                                       tail, st);
  return (int)cudaErrorInvalidValue;
}
