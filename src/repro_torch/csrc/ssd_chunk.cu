// The SSD intra-chunk block of Mamba-2, for Hopper (sm_90a).
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/ssd_chunk.py::ssd_intra_pallas (body _ssd_intra_kernel),
// and computes what it computes, on the same tensors (all fp32, contiguous):
//   cc, bc (BC, Q, N)     C and B blocks per (batch x chunk), shared by heads
//   acum   (BC, H, Q)     cumulative log decays
//   xd     (BC, H, Q, P)  dt-weighted inputs
//   y      (BC, H, Q, P)  y[i] = sum_{j <= i} (c_i . b_j) exp(acum_i - acum_j) x_j
//
// Work split.  The TPU kernel holds the whole (Q, Q) score tile of one
// (batch-chunk, head) in VMEM.  At mamba2-130m's chunk Q = 256 that tile is
// 256 KB of fp32, more than a block's 227 KB of shared memory, so it is not
// carried over.  Here one thread block computes TI = 64 output rows of one
// (batch-chunk, head): the grid is (row tiles, H, BC), so a 2,048-token
// prefill gives 4 * 24 * 8 = 768 blocks instead of 192.  The block stages
// its rows of C and the row decays once, then loops over the column tiles
// j <= i in TJ = 64 steps: it stages b_j, x_j and their decays, forms the
// 64 x 64 score tile c_i . b_j (N = 128 terms) with the causal mask and
// the decay exp(acum_i - acum_j) applied, and accumulates score @ x_j
// (P = 64) into an fp32 (64, P) accumulator held in registers, 4 x 4 per
// thread.  Only the score tile goes through shared memory.  Ragged Q (the
// reduced configs' Q = 8) is masked.  Shared-memory rows of C and B are
// padded by one float so that the 16 threads reading 16 rows at one column
// hit 16 banks.
//
// What bounds it on the H100: the causal half of the two products,
// BC * H * Q(Q+1)/2 * 2(N + P) FLOP, of which the C.B scores are the same
// for every head (single SSD group), against bytes of a few MB: it is
// operations-bound.  This kernel computes the scores once per head, as the
// TPU kernel does, on the fp32 FMA units, with two shared-memory loads per
// four FMAs in the score loop.  A later kernel shares the score tile
// across heads and moves both products onto the tensor cores (TF32 wgmma,
// with a tolerance decision, or bf16 inputs).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TI = 64;           // output rows per block
constexpr int TJ = 64;           // columns per step
constexpr int THREADS = 256;     // 16 x 16, each 4 rows x 4 columns
constexpr int MAXP = 64;         // P <= 16 * 4

__host__ __device__ inline size_t smem_floats(int n, int p) {
  return (size_t)TI * (n + 1) + (size_t)TJ * (n + 1) + (size_t)TJ * p
         + (size_t)TI * (TJ + 1) + TI + TJ;
}

__global__ void __launch_bounds__(THREADS)
ssd_intra_kernel(const float* __restrict__ cc, const float* __restrict__ bc,
                 const float* __restrict__ acum, const float* __restrict__ xd,
                 float* __restrict__ y, int h_heads, int q_len, int n, int p) {
  extern __shared__ float sm[];
  const int ns = n + 1;
  float* cs = sm;                         // [TI][n + 1]
  float* bs = cs + TI * ns;               // [TJ][n + 1]
  float* xs = bs + TJ * ns;               // [TJ][p]
  float* ss = xs + TJ * p;                // [TI][TJ + 1]
  float* ai = ss + TI * (TJ + 1);         // [TI]
  float* aj = ai + TI;                    // [TJ]

  const int i0 = blockIdx.x * TI;
  const int h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* cg = cc + (size_t)g * q_len * n;
  const float* bg = bc + (size_t)g * q_len * n;
  const float* ag = acum + ((size_t)g * h_heads + h) * q_len;
  const float* xg = xd + ((size_t)g * h_heads + h) * q_len * p;
  float* yg = y + ((size_t)g * h_heads + h) * q_len * p;

  for (int idx = tid; idx < TI * n; idx += THREADS) {
    const int r = idx / n, c = idx % n;
    cs[r * ns + c] = i0 + r < q_len ? cg[(size_t)(i0 + r) * n + c] : 0.f;
  }
  for (int idx = tid; idx < TI; idx += THREADS)
    ai[idx] = i0 + idx < q_len ? ag[i0 + idx] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;

  const int i_last = min(i0 + TI, q_len) - 1;
  for (int j0 = 0; j0 <= i_last; j0 += TJ) {
    __syncthreads();                      // previous step's tiles consumed
    for (int idx = tid; idx < TJ * n; idx += THREADS) {
      const int r = idx / n, c = idx % n;
      bs[r * ns + c] = j0 + r < q_len ? bg[(size_t)(j0 + r) * n + c] : 0.f;
    }
    for (int idx = tid; idx < TJ * p; idx += THREADS) {
      const int r = idx / p;
      xs[idx] = j0 + r < q_len ? xg[(size_t)(j0 + r) * p + idx % p] : 0.f;
    }
    for (int idx = tid; idx < TJ; idx += THREADS)
      aj[idx] = j0 + idx < q_len ? ag[j0 + idx] : 0.f;
    __syncthreads();

    // scores of rows ty + 16a against columns tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
    for (int c = 0; c < n; ++c) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * ns + c];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) bv[bb] = bs[(tx + 16 * bb) * ns + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) s[a][bb] = fmaf(cv[a], bv[bb], s[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int ri = ty + 16 * a, cj = tx + 16 * bb;
        const int i = i0 + ri, j = j0 + cj;
        ss[ri * (TJ + 1) + cj] =
            (j <= i && i < q_len) ? s[a][bb] * expf(ai[ri] - aj[cj]) : 0.f;
      }
    }
    __syncthreads();

    // acc(rows, p) += score(rows, j) @ x(j, p), columns p = tx + 16b
    for (int jj = 0; jj < TJ; ++jj) {
      float sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = ss[(ty + 16 * a) * (TJ + 1) + jj];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int pc = tx + 16 * bb;
        if (pc < p) {
          const float xv = xs[jj * p + pc];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][bb] = fmaf(sv[a], xv, acc[a][bb]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= q_len) continue;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int pc = tx + 16 * bb;
      if (pc < p) yg[(size_t)i * p + pc] = acc[a][bb];
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t (cudaErrorInvalidValue for P > 64).
extern "C" int ssd_intra_launch(const float* cc, const float* bc,
                                const float* acum, const float* xd, float* y,
                                int bcn, int h, int q, int n, int p,
                                void* stream) {
  if (p > MAXP || p < 1 || n < 1 || q < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(n, p) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((q + TI - 1) / TI, h, bcn);
  ssd_intra_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      cc, bc, acum, xd, y, h, q, n, p);
  return (int)cudaGetLastError();
}
