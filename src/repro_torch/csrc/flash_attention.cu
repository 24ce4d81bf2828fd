// Forward attention with an online softmax (flash attention), for Hopper
// (sm_90a).
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/flash_attention.py::flash_attention_pallas (body
//   _attn_kernel), and computes what repro/models/lm/layers.py::
//   flash_attention_xla computes, on the same tensors:
//   q (B, HQ, S, D), k and v (B, HKV, SK, D), contiguous fp32; o (B, HQ,
//   S, D) fp32.  SK != S is cross-attention (keys of another sequence);
//   the masks take absolute positions from 0 on both sides.  This is B3's fp32 route; bf16 takes the tensor-core kernel
//   of flash_attention_sm90.cu.
// GQA: query head h reads kv head h / (HQ / HKV); K and V are never
// repeated.  Scale 1/sqrt(D), causal and local-window band masks, masked
// scores set to NEG_INF = -1e30 (never -inf), denominator clamped at 1e-30,
// fp32 inside.  Any S and SK: the kernel masks the ragged last tiles itself
// (k_pos < SK, q_pos < S), where the Pallas kernel asserts S % block == 0
// and SK == S.
//
// Work split.  One thread block per (q tile of BQ rows, q head, batch).  The
// Pallas grid's sequential fourth axis (kv blocks) becomes a loop inside the
// block, in ascending order: a row whose first processed tile is wholly
// masked accumulates exp(0) terms there, and the first real score wipes
// them out through alpha = exp(-1e30 - m) = 0, as in both references.  Tiles
// wholly above the diagonal or wholly left of the window are skipped, as the
// Pallas kernel skips them.  K and V tiles of BK rows are staged in shared
// memory as fp32.  Each query row belongs to TPR neighbouring threads of
// one warp (D / 32 at D = 64, 128, 256; one thread when D < 64; see
// threads_per_row); each holds an interleaved slice of E = D / TPR <= 60
// elements of q and of the fp32 accumulator in registers, and the partial
// dot products meet through warp shuffles.  Every head dim that is a
// multiple of 16 up to 256 has its own instantiation, as the sm90 route
// takes them all.  The running max and
// denominator are per row, kept by each of its threads.
//
// What bounds it on the H100: at qwen2-1.5b's prefill (D = 128, S up to
// 2048) the work is 4 * B * HQ * S^2 * D / 2 FLOP (the causal half), far
// above the bytes (q, k, v, o once each); the tensor cores would make it
// operations-bound at 989 TFLOP/s in bf16.  This first kernel runs on the
// fp32 FMA units (67 TFLOP/s) and feeds them from shared memory with one
// 16-byte load per four FMAs, so the rate of shared-memory loads bounds
// it well below even the fp32 peak.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 32;           // kv rows per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Threads per query row: the largest power of two that is at most D / 32
// and divides D / 4, so that each thread holds whole float4 chunks; any D
// that is a multiple of 16 then gives E = D / TPR <= 60.
constexpr int threads_per_row(int d) {
  int t = 1;
  while (2 * t * 32 <= d && (d / 4) % (2 * t) == 0) t *= 2;
  return t;
}

template <int D> struct Shape {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static constexpr int TPR = threads_per_row(D);     // threads per query row
  static constexpr int E = D / TPR;                  // D elements per thread
  static constexpr int C4 = E / 4;                   // float4 chunks of them
  static constexpr int BQ = 256 / TPR < 64 ? 256 / TPR : 64;  // rows / block
  static constexpr int THREADS = BQ * TPR;
  static constexpr size_t SMEM = 2ull * BK * D * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::THREADS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int s, int sk, int causal, int window,
                       float scale) {
  using SH = Shape<D>;
  constexpr int TPR = SH::TPR, E = SH::E, C4 = SH::C4, BQ = SH::BQ;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);       // [BK][D]
  float* vs = ks + BK * D;                           // [BK][D]

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_start = blockIdx.x * BQ;
  const int q_pos = q_start + row;
  const bool row_valid = q_pos < s;
  const int hk = h / (hq / hkv);

  const T* qp = q + ((size_t)(b * hq + h) * s) * D;
  const T* kp = k + ((size_t)(b * hkv + hk) * sk) * D;
  const T* vp = v + ((size_t)(b * hkv + hk) * sk) * D;

  // thread `part` owns elements d = (c * TPR + part) * 4 + e, c < C4, e < 4
  float qr[E], acc[E];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (c * TPR + part) * 4 + e;
      qr[c * 4 + e] = row_valid ? to_f(qp[(size_t)q_pos * D + d]) : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // kv tiles this q tile needs: up to its last row (causal), from the
  // first key its first row's window reaches
  const int k_end = causal ? min(sk, q_start + BQ) : sk;
  int t0 = 0;
  if (window > 0) {
    const int lo = q_start - window + 1;
    t0 = lo > 0 ? lo / BK : 0;
  }

  for (int k0 = t0 * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                       // the previous tile is consumed
    for (int i = tid; i < BK * D; i += SH::THREADS) {
      const int kpos = k0 + i / D;
      const size_t off = (size_t)kpos * D + i % D;
      ks[i] = kpos < sk ? to_f(kp[off]) : 0.f;
      vs[i] = kpos < sk ? to_f(vp[off]) : 0.f;
    }
    __syncthreads();

    float sc[BK];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 kk = kr[c * TPR + part];
        dot = fmaf(qr[c * 4 + 0], kk.x, dot);
        dot = fmaf(qr[c * 4 + 1], kk.y, dot);
        dot = fmaf(qr[c * 4 + 2], kk.z, dot);
        dot = fmaf(qr[c * 4 + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kpos = k0 + j;
      bool ok = kpos < sk;
      if (causal) ok = ok && q_pos >= kpos;
      if (window > 0) ok = ok && q_pos - kpos < window;
      sc[j] = ok ? dot * scale : NEG_INF;
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      sc[j] = expf(sc[j] - m_new);
      psum += sc[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 vv = vr[c * TPR + part];
        acc[c * 4 + 0] = fmaf(sc[j], vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(sc[j], vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(sc[j], vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(sc[j], vv.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (row_valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = o + ((size_t)(b * hq + h) * s + q_pos) * D;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(op + (c * TPR + part) * 4 + e, acc[c * 4 + e] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int sk, int causal, int window,
           cudaStream_t stream) {
  using SH = Shape<D>;
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SH::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + SH::BQ - 1) / SH::BQ, hq, b);
  kern<<<grid, SH::THREADS, SH::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, sk, causal,
      window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int s, int sk, int d, int causal,
               int window, cudaStream_t st) {
  switch (d) {
#define HEAD_DIM(D) \
  case D:        \
    return launch<T, D>(q, k, v, o, b, hq, hkv, s, sk, causal, window, st);
    HEAD_DIM(16) HEAD_DIM(32) HEAD_DIM(48) HEAD_DIM(64) HEAD_DIM(80)
    HEAD_DIM(96) HEAD_DIM(112) HEAD_DIM(128) HEAD_DIM(144) HEAD_DIM(160)
    HEAD_DIM(176) HEAD_DIM(192) HEAD_DIM(208) HEAD_DIM(224) HEAD_DIM(240)
    HEAD_DIM(256)
#undef HEAD_DIM
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous fp32.  Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int s, int sk, int d,
                                      int causal, int window, void* stream) {
  return dispatch_d<float>(q, k, v, o, b, hq, hkv, s, sk, d, causal, window,
                           static_cast<cudaStream_t>(stream));
}
