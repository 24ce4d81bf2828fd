// Blocked direct convolution in NCHW[x]c with the fused conv_block epilogue,
// for Hopper (sm_90a).
//
// Replaces: the JAX reference's Pallas TPU kernel
//   repro/kernels/conv2d_nchwc.py::conv2d_nchwc_pallas (body _conv_kernel).
// It computes what that kernel computes, on the same tensors:
//   x     (N, CI, HP, WP, ICB)       input, already padded by the caller
//   w     (KO, CI, KH, KW, ICB, OCB) weight, KCRS[x]c[y]k
//   scale (KO, OCB), shift (KO, OCB) optional per-channel affine
//   res   (N, KO, OH, OW, OCB)       optional residual, at conv resolution
//   buf   (N, TOTC, PH, PW, OCB)     optional concat buffer
//   out   (N, KO or TOTC, PH, PW, OCB)
// acc = sum over (ci, kh, kw, ic) in fp32, then in the reference's order
// (repro/kernels/ops.py::apply_epilogue_fp32): * scale, + shift, + residual,
// ReLU, pool, and the store at a channel offset into the concat buffer.
// Output chunks outside [off, off + KO) copy the buffer through, as the TPU
// kernel's grid does (conv2d_nchwc.py:82-85).
//
// The TPU kernel's tile knobs (ow_bn, oh_bn, unroll_ker) and the schedule's
// lowering variant have no meaning here: this kernel has one loop nest and
// ignores them.
//
// Design: one thread per stored output element, oc innermost, so the threads
// of a warp read consecutive weights (coalesced), share the input value
// (broadcast) and write consecutive outputs (coalesced).  Nothing is staged
// in shared memory.
//
// Fused pooling: the conv-resolution tensor is never written to device
// memory.  Each pooled output recomputes the conv values of its window, with
// padded taps counting as -inf for max and 0 for avg (the ceil-mode
// arithmetic of repro/core/epilogue.py::pool2d: a window starts at
// p * stride - pad in conv coordinates, and a tap outside [0, OH) x [0, OW)
// is padding).  The cost is recomputation: on ResNet's stem (7x7 s2 conv,
// 3x3 s2 p1 max-pool, 112x112 -> 56x56) each conv value is computed
// 9 * 56^2 / 112^2 = 2.25 times on average.
//
// What bounds it on the H100: the work is 2*N*KO*OCB*OH*OW*CI*ICB*KH*KW fp32
// FLOP, against 67 TFLOP/s of fp32 FMA outside the tensor cores; the bytes
// (each input once, the output once) are far below that at ResNet's shapes.
// What this simple design gives up, for a later kernel to reclaim: every FMA
// costs two loads through L1 (no register or shared-memory reuse of the
// input row or the weight block), the fp32 FMA path instead of the tensor
// cores (TF32 or bf16 wgmma fed by TMA), and the pooled recomputation.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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
};

// One conv value at conv-resolution position (r, c), epilogue applied up to
// and including ReLU.
__device__ __forceinline__ float conv_value(const Conv& p, int n, int k,
                                            int oc, int r, int c) {
  float acc = 0.0f;
  const int row0 = r * p.stride;
  const int col0 = c * p.stride;
  for (int ci = 0; ci < p.ci; ++ci) {
    for (int dh = 0; dh < p.kh; ++dh) {
      const long long xrow =
          ((static_cast<long long>(n) * p.ci + ci) * p.hp + row0 + dh) * p.wp;
      for (int dw = 0; dw < p.kw; ++dw) {
        const float* xp = p.x + (xrow + col0 + dw) * p.icb;
        const float* wq =
            p.w +
            (((static_cast<long long>(k) * p.ci + ci) * p.kh + dh) * p.kw +
             dw) * p.icb * p.ocb + oc;
        for (int ic = 0; ic < p.icb; ++ic) {
          acc = fmaf(xp[ic], wq[static_cast<long long>(ic) * p.ocb], acc);
        }
      }
    }
  }
  const int ch = k * p.ocb + oc;
  if (p.scale) acc = acc * p.scale[ch];
  if (p.shift) acc = acc + p.shift[ch];
  if (p.res) {
    acc = acc + p.res[(((static_cast<long long>(n) * p.ko + k) * p.oh + r) *
                           p.ow + c) * p.ocb + oc];
  }
  if (p.relu) acc = fmaxf(acc, 0.0f);
  return acc;
}

__global__ void conv2d_nchwc_kernel(Conv p, long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  long long t = idx;
  const int oc = static_cast<int>(t % p.ocb); t /= p.ocb;
  const int pc = static_cast<int>(t % p.pw);  t /= p.pw;
  const int pr = static_cast<int>(t % p.ph);  t /= p.ph;
  const int co = static_cast<int>(t % p.out_chunks);
  const int n = static_cast<int>(t / p.out_chunks);
  const int k = co - p.off_chunks;
  if (k < 0 || k >= p.ko) {       // concat chunk owned by another producer
    p.out[idx] = p.buf[idx];
    return;
  }
  float v;
  if (p.pool_kind == 0) {
    v = conv_value(p, n, k, oc, pr, pc);
  } else {
    const bool is_max = p.pool_kind == 1;
    v = is_max ? -INFINITY : 0.0f;
    for (int dh = 0; dh < p.pool_k; ++dh) {
      const int r = pr * p.pool_stride - p.pool_pad + dh;
      if (r < 0 || r >= p.oh) continue;
      for (int dw = 0; dw < p.pool_k; ++dw) {
        const int c = pc * p.pool_stride - p.pool_pad + dw;
        if (c < 0 || c >= p.ow) continue;
        const float u = conv_value(p, n, k, oc, r, c);
        v = is_max ? fmaxf(v, u) : v + u;
      }
    }
    if (!is_max) v = v / static_cast<float>(p.pool_k * p.pool_k);
  }
  p.out[idx] = v;
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers (scale, shift, res
// and buf may be null); stream is a cudaStream_t.  Returns the cudaError_t
// of the launch (0 on success).  The caller validates every shape.
extern "C" int conv2d_nchwc_launch(
    const float* x, const float* w, const float* scale, const float* shift,
    const float* res, const float* buf, float* out,
    int n, int ci, int hp, int wp, int icb,
    int ko, int kh, int kw, int ocb,
    int stride, int oh, int ow,
    int out_chunks, int ph, int pw, int off_chunks,
    int relu, int pool_kind, int pool_k, int pool_stride, int pool_pad,
    void* stream) {
  Conv p{x, w, scale, shift, res, buf, out,
         n, ci, hp, wp, icb, ko, kh, kw, ocb, stride, oh, ow,
         out_chunks, ph, pw, off_chunks, relu, pool_kind,
         pool_k, pool_stride, pool_pad};
  const long long total =
      static_cast<long long>(n) * out_chunks * ph * pw * ocb;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  conv2d_nchwc_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, total);
  return static_cast<int>(cudaGetLastError());
}
