// Hopper (sm_90a) building blocks shared by the port's tensor-core and
// split-K kernels: shared-memory barriers, TMA and bulk copies,
// wgmma descriptors and fences, thread-block-cluster barriers and
// distributed shared memory, the 3xTF32 pieces (the tf32 split and the
// tf32 wgmmas), quad and lane-group reductions, the matmul tail on a row
// reduced across a cluster, and the host's lookup of the tensor-map
// encoder.  Included by conv2d_nchwc_sm90.cu, flash_attention_sm90.cu,
// matmul_blocked_sm90.cu, matmul_splitk.cu and ssd_chunk_sm90.cu;
// kernels/build.py hashes it with each of them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

// ---- shared-memory barriers, TMA and bulk copies ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D TMA tile copy into this block's shared memory, completing its
// bytes on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y),
      "r"(z)
      : "memory");
}

// A contiguous bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global into this block's shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- thread-block clusters -------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: this block's shared-memory
// writes before the barrier are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::
                   : "memory");
}

// The two halves of a cluster barrier: a block may touch another's shared
// memory only once the other has started, which an arrive at the start and
// a wait before the first access make sure of.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The generic address of what lies at `p` (this block's shared memory) in
// block `rank`'s shared memory: plain C++ stores through it land in that
// block, and a later cluster_sync makes them visible there.
template <typename T>
__device__ __forceinline__ T* map_rank(T* p, uint32_t rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;"
      : "=l"(out)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// ---- wgmma -----------------------------------------------------------------

// A shared-memory matrix descriptor for a tile in TMA's 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), and
// layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Operand lists of wgmma's fp32 accumulator: F32(a, i) binds a[i..i+31]
// as read-write registers, Rn is the instruction's list of n of them.
#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F16(a, i) F4(a, i), F4(a, i + 4), F4(a, i + 8), F4(a, i + 12)
#define F32(a, i) F16(a, i), F16(a, i + 16)
#define R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define R96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// ---- 3xTF32 ----------------------------------------------------------------

// One TF32 product keeps 11 of fp32's 24 significant bits.  So an fp32
// operand a is split into hi = tf32(a) and lo = tf32(a - hi), and a product
// is taken as lo*hi + hi*lo + hi*hi (the dropped lo*lo is ~2^-22 of it).

// cvt.rna: round to nearest, ties away from zero, to tf32's 10 stored bits
__device__ __forceinline__ float tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r & 0xffffe000u);
}

// a = hi + lo to ~2^-22 relative, both tf32
__device__ __forceinline__ void split(const float4& a, float4& hi,
                                      float4& lo) {
  hi = make_float4(tf32(a.x), tf32(a.y), tf32(a.z), tf32(a.w));
  lo = make_float4(tf32(a.x - hi.x), tf32(a.y - hi.y), tf32(a.z - hi.z),
                   tf32(a.w - hi.w));
}

// The byte offset of 16-byte chunk q of row r in a tile of 128-byte rows,
// in TMA's 128-byte swizzle (the tile 1024-byte aligned): the layout that
// sw128_desc(tile + 32 * kk, 16, 1024) reads as k step kk of 8 fp32.
__device__ __forceinline__ int sw128(int r, int q) {
  return r * 128 + ((q ^ (r & 7)) << 4);
}

// Shared-memory writes of the threads (the generic proxy) visible to the
// wgmmas (the async proxy) that follow a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#define R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32 fp32) = A (64 x 8, smem, K-major) * B (8 x 32, smem, K-major)
// + (accumulate ? d : 0), in tf32.  d[4j + e] is row 16 (warp % 4) +
// lane / 4 (+ 8 for e >= 2), column 8j + 2 (lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
      ", %16, %17, p, 1, 1;\n}\n"
      : F16(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) = A (64 x 8, registers) * B (8 x 64, smem, K-major)
// + (accumulate ? d : 0), in tf32.  Thread (warp w, lane l) holds A at
// rows 16 (w % 4) + l / 4 (a[0], a[2]) and + 8 (a[1], a[3]), columns
// l % 4 (a[0], a[1]) and + 4 (a[2], a[3]).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ---- small helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the matmul tail on a full row -----------------------------------------

// The fused matmul tail of matmul_blocked.cu, in the reference's order, on
// the fp32 sums: scale, causal mask at absolute coordinates, the n_valid
// column mask and row softmax (softmax only), ReLU.
struct Tail {
  int has_scale;
  float scale;
  int causal;
  int softmax;
  int relu;
  int n_valid;                   // columns >= n_valid are NEG_INF (softmax)
};

constexpr float TAIL_NEG_INF = -1e30f;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A group of W lanes (W divides 32; `lane` is the lane within the group)
// finishes output row `row` (n columns) of a split-K product: the cl
// partials of the row lie in this block's shared memory at `parts`,
// `stride` floats apart, in the order of the cluster ranks that sent them.
// It sums them in that order, applies the tail and stores the row to
// out_row; a softmax keeps the logits in the first partial.  Every lane's
// sum runs in the same order, so the result does not depend on timing.
// All 32 lanes of the warp must call it together (the reductions shuffle
// across the warp); a group with no row passes n = 0 and stores nothing.
template <int W, typename TO>
__device__ __forceinline__ void finish_row(float* parts, int stride, int cl,
                                           int row, int n, const Tail& tail,
                                           TO* out_row, int lane) {
  float mx = -INFINITY;
  for (int col = lane; col < n; col += W) {
    float x = parts[col];
    for (int p = 1; p < cl; ++p) x += parts[p * stride + col];
    if (tail.has_scale) x *= tail.scale;
    if (tail.causal && row < col) x = TAIL_NEG_INF;
    if (tail.softmax) {
      if (col >= tail.n_valid) x = TAIL_NEG_INF;
      parts[col] = x;
      mx = fmaxf(mx, x);
    } else {
      store_out(out_row + col, tail.relu ? fmaxf(x, 0.f) : x);
    }
  }
  if (!tail.softmax) return;
  mx = group_max<W>(mx);
  float l = 0.f;
  for (int col = lane; col < n; col += W) l += expf(parts[col] - mx);
  const float denom = fmaxf(group_sum<W>(l), 1e-30f);
  for (int col = lane; col < n; col += W) {
    float p = expf(parts[col] - mx) / denom;
    if (tail.relu) p = fmaxf(p, 0.f);
    store_out(out_row + col, p);
  }
}

// ---- host ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor-map encoder cuTensorMapEncodeTiled, found in the libcuda that
// the process has loaded (nothing links against libcuda).
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

}  // namespace sm90
