// Generic Hopper (sm_90a) helpers shared by the port's TMA + wgmma kernels:
// the attention mainloop (attention_sm90.cuh: kernels 1 and 4) and the Oobleck
// decoder-block conv mainloop (oobleck_sm90.cu: kernel 2).
//   - mbarrier init / expect_tx / arrive / wait (a wait over 10 s traps);
//   - TMA loads of 4-D tensor maps (128-byte swizzle) and the host-side map
//     encoder (`make_map`, through the runtime: no -lcuda);
//   - wgmma shared-memory descriptors, m64n128k16 bf16 products with A from
//     shared memory (`wgmma_ss`) or registers (`wgmma_rs`), fences, and the
//     fp32-accumulator -> bf16 A-fragment conversion (`to_a_frags`);
//   - `setmaxnreg` for warp-specialised producer / consumer warpgroups.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats to a bf16 pair; `lo` lands in the low 16 bits (lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed. A wait of more
// than 10 s is a fault in the pipeline: trap, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// One TMA box of a 4-D tensor map into shared memory, completed on `bar`.
// Coordinates are signed: box rows before 0 or past an edge read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers an asynchronous wgmma reads or writes to this point of the
// program, so the compiler neither reads them early nor reuses them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Barrier over the 128 threads of one consumer warpgroup (ids 1.., 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands step
// 32 bytes per k16 inside a box; MN-major operands step 2048 bytes (16 rows).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

#define ACE_D8(i)                                                                  \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACE_D64 \
  ACE_D8(0), ACE_D8(8), ACE_D8(16), ACE_D8(24), ACE_D8(32), ACE_D8(40), ACE_D8(48), ACE_D8(56)
#define ACE_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d[64] (+)= A[64x16] B[16x128], A and B in shared memory (A K-major).
// d[4i + e]: row (lane/4) + 8 (e/2) of this warp's 16, column 8i + 2 (lane%4) + e%2.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACE_R64
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : ACE_D64
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// d[64] += A[64x16] B[16x128], A in registers (bf16 pairs in the
// m16n8k16 A-fragment layout, per warp), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACE_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : ACE_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

#undef ACE_D8
#undef ACE_D64
#undef ACE_R64

// A 64 x 128 fp32 accumulator (wgmma layout) to the bf16 A fragments of the
// next product's eight k16 steps: columns 16 kk .. 16 kk + 15 -> a[kk].
__device__ __forceinline__ void to_a_frags(const float (&s)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-D bf16 map with 128-byte swizzle. dims innermost first; strides in
// elements for dims 1..3; box innermost first. Reads past an edge are zeros.
inline bool make_map(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                     const uint64_t (&strides)[3], const uint32_t (&box)[4]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstride[3] = {strides[0] * 2, strides[1] * 2, strides[2] * 2};
  const cuuint32_t bdim[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim, gstride, bdim,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
