// Device helpers of the Oobleck kernels (csrc/oobleck.cu): bf16 tensor-core
// products through mma.sync (m16n8k16, fp32 accumulate), ldmatrix fragment
// loads from shared memory, cp.async copies, and the sin^2 polynomial of
// `ops/basic.sin2_f32`. The attention kernels use attention_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i gives the row address of matrix i/8, row i%8.
// Each thread receives (row lane/4, cols 2*(lane%4), +1) of every matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// Transposed: each thread receives (rows 2*(lane%4), +1; col lane/4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair; `lo` lands in the low 16 bits (lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte global->shared copy; copies zeros when `pred` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// sin^2(u) = 1/2 - cos(2u)/2, range-reduced even polynomial (ops/basic.sin2_f32).
__device__ __forceinline__ float sin2_poly(float u) {
  const float v = 2.0f * u;
  const float k = rintf(v * 0.15915494309189535f);
  const float r = v - k * 6.283185307179586f;
  const float r2 = r * r;
  float c = -9.7751781371e-12f;
  c = c * r2 + 2.0620751417e-09f;
  c = c * r2 + -2.7536992140e-07f;
  c = c * r2 + 2.4800691382e-05f;
  c = c * r2 + -1.3888867452e-03f;
  c = c * r2 + 4.1666664136e-02f;
  c = c * r2 + -4.9999999880e-01f;
  c = c * r2 + 9.9999999980e-01f;
  return 0.5f - 0.5f * c;
}
