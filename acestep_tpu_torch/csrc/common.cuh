// Device helpers shared by the kernels: the bf16 pair packing of the Snake
// launch and the sin^2 polynomial of `ops/basic.sin2_f32` (the Oobleck
// kernels), and the cp.async and TF32 mma.sync pieces of csrc/oobleck_generic.cu
// and csrc/flash_attention_f32.cu. The Hopper helpers (TMA, wgmma) are in
// sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Two floats to a bf16 pair; `lo` lands in the low 16 bits (lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: half of the 13
// dropped bits' range added to the magnitude, then those bits cleared. On
// sm_90a the cvt compiles to a longer sequence that also screens for inf and
// NaN, and the splits take most of an fp32 kernel's instruction slots.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
