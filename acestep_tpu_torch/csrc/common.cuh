// Device helpers of the Oobleck kernels (csrc/oobleck.cu, csrc/oobleck_sm90.cu):
// the bf16 pair packing of the Snake launch and the sin^2 polynomial of
// `ops/basic.sin2_f32`. The Hopper helpers are in sm90.cuh.
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
