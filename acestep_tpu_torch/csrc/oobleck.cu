// Snake for the Oobleck decoder kernels (Hopper, sm_90a): a = bf16(Snake(x))
// on bf16 (B, L, C) activations, 8 channels (16 bytes) per thread, fp32
// inside with the sin^2 polynomial of `ops/basic.sin2_f32`. It is the first
// launch of both kernels of `csrc/oobleck_sm90.cu`, composed by
// ops/oobleck_kernels.py: a decoder block's Snake on its input (kernel 2,
// `decoder_block_pallas`) and the chain's Snake1 of its first unit (kernel 3,
// `res_units_pallas`); every later Snake runs in a conv epilogue there. Bound
// by bytes (one read and one write of the activation, no reuse).

#include "common.cuh"

namespace {

__global__ void snake_kernel(const bf16* __restrict__ x, const float* __restrict__ ae,
                             const float* __restrict__ ib, bf16* __restrict__ y,
                             long long n_vec, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const int c0 = (int)((i * 8) % C);
  uint4 raw = reinterpret_cast<const uint4*>(x)[i];
  const bf16* xv = reinterpret_cast<const bf16*>(&raw);
  uint4 outv;
  uint32_t* ov = reinterpret_cast<uint32_t*>(&outv);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float a = __bfloat162float(xv[2 * j]);
    float b = __bfloat162float(xv[2 * j + 1]);
    a = a + ib[c0 + 2 * j] * sin2_poly(ae[c0 + 2 * j] * a);
    b = b + ib[c0 + 2 * j + 1] * sin2_poly(ae[c0 + 2 * j + 1] * b);
    ov[j] = pack_bf16(a, b);
  }
  reinterpret_cast<uint4*>(y)[i] = outv;
}

}  // namespace

extern "C" int acestep_snake(const void* x, const void* ae, const void* ib, void* y,
                             long long n_elem, int C, void* stream) {
  const long long n_vec = n_elem / 8;
  const int threads = 256;
  const long long blocks = (n_vec + threads - 1) / threads;
  snake_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ae), static_cast<const float*>(ib),
      static_cast<bf16*>(y), n_vec, C);
  return static_cast<int>(cudaGetLastError());
}
