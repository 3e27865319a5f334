// The narrow route of the Oobleck decoder kernels (kernels 2 and 3): the
// widths and activation types the Hopper instances of csrc/oobleck_sm90.cu do
// not take, at every width the JAX package's gate sends to its Pallas kernels
// (`decoder_block_pallas`, acestep_tpu/ops/pallas_vae.py:202, at C_out <= 512;
// `res_units_pallas`, same file :89, at C <= 1024): C_out <= 512 outside
// SM90_CHANNELS, C_in not a multiple of 128, chain widths outside
// CHAIN_CHANNELS, and fp32 activations at any width. ops/oobleck_kernels
// composes the launches, per decoder block (C = its output channels):
//   snake     a0 = T(Snake(x))
//   upsample  y = T(conv_t(a0) + bias);  a1 = T(Snake1_unit1(y))
//   unit k    k7: z = T(Snake2(conv_k7,d(a_k) + b1))
//             k1: h' = T((h + conv_k1(z)) + b2);  a_{k+1} = T(Snake1_{k+1}(h'))
// 8 launches a block; the chain alone is the Snake and the 6 unit launches.
// T is the activation type (bf16 or fp32); weights, biases and Snake
// constants are fp32, every product is summed in fp32 (taps outer, input
// channels inner), and each output is rounded to T exactly where
// `decoder_block_plain` / `res_units_plain` round. The Snake is the sin^2
// polynomial of `ops/basic.sin2_f32` (common.cuh), read from the rounded value
// it follows. Rows outside [0, L) read as zeros (torch's zero padding).
//
// Design: SIMT, one thread per output element (b, t, c_out), c_out fastest,
// so a warp reads each weight row coalesced and each activation as a
// broadcast. The widths this route takes are narrow (the 16-channel tiny VAE
// does about 1/1000th of a full-width block's work): a direct convolution is
// bound by the L1 / L2 reads of activations and weights, not by the card's
// peak, and no tensor-core path pays off at 16 channels. It is the plain
// route, not a fast one.

#include "common.cuh"

namespace {

constexpr int BAD = 1;  // a shape the kernels do not take (not a CUDA error code)

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// T(v) read back as fp32: the value a later stage of the plain version sees.
template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f<T>(from_f<T>(v)); }

__device__ __forceinline__ float snake(float x, float ae, float ib) { return x + ib * sin2_poly(ae * x); }

template <typename T>
__global__ void gen_snake_kernel(const T* __restrict__ x, const float* __restrict__ ae,
                                 const float* __restrict__ ib, T* __restrict__ y, long long n, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % C);
  y[i] = from_f<T>(snake(to_f<T>(x[i]), ae[c], ib[c]));
}

// 'same' conv of K taps at dilation d over (B, L, Ci) -> (B, L, Co), weights
// (K, Ci, Co). Epilogue: without h, out = T(Snake(acc + bias)) (the k7 stage);
// with h, out = T((h + acc) + bias) and, with Snake constants, a_next =
// T(Snake_next(out)) (the k1 stage).
template <typename T, int K>
__global__ void gen_conv_kernel(const T* __restrict__ a, const float* __restrict__ w,
                                const float* __restrict__ bias, const T* __restrict__ h,
                                const float* __restrict__ ae, const float* __restrict__ ib,
                                T* __restrict__ out, T* __restrict__ a_next, int L, int Ci,
                                int Co, int dil, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int co = (int)(i % Co);
  const long long row = i / Co;  // b * L + t
  const int t = (int)(row % L);
  const long long base = row - t;  // b * L
  const int pad = (K - 1) * dil / 2;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int ti = t + j * dil - pad;
    if (ti < 0 || ti >= L) continue;
    const T* ar = a + (base + ti) * Ci;
    const float* wr = w + (long long)j * Ci * Co + co;
    for (int ci = 0; ci < Ci; ++ci) acc += to_f<T>(ar[ci]) * wr[(long long)ci * Co];
  }
  if (h == nullptr) {
    out[i] = from_f<T>(snake(acc + bias[co], ae[co], ib[co]));
    return;
  }
  const float v = round_t<T>((to_f<T>(h[i]) + acc) + bias[co]);
  out[i] = from_f<T>(v);
  if (a_next != nullptr) a_next[i] = from_f<T>(snake(v, ae[co], ib[co]));
}

// ConvTranspose1d with K = 2s, padding s/2 over (B, L, Ci) -> (B, L s, Co),
// weights (2s, Ci, Co): output p = t s + r takes x[t] W[r + s/2], and x[t-1]
// W[r + 3s/2] for r < s/2 or x[t+1] W[r - s/2] for r >= s/2, each product
// summed over Ci in fp32; y = T((mid + side) + bias), a1 = T(Snake1(y)).
template <typename T>
__global__ void gen_upsample_kernel(const T* __restrict__ a, const float* __restrict__ w,
                                    const float* __restrict__ bias, const float* __restrict__ ae,
                                    const float* __restrict__ ib, T* __restrict__ y,
                                    T* __restrict__ a1, int L, int Ci, int Co, int s, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int co = (int)(i % Co);
  const long long prow = i / Co;  // b * L s + p
  const long long lo = (long long)L * s;
  const int p = (int)(prow % lo);
  const long long b = prow / lo;
  const int t = p / s, r = p % s, half = s / 2;
  const T* ar = a + (b * L + t) * Ci;
  const float* wm = w + (long long)(r + half) * Ci * Co + co;
  float mid = 0.0f, side = 0.0f;
  for (int ci = 0; ci < Ci; ++ci) mid += to_f<T>(ar[ci]) * wm[(long long)ci * Co];
  const int tn = r < half ? t - 1 : t + 1;
  if (tn >= 0 && tn < L) {
    const T* an = a + (b * L + tn) * Ci;
    const float* ws = w + (long long)(r < half ? r + 3 * half : r - half) * Ci * Co + co;
    for (int ci = 0; ci < Ci; ++ci) side += to_f<T>(an[ci]) * ws[(long long)ci * Co];
  }
  const float v = round_t<T>((mid + side) + bias[co]);
  y[i] = from_f<T>(v);
  a1[i] = from_f<T>(snake(v, ae[co], ib[co]));
}

constexpr int THREADS = 256;

unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

template <typename T>
int snake_launch(const void* x, const void* ae, const void* ib, void* y, long long n, int C,
                 cudaStream_t st) {
  gen_snake_kernel<T><<<blocks(n), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ae), static_cast<const float*>(ib),
      static_cast<T*>(y), n, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int conv_launch(const void* a, const void* w, const void* bias, const void* h, const void* ae,
                const void* ib, void* out, void* a_next, int B, int L, int Ci, int Co, int dil,
                cudaStream_t st) {
  const long long n = (long long)B * L * Co;
  gen_conv_kernel<T, K><<<blocks(n), THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const T*>(h), static_cast<const float*>(ae), static_cast<const float*>(ib),
      static_cast<T*>(out), static_cast<T*>(a_next), L, Ci, Co, dil, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int upsample_launch(const void* a, const void* w, const void* bias, const void* ae, const void* ib,
                    void* y, void* a1, int B, int L, int Ci, int Co, int s, cudaStream_t st) {
  const long long n = (long long)B * L * s * Co;
  gen_upsample_kernel<T><<<blocks(n), THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(ae), static_cast<const float*>(ib), static_cast<T*>(y),
      static_cast<T*>(a1), L, Ci, Co, s, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = T(Snake(x)) over n elements of C channels; fp32 != 0 selects T = float.
extern "C" int acestep_gen_snake(const void* x, const void* ae, const void* ib, void* y,
                                 long long n, int C, int fp32, void* stream) {
  if (n <= 0 || C <= 0) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? snake_launch<float>(x, ae, ib, y, n, C, st) : snake_launch<bf16>(x, ae, ib, y, n, C, st);
}

// One unit stage: K = 7 (h null: the k7 with Snake2 in its epilogue) or K = 1
// (h given: the k1 with the residual and, with ae / ib, the next Snake1).
extern "C" int acestep_gen_conv(const void* a, const void* w, const void* bias, const void* h,
                                const void* ae, const void* ib, void* out, void* a_next, int B,
                                int L, int Ci, int Co, int K, int dil, int fp32, void* stream) {
  if (B <= 0 || L <= 0 || Ci <= 0 || Co <= 0 || dil <= 0) return BAD;
  if ((h == nullptr) != (K == 7) || (h == nullptr && ae == nullptr)) return BAD;
  if ((a_next != nullptr) != (h != nullptr && ae != nullptr)) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 7)
    return fp32 ? conv_launch<float, 7>(a, w, bias, h, ae, ib, out, a_next, B, L, Ci, Co, dil, st)
                : conv_launch<bf16, 7>(a, w, bias, h, ae, ib, out, a_next, B, L, Ci, Co, dil, st);
  return fp32 ? conv_launch<float, 1>(a, w, bias, h, ae, ib, out, a_next, B, L, Ci, Co, dil, st)
              : conv_launch<bf16, 1>(a, w, bias, h, ae, ib, out, a_next, B, L, Ci, Co, dil, st);
}

// The block's transposed conv (K = 2s, pad s/2) with the first unit's Snake1.
extern "C" int acestep_gen_upsample(const void* a, const void* w, const void* bias, const void* ae,
                                    const void* ib, void* y, void* a1, int B, int L, int Ci, int Co,
                                    int s, int fp32, void* stream) {
  if (B <= 0 || L <= 0 || Ci <= 0 || Co <= 0 || s < 2 || s % 2) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? upsample_launch<float>(a, w, bias, ae, ib, y, a1, B, L, Ci, Co, s, st)
              : upsample_launch<bf16>(a, w, bias, ae, ib, y, a1, B, L, Ci, Co, s, st);
}
