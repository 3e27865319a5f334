// Oobleck decoder kernels for Hopper (sm_90a): Snake and a conv-as-GEMM with
// fused epilogues, composed by ops/oobleck_kernels.py into
//   - decoder_block_kernel (replaces `decoder_block_pallas`,
//     acestep_tpu/ops/pallas_vae.py): Snake -> ConvTranspose1d(K=2s, pad s/2)
//     -> 3 residual units, for blocks with c_out <= 512;
//   - res_units_kernel (replaces `res_units_pallas`, same file): the
//     3-residual-unit chain alone, at 1024 channels after decoder block 0.
//
// Design taken (the first of the two the port allows): a block runs as a
// short fixed sequence of launches, not one fused launch. A whole fused block
// at 512 channels, with its 8*C*C weights per unit, does not fit the 227 KB
// of shared memory of an SM. Per residual unit:
//   snake_kernel   a = Snake1(h)                     -> bf16
//   conv_gemm      z = Snake2(conv_k7,dil d(a) + b1) -> bf16
//   conv_gemm      h' = h + conv_k1(z) + b2          -> bf16
// and the upsampling is Snake followed by one conv_gemm over three taps
// (x[t-1], x[t], x[t+1]) whose weights hold the transposed conv's phases in
// (t, phase*C_out + c) columns, so the output buffer (B, L, s*C_out) is the
// upsampled (B, L*s, C_out) activation. These are exactly the bf16 rounding
// points of the TPU kernel: Snake output, the fp32 k7 sum after Snake2, the
// fp32 residual sum, and the fp32 conv_t sum are each rounded once.
//
// conv_gemm: one CTA of 8 warps per (128 rows, 128 output channels, batch);
// K runs over taps x input channels in steps of 32 through a two-stage
// cp.async pipeline; bf16 mma.sync with fp32 accumulators; rows outside
// [0, L) are zero-filled by the copy (torch's zero padding; Snake(0) = 0).
// Weights stream from L2. Bound: at 128-512 channels the residual units move
// about 14 bytes per row-channel against 16*C flops per row-channel, so the
// narrow late blocks are bytes-bound and block 0 (1024 channels) is
// operations-bound; the extra launches cost one bf16 round trip of the
// activation each, which a fused block would save.

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;  // padded rows: conflict-free ldmatrix
constexpr int LDB = BN + 8;

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

// y[b, t, n] = epi( sum_j sum_ci x[b, t + j*dil - pad, ci] * w[j, ci, n] )
// epi: + bias[n]; optional Snake (ae2, ib2); optional + res[b, t, n].
__global__ void __launch_bounds__(THREADS)
conv_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ ae2,
                 const float* __restrict__ ib2, const bf16* __restrict__ res,
                 bf16* __restrict__ y, int L, int Ci, int N, int KT, int dil, int pad) {
  __shared__ __align__(16) bf16 sA[2][BM * LDA];
  __shared__ __align__(16) bf16 sB[2][BK * LDB];

  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: 32 rows x 64 cols
  const int g = lane >> 2, t4 = lane & 3;

  const bf16* xb = x + (long long)b * L * Ci;
  const int n_ci = Ci / BK;
  const int n_iter = KT * n_ci;

  auto load_stage = [&](int stage, int it) {
    const int j = it / n_ci;
    const int ci0 = (it % n_ci) * BK;
    const int shift = j * dil - pad;
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // A: 128 rows x 4 chunks of 8
      const int c = tid + u * THREADS;
      const int r = c >> 2, col = (c & 3) * 8;
      const int t = t0 + r + shift;
      const bool ok = t >= 0 && t < L;
      const bf16* src = ok ? xb + (long long)t * Ci + ci0 + col : x;
      cp_async16(smem_addr(&sA[stage][r * LDA + col]), src, ok);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // B: 32 rows x 16 chunks of 8
      const int c = tid + u * THREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      const bf16* src = w + ((long long)j * Ci + ci0 + r) * N + n0 + col;
      cp_async16(smem_addr(&sB[stage][r * LDB + col]), src, true);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c][0] = acc[a][c][1] = acc[a][c][2] = acc[a][c][3] = 0.f;
  }

  load_stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    if (it + 1 < n_iter) load_stage(st ^ 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* p = &sA[st][(wm * 32 + mt * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8];
        ldsm_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3], smem_addr(p));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        const bf16* p = &sB[st][(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn * 64 +
                                np * 16 + (lane >> 4) * 8];
        ldsm_x4_t(b0, b1, b2, b3, smem_addr(p));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], af[mt], b0, b1);
          mma_bf16_16816(acc[mt][2 * np + 1], af[mt], b2, b3);
        }
      }
    }
    __syncthreads();
  }

  bf16* yb = y + (long long)b * L * N;
  const bf16* rb = res ? res + (long long)b * L * N : nullptr;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * 32 + mt * 16 + g + h * 8;
      if (t >= L) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wn * 64 + nt * 8 + 2 * t4;
        float v0 = acc[mt][nt][2 * h] + bias[n];
        float v1 = acc[mt][nt][2 * h + 1] + bias[n + 1];
        if (ae2 != nullptr) {
          v0 = v0 + ib2[n] * sin2_poly(ae2[n] * v0);
          v1 = v1 + ib2[n + 1] * sin2_poly(ae2[n + 1] * v1);
        }
        if (rb != nullptr) {
          const __nv_bfloat162 r2 =
              *reinterpret_cast<const __nv_bfloat162*>(rb + (long long)t * N + n);
          v0 += __bfloat162float(r2.x);
          v1 += __bfloat162float(r2.y);
        }
        *reinterpret_cast<uint32_t*>(yb + (long long)t * N + n) = pack_bf16(v0, v1);
      }
    }
  }
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

extern "C" int acestep_conv_gemm(const void* x, const void* w, const void* bias, const void* ae2,
                                 const void* ib2, const void* res, void* y, int B, int L, int Ci,
                                 int N, int KT, int dil, int pad, void* stream) {
  dim3 grid((L + BM - 1) / BM, N / BN, B);
  conv_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(ae2), static_cast<const float*>(ib2),
      static_cast<const bf16*>(res), static_cast<bf16*>(y), L, Ci, N, KT, dil, pad);
  return static_cast<int>(cudaGetLastError());
}
