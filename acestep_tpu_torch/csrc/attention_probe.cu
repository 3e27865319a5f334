// Stage-cost probe of the attention kernel for Hopper (sm_90a), bf16 in.
//
// Replaces the Pallas TPU kernel of tools/probe_kernel_parts.py
// (`make_kernel`, launched by `run_mode`): stripped variants of attention
// that cost each stage. Per (batch, q head, q tile) and over ALL keys (no
// mask): S = Q K^T / sqrt(128) in fp32, then P by mode
//   DOTS   S * 1e-3
//   MAX    S - rowmax(S)
//   EXP    exp(S - rowmax(S))
//   EXPF   the same with the degree-5 exp2 polynomial of `_exp_softmax_fast`
//   FULL   softmax(S)
//   FULLF  softmax with the polynomial exp
// and O = bf16(P) V with fp32 accumulators. KT = true reads K stored
// transposed, (B, Nkv, 128, L); otherwise every tensor is head-major
// (B, N, L, 128). GQA: kv head = q head / (Nq / Nkv).
//
// Design: the tile loop of csrc/flash_attention.cu (one warp per 16 query
// rows, BQ rows per CTA, 64-key tiles in shared memory, bf16 mma.sync with
// fp32 accumulators), so its times cost the stages of the port's own
// attention kernel. The TPU kernel holds a whole (bq x L) score row in VMEM
// and takes the final row max before P V; here the row max is a running one:
//   EXP/EXPF/FULL/FULLF rescale the accumulator by exp(m_old - m_new) (online
//     softmax; the polynomial modes rescale with the polynomial);
//   MAX uses sum_j (S_j - m) V_j = sum_j (S_j - m_run) V_j - (m - m_run) sum_j V_j:
//     each tile adds bf16(S - m_run) V and, when m_run grows by d, subtracts
//     d * (column sums of the V tiles seen so far), kept in shared memory.
// Both round P at another point than the TPU's bf16(S - m_final); the plain
// version follows the TPU and the comparison uses a tolerance relative to
// max|ref|.
//
// Bound: 4 * Nq * L^2 * 128 flops per batch row against (2 Nq + 2 Nkv) L 128
// bf16 bytes: operations-bound (0.122 ms at L = 3840, 16 q heads, on the
// H100's 989 TFLOP/s). Tiles load synchronously, so this first version runs
// well below that; PERF.md keeps its times.

#include <float.h>

#include "common.cuh"

namespace {

constexpr int HD = 128;
constexpr int BKV = 64;
constexpr int LDS = HD + 8;     // padded row of a (rows x 128) tile
constexpr int LDKT = BKV + 8;   // padded row of a (128 x 64 keys) K^T tile
constexpr float NEG_INF = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE = 0.08838834764831845f;

enum Mode { DOTS = 0, MAX = 1, EXP = 2, EXPF = 3, FULL = 4, FULLF = 5 };

// exp(x) via exponent-bit assembly and a degree-5 exp2 polynomial
// (`_exp_softmax_fast` of the TPU probe: same coefficients, clamp at -87).
__device__ __forceinline__ float exp_poly(float x) {
  const float y = fmaxf(x, -87.0f) * LOG2E;
  const float yi = floorf(y);
  const float yf = y - yi;
  float p = 1.89437864e-03f;
  p = p * yf + 8.94057778e-03f;
  p = p * yf + 5.58765685e-02f;
  p = p * yf + 2.40131684e-01f;
  p = p * yf + 6.93156779e-01f;
  p = p * yf + 9.99999769e-01f;
  return p * __int_as_float(((int)yi + 127) << 23);
}

template <int MODE>
__device__ __forceinline__ float mode_exp(float x) {
  if (MODE == EXPF || MODE == FULLF) return exp_poly(x);
  return exp2f(x * LOG2E);
}

template <bool KT, int BQ>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * LDS + (KT ? HD * LDKT : BKV * LDS) + BKV * LDS) * sizeof(bf16) +
         HD * sizeof(float);
}

template <int MODE, bool KT, int BQ>
__global__ void __launch_bounds__(BQ * 2)
probe_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int L, int Nq, int Nkv) {
  constexpr int THREADS = BQ * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDS;
  bf16* sV = sK + (KT ? HD * LDKT : BKV * LDS);
  float* sVsum = reinterpret_cast<float*>(sV + BKV * LDS);  // MAX: column sums of V so far

  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Nq / Nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long LH = (long long)L * HD;
  const bf16* qb = q + ((long long)b * Nq + hq) * LH;
  const bf16* kb = k + ((long long)b * Nkv + hk) * LH;
  const bf16* vb = v + ((long long)b * Nkv + hk) * LH;
  bf16* ob = o + ((long long)b * Nq + hq) * LH;

  for (int c = tid; c < BQ * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(sQ + r * LDS + col) =
        *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * HD + col);
  }
  if (MODE == MAX) {
    for (int c = tid; c < HD; c += THREADS) sVsum[c] = 0.f;
  }
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const bf16* p = sQ + (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8;
    ldsm_x4(qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], smem_addr(p));
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < L; k0 += BKV) {
    __syncthreads();  // the previous tile (and its V column sums) is consumed
    if (KT) {
      for (int c = tid; c < HD * (BKV / 8); c += THREADS) {
        const int d = c / (BKV / 8), col = (c % (BKV / 8)) * 8;
        *reinterpret_cast<uint4*>(sK + d * LDKT + col) =
            *reinterpret_cast<const uint4*>(kb + (long long)d * L + k0 + col);
      }
    } else {
      for (int c = tid; c < BKV * (HD / 8); c += THREADS) {
        const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
        *reinterpret_cast<uint4*>(sK + r * LDS + col) =
            *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * HD + col);
      }
    }
    for (int c = tid; c < BKV * (HD / 8); c += THREADS) {
      const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
      *reinterpret_cast<uint4*>(sV + r * LDS + col) =
          *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * HD + col);
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp.
    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        if (KT) {
          const bf16* p = sK + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDKT + np * 16 +
                          (lane >> 4) * 8;
          ldsm_x4_t(b0, b1, b2, b3, smem_addr(p));
        } else {
          const bf16* p = sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + ks * 16 +
                          ((lane >> 3) & 1) * 8;
          ldsm_x4(b0, b1, b2, b3, smem_addr(p));
        }
        mma_bf16_16816(s[2 * np], qf[ks], b0, b1);
        mma_bf16_16816(s[2 * np + 1], qf[ks], b2, b3);
      }
    }

    if (MODE == DOTS) {
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] * SCALE * 1e-3f;
    } else {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= SCALE;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float m_old[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
        m_old[r] = m_run[r];
        m_run[r] = fmaxf(m_run[r], mx[r]);
      }
      if (MODE == MAX) {
        // acc held sum (S - m_old) V over earlier tiles: move it to m_run.
        // Before the first tile sVsum is 0 and the finite d times 0 is 0.
        const float d0 = m_run[0] - m_old[0], d1 = m_run[1] - m_old[1];
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const float vs0 = sVsum[nt * 8 + 2 * t4], vs1 = sVsum[nt * 8 + 2 * t4 + 1];
          acc[nt][0] -= d0 * vs0;
          acc[nt][1] -= d0 * vs1;
          acc[nt][2] -= d1 * vs0;
          acc[nt][3] -= d1 * vs1;
        }
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] -= m_run[e >> 1];
      } else {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          alpha[r] = mode_exp<MODE>(m_old[r] - m_run[r]);
          l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          acc[i][0] *= alpha[0];
          acc[i][1] *= alpha[0];
          acc[i][2] *= alpha[1];
          acc[i][3] *= alpha[1];
        }
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = mode_exp<MODE>(s[nt][e] - m_run[e >> 1]);
            s[nt][e] = p;
            l_run[e >> 1] += p;
          }
      }
    }

    // O += bf16(P) V: the S accumulators are already in the A-fragment layout.
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        const bf16* p = sV + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + dp * 16 +
                        (lane >> 4) * 8;
        ldsm_x4_t(b0, b1, b2, b3, smem_addr(p));
        mma_bf16_16816(acc[2 * dp], pa, b0, b1);
        mma_bf16_16816(acc[2 * dp + 1], pa, b2, b3);
      }
    }

    if (MODE == MAX) {
      __syncthreads();  // every warp has read sVsum for this tile
      for (int c = tid; c < HD; c += THREADS) {
        float t = 0.f;
        for (int r = 0; r < BKV; ++r) t += __bfloat162float(sV[r * LDS + c]);
        sVsum[c] += t;
      }
    }
  }

  float inv[2] = {1.f, 1.f};
  if (MODE == FULL || MODE == FULLF) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
  }
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* orow = ob + (long long)(row0 + r * 8) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t4) =
          pack_bf16(acc[nt][2 * r] * inv[r], acc[nt][2 * r + 1] * inv[r]);
    }
  }
}

template <int MODE, bool KT, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int L, int Nq, int Nkv,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KT, BQ>();
  cudaFuncSetAttribute(probe_kernel<MODE, KT, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(L / BQ, Nq, B);
  probe_kernel<MODE, KT, BQ><<<grid, BQ * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), L, Nq, Nkv);
  return static_cast<int>(cudaGetLastError());
}

template <bool KT, int BQ>
int by_mode(int mode, const void* q, const void* k, const void* v, void* o, int B, int L,
            int Nq, int Nkv, cudaStream_t st) {
  switch (mode) {
    case DOTS: return launch<DOTS, KT, BQ>(q, k, v, o, B, L, Nq, Nkv, st);
    case MAX: return launch<MAX, KT, BQ>(q, k, v, o, B, L, Nq, Nkv, st);
    case EXP: return launch<EXP, KT, BQ>(q, k, v, o, B, L, Nq, Nkv, st);
    case EXPF: return launch<EXPF, KT, BQ>(q, k, v, o, B, L, Nq, Nkv, st);
    case FULL: return launch<FULL, KT, BQ>(q, k, v, o, B, L, Nq, Nkv, st);
    case FULLF: return launch<FULLF, KT, BQ>(q, k, v, o, B, L, Nq, Nkv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BQ>
int by_layout(int kt, int mode, const void* q, const void* k, const void* v, void* o, int B,
              int L, int Nq, int Nkv, cudaStream_t st) {
  return kt ? by_mode<true, BQ>(mode, q, k, v, o, B, L, Nq, Nkv, st)
            : by_mode<false, BQ>(mode, q, k, v, o, B, L, Nq, Nkv, st);
}

}  // namespace

// mode: 0 dots, 1 +max, 2 +exp, 3 +expf, 4 full, 5 fullf; kt: K stored (B, Nkv, 128, L);
// bq: 64 or 128 query rows per CTA. L must be a multiple of bq.
extern "C" int acestep_attention_probe(const void* q, const void* k, const void* v, void* o,
                                       int B, int L, int Nq, int Nkv, int mode, int kt, int bq,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq == 64) return by_layout<64>(kt, mode, q, k, v, o, B, L, Nq, Nkv, st);
  if (bq == 128) return by_layout<128>(kt, mode, q, k, v, o, B, L, Nq, Nkv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
