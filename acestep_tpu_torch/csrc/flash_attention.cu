// Banded flash attention for Hopper (sm_90a), bf16 in, fp32 scores.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_band_kernel` of
// acestep_tpu/ops/pallas_attention.py. Computes softmax(Q K^T * scale + mask) V
// with GQA (kv head = q head / groups), a causal mask, a window |i-j| <= w
// (0 <= i-j <= w when causal) and a key-padding mask.
//
// Design: one CTA of 4 warps per (q tile of 64 rows, q head, batch); each warp
// owns 16 query rows. The CTA walks only the 64-key tiles that intersect the
// band [q0 - w, q1 + w] (up to q1 when causal) with an online softmax, so
// sliding-window layers do O(L*w) work. Q K^T and P V are bf16 mma.sync
// products with fp32 accumulators; P is rounded to bf16 for the second
// product as in the TPU kernel, while the normaliser sums fp32 P. Masked
// scores take the finite NEG_INF = -0.7 * FLT_MAX of the TPU kernel, so a row
// with no valid key averages the visited keys instead of giving NaN, and the
// normaliser is clamped at 1e-30. Q, K and V are read in their (B, L, N, 128)
// layout through batch and row strides; keys at or past Lk are zero-filled
// and masked inside the kernel.
//
// Bound: at the DiT's head_dim 128 the work is operations-bound on paper
// (4*Lq*Lk*128 flops against 2*(Lq+2*Lk)*128 bytes per head). This first
// version loads tiles synchronously (no cp.async/TMA pipeline, no wgmma), so
// it runs well below the tensor-core peak; PERF.md keeps its times.

#include <float.h>

#include "common.cuh"

namespace {

constexpr int HD = 128;          // head dim
constexpr int BQ = 64;           // query rows per CTA
constexpr int BKV = 64;          // keys per tile
constexpr int LDS = HD + 8;      // padded smem row (272 bytes): conflict-free ldmatrix
constexpr int THREADS = 128;
constexpr float NEG_INF = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_BYTES = (size_t)(BQ + 2 * BKV) * LDS * sizeof(bf16) + BKV * sizeof(int);

__global__ void __launch_bounds__(THREADS)
flash_band_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ kv_mask,
                  bf16* __restrict__ o, int Lq, int Lk, int Nq, int Nkv,
                  long long sqb, long long sql, long long skb, long long skl,
                  long long svb, long long svl, long long sob, long long sol,
                  float scale, int window, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDS;
  bf16* sV = sK + BKV * LDS;
  int* sM = reinterpret_cast<int*>(sV + BKV * LDS);

  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Nq / Nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const bf16* qb = q + b * sqb + (long long)hq * HD;
  const bf16* kb = k + b * skb + (long long)hk * HD;
  const bf16* vb = v + b * svb + (long long)hk * HD;

  for (int c = tid; c < BQ * (HD / 8); c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Lq) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * sql + col);
    *reinterpret_cast<uint4*>(sQ + r * LDS + col) = val;
  }

  // Key tiles that intersect the band of this q tile.
  const int q_last = min(q0 + BQ, Lq) - 1;
  int lo = 0, hi = Lk - 1;
  if (window >= 0) lo = max(0, q0 - window);
  if (causal) hi = min(hi, q_last);
  else if (window >= 0) hi = min(hi, q_last + window);
  const int kt_begin = lo / BKV;
  const int kt_end = hi >= lo ? hi / BKV + 1 : kt_begin;

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
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const float sl2 = scale * LOG2E;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BKV * (HD / 8); c += THREADS) {
      const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < Lk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (k0 + r) * skl + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + (k0 + r) * svl + col);
      }
      *reinterpret_cast<uint4*>(sK + r * LDS + col) = kv4;
      *reinterpret_cast<uint4*>(sV + r * LDS + col) = vv4;
    }
    if (tid < BKV) {
      const int key = k0 + tid;
      sM[tid] = key < Lk && (kv_mask == nullptr || kv_mask[(long long)b * Lk + key] != 0);
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
        const bf16* p = sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + ks * 16 +
                        ((lane >> 3) & 1) * 8;
        ldsm_x4(b0, b1, b2, b3, smem_addr(p));
        mma_bf16_16816(s[2 * np], qf[ks], b0, b1);
        mma_bf16_16816(s[2 * np + 1], qf[ks], b2, b3);
      }
    }

    // Mask, scale into the log2 domain, and take the row maxima.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t4 + (e & 1);
        const int key = k0 + kl;
        const int qi = row0 + (e >> 1) * 8;
        bool ok = sM[kl] != 0;
        if (causal) ok = ok && key <= qi;
        if (window >= 0) {
          const int d = qi - key;
          ok = ok && (causal ? d <= window : (d <= window && -d <= window));
        }
        const float val = ok ? s[nt][e] * sl2 : NEG_INF;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V: the S accumulators are already in the A-fragment layout.
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
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + r * 8;
    if (qi >= Lq) continue;
    bf16* orow = o + b * sob + qi * sol + (long long)hq * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const uint32_t pk = pack_bf16(acc[nt][2 * r] * inv[r], acc[nt][2 * r + 1] * inv[r]);
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t4) = pk;
    }
  }
}

}  // namespace

extern "C" int acestep_flash_attention(const void* q, const void* k, const void* v,
                                       const void* kv_mask, void* o, int B, int Lq, int Lk,
                                       int Nq, int Nkv, long long sqb, long long sql,
                                       long long skb, long long skl, long long svb,
                                       long long svl, long long sob, long long sol, float scale,
                                       int window, int causal, void* stream) {
  cudaFuncSetAttribute(flash_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  dim3 grid((Lq + BQ - 1) / BQ, Nq, B);
  flash_band_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_mask), static_cast<bf16*>(o), Lq, Lk, Nq, Nkv, sqb, sql, skb,
      skl, svb, svl, sob, sol, scale, window, causal);
  return static_cast<int>(cudaGetLastError());
}
