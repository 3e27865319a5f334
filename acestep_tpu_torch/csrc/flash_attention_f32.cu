// Banded flash attention in fp32 for Hopper (sm_90a): kernel 1's fp32 route.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_band_kernel` of
// acestep_tpu/ops/pallas_attention.py at fp32 storage. The JAX training path
// runs the DiT in fp32 (fp32 batches, bf16 weights cast up by `linear`), so
// the Pallas kernel there sees fp32 q/k/v, keeps them in fp32 and accumulates
// in fp32. This kernel computes the same: q k^T in fp32 times `scale`, the
// band / causal / kv-padding mask with masked scores at the finite
// NEG_INF = -0.7 * FLT_MAX (a row with no valid key averages the visited keys
// instead of giving NaN), an online softmax, P V accumulated in fp32, and the
// division by max(l, 1e-30). Q, K, V and O are (B, L, N, 128), read through
// batch and row strides, heads packed; GQA maps q head h to kv head
// h / (Nq / Nkv). No TF32 anywhere: every product is an fp32 FMA.
//
// Bound: operations. 4 * pairs * 128 flops per head against 4 * (Lq + 2 Lk) *
// 128 bytes; at the fp32 peak outside the tensor cores (67 TFLOP/s) a DiT
// full layer of 750 tokens x 16 heads is 0.069 ms, far above its 0.02 ms of
// bytes. This first version is plain SIMT: one CTA of 256 threads per
// (64-row q tile, q head, batch); Q stays in shared memory; 64-key K/V tiles
// stream through a two-stage cp.async ring, the next tile loading while this
// one computes; each thread holds a 4 x 4 block of scores and a 4 x 8 block
// of O, fed by 16-byte shared-memory loads along the head dimension. Only the
// key tiles that intersect the band [q0 - w, q1 + w] (up to q1 when causal)
// are visited, so sliding-window layers do O(L * w) work. What holds it below
// the fp32 peak: every FMA of the score product needs a shared-memory operand
// (8 LDS.128 per 64 FMAs), one CTA fits an SM (182 KB of shared memory), and
// P makes a round trip through shared memory. The way to the tensor cores is
// 3xTF32 (mma.sync or wgmma-tf32 with the low parts as a correction), which
// keeps fp32 accuracy at up to three times the TF32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;
constexpr int BQ = 64;            // query rows a CTA
constexpr int BK = 64;            // keys a tile
constexpr int THREADS = 256;      // 16 x 16: ty owns rows 4ty..4ty+3, tx keys tx + 16j
constexpr int LDQ = HD + 4;       // shared-memory pitch of Q, K and V rows (conflict-free LDS.128)
constexpr int LDP = BK + 4;       // pitch of P
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

constexpr int Q_FLOATS = BQ * LDQ;
constexpr int KV_FLOATS = BK * LDQ;
constexpr int P_FLOATS = BQ * LDP;
constexpr size_t SMEM_BYTES = sizeof(float) * (Q_FLOATS + 4 * KV_FLOATS + P_FLOATS);

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* kv_mask;  // (B, Lk) int32, nonzero = valid key; may be null
  float* o;
  long long sqb, sql, skb, skl, svb, svl, sob, sol;
  int Lq, Lk, Nq, Nkv;
  float scale;
  int window;  // < 0: none
  int causal;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + 64) of one head into shared memory at pitch LDQ; rows at or
// past L are zero-filled. 64 rows x 32 chunks of 16 bytes: 8 a thread.
__device__ __forceinline__ void load_rows(float* dst, const float* head, long long s_row, int r0, int L,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 5, col = (c & 31) * 4;
    const bool ok = r0 + row < L;
    const float* src = ok ? head + (long long)(r0 + row) * s_row + col : head;
    cp_async16(dst + row * LDQ + col, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS) flash_f32_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + Q_FLOATS;  // stage s: K at sKV + 2 s KV_FLOATS, V after it
  float* sP = sKV + 4 * KV_FLOATS;

  const int hq = blockIdx.x, b = blockIdx.y;
  const int n_qt = gridDim.z;
  const int qt = p.causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;  // causal: longest rows first
  const int q0 = qt * BQ;
  const int hk = hq / (p.Nq / p.Nkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const int q_last = min(q0 + BQ, p.Lq) - 1;
  int lo = 0, hi = p.Lk - 1;
  if (p.window >= 0) lo = max(0, q0 - p.window);
  if (p.causal) hi = min(hi, q_last);
  else if (p.window >= 0) hi = min(hi, q_last + p.window);
  const int kt0 = lo / BK;
  const int n_tiles = hi >= lo ? hi / BK + 1 - kt0 : 0;

  const float* qh = p.q + b * p.sqb + (long long)hq * HD;
  const float* kh = p.k + b * p.skb + (long long)hk * HD;
  const float* vh = p.v + b * p.svb + (long long)hk * HD;
  const int* mrow = p.kv_mask == nullptr ? nullptr : p.kv_mask + (long long)b * p.Lk;

  load_rows(sQ, qh, p.sql, q0, p.Lq, tid);
  if (n_tiles > 0) {
    load_rows(sKV, kh, p.skl, kt0 * BK, p.Lk, tid);
    load_rows(sKV + KV_FLOATS, vh, p.svl, kt0 * BK, p.Lk, tid);
  }
  cp_async_commit();

  float acc[4][8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = (kt0 + t) * BK;
    const float* sK = sKV + 2 * (t & 1) * KV_FLOATS;
    const float* sV = sK + KV_FLOATS;
    if (t + 1 < n_tiles) {
      float* nK = sKV + 2 * ((t + 1) & 1) * KV_FLOATS;
      load_rows(nK, kh, p.skl, k0 + BK, p.Lk, tid);
      load_rows(nK + KV_FLOATS, vh, p.svl, k0 + BK, p.Lk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Scores of rows 4ty + i against keys k0 + tx + 16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      valid[j] = key < p.Lk && (mrow == nullptr || __ldg(mrow + key) != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = row - (k0 + tx + 16 * j);
        bool ok = valid[j];
        if (p.causal) ok = ok && d >= 0;
        if (p.window >= 0) ok = ok && d <= p.window && (p.causal || -d <= p.window);
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        l_run[i] += e;
        sP[(4 * ty + i) * LDP + tx + 16 * j] = e;
      }
    }
    __syncthreads();

    // O[rows, 4tx..4tx+3 and 64+4tx..] += P V.
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v0 = *reinterpret_cast<const float4*>(sV + (kk + u) * LDQ + 4 * tx);
        const float4 v1 = *reinterpret_cast<const float4*>(sV + (kk + u) * LDQ + 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = fmaf(pu, v0.x, acc[i][0]);
          acc[i][1] = fmaf(pu, v0.y, acc[i][1]);
          acc[i][2] = fmaf(pu, v0.z, acc[i][2]);
          acc[i][3] = fmaf(pu, v0.w, acc[i][3]);
          acc[i][4] = fmaf(pu, v1.x, acc[i][4]);
          acc[i][5] = fmaf(pu, v1.y, acc[i][5]);
          acc[i][6] = fmaf(pu, v1.z, acc[i][6]);
          acc[i][7] = fmaf(pu, v1.w, acc[i][7]);
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage and P
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const float den = fmaxf(l, 1e-30f);
    const int row = q0 + 4 * ty + i;
    if (row >= p.Lq) continue;
    float* orow = p.o + b * p.sob + row * p.sol + (long long)hq * HD;
    *reinterpret_cast<float4*>(orow + 4 * tx) =
        make_float4(acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
    *reinterpret_cast<float4*>(orow + 64 + 4 * tx) =
        make_float4(acc[i][4] / den, acc[i][5] / den, acc[i][6] / den, acc[i][7] / den);
  }
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int acestep_flash_attention_f32(const void* q, const void* k, const void* v, const void* kv_mask,
                                           void* o, int B, int Lq, int Lk, int Nq, int Nkv, long long sqb,
                                           long long sql, long long skb, long long skl, long long svb,
                                           long long svl, long long sob, long long sol, float scale, int window,
                                           int causal, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.o = static_cast<float*>(o);
  p.sqb = sqb;
  p.sql = sql;
  p.skb = skb;
  p.skl = skl;
  p.svb = svb;
  p.svl = svl;
  p.sob = sob;
  p.sol = sol;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Nq = Nq;
  p.Nkv = Nkv;
  p.scale = scale;
  p.window = window;
  p.causal = causal;
  const dim3 grid(Nq, B, (Lq + BQ - 1) / BQ);
  flash_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
