// Banded flash attention in fp32 for Hopper (sm_90a): kernel 1's fp32 route.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_band_kernel` of
// acestep_tpu/ops/pallas_attention.py at fp32 storage. The JAX training path
// runs the DiT in fp32 (fp32 batches, bf16 weights cast up by `linear`), so
// the Pallas kernel there sees fp32 q/k/v, keeps them in fp32 and accumulates
// in fp32. This kernel computes the same: q k^T times `scale`, the band /
// causal / kv-padding mask with masked scores at the finite
// NEG_INF = -0.7 * FLT_MAX (a row with no valid key averages the visited keys
// instead of giving NaN), an online softmax, P V, and the division by
// max(l, 1e-30). Q, K, V and O are (B, L, N, 128), read through batch and row
// strides, heads packed; GQA maps q head h to kv head h / (Nq / Nkv).
//
// Arithmetic: 3xTF32 on the tensor cores, at fp32 accuracy. Every operand x
// of both products is split in registers as it is read from shared memory
// into hi = rna(x) and lo = rna(x - hi), rna being `cvt.rna.tf32.f32`'s
// rounding (to nearest, ties away from zero; see tf32_rna). Each product is
// three `mma.sync.m16n8k8.tf32`, the two small terms (lo.hi, hi.lo) before
// the large one (hi.hi); lo.lo is below fp32's last place. No single-pass
// TF32 anywhere. The tensor cores align the addends of an mma to the largest
// and drop the bits below it, so a long sum kept in them loses part of a
// last place at every step: kept there across a whole product, the sums read
// 2.5e-6 to 5.9e-6 from the plain version at the training shapes (H100 80GB
// HBM3), above the 3.1e-6 the route is held to. So the tensor cores sum
// only short runs from a zero accumulator, 16 products of Q.K^T (two k = 8
// steps) or the 32 keys of one tile of P V, and each run is added to its
// accumulator in fp32 outside them. The scale, the mask, the running max,
// expf, the rescaling of O and the division stay in fp32.
//
// Bound: operations. 4 * pairs * 128 flops per head against 4 * (Lq + 2 Lk) *
// 128 bytes. Three TF32 products per fp32 product put the tensor-core peak at
// 495 / 3 = 165 TFLOP/s: a DiT full layer at 1 x 768 (750 valid keys, 16 q
// heads) is 0.029 ms there, 0.070 ms at the 67 TFLOP/s of SIMT fp32. What
// holds it above: mma.sync's TF32 rate, well below wgmma's (builds that
// dropped one or two of the three products ran faster nearly in proportion,
// so the HMMAs take most of the time); the splits (five integer and float
// operations a value, every warp splitting the whole K and V tiles); and
// 192 CTAs on 132 SMs leave 72 SMs with one CTA while 60 run two.
//
// Design:
// - mma.sync, not wgmma. A tf32 wgmma takes both operands K-major; V (keys x
//   128, contiguous along the head) is MN-major for P V and would need a
//   transposed copy, and B must come from shared memory, so K and V^T would
//   each need a hi and a lo copy there: 128 KB for one 64-key stage before Q,
//   and the short runs summed outside the tensor cores would stall an
//   asynchronous wgmma at every run. With mma.sync shared memory holds only
//   the raw fp32 tiles.
// - A CTA is 4 warps x 16 query rows (64 rows) of one (q head, batch). Q stays
//   in shared memory; 32-key K/V tiles stream through a two-stage cp.async
//   ring, the next tile loading while this one computes. Q 36 KB + 2 x (K 18 +
//   V 16.5 KB) = 105 KB, so two CTAs share an SM (228 KB): the 192 CTAs of a
//   1 x 768 or a 1 x 750 layer (16 heads x 12 row tiles) are one wave on 132
//   SMs (264 slots); at one CTA an SM they would take 1.45 waves.
// - cp.async into padded rows, not TMA: the wrapper builds no tensor map per
//   call (the narrow shapes' time moves with the host), and the padded
//   pitches keep the fragment addresses plain. Q and K rows are 144 floats
//   apart: Q.K^T reads a float4 along the head (two k = 8 steps; the head
//   order inside the sum is free, so step 0 takes the .x/.y of each float4
//   and step 1 the .z/.w), and 144 = 16 mod 32 puts the 8 lanes of each
//   quarter-warp on 32 distinct banks. V rows are 132 floats apart (below).
// - P stays in registers. The S accumulator holds columns (2t, 2t+1) of rows
//   g, g+8 (g = lane / 4, t = lane % 4), the tf32 A fragment wants columns
//   (t, t+4). The key order inside one P V step is free, so A's column t is
//   key 2t and column t+4 is key 2t+1: P's fragment is S's accumulator as it
//   stands, and V's B fragment reads rows 2t and 2t+1 at column g, banks
//   8t + g (and + 4) at the pitch of 132: no shuffle and no bank conflict.
// - Only key tiles that meet the band [q0 - w, q1 + w] (up to q1 when causal)
//   are visited, so sliding layers do O(L * w) work. Causal CTAs run longest
//   rows first.
// - Deterministic: no split over keys, a fixed order of every sum.

#include "common.cuh"  // cp.async, tf32_rna, mma_tf32

namespace {

constexpr int HD = 128;
constexpr int BQ = 64;         // query rows a CTA
constexpr int BK = 32;         // keys a tile
constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int LDQK = HD + 16;  // pitch of Q and K rows: conflict-free float4 fragment loads
constexpr int LDV = HD + 4;    // pitch of V rows: conflict-free B fragments of P V
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

constexpr int Q_FLOATS = BQ * LDQK;
constexpr int K_FLOATS = BK * LDQK;
constexpr int STAGE_FLOATS = K_FLOATS + BK * LDV;
constexpr size_t SMEM_BYTES = sizeof(float) * (Q_FLOATS + 2 * STAGE_FLOATS);

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

// Rows [r0, r0 + ROWS) of one head into shared memory at pitch LD; rows at or
// past L are zero-filled. ROWS x 32 chunks of 16 bytes.
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* head, long long s_row, int r0, int L,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 32 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 5, col = (c & 31) * 4;
    const bool ok = r0 + row < L;
    const float* src = ok ? head + (long long)(r0 + row) * s_row + col : head;
    cp_async16(dst + row * LD + col, src, ok);
  }
}

// x = hi + lo + O(2^-22 |x|): both parts rounded to nearest TF32.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

// d += A B for one k = 8 step in 3xTF32 on the tensor cores, A = (a0, a1,
// a2, a3) and B = (b0, b1) as the m16n8k8 tf32 fragments hold them (a0: row
// g col t, a1: row g+8 col t, a2: row g col t+4, a3: row g+8 col t+4; b0:
// row t col g, b1: row t+4 col g). The small terms go in first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], Split a0, Split a1, Split a2, Split a3, Split b0,
                                           Split b1) {
  mma_tf32(d, a0.lo, a1.lo, a2.lo, a3.lo, b0.hi, b1.hi);
  mma_tf32(d, a0.hi, a1.hi, a2.hi, a3.hi, b0.lo, b1.lo);
  mma_tf32(d, a0.hi, a1.hi, a2.hi, a3.hi, b0.hi, b1.hi);
}

__device__ __forceinline__ void add4(float (&d)[4], const float (&x)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] += x[c];
}

__global__ void __launch_bounds__(THREADS, 2) flash_f32_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + Q_FLOATS;  // stage s: K at sKV + s STAGE_FLOATS, V after it

  const int hq = blockIdx.x, b = blockIdx.y;
  const int n_qt = gridDim.z;
  const int qt = p.causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;  // causal: longest rows first
  const int q0 = qt * BQ;
  const int hk = hq / (p.Nq / p.Nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;

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

  load_rows<BQ, LDQK>(sQ, qh, p.sql, q0, p.Lq, tid);
  if (n_tiles > 0) {
    load_rows<BK, LDQK>(sKV, kh, p.skl, kt0 * BK, p.Lk, tid);
    load_rows<BK, LDV>(sKV + K_FLOATS, vh, p.svl, kt0 * BK, p.Lk, tid);
  }
  cp_async_commit();

  // This thread's rows: g and g + 8 of its warp's 16.
  const int row0 = q0 + warp * 16 + g;
  const float* qf = sQ + (warp * 16 + g) * LDQK + 4 * t;
  float acc[16][4];  // O columns 8n + 2t, 8n + 2t + 1 of rows row0 ([0], [1]) and row0 + 8 ([2], [3])
  float m_run[2], l_run[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (kt0 + it) * BK;
    const float* sK = sKV + (it & 1) * STAGE_FLOATS;
    const float* sV = sK + K_FLOATS;
    if (it + 1 < n_tiles) {
      float* nK = sKV + ((it + 1) & 1) * STAGE_FLOATS;
      load_rows<BK, LDQK>(nK, kh, p.skl, k0 + BK, p.Lk, tid);
      load_rows<BK, LDV>(nK + K_FLOATS, vh, p.svl, k0 + BK, p.Lk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: s[j] holds keys k0 + 8j + 2t, + 1 of rows row0, row0 + 8.
    // Each u sums its 16 products on the tensor cores from zero (run) and
    // adds them to s in fp32.
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll 2
    for (int u = 0; u < HD / 16; ++u) {
      const float4 qa = *reinterpret_cast<const float4*>(qf + 16 * u);
      const float4 qb = *reinterpret_cast<const float4*>(qf + 8 * LDQK + 16 * u);
      const Split gx = split(qa.x), gy = split(qa.y), gz = split(qa.z), gw = split(qa.w);  // row g
      const Split hx = split(qb.x), hy = split(qb.y), hz = split(qb.z), hw = split(qb.w);  // row g + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (8 * j + g) * LDQK + 16 * u + 4 * t);
        float run[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(run, gx, hx, gy, hy, split(kv.x), split(kv.y));
        mma_3xtf32(run, gz, hz, gw, hw, split(kv.z), split(kv.w));
        add4(s[j], run);
      }
    }

    bool valid[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        valid[j][e] = key < p.Lk && (mrow == nullptr || __ldg(mrow + key) != 0);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = row - (k0 + 8 * j + 2 * t + e);
          bool ok = valid[j][e];
          if (p.causal) ok = ok && d >= 0;
          if (p.window >= 0) ok = ok && d <= p.window && (p.causal || -d <= p.window);
          float& x = s[j][2 * r + e];
          x = ok ? x * p.scale : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = expf(x - m_new);
          l_run[r] += x;
        }
    }

    // O += P V, one k = 8 step a key group j: A's column t is key 8j + 2t,
    // column t + 4 is key 8j + 2t + 1, so A is s[j] as it stands. Each
    // column block n sums the tile's 32 keys on the tensor cores from zero
    // and adds them to acc in fp32.
    Split pa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j][0] = split(s[j][0]);
      pa[j][1] = split(s[j][2]);
      pa[j][2] = split(s[j][1]);
      pa[j][3] = split(s[j][3]);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      float run[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* vf = sV + (8 * j + 2 * t) * LDV + g;
        mma_3xtf32(run, pa[j][0], pa[j][1], pa[j][2], pa[j][3], split(vf[8 * n]), split(vf[LDV + 8 * n]));
      }
      add4(acc[n], run);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= p.Lq) continue;
    float* orow = p.o + b * p.sob + row * p.sol + (long long)hq * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

cudaError_t set_attributes() {
  cudaError_t err =
      cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int acestep_flash_attention_f32(const void* q, const void* k, const void* v, const void* kv_mask,
                                           void* o, int B, int Lq, int Lk, int Nq, int Nkv, long long sqb,
                                           long long sql, long long skb, long long skl, long long svb,
                                           long long svl, long long sob, long long sol, float scale, int window,
                                           int causal, void* stream) {
  cudaError_t err = set_attributes();
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

// CTAs of the kernel that one SM holds at once (the occupancy the design
// asks for is 2), or minus a cudaError_t.
extern "C" int acestep_flash_attention_f32_ctas_per_sm() {
  cudaError_t err = set_attributes();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_f32_kernel, THREADS, SMEM_BYTES);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
