// Banded flash attention for Hopper (sm_90a), bf16 in, fp32 scores.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_band_kernel` of
// acestep_tpu/ops/pallas_attention.py. Computes softmax(Q K^T * scale + mask) V
// with GQA (kv head = q head / groups), a causal mask, a window |i-j| <= w
// (0 <= i-j <= w when causal) and a key-padding mask. Q, K, V and O are
// (B, L, N, 128), read through batch and row strides.
//
// Bound: at head_dim 128 the work is operations-bound (4*Lq*Lk*128 flops per
// head against 2*(Lq+2*Lk)*128 bytes): 0.47 ms for one 7 500-token DiT layer
// at the H100's 989 TFLOP/s. What held the first version far from it was the
// tile loop: synchronous tile loads, Ampere-style tensor-core products, one
// 64-row CTA per K/V fetch, and the mask applied to every score. This
// version runs the shared Hopper mainloop of attention_sm90.cuh: a producer
// thread keeps TMA loads of K/V tiles in flight through a three-stage ring
// while two consumer warpgroups (128 query rows per CTA) run wgmma on the
// tiles that have arrived, each overlapping one tile's softmax with the
// previous tile's P V, and taking turns with the other to issue.
//
// The Op here:
//   - visits only the 128-key tiles that intersect the band [q0 - w, q1 + w]
//     (up to q1 when causal), so sliding-window layers do O(L*w) work; causal
//     grids run the longest q tiles first;
//   - classifies each (warpgroup rows, key tile) pair: interior when every
//     pair is inside the band/causal geometry, the tile ends before Lk and all
//     its kv_mask entries are nonzero. Interior tiles only scale the scores;
//     edge tiles apply the element mask. Each warp reads the tile's kv_mask
//     slice with plain loads one tile ahead (a mask row is Lk*4 bytes, not
//     16-byte aligned in general) and votes on it;
//   - keeps the TPU kernel's numerics: fp32 scores with scale*log2(e) folded
//     in and exp2f, an online row max with the accumulator rescaled by
//     exp2(m_old - m_new), P rounded to bf16 before P V while the normaliser
//     sums fp32 P, the normaliser clamped at 1e-30, and masked scores at the
//     finite NEG_INF = -0.7 * FLT_MAX, so a row with no valid key averages the
//     visited keys instead of giving NaN. Keys at or past Lk are zero-filled
//     by TMA and masked here; rows at or past Lq are not stored.

#include "attention_sm90.cuh"

namespace {

using namespace sm90;

constexpr int NWG = 2;           // consumer warpgroups: 128 query rows per CTA
constexpr int BQ = NWG * 64;
constexpr int STAGES = 3;

struct FlashOp {
  static constexpr bool KT = false;

  struct Params {
    const int* kv_mask;  // (B, Lk) int32, nonzero = valid key; may be null
    bf16* o;
    long long sob, sol;
    int Lq, Lk, Nq, Nkv, n_qt;
    float sl2;           // scale * log2(e)
    int window;          // < 0: none
    int causal;
  };

  __device__ static Tile tile(const Params& p, int bq) {
    Tile t;
    t.hq = blockIdx.x;
    t.b = blockIdx.y;
    const int qt = p.causal ? p.n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;
    t.q0 = qt * bq;
    t.hk = t.hq / (p.Nq / p.Nkv);
    const int q_last = min(t.q0 + bq, p.Lq) - 1;
    int lo = 0, hi = p.Lk - 1;
    if (p.window >= 0) lo = max(0, t.q0 - p.window);
    if (p.causal) hi = min(hi, q_last);
    else if (p.window >= 0) hi = min(hi, q_last + p.window);
    t.kt_begin = lo / BKV;
    t.n_tiles = hi >= lo ? hi / BKV + 1 - t.kt_begin : 0;
    return t;
  }

  const Params p;
  const Tile t;
  const int* mrow;
  int r0;           // first query row of this warpgroup
  int ra;           // this thread's rows: ra and ra + 8
  int lane, t4;
  int next[4];      // the next tile's key validity, loaded one tile ahead
  uint32_t bits[4]; // the current tile's: bit c of bits[c / 32] for key k0 + c
  bool interior;
  float m_run[2], l_run[2], alpha[2];

  __device__ FlashOp(const Params& p_, const Tile& t_, int wg, int tid, float*)
      : p(p_), t(t_) {
    mrow = p.kv_mask == nullptr ? nullptr : p.kv_mask + (long long)t.b * p.Lk;
    r0 = t.q0 + wg * 64;
    lane = tid & 31;
    t4 = lane & 3;
    ra = r0 + (tid >> 5) * 16 + (lane >> 2);
    m_run[0] = m_run[1] = NEG_INF;
    l_run[0] = l_run[1] = 0.f;
    load_valid(t.kt_begin * BKV);
  }

  __device__ __forceinline__ void load_valid(int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + 32 * j + lane;
      next[j] = key < p.Lk ? (mrow == nullptr ? 1 : __ldg(mrow + key)) : 0;
    }
  }

  // Every (row, key) pair of this warpgroup's rows and the tile is inside the band.
  __device__ __forceinline__ bool band_interior(int k0) const {
    const int d_max = r0 + 63 - k0;         // largest row - key
    const int d_min = r0 - (k0 + BKV - 1);  // smallest row - key
    if (p.causal && d_min < 0) return false;
    if (p.window >= 0 && (d_max > p.window || -d_min > p.window)) return false;
    return true;
  }

  __device__ __forceinline__ void begin_tile(int k0) {
    bool all = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits[j] = __ballot_sync(0xffffffff, next[j] != 0);
      all = all && bits[j] == 0xffffffffu;
    }
    interior = all && band_interior(k0);
    load_valid(k0 + BKV);
  }

  __device__ __forceinline__ void scores(float (&s)[64], int k0) {
    if (interior) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= p.sl2;
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
        const int key = k0 + col;
        const int row = ra + ((i >> 1) & 1) * 8;
        bool ok = (bits[i / 16] >> (col & 31)) & 1;
        const int d = row - key;
        if (p.causal) ok = ok && d >= 0;
        if (p.window >= 0) ok = ok && d <= p.window && -d <= p.window;
        s[i] = ok ? s[i] * p.sl2 : NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      const float e = exp2f(s[i] - m_run[r]);
      s[i] = e;
      l_run[r] += e;
    }
  }

  // O of the earlier tiles moves to the new row max.
  __device__ __forceinline__ void rescale(float (&acc)[64]) const {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
  }

  __device__ __forceinline__ void after_pv(const bf16*, int) {}

  __device__ __forceinline__ void finish(const float (&acc)[64]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + r * 8;
      const float inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
      if (row >= p.Lq) continue;
      bf16* orow = p.o + t.b * p.sob + row * p.sol + (long long)t.hq * HD;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
};

// (B, L, N, 128) with heads packed: map {128, L, N, B}, box {64, rows, 1, 1}.
bool rows_map(CUtensorMap* m, const void* base, int L, int N, int B, long long s_row,
              long long s_batch, int rows) {
  return make_map(m, base, {(uint64_t)HD, (uint64_t)L, (uint64_t)N, (uint64_t)B},
                  {(uint64_t)s_row, (uint64_t)HD, (uint64_t)s_batch},
                  {(uint32_t)BOX, (uint32_t)rows, 1u, 1u});
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int acestep_flash_attention(const void* q, const void* k, const void* v,
                                       const void* kv_mask, void* o, int B, int Lq, int Lk,
                                       int Nq, int Nkv, long long sqb, long long sql,
                                       long long skb, long long skl, long long svb,
                                       long long svl, long long sob, long long sol, float scale,
                                       int window, int causal, void* stream) {
  CUtensorMap mq, mk, mv;
  if (!rows_map(&mq, q, Lq, Nq, B, sql, sqb, BQ) || !rows_map(&mk, k, Lk, Nkv, B, skl, skb, BKV) ||
      !rows_map(&mv, v, Lk, Nkv, B, svl, svb, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashOp::Params p;
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.o = static_cast<bf16*>(o);
  p.sob = sob;
  p.sol = sol;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Nq = Nq;
  p.Nkv = Nkv;
  p.n_qt = (Lq + BQ - 1) / BQ;
  p.sl2 = scale * LOG2E;
  p.window = window;
  p.causal = causal;
  return launch<FlashOp, NWG, STAGES>(mq, mk, mv, p, dim3(Nq, B, p.n_qt),
                                      static_cast<cudaStream_t>(stream));
}
