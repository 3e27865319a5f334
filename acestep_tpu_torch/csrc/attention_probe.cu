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
// (B, N, L, 128). GQA: kv head = q head / (Nq / Nkv). L is a multiple of the
// CTA's query rows (64 or 128); keys past L in the last 128-key tile are
// masked.
//
// Design: the Hopper mainloop of attention_sm90.cuh, the one kernel 1 runs
// (TMA ring of K/V tiles fed by a producer thread, wgmma for Q K^T and P V,
// P kept in registers), so the mode times cost the stages of the port's own
// attention kernel. 64 query rows per CTA is one consumer warpgroup, 128 is
// two. K transposed is the MN-major B operand of Q K^T (descriptor transpose
// bit). The TPU kernel holds a whole (bq x L) score row in VMEM and takes the
// final row max before P V; here the row max is a running one:
//   EXP/EXPF/FULL/FULLF rescale the accumulator by exp(m_old - m_new) (online
//     softmax; the polynomial modes rescale with the polynomial);
//   MAX uses sum_j (S_j - m) V_j = sum_j (S_j - m_run) V_j - (m - m_run) sum_j V_j:
//     each tile adds bf16(S - m_run) V and, when m_run grows by d, subtracts
//     d * (column sums of the V tiles seen so far). The column sums are read
//     from the swizzled V tile in shared memory (the 128-byte swizzle undone
//     in the index: 16-byte chunk c of row r sits at chunk c ^ (r % 8)) by one
//     thread per column, between two warpgroup barriers, before the stage is
//     released.
// Both round P at another point than the TPU's bf16(S - m_final); the plain
// version follows the TPU and the comparison uses a tolerance relative to
// max|ref|.
//
// Bound: 4 * Nq * L^2 * 128 flops per batch row against (2 Nq + 2 Nkv) L 128
// bf16 bytes: operations-bound (0.122 ms at L = 3840, 16 q heads, on the
// H100's 989 TFLOP/s).

#include "attention_sm90.cuh"

namespace {

using namespace sm90;

constexpr int STAGES = 3;
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

template <int MODE, bool KT_>
struct ProbeOp {
  static constexpr bool KT = KT_;

  struct Params {
    bf16* o;
    int L, Nq, Nkv;
  };

  __device__ static Tile tile(const Params& p, int bq) {
    Tile t;
    t.hq = blockIdx.x;
    t.b = blockIdx.y;
    t.q0 = blockIdx.z * bq;
    t.hk = t.hq / (p.Nq / p.Nkv);
    t.kt_begin = 0;
    t.n_tiles = (p.L + BKV - 1) / BKV;
    return t;
  }

  const Params p;
  const Tile t;
  float* vsum;   // this warpgroup's V column sums (MAX)
  int tid, row0, t4;
  float m_run[2], l_run[2];
  float alpha[2];  // rescale factor of O per row (MAX: the growth d of the row max)

  __device__ ProbeOp(const Params& p_, const Tile& t_, int wg, int tid_, float* vsum_)
      : p(p_), t(t_), vsum(vsum_), tid(tid_) {
    const int lane = tid & 31;
    t4 = lane & 3;
    row0 = t.q0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    m_run[0] = m_run[1] = NEG_INF;
    l_run[0] = l_run[1] = 0.f;
    if (MODE == MAX) {
      vsum[tid] = 0.f;
      warpgroup_sync(wg);
    }
  }

  __device__ __forceinline__ void begin_tile(int) {}

  __device__ __forceinline__ void scores(float (&s)[64], int k0) {
    const int n_valid = p.L - k0;  // keys of this tile before L (>= BKV but for the last)
    if (MODE == DOTS) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
        s[i] = col < n_valid ? s[i] * SCALE * 1e-3f : 0.f;
      }
      return;
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
      s[i] = col < n_valid ? s[i] * SCALE : NEG_INF;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float m_old[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_old[r] = m_run[r];
      m_run[r] = fmaxf(m_run[r], quad_max(mx[r]));
    }
    if (MODE == MAX) {
      // The row max grew by d: `rescale` moves O, which holds sum (S - m_old) V.
#pragma unroll
      for (int r = 0; r < 2; ++r) alpha[r] = m_run[r] - m_old[r];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] -= m_run[(i >> 1) & 1];
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = mode_exp<MODE>(m_old[r] - m_run[r]);
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        const float e = mode_exp<MODE>(s[i] - m_run[r]);
        s[i] = e;
        l_run[r] += e;
      }
    }
  }

  // Called once P V of the earlier tiles has landed (and, for MAX, their V
  // column sums are in vsum).
  __device__ __forceinline__ void rescale(float (&acc)[64]) const {
    if (MODE == MAX) {
      // Before the first tile vsum is 0 and the finite d times 0 is 0.
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float vs0 = vsum[8 * j + 2 * t4], vs1 = vsum[8 * j + 2 * t4 + 1];
        acc[4 * j + 0] -= alpha[0] * vs0;
        acc[4 * j + 1] -= alpha[0] * vs1;
        acc[4 * j + 2] -= alpha[1] * vs0;
        acc[4 * j + 3] -= alpha[1] * vs1;
      }
    } else if (MODE != DOTS) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
  }

  // MAX: add this V tile's column sums (zero-filled rows past L add 0).
  __device__ __forceinline__ void after_pv(const bf16* v, int wg) {
    if (MODE != MAX) return;
    warpgroup_sync(wg);  // every thread has read vsum for this tile
    const int half = tid >> 6, c = tid & 63;
    const bf16* vh = v + half * BKV * BOX;
    float sum = 0.f;
#pragma unroll 8
    for (int r = 0; r < BKV; ++r)
      sum += __bfloat162float(vh[r * BOX + ((((c >> 3) ^ r) & 7) << 3) + (c & 7)]);
    vsum[tid] += sum;
    // Generic-proxy reads of the stage before the producer's TMA overwrites it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);
  }

  __device__ __forceinline__ void finish(const float (&acc)[64]) {
    bf16* ob = p.o + ((long long)t.b * p.Nq + t.hq) * (long long)p.L * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float inv = 1.f;
      if (MODE == FULL || MODE == FULLF) inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
      bf16* orow = ob + (long long)(row0 + r * 8) * HD;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
};

template <int MODE, bool KT, int NWG>
int launch_probe(const void* q, const void* k, const void* v, void* o, int B, int L, int Nq,
                 int Nkv, cudaStream_t stream) {
  const uint64_t l = L, hd = HD;
  CUtensorMap mq, mk, mv;
  // Head-major (B, N, L, 128): map {128, L, N, B}; K^T (B, N, 128, L): {L, 128, N, B}.
  bool ok = make_map(&mq, q, {hd, l, (uint64_t)Nq, (uint64_t)B}, {hd, l * hd, Nq * l * hd},
                     {(uint32_t)BOX, (uint32_t)(NWG * 64), 1u, 1u});
  if (KT)
    ok = ok && make_map(&mk, k, {l, hd, (uint64_t)Nkv, (uint64_t)B}, {l, hd * l, Nkv * hd * l},
                        {(uint32_t)BOX, (uint32_t)HD, 1u, 1u});
  else
    ok = ok && make_map(&mk, k, {hd, l, (uint64_t)Nkv, (uint64_t)B}, {hd, l * hd, Nkv * l * hd},
                        {(uint32_t)BOX, (uint32_t)BKV, 1u, 1u});
  ok = ok && make_map(&mv, v, {hd, l, (uint64_t)Nkv, (uint64_t)B}, {hd, l * hd, Nkv * l * hd},
                      {(uint32_t)BOX, (uint32_t)BKV, 1u, 1u});
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  typename ProbeOp<MODE, KT>::Params p;
  p.o = static_cast<bf16*>(o);
  p.L = L;
  p.Nq = Nq;
  p.Nkv = Nkv;
  return launch<ProbeOp<MODE, KT>, NWG, STAGES>(mq, mk, mv, p, dim3(Nq, B, L / (NWG * 64)),
                                                stream);
}

template <bool KT, int NWG>
int by_mode(int mode, const void* q, const void* k, const void* v, void* o, int B, int L,
            int Nq, int Nkv, cudaStream_t st) {
  switch (mode) {
    case DOTS: return launch_probe<DOTS, KT, NWG>(q, k, v, o, B, L, Nq, Nkv, st);
    case MAX: return launch_probe<MAX, KT, NWG>(q, k, v, o, B, L, Nq, Nkv, st);
    case EXP: return launch_probe<EXP, KT, NWG>(q, k, v, o, B, L, Nq, Nkv, st);
    case EXPF: return launch_probe<EXPF, KT, NWG>(q, k, v, o, B, L, Nq, Nkv, st);
    case FULL: return launch_probe<FULL, KT, NWG>(q, k, v, o, B, L, Nq, Nkv, st);
    case FULLF: return launch_probe<FULLF, KT, NWG>(q, k, v, o, B, L, Nq, Nkv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NWG>
int by_layout(int kt, int mode, const void* q, const void* k, const void* v, void* o, int B,
              int L, int Nq, int Nkv, cudaStream_t st) {
  return kt ? by_mode<true, NWG>(mode, q, k, v, o, B, L, Nq, Nkv, st)
            : by_mode<false, NWG>(mode, q, k, v, o, B, L, Nq, Nkv, st);
}

}  // namespace

// mode: 0 dots, 1 +max, 2 +exp, 3 +expf, 4 full, 5 fullf; kt: K stored (B, Nkv, 128, L);
// bq: 64 or 128 query rows per CTA (one or two consumer warpgroups). L must be a
// multiple of bq. Returns a cudaError_t; cudaErrorInvalidValue when a tensor map
// cannot be made.
extern "C" int acestep_attention_probe(const void* q, const void* k, const void* v, void* o,
                                       int B, int L, int Nq, int Nkv, int mode, int kt, int bq,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq == 64) return by_layout<1>(kt, mode, q, k, v, o, B, L, Nq, Nkv, st);
  if (bq == 128) return by_layout<2>(kt, mode, q, k, v, o, B, L, Nq, Nkv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
