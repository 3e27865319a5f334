// The narrow route of the Oobleck decoder kernels (kernels 2 and 3): the
// widths and activation types the Hopper instances of csrc/oobleck_sm90.cu do
// not take, at every width the JAX package's gate sends to its Pallas kernels
// (`decoder_block_pallas`, acestep_tpu/ops/pallas_vae.py:202, at C_out <= 512;
// `res_units_pallas`, same file :89, at C <= 1024): C_out <= 512 outside
// SM90_CHANNELS, C_in not a multiple of 128, chain widths outside
// CHAIN_CHANNELS, and fp32 activations at any width (a handler built in fp32
// decodes every block here). ops/oobleck_kernels composes the launches, per
// decoder block (C = its output channels):
//   snake     a0 = T(Snake(x))
//   upsample  y = T(conv_t(a0) + bias);  a1 = T(Snake1_unit1(y))
//   unit k    z = T(Snake2(conv_k7,d(a_k) + b1))            (shared memory only)
//             h' = T((h + conv_k1(z)) + b2);  a_{k+1} = T(Snake1_{k+1}(h'))
// 5 launches a block; the chain alone is the Snake and the 3 unit launches.
// T is the activation type (bf16 or fp32); weights, biases and Snake
// constants are fp32 in the checkpoint, every product is summed in fp32, and
// each output is rounded to T exactly where `decoder_block_plain` /
// `res_units_plain` round. The Snake is the sin^2 polynomial of
// `ops/basic.sin2_f32` (common.cuh), read from the rounded value it follows.
// Rows outside [0, L) read as zeros (torch's zero padding).
//
// Design: implicit GEMMs on the tensor cores with `mma.sync` (M = rows, N =
// output channels, K = taps x input channels), one template for both types.
// - A CTA covers BM = 32 rows x BN output channels: BN = 32, 64 or 128 on 4
//   warps, 192 or 256 on 8, the warps side by side along N, each over all 32
//   rows and BN / WN columns: 2 x NT independent accumulator tiles of 16 x 8,
//   so consecutive mma.sync do not wait on each other, and every B fragment
//   serves two row tiles. The wrapper picks BN from the width (the smallest
//   tile up to 192 columns, then 192 or 256, whichever pads less). CTAs of
//   16 rows read twice the shared memory per product and ran slower on an
//   H100, even where they fill more SMs (the fp32 unit at 1 x 2176 x 192 and
//   at the full-width blocks).
// - A K step is 64 bytes of channels of one tap (32 bf16 or 16 fp32): the A
//   tile and the B tile (BN output channels, K-major) are copied by cp.async
//   into a ring, rows 64 bytes apart. A thread reads 16 bytes of a row (lane
//   t at bytes 16 t): the order of the products inside one K step is free,
//   so the 16 bytes hold its A fragments for both halves of the step (two
//   k16 bf16 or two k8 tf32 mma), and rows 64 bytes apart put the 8 lanes of
//   a quarter warp on 32 distinct banks without padding. The ring is 3
//   stages deep, 2 where z leaves no room for 3 (fp32 at 1024 channels); 2
//   stages timed as fast as 3 at most shapes and slower at bf16 1024 channels
//   (tools/narrow_parts.py).
// - Weights: the wrapper packs each conv kernel once (cached per tensor) as
//   (tap, N_pad, K_pad), zero-padded to the tile, split into hi and lo parts
//   in the operand type. bf16: hi = bf16(w), lo = bf16(w - hi); a bf16
//   activation times either part is exact in fp32, so the two products keep
//   about 16 bits of each fp32 weight (one bf16 rounding of the weight would
//   put the narrow route a bf16 step away from the plain version, which
//   multiplies fp32 weights). fp32: 3xTF32, hi = rna(x), lo = rna(x - hi),
//   the activations split in registers as they are read; the small products
//   (lo.hi, hi.lo) of a K step before its large ones (hi.hi), lo.lo left
//   out (below fp32's last place). The tensor cores align the addends of an
//   mma to the largest and drop the bits below it, so a long sum kept in
//   them loses part of a last place at every step (as kernel 1's fp32 route
//   found): each K step of 16 products is summed on the tensor cores from
//   zero and added to its accumulator in fp32 outside them. Single-pass
//   TF32 would miss the route's fp32 tolerance
//   (tests/test_torch_oobleck_narrow_split.py).
// - A residual unit is one launch: the CTA computes z for its rows and every
//   channel (the k7 GEMM over the N chunks of BN, + b1 and Snake2 in the
//   epilogue) into shared memory, then the k1 GEMM reads z there as its A
//   operand, adds h and b2 and applies the next unit's Snake1. z never reaches
//   device memory. z (32 rows x C: 133 KB at fp32 C = 1024) beside a ring of
//   at least two stages (68 KB at BN = 256) fits an SM at every width the
//   route takes, so no width needs a second launch per unit; a width whose z
//   would not fit is refused.
// - The upsample (K = 2s, pad s/2) is a 3-tap conv over x[t-1], x[t], x[t+1]
//   whose weights hold the output phase r in columns r C_out + c
//   (ops/oobleck_kernels.phase_weights), so the (B, L, s C_out) output is the
//   upsampled (B, L s, C_out): column r takes x[t] W[r + s/2] and one
//   neighbour's product. The x[t-1] tap feeds only phases r < s/2 and the
//   x[t+1] tap only the others, so a CTA skips a tap that is zero over its
//   columns. Its tile is the widest power of two up to 128 columns that still
//   gives every SM a CTA. Epilogue: y = T(acc + bias), a1 = T(Snake1(y)).
// - Inputs whose rows are not a multiple of 16 bytes (bf16 at odd multiples
//   of 4 channels and the like) are staged element by element instead of by
//   cp.async; widths not a multiple of the tile are zero-padded.
//
// Bound, H100 SXM: a unit is 16 L C^2 flops against ~4 L C activations
// (a, h in; h', a_next out), so operations above a few dozen channels: at the
// bf16 peak (989 TFLOP/s) for bf16 and, at fp32 accuracy, at 495 / 3 = 165
// TFLOP/s (3xTF32; 67 TFLOP/s of SIMT fp32) for fp32. What holds it above
// (tools/narrow_parts.py times builds with the products, the weight copies
// or the epilogues left out, on an H100): the products with their
// shared-memory reads (every CTA streams the whole hi / lo weights through
// shared memory for its 32 rows, about 26 KB a K step at 192 columns, and
// the fp32 route splits the A tile in every warp); the weight copies, which
// overlap the products at the large widths; a fixed cost a K step (the A
// copies, the ring's wait and the CTA barrier); the epilogues' global
// reads; a row count that leaves SMs idle (2176 rows are 68 CTAs on 132
// SMs: a unit computes z for every channel of its rows, so the grid does not
// grow with the width); and at the tiny shapes the launches themselves.

#include "common.cuh"

namespace {

constexpr int BAD = 1;  // a shape the kernels do not take (not a CUDA error code)
constexpr int ROW = 64;       // bytes of one K step of a row
constexpr int MAX_SMEM = 232448;  // 227 KB a CTA on sm_90
constexpr int MT = 2;             // row tiles of 16 a warp: BM = 32 rows a CTA

// Builds with a part left out, for the timings of tools/narrow_parts.py (their
// results are wrong): -DNARROW_NO_MMA (the products and their shared-memory
// reads), -DNARROW_NO_BLOAD (the weights' copies into shared memory),
// -DNARROW_NO_EPI (the epilogues' bias, Snakes, residual and a_next);
// -DNARROW_STAGES=2 the ring's depth.
#ifndef NARROW_STAGES
#define NARROW_STAGES 3
#endif
constexpr int STAGES = NARROW_STAGES;  // the ring's depth (2 where z leaves no room for 3)
#ifdef NARROW_NO_MMA
constexpr bool MMA = false;
#else
constexpr bool MMA = true;
#endif
#ifdef NARROW_NO_BLOAD
constexpr bool BLOAD = false;
#else
constexpr bool BLOAD = true;
#endif
#ifdef NARROW_NO_EPI
constexpr bool EPI = false;
#else
constexpr bool EPI = true;
#endif

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

// ---------------------------------------------------------------------------
// Tensor-core pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Channels of one K step.
template <typename T>
__host__ __device__ constexpr int kstep_channels() { return ROW / (int)sizeof(T); }

// An instance: WN warps side by side along N, each over all BM = 16 MT rows
// of the CTA and 8 NT output channels: a tile of BM x BN, BN = 8 NT WN.
template <int WN, int NT>
struct Tile {
  static constexpr int BM = 16 * MT;
  static constexpr int BN = 8 * NT * WN;
  static constexpr int THREADS = 32 * WN;
  static constexpr int BH = BM * ROW;        // offset of the hi B tile in a stage
  static constexpr int BL = BH + BN * ROW;   // offset of the lo B tile
  static constexpr int STAGE = BL + BN * ROW;
};

// One K step of a warp's 16 MT x 8 NT tile. A rows at a + r * lda (the
// thread reads bytes [16 t, 16 t + 16) of rows g + 8 h of each m16 tile), B
// rows (output channels) at bh / bl, ROW bytes apart. bf16: the 16 bytes of a
// row hold 8 channels; words 0 and 1 feed the first k16 step (A columns
// 2t..2t+1 and 2t+8..2t+9), words 2 and 3 the second, and B's k rows match
// them. The lo products go in before the hi ones.
template <int NT>
__device__ __forceinline__ void kstep_bf16(float (&acc)[MT][NT][4], const char* a, int lda, const char* bh,
                                           const char* bl, int g, int t) {
  uint4 A[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) A[mt][h] = *reinterpret_cast<const uint4*>(a + (16 * mt + g + 8 * h) * lda + 16 * t);
  uint4 H[NT], L[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    H[nt] = *reinterpret_cast<const uint4*>(bh + (nt * 8 + g) * ROW + 16 * t);
    L[nt] = *reinterpret_cast<const uint4*>(bl + (nt * 8 + g) * ROW + 16 * t);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i0 = 2 * s, i1 = 2 * s + 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], word(A[mt][0], i0), word(A[mt][1], i0), word(A[mt][0], i1), word(A[mt][1], i1),
                 word(L[nt], i0), word(L[nt], i1));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[mt][nt], word(A[mt][0], i0), word(A[mt][1], i0), word(A[mt][0], i1), word(A[mt][1], i1),
                 word(H[nt], i0), word(H[nt], i1));
  }
}

// run += x w over the k8 half s of a K step: A fragments x[mt][h][2 s] and
// x[mt][h][2 s + 1], B words 2 s and 2 s + 1 of w[nt].
template <int NT>
__device__ __forceinline__ void mma_half(float (&run)[MT][NT][4], const uint32_t (&x)[MT][2][4],
                                         const uint4 (&w)[NT], int s) {
  const int i0 = 2 * s, i1 = 2 * s + 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_tf32(run[mt][nt], x[mt][0][i0], x[mt][1][i0], x[mt][0][i1], x[mt][1][i1], word(w[nt], i0),
               word(w[nt], i1));
}

// fp32: the 16 bytes of a row hold 4 channels; .x / .y are the first k8
// step's A columns t and t + 4 (B rows t and t + 4), .z / .w the second's.
// The step's 16 products are summed from zero on the tensor cores (3xTF32:
// the small terms of both halves, then the two hi.hi) and added to acc in
// fp32.
template <int NT>
__device__ __forceinline__ void kstep_f32(float (&acc)[MT][NT][4], const char* a, int lda, const char* bh,
                                          const char* bl, int g, int t) {
  uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(a + (16 * mt + g + 8 * h) * lda + 16 * t);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[mt][h][i] = tf32_rna(x[i]);
        al[mt][h][i] = tf32_rna(x[i] - __uint_as_float(ah[mt][h][i]));
      }
    }
  uint4 H[NT], L[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    H[nt] = *reinterpret_cast<const uint4*>(bh + (nt * 8 + g) * ROW + 16 * t);
    L[nt] = *reinterpret_cast<const uint4*>(bl + (nt * 8 + g) * ROW + 16 * t);
  }
  float run[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) run[mt][nt][c] = 0.f;
#pragma unroll
  for (int s = 0; s < 2; ++s) mma_half<NT>(run, al, H, s);  // lo.hi
#pragma unroll
  for (int s = 0; s < 2; ++s) mma_half<NT>(run, ah, L, s);  // hi.lo
#pragma unroll
  for (int s = 0; s < 2; ++s) mma_half<NT>(run, ah, H, s);  // hi.hi
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] += run[mt][nt][c];
}

// The A operand of a GEMM: a conv over activations a (L, C) of one batch row
// (tap j reads row t + j dil - pad; rows outside [0, L) and channels >= C are
// zeros), or, with z set, the z tile in shared memory (one tap, row pitch
// zpitch bytes).
template <typename T>
struct ASrc {
  const T* a;
  int L, C, dil, pad;
  unsigned taps;  // bit j: tap j contributes (0 bits are skipped)
  bool vec;       // rows a multiple of 16 bytes and a 16-byte aligned: cp.async
  const char* z;
  int zpitch;
};

// The B operand: hi / lo weights packed (tap, npad, kpad).
template <typename T>
struct BSrc {
  const T* hi;
  const T* lo;
  int npad, kpad;
};

// acc = the GEMM of A and B's columns [n0, n0 + BN) over every (tap, K step),
// through a cp.async ring of `stages` (2 or 3) stages. Warps whose columns
// all lie at or past n_live load but skip the products. Ends with the ring
// free.
template <typename T, int WN, int NT>
__device__ void gemm(float (&acc)[MT][NT][4], char* ring, int stages, const ASrc<T>& as, const BSrc<T>& bs,
                     int t0, int n0, int n_live) {
  using TL = Tile<WN, NT>;
  constexpr int KC = kstep_channels<T>();
  constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int chunks = bs.kpad / KC;
  const int steps = __popc(as.taps) * chunks;
  const bool live = n0 + warp * 8 * NT < n_live;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  // The load cursor: (tap, K step) of the next step to issue.
  int ltap = __ffs(as.taps) - 1, lkc = 0;
  auto issue = [&](int stage) {
    char* st = ring + stage * TL::STAGE;
    if (as.z == nullptr && tid < TL::BM * 4) {  // A: BM rows x 4 pieces of 16 bytes
      const int r = tid >> 2, q = tid & 3;
      const int row = t0 + r + ltap * as.dil - as.pad;
      const int ch = lkc * KC + q * E;
      const bool ok = row >= 0 && row < as.L;
      char* dst = st + r * ROW + q * 16;
      if (as.vec) {
        const bool v = ok && ch < as.C;
        cp_async16(dst, v ? as.a + (long long)row * as.C + ch : as.a, v);
      } else {
        T* d = reinterpret_cast<T*>(dst);
#pragma unroll
        for (int e = 0; e < E; ++e)
          d[e] = ok && ch + e < as.C ? as.a[(long long)row * as.C + ch + e] : from_f<T>(0.f);
      }
    }
    const T* hi = bs.hi + ((long long)ltap * bs.npad + n0) * bs.kpad + lkc * KC;
    const T* lo = bs.lo + ((long long)ltap * bs.npad + n0) * bs.kpad + lkc * KC;
#pragma unroll
    for (int i = 0; i < (TL::BN * 4 + TL::THREADS - 1) / TL::THREADS; ++i) {  // B: BN rows x 4 pieces, hi and lo
      const int c = tid + i * TL::THREADS;
      if (BLOAD && c < TL::BN * 4) {
        const int n = c >> 2, q = c & 3;
        const int off = n * bs.kpad + q * E;
        cp_async16(st + TL::BH + n * ROW + q * 16, hi + off, true);
        cp_async16(st + TL::BL + n * ROW + q * 16, lo + off, true);
      }
    }
    if (++lkc == chunks) {
      lkc = 0;
      const unsigned rest = as.taps & ~((2u << ltap) - 1);
      ltap = rest ? __ffs(rest) - 1 : ltap;
    }
  };

  for (int p = 0; p < stages - 1; ++p) {
    if (p < steps) issue(p);
    cp_async_commit();
  }
  int cs = 0, ls = stages - 1;  // the stage computed and the stage loaded next
  for (int i = 0; i < steps; ++i) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (i + stages - 1 < steps) issue(ls);
    cp_async_commit();
    if (MMA && live) {
      const char* st = ring + cs * TL::STAGE;
      const char* a = as.z != nullptr ? as.z + (i % chunks) * ROW : st;
      const int lda = as.z != nullptr ? as.zpitch : ROW;
      const char* bh = st + TL::BH + warp * 8 * NT * ROW;
      const char* bl = st + TL::BL + warp * 8 * NT * ROW;
      if constexpr (sizeof(T) == 2)
        kstep_bf16<NT>(acc, a, lda, bh, bl, g, t);
      else
        kstep_f32<NT>(acc, a, lda, bh, bl, g, t);
    }
    cs = cs + 1 == stages ? 0 : cs + 1;
    ls = ls + 1 == stages ? 0 : ls + 1;
  }
  __syncthreads();
}

// Calls f(r, n, v) for each accumulator of this thread: r the tile's row,
// n the column, v its sum. Pairs (n, n + 1) come one after the other.
template <int NT, typename F>
__device__ __forceinline__ void for_each(const float (&acc)[MT][NT][4], int n0, F&& f) {
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f(16 * mt + g + 8 * (c >> 1), n0 + warp * 8 * NT + nt * 8 + 2 * t + (c & 1), acc[mt][nt][c]);
}

int z_pitch(int npad, int esize) {
  const int bytes = npad * esize;  // rows 64 mod 128 bytes apart: 8 rows on distinct banks
  return bytes % 128 == 0 ? bytes + 64 : bytes;
}

template <typename T>
struct UnitParams {
  const T* a;   // (B, L, C): T(Snake1(h))
  const T* h;   // (B, L, C): the residual
  BSrc<T> w1;   // k7: (7, npad, kpad)
  BSrc<T> w2;   // k1: (1, npad, kpad)
  const float *b1, *ae2, *ib2, *b2, *aen, *ibn;  // aen / ibn null: no next Snake
  T* out;
  T* a_next;
  int L, C, dil, zpitch, stages;
  bool vec;
};

// One residual unit over BM rows of one batch row: z for every channel into
// shared memory, then h' and a_next.
template <typename T, int WN, int NT>
__global__ void __launch_bounds__(32 * WN, 1) narrow_unit_kernel(const UnitParams<T> p) {
  using TL = Tile<WN, NT>;
  extern __shared__ __align__(128) char smem[];
  char* ring = smem;
  char* z = smem + p.stages * TL::STAGE;
  const int t0 = blockIdx.x * TL::BM;
  const long long boff = (long long)blockIdx.y * p.L * p.C;
  const ASrc<T> conv{p.a + boff, p.L, p.C, p.dil, 3 * p.dil, 0x7Fu, p.vec, nullptr, 0};
  const ASrc<T> fromz{nullptr, p.L, p.C, 1, 0, 1u, false, z, p.zpitch};
  float acc[MT][NT][4];
  for (int n0 = 0; n0 < p.w1.npad; n0 += TL::BN) {
    gemm<T, WN, NT>(acc, ring, p.stages, conv, p.w1, t0, n0, p.C);
    for_each<NT>(acc, n0, [&](int r, int n, float v) {
      const float zv = n >= p.C ? 0.f : EPI ? snake(v + p.b1[n], p.ae2[n], p.ib2[n]) : v;
      reinterpret_cast<T*>(z + r * p.zpitch)[n] = from_f<T>(zv);
    });
  }
  // gemm's first barrier orders these z writes before any read of z.
  for (int n0 = 0; n0 < p.w2.npad; n0 += TL::BN) {
    gemm<T, WN, NT>(acc, ring, p.stages, fromz, p.w2, 0, n0, p.C);
    for_each<NT>(acc, n0, [&](int r, int n, float v) {
      const int row = t0 + r;
      if (row >= p.L || n >= p.C) return;
      const long long i = boff + (long long)row * p.C + n;
      if (!EPI) {
        p.out[i] = from_f<T>(v);
        return;
      }
      const float o = round_t<T>((to_f<T>(p.h[i]) + v) + p.b2[n]);
      p.out[i] = from_f<T>(o);
      if (p.a_next != nullptr) p.a_next[i] = from_f<T>(snake(o, p.aen[n], p.ibn[n]));
    });
  }
}

template <typename T>
struct UpParams {
  const T* a;  // (B, L, Ci): T(Snake(x))
  BSrc<T> w;   // (3, npad, kpad): phase weights over x[t-1], x[t], x[t+1]
  const float *bias, *ae, *ib;  // (Co)
  T* y;
  T* a1;  // (B, L, s Co)
  int L, Ci, Co, N, split;  // N = s Co; columns below `split` take x[t-1], the rest x[t+1]
  int stages;
  bool vec;
};

template <typename T, int WN, int NT>
__global__ void __launch_bounds__(32 * WN, 1) narrow_upsample_kernel(const UpParams<T> p) {
  using TL = Tile<WN, NT>;
  extern __shared__ __align__(128) char smem[];
  const int t0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::BN;
  const unsigned taps = 2u | (n0 < p.split ? 1u : 0u) | (n0 + TL::BN > p.split ? 4u : 0u);
  const ASrc<T> conv{p.a + (long long)blockIdx.z * p.L * p.Ci, p.L, p.Ci, 1, 1, taps, p.vec, nullptr, 0};
  float acc[MT][NT][4];
  gemm<T, WN, NT>(acc, smem, p.stages, conv, p.w, t0, n0, p.N);
  const long long boff = (long long)blockIdx.z * p.L * p.N;
  for_each<NT>(acc, n0, [&](int r, int n, float v) {
    const int row = t0 + r;
    if (row >= p.L || n >= p.N) return;
    const int c = n % p.Co;
    const long long i = boff + (long long)row * p.N + n;
    if (!EPI) {
      p.y[i] = from_f<T>(v);
      return;
    }
    const float o = round_t<T>(v + p.bias[c]);
    p.y[i] = from_f<T>(o);
    p.a1[i] = from_f<T>(snake(o, p.ae[c], p.ib[c]));
  });
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// Lets `kernel` take up to MAX_SMEM of dynamic shared memory, once per device
// (`done`: one such mask per kernel instance).
template <typename K>
int allow_smem(K kernel, unsigned& done) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  if (dev < 32 && (done >> dev) & 1u) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess)  // all of the SM's 228 KB to shared memory
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 32) done |= 1u << dev;
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The column tiles the route takes: BN 32, 64, 128 (4 warps of 8, 16 or 32
// columns), 192 or 256 (8 warps of 24 or 32 columns), all 32 rows.
bool valid_tile(int bn) { return bn == 32 || bn == 64 || bn == 128 || bn == 192 || bn == 256; }

// The instance of a tile of bn columns: 4 warps up to 128 columns (NT = bn /
// 32 column tiles of 8 a warp), 8 warps above.
#define WITH_TILE(bn, CALL)          \
  do {                               \
    switch (bn) {                    \
      case 32: return CALL(4, 1);    \
      case 64: return CALL(4, 2);    \
      case 128: return CALL(4, 4);   \
      case 192: return CALL(8, 3);   \
      default: return CALL(8, 4);    \
    }                                \
  } while (0)

// The ring's depth beside `fixed` bytes: STAGES, or 2 where z leaves no room
// for more (0: not even 2 fit).
int ring_stages(int stage, int fixed) {
  const int fit = (MAX_SMEM - fixed) / stage;
  return fit < 2 ? 0 : fit < STAGES ? fit : STAGES;
}

template <typename T, int WN, int NT>
int unit_launch(UnitParams<T> p, int B, cudaStream_t st) {
  using TL = Tile<WN, NT>;
  p.stages = ring_stages(TL::STAGE, TL::BM * p.zpitch);
  if (p.stages == 0) return BAD;  // z does not fit beside a ring of two stages
  const int smem = p.stages * TL::STAGE + TL::BM * p.zpitch;
  static unsigned done = 0;
  const int rc = allow_smem(narrow_unit_kernel<T, WN, NT>, done);
  if (rc) return rc;
  narrow_unit_kernel<T, WN, NT><<<dim3((p.L + TL::BM - 1) / TL::BM, B), TL::THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int unit_typed(const void* a, const void* h, const void* w1h, const void* w1l, const void* b1, const void* ae2,
               const void* ib2, const void* w2h, const void* w2l, const void* b2, const void* aen, const void* ibn,
               void* out, void* a_next, int B, int L, int C, int npad, int kpad, int bn, int dil,
               cudaStream_t st) {
  if (!valid_tile(bn) || npad % bn || npad < C || kpad % kstep_channels<T>() || kpad < C || kpad > npad)
    return BAD;
  UnitParams<T> p;
  p.a = static_cast<const T*>(a);
  p.h = static_cast<const T*>(h);
  p.w1 = {static_cast<const T*>(w1h), static_cast<const T*>(w1l), npad, kpad};
  p.w2 = {static_cast<const T*>(w2h), static_cast<const T*>(w2l), npad, kpad};
  p.b1 = static_cast<const float*>(b1);
  p.ae2 = static_cast<const float*>(ae2);
  p.ib2 = static_cast<const float*>(ib2);
  p.b2 = static_cast<const float*>(b2);
  p.aen = static_cast<const float*>(aen);
  p.ibn = static_cast<const float*>(ibn);
  p.out = static_cast<T*>(out);
  p.a_next = static_cast<T*>(a_next);
  p.L = L;
  p.C = C;
  p.dil = dil;
  p.zpitch = z_pitch(npad, sizeof(T));
  p.vec = (C * (int)sizeof(T)) % 16 == 0 && aligned16(a);
#define UNIT(WN, NT) unit_launch<T, WN, NT>(p, B, st)
  WITH_TILE(bn, UNIT);
#undef UNIT
}

template <typename T, int WN, int NT>
int upsample_launch(UpParams<T> p, int B, cudaStream_t st) {
  using TL = Tile<WN, NT>;
  const dim3 grid((p.L + TL::BM - 1) / TL::BM, p.w.npad / TL::BN, B);
  p.stages = STAGES;
  static unsigned done = 0;
  const int rc = allow_smem(narrow_upsample_kernel<T, WN, NT>, done);
  if (rc) return rc;
  narrow_upsample_kernel<T, WN, NT><<<grid, TL::THREADS, p.stages * TL::STAGE, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int upsample_typed(const void* a, const void* wh, const void* wl, const void* bias, const void* ae, const void* ib,
                   void* y, void* a1, int B, int L, int Ci, int Co, int s, int npad, int kpad, int bn,
                   cudaStream_t st) {
  const int n = s * Co;
  if (!valid_tile(bn) || npad % bn || npad < n || kpad % kstep_channels<T>() || kpad < Ci) return BAD;
  UpParams<T> p;
  p.a = static_cast<const T*>(a);
  p.w = {static_cast<const T*>(wh), static_cast<const T*>(wl), npad, kpad};
  p.bias = static_cast<const float*>(bias);
  p.ae = static_cast<const float*>(ae);
  p.ib = static_cast<const float*>(ib);
  p.y = static_cast<T*>(y);
  p.a1 = static_cast<T*>(a1);
  p.L = L;
  p.Ci = Ci;
  p.Co = Co;
  p.N = n;
  p.split = (s / 2) * Co;
  p.vec = (Ci * (int)sizeof(T)) % 16 == 0 && aligned16(a);
#define UPSAMPLE(WN, NT) upsample_launch<T, WN, NT>(p, B, st)
  WITH_TILE(bn, UPSAMPLE);
#undef UPSAMPLE
}

constexpr int SNAKE_THREADS = 256;

template <typename T>
int snake_launch(const void* x, const void* ae, const void* ib, void* y, long long n, int C, cudaStream_t st) {
  gen_snake_kernel<T><<<(unsigned)((n + SNAKE_THREADS - 1) / SNAKE_THREADS), SNAKE_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ae), static_cast<const float*>(ib), static_cast<T*>(y),
      n, C);
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

// One residual unit at dilation dil: out = T((h + conv_k1(z)) + b2) with
// z = T(Snake2(conv_k7,d(a) + b1)), and a_next = T(Snake_next(out)) when
// aen / ibn are given. Weights packed (tap, npad, kpad) as hi and lo parts
// (ops/oobleck_kernels.pack_narrow); CTA tiles of 32 rows x bn output
// channels (valid_tile; npad a multiple of bn).
extern "C" int acestep_gen_unit(const void* a, const void* h, const void* w1h, const void* w1l, const void* b1,
                                const void* ae2, const void* ib2, const void* w2h, const void* w2l,
                                const void* b2, const void* aen, const void* ibn, void* out, void* a_next, int B,
                                int L, int C, int npad, int kpad, int bn, int dil, int fp32, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || dil <= 0 || B > 65535) return BAD;
  if ((aen == nullptr) != (a_next == nullptr) || (ibn == nullptr) != (a_next == nullptr)) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? unit_typed<float>(a, h, w1h, w1l, b1, ae2, ib2, w2h, w2l, b2, aen, ibn, out, a_next, B, L, C,
                                  npad, kpad, bn, dil, st)
              : unit_typed<bf16>(a, h, w1h, w1l, b1, ae2, ib2, w2h, w2l, b2, aen, ibn, out, a_next, B, L, C,
                                 npad, kpad, bn, dil, st);
}

// The block's transposed conv (K = 2s, pad s/2) with the first unit's Snake1,
// on phase weights (3, npad, kpad) over s * Co columns, as hi and lo parts,
// in CTA tiles of 32 rows x bn columns.
extern "C" int acestep_gen_upsample(const void* a, const void* wh, const void* wl, const void* bias,
                                    const void* ae, const void* ib, void* y, void* a1, int B, int L, int Ci,
                                    int Co, int s, int npad, int kpad, int bn, int fp32, void* stream) {
  if (B <= 0 || L <= 0 || Ci <= 0 || Co <= 0 || s < 2 || s % 2 || B > 65535) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? upsample_typed<float>(a, wh, wl, bias, ae, ib, y, a1, B, L, Ci, Co, s, npad, kpad, bn, st)
              : upsample_typed<bf16>(a, wh, wl, bias, ae, ib, y, a1, B, L, Ci, Co, s, npad, kpad, bn, st);
}
