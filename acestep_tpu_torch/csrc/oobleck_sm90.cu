// Oobleck decoder kernels for Hopper (sm_90a): the decoder block (kernel 2)
// and the residual-unit chain of block 0 (kernel 3), as implicit-GEMM
// convolutions on one TMA + wgmma mainloop, with fused epilogues at the TPU
// kernels' bf16 rounding points. ops/oobleck_kernels composes the launches:
// decoder_block_kernel (kernel 2) and res_units_kernel (kernel 3).
//
// Kernel 2 replaces `decoder_block_pallas` (acestep_tpu/ops/pallas_vae.py:202),
// which runs a whole block in one VMEM pass. A fused block at 512 channels
// does not fit an SM's 227 KB of shared memory, so a block is a short fixed
// sequence of launches (C = the block's output channels; every output is bf16):
//   snake_kernel (csrc/oobleck.cu)  a0 = Snake(x), on the 1/s input rows
//   upsample                        y = conv_t(a0) + bias;  a1 = Snake1_unit1(y)
//   unit k, C <= 256, one launch    z = Snake2_k(conv_k7,d(a_k) + b1), kept in registers
//                                   h' = h + conv_k1(z) + b2;  a_{k+1} = Snake1_{k+1}(h')
//   unit k, C = 512, two launches   k7: z -> HBM;  k1: h', a_{k+1}
// 5 launches per block at C <= 256 and 8 at C = 512. The conv_t is a 3-tap
// conv over x[t-1], x[t], x[t+1] whose weights hold the phases in
// (phase * C_out + c) columns, so the output (B, L, s C) is the upsampled
// (B, L s, C). Rounding points: Snake outputs, the fp32 k7 sum after Snake2,
// the fp32 residual sum and the fp32 conv_t sum, each rounded once; a Snake
// epilogue reads the rounded value it follows.
//
// Kernel 3 replaces `res_units_pallas` (same file, :89): the 3 units alone
// (block 0's output at C = 1024, after its plain Snake and conv_t; any C that
// is a multiple of 128 up to 1024): snake_kernel for unit 1's Snake1, then per
// unit either kernel 2's fused launch (C <= 256; 4 launches) or k7 (z -> HBM)
// and k1 (h', with the next unit's Snake1 in its epilogue; 7 launches). At
// multiples of 256 both run on the stream-K instance (SK) below; at 384, 640
// and 896 on whole tiles of 128 channels. Bound at C = 1024: 48 L C^2 flops
// against ~4 L C bytes of activations and 48 MB of weights, so operations
// (1x2240 rows: 0.114 ms; 1x5440: 0.277 ms), and the k7s are 7/8 of them.
// What held the data-parallel walk far above that is the tile count: a k7
// tile of 128 rows x 256 channels is K = 7 taps x 16 chunks = 112 steps of
// 4.19 MFLOP, at least 62.7 us on one SM (989/132 TFLOP/s). The 224-frame
// chunk has 18 row tiles x 4 = 72 tiles: one round on 72 of 132 SMs, a floor
// of 0.188 ms for the three k7s; the 544-frame chunk 43 x 4 = 172: two
// rounds, the second 30 % full, 0.376 ms. Stream-K splits the (tile, K step)
// space evenly over the persistent CTAs instead (CUTLASS's hybrid: whole
// data-parallel rounds first, then the last, partial round's K steps): 62
// steps per CTA at c224 (floor 0.104 ms), 112 + 34 = 146 at c544 (0.245 ms).
// A CTA walks its run of split steps from the top down, cut at tile edges
// into segments, as CUTLASS's stream-K does, so that only its first segment
// can end inside a tile and only its last start inside one. A segment that
// starts inside a tile first adds the sum of the tile's lower steps: CTA c - 1
// holds the steps just below (its run ends where c's begins) and has left
// there the sum of its own and of all lower ones, in its workspace slot (128
// KB of fp32), under its flag (c waits for it: acquire). A segment that ends
// inside a tile then leaves that running sum in its own slot and raises its
// flag (release); one that ends the tile runs the epilogue, which only a
// tile's full sum may pass since Snake2 is not linear. Each tile's partial
// sums thus add in K order, the same bits on every run. A CTA waits only for
// CTA c - 1, which the hardware dispatches first and which waits only for
// lower ones still, so the launch finishes without the whole grid resident:
// beside other kernels, on other streams or under MPS. A wait over 10 s
// traps. The host computes the
// split (ops/oobleck_kernels.streamk_schedule) and passes it in Params; the k1
// launches take the same instance with every tile whole (16 steps a tile,
// bound by bytes). Flags carry a per-launch epoch, so nothing is reset (and
// no launch may be replayed from a CUDA graph: the wrapper refuses capture).
//
// Mainloop: acc[t, n] = sum_j sum_ci a[t + j d - pad, ci] W[j, n, ci].
//   - Tile: 128 output rows x NT output channels of one batch row. The grid is
//     persistent: one CTA per SM walks the tiles (row tiles fastest), and the
//     ring runs on across them, so the next tile's first stages load during
//     this tile's epilogue and no CTA pays a launch and an empty pipeline.
//   - CTA: two consumer warpgroups of 64 rows and a producer warpgroup of
//     which one thread issues every load; `setmaxnreg` 24 / 240.
//   - The K loop runs over (tap j, 64-channel chunk) through a ring of 4
//     stages at NT = 128 and 3 at NT = 256. The A tile is one TMA box of 128
//     rows x 64 channels of `a` (B, L, C) starting at row t0 + j d - pad: TMA
//     zero-fills rows outside [0, L), negative ones too, which is torch's zero
//     padding (Snake(0) = 0), so there is no halo logic. The B tile is the
//     weight chunk, packed K-major as (tap, n, ci) by the wrapper: NT rows x 64.
//   - Products: wgmma.m64n128k16, A and B from shared memory, fp32
//     accumulators, NT / 128 per k16 step.
//   - Fused unit: the k7 accumulators take + b1 and Snake2 and become, in
//     registers, the bf16 A fragments of z (as P in attention); the k1 stage
//     is wgmma with A from registers against W2 tiles (128 output channels x
//     64) streamed through the same ring, whose stages then carry no A tile,
//     one 128-channel half of h' after the other. z never reaches HBM.
//   - Epilogue: each warpgroup writes its fp32 accumulators (64 rows x 128
//     channels at a time) to its own shared-memory tile and reads them back
//     8 channels x 8 rows per thread: 16-byte coalesced residual reads (rows
//     prefetched into L2 when the tile starts) and stores, per-channel
//     constants read once, a short loop. Written straight from the wgmma
//     layout (4-byte accesses, fully unrolled), the epilogue had cost more
//     than the products and the loads together.
//
// Bound of kernel 2, H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). As a whole block (inputs and
// output once, the kernel table's bound) all four blocks are bound by
// operations: 4 L_out C_in C + 48 L_out C^2 flops. Per fused unit at C = 128,
// its own HBM traffic (read a and h, write h' and a_next: 8 C bytes per row)
// against 16 C^2 flops per row is 2 C = 256 flop/byte, below the card's ~295:
// there a unit is bound by bytes (0.131 ms against 0.114 ms of operations at
// block 4's 430 080 rows); at C = 256 (512 flop/byte) and 512 by operations.
// What holds it above that: every tap re-reads its A tile and every 128-row
// tile re-reads all weights from L2 (32-48 KB per K step), and the epilogue
// does not overlap the products of its own warpgroups.
// Shared memory: a stage is 16 KB of A + NT * 128 bytes of B; the epilogue
// tiles are 2 x 64 x 136 fp32 (68 KB). At NT = 128 (C = 128; kernel 3's
// stages at 384, 640, 896): 4 x 32 KB + 68 KB = 196 KB; at NT = 256 (C = 256,
// the stages at multiples of 256, the conv_t): 3 x 48 KB + 68 KB = 212 KB;
// plus barriers and 1 KB of alignment slack, of 227 KB.
// Why z is in registers at C <= 256 and in HBM at 512: per consumer thread
// the k7 accumulators take C / 2 fp32 registers, then z C / 4 registers of
// packed bf16 beside one 64-register k1 accumulator (one 128-channel half of
// h' at a time): at most 128 + addressing at C = 256, inside the 168 that
// ptxas gives every thread of a 384-thread CTA (all 256 k1 accumulators
// beside z, 192, spilled and serialised the wgmma). At 512 the k7
// accumulators alone would be 256, past the 255 a thread can hold, and z
// (128 KB per 128-row tile) does not fit shared memory beside the ring
// either. So at 512 the k7 stage writes z and the k1 stage reads it.

#include <atomic>

#include "common.cuh"  // sin2_poly, shared with csrc/oobleck.cu
#include "sm90.cuh"

namespace sm90 {
namespace {

constexpr int BK = 64;     // channels per K step: one 128-byte swizzled box
constexpr int SROW = 136;  // fp32 row of the epilogue tile: 128 + 8, conflict-free float2 writes

// A CTA's tile: BM = 128 rows (a 64-row product per consumer warpgroup) x NT
// output channels.
template <int NT_>
struct ConvSmem {
  static constexpr int NT = NT_, NH = NT / 128, BM = 128;
  static constexpr uint32_t A_BYTES = BM * BK * 2, B_BYTES = NT * BK * 2;
  static constexpr int STAGES = A_BYTES + B_BYTES <= 32768 ? 4 : 3;  // what fits beside `tile`
  bf16 a[STAGES][BM][BK];  // [rows][64 channels], 128-byte swizzle
  bf16 b[STAGES][NT][BK];  // [output channels][64 input channels], K-major
  float tile[2][64][SROW];  // per consumer warpgroup: 64 rows x 128 channels of the epilogue
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// The epilogue after the last product: v = acc + bias[n]; v = Snake(v) if
// `ae` (the k7 stage's Snake2); v += res[t, n] if `res`; out = bf16(v); and,
// if `out2`, out2 = bf16(Snake'(float(out))) with Snake' at channel n % period.
struct Epi {
  const float* bias;
  const float* ae;
  const float* ib;
  const bf16* res;
  bf16* out;
  const float* ae2;
  const float* ib2;
  bf16* out2;
  int period;
};

struct Params {
  Epi epi;
  const float* b1;  // fused unit: the k7 stage's bias and Snake2, applied in registers
  const float* ae1;
  const float* ib1;
  int L;            // rows of `a` and of the output per batch row
  long long ld;     // output row stride (elements)
  int n_ci;         // 64-channel chunks of `a`
  int taps, dil, pad;
  int n_ci2;        // fused unit: 64-channel chunks of z (the k1 stage), else 0
  int n_nt, batch;  // output-channel tiles, batch rows
  // The stream-K walk (SK instance, kernel 3): tiles [0, dp_tiles) in
  // data-parallel rounds, then the K steps of tiles [dp_tiles, tiles) split
  // over CTAs [0, sk_ctas), CTA c taking sk_q steps, plus one if c < sk_r.
  int dp_tiles, sk_ctas, sk_q, sk_r;
  float* ws;   // one 128 KB slot of fp32 partial accumulators per CTA
  int* flags;  // per CTA: `epoch` once its slot holds this launch's partial
  int epoch;
};

// Output tile `tile` of the persistent grid: row tiles vary fastest, so the
// CTAs in flight read neighbouring rows of `a` and the same weight tiles.
struct TileIdx {
  int t0, n0, b;
};

template <class SM>
__device__ __forceinline__ TileIdx tile_at(const Params& p, int tile) {
  const int n_rt = (p.L + SM::BM - 1) / SM::BM;
  const int rest = tile / n_rt;
  return {(tile % n_rt) * SM::BM, (rest % p.n_nt) * SM::NT, rest / p.n_nt};
}

template <class SM>
__device__ __forceinline__ int n_tiles(const Params& p) {
  return (p.L + SM::BM - 1) / SM::BM * p.n_nt * p.batch;
}

// Ring steps of one tile: (tap, chunk) steps, then the fused unit's W2 steps.
template <class SM>
__host__ __device__ __forceinline__ int n_steps(const Params& p) {
  return p.taps * p.n_ci + SM::NH * p.n_ci2;
}

// Stream-K segments of CTA blockIdx.x, in order: its run of K steps over the
// split tiles from the top down, cut at tile edges, as f(tile, k0, k1) for
// steps k0 .. k1 - 1 (each segment's steps run upwards). Only the first
// segment can end inside a tile (k1 < steps: it leaves a running sum), only
// the last start inside one (k0 > 0: it adds CTA blockIdx.x - 1's).
template <class F>
__device__ __forceinline__ void sk_segments(const Params& p, int steps, F&& f) {
  const int c = blockIdx.x;
  if (c >= p.sk_ctas) return;
  const int begin = c * p.sk_q + min(c, p.sk_r);
  int end = begin + p.sk_q + (c < p.sk_r ? 1 : 0);
  while (end > begin) {
    const int t = (end - 1) / steps, base = t * steps;
    const int k0 = max(begin - base, 0), k1 = end - base;
    f(p.dp_tiles + t, k0, k1);
    end = base + k0;
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float snake(float v, float ae, float ib) {
  return v + ib * sin2_poly(ae * v);
}

template <int NH>
__device__ __forceinline__ void fence_acc(float (&acc)[NH][64]) {
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
}

// ---------------------------------------------------------------------------
// The two roles
// ---------------------------------------------------------------------------

// The producer's loads of ring steps k0 .. k1 - 1 of one tile. `a` is
// {C, L, B, 1} with box {64, BM}; W is {C_in, N, taps, 1} with box {64, NT};
// W2 of the fused unit is {C, C, 1, 1} with box {64, 128}, loaded per
// (128-channel half of n, 64-channel chunk of z).
template <class SM>
__device__ __forceinline__ void produce_steps(SM& sm, const CUtensorMap* ma,
                                              const CUtensorMap* mw, const CUtensorMap* mw2,
                                              const Params& p, int tile, int k0, int k1,
                                              int& ring) {
  constexpr int STAGES = SM::STAGES;
  const int n1 = p.taps * p.n_ci;
  const TileIdx ti = tile_at<SM>(p, tile);
  for (int k = k0; k < k1; ++k, ++ring) {
    const int s = ring % STAGES;
    mbar_wait(&sm.empty[s], ((ring / STAGES) & 1) ^ 1);
    if (k < n1) {
      const int j = k / p.n_ci, c = k % p.n_ci;
      mbar_expect_tx(&sm.full[s], SM::A_BYTES + SM::B_BYTES);
      tma_load_4d(&sm.a[s][0][0], ma, &sm.full[s], c * BK, ti.t0 + j * p.dil - p.pad, ti.b, 0);
      tma_load_4d(&sm.b[s][0][0], mw, &sm.full[s], c * BK, ti.n0, j, 0);
    } else {
      const int half = (k - n1) / p.n_ci2 % SM::NH, c = (k - n1) % p.n_ci2;
      mbar_expect_tx(&sm.full[s], 128 * BK * 2);
      tma_load_4d(&sm.b[s][0][0], mw2, &sm.full[s], c * BK, half * 128, 0, 0);
    }
  }
}

// The producer thread: every tile (or stream-K segment) of this CTA in turn,
// exactly the consumers' sequence, the ring running on across tiles, so the
// next tile's first stages load during this tile's epilogue.
template <class SM, bool SK>
__device__ __forceinline__ void produce(SM& sm, const CUtensorMap* ma,
                                        const CUtensorMap* mw, const CUtensorMap* mw2,
                                        const Params& p) {
  const int steps = n_steps<SM>(p);
  int ring = 0;
  for (int tile = blockIdx.x; tile < (SK ? p.dp_tiles : n_tiles<SM>(p)); tile += gridDim.x)
    produce_steps<SM>(sm, ma, mw, mw2, p, tile, 0, steps, ring);
  if constexpr (SK)
    sk_segments(p, steps, [&](int tile, int k0, int k1) {
      produce_steps<SM>(sm, ma, mw, mw2, p, tile, k0, k1, ring);
    });
}

// acc += the products of ring steps it0 .. it0 + n_it - 1, A and B from shared memory.
// Step it's products are issued before step it - 1's are waited for; a stage
// is released once its products have completed.
template <class SM>
__device__ __forceinline__ void mainloop_ss(SM& sm, float (&acc)[SM::NH][64], int wg,
                                            int it0, int n_it) {
  constexpr int STAGES = SM::STAGES;
  for (int k = 0; k < n_it; ++k) {
    const int it = it0 + k, s = it % STAGES;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    const uint64_t da = make_desc(&sm.a[s][wg * 64][0], 16, 1024);
    const uint64_t db = make_desc(&sm.b[s][0][0], 16, 1024);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < SM::NH; ++h)
        wgmma_ss<0>(acc[h], da + ((kk * 32) >> 4), db + ((h * 128 * BK * 2 + kk * 32) >> 4), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (k > 0) mbar_arrive(&sm.empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mbar_arrive(&sm.empty[(it0 + n_it - 1) % STAGES]);
}

// acc += z W2[:, 128 output channels] over ring steps it0 .. it0 + NT / 64 - 1,
// z (NT channels) from registers.
template <class SM, int NT = SM::NT>
__device__ __forceinline__ void mainloop_rs(SM& sm, float (&acc)[64],
                                            uint32_t (&zf)[NT / 128][8][4], int it0) {
  constexpr int STAGES = SM::STAGES;
#pragma unroll
  for (int c = 0; c < NT / BK; ++c) {
    const int it = it0 + c, s = it % STAGES;
    mbar_wait(&sm.full[s], (it / STAGES) & 1);
    const uint64_t db = make_desc(&sm.b[s][0][0], 16, 1024);
    fence_regs(acc);
#pragma unroll
    for (int h = 0; h < NT / 128; ++h) fence_regs(zf[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int kg = c * (BK / 16) + kk;  // k16 step over z's channels
      wgmma_rs<0>(acc, zf[kg / 8][kg % 8], db + ((kk * 32) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (c > 0) mbar_arrive(&sm.empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int h = 0; h < NT / 128; ++h) fence_regs(zf[h]);
  mbar_arrive(&sm.empty[(it0 + NT / BK - 1) % STAGES]);
}

// acc = Snake(acc + bias) in place; this thread's columns are n_base + 128 h + 8 i + {0, 1}.
template <int NH>
__device__ __forceinline__ void bias_snake(float (&acc)[NH][64], const float* bias,
                                           const float* ae, const float* ib, int n_base) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = n_base + h * 128 + i * 8;
      const float2 bb = ld2(bias + n), a2 = ld2(ae + n), i2 = ld2(ib + n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = acc[h][4 * i + e];
        v = (e & 1) ? snake(v + bb.y, a2.y, i2.y) : snake(v + bb.x, a2.x, i2.x);
      }
    }
}

template <int N>
__device__ __forceinline__ void load_f32(float (&v)[N], const float* p) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + j));
    v[j] = x.x, v[j + 1] = x.y, v[j + 2] = x.z, v[j + 3] = x.w;
  }
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[2 * j] = __low2float(h[j]), v[2 * j + 1] = __high2float(h[j]);
}

__device__ __forceinline__ uint4 f32_to_bf16x8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Global offset of (batch row b, output row t, column n).
__device__ __forceinline__ long long out_offset(const Params& p, int b, int t, int n) {
  return ((long long)b * p.L + t) * p.ld + n;
}

// The warpgroup's epilogue rows, as `finish` reads them, into L2 ahead of it.
__device__ __forceinline__ void prefetch_res(const Epi& e, const Params& p, int b, int row_base,
                                             int col0) {
  const int tid = threadIdx.x % 128;
  const int n = col0 + 8 * (tid & 15);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = row_base + (tid >> 4) + 8 * k;
    if (t < p.L)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(e.res + out_offset(p, b, t, n)));
  }
}

// The epilogue (Epi) of one 64-row x 128-column tile of a warpgroup, read
// back from shared memory: each thread takes 8 columns (16 bytes of bf16) of
// 8 rows, so the residual reads and the stores are 16-byte and coalesced
// (16 threads per 256-byte row), the per-channel constants are read once,
// and the loop stays short.
__device__ __forceinline__ void finish(const float (&tile)[64][SROW], const Epi& e, const Params& p,
                                       int b, int row_base, int col0) {
  const int tid = threadIdx.x % 128;
  const int cc = tid & 15;
  const int n = col0 + 8 * cc;
  float bias[8], ae[8] = {}, ib[8] = {}, ae2[8] = {}, ib2[8] = {};
  load_f32(bias, e.bias + n);
  if (e.ae != nullptr) {
    load_f32(ae, e.ae + n);
    load_f32(ib, e.ib + n);
  }
  if (e.out2 != nullptr) {
    const int m = n % e.period;
    load_f32(ae2, e.ae2 + m);
    load_f32(ib2, e.ib2 + m);
  }
#pragma unroll 2
  for (int k = 0; k < 8; ++k) {
    const int rl = (tid >> 4) + 8 * k;
    const int t = row_base + rl;
    if (t >= p.L) break;
    const float4 x0 = *reinterpret_cast<const float4*>(&tile[rl][8 * cc]);
    const float4 x1 = *reinterpret_cast<const float4*>(&tile[rl][8 * cc + 4]);
    float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] += bias[j];
      if (e.ae != nullptr) v[j] = snake(v[j], ae[j], ib[j]);
    }
    const long long off = out_offset(p, b, t, n);
    if (e.res != nullptr) {
      float r[8];
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(e.res + off), r);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += r[j];
    }
    const uint4 y = f32_to_bf16x8(v);
    *reinterpret_cast<uint4*>(e.out + off) = y;
    if (e.out2 != nullptr) {
      bf16x8_to_f32(y, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = snake(v[j], ae2[j], ib2[j]);
      *reinterpret_cast<uint4*>(e.out2 + off) = f32_to_bf16x8(v);
    }
  }
}

// acc (NH x 128 columns from col0, the warpgroup's 64 rows) through the
// warpgroup's shared-memory tile into `finish`, one 128-column half at a time.
template <int NH>
__device__ __forceinline__ void store(const float (&acc)[NH][64], float (&tile)[64][SROW],
                                      const Epi& e, const Params& p, int b, int row_base, int col0,
                                      int wg) {
  const int tid = threadIdx.x % 128, lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<float2*>(&tile[r][8 * i + c]) = make_float2(acc[h][4 * i], acc[h][4 * i + 1]);
      *reinterpret_cast<float2*>(&tile[r + 8][8 * i + c]) =
          make_float2(acc[h][4 * i + 2], acc[h][4 * i + 3]);
    }
    warpgroup_sync(wg);
    finish(tile, e, p, b, row_base, col0 + 128 * h);
    warpgroup_sync(wg);
  }
}

// One output tile of a consumer warpgroup, on ring steps it0 .. it0 + n_steps - 1.
template <class SM, bool FUSED>
__device__ __forceinline__ void consume_tile(SM& sm, const Params& p, const TileIdx& ti, int wg,
                                             int it0) {
  constexpr int NH = SM::NH;
  const int n_base = ti.n0 + 2 * (threadIdx.x & 3);  // this thread's first accumulator column
  const int row_base = ti.t0 + wg * 64;
  if (p.epi.res != nullptr)
    for (int h = 0; h < NH; ++h) prefetch_res(p.epi, p, ti.b, row_base, ti.n0 + 128 * h);
  float acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  const int n1 = p.taps * p.n_ci;
  mainloop_ss<SM>(sm, acc, wg, it0, n1);
  if constexpr (FUSED) {
    bias_snake<NH>(acc, p.b1, p.ae1, p.ib1, n_base);
    uint32_t zf[NH][8][4];
#pragma unroll
    for (int h = 0; h < NH; ++h) to_a_frags(acc[h], zf[h]);
    // The k1 stage one 128-channel half of h' at a time: z and one
    // 64-register accumulator instead of z and all of them.
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float acc2[1][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc2[0][i] = 0.f;
      mainloop_rs<SM>(sm, acc2[0], zf, it0 + n1 + h * (SM::NT / BK));
      store<1>(acc2, sm.tile[wg], p.epi, p, ti.b, row_base, ti.n0 + 128 * h, wg);
    }
  } else {
    store<NH>(acc, sm.tile[wg], p.epi, p, ti.b, row_base, ti.n0, wg);
  }
}

// Barrier over the 256 consumer threads (id 3; 1 and 2 are warpgroup_sync's).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* f) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory");
  return v;
}

// Returns once *f == v. As mbar_wait: a wait of more than 10 s traps.
__device__ __forceinline__ void flag_wait(const int* f, int v) {
  if (ld_acquire(f) == v) return;
  const uint64_t t0 = global_ns();
  while (ld_acquire(f) != v) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// This warpgroup's accumulators to and from its half of a workspace slot,
// [16-byte group][thread], so that a warp's accesses are 512 contiguous
// bytes. Through L2 only (.cg): another SM reads the slot during the launch.
template <int NH>
__device__ __forceinline__ void partial_store(const float (&acc)[NH][64], float4* slot) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int g = 0; g < 16; ++g)
      __stcg(slot + (h * 16 + g) * 128 + tid,
             make_float4(acc[h][4 * g], acc[h][4 * g + 1], acc[h][4 * g + 2], acc[h][4 * g + 3]));
}

template <int NH>
__device__ __forceinline__ void partial_add(float (&acc)[NH][64], const float4* slot) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const float4 v = __ldcg(slot + (h * 16 + g) * 128 + tid);
      acc[h][4 * g] += v.x, acc[h][4 * g + 1] += v.y, acc[h][4 * g + 2] += v.z,
          acc[h][4 * g + 3] += v.w;
    }
}

// One stream-K segment: ring steps it0 .. of K steps k0 .. k1 - 1 of `tile`.
// Starting inside the tile, it adds the running sum of CTA blockIdx.x - 1
// (the tile's steps 0 .. k0 - 1); ending inside it, it leaves its own running
// sum in the CTA's slot and raises the CTA's flag after both warpgroups'
// stores; ending the tile, it runs the epilogue.
template <class SM>
__device__ __forceinline__ void consume_segment(SM& sm, const Params& p, int tile, int k0,
                                                int k1, int wg, int it0) {
  constexpr int NH = SM::NH;
  constexpr int SLOT = 2 * NH * 16 * 128;  // float4s per CTA (128 KB at NT = 256)
  float acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  mainloop_ss<SM>(sm, acc, wg, it0, k1 - k0);
  float4* ws = reinterpret_cast<float4*>(p.ws) + wg * (SLOT / 2);
  if (k0 > 0) {
    if (threadIdx.x == 0) flag_wait(p.flags + blockIdx.x - 1, p.epoch);
    consumers_sync();
    partial_add<NH>(acc, ws + (size_t)(blockIdx.x - 1) * SLOT);
  }
  if (k1 < n_steps<SM>(p)) {
    partial_store<NH>(acc, ws + (size_t)blockIdx.x * SLOT);
    consumers_sync();
    if (threadIdx.x == 0) {
      __threadfence();
      asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p.flags + blockIdx.x),
                   "r"(p.epoch)
                   : "memory");
    }
    return;
  }
  const TileIdx ti = tile_at<SM>(p, tile);
  store<NH>(acc, sm.tile[wg], p.epi, p, ti.b, ti.t0 + wg * 64, ti.n0, wg);
}

template <class SM, bool FUSED, bool SK>
__device__ __forceinline__ void consume(SM& sm, const Params& p, int wg) {
  int ring = 0;
  for (int tile = blockIdx.x; tile < (SK ? p.dp_tiles : n_tiles<SM>(p)); tile += gridDim.x) {
    consume_tile<SM, FUSED>(sm, p, tile_at<SM>(p, tile), wg, ring);
    ring += n_steps<SM>(p);
  }
  if constexpr (SK)
    sk_segments(p, n_steps<SM>(p), [&](int tile, int k0, int k1) {
      consume_segment<SM>(sm, p, tile, k0, k1, wg, ring);
      ring += k1 - k0;
    });
}

// The bounds say 384 threads so that the register count at entry (at most
// 168) stays below the consumers' 240. SK: the stream-K walk of Params (the
// chain's launches, kernel 3), never with FUSED.
template <int NT, bool FUSED, bool SK>
__global__ void __launch_bounds__(3 * 128, 1)
oobleck_conv_sm90(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
                  const __grid_constant__ CUtensorMap mw2, const __grid_constant__ Params p) {
  static_assert(!(SK && FUSED), "the stream-K walk has no fused unit");
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries.
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  using SM = ConvSmem<NT>;
  auto& sm = *reinterpret_cast<SM*>(smem_raw + pad);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SM::STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * 128) produce<SM, SK>(sm, &ma, &mw, &mw2, p);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<SM, FUSED, SK>(sm, p, wg);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// (B, L, C) activations: map {C, L, B, 1}, box {64, 128}.
bool act_map(CUtensorMap* m, const void* base, int B, int L, int C) {
  return make_map(m, base, {(uint64_t)C, (uint64_t)L, (uint64_t)B, 1ull},
                  {(uint64_t)C, (uint64_t)L * C, (uint64_t)L * C * B},
                  {(uint32_t)BK, 128u, 1u, 1u});
}

// (taps, N, C_in) packed weights: map {C_in, N, taps, 1}, box {64, NT}.
bool weight_map(CUtensorMap* m, const void* base, int taps, int N, int Ci, int nt) {
  return make_map(m, base, {(uint64_t)Ci, (uint64_t)N, (uint64_t)taps, 1ull},
                  {(uint64_t)Ci, (uint64_t)N * Ci, (uint64_t)taps * N * Ci},
                  {(uint32_t)BK, (uint32_t)nt, 1u, 1u});
}

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);
constexpr int MAX_DEVICES = 64;

// The CTAs of an instance that one card holds at once (SMs x CTAs per SM),
// once its shared-memory attribute is set on the card, else 0.
template <int NT, bool FUSED, bool SK>
std::atomic<int> resident[MAX_DEVICES];

// `sched` null: one CTA per SM (at most one per tile), each walking tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... Else the stream-K walk
// {grid, dp_tiles, sk_ctas, sk_q, sk_r, epoch} (SK) with its workspace and
// flags, refused unless it covers every (tile, K step) once on a persistent
// grid (no more CTAs than the card holds at once).
template <int NT, bool FUSED, bool SK>
int launch_conv(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mw2, Params p,
                int B, int N, const int* sched, void* ws, void* flags, cudaStream_t stream) {
  using SM = ConvSmem<NT>;
  constexpr size_t smem = sizeof(SM) + 1024;
  auto kernel = oobleck_conv_sm90<NT, FUSED, SK>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return BAD;
  // Once per instance and card, not per launch: the launch's host share is
  // part of every decode chunk.
  int held = resident<NT, FUSED, SK>[dev].load(std::memory_order_relaxed);
  if (held == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 3 * 128, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return BAD;
    held = sms * per_sm;
    resident<NT, FUSED, SK>[dev].store(held, std::memory_order_relaxed);
  }
  p.n_nt = N / NT;
  p.batch = B;
  const int tiles = (p.L + SM::BM - 1) / SM::BM * p.n_nt * B;
  int grid = tiles < held ? tiles : held;
  if constexpr (SK) {
    grid = sched[0];
    p.dp_tiles = sched[1];
    p.sk_ctas = sched[2];
    p.sk_q = sched[3];
    p.sk_r = sched[4];
    p.epoch = sched[5];
    p.ws = static_cast<float*>(ws);
    p.flags = static_cast<int*>(flags);
    const long long split = (long long)(tiles - p.dp_tiles) * n_steps<SM>(p);
    const bool ok =
        grid >= 1 && grid <= held && p.dp_tiles >= 0 && p.dp_tiles <= tiles &&
        p.sk_ctas >= 0 && p.sk_ctas <= grid &&
        (p.sk_ctas == 0 ? split == 0
                        : p.sk_q >= 1 && p.sk_r >= 0 && p.sk_r < p.sk_ctas && ws && flags &&
                              (long long)p.sk_ctas * p.sk_q + p.sk_r == split);
    if (!ok) return BAD;
  }
  kernel<<<grid, 3 * 128, smem, stream>>>(ma, mw, mw2, p);
  return static_cast<int>(cudaGetLastError());
}

Params base_params(int L, long long ld, int Ci, int taps, int dil, int pad) {
  Params p = {};
  p.L = L;
  p.ld = ld;
  p.n_ci = Ci / BK;
  p.taps = taps;
  p.dil = dil;
  p.pad = pad;
  return p;
}

// The two stages of a unit as two launches, C a multiple of 128: kernel 2's
// units at C = 512 (`sched` null: the data-parallel instance) and kernel 3's
// chain (`sched` = the stream-K walk, see launch_conv; ws and flags are read
// only where it splits tiles). Tiles of 256 output channels where C is a
// multiple of 256, else of 128, on whole tiles only.
using LaunchFn = int (*)(const CUtensorMap&, const CUtensorMap&, const CUtensorMap&, Params, int,
                         int, const int*, void*, void*, cudaStream_t);

int stage_nt(int C) { return C % 256 ? 128 : 256; }

LaunchFn unit_stage(int C, const int* sched) {
  if (C % 256) return sched ? nullptr : launch_conv<128, false, false>;
  return sched ? launch_conv<256, false, true> : launch_conv<256, false, false>;
}

}  // namespace

// Each entry point returns a cudaError_t: cudaErrorInvalidValue for a shape it
// does not take or a tensor map that cannot be made. Channel counts are
// multiples of 64; N of the upsample a multiple of 256; C of the k7 and k1
// stages a multiple of 128, and of 256 on the stream-K walk. C linkage inside the
// namespace: the symbols are the plain names.

// conv_t as a 3-tap conv over phase columns: y (B, L, N = s C_out) = conv(a0) + bias,
// a1 = Snake(y) at channel n % C_out. w is (3, N, C_in).
extern "C" int acestep_oob_upsample(const void* a0, const void* w, const void* bias,
                                    const void* ae, const void* ib, void* y, void* a1, int B,
                                    int L, int Ci, int N, int Co, void* stream) {
  if (Ci % BK || N % 256 || Co <= 0) return BAD;
  CUtensorMap ma, mw;
  if (!act_map(&ma, a0, B, L, Ci) || !weight_map(&mw, w, 3, N, Ci, 256)) return BAD;
  Params p = base_params(L, N, Ci, 3, 1, 1);
  p.epi = {static_cast<const float*>(bias), nullptr, nullptr, nullptr, static_cast<bf16*>(y),
           static_cast<const float*>(ae), static_cast<const float*>(ib), static_cast<bf16*>(a1),
           Co};
  return launch_conv<256, false, false>(ma, mw, mw, p, B, N, nullptr, nullptr, nullptr,
                                       static_cast<cudaStream_t>(stream));
}

// One residual unit in one launch, C in {128, 256}: out = h + conv_k1(z) + b2
// with z = Snake2(conv_k7,dil(a) + b1) in registers; a_next = Snake1_next(out)
// unless a_next is null. w1 is (7, C, C), w2 (1, C, C), both (tap, n, ci).
extern "C" int acestep_oob_unit(const void* a, const void* h, const void* w1, const void* b1,
                                const void* ae1, const void* ib1, const void* w2, const void* b2,
                                const void* aen, const void* ibn, void* out, void* a_next, int B,
                                int L, int C, int dil, void* stream) {
  if (C != 128 && C != 256) return BAD;
  CUtensorMap ma, mw, mw2;
  if (!act_map(&ma, a, B, L, C) || !weight_map(&mw, w1, 7, C, C, C) ||
      !weight_map(&mw2, w2, 1, C, C, 128))
    return BAD;
  Params p = base_params(L, C, C, 7, dil, 3 * dil);
  p.n_ci2 = C / BK;
  p.b1 = static_cast<const float*>(b1);
  p.ae1 = static_cast<const float*>(ae1);
  p.ib1 = static_cast<const float*>(ib1);
  p.epi = {static_cast<const float*>(b2), nullptr, nullptr, static_cast<const bf16*>(h),
           static_cast<bf16*>(out), static_cast<const float*>(aen), static_cast<const float*>(ibn),
           static_cast<bf16*>(a_next), C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return C == 128 ? launch_conv<128, true, false>(ma, mw, mw2, p, B, C, nullptr, nullptr, nullptr, st)
                  : launch_conv<256, true, false>(ma, mw, mw2, p, B, C, nullptr, nullptr, nullptr, st);
}

// The k7 stage alone: z = Snake2(conv_k7,dil(a) + b1). w1 is (7, C, C).
extern "C" int acestep_oob_k7(const void* a, const void* w1, const void* b1, const void* ae1,
                              const void* ib1, void* z, int B, int L, int C, int dil,
                              const int* sched, void* ws, void* flags, void* stream) {
  const LaunchFn launch = C % 128 ? nullptr : unit_stage(C, sched);
  CUtensorMap ma, mw;
  if (!launch || !act_map(&ma, a, B, L, C) || !weight_map(&mw, w1, 7, C, C, stage_nt(C))) return BAD;
  Params p = base_params(L, C, C, 7, dil, 3 * dil);
  p.epi = {static_cast<const float*>(b1), static_cast<const float*>(ae1),
           static_cast<const float*>(ib1), nullptr, static_cast<bf16*>(z), nullptr, nullptr,
           nullptr, C};
  return launch(ma, mw, mw, p, B, C, sched, ws, flags, static_cast<cudaStream_t>(stream));
}

// The k1 stage alone: out = h + conv_k1(z) + b2; a_next = Snake1_next(out)
// unless a_next is null. w2 is (1, C, C).
extern "C" int acestep_oob_k1(const void* z, const void* h, const void* w2, const void* b2,
                              const void* aen, const void* ibn, void* out, void* a_next, int B,
                              int L, int C, const int* sched, void* ws, void* flags,
                              void* stream) {
  const LaunchFn launch = C % 128 ? nullptr : unit_stage(C, sched);
  CUtensorMap mz, mw;
  if (!launch || !act_map(&mz, z, B, L, C) || !weight_map(&mw, w2, 1, C, C, stage_nt(C))) return BAD;
  Params p = base_params(L, C, C, 1, 1, 0);
  p.epi = {static_cast<const float*>(b2), nullptr, nullptr, static_cast<const bf16*>(h),
           static_cast<bf16*>(out), static_cast<const float*>(aen), static_cast<const float*>(ibn),
           static_cast<bf16*>(a_next), C};
  return launch(mz, mw, mw, p, B, C, sched, ws, flags, static_cast<cudaStream_t>(stream));
}

}  // namespace sm90
