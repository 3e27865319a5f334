// Hopper (sm_90a) attention mainloop shared by csrc/flash_attention.cu
// (kernel 1) and csrc/attention_probe.cu (kernel 4, its stage-cost probe).
//
// The shape is FlashAttention-3's (Shah et al., 2024):
//   - A CTA covers NWG * 64 query rows of one q head and one batch row: NWG
//     consumer warpgroups of 64 rows each (wgmma's M) and one producer
//     warpgroup, of which one thread issues every load. `setmaxnreg` moves
//     registers from the producer (24) to the consumers (240).
//   - The producer loads Q once and then 128-key K and V tiles through a ring
//     of STAGES shared-memory stages with TMA (`cp.async.bulk.tensor`, 128-byte
//     swizzle: a 128-wide head is two 64-column boxes). Each stage has a full
//     barrier for K, one for V, and an empty barrier the consumers arrive on.
//   - S = Q K^T is 8 `wgmma.m64n128k16` with Q and K both read from shared
//     memory (K-major; K stored transposed is the MN-major operand, through the
//     descriptor's transpose bit). The fp32 S accumulators become, in
//     registers, the bf16 A fragments of P, and O += P V is 8 more wgmma with
//     A from registers and V (MN-major, transpose bit) from shared memory. P is
//     never written to shared memory.
//   - Each consumer issues tile j's Q K^T before tile j-1's P V and runs tile
//     j's score stage while that P V is on the tensor cores; the two consumer
//     warpgroups take turns to issue (ping-pong on named barriers 3 and 4), so
//     one's score stage also overlaps the other's products.
// The kernel-specific work is an `Op`: which key tiles a CTA visits (`tile`),
// the score stage that turns S into P (`scores`), the matching correction of
// O (`rescale`), work on the V tile before its stage is released
// (`after_pv`) and the store (`finish`).
// Kernel 1's Op masks (band, causal, key padding) and runs the online
// softmax; kernel 4's Op runs one of the probe's stripped stages, so the
// probe's times cost this loop's stages.
#pragma once

#include <float.h>

#include "sm90.cuh"

namespace sm90 {

constexpr int HD = 128;                              // head dim
constexpr int BKV = 128;                             // keys per tile
constexpr int BOX = 64;                              // bf16 columns of one 128-byte swizzled box
constexpr uint32_t KV_TILE_BYTES = BKV * HD * 2;     // 32 KB: a K or V tile, two boxes
constexpr uint32_t KV_HALF_BYTES = KV_TILE_BYTES / 2;
constexpr float NEG_INF = -0.7f * FLT_MAX;           // pallas_attention.py's finite mask value
constexpr float LOG2E = 1.4426950408889634f;

template <int NWG, int STAGES>
struct Smem {
  bf16 q[2][NWG * 64][BOX];      // Q as two 64-column boxes, each [rows][64] swizzled
  bf16 k[STAGES][2][BKV][BOX];   // K as [2 column boxes][keys][64]; K^T as [2 key boxes][dims][64]
  bf16 v[STAGES][2][BKV][BOX];
  float vsum[NWG][HD];           // kernel 4, +max mode: column sums of the V tiles so far
  uint64_t full_q;
  uint64_t full_k[STAGES];
  uint64_t full_v[STAGES];
  uint64_t empty[STAGES];
};

// Which key tiles a CTA visits, and where it sits in the grid.
struct Tile {
  int q0, hq, hk, b;   // first query row, q head, kv head, batch row
  int kt_begin;        // first key tile
  int n_tiles;         // key tiles visited
};

// Max and sum over the 4 threads that share a row of the accumulator layout.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// ---------------------------------------------------------------------------
// The two roles
// ---------------------------------------------------------------------------

template <int NWG, int STAGES, bool KT>
__device__ __forceinline__ void produce(Smem<NWG, STAGES>& sm, const CUtensorMap* mq,
                                        const CUtensorMap* mk, const CUtensorMap* mv,
                                        const Tile& t) {
  // Maps are 4-D {128 columns, rows, heads, batch}; K^T's is {keys, 128, heads, batch}.
  mbar_expect_tx(&sm.full_q, NWG * 64 * HD * 2);
  tma_load_4d(&sm.q[0][0][0], mq, &sm.full_q, 0, t.q0, t.hq, t.b);
  tma_load_4d(&sm.q[1][0][0], mq, &sm.full_q, BOX, t.q0, t.hq, t.b);
  for (int it = 0; it < t.n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = (t.kt_begin + it) * BKV;
    mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full_k[s], KV_TILE_BYTES);
    if (KT) {
      tma_load_4d(&sm.k[s][0][0][0], mk, &sm.full_k[s], k0, 0, t.hk, t.b);
      tma_load_4d(&sm.k[s][1][0][0], mk, &sm.full_k[s], k0 + BOX, 0, t.hk, t.b);
    } else {
      tma_load_4d(&sm.k[s][0][0][0], mk, &sm.full_k[s], 0, k0, t.hk, t.b);
      tma_load_4d(&sm.k[s][1][0][0], mk, &sm.full_k[s], BOX, k0, t.hk, t.b);
    }
    mbar_expect_tx(&sm.full_v[s], KV_TILE_BYTES);
    tma_load_4d(&sm.v[s][0][0][0], mv, &sm.full_v[s], 0, k0, t.hk, t.b);
    tma_load_4d(&sm.v[s][1][0][0], mv, &sm.full_v[s], BOX, k0, t.hk, t.b);
  }
}

template <class Op, int NWG, int STAGES>
struct Consumer {
  static constexpr uint32_t Q_HALF_BYTES = NWG * 64 * BOX * 2;
  Smem<NWG, STAGES>& sm;
  uint64_t dq;  // Q descriptor of k16 step 0; steps add their byte offset >> 4

  // S = Q K^T of the tile in stage `st`, issued and committed (not waited for).
  __device__ __forceinline__ void issue_qk(float (&s)[64], int st) {
    const uint64_t dk = Op::KT ? make_desc(&sm.k[st][0][0][0], KV_HALF_BYTES, 1024)
                               : make_desc(&sm.k[st][0][0][0], 16, 1024);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t a = dq + (((kk / 4) * Q_HALF_BYTES + (kk % 4) * 32) >> 4);
      const uint64_t b = Op::KT ? dk + ((kk * 2048) >> 4)
                                : dk + (((kk / 4) * KV_HALF_BYTES + (kk % 4) * 32) >> 4);
      wgmma_ss<Op::KT ? 1 : 0>(s, a, b, kk > 0);
    }
    wgmma_commit();
  }

  // O += P V of the tile in stage `st`, issued and committed.
  __device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&pa)[8][4], int st) {
    const uint64_t dv = make_desc(&sm.v[st][0][0][0], KV_HALF_BYTES, 1024);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<1>(acc, pa[kk], dv + ((kk * 2048) >> 4));
    wgmma_commit();
  }
};

// The consumer warpgroup's loop. Tile j's Q K^T is issued before tile j-1's
// P V, and tile j's score stage runs while that P V is on the tensor cores;
// O is rescaled for tile j once P V of j-1 has landed (FlashAttention-3's
// intra-warpgroup overlap). With two consumer warpgroups, each waits for its
// turn (named barrier 3 + wg) before issuing a tile's products and hands the
// turn over (barrier 4 - wg) after: per tile, warpgroup 1 arrives once more
// than warpgroup 0 waits, so the prologue and epilogue even the counts.
template <class Op, int NWG, int STAGES>
__device__ __forceinline__ void consume(Smem<NWG, STAGES>& sm, const typename Op::Params& p,
                                        const Tile& t, int wg) {
  Op op(p, t, wg, threadIdx.x % 128, sm.vsum[wg]);
  Consumer<Op, NWG, STAGES> c{sm, make_desc(&sm.q[0][wg * 64][0], 16, 1024)};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float s[64];
  uint32_t pa[8][4];
  mbar_wait(&sm.full_q, 0);
  if (t.n_tiles == 0) {
    op.finish(acc);
    return;
  }
  // Ping-pong turns: warpgroup 1 lets warpgroup 0 issue first.
  if (NWG == 2)
    asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, %0, 1;\n@p bar.arrive 3, 256;\n}\n" ::"r"(wg)
                 : "memory");
  op.begin_tile(t.kt_begin * BKV);
  mbar_wait(&sm.full_k[0], 0);
  wgmma_fence();
  c.issue_qk(s, 0);
  wgmma_wait<0>();
  fence_regs(s);
  op.scores(s, t.kt_begin * BKV);
  to_a_frags(s, pa);

  for (int it = 1; it < t.n_tiles; ++it) {
    const int st = it % STAGES, prev = (it - 1) % STAGES;
    const int k0 = (t.kt_begin + it) * BKV;
    op.begin_tile(k0);
    fence_regs(pa);
    fence_regs(acc);
    mbar_wait(&sm.full_k[st], (it / STAGES) & 1);
    if (NWG == 2) asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
    wgmma_fence();
    c.issue_qk(s, st);
    mbar_wait(&sm.full_v[prev], ((it - 1) / STAGES) & 1);
    c.issue_pv(acc, pa, prev);
    if (NWG == 2) asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
    wgmma_wait<1>();  // Q K^T of tile it
    fence_regs(s);
    op.scores(s, k0);
    wgmma_wait<0>();  // P V of tile it - 1
    fence_regs(acc);
    fence_regs(pa);
    op.after_pv(&sm.v[prev][0][0][0], wg);
    mbar_arrive(&sm.empty[prev]);
    op.rescale(acc);
    to_a_frags(s, pa);
  }

  // Warpgroup 0 takes the turn warpgroup 1 gave after its last issue.
  if (NWG == 2)
    asm volatile("{\n.reg .pred p;\nsetp.eq.u32 p, %0, 0;\n@p bar.sync 3, 256;\n}\n" ::"r"(wg)
                 : "memory");
  const int last = (t.n_tiles - 1) % STAGES;
  fence_regs(pa);
  fence_regs(acc);
  mbar_wait(&sm.full_v[last], ((t.n_tiles - 1) / STAGES) & 1);
  wgmma_fence();
  c.issue_pv(acc, pa, last);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
  op.after_pv(&sm.v[last][0][0][0], wg);
  mbar_arrive(&sm.empty[last]);
  op.finish(acc);
}

// The bounds say 384 threads for one consumer warpgroup too, so that the
// register count at entry (at most 168) stays below the consumers' 240.
template <class Op, int NWG, int STAGES>
__global__ void __launch_bounds__(3 * 128, 1)
attention_sm90(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ typename Op::Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries.
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  auto& sm = *reinterpret_cast<Smem<NWG, STAGES>*>(smem_raw + pad);
  const Tile t = Op::tile(p, NWG * 64);
  static_assert(NWG == 1 || NWG == 2, "one or two consumer warpgroups");
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty[s], NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NWG * 128) produce<NWG, STAGES, Op::KT>(sm, &mq, &mk, &mv, t);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<Op, NWG, STAGES>(sm, p, t, wg);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <class Op, int NWG, int STAGES>
inline int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                  const typename Op::Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<NWG, STAGES>) + 1024;
  auto kernel = attention_sm90<Op, NWG, STAGES>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, (NWG + 1) * 128, smem, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
