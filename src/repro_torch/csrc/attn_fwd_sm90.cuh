// The bf16 attention forward on Hopper's tensor cores (sm_90a): the body
// that the flash forward (flash_attention.cu), the local-window forward
// (local_attention.cu), the gathered routing forward (routing_gathered.cu)
// and the fused routing forward (routing_fused.cu) share.
//
// A block of 256 threads owns 128 query rows of one plane, 64 per
// warpgroup; TMA loads its Q once and walks key tiles of 128 rows (64 at
// dh 192 and 256: `fwd_keys`) through a ring of two K/V stages (`sm90::Ring`),
// from 3-D tensor maps (dh, rows, planes): rows past a plane's end arrive
// as zeros, never as the next plane's rows. At dh 128 a tile is two boxes
// of 64 columns, at dh 192 three, at dh 256 four (`head_boxes`). At dh 80
// (the flash forward's instance for hubert-xlarge's heads) a tile is two
// boxes too, the second holding columns 64-79 and the zeros TMA writes
// past the plane's dh (counted in the barriers' bytes); the products read
// columns 0-79 only. Per tile S = Q K^T is one SS wgmma chain of dh / 16
// k16 steps (five at dh 80, the fifth from the second box; m64n128k16,
// m64n64k16 at dh 192 and 256; K a K-major operand); the online softmax
// runs in fp32 on the accumulator registers (a row's max and sum over the
// 4 threads of a quad); P, zero where masked and rounded to bf16 in
// registers (`pack_a`), is the A operand of the RS wgmma chain O += P V
// (V an MN-major operand; m64n80k16 at dh 80, B over two boxes one tile
// apart). The output is rounded to bf16 once and written dh wide;
// lse = m * scale + log(max(l, 1e-30)) in fp32.
//
// The body runs the softmax of a tile between its two products, with no
// overlap of one tile's exponentials with the next tile's wgmma. In the
// flash forward (which replaces the TPU kernel `_kernel` of the JAX
// package's kernels/flash_attention.py) the products bound the work, 4 *
// dh operations a pair: at dh 80 and hubert-xlarge's shape (B 2, H 16,
// N = M 4096) 0.1737 ms at the card's bf16 peak. Its N * M exponentials a
// head, at 16 a clock per SM, take some 0.14-0.15 ms of that shape on
// their own, ~83% of the products' time, so at dh 80 they are the next
// cost to take on.
//
// What the walk covers and what is masked is the policy's (the `P` of the
// body), so one body serves row indices, windows and positions:
//   P::qplane, kplane   planes of the q and the k/v tensor maps; out and
//                       lse use the query plane (qplane * N)
//   P::N                query rows of a plane
//   P::q0               the block's first query row
//   P::k_first          first key row of the walk
//   P::ntiles           key tiles walked (0: no row of the block keeps a
//                       key)
//   P::kNoKeyRows       whether a row may keep no key at all. Its running
//                       max stays -inf, and it writes out 0 and lse
//                       NEG + log(1e-30), as `FlashTile::store` and the
//                       plain versions do; the backward kernels drop such
//                       a row by its lse (attn_bwd_sm90.cuh). Flash's rows
//                       always keep a key, and its lse stays as it was
//   row_tag(row)        what an owned row's mask reads (an index, a
//                       window, a position), taken once into registers
//   tile_tags()         whether the walked tile's keys are staged
//   stage(wg, buf, t, j)  thread t of warpgroup wg stages what the mask
//                       reads of key row j (double-buffered by tile
//                       parity, behind a named barrier)
//   edge(wg, buf, k0)   whether this warpgroup masks the tile at all
//   drop(wg, buf, c, j, tag)  element (owned row of ``tag``, tile column
//                       c = key row j) is masked
//
// A policy with P::kGatherRows true (the fused routing forward, whose rows
// are a cluster's members picked by index from sequence-layout planes,
// which TMA boxes cannot pick) loads the tiles itself by cp.async into the
// same swizzled layout, with all 256 threads, as the backward bodies'
// gathering policies do (attn_bwd_sm90.cuh), and the tensor maps go
// unused:
//   gather_own(q)         the block's 128 query rows
//   gather_tile(k, v, k0) the walked K and V tile from key row k0, rows
//                         past the keys as zeros
// Q and tile 0 go before the walk; at the top of tile j each thread waits
// for its own copies, fences them into the async proxy, and the block
// syncs, which also frees tile j - 1's stage: tile j + 1 is gathered into
// it while tile j computes. No mbarrier, no ring; a block whose walk is
// empty gathers nothing.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace sm90 {

constexpr int FWD_ROWS = 128;   // query rows per block: two warpgroups of 64
constexpr int FWD_KEYS = 128;   // key rows per tile

// Key rows per tile at head dim DH: FWD_KEYS, but 64 at dh 192 and 256,
// where the Q tile and two stages of 128-row K and V tiles would take 240
// and 320 KB of shared memory (the block has 227 KB); 64-row tiles take
// 144 and 192 KB, and the score and P fragments shrink by half beside the
// 96 and 128 registers of O.
template <int DH>
__host__ __device__ constexpr int fwd_keys() {
  return DH > 128 ? 64 : FWD_KEYS;
}

template <int DH>
struct FwdSmemH {
  static constexpr int BOXES = head_boxes<DH>();
  static constexpr int KEYS = fwd_keys<DH>();
  static constexpr uint32_t QBOX = FWD_ROWS * ROW_BYTES;  // bytes of a box
  static constexpr uint32_t KBOX = KEYS * ROW_BYTES;
  __nv_bfloat16 q[BOXES][FWD_ROWS][BOX_COLS];
  __nv_bfloat16 k[RING_STAGES][BOXES][KEYS][BOX_COLS];
  __nv_bfloat16 v[RING_STAGES][BOXES][KEYS][BOX_COLS];
  uint64_t qbar;
  Ring ring;
};

template <int DH, typename P>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         __nv_bfloat16* __restrict__ o,
                                         float* __restrict__ lse,
                                         const P& pol, float scale) {
  using Sm = FwdSmemH<DH>;
  constexpr int KEYS = Sm::KEYS;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int ntiles = pol.ntiles;
  constexpr uint32_t KV_BYTES = 2 * Sm::BOXES * Sm::KBOX;

  auto load_kv = [&](int j) {
    const int s = j % RING_STAGES;
    uint64_t* bar = sm.ring.produce(j, KV_BYTES);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.k[s][x][0][0], &tk, bar, x * BOX_COLS,
                  pol.k_first + j * KEYS, pol.kplane);
      tma_load_3d(&sm.v[s][x][0][0], &tv, bar, x * BOX_COLS,
                  pol.k_first + j * KEYS, pol.kplane);
    }
  };
  constexpr bool G = GathersRows<P>::value;
  if constexpr (G) {
    if (ntiles > 0) {
      pol.gather_own(&sm.q[0][0][0]);
      pol.gather_tile(&sm.k[0][0][0][0], &sm.v[0][0][0][0], pol.k_first);
      cp_async_commit();
    }
  } else {
    sm.ring.init(&sm.qbar);
    if (tid == 0) {
      mbar_expect_tx(&sm.qbar, Sm::BOXES * Sm::QBOX);
#pragma unroll
      for (int x = 0; x < Sm::BOXES; ++x)
        tma_load_3d(&sm.q[x][0][0], &tq, &sm.qbar, x * BOX_COLS, pol.q0,
                    pol.qplane);
      sm.ring.prime(ntiles, load_kv);
    }
  }

  const int lane = t % 32;
  const int r = 64 * wg + 16 * (t / 32) + lane / 4;   // rows r and r + 8
  const int cq = 2 * (lane % 4);
  const int row0 = pol.q0 + r, row1 = row0 + 8;
  const auto tag0 = pol.row_tag(row0);
  const auto tag1 = pol.row_tag(row1);
  const float sl2 = scale * 1.4426950408889634f;      // scale * log2(e)
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const void* qtile = &sm.q[0][64 * wg][0];

  if constexpr (!G) mbar_wait(&sm.qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % RING_STAGES, buf = j % 2;
    const int k0 = pol.k_first + j * KEYS;
    if (pol.tile_tags()) {
      if (KEYS == WG || t < KEYS) pol.stage(wg, buf, t, k0 + t);
      wg_sync(1 + wg);
    }
    if constexpr (G) {
      gathered_tile_ready();
      if (j + 1 < ntiles) {
        pol.gather_tile(&sm.k[(j + 1) % RING_STAGES][0][0][0],
                        &sm.v[(j + 1) % RING_STAGES][0][0][0],
                        k0 + KEYS);
        cp_async_commit();
      }
    } else {
      sm.ring.wait(j);
    }
    float sc[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, desc_k(qtile, kk, Sm::QBOX),
               desc_k(&sm.k[s][0][0][0], kk, Sm::KBOX), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if (pol.edge(wg, buf, k0)) {
#pragma unroll
      for (int c = 0; c < KEYS / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * c + cq + e;
          if (pol.drop(wg, buf, cl, k0 + cl, tag0))
            sc[4 * c + e] = -INFINITY;
          if (pol.drop(wg, buf, cl, k0 + cl, tag1))
            sc[4 * c + 2 + e] = -INFINITY;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < KEYS / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    // a row with no unmasked key yet keeps max -inf: subtract 0 instead
    const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float alpha0 = exp2f(m0 * sl2 - ms0);
    const float alpha1 = exp2f(m1 * sl2 - ms1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < KEYS / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * c + e] = exp2f(fmaf(sc[4 * c + e], sl2, -ms0));
        sc[4 * c + 2 + e] = exp2f(fmaf(sc[4 * c + 2 + e], sl2, -ms1));
        sum0 += sc[4 * c + e];
        sum1 += sc[4 * c + 2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;   // this thread's share; summed over 4 at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      acc[4 * c] *= alpha0;
      acc[4 * c + 1] *= alpha0;
      acc[4 * c + 2] *= alpha1;
      acc[4 * c + 3] *= alpha1;
    }
    uint32_t pa[KEYS / 16][4];
    pack_a(sc, pa);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KEYS / 16; ++c)
      wgmma_rs(acc, pa[c], desc_mn(&sm.v[s][0][0][0], c, Sm::KBOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    // stage s is free once both warpgroups are done with it
    if constexpr (!G) sm.ring.advance(j, ntiles, load_kv);
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int N = pol.N;
  const size_t plane = static_cast<size_t>(pol.qplane) * N;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + cq;
    if (row0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + (plane + row0) * DH + col) =
          __floats2bfloat162_rn(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
    if (row1 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + (plane + row1) * DH + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] * inv1,
                                acc[4 * c + 3] * inv1);
  }
  auto row_lse = [&](float m, float l) {
    if constexpr (P::kNoKeyRows) {
      if (m == -INFINITY) return rt::NEG + logf(1e-30f);
    }
    return m * scale + logf(fmaxf(l, 1e-30f));
  };
  if (lane % 4 == 0) {
    if (row0 < N) lse[plane + row0] = row_lse(m0, l0);
    if (row1 < N) lse[plane + row1] = row_lse(m1, l1);
  }
}

}  // namespace sm90
