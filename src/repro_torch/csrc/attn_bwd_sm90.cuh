// The bf16 attention backward on Hopper's tensor cores (sm_90a): the dk/dv
// and dq bodies that the flash backward (flash_attention_bwd.cu), the
// local-window backward (local_attention_bwd.cu), the gathered routing
// backward (routing_gathered_bwd.cu) and the fused routing backward
// (routing_fused_bwd.cu) share. All recompute p from the forward's lse and
// mask it explicitly:
//   p  = keep ? exp(q.k * scale - lse) : 0
//   ds = p * (do.v - D) * scale,  D = rowsum(do * out) (computed outside)
//   dq = ds . K,   dk = ds^T . Q,   dv = p^T . dO
// with fp32 outputs. p comes from the mask, never from underflow: a query
// row that keeps no key has lse = -1e9 (attn_bwd.cuh), so exp(s - lse) of
// its scores is +inf, and it is dropped by a select, never multiplied.
//
// A block of 256 threads owns 128 rows, 64 per warpgroup, loaded once by
// TMA, and walks tiles of the other side through a ring of two stages
// (`sm90::Ring`) from 3-D tensor maps (dh, rows, planes: rows past a
// plane's end arrive as zeros). At dh 80 the tiles are those of dh 128,
// two boxes a row, the second zero past column 80, and the products read
// columns 0-79 only: five k16 steps for S and dP (and their transposes),
// m64n80k16 for dV, dK and dQ (`head_boxes`).
// - dk/dv: the block owns 128 key rows (K, V) and walks query tiles of BQ
//   rows (Q, dO; BQ 64 at dh 64 and 80, 32 at dh 128, 192 and 256 so that
//   dK and dV, 64 x dh fp32 each per warpgroup, leave room for the tile's
//   products: `dkv_tile_queries`). Per tile: S^T = K Q^T and dP^T = V dO^T
//   (SS, K-major), P^T = exp(S^T scale - lse) on the accumulators, dV +=
//   P^T dO (RS, dO MN-major), dS^T = P^T (dP^T - D) scale, dK += dS^T Q
//   (RS, Q MN-major).
//   Above dh 128 dK and dV do not both fit in registers: the walk runs
//   twice (`dkv_sweeps`), at dh 192 dV in the first sweep and dK in the
//   second, at dh 256 both over columns 0-127 in the first and both over
//   columns 128-255 in the second (`dkv_col_parts`).
// - dq: the block owns 128 query rows (Q, dO, their lse and D) and walks
//   key tiles of KT rows (K, V; KT 64 up to dh 192, 32 at dh 256 so that
//   the owned tiles and the ring fit in shared memory, `dq_tile_keys`).
//   Per tile: S = Q K^T and dP = dO V^T (SS), P, dS, dQ += dS K (RS, K
//   MN-major).
// P and dS are products' A operands. Rounded to one bf16 value each, they
// put dq, dk and dv 1.4-2.6e-3 (flash at qwen2's shape) and 1.2-2.8e-3
// (gathered blocks of rt-cifar10 and rt-enwik8) of their largest value
// from the fp32 result (tests/test_torch_flash_bwd_split.py,
// tests/test_torch_gathered_bwd_split.py), over the 1e-3 chip_smoke.py
// holds them to. So each is split into two bf16 fragments, hi = bf16(x)
// and lo = bf16(x - hi) (`sm90::pack_a_split`), and each of those products
// runs twice into one fp32 accumulator: 6 products a tile where 4 would do
// (dk/dv) and 4 where 3 would (dq), all at the bf16 rate.
//
// What the walk covers and what is masked is the policy's (the `P` of the
// bodies), so one body serves row-index causality and positions:
//   P::qplane, kplane   planes of the q/dO and the k/v tensor maps; lse, D
//                       and the outputs use the query plane (qplane * N)
//   P::N, M             query and key rows of a plane
//   P::k0 (dk/dv)       the block's first key row; P::q0 (dq) first query
//   P::q_first (dk/dv)  first query row of the walk; P::k_first (dq) key
//   P::ntiles           tiles walked (0: the block writes zeros)
//   key_tag / row_tag   what an owned row's mask reads (an index, a
//                       window or a position; any type `drop` takes),
//                       taken once into registers
//   stage(wg, buf, t, i)  threads t < tile rows of warpgroup wg: stage
//                       what the mask reads of the walked tile's row i
//                       (double-buffered by tile parity, beside lse and D)
//   edge(wg, buf, i0, rows)  whether this warpgroup masks the tile at all
//   drop(wg, buf, c, i, tag)  element (owned row of ``tag``, tile row c =
//                       row i of the plane) is masked
// dq stages per tile only when P::kTileTags (behind a named barrier).
//
// A policy with P::kGatherRows true (the fused routing kernels, whose rows
// are picked by index from sequence-layout planes, which TMA boxes cannot
// do) loads the tiles itself by cp.async into the same swizzled layout,
// with all 256 threads, and the tensor maps go unused:
//   gather_own(a, b)      the block's owned tiles (dk/dv: K, V; dq: Q, dO)
//   gather_tile(a, b, i0) the walked tile from plane row i0 (dk/dv: Q, dO;
//                         dq: K, V), rows past the plane as zeros
// The owned rows and tile 0 go before the walk; at the top of tile j each
// thread waits for its own copies, fences them into the async proxy, and
// the block syncs, which also frees tile j - 1's stage: tile j + 1 is
// gathered into it while tile j computes. No mbarrier, no ring.
#pragma once

#include "sm90.cuh"

namespace sm90 {

constexpr int HB = 128;        // rows a block owns: two warpgroups of 64
constexpr int HBN = 64;        // key rows per dq tile up to dh 192
constexpr float LOG2E = 1.4426950408889634f;

// Key rows per tile of the dq body: 64, and 32 at dh 256, where the owned
// Q and dO (64 KB each) and two stages of 64-row K and V tiles would take
// 256 KB of shared memory (a block has 227 KB); 32-row tiles take 192 KB.
template <int DH>
__host__ __device__ constexpr int dq_tile_keys() {
  return DH > 192 ? 32 : HBN;
}

// Column parts of dK and dV that the dk/dv body computes one at a time:
// one (every column) up to dh 192; two at dh 256, columns 0-127 and
// 128-255, each two 64-column boxes of Q and dO.
template <int DH>
__host__ __device__ constexpr int dkv_col_parts() {
  return DH > 192 ? 2 : 1;
}

// Sweeps of the dk/dv body over its query tiles: one, with dK and dV side
// by side in registers (64 x DH fp32 each per warpgroup); more above dh
// 128, where the two would take 192 (dh 192) or 256 (dh 256) registers a
// thread before S, dP and the hi + lo fragments (at dh 128 the body reads
// 210-214 of the 255 a thread may hold). With as many sweeps as column
// parts (`dkv_col_parts`), sweep c keeps dV and dK of part c side by side;
// with twice as many, the first half of the sweeps computes dV alone,
// part by part, and the second dK: a sweep that computes dV alone skips
// dP^T. At dh 192, dV then dK: S^T = K Q^T twice, and Q and dO read twice.
// At dh 256, columns 0-127 of both, then 128-255 of both (64 x 128 fp32
// each per warpgroup, 64 registers: the register shape of the dh-128
// single sweep): S^T and dP^T over all 256 columns twice, Q and dO read
// twice. Each output element keeps its products and their order; only
// which sweep computes it changes.
template <int DH>
__host__ __device__ constexpr int dkv_sweeps() {
  return DH > 128 ? 2 : 1;
}

// Query rows per tile of the dk/dv body: 64 up to dh 80, where dK and dV
// take 64 or 80 registers a thread beside the tile's S^T, dP^T and hi + lo
// fragments (32 + 32 + 32); 32 above. At dh 80, hubert-xlarge's shape, 64
// rows read 232 registers and 1.16 ms, 32 rows 180 and 1.65 ms (no spill
// either way; chip_smoke.py --flash80-only, H100 80GB HBM3 at 700 W).
template <int DH>
__host__ __device__ constexpr int dkv_tile_queries() {
  return DH <= 80 ? 64 : 32;
}

template <int DH>
struct DkvSmemH {
  static constexpr int BOXES = head_boxes<DH>();
  static constexpr int BQ = dkv_tile_queries<DH>();   // query rows per tile
  static constexpr uint32_t KBOX = HB * ROW_BYTES;  // bytes of a box
  static constexpr uint32_t QBOX = BQ * ROW_BYTES;
  __nv_bfloat16 k[BOXES][HB][BOX_COLS];
  __nv_bfloat16 v[BOXES][HB][BOX_COLS];
  __nv_bfloat16 q[RING_STAGES][BOXES][BQ][BOX_COLS];
  __nv_bfloat16 dO[RING_STAGES][BOXES][BQ][BOX_COLS];
  float lse[2][2][BQ];    // [warpgroup][tile % 2][query]: lse * log2(e)
  float dsum[2][2][BQ];
  uint64_t kvbar;
  Ring ring;
};

template <int DH, typename P>
__device__ __forceinline__ void bwd_dkv_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, const P& pol, float scale) {
  using Sm = DkvSmemH<DH>;
  constexpr int BQ = Sm::BQ;
  constexpr int SWEEPS = dkv_sweeps<DH>();
  constexpr int PARTS = dkv_col_parts<DH>();
  static_assert(SWEEPS == PARTS || SWEEPS == 2 * PARTS, "dk/dv sweeps");
  // whether each sweep computes both dK and dV, of its column part; the
  // registers a thread holds of one accumulator (its warpgroup's 64 rows
  // by the part's 2 ACC columns)
  constexpr bool BOTH = SWEEPS == PARTS;
  constexpr int ACC = DH / 2 / PARTS;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int ntiles = pol.ntiles;
  // the walk: the query tiles once per sweep, tile j of it query tile
  // j % ntiles
  const int nwalk = SWEEPS * ntiles;
  constexpr uint32_t Q_BYTES = 2 * Sm::BOXES * Sm::QBOX;
  constexpr bool G = GathersRows<P>::value;
  auto tile_row = [&](int j) {
    return pol.q_first + (SWEEPS == 1 ? j : j % ntiles) * BQ;
  };

  auto load_q = [&](int j) {
    const int s = j % RING_STAGES;
    uint64_t* bar = sm.ring.produce(j, Q_BYTES);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.q[s][x][0][0], &tq, bar, x * BOX_COLS, tile_row(j),
                  pol.qplane);
      tma_load_3d(&sm.dO[s][x][0][0], &tdo, bar, x * BOX_COLS, tile_row(j),
                  pol.qplane);
    }
  };
  if constexpr (G) {
    if (ntiles > 0) {
      pol.gather_own(&sm.k[0][0][0], &sm.v[0][0][0]);
      pol.gather_tile(&sm.q[0][0][0][0], &sm.dO[0][0][0][0], pol.q_first);
      cp_async_commit();
    }
  } else {
    sm.ring.init(&sm.kvbar);
    // a block that no query sees loads nothing and writes zeros
    if (tid == 0 && ntiles > 0) {
      mbar_expect_tx(&sm.kvbar, 2 * Sm::BOXES * Sm::KBOX);
#pragma unroll
      for (int x = 0; x < Sm::BOXES; ++x) {
        tma_load_3d(&sm.k[x][0][0], &tk, &sm.kvbar, x * BOX_COLS, pol.k0,
                    pol.kplane);
        tma_load_3d(&sm.v[x][0][0], &tv, &sm.kvbar, x * BOX_COLS, pol.k0,
                    pol.kplane);
      }
      sm.ring.prime(nwalk, load_q);
    }
  }

  const int lane = t % 32;
  const int r = 64 * wg + 16 * (t / 32) + lane / 4;   // key rows r, r + 8
  const int cq = 2 * (lane % 4);
  const int key0 = pol.k0 + r, key1 = key0 + 8;
  const auto tag0 = pol.key_tag(key0), tag1 = pol.key_tag(key1);
  const float sl2 = scale * LOG2E;
  // dK and dV of the sweep's column part side by side (BOTH), or dV in
  // the first sweeps and then dK in the last, in the same registers
  float dva[ACC], dka[BOTH ? ACC : 1];
#pragma unroll
  for (int i = 0; i < ACC; ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (BOTH ? ACC : 1); ++i) dka[i] = 0.f;
  const void* ktile = &sm.k[0][64 * wg][0];
  const void* vtile = &sm.v[0][64 * wg][0];
  const size_t plane = static_cast<size_t>(pol.qplane) * pol.N;
  const size_t kplane = static_cast<size_t>(pol.qplane) * pol.M;
  // an accumulator's 64 x (2 ACC) block to its key rows of ``out``, at
  // column part ``part``
  auto store = [&](const float (&a)[ACC], float* out, int part) {
#pragma unroll
    for (int c = 0; c < ACC / 4; ++c) {
      const int col = part * (DH / PARTS) + 8 * c + cq;
      if (key0 < pol.M)
        *reinterpret_cast<float2*>(out + (kplane + key0) * DH + col) =
            make_float2(a[4 * c], a[4 * c + 1]);
      if (key1 < pol.M)
        *reinterpret_cast<float2*>(out + (kplane + key1) * DH + col) =
            make_float2(a[4 * c + 2], a[4 * c + 3]);
    }
  };
  // the accumulators of sweep ``sw`` to their rows and columns
  auto store_sweep = [&](int sw) {
    if constexpr (BOTH) {
      store(dka, dk, sw);
      store(dva, dv, sw);
    } else {
      store(dva, sw < PARTS ? dv : dk, sw % PARTS);
    }
  };

  if constexpr (!G) {
    if (ntiles > 0) mbar_wait(&sm.kvbar, 0);
  }
  for (int j = 0; j < nwalk; ++j) {
    const int s = j % RING_STAGES, buf = j % 2;
    const int q0 = tile_row(j);
    // this sweep, and whether it computes dV alone
    const int sw = SWEEPS == 1 ? 0 : j / ntiles;
    const bool dv_sweep = !BOTH && sw < PARTS;
    if (SWEEPS > 1 && j > 0 && j % ntiles == 0) {
      store_sweep(sw - 1);
#pragma unroll
      for (int i = 0; i < ACC; ++i) dva[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (BOTH ? ACC : 1); ++i) dka[i] = 0.f;
    }
    // this tile's lse and D, staged per warpgroup, double-buffered behind a
    // named barrier: TMA cannot load them (a plane's fp32 row need not be
    // 16-byte aligned), and with each thread reading its 2 * BQ / 4 values
    // straight from global memory, as the dq body reads its rows' once,
    // flash dk/dv took 0.947 ms, not 0.593, at qwen2's shape
    // (chip_smoke.py, H100 80GB HBM3 at 700 W)
    if (t < BQ) {
      const bool in = q0 + t < pol.N;
      sm.lse[wg][buf][t] = in ? lse[plane + q0 + t] * LOG2E : 0.f;
      sm.dsum[wg][buf][t] = in ? dsum[plane + q0 + t] : 0.f;
      pol.stage(wg, buf, t, q0 + t);
    }
    wg_sync(1 + wg);
    if constexpr (G) {
      gathered_tile_ready();
      if (j + 1 < nwalk) {
        pol.gather_tile(&sm.q[(j + 1) % RING_STAGES][0][0][0],
                        &sm.dO[(j + 1) % RING_STAGES][0][0][0],
                        tile_row(j + 1));
        cp_async_commit();
      }
    } else {
      sm.ring.wait(j);
    }
    const void* qt = &sm.q[s][0][0][0];
    const void* dot = &sm.dO[s][0][0][0];
    // the B operands of dV's and dK's products: at dh 256 this sweep's
    // column part of dO and Q, its two 64-column boxes
    const void* doc = dot;
    const void* qc = qt;
    if constexpr (PARTS > 1) {
      const uint32_t off = (sw % PARTS) * (Sm::BOXES / PARTS) * Sm::QBOX;
      doc = static_cast<const char*>(dot) + off;
      qc = static_cast<const char*>(qt) + off;
    }
    // above dh 128 the owned tiles' addresses are taken anew in each tile,
    // so that the compiler computes their 24 (dh 192) or 32 (dh 256)
    // k16-slice descriptors where the products read them instead of
    // holding them (48 or 64 registers) across the walk beside the
    // accumulators
    uint64_t kaddr = reinterpret_cast<uint64_t>(ktile);
    uint64_t vaddr = reinterpret_cast<uint64_t>(vtile);
    if constexpr (SWEEPS > 1) {
      asm volatile("" : "+l"(kaddr));
      asm volatile("" : "+l"(vaddr));
    }
    const void* kt = reinterpret_cast<const void*>(kaddr);
    const void* vt = reinterpret_cast<const void*>(vaddr);
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(st, desc_k(kt, kk, Sm::KBOX), desc_k(qt, kk, Sm::QBOX),
               kk > 0);
    wgmma_commit();
    if (!dv_sweep) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss(dpt, desc_k(vt, kk, Sm::KBOX), desc_k(dot, kk, Sm::QBOX),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // S^T is in; dP^T may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(st);

    // P^T, zero where masked: only a tile the policy marks for this
    // warpgroup (one that crosses the mask's edge or the queries' end)
    const bool edge = pol.edge(wg, buf, q0, BQ);
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * c + cq + e;
        const float l = sm.lse[wg][buf][cl];
        float p0 = exp2f(fmaf(st[4 * c + e], sl2, -l));
        float p1 = exp2f(fmaf(st[4 * c + 2 + e], sl2, -l));
        if (edge) {
          const int col = q0 + cl;
          if (pol.drop(wg, buf, cl, col, tag0)) p0 = 0.f;
          if (pol.drop(wg, buf, cl, col, tag1)) p1 = 0.f;
        }
        st[4 * c + e] = p0;
        st[4 * c + 2 + e] = p1;
      }
    uint32_t ahi[BQ / 16][4], alo[BQ / 16][4];
    if (BOTH || dv_sweep) {
      pack_a_split(st, ahi, alo);
      fence_regs(dva);
      fence_regs(ahi);
      fence_regs(alo);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        wgmma_rs(dva, ahi[c], desc_mn(doc, c, Sm::QBOX), 1);
        wgmma_rs(dva, alo[c], desc_mn(doc, c, Sm::QBOX), 1);
      }
      wgmma_commit();
    }
    if (!dv_sweep) {
      if (BOTH) {
        wgmma_wait<1>();   // dP^T is in; dV += P^T dO may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dpt);
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = sm.dsum[wg][buf][8 * c + cq + e];
          dpt[4 * c + e] = st[4 * c + e] * (dpt[4 * c + e] - d) * scale;
          dpt[4 * c + 2 + e] =
              st[4 * c + 2 + e] * (dpt[4 * c + 2 + e] - d) * scale;
        }
    }
    wgmma_wait<0>();   // the P fragments are free again
    fence_regs(dva);
    fence_regs(ahi);
    fence_regs(alo);
    // dK += dS^T Q: into dka beside dva, or (dh 192) into dva, whose dV
    // the first sweep stored
    auto dk_update = [&](float (&acc)[ACC]) {
      pack_a_split(dpt, ahi, alo);
      fence_regs(acc);
      fence_regs(ahi);
      fence_regs(alo);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        wgmma_rs(acc, ahi[c], desc_mn(qc, c, Sm::QBOX), 1);
        wgmma_rs(acc, alo[c], desc_mn(qc, c, Sm::QBOX), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ahi);
      fence_regs(alo);
    };
    if constexpr (BOTH) {
      dk_update(dka);
    } else {
      if (!dv_sweep) dk_update(dva);
    }
    // stage s is free once both warpgroups are done with it
    if constexpr (!G) sm.ring.advance(j, nwalk, load_q);
  }

  // the last sweep's; a block that walks nothing stores every sweep's
  // zeros here
  if (SWEEPS > 1 && ntiles == 0) {
#pragma unroll
    for (int sw = 0; sw < SWEEPS - 1; ++sw) store_sweep(sw);
  }
  store_sweep(SWEEPS - 1);
}

template <int DH>
struct DqSmemH {
  static constexpr int BOXES = head_boxes<DH>();
  static constexpr int KT = dq_tile_keys<DH>();     // key rows per tile
  static constexpr uint32_t QBOX = HB * ROW_BYTES;  // bytes of a box
  static constexpr uint32_t KBOX = KT * ROW_BYTES;
  __nv_bfloat16 q[BOXES][HB][BOX_COLS];
  __nv_bfloat16 dO[BOXES][HB][BOX_COLS];
  __nv_bfloat16 k[RING_STAGES][BOXES][KT][BOX_COLS];
  __nv_bfloat16 v[RING_STAGES][BOXES][KT][BOX_COLS];
  uint64_t qbar;
  Ring ring;
};

template <int DH, typename P>
__device__ __forceinline__ void bwd_dq_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq, const P& pol,
    float scale) {
  using Sm = DqSmemH<DH>;
  constexpr int KT = Sm::KT;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int ntiles = pol.ntiles;
  constexpr uint32_t KV_BYTES = 2 * Sm::BOXES * Sm::KBOX;
  constexpr bool G = GathersRows<P>::value;

  auto load_kv = [&](int j) {
    const int s = j % RING_STAGES;
    uint64_t* bar = sm.ring.produce(j, KV_BYTES);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.k[s][x][0][0], &tk, bar, x * BOX_COLS,
                  pol.k_first + j * KT, pol.kplane);
      tma_load_3d(&sm.v[s][x][0][0], &tv, bar, x * BOX_COLS,
                  pol.k_first + j * KT, pol.kplane);
    }
  };
  if constexpr (G) {
    // a block whose rows see no key loads nothing and writes zeros
    if (ntiles > 0) {
      pol.gather_own(&sm.q[0][0][0], &sm.dO[0][0][0]);
      pol.gather_tile(&sm.k[0][0][0][0], &sm.v[0][0][0][0], pol.k_first);
      cp_async_commit();
    }
  } else {
    sm.ring.init(&sm.qbar);
    if (tid == 0) {
      mbar_expect_tx(&sm.qbar, 2 * Sm::BOXES * Sm::QBOX);
#pragma unroll
      for (int x = 0; x < Sm::BOXES; ++x) {
        tma_load_3d(&sm.q[x][0][0], &tq, &sm.qbar, x * BOX_COLS, pol.q0,
                    pol.qplane);
        tma_load_3d(&sm.dO[x][0][0], &tdo, &sm.qbar, x * BOX_COLS, pol.q0,
                    pol.qplane);
      }
      sm.ring.prime(ntiles, load_kv);
    }
  }

  const int lane = t % 32;
  const int r = 64 * wg + 16 * (t / 32) + lane / 4;   // query rows r, r + 8
  const int cq = 2 * (lane % 4);
  const int row0 = pol.q0 + r, row1 = row0 + 8;
  const int N = pol.N;
  const size_t plane = static_cast<size_t>(pol.qplane) * N;
  const float sl2 = scale * LOG2E;
  const float l0 = row0 < N ? lse[plane + row0] * LOG2E : 0.f;
  const float l1 = row1 < N ? lse[plane + row1] * LOG2E : 0.f;
  const float d0 = row0 < N ? dsum[plane + row0] : 0.f;
  const float d1 = row1 < N ? dsum[plane + row1] : 0.f;
  const auto tag0 = pol.row_tag(row0), tag1 = pol.row_tag(row1);
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  const void* qtile = &sm.q[0][64 * wg][0];
  const void* dotile = &sm.dO[0][64 * wg][0];

  if constexpr (!G) mbar_wait(&sm.qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % RING_STAGES, buf = j % 2;
    const int k0 = pol.k_first + j * KT;
    if constexpr (P::kTileTags) {
      if (t < KT) pol.stage(wg, buf, t, k0 + t);
      wg_sync(1 + wg);
    }
    if constexpr (G) {
      gathered_tile_ready();
      if (j + 1 < ntiles) {
        pol.gather_tile(&sm.k[(j + 1) % RING_STAGES][0][0][0],
                        &sm.v[(j + 1) % RING_STAGES][0][0][0], k0 + KT);
        cp_async_commit();
      }
    } else {
      sm.ring.wait(j);
    }
    const void* kt = &sm.k[s][0][0][0];
    const void* vt = &sm.v[s][0][0][0];
    // at dh 256, as in the dk/dv body above dh 128, the owned tiles'
    // addresses are taken anew in each tile, so that the compiler need not
    // hold their 32 k16-slice descriptors (64 registers) across the walk
    // beside the 128 of the accumulator
    uint64_t qaddr = reinterpret_cast<uint64_t>(qtile);
    uint64_t doaddr = reinterpret_cast<uint64_t>(dotile);
    if constexpr (DH > 192) {
      asm volatile("" : "+l"(qaddr));
      asm volatile("" : "+l"(doaddr));
    }
    const void* qo = reinterpret_cast<const void*>(qaddr);
    const void* doo = reinterpret_cast<const void*>(doaddr);
    float sc[KT / 2], dp[KT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, desc_k(qo, kk, Sm::QBOX), desc_k(kt, kk, Sm::KBOX),
               kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(dp, desc_k(doo, kk, Sm::QBOX), desc_k(vt, kk, Sm::KBOX),
               kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S is in; dP may still run
    fence_regs(sc);

    // P, zero where masked: only a tile the policy marks for this
    // warpgroup (one that crosses the mask's edge or the keys' end)
    const bool edge = pol.edge(wg, buf, k0, KT);
#pragma unroll
    for (int c = 0; c < KT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(fmaf(sc[4 * c + e], sl2, -l0));
        float p1 = exp2f(fmaf(sc[4 * c + 2 + e], sl2, -l1));
        if (edge) {
          const int cl = 8 * c + cq + e;
          if (pol.drop(wg, buf, cl, k0 + cl, tag0)) p0 = 0.f;
          if (pol.drop(wg, buf, cl, k0 + cl, tag1)) p1 = 0.f;
        }
        sc[4 * c + e] = p0;
        sc[4 * c + 2 + e] = p1;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < KT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * c + e] = sc[4 * c + e] * (dp[4 * c + e] - d0) * scale;
        dp[4 * c + 2 + e] = sc[4 * c + 2 + e] * (dp[4 * c + 2 + e] - d1) *
                            scale;
      }
    uint32_t ahi[KT / 16][4], alo[KT / 16][4];
    pack_a_split(dp, ahi, alo);
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KT / 16; ++c) {
      wgmma_rs(acc, ahi[c], desc_mn(kt, c, Sm::KBOX), 1);
      wgmma_rs(acc, alo[c], desc_mn(kt, c, Sm::KBOX), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);
    // stage s is free once both warpgroups are done with it
    if constexpr (!G) sm.ring.advance(j, ntiles, load_kv);
  }

#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + cq;
    if (row0 < N)
      *reinterpret_cast<float2*>(dq + (plane + row0) * DH + col) =
          make_float2(acc[4 * c], acc[4 * c + 1]);
    if (row1 < N)
      *reinterpret_cast<float2*>(dq + (plane + row1) * DH + col) =
          make_float2(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

}  // namespace sm90
