// Dense (full) flash attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// src/repro/kernels/flash_attention.py (:90 / :123, their `pallas_call`s
// :225 / :249; the backward of `flash_attention`). Both recompute p from
// the forward's lse and mask it explicitly:
//   p  = keep ? exp(q.k * scale - lse) : 0
//   ds = p * (do.v - D) * scale,  D = rowsum(do * out) (computed outside)
//   dq = ds . K,   dk = ds^T . Q,   dv = p^T . dO
// with keep the forward's mask (csrc/flash_attention.cu): every key, or
// key row j <= query row i when causal, on row indices also when M != N.
// Causal tiles wholly above the diagonal are skipped, not masked. dk and
// dv come out per *query* head, fp32; the wrapper sums each kv head's
// query group (GQA), as the JAX package does in XLA. dq is fp32.
//
// What bounds it on this card: the dq kernel needs 6*dh flops per
// attended pair and the dk/dv kernel 8*dh; at qwen2's train shape
// (B 2, H 14, Hkv 2, N 4096, dh 64, causal) that is ~90 and ~120 GFLOP
// against ~65 and ~95 MB read or written once: far above the bf16 ridge,
// so the tensor cores bound an ideal kernel (~0.09 / ~0.12 ms).
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64 and 128): `flash_bwd_dkv_wgmma` and `flash_bwd_dq_wgmma`, on
// the tensor cores (sm90.cuh). A block of 256 threads owns 128 rows, 64
// per warpgroup, loaded once by TMA, and walks tiles of the other side
// through a ring of two stages (`sm90::Ring`) from 3-D tensor maps (dh,
// rows, batch * heads: rows past a plane's end arrive as zeros).
// - dk/dv: the block owns 128 key rows (K, V) and walks query tiles of BQ
//   rows (Q, dO; BQ 64 at dh 64, 32 at dh 128 so that dK and dV, 64 x dh
//   fp32 each per warpgroup, leave room for the tile's products), from the
//   tile of its first key row (causal) or from 0. Per tile: S^T = K Q^T and
//   dP^T = V dO^T (SS, K-major), P^T = exp(S^T scale - lse) on the
//   accumulators, dV += P^T dO (RS, dO MN-major), dS^T = P^T (dP^T - D)
//   scale, dK += dS^T Q (RS, Q MN-major).
// - dq: the block owns 128 query rows (Q, dO, their lse and D) and walks
//   key tiles of 64 rows (K, V) up to its last query row (causal) or to M,
//   the heaviest blocks (the last, under causality) first. Per tile: S = Q
//   K^T and dP = dO V^T (SS), P, dS, dQ += dS K (RS, K MN-major).
// P and dS are products' A operands. Rounded to one bf16 value each, they
// put dq, dk and dv 1.4-2.6e-3 of their largest value from the fp32
// result at qwen2's shape (tests/test_torch_flash_bwd_split.py), over the
// 1e-3 chip_smoke.py holds them to. So each is split into two bf16
// fragments, hi = bf16(x) and lo = bf16(x - hi) (`sm90::pack_a_split`),
// and each of those products runs twice into one fp32 accumulator. The
// cost: 6 products a tile where 4 would do (dk/dv) and 4 where 3 would
// (dq), all at the bf16 rate. The split alone leaves ~4e-6 (fp32 sums);
// on the card the tensor cores' own fp32 accumulation adds the rest of
// the ~2e-5 chip_smoke.py reads against an fp64 reference.
// Only tiles that cross the diagonal or the ragged end are masked.
//
// fp32: `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, fp32 FMAs from
// shared memory with the tiles `DqTile` and `DkvTile` (attn_bwd.cuh),
// shared with the local-window and fused routing backward kernels: blocks
// of 64 query (key) rows walk key (query) tiles of 32 rows. They keep full
// fp32 products, as PyTorch's fp32 matmul does (no TF32).
#include "attn_bwd.cuh"
#include "sm90.cuh"

namespace {

using namespace rt;

template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, int H, int Hkv, int N, int M, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const size_t plane = static_cast<size_t>(bh) * N;
  const float* kb = k + kvh * M * DH;
  const float* vb = v + kvh * M * DH;

  auto qrows = [&](const float* base) {
    return [=](int r) -> const float* {
      return r < qn ? base + (plane + q0 + r) * DH : nullptr;
    };
  };
  load_rows<float, DH, BQ, DH + 1>(&sm.q[0][0], qrows(q));
  load_rows<float, DH, BQ, DH + 1>(&sm.dO[0][0], qrows(dO));
  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    sm.lse[r] = r < qn ? lse[plane + q0 + r] : 0.f;
    sm.dsum[r] = r < qn ? dsum[plane + q0 + r] : 0.f;
  }
  const int kend = causal ? min(M, q0 + qn) : M;

  DqTile<DH> t;
  t.init();
  for (int k0 = 0; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    auto krow = [&](const float* base) {
      return [=](int r) -> const float* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<float, DH, BK, DH + 1>(&sm.v[0][0], krow(vb));
    __syncthreads();
    t.consume(sm, nk, scale, [&](int row, int col) {
      return !causal || k0 + col <= q0 + row;
    });
  }
  t.store([&](int row) -> float* {
    return row < qn ? dq + (plane + q0 + row) * DH : nullptr;
  });
}

template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int N,
    int M, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int k0 = blockIdx.x * BKR;
  const int kn = min(BKR, M - k0);
  const size_t plane = static_cast<size_t>(bh) * N;

  auto krow = [&](const float* base) {
    return [=](int r) -> const float* {
      return r < kn ? base + (kvh * M + k0 + r) * DH : nullptr;
    };
  };
  load_rows<float, DH, BKR, DH + 1>(&sm.k[0][0], krow(k));
  load_rows<float, DH, BKR, DH + 1>(&sm.v[0][0], krow(v));
  // causal: no query before the block's first key row
  const int qs = causal ? k0 : 0;

  DkvTile<DH> t;
  t.init();
  for (int q0 = qs; q0 < N; q0 += BQT) {
    const int nq = min(BQT, N - q0);
    if (threadIdx.x < BQT) {
      const int r = threadIdx.x;
      sm.lse[r] = r < nq ? lse[plane + q0 + r] : 0.f;
      sm.dsum[r] = r < nq ? dsum[plane + q0 + r] : 0.f;
    }
    auto qrows = [&](const float* base) {
      return [=](int r) -> const float* {
        return r < nq ? base + (plane + q0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BQT, DH + 1>(&sm.q[0][0], qrows(q));
    load_rows<float, DH, BQT, DH + 1>(&sm.dO[0][0], qrows(dO));
    __syncthreads();
    t.consume(sm, nq, scale, [&](int row, int col) {
      return row < kn && (!causal || k0 + row <= q0 + col);
    });
  }
  const size_t kplane = static_cast<size_t>(bh) * M;
  t.store(
      [&](int row) -> float* {
        return row < kn ? dk + (kplane + k0 + row) * DH : nullptr;
      },
      [&](int row) -> float* {
        return row < kn ? dv + (kplane + k0 + row) * DH : nullptr;
      });
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* dsum, float* dq, int B, int H,
              int Hkv, int N, int M, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, dsum,
      dq, H, Hkv, N, M, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* dsum, float* dk, float* dv,
               int B, int H, int Hkv, int N, int M, int causal,
               cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BKR - 1) / BKR, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, dsum,
      dk, dv, H, Hkv, N, M, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int HB = 128;        // rows a block owns: two warpgroups of 64
constexpr int HBN = 64;        // key rows per dq tile
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct DkvSmemH {
  static constexpr int BOXES = DH / sm90::BOX_COLS;
  static constexpr int BQ = DH == 64 ? 64 : 32;   // query rows per tile
  static constexpr uint32_t KBOX = HB * sm90::ROW_BYTES;  // bytes of a box
  static constexpr uint32_t QBOX = BQ * sm90::ROW_BYTES;
  __nv_bfloat16 k[BOXES][HB][sm90::BOX_COLS];
  __nv_bfloat16 v[BOXES][HB][sm90::BOX_COLS];
  __nv_bfloat16 q[sm90::RING_STAGES][BOXES][BQ][sm90::BOX_COLS];
  __nv_bfloat16 dO[sm90::RING_STAGES][BOXES][BQ][sm90::BOX_COLS];
  float lse[2][2][BQ];    // [warpgroup][tile % 2][query]: lse * log2(e)
  float dsum[2][2][BQ];
  uint64_t kvbar;
  sm90::Ring ring;
};

template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int H, int Hkv, int N, int M, int causal,
                        float scale) {
  using namespace sm90;
  using Sm = DkvSmemH<DH>;
  constexpr int BQ = Sm::BQ;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int k0 = blockIdx.x * HB;
  // causal: no query row before the block's first key row
  const int qs = causal ? k0 : 0;
  const int ntiles = qs < N ? (N - qs + BQ - 1) / BQ : 0;
  constexpr uint32_t Q_BYTES = 2 * Sm::BOXES * Sm::QBOX;

  auto load_q = [&](int j) {
    const int s = j % RING_STAGES;
    uint64_t* bar = sm.ring.produce(j, Q_BYTES);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.q[s][x][0][0], &tq, bar, x * BOX_COLS, qs + j * BQ,
                  bh);
      tma_load_3d(&sm.dO[s][x][0][0], &tdo, bar, x * BOX_COLS, qs + j * BQ,
                  bh);
    }
  };
  sm.ring.init(&sm.kvbar);
  // a block that no query sees loads nothing and writes zeros
  if (tid == 0 && ntiles > 0) {
    mbar_expect_tx(&sm.kvbar, 2 * Sm::BOXES * Sm::KBOX);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.k[x][0][0], &tk, &sm.kvbar, x * BOX_COLS, k0, kvh);
      tma_load_3d(&sm.v[x][0][0], &tv, &sm.kvbar, x * BOX_COLS, k0, kvh);
    }
    sm.ring.prime(ntiles, load_q);
  }

  const int lane = t % 32;
  const int r = 64 * wg + 16 * (t / 32) + lane / 4;   // key rows r, r + 8
  const int cq = 2 * (lane % 4);
  const int key0 = k0 + r, key1 = key0 + 8;
  const float sl2 = scale * LOG2E;
  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  const void* ktile = &sm.k[0][64 * wg][0];
  const void* vtile = &sm.v[0][64 * wg][0];
  const size_t plane = static_cast<size_t>(bh) * N;

  if (ntiles > 0) mbar_wait(&sm.kvbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % RING_STAGES, buf = j % 2;
    const int q0 = qs + j * BQ;
    // this tile's lse and D, staged per warpgroup, double-buffered behind a
    // named barrier: TMA cannot load them (a plane's fp32 row need not be
    // 16-byte aligned), and with each thread reading its 2 * BQ / 4 values
    // straight from global memory, as the dq kernel reads its rows' once,
    // dk/dv took 0.947 ms, not 0.593, at qwen2's shape (chip_smoke.py,
    // H100 80GB HBM3 at 700 W)
    if (t < BQ) {
      const bool in = q0 + t < N;
      sm.lse[wg][buf][t] = in ? lse[plane + q0 + t] * LOG2E : 0.f;
      sm.dsum[wg][buf][t] = in ? dsum[plane + q0 + t] : 0.f;
    }
    wg_sync(1 + wg);
    sm.ring.wait(j);
    const void* qt = &sm.q[s][0][0][0];
    const void* dot = &sm.dO[s][0][0][0];
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(st, desc_k(ktile, kk, Sm::KBOX), desc_k(qt, kk, Sm::QBOX),
               kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(dpt, desc_k(vtile, kk, Sm::KBOX), desc_k(dot, kk, Sm::QBOX),
               kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S^T is in; dP^T may still run
    fence_regs(st);

    // P^T, zero where masked: only a tile that crosses the diagonal of
    // this warpgroup's key rows or the queries' ragged end
    const bool edge = q0 + BQ > N || (causal && k0 + 64 * wg + 63 > q0);
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
          if (col >= N || (causal && col < key0)) p0 = 0.f;
          if (col >= N || (causal && col < key1)) p1 = 0.f;
        }
        st[4 * c + e] = p0;
        st[4 * c + 2 + e] = p1;
      }
    uint32_t ahi[BQ / 16][4], alo[BQ / 16][4];
    pack_a_split(st, ahi, alo);
    fence_regs(dva);
    fence_regs(ahi);
    fence_regs(alo);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      wgmma_rs(dva, ahi[c], desc_mn(dot, c, Sm::QBOX), 1);
      wgmma_rs(dva, alo[c], desc_mn(dot, c, Sm::QBOX), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();   // dP^T is in; dV += P^T dO may still run
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
    wgmma_wait<0>();   // the P fragments are free again
    fence_regs(dva);
    fence_regs(ahi);
    fence_regs(alo);
    pack_a_split(dpt, ahi, alo);
    fence_regs(dka);
    fence_regs(ahi);
    fence_regs(alo);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      wgmma_rs(dka, ahi[c], desc_mn(qt, c, Sm::QBOX), 1);
      wgmma_rs(dka, alo[c], desc_mn(qt, c, Sm::QBOX), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(ahi);
    fence_regs(alo);
    // stage s is free once both warpgroups are done with it
    sm.ring.advance(j, ntiles, load_q);
  }

  const size_t kplane = static_cast<size_t>(bh) * M;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + cq;
    if (key0 < M) {
      const size_t at = (kplane + key0) * DH + col;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(dka[4 * c], dka[4 * c + 1]);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(dva[4 * c], dva[4 * c + 1]);
    }
    if (key1 < M) {
      const size_t at = (kplane + key1) * DH + col;
      *reinterpret_cast<float2*>(dk + at) =
          make_float2(dka[4 * c + 2], dka[4 * c + 3]);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(dva[4 * c + 2], dva[4 * c + 3]);
    }
  }
}

template <int DH>
struct DqSmemH {
  static constexpr int BOXES = DH / sm90::BOX_COLS;
  static constexpr uint32_t QBOX = HB * sm90::ROW_BYTES;  // bytes of a box
  static constexpr uint32_t KBOX = HBN * sm90::ROW_BYTES;
  __nv_bfloat16 q[BOXES][HB][sm90::BOX_COLS];
  __nv_bfloat16 dO[BOXES][HB][sm90::BOX_COLS];
  __nv_bfloat16 k[sm90::RING_STAGES][BOXES][HBN][sm90::BOX_COLS];
  __nv_bfloat16 v[sm90::RING_STAGES][BOXES][HBN][sm90::BOX_COLS];
  uint64_t qbar;
  sm90::Ring ring;
};

template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       float* __restrict__ dq, int H, int Hkv, int N, int M,
                       int causal, float scale) {
  using namespace sm90;
  using Sm = DqSmemH<DH>;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * HB;
  const int qn = min(HB, N - q0);
  // causal: no key past the block's last query row
  const int kend = causal ? min(M, q0 + qn) : M;
  const int ntiles = (kend + HBN - 1) / HBN;
  constexpr uint32_t KV_BYTES = 2 * Sm::BOXES * Sm::KBOX;

  auto load_kv = [&](int j) {
    const int s = j % RING_STAGES;
    uint64_t* bar = sm.ring.produce(j, KV_BYTES);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.k[s][x][0][0], &tk, bar, x * BOX_COLS, j * HBN, kvh);
      tma_load_3d(&sm.v[s][x][0][0], &tv, bar, x * BOX_COLS, j * HBN, kvh);
    }
  };
  sm.ring.init(&sm.qbar);
  if (tid == 0) {
    mbar_expect_tx(&sm.qbar, 2 * Sm::BOXES * Sm::QBOX);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.q[x][0][0], &tq, &sm.qbar, x * BOX_COLS, q0, bh);
      tma_load_3d(&sm.dO[x][0][0], &tdo, &sm.qbar, x * BOX_COLS, q0, bh);
    }
    sm.ring.prime(ntiles, load_kv);
  }

  const int lane = t % 32;
  const int r = 64 * wg + 16 * (t / 32) + lane / 4;   // query rows r, r + 8
  const int cq = 2 * (lane % 4);
  const int row0 = q0 + r, row1 = row0 + 8;
  const size_t plane = static_cast<size_t>(bh) * N;
  const float sl2 = scale * LOG2E;
  const float l0 = row0 < N ? lse[plane + row0] * LOG2E : 0.f;
  const float l1 = row1 < N ? lse[plane + row1] * LOG2E : 0.f;
  const float d0 = row0 < N ? dsum[plane + row0] : 0.f;
  const float d1 = row1 < N ? dsum[plane + row1] : 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  const void* qtile = &sm.q[0][64 * wg][0];
  const void* dotile = &sm.dO[0][64 * wg][0];

  mbar_wait(&sm.qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % RING_STAGES;
    sm.ring.wait(j);
    const void* kt = &sm.k[s][0][0][0];
    const void* vt = &sm.v[s][0][0][0];
    float sc[HBN / 2], dp[HBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, desc_k(qtile, kk, Sm::QBOX), desc_k(kt, kk, Sm::KBOX),
               kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(dp, desc_k(dotile, kk, Sm::QBOX), desc_k(vt, kk, Sm::KBOX),
               kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S is in; dP may still run
    fence_regs(sc);

    // P, zero where masked: only a tile that crosses the diagonal of this
    // warpgroup's query rows or the keys' ragged end
    const int k0 = j * HBN;
    const bool edge = k0 + HBN > M || (causal && k0 + HBN - 1 > q0 + 64 * wg);
#pragma unroll
    for (int c = 0; c < HBN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2f(fmaf(sc[4 * c + e], sl2, -l0));
        float p1 = exp2f(fmaf(sc[4 * c + 2 + e], sl2, -l1));
        if (edge) {
          const int col = k0 + 8 * c + cq + e;
          if (col >= M || (causal && col > row0)) p0 = 0.f;
          if (col >= M || (causal && col > row1)) p1 = 0.f;
        }
        sc[4 * c + e] = p0;
        sc[4 * c + 2 + e] = p1;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < HBN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * c + e] = sc[4 * c + e] * (dp[4 * c + e] - d0) * scale;
        dp[4 * c + 2 + e] = sc[4 * c + 2 + e] * (dp[4 * c + 2 + e] - d1) *
                            scale;
      }
    uint32_t ahi[HBN / 16][4], alo[HBN / 16][4];
    pack_a_split(dp, ahi, alo);
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < HBN / 16; ++c) {
      wgmma_rs(acc, ahi[c], desc_mn(kt, c, Sm::KBOX), 1);
      wgmma_rs(acc, alo[c], desc_mn(kt, c, Sm::KBOX), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);
    // stage s is free once both warpgroups are done with it
    sm.ring.advance(j, ntiles, load_kv);
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

// The four bf16 tensor maps of a backward call: q and do in boxes of
// ``qrows`` rows, k and v of ``krows``.
template <int DH>
int map_bwd(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
            const void* dO, int B, int H, int Hkv, int N, int M, int qrows,
            int krows) {
  using sm90::map_rows;
  int err = map_rows(&m[0], q, B * H, N, DH, qrows);
  if (err == cudaSuccess) err = map_rows(&m[1], k, B * Hkv, M, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[2], v, B * Hkv, M, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[3], dO, B * H, N, DH, qrows);
  return err;
}

template <int DH>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* dsum,
                   float* dq, int B, int H, int Hkv, int N, int M,
                   int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, B, H, Hkv, N, M, HB, HBN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<DqSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + HB - 1) / HB, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, dq, H, Hkv, N, M, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <int DH>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* dsum,
                    float* dk, float* dv, int B, int H, int Hkv, int N,
                    int M, int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, B, H, Hkv, N, M, DkvSmemH<DH>::BQ,
                        HB);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<DkvSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + HB - 1) / HB, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, dk, dv, H, Hkv, N, M, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q/do (B,H,N,dh), k/v (B,Hkv,M,dh), lse/dsum (B,H,N) fp32; dq (B,H,N,dh)
// fp32. dtype: 0 fp32, 1 bf16. Returns a cudaError_t code.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const float* lse, const float* dsum,
                                      float* dq, int B, int H, int Hkv, int N,
                                      int M, int dh, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dq_bf16<128>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M,
                               causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dq_bf16<64>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M,
                              causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dq<128>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M, causal,
                          s);
  if (dtype == 0 && dh == 64)
    return launch_dq<64>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M, causal,
                         s);
  return cudaErrorInvalidValue;
}

// As above; dk/dv (B,H,M,dh) fp32 per query head.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const float* lse, const float* dsum,
                                       float* dk, float* dv, int B, int H,
                                       int Hkv, int N, int M, int dh,
                                       int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dkv_bf16<128>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N,
                                M, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dkv_bf16<64>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N,
                               M, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dkv<128>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N, M,
                           causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dkv<64>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N, M,
                          causal, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the dq (dkv = 0) or dk/dv
// (dkv = 1) backward kernels (the local, fused routing and flash backward
// kernels share DqSmem and DkvSmem), for reports; -1 for an unsupported
// dh.
extern "C" int backward_tile_smem_bytes(int dh, int dkv) {
  if (dh == 128)
    return static_cast<int>(dkv ? sizeof(DkvSmem<128>) : sizeof(DqSmem<128>));
  if (dh == 64)
    return static_cast<int>(dkv ? sizeof(DkvSmem<64>) : sizeof(DqSmem<64>));
  return -1;
}

// Dynamic shared memory of one block of the bf16 flash dq (dkv = 0) or
// dk/dv (dkv = 1) kernel on the tensor cores (resident tiles, two ring
// stages, barriers, alignment room), for reports; -1 for an unsupported dh.
extern "C" int flash_bwd_wgmma_smem_bytes(int dh, int dkv) {
  using sm90::aligned_smem_bytes;
  if (dh == 128)
    return static_cast<int>(dkv ? aligned_smem_bytes<DkvSmemH<128>>()
                                : aligned_smem_bytes<DqSmemH<128>>());
  if (dh == 64)
    return static_cast<int>(dkv ? aligned_smem_bytes<DkvSmemH<64>>()
                                : aligned_smem_bytes<DqSmemH<64>>());
  return -1;
}
