// Fused gather-free routed attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_f_dq_kernel` / `_f_dkv_kernel` (VMEM-resident
// plan; :372 / :411, their `pallas_call`s :544 / :569) and `_p_dq_kernel`
// / `_p_dkv_kernel` (DMA-paged plan; :713 / :767, :899 / :926) of
// src/repro/kernels/routing_attention.py (backward of
// `routed_attention_fused`). As in the forward (csrc/routing_fused.cu),
// each block reads its own member indices and pulls member rows of q, k, v
// straight from the sequence-layout (B*H, N, dh) planes; the mask is on
// original positions (pos_q >= pos_k when causal; a padded key carries
// pos = SENTINEL = 2^30). p is recomputed from the forward's lse; do, lse
// and D are per-cluster (B*H, k, w[, dh]); dq, dk, dv come out as
// per-cluster fp32 blocks (B*H, k, w, dh). Shared-QK passes the q plane as
// k; the caller then adds the scattered dk to q's gradient. The
// scatter-add of these blocks to sequence layout (a token sits in up to k
// clusters) stays in PyTorch (`core.routing.scatter_add_rows`, in a fixed
// order), as the JAX package leaves it to XLA.
//
// What bounds it on this card: each cluster is a (w x w) problem whose
// causal half is needed, 6*dh (dq) or 8*dh (dk/dv) flops per pair against
// each member row read once and fp32 per-cluster gradients written: ~75
// flops per byte at w = 256, under the bf16 ridge (~295), so device memory
// bounds an ideal kernel.
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64, 128 and 192; the dh-192 instance serves any head dim over
// 128, zero-padded by the wrapper, with the true head dim's scale, which
// every instance takes from the caller; its dk/dv body runs two sweeps,
// attn_bwd_sm90.cuh `dkv_sweeps`): `routing_fused_dkv_wgmma` and
// `routing_fused_dq_wgmma`, on the tensor cores with the backward bodies
// the flash, local and gathered backwards run (attn_bwd_sm90.cuh: 128
// owned rows a block, the other side walked in tiles, S and dP by wgmma, P
// and dS fed to their products as hi + lo bf16 pairs so that dq, dk and dv
// keep fp32's accuracy). They compute what the gathered kernels
// (routing_gathered_bwd.cu) compute on the same blocks; what differs is
// where the rows come from. A block's rows are members of one cluster,
// picked by index from the sequence planes, and TMA loads boxes, not rows
// picked by index, so the policies (`FusedDkv`, `FusedDq`) gather them
// (`kGatherRows`): each of the block's 256 threads copies 16 bytes at a
// time by cp.async into the swizzled box layout wgmma reads (as TMA would
// have landed them; `sm90::gather_rows`), zero-filling rows past w, as
// TMA fills rows past a plane. No gathered (B, H, k, w, dh) copy of q, k
// or v is written to device memory. do is per cluster and contiguous; it
// goes the same way (its row index is the identity), so one completion
// covers a tile. How tiles pass through the two stages: all 256 threads
// gather tile j + 1 into the stage tile j - 1 held, right after the block
// barrier that opens tile j (each thread's cp.async.wait_group, then
// fence.proxy.async, since cp.async writes through the generic proxy and
// wgmma reads through the async one, then __syncthreads). That barrier
// is one per tile, where an arrival per gathering thread on an mbarrier
// (cp.async.mbarrier.arrive.noinc) would still need each stage's release
// and the same fence by the writers before the consumers read; with the
// one barrier nothing else is needed, at the price of the two warpgroups
// keeping step per tile (which the shared ring already makes them do).
// The member index of a row is clamped into [0, N - 1] (as the fp32
// kernels clamp it), and a member's position is pos[b * N + idx], one
// indirection more than the gathered blocks; the walked tile's positions
// are staged per warpgroup beside its lse and D (`stage`), as the
// gathered policies stage theirs. The walk and the edges are the gathered
// kernels': before the walk the block reduces its owned rows' positions
// and walks only the tiles from the first to the last row of the other
// side that keeps one of its rows (`walk`, `block_min_max`);
// `balanced_topk` returns each cluster's members sorted by token index, so
// under causality this skips what flash's diagonal skips, and with
// unsorted positions a skipped tile is still one that keeps nothing. A
// block whose walk is empty writes zeros. Grid: (B*H*k cluster slots,
// w / 128 row blocks), the gathered kernels' order, so that dq's heaviest
// blocks (reversed blockIdx.y) go first across the whole grid.
//
// fp32: `routing_bwd_dq_kernel` and `routing_bwd_dkv_kernel`, fp32 FMAs
// from shared memory with the tiles `DqTile` and `DkvTile` (attn_bwd.cuh):
// one block per (batch*head, cluster, 64 query rows) walks the cluster's
// keys in tiles of 32 (per-cluster dq); one block per (batch*head,
// cluster, 64 key rows) walks all of the cluster's queries in tiles of 32
// (the TPU's swapped grid; per-cluster dk, dv). Rows are read by index
// once per tile. Hopper has no VMEM residency budget, so one kernel pair
// serves both of the TPU's memory plans, and any w works (the last tiles
// are masked).
#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"

namespace {

using namespace rt;

__device__ __forceinline__ bool routing_keep(int pq, int pk, int causal) {
  return causal ? pq >= pk : pk < SENTINEL;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_idx, const int* __restrict__ k_idx,
    const int* __restrict__ pos_q, const int* __restrict__ pos_k,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq, int H, int N,
    int kc, int w, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const int bh = blockIdx.z, c = blockIdx.y, q0 = blockIdx.x * BQ;
  const int b = bh / H;
  const int qn = min(BQ, w - q0);
  const size_t cl = static_cast<size_t>(bh) * kc + c;   // cluster slot
  const int* qi = q_idx + cl * w;
  const int* ki = k_idx + cl * w;
  const T* qb = q + static_cast<size_t>(bh) * N * DH;
  const T* kb = k + static_cast<size_t>(bh) * N * DH;
  const T* vb = v + static_cast<size_t>(bh) * N * DH;
  const int* pq = pos_q + static_cast<size_t>(b) * N;
  const int* pk = pos_k + static_cast<size_t>(b) * N;

  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    const int row = r < qn ? min(max(qi[q0 + r], 0), N - 1) : -1;
    sm.qrow[r] = row;
    sm.qpos[r] = row >= 0 ? pq[row] : 0;
    sm.lse[r] = r < qn ? lse[cl * w + q0 + r] : 0.f;
    sm.dsum[r] = r < qn ? dsum[cl * w + q0 + r] : 0.f;
  }
  __syncthreads();
  load_rows<T, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const T* {
    const int row = sm.qrow[r];
    return row >= 0 ? qb + static_cast<size_t>(row) * DH : nullptr;
  });
  load_rows<T, DH, BQ, DH + 1>(&sm.dO[0][0], [&](int r) -> const T* {
    return r < qn ? dO + (cl * w + q0 + r) * DH : nullptr;
  });

  DqTile<DH> t;
  t.init();
  for (int k0 = 0; k0 < w; k0 += BK) {
    const int nk = min(BK, w - k0);
    if (threadIdx.x < BK) {
      const int r = threadIdx.x;
      const int row = r < nk ? min(max(ki[k0 + r], 0), N - 1) : -1;
      sm.krow[r] = row;
      sm.kpos[r] = row >= 0 ? pk[row] : SENTINEL;
    }
    __syncthreads();
    auto krow = [&](const T* base) {
      return [=, &sm](int r) -> const T* {
        const int row = sm.krow[r];
        return row >= 0 ? base + static_cast<size_t>(row) * DH : nullptr;
      };
    };
    load_rows<T, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<T, DH, BK, DH + 1>(&sm.v[0][0], krow(vb));
    __syncthreads();
    t.consume(sm, nk, scale, [&](int row, int col) {
      return routing_keep(sm.qpos[row], sm.kpos[col], causal);
    });
  }
  t.store([&](int row) -> float* {
    return row < qn ? dq + (cl * w + q0 + row) * DH : nullptr;
  });
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_idx, const int* __restrict__ k_idx,
    const int* __restrict__ pos_q, const int* __restrict__ pos_k,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, int H, int N, int kc, int w, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);
  const int bh = blockIdx.z, c = blockIdx.y, k0 = blockIdx.x * BKR;
  const int b = bh / H;
  const int kn = min(BKR, w - k0);
  const size_t cl = static_cast<size_t>(bh) * kc + c;   // cluster slot
  const int* qi = q_idx + cl * w;
  const int* ki = k_idx + cl * w;
  const T* qb = q + static_cast<size_t>(bh) * N * DH;
  const T* kb = k + static_cast<size_t>(bh) * N * DH;
  const T* vb = v + static_cast<size_t>(bh) * N * DH;
  const int* pq = pos_q + static_cast<size_t>(b) * N;
  const int* pk = pos_k + static_cast<size_t>(b) * N;

  if (threadIdx.x < BKR) {
    const int r = threadIdx.x;
    const int row = r < kn ? min(max(ki[k0 + r], 0), N - 1) : -1;
    sm.krow[r] = row;
    sm.kpos[r] = row >= 0 ? pk[row] : SENTINEL;
  }
  __syncthreads();
  auto krow = [&](const T* base) {
    return [=, &sm](int r) -> const T* {
      const int row = sm.krow[r];
      return row >= 0 ? base + static_cast<size_t>(row) * DH : nullptr;
    };
  };
  load_rows<T, DH, BKR, DH + 1>(&sm.k[0][0], krow(kb));
  load_rows<T, DH, BKR, DH + 1>(&sm.v[0][0], krow(vb));

  DkvTile<DH> t;
  t.init();
  for (int q0 = 0; q0 < w; q0 += BQT) {
    const int nq = min(BQT, w - q0);
    if (threadIdx.x < BQT) {
      const int r = threadIdx.x;
      const int row = r < nq ? min(max(qi[q0 + r], 0), N - 1) : -1;
      sm.qrow[r] = row;
      sm.qpos[r] = row >= 0 ? pq[row] : 0;
      sm.lse[r] = r < nq ? lse[cl * w + q0 + r] : 0.f;
      sm.dsum[r] = r < nq ? dsum[cl * w + q0 + r] : 0.f;
    }
    __syncthreads();
    load_rows<T, DH, BQT, DH + 1>(&sm.q[0][0], [&](int r) -> const T* {
      const int row = sm.qrow[r];
      return row >= 0 ? qb + static_cast<size_t>(row) * DH : nullptr;
    });
    load_rows<T, DH, BQT, DH + 1>(&sm.dO[0][0], [&](int r) -> const T* {
      return r < nq ? dO + (cl * w + q0 + r) * DH : nullptr;
    });
    __syncthreads();
    t.consume(sm, nq, scale, [&](int row, int col) {
      return routing_keep(sm.qpos[col], sm.kpos[row], causal);
    });
  }
  t.store(
      [&](int row) -> float* {
        return row < kn ? dk + (cl * w + k0 + row) * DH : nullptr;
      },
      [&](int row) -> float* {
        return row < kn ? dv + (cl * w + k0 + row) * DH : nullptr;
      });
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const int* q_idx,
              const int* k_idx, const int* pos_q, const int* pos_k,
              const void* dO, const float* lse, const float* dsum, float* dq,
              int BH, int H, int N, int kc, int w, int causal, float scale,
              cudaStream_t stream) {
  auto kernel = routing_bwd_dq_kernel<T, DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((w + BQ - 1) / BQ, kc, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_idx, k_idx, pos_q, pos_k,
      static_cast<const T*>(dO), lse, dsum, dq, H, N, kc, w, causal,
      scale);
  return cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const int* q_idx,
               const int* k_idx, const int* pos_q, const int* pos_k,
               const void* dO, const float* lse, const float* dsum, float* dk,
               float* dv, int BH, int H, int N, int kc, int w, int causal,
               float scale, cudaStream_t stream) {
  auto kernel = routing_bwd_dkv_kernel<T, DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((w + BKR - 1) / BKR, kc, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_idx, k_idx, pos_q, pos_k,
      static_cast<const T*>(dO), lse, dsum, dk, dv, H, N, kc, w, causal,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the bodies are attn_bwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::BLOCK_THREADS;
using sm90::BlockMinMax;
using sm90::block_min_max;
using sm90::gather_rows;
using sm90::HB;
using sm90::HBN;
using sm90::walk;

// What both fused policies read of one cluster slot: its member indices
// into this (batch, head)'s sequence planes, those planes, this batch
// row's positions and the slot's contiguous do rows.
template <int DH>
struct FusedRows {
  int nseq;                     // N, the rows of a sequence plane
  const int* qi;                // the slot's w query members
  const int* ki;                // and key members
  const int* pos_q;             // (N,) positions of this batch row
  const int* pos_k;             // SENTINEL for a padded key
  const __nv_bfloat16* q;       // (N, DH) planes of this (batch, head)
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dO;      // (w, DH), the slot's own
  // the plane row of member i, clamped into [0, N - 1] as the fp32
  // kernels clamp it
  __device__ int member(const int* idx, int i) const {
    return min(max(idx[i], 0), nseq - 1);
  }
  __device__ void init(const void* q_, const void* k_, const void* v_,
                       const int* q_idx, const int* k_idx, const int* pq,
                       const int* pk, const void* dO_, int H, int N, int kc,
                       int w) {
    const size_t cl = blockIdx.x;   // cluster slot (b * H + h) * kc + c
    const size_t bh = cl / kc;
    const size_t plane = bh * N * DH;
    nseq = N;
    qi = q_idx + cl * w;
    ki = k_idx + cl * w;
    pos_q = pq + bh / H * N;
    pos_k = pk + bh / H * N;
    q = static_cast<const __nv_bfloat16*>(q_) + plane;
    k = static_cast<const __nv_bfloat16*>(k_) + plane;
    v = static_cast<const __nv_bfloat16*>(v_) + plane;
    dO = static_cast<const __nv_bfloat16*>(dO_) + cl * w * DH;
  }
};

// dk/dv: the owned rows are the slot's keys (their tag a position,
// SENTINEL past w), the walked tiles its queries (staged positions, -1
// past w, with their smallest value per warp); the mask and the edges are
// `GatheredDkv`'s on the members' positions.
template <int DH, int BQ>
struct FusedDkv {
  static constexpr bool kGatherRows = true;
  int qplane, kplane, k0, N, M, causal, q_first, ntiles;
  int kmax;                 // the largest tag of this warpgroup's keys
  FusedRows<DH> rows;
  int (*pos)[2][BQ];        // [warpgroup][tile % 2][query]
  int (*low)[2][BQ / 32];   // their smallest value per warp
  __device__ int query_pos(int i) const {
    return rows.pos_q[rows.member(rows.qi, i)];
  }
  __device__ int key_tag(int key) const {
    return key < M ? rows.pos_k[rows.member(rows.ki, key)] : SENTINEL;
  }
  __device__ void stage(int wg, int buf, int t, int row) const {
    const int p = row < N ? query_pos(row) : -1;
    pos[wg][buf][t] = p;
    const int m = __reduce_min_sync(0xffffffffu, p);
    if (t % 32 == 0) low[wg][buf][t / 32] = m;
  }
  __device__ bool edge(int wg, int buf, int q0, int nrows) const {
    if (q0 + nrows > N) return true;
    if (!causal) return kmax >= SENTINEL;
    int m = low[wg][buf][0];
#pragma unroll
    for (int i = 1; i < BQ / 32; ++i) m = min(m, low[wg][buf][i]);
    return m < kmax;
  }
  __device__ bool drop(int wg, int buf, int cl, int col, int key) const {
    return col >= N || !routing_keep(pos[wg][buf][cl], key, causal);
  }
  __device__ void gather_own(void* kt, void* vt) const {
    auto row = [&](int r) {
      return k0 + r < M ? rows.member(rows.ki, k0 + r) : -1;
    };
    gather_rows<DH, HB>(kt, rows.k, row);
    gather_rows<DH, HB>(vt, rows.v, row);
  }
  __device__ void gather_tile(void* qt, void* dot, int q0) const {
    gather_rows<DH, BQ>(qt, rows.q, [&](int r) {
      return q0 + r < N ? rows.member(rows.qi, q0 + r) : -1;
    });
    gather_rows<DH, BQ>(dot, rows.dO,
                        [&](int r) { return q0 + r < N ? q0 + r : -1; });
  }
};

// dq: the owned rows are the slot's queries (their tag a position, -1 past
// w), the walked tiles its keys (staged positions, SENTINEL past w, with
// their largest value per warp); `GatheredDq`'s mask and edges.
template <int DH>
struct FusedDq {
  static constexpr bool kTileTags = true;
  static constexpr bool kGatherRows = true;
  int qplane, kplane, q0, N, M, causal, k_first, ntiles;
  int qmin;                 // the smallest position of this warpgroup's rows
  FusedRows<DH> rows;
  int (*pos)[2][HBN];       // [warpgroup][tile % 2][key]
  int (*high)[2][HBN / 32]; // their largest value per warp
  __device__ int key_pos(int i) const {
    return rows.pos_k[rows.member(rows.ki, i)];
  }
  __device__ int row_tag(int row) const {
    return row < N ? rows.pos_q[rows.member(rows.qi, row)] : -1;
  }
  __device__ void stage(int wg, int buf, int t, int row) const {
    const int p = row < M ? key_pos(row) : SENTINEL;
    pos[wg][buf][t] = p;
    const int m = __reduce_max_sync(0xffffffffu, p);
    if (t % 32 == 0) high[wg][buf][t / 32] = m;
  }
  __device__ bool edge(int wg, int buf, int, int) const {
    const int m = max(high[wg][buf][0], high[wg][buf][1]);
    return causal ? m > qmin : m >= SENTINEL;
  }
  __device__ bool drop(int wg, int buf, int cl, int, int row) const {
    return !routing_keep(row, pos[wg][buf][cl], causal);
  }
  __device__ void gather_own(void* qt, void* dot) const {
    gather_rows<DH, HB>(qt, rows.q, [&](int r) {
      return q0 + r < N ? rows.member(rows.qi, q0 + r) : -1;
    });
    gather_rows<DH, HB>(dot, rows.dO,
                        [&](int r) { return q0 + r < N ? q0 + r : -1; });
  }
  __device__ void gather_tile(void* kt, void* vt, int k0) const {
    auto row = [&](int r) {
      return k0 + r < M ? rows.member(rows.ki, k0 + r) : -1;
    };
    gather_rows<DH, HBN>(kt, rows.k, row);
    gather_rows<DH, HBN>(vt, rows.v, row);
  }
};

template <int DH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    routing_fused_dkv_wgmma(const void* __restrict__ q,
                            const void* __restrict__ k,
                            const void* __restrict__ v,
                            const int* __restrict__ q_idx,
                            const int* __restrict__ k_idx,
                            const int* __restrict__ pos_q,
                            const int* __restrict__ pos_k,
                            const void* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int N, int kc, int w, int causal,
                            float scale) {
  constexpr int BQ = sm90::DkvSmemH<DH>::BQ;
  __shared__ int pos[2][2][BQ];
  __shared__ int low[2][2][BQ / 32];
  __shared__ int red[2][8];
  FusedDkv<DH, BQ> pol;
  pol.qplane = pol.kplane = blockIdx.x;   // lse, D and the outputs' plane
  pol.k0 = blockIdx.y * HB;
  pol.N = pol.M = w;
  pol.causal = causal;
  pol.rows.init(q, k, v, q_idx, k_idx, pos_q, pos_k, dO, H, N, kc, w);
  pol.pos = pos;
  pol.low = low;
  // the block's 128 keys, one a thread of warps 0-3: the smallest
  // position, and the largest of each warpgroup (warps 4-7 hold SENTINEL,
  // which moves neither)
  const int tid = threadIdx.x;
  const int tag = tid < HB ? pol.key_tag(pol.k0 + tid) : SENTINEL;
  const BlockMinMax keys = block_min_max(tag, tag, red);
  const int kmin = keys.low;
  pol.kmax = keys.rows_high;
  walk(w, BQ, red,
       [&](int i) {
         return causal ? pol.query_pos(i) >= kmin : kmin < SENTINEL;
       },
       pol.q_first, pol.ntiles);
  const CUtensorMap none{};   // the policy gathers; no tensor map is read
  sm90::bwd_dkv_body<DH>(none, none, none, none, lse, dsum, dk, dv, pol,
                         scale);
}

// dq: the heaviest blocks (the last, under causality with sorted
// positions) first.
template <int DH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    routing_fused_dq_wgmma(const void* __restrict__ q,
                           const void* __restrict__ k,
                           const void* __restrict__ v,
                           const int* __restrict__ q_idx,
                           const int* __restrict__ k_idx,
                           const int* __restrict__ pos_q,
                           const int* __restrict__ pos_k,
                           const void* __restrict__ dO,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           float* __restrict__ dq, int H, int N, int kc,
                           int w, int causal, float scale) {
  __shared__ int pos[2][2][HBN];
  __shared__ int high[2][2][HBN / 32];
  __shared__ int red[2][8];
  FusedDq<DH> pol;
  pol.qplane = pol.kplane = blockIdx.x;
  pol.q0 = (gridDim.y - 1 - blockIdx.y) * HB;
  pol.N = pol.M = w;
  pol.causal = causal;
  pol.rows.init(q, k, v, q_idx, k_idx, pos_q, pos_k, dO, H, N, kc, w);
  pol.pos = pos;
  pol.high = high;
  // the block's 128 query rows, one a thread of warps 0-3: the largest
  // position, and the smallest of each warpgroup (rows past w and warps
  // 4-7 move neither)
  const int tid = threadIdx.x;
  const int row = pol.q0 + tid;
  const bool mine = tid < HB && row < w;
  const int p = mine ? pol.row_tag(row) : 0;
  const BlockMinMax rows = block_min_max(mine ? p : INT_MAX, mine ? p : -1,
                                         red);
  const int qmax = rows.high;
  pol.qmin = rows.rows_low;
  walk(w, HBN, red,
       [&](int i) {
         const int pk = pol.key_pos(i);
         return causal ? pk <= qmax : pk < SENTINEL;
       },
       pol.k_first, pol.ntiles);
  const CUtensorMap none{};
  sm90::bwd_dq_body<DH>(none, none, none, none, lse, dsum, dq, pol, scale);
}

template <int DH>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const int* q_idx, const int* k_idx, const int* pos_q,
                   const int* pos_k, const void* dO, const float* lse,
                   const float* dsum, float* dq, int BH, int H, int N,
                   int kc, int w, int causal, float scale,
                   cudaStream_t stream) {
  auto kernel = routing_fused_dq_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DqSmemH<DH>>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH * kc, (w + HB - 1) / HB);
  kernel<<<grid, BLOCK_THREADS, smem, stream>>>(
      q, k, v, q_idx, k_idx, pos_q, pos_k, dO, lse, dsum, dq, H, N, kc, w,
      causal, scale);
  return cudaGetLastError();
}

template <int DH>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const int* q_idx, const int* k_idx, const int* pos_q,
                    const int* pos_k, const void* dO, const float* lse,
                    const float* dsum, float* dk, float* dv, int BH, int H,
                    int N, int kc, int w, int causal, float scale,
                    cudaStream_t stream) {
  auto kernel = routing_fused_dkv_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DkvSmemH<DH>>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH * kc, (w + HB - 1) / HB);
  kernel<<<grid, BLOCK_THREADS, smem, stream>>>(
      q, k, v, q_idx, k_idx, pos_q, pos_k, dO, lse, dsum, dk, dv, H, N, kc,
      w, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v (B*H, N, dh) (k may be q: shared-QK), q_idx/k_idx (B*H, kc, w)
// int32, pos_q/pos_k (B, N) int32 (pos_k = SENTINEL for padded keys),
// dO (B*H, kc, w, dh), lse/dsum (B*H, kc, w) fp32; dq (B*H, kc, w, dh)
// fp32. dtype: 0 fp32, 1 bf16; dh 64, 128 or 192 (any other head dim comes
// zero-padded to one of them); scale the softmax scale, 1 / sqrt of the
// true head dim. Returns a cudaError_t code.
extern "C" int routing_fused_bwd_dq(const void* q, const void* k,
                                    const void* v, const int* q_idx,
                                    const int* k_idx, const int* pos_q,
                                    const int* pos_k, const void* dO,
                                    const float* lse, const float* dsum,
                                    float* dq, int BH, int H, int N, int kc,
                                    int w, int dh, int causal, int dtype,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_DQ(DH)                                                         \
  if (dh == DH && dtype == 1)                                                \
    return launch_dq_bf16<DH>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO, lse,  \
                              dsum, dq, BH, H, N, kc, w, causal, scale, s);  \
  if (dh == DH && dtype == 0)                                                \
    return launch_dq<float, DH>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO,     \
                                lse, dsum, dq, BH, H, N, kc, w, causal,      \
                                scale, s);
  FUSED_DQ(128)
  FUSED_DQ(64)
  FUSED_DQ(192)
#undef FUSED_DQ
  return cudaErrorInvalidValue;
}

// As above; dk/dv (B*H, kc, w, dh) fp32.
extern "C" int routing_fused_bwd_dkv(const void* q, const void* k,
                                     const void* v, const int* q_idx,
                                     const int* k_idx, const int* pos_q,
                                     const int* pos_k, const void* dO,
                                     const float* lse, const float* dsum,
                                     float* dk, float* dv, int BH, int H,
                                     int N, int kc, int w, int dh, int causal,
                                     int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_DKV(DH)                                                        \
  if (dh == DH && dtype == 1)                                                \
    return launch_dkv_bf16<DH>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO, lse, \
                               dsum, dk, dv, BH, H, N, kc, w, causal, scale, \
                               s);                                           \
  if (dh == DH && dtype == 0)                                                \
    return launch_dkv<float, DH>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO,    \
                                 lse, dsum, dk, dv, BH, H, N, kc, w, causal, \
                                 scale, s);
  FUSED_DKV(128)
  FUSED_DKV(64)
  FUSED_DKV(192)
#undef FUSED_DKV
  return cudaErrorInvalidValue;
}
