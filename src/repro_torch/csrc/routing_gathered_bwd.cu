// Gathered routed attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_g_dq_kernel` and `_g_dkv_kernel` of
// src/repro/kernels/routing_attention.py (:115 / :140, their
// `pallas_call`s :213 / :238; the backward of `routed_attention_blocks`).
// As in the forward (csrc/routing_gathered.cu) the inputs are contiguous
// gathered cluster blocks: q/k/v and do (n, w, dh), positions (n, w) int32
// (a padded key carries pos = SENTINEL = 2^30), the forward's lse and
// D = rowsum(do * out) (n, w) fp32, D taken outside the kernels as
// `_g_bwd_call` does. p is recomputed from the lse and masked explicitly:
//   keep = causal ? pos_q >= pos_k : pos_k < SENTINEL
// (`_keep_mask`), and dq, dk, dv come out fp32 (n, w, dh). Shared-QK
// passes the q blocks as k; the caller's autograd then adds dk to q's
// gradient, and the scatter of the block gradients back to sequence
// layout is the backward of the caller's gather.
//
// What bounds it on this card: 6*dh (dq) or 8*dh (dk/dv) flops per
// attended pair against each block row read once and fp32 gradients
// written: under the bf16 ridge (~295 flops per byte) at w = 512, dh 64,
// so device memory bounds an ideal kernel.
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64 and 128): `routing_gathered_dkv_wgmma` and
// `routing_gathered_dq_wgmma`, on the tensor cores with the bodies of
// attn_bwd_sm90.cuh, the flash backward's (the design is described
// there: 128 owned rows a block, TMA-loaded tiles of the other side
// through a ring, P and dS as hi + lo bf16 pairs). The gathered blocks
// are that layout already: n planes of w rows, one plane for q, k, v and
// do alike (flash with Hkv = H, no group sum). What differs is the mask,
// which reads positions, not row indices (the policies `GatheredDkv` and
// `GatheredDq`):
// - an owned row's position goes into a register once (a key past w reads
//   SENTINEL); the walked tile's positions are staged per warpgroup in
//   shared memory beside its lse and D (a plane's int32 row is 16-byte
//   aligned only when w is a multiple of 4, so TMA cannot load it), with
//   their smallest (query tiles) or largest (key tiles) value per warp;
// - the walk: before it, the block reduces its owned rows' positions and
//   walks only the tiles from the first to the last row of the other side
//   that keeps one of its rows (causal: a query at or after the block's
//   smallest key position, a key at or before its largest query
//   position; non-causal: every query while the block has a key that is
//   not padding, every key that is not). Under causality with sorted
//   positions, as every producer makes them, that skips what flash's
//   diagonal skips; with unsorted positions a skipped tile is still one
//   that keeps nothing. A block whose walk is empty writes zeros;
// - a warpgroup masks a tile only when the tile crosses the mask's edge
//   for its 64 rows: causal, a query tile's smallest position is below
//   the warpgroup's largest key position (dk/dv) or a key tile's largest
//   position is above the warpgroup's smallest query position (dq);
//   non-causal, a padded key is among the keys; or rows past w. A query
//   row that keeps no key (lse -1e9) always sits in such a tile.
//
// fp32: `routing_gathered_dq_kernel` and `routing_gathered_dkv_kernel`,
// fp32 FMAs from shared memory with the tiles `DqTile` and `DkvTile`
// (attn_bwd.cuh): a block per (cluster, 64 query rows) walks the cluster's
// keys in tiles of 32; a block per (cluster, 64 key rows) walks all of its
// queries in tiles of 32 (the TPU's swapped grid: key tile parallel, query
// sweep sequential). They keep full fp32 products, as PyTorch's fp32
// matmul does (no TF32).
#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"

namespace {

using namespace rt;

template <int DH>
__global__ void __launch_bounds__(NT) routing_gathered_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ pos_q,
    const int* __restrict__ pos_k, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, int w, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * w;
  const int q0 = blockIdx.y * BQ;
  const int qn = min(BQ, w - q0);
  const float* kb = k + base * DH;
  const float* vb = v + base * DH;

  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    sm.qpos[r] = r < qn ? pos_q[base + q0 + r] : 0;
    sm.lse[r] = r < qn ? lse[base + q0 + r] : 0.f;
    sm.dsum[r] = r < qn ? dsum[base + q0 + r] : 0.f;
  }
  auto qrow = [&](const float* b) {
    return [=](int r) -> const float* {
      return r < qn ? b + (base + q0 + r) * DH : nullptr;
    };
  };
  load_rows<float, DH, BQ, DH + 1>(&sm.q[0][0], qrow(q));
  load_rows<float, DH, BQ, DH + 1>(&sm.dO[0][0], qrow(dO));

  DqTile<DH> t;
  t.init();
  for (int k0 = 0; k0 < w; k0 += BK) {
    const int nk = min(BK, w - k0);
    if (threadIdx.x < BK) {
      const int r = threadIdx.x;
      sm.kpos[r] = r < nk ? pos_k[base + k0 + r] : SENTINEL;
    }
    auto krow = [&](const float* b) {
      return [=](int r) -> const float* {
        return r < nk ? b + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<float, DH, BK, DH + 1>(&sm.v[0][0], krow(vb));
    __syncthreads();
    t.consume(sm, nk, scale, [&](int row, int col) {
      return gathered_keep(sm.qpos[row], sm.kpos[col], causal);
    });
  }
  t.store([&](int row) -> float* {
    return row < qn ? dq + (base + q0 + row) * DH : nullptr;
  });
}

template <int DH>
__global__ void __launch_bounds__(NT) routing_gathered_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ pos_q,
    const int* __restrict__ pos_k, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int w, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * w;
  const int k0 = blockIdx.y * BKR;
  const int kn = min(BKR, w - k0);

  if (threadIdx.x < BKR) {
    const int r = threadIdx.x;
    sm.kpos[r] = r < kn ? pos_k[base + k0 + r] : SENTINEL;
  }
  auto krow = [&](const float* b) {
    return [=](int r) -> const float* {
      return r < kn ? b + (base + k0 + r) * DH : nullptr;
    };
  };
  load_rows<float, DH, BKR, DH + 1>(&sm.k[0][0], krow(k));
  load_rows<float, DH, BKR, DH + 1>(&sm.v[0][0], krow(v));

  DkvTile<DH> t;
  t.init();
  for (int q0 = 0; q0 < w; q0 += BQT) {
    const int nq = min(BQT, w - q0);
    if (threadIdx.x < BQT) {
      const int r = threadIdx.x;
      sm.qpos[r] = r < nq ? pos_q[base + q0 + r] : 0;
      sm.lse[r] = r < nq ? lse[base + q0 + r] : 0.f;
      sm.dsum[r] = r < nq ? dsum[base + q0 + r] : 0.f;
    }
    auto qrow = [&](const float* b) {
      return [=](int r) -> const float* {
        return r < nq ? b + (base + q0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BQT, DH + 1>(&sm.q[0][0], qrow(q));
    load_rows<float, DH, BQT, DH + 1>(&sm.dO[0][0], qrow(dO));
    __syncthreads();
    t.consume(sm, nq, scale, [&](int row, int col) {
      return gathered_keep(sm.qpos[col], sm.kpos[row], causal);
    });
  }
  t.store(
      [&](int row) -> float* {
        return row < kn ? dk + (base + k0 + row) * DH : nullptr;
      },
      [&](int row) -> float* {
        return row < kn ? dv + (base + k0 + row) * DH : nullptr;
      });
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const int* pos_q,
              const int* pos_k, const void* dO, const float* lse,
              const float* dsum, float* dq, int n, int w, int causal,
              cudaStream_t stream) {
  auto kernel = routing_gathered_dq_kernel<DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos_q, pos_k,
      static_cast<const float*>(dO), lse, dsum, dq, w, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const int* pos_q,
               const int* pos_k, const void* dO, const float* lse,
               const float* dsum, float* dk, float* dv, int n, int w,
               int causal, cudaStream_t stream) {
  auto kernel = routing_gathered_dkv_kernel<DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + BKR - 1) / BKR);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos_q, pos_k,
      static_cast<const float*>(dO), lse, dsum, dk, dv, w, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the bodies are attn_bwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::BLOCK_THREADS;
using sm90::BlockMinMax;
using sm90::block_min_max;
using sm90::HB;
using sm90::HBN;
using sm90::WG;
using sm90::walk;

// The gathered mask on positions (see the top of this file). dk/dv: the
// owned rows are keys (their tag a position, SENTINEL past w), the walked
// tiles queries (staged positions, -1 past w, with their smallest value
// per warp).
template <int BQ>
struct GatheredDkv {
  int qplane, kplane, k0, N, M, causal, q_first, ntiles;
  int kmax;                 // the largest tag of this warpgroup's keys
  size_t base;              // the plane's first row of the positions
  const int* pos_q;
  const int* pos_k;
  int (*pos)[2][BQ];        // [warpgroup][tile % 2][query]
  int (*low)[2][BQ / 32];   // their smallest value per warp
  __device__ int key_tag(int key) const {
    return key < M ? pos_k[base + key] : SENTINEL;
  }
  __device__ void stage(int wg, int buf, int t, int row) const {
    const int p = row < N ? pos_q[base + row] : -1;
    pos[wg][buf][t] = p;
    const int m = __reduce_min_sync(0xffffffffu, p);
    if (t % 32 == 0) low[wg][buf][t / 32] = m;
  }
  __device__ bool edge(int wg, int buf, int q0, int rows) const {
    if (q0 + rows > N) return true;
    if (!causal) return kmax >= SENTINEL;
    int m = low[wg][buf][0];
#pragma unroll
    for (int i = 1; i < BQ / 32; ++i) m = min(m, low[wg][buf][i]);
    return m < kmax;
  }
  __device__ bool drop(int wg, int buf, int cl, int col, int key) const {
    return col >= N || !gathered_keep(pos[wg][buf][cl], key, causal);
  }
};

// dq: the owned rows are queries (their tag a position, -1 past w), the
// walked tiles keys (staged positions, SENTINEL past w, with their largest
// value per warp).
struct GatheredDq {
  static constexpr bool kTileTags = true;
  int qplane, kplane, q0, N, M, causal, k_first, ntiles;
  int qmin;                 // the smallest position of this warpgroup's rows
  size_t base;
  const int* pos_q;
  const int* pos_k;
  int (*pos)[2][HBN];       // [warpgroup][tile % 2][key]
  int (*high)[2][HBN / 32]; // their largest value per warp
  __device__ int row_tag(int row) const {
    return row < N ? pos_q[base + row] : -1;
  }
  __device__ void stage(int wg, int buf, int t, int row) const {
    const int p = row < M ? pos_k[base + row] : SENTINEL;
    pos[wg][buf][t] = p;
    const int m = __reduce_max_sync(0xffffffffu, p);
    if (t % 32 == 0) high[wg][buf][t / 32] = m;
  }
  __device__ bool edge(int wg, int buf, int, int) const {
    const int m = max(high[wg][buf][0], high[wg][buf][1]);
    return causal ? m > qmin : m >= SENTINEL;
  }
  __device__ bool drop(int wg, int buf, int cl, int, int row) const {
    return !gathered_keep(row, pos[wg][buf][cl], causal);
  }
};

template <int DH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    routing_gathered_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const int* __restrict__ pos_q,
                               const int* __restrict__ pos_k,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum,
                               float* __restrict__ dk,
                               float* __restrict__ dv, int w, int causal,
                               float scale) {
  constexpr int BQ = sm90::DkvSmemH<DH>::BQ;
  __shared__ int pos[2][2][BQ];
  __shared__ int low[2][2][BQ / 32];
  __shared__ int red[2][8];
  GatheredDkv<BQ> pol;
  pol.qplane = pol.kplane = blockIdx.x;
  pol.k0 = blockIdx.y * HB;
  pol.N = pol.M = w;
  pol.causal = causal;
  pol.base = static_cast<size_t>(blockIdx.x) * w;
  pol.pos_q = pos_q;
  pol.pos_k = pos_k;
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
  const size_t base = pol.base;
  walk(w, BQ, red,
       [&](int i) {
         return causal ? pos_q[base + i] >= kmin : kmin < SENTINEL;
       },
       pol.q_first, pol.ntiles);
  sm90::bwd_dkv_body<DH>(tq, tk, tv, tdo, lse, dsum, dk, dv, pol, scale);
}

// dq: the heaviest blocks (the last, under causality with sorted
// positions) first.
template <int DH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    routing_gathered_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const int* __restrict__ pos_q,
                              const int* __restrict__ pos_k,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              float* __restrict__ dq, int w, int causal,
                              float scale) {
  __shared__ int pos[2][2][HBN];
  __shared__ int high[2][2][HBN / 32];
  __shared__ int red[2][8];
  GatheredDq pol;
  pol.qplane = pol.kplane = blockIdx.x;
  pol.q0 = (gridDim.y - 1 - blockIdx.y) * HB;
  pol.N = pol.M = w;
  pol.causal = causal;
  pol.base = static_cast<size_t>(blockIdx.x) * w;
  pol.pos_q = pos_q;
  pol.pos_k = pos_k;
  pol.pos = pos;
  pol.high = high;
  // the block's 128 query rows, one a thread of warps 0-3: the largest
  // position, and the smallest of each warpgroup (rows past w and warps
  // 4-7 move neither)
  const int tid = threadIdx.x;
  const int row = pol.q0 + tid;
  const bool mine = tid < HB && row < w;
  const int p = mine ? pos_q[pol.base + row] : 0;
  const BlockMinMax rows = block_min_max(mine ? p : INT_MAX, mine ? p : -1,
                                         red);
  const int qmax = rows.high;
  pol.qmin = rows.rows_low;
  const size_t base = pol.base;
  walk(w, HBN, red,
       [&](int i) {
         const int pk = pos_k[base + i];
         return causal ? pk <= qmax : pk < SENTINEL;
       },
       pol.k_first, pol.ntiles);
  sm90::bwd_dq_body<DH>(tq, tk, tv, tdo, lse, dsum, dq, pol, scale);
}

// The four bf16 tensor maps of a backward call over n planes of w rows:
// q and do in boxes of ``qrows`` rows, k and v of ``krows``.
template <int DH>
int map_bwd(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
            const void* dO, int n, int w, int qrows, int krows) {
  using sm90::map_rows;
  int err = map_rows(&m[0], q, n, w, DH, qrows);
  if (err == cudaSuccess) err = map_rows(&m[1], k, n, w, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[2], v, n, w, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[3], dO, n, w, DH, qrows);
  return err;
}

template <int DH>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const int* pos_q, const int* pos_k, const void* dO,
                   const float* lse, const float* dsum, float* dq, int n,
                   int w, int causal, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, n, w, HB, HBN);
  if (err != cudaSuccess) return err;
  auto kernel = routing_gathered_dq_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DqSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + HB - 1) / HB);
  kernel<<<grid, BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], pos_q, pos_k, lse, dsum, dq, w, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <int DH>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const int* pos_q, const int* pos_k, const void* dO,
                    const float* lse, const float* dsum, float* dk,
                    float* dv, int n, int w, int causal,
                    cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, n, w, sm90::DkvSmemH<DH>::BQ, HB);
  if (err != cudaSuccess) return err;
  auto kernel = routing_gathered_dkv_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DkvSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + HB - 1) / HB);
  kernel<<<grid, BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], pos_q, pos_k, lse, dsum, dk, dv, w, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q/k/v/dO (n, w, dh) contiguous gathered blocks (k may be q: shared-QK),
// pos_q/pos_k (n, w) int32 (pos_k = SENTINEL for padded keys), lse/dsum
// (n, w) fp32; dq (n, w, dh) fp32. dtype: 0 fp32, 1 bf16. Returns a
// cudaError_t code.
extern "C" int routing_gathered_bwd_dq(const void* q, const void* k,
                                       const void* v, const int* pos_q,
                                       const int* pos_k, const void* dO,
                                       const float* lse, const float* dsum,
                                       float* dq, int n, int w, int dh,
                                       int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dq_bf16<128>(q, k, v, pos_q, pos_k, dO, lse, dsum, dq, n,
                               w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dq_bf16<64>(q, k, v, pos_q, pos_k, dO, lse, dsum, dq, n,
                              w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dq<128>(q, k, v, pos_q, pos_k, dO, lse, dsum, dq, n, w,
                          causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dq<64>(q, k, v, pos_q, pos_k, dO, lse, dsum, dq, n, w,
                         causal, s);
  return cudaErrorInvalidValue;
}

// As above; dk/dv (n, w, dh) fp32.
extern "C" int routing_gathered_bwd_dkv(const void* q, const void* k,
                                        const void* v, const int* pos_q,
                                        const int* pos_k, const void* dO,
                                        const float* lse, const float* dsum,
                                        float* dk, float* dv, int n, int w,
                                        int dh, int causal, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dkv_bf16<128>(q, k, v, pos_q, pos_k, dO, lse, dsum, dk,
                                dv, n, w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dkv_bf16<64>(q, k, v, pos_q, pos_k, dO, lse, dsum, dk, dv,
                               n, w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dkv<128>(q, k, v, pos_q, pos_k, dO, lse, dsum, dk, dv, n,
                           w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dkv<64>(q, k, v, pos_q, pos_k, dO, lse, dsum, dk, dv, n,
                          w, causal, s);
  return cudaErrorInvalidValue;
}
