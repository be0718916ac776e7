// Gathered routed attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/routing_attention.py
// (:80, its `pallas_call` :172; the forward of `routed_attention_blocks`).
// The caller has already gathered each cluster's member rows into
// contiguous blocks, as XLA does in the JAX package: q/k/v (n, w, dh) with
// n = B*H*k, and each row's original position (n, w) int32 (a padded key
// carries pos = SENTINEL = 2^30). The mask is causal on original positions
// (pos_q >= pos_k), or, non-causal, every key whose position is below
// SENTINEL. A row with no attendable key outputs 0 and lse
// NEG + log(1e-30). Writes out (n, w, dh) in q's type and
// lse = m + log(max(l, 1e-30)) fp32. Shared-QK passes the q blocks as k.
// Any w (the TPU kernel asserts w % min(128, w) == 0; this one masks the
// ragged last tiles).
//
// What bounds it on this card: each cluster is a (w x w) problem of which
// the causal half is needed, ~4*dh flops per attended pair against q, k, v
// and out read or written once: ~85 flops per byte at w = 512 and dh 64 in
// bf16, under the bf16 ridge (~295), so device memory bounds an ideal
// kernel.
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64 and 128): `routing_gathered_wgmma`, on the tensor cores with
// the flash forward's body (attn_fwd_sm90.cuh: 128 query rows a block, Q
// loaded once by TMA, 128-row K/V tiles through a ring, S = Q K^T and
// O += P V by wgmma, P rounded to bf16 once). The blocks are that layout
// already: n planes of w rows (rows past w arrive as zeros). What differs
// from flash is the mask, which reads positions (the policy
// `GatheredFwd`), as the gathered backward's do (routing_gathered_bwd.cu):
// - an owned row's position goes into a register once (-1 past w); the
//   walked key tile's positions are staged per warpgroup in shared memory
//   (a plane's int32 row is 16-byte aligned only when w is a multiple of
//   4, so TMA cannot load it), with their largest value per warp;
// - the walk: the block reduces its rows' positions and walks only the
//   key tiles from the first to the last key that one of its rows keeps
//   (causal: a key at or before the block's largest query position;
//   non-causal: every key that is not padding). Under causality with
//   sorted positions that skips what flash's diagonal skips; with unsorted
//   positions a skipped tile is still one that keeps nothing;
// - a warpgroup masks a tile unless every pair in it keeps: causal, the
//   tile's largest key position is above the warpgroup's smallest query
//   position; non-causal, a padded key (or a row past w) is among the
//   keys. A query that keeps no key always sits in such a tile.
//
// fp32: `routing_gathered_kernel`, fp32 FMAs from shared memory with the
// online softmax of `FlashTile` (common.cuh): one block of threads owns
// (cluster, 64 query rows) and walks the cluster's keys in tiles of 32.
// It keeps full fp32 products, as PyTorch's fp32 matmul does (no TF32).
#include "attn_fwd_sm90.cuh"
#include "common.cuh"

namespace {

using namespace rt;

template <int DH>
__global__ void __launch_bounds__(NT) routing_gathered_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ pos_q,
    const int* __restrict__ pos_k, float* __restrict__ o,
    float* __restrict__ lse, int w, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FlashSmem<DH>*>(smem_raw);
  const size_t c = blockIdx.x;                 // cluster block
  const int q0 = blockIdx.y * BQ;
  const int qn = min(BQ, w - q0);
  const size_t base = c * w;                   // first row of the block
  const float* qb = q + base * DH;
  const float* kb = k + base * DH;
  const float* vb = v + base * DH;

  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    sm.qpos[r] = r < qn ? pos_q[base + q0 + r] : 0;
  }
  load_rows<float, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const float* {
    return r < qn ? qb + static_cast<size_t>(q0 + r) * DH : nullptr;
  });

  FlashTile<DH> ft;
  ft.init();
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
    load_rows<float, DH, BK, DH>(&sm.v[0][0], krow(vb));
    __syncthreads();
    ft.consume(sm, nk, scale, [&](int row, int col) {
      return gathered_keep(sm.qpos[row], sm.kpos[col], causal);
    });
  }
  float* ob = o + base * DH;
  float* lb = lse + base;
  ft.template store<float>(
      [&](int row) -> float* {
        return row < qn ? ob + static_cast<size_t>(q0 + row) * DH : nullptr;
      },
      [&](int row) -> float* { return row < qn ? lb + q0 + row : nullptr; });
}

template <int DH>
int launch_fp32(const void* q, const void* k, const void* v, const int* pos_q,
                const int* pos_k, void* o, float* lse, int n, int w,
                int causal, cudaStream_t stream) {
  auto kernel = routing_gathered_kernel<DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos_q, pos_k, static_cast<float*>(o),
      lse, w, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the body is attn_fwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::FWD_KEYS;
using sm90::FWD_ROWS;

// The gathered mask on positions (see the top of this file): an owned
// row's tag is its position (-1 past w), the walked key tiles' positions
// are staged (SENTINEL past w) with their largest value per warp.
struct GatheredFwd {
  static constexpr bool kNoKeyRows = true;
  int qplane, kplane, q0, N, k_first, ntiles, causal;
  int qmin;                       // the smallest position of this
                                  // warpgroup's rows
  size_t base;                    // the plane's first row of the positions
  const int* pos_q;
  const int* pos_k;
  int (*pos)[2][FWD_KEYS];        // [warpgroup][tile % 2][key]
  int (*high)[2][FWD_KEYS / 32];  // their largest value per warp
  __device__ int row_tag(int row) const {
    return row < N ? pos_q[base + row] : -1;
  }
  __device__ bool tile_tags() const { return true; }
  __device__ void stage(int wg, int buf, int t, int j) const {
    const int p = j < N ? pos_k[base + j] : SENTINEL;
    pos[wg][buf][t] = p;
    const int m = __reduce_max_sync(0xffffffffu, p);
    if (t % 32 == 0) high[wg][buf][t / 32] = m;
  }
  __device__ bool edge(int wg, int buf, int) const {
    int m = high[wg][buf][0];
#pragma unroll
    for (int i = 1; i < FWD_KEYS / 32; ++i) m = max(m, high[wg][buf][i]);
    return causal ? m > qmin : m >= SENTINEL;
  }
  __device__ bool drop(int wg, int buf, int c, int, int row) const {
    return !gathered_keep(row, pos[wg][buf][c], causal);
  }
};

// The heaviest blocks (the last, under causality with sorted positions)
// first.
template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    routing_gathered_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const int* __restrict__ pos_q,
                           const int* __restrict__ pos_k,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int w, int causal,
                           float scale) {
  __shared__ int pos[2][2][FWD_KEYS];
  __shared__ int high[2][2][FWD_KEYS / 32];
  __shared__ int red[2][8];
  GatheredFwd pol;
  pol.qplane = pol.kplane = blockIdx.x;
  pol.q0 = (gridDim.y - 1 - blockIdx.y) * FWD_ROWS;
  pol.N = w;
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
  const bool mine = tid < FWD_ROWS && row < w;
  const int p = mine ? pos_q[pol.base + row] : 0;
  const sm90::BlockMinMax rows = sm90::block_min_max(
      mine ? p : INT_MAX, mine ? p : -1, red);
  const int qmax = rows.high;
  pol.qmin = rows.rows_low;
  const size_t base = pol.base;
  sm90::walk(w, FWD_KEYS, red,
             [&](int i) {
               const int pk = pos_k[base + i];
               return causal ? pk <= qmax : pk < SENTINEL;
             },
             pol.k_first, pol.ntiles);
  sm90::fwd_body<DH>(tq, tk, tv, o, lse, pol, scale);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const int* pos_q,
                const int* pos_k, void* o, float* lse, int n, int w,
                int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = sm90::map_rows(&tq, q, n, w, DH, FWD_ROWS);
  if (err == cudaSuccess) err = sm90::map_rows(&tk, k, n, w, DH, FWD_KEYS);
  if (err == cudaSuccess) err = sm90::map_rows(&tv, v, n, w, DH, FWD_KEYS);
  if (err != cudaSuccess) return err;
  auto kernel = routing_gathered_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::FwdSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + FWD_ROWS - 1) / FWD_ROWS);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      tq, tk, tv, pos_q, pos_k, static_cast<__nv_bfloat16*>(o), lse, w,
      causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q/k/v (n, w, dh) contiguous gathered blocks (k may be q: shared-QK),
// pos_q/pos_k (n, w) int32 (pos_k = SENTINEL for padded keys); o (n, w, dh),
// lse (n, w) fp32. dtype: 0 fp32, 1 bf16. Returns a cudaError_t code.
extern "C" int routing_gathered_fwd(const void* q, const void* k,
                                    const void* v, const int* pos_q,
                                    const int* pos_k, void* o, float* lse,
                                    int n, int w, int dh, int causal,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_bf16<128>(q, k, v, pos_q, pos_k, o, lse, n, w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_bf16<64>(q, k, v, pos_q, pos_k, o, lse, n, w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_fp32<128>(q, k, v, pos_q, pos_k, o, lse, n, w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_fp32<64>(q, k, v, pos_q, pos_k, o, lse, n, w, causal, s);
  return cudaErrorInvalidValue;
}
