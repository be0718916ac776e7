// Fused gather-free routed attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_f_fwd_kernel` (VMEM-resident plan) and
// `_p_fwd_kernel` (DMA-paged plan) of src/repro/kernels/routing_attention.py
// (forward of `routed_attention_fused`). For each (batch*head, cluster c,
// query tile) the block reads its own member indices q_idx / k_idx, pulls
// the member rows of q, k and v straight from the sequence-layout
// (B*H, N, dh) planes, masks on original positions (pos_q >= pos_k when
// causal; a padded key carries pos = SENTINEL = 2^30) and runs an online
// softmax. Shared-QK mode passes the q plane as k. Writes per-cluster
// outputs (B*H, k, w, dh) and the lse (B*H, k, w); a row that keeps no key
// writes 0 and lse NEG + log(1e-30). No gathered (B, H, k, w, dh) copy of
// q, k or v is written to device memory. Hopper has no VMEM residency
// budget, so one kernel serves both of the TPU's memory plans, and any w
// works (the last tiles are masked).
//
// What bounds it on this card: each cluster is a (w x w) attention whose
// causal half is needed, ~4*dh flops per attended pair against each member
// row of q, k, v read once and out written once: ~20 flops per byte at
// w = 64 (N = 2048) and ~85 at w = 256 (N = 8192), under the bf16 ridge
// (~295), so device memory bounds an ideal kernel.
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64, 128 and 192): `routing_fused_wgmma`, on the tensor cores
// with the forward body the flash, local and gathered forwards run
// (attn_fwd_sm90.cuh: 128 query rows a block, 128-row K/V tiles (64-row at
// dh 192), S = Q K^T and O += P V by wgmma, P rounded to bf16 once). The
// dh-192 instance serves any head dim over 128 (rt-pg19's 129): the
// wrapper pads q, k and v with zero columns and passes the true head dim's
// scale, which every instance takes from the caller. It computes what the
// gathered forward (routing_gathered.cu) computes on the same blocks; what
// differs is where the rows come from. A block's rows are members of one
// cluster, picked by index from the sequence planes, and TMA loads boxes,
// not rows picked by index, so the policy (`FusedFwd`) gathers them
// (`kGatherRows`), as the fused backward's policies do
// (routing_fused_bwd.cu): each of the block's 256 threads copies 16 bytes
// at a time by cp.async into the swizzled box layout wgmma reads
// (`sm90::gather_rows`), zero-filling rows past w; tile j + 1 is gathered
// into the stage tile j - 1 held, right after the block barrier that opens
// tile j. The member index of a row is clamped into [0, N - 1] (as the
// fp32 kernel clamps it), and a member's position is pos[b * N + idx]. The
// mask, the walk and the edges are the gathered forward's on the members'
// positions: an owned row's position goes into a register once (-1 past
// w); the walked key tile's positions are staged per warpgroup (SENTINEL
// past w) with their largest value per warp; the block walks only the key
// tiles from the first to the last key member that one of its rows keeps;
// a warpgroup masks a tile unless every pair in it keeps.
//
// fp32: `routing_fused_kernel`, fp32 FMAs from shared memory with the
// online softmax of `FlashTile` (common.cuh): all w^2 pairs of a cluster,
// in tiles.
#include "attn_fwd_sm90.cuh"
#include "common.cuh"

namespace {

using namespace rt;

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_idx, const int* __restrict__ k_idx,
    const int* __restrict__ pos_q, const int* __restrict__ pos_k,
    T* __restrict__ o, float* __restrict__ lse, int H, int N, int kc, int w,
    int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FlashSmem<DH>*>(smem_raw);
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
  }
  __syncthreads();
  load_rows<T, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const T* {
    const int row = sm.qrow[r];
    return row >= 0 ? qb + static_cast<size_t>(row) * DH : nullptr;
  });

  FlashTile<DH> ft;
  ft.init();
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
    load_rows<T, DH, BK, DH>(&sm.v[0][0], krow(vb));
    __syncthreads();
    ft.consume(sm, nk, scale, [&](int row, int col) {
      const int pkc = sm.kpos[col];
      return causal ? sm.qpos[row] >= pkc : pkc < SENTINEL;
    });
  }
  T* ob = o + cl * w * DH;
  float* lb = lse + cl * w;
  ft.template store<T>(
      [&](int row) -> T* {
        return row < qn ? ob + static_cast<size_t>(q0 + row) * DH : nullptr;
      },
      [&](int row) -> float* { return row < qn ? lb + q0 + row : nullptr; });
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* q_idx,
           const int* k_idx, const int* pos_q, const int* pos_k, void* o,
           float* lse, int BH, int H, int N, int kc, int w, int causal,
           float scale, cudaStream_t stream) {
  auto kernel = routing_fused_kernel<T, DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((w + BQ - 1) / BQ, kc, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_idx, k_idx, pos_q, pos_k,
      static_cast<T*>(o), lse, H, N, kc, w, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the body is attn_fwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::FWD_ROWS;
using sm90::gather_rows;

// The gathered forward's mask on the members' positions (see the top of
// this file), its rows gathered from the sequence planes: an owned row's
// tag is its member's position (-1 past w), the walked key tiles' member
// positions are staged (SENTINEL past w) with their largest value per
// warp; the walked tiles have KEYS rows.
template <int DH>
struct FusedFwd {
  static constexpr int KEYS = sm90::fwd_keys<DH>();
  static constexpr bool kNoKeyRows = true;
  static constexpr bool kGatherRows = true;
  int qplane, kplane, q0, N, k_first, ntiles, causal;
  int qmin;                       // the smallest position of this
                                  // warpgroup's rows
  int nseq;                       // the rows of a sequence plane
  const int* qi;                  // the slot's w query members
  const int* ki;                  // and key members
  const int* pos_q;               // (nseq,) positions of this batch row
  const int* pos_k;               // SENTINEL for a padded key
  const __nv_bfloat16* q;         // (nseq, DH) planes of this (batch, head)
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int (*pos)[2][KEYS];            // [warpgroup][tile % 2][key]
  int (*high)[2][KEYS / 32];      // their largest value per warp
  // the plane row of member i, clamped into [0, nseq - 1] as the fp32
  // kernel clamps it
  __device__ int member(const int* idx, int i) const {
    return min(max(idx[i], 0), nseq - 1);
  }
  __device__ int key_pos(int i) const { return pos_k[member(ki, i)]; }
  __device__ int row_tag(int row) const {
    return row < N ? pos_q[member(qi, row)] : -1;
  }
  __device__ bool tile_tags() const { return true; }
  __device__ void stage(int wg, int buf, int t, int j) const {
    const int p = j < N ? key_pos(j) : SENTINEL;
    pos[wg][buf][t] = p;
    const int m = __reduce_max_sync(0xffffffffu, p);
    if (t % 32 == 0) high[wg][buf][t / 32] = m;
  }
  __device__ bool edge(int wg, int buf, int) const {
    int m = high[wg][buf][0];
#pragma unroll
    for (int i = 1; i < KEYS / 32; ++i) m = max(m, high[wg][buf][i]);
    return causal ? m > qmin : m >= SENTINEL;
  }
  __device__ bool drop(int wg, int buf, int c, int, int row) const {
    return !gathered_keep(row, pos[wg][buf][c], causal);
  }
  __device__ void gather_own(void* qt) const {
    gather_rows<DH, FWD_ROWS>(qt, q, [&](int r) {
      return q0 + r < N ? member(qi, q0 + r) : -1;
    });
  }
  __device__ void gather_tile(void* kt, void* vt, int k0) const {
    auto row = [&](int r) {
      return k0 + r < N ? member(ki, k0 + r) : -1;
    };
    gather_rows<DH, KEYS>(kt, k, row);
    gather_rows<DH, KEYS>(vt, v, row);
  }
};

// One block a (cluster slot, 128 query members); the heaviest blocks (the
// last, under causality with sorted positions) first.
template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    routing_fused_wgmma(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ q_idx,
                        const int* __restrict__ k_idx,
                        const int* __restrict__ pos_q,
                        const int* __restrict__ pos_k,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int H, int N, int kc,
                        int w, int causal, float scale) {
  constexpr int KEYS = FusedFwd<DH>::KEYS;
  __shared__ int pos[2][2][KEYS];
  __shared__ int high[2][2][KEYS / 32];
  __shared__ int red[2][8];
  const size_t cl = blockIdx.x;   // cluster slot (b * H + h) * kc + c
  const size_t bh = cl / kc;
  const size_t plane = bh * N * DH;
  FusedFwd<DH> pol;
  pol.qplane = pol.kplane = blockIdx.x;   // the output's plane: the slot
  pol.q0 = (gridDim.y - 1 - blockIdx.y) * FWD_ROWS;
  pol.N = w;
  pol.causal = causal;
  pol.nseq = N;
  pol.qi = q_idx + cl * w;
  pol.ki = k_idx + cl * w;
  pol.pos_q = pos_q + bh / H * N;
  pol.pos_k = pos_k + bh / H * N;
  pol.q = q + plane;
  pol.k = k + plane;
  pol.v = v + plane;
  pol.pos = pos;
  pol.high = high;
  // the block's 128 query rows, one a thread of warps 0-3: the largest
  // position, and the smallest of each warpgroup (rows past w and warps
  // 4-7 move neither)
  const int tid = threadIdx.x;
  const int row = pol.q0 + tid;
  const bool mine = tid < FWD_ROWS && row < w;
  const int p = mine ? pol.row_tag(row) : 0;
  const sm90::BlockMinMax rows = sm90::block_min_max(
      mine ? p : INT_MAX, mine ? p : -1, red);
  const int qmax = rows.high;
  pol.qmin = rows.rows_low;
  sm90::walk(w, KEYS, red,
             [&](int i) {
               const int pk = pol.key_pos(i);
               return causal ? pk <= qmax : pk < SENTINEL;
             },
             pol.k_first, pol.ntiles);
  const CUtensorMap none{};   // the policy gathers; no tensor map is read
  sm90::fwd_body<DH>(none, none, none, o, lse, pol, scale);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v,
                const int* q_idx, const int* k_idx, const int* pos_q,
                const int* pos_k, void* o, float* lse, int BH, int H, int N,
                int kc, int w, int causal, float scale,
                cudaStream_t stream) {
  auto kernel = routing_fused_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::FwdSmemH<DH>>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH * kc, (w + FWD_ROWS - 1) / FWD_ROWS);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_idx, k_idx, pos_q, pos_k,
      static_cast<__nv_bfloat16*>(o), lse, H, N, kc, w, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v (B*H, N, dh) (k may be q: shared-QK), q_idx/k_idx (B*H, kc, w)
// int32, pos_q/pos_k (B, N) int32 (pos_k = SENTINEL for padded keys);
// o (B*H, kc, w, dh), lse (B*H, kc, w) fp32. dtype: 0 fp32, 1 bf16; dh 64,
// 128 or 192 (any other head dim comes zero-padded to one of them); scale
// the softmax scale, 1 / sqrt of the true head dim.
extern "C" int routing_fused_fwd(const void* q, const void* k, const void* v,
                                 const int* q_idx, const int* k_idx,
                                 const int* pos_q, const int* pos_k, void* o,
                                 float* lse, int BH, int H, int N, int kc,
                                 int w, int dh, int causal, int dtype,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_FWD(DH)                                                        \
  if (dh == DH && dtype == 1)                                                \
    return launch_bf16<DH>(q, k, v, q_idx, k_idx, pos_q, pos_k, o, lse, BH,  \
                           H, N, kc, w, causal, scale, s);                   \
  if (dh == DH && dtype == 0)                                                \
    return launch<float, DH>(q, k, v, q_idx, k_idx, pos_q, pos_k, o, lse,    \
                             BH, H, N, kc, w, causal, scale, s);
  FUSED_FWD(128)
  FUSED_FWD(64)
  FUSED_FWD(192)
#undef FUSED_FWD
  return cudaErrorInvalidValue;
}
