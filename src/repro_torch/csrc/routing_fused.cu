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
// outputs (B*H, k, w, dh) and the lse (B*H, k, w).
//
// What bounds it on this card: each cluster is a dense (w x w) attention,
// 4*w*dh flops per query against 3*dh*2 bytes of gathered rows: w = 64 at
// N = 2048 and 256 at N = 8192, ~85..340 flops per byte, at or above the
// bf16 ridge (~295), so tensor-core throughput is the bound at long N and
// memory at short N. This version runs fp32 FMAs, so its bound is the FMA
// rate for now; wgmma is a later step.
// What the design does about it: no gathered (B,H,k,w,dh) copy of q/k/v is
// written to device memory; rows are read by index once per query tile.
// Hopper has no VMEM residency budget, so one kernel serves both of the
// TPU's memory plans, and any w works (the last tiles are masked).
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
           cudaStream_t stream) {
  auto kernel = routing_fused_kernel<T, DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((w + BQ - 1) / BQ, kc, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_idx, k_idx, pos_q, pos_k,
      static_cast<T*>(o), lse, H, N, kc, w, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q/k/v (B*H, N, dh) (k may be q: shared-QK), q_idx/k_idx (B*H, kc, w)
// int32, pos_q/pos_k (B, N) int32 (pos_k = SENTINEL for padded keys);
// o (B*H, kc, w, dh), lse (B*H, kc, w) fp32. dtype: 0 fp32, 1 bf16.
extern "C" int routing_fused_fwd(const void* q, const void* k, const void* v,
                                 const int* q_idx, const int* k_idx,
                                 const int* pos_q, const int* pos_k, void* o,
                                 float* lse, int BH, int H, int N, int kc,
                                 int w, int dh, int causal, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, q_idx, k_idx, pos_q, pos_k, o,
                                      lse, BH, H, N, kc, w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, q_idx, k_idx, pos_q, pos_k, o,
                                     lse, BH, H, N, kc, w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, q_idx, k_idx, pos_q, pos_k, o, lse, BH,
                              H, N, kc, w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, q_idx, k_idx, pos_q, pos_k, o, lse, BH,
                             H, N, kc, w, causal, s);
  return cudaErrorInvalidValue;
}
