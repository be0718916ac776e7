// Fused gather-free routed attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_f_dq_kernel` / `_f_dkv_kernel` (VMEM-resident
// plan) and `_p_dq_kernel` / `_p_dkv_kernel` (DMA-paged plan) of
// src/repro/kernels/routing_attention.py (backward of
// `routed_attention_fused`). As in the forward (csrc/routing_fused.cu),
// each block reads its own member indices and pulls member rows of q, k, v
// straight from the sequence-layout (B*H, N, dh) planes; the mask is on
// original positions (pos_q >= pos_k when causal; a padded key carries
// pos = SENTINEL = 2^30). p is recomputed from the forward's lse (see
// attn_bwd.cuh); do, lse and D are per-cluster (B*H, k, w[, dh]).
//
// dq kernel: one block per (batch*head, cluster, 64 query rows), walking
// the cluster's keys in tiles of 32: per-cluster dq (B*H, k, w, dh).
// dk/dv kernel: one block per (batch*head, cluster, 64 key rows), walking
// all of the cluster's queries in tiles of 32 (the TPU's swapped grid):
// per-cluster dk, dv (B*H, k, w, dh). All fp32. Shared-QK passes the q
// plane as k; the caller then adds the scattered dk to q's gradient. The
// scatter-add of these blocks to sequence layout (a token sits in up to k
// clusters) stays in PyTorch (`core.routing.scatter_add_rows`, in a fixed
// order), as the JAX package leaves it to XLA.
//
// What bounds it on this card: each cluster is a (w x w) problem whose
// causal half is needed, 6*dh (dq) or 8*dh (dk/dv) flops per pair against
// each member row read once and fp32 per-cluster gradients written: ~75
// flops per byte at w = 256, under the bf16 ridge (~295), so device memory
// bounds an ideal kernel. This version computes all w^2 pairs with fp32
// FMAs from shared memory, so it sits far from that bound; wgmma is a
// later step.
// What the design does about it: no gathered (B,H,k,w,dh) copy of q/k/v is
// written to device memory; rows are read by index once per tile. Hopper
// has no VMEM residency budget, so one kernel pair serves both of the
// TPU's memory plans, and any w works (the last tiles are masked).
#include "attn_bwd.cuh"

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
              int BH, int H, int N, int kc, int w, int causal,
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
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const int* q_idx,
               const int* k_idx, const int* pos_q, const int* pos_k,
               const void* dO, const float* lse, const float* dsum, float* dk,
               float* dv, int BH, int H, int N, int kc, int w, int causal,
               cudaStream_t stream) {
  auto kernel = routing_bwd_dkv_kernel<T, DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((w + BKR - 1) / BKR, kc, BH);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_idx, k_idx, pos_q, pos_k,
      static_cast<const T*>(dO), lse, dsum, dk, dv, H, N, kc, w, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q/k/v (B*H, N, dh) (k may be q: shared-QK), q_idx/k_idx (B*H, kc, w)
// int32, pos_q/pos_k (B, N) int32 (pos_k = SENTINEL for padded keys),
// dO (B*H, kc, w, dh), lse/dsum (B*H, kc, w) fp32; dq (B*H, kc, w, dh)
// fp32. dtype: 0 fp32, 1 bf16. Returns a cudaError_t code.
extern "C" int routing_fused_bwd_dq(const void* q, const void* k,
                                    const void* v, const int* q_idx,
                                    const int* k_idx, const int* pos_q,
                                    const int* pos_k, const void* dO,
                                    const float* lse, const float* dsum,
                                    float* dq, int BH, int H, int N, int kc,
                                    int w, int dh, int causal, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, q_idx, k_idx, pos_q, pos_k,
                                         dO, lse, dsum, dq, BH, H, N, kc, w,
                                         causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, q_idx, k_idx, pos_q, pos_k,
                                        dO, lse, dsum, dq, BH, H, N, kc, w,
                                        causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dq<float, 128>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO, lse,
                                 dsum, dq, BH, H, N, kc, w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dq<float, 64>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO, lse,
                                dsum, dq, BH, H, N, kc, w, causal, s);
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
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, q_idx, k_idx, pos_q, pos_k,
                                          dO, lse, dsum, dk, dv, BH, H, N, kc,
                                          w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, q_idx, k_idx, pos_q, pos_k,
                                         dO, lse, dsum, dk, dv, BH, H, N, kc,
                                         w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dkv<float, 128>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO,
                                  lse, dsum, dk, dv, BH, H, N, kc, w, causal,
                                  s);
  if (dtype == 0 && dh == 64)
    return launch_dkv<float, 64>(q, k, v, q_idx, k_idx, pos_q, pos_k, dO, lse,
                                 dsum, dk, dv, BH, H, N, kc, w, causal, s);
  return cudaErrorInvalidValue;
}
