// Gathered routed attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_g_dq_kernel` and `_g_dkv_kernel` of
// src/repro/kernels/routing_attention.py (backward of
// `routed_attention_blocks`). As in the forward (csrc/routing_gathered.cu)
// the inputs are contiguous gathered cluster blocks: q/k/v and do
// (n, w, dh), positions (n, w) int32 (a padded key carries pos = SENTINEL
// = 2^30), the forward's lse and D = rowsum(do * out) (n, w) fp32, D taken
// outside the kernels as `_g_bwd_call` does. p is recomputed from the lse
// and masked explicitly (see attn_bwd.cuh).
//
// dq kernel: one block per (cluster, 64 query rows), walking the
// cluster's keys in tiles of 32 (`DqTile`): dq (n, w, dh) fp32.
// dk/dv kernel: one block per (cluster, 64 key rows), walking all of the
// cluster's queries in tiles of 32 (`DkvTile`; the TPU's swapped grid:
// key tile parallel, query sweep sequential): dk, dv (n, w, dh) fp32.
// Shared-QK passes the q blocks as k; the caller's autograd then adds dk
// to q's gradient, and the scatter of the block gradients back to
// sequence layout is the backward of the caller's gather.
//
// What bounds it on this card: 6*dh (dq) or 8*dh (dk/dv) flops per
// attended pair against each block row read once and fp32 gradients
// written: under the bf16 ridge (~295 flops per byte) at w = 512, dh 64,
// so device memory bounds an ideal kernel. This version computes all w^2
// pairs with fp32 FMAs from shared memory, so it sits far from that bound;
// wgmma is a later step.
// What the design does about it: rows are contiguous (one run of 16-byte
// vector loads per tile), and any w works (ragged tiles are masked).
#include "attn_bwd.cuh"

namespace {

using namespace rt;

__device__ __forceinline__ bool gathered_keep(int pq, int pk, int causal) {
  return causal ? pq >= pk : pk < SENTINEL;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_gathered_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos_q, const int* __restrict__ pos_k,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq, int w,
    int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * w;
  const int q0 = blockIdx.y * BQ;
  const int qn = min(BQ, w - q0);
  const T* kb = k + base * DH;
  const T* vb = v + base * DH;

  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    sm.qpos[r] = r < qn ? pos_q[base + q0 + r] : 0;
    sm.lse[r] = r < qn ? lse[base + q0 + r] : 0.f;
    sm.dsum[r] = r < qn ? dsum[base + q0 + r] : 0.f;
  }
  auto qrow = [&](const T* b) {
    return [=](int r) -> const T* {
      return r < qn ? b + (base + q0 + r) * DH : nullptr;
    };
  };
  load_rows<T, DH, BQ, DH + 1>(&sm.q[0][0], qrow(q));
  load_rows<T, DH, BQ, DH + 1>(&sm.dO[0][0], qrow(dO));

  DqTile<DH> t;
  t.init();
  for (int k0 = 0; k0 < w; k0 += BK) {
    const int nk = min(BK, w - k0);
    if (threadIdx.x < BK) {
      const int r = threadIdx.x;
      sm.kpos[r] = r < nk ? pos_k[base + k0 + r] : SENTINEL;
    }
    auto krow = [&](const T* b) {
      return [=](int r) -> const T* {
        return r < nk ? b + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<T, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<T, DH, BK, DH + 1>(&sm.v[0][0], krow(vb));
    __syncthreads();
    t.consume(sm, nk, scale, [&](int row, int col) {
      return gathered_keep(sm.qpos[row], sm.kpos[col], causal);
    });
  }
  t.store([&](int row) -> float* {
    return row < qn ? dq + (base + q0 + row) * DH : nullptr;
  });
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_gathered_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos_q, const int* __restrict__ pos_k,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, int w, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * w;
  const int k0 = blockIdx.y * BKR;
  const int kn = min(BKR, w - k0);

  if (threadIdx.x < BKR) {
    const int r = threadIdx.x;
    sm.kpos[r] = r < kn ? pos_k[base + k0 + r] : SENTINEL;
  }
  auto krow = [&](const T* b) {
    return [=](int r) -> const T* {
      return r < kn ? b + (base + k0 + r) * DH : nullptr;
    };
  };
  load_rows<T, DH, BKR, DH + 1>(&sm.k[0][0], krow(k));
  load_rows<T, DH, BKR, DH + 1>(&sm.v[0][0], krow(v));

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
    auto qrow = [&](const T* b) {
      return [=](int r) -> const T* {
        return r < nq ? b + (base + q0 + r) * DH : nullptr;
      };
    };
    load_rows<T, DH, BQT, DH + 1>(&sm.q[0][0], qrow(q));
    load_rows<T, DH, BQT, DH + 1>(&sm.dO[0][0], qrow(dO));
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

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const int* pos_q,
              const int* pos_k, const void* dO, const float* lse,
              const float* dsum, float* dq, int n, int w, int causal,
              cudaStream_t stream) {
  auto kernel = routing_gathered_dq_kernel<T, DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_q, pos_k, static_cast<const T*>(dO), lse,
      dsum, dq, w, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const int* pos_q,
               const int* pos_k, const void* dO, const float* lse,
               const float* dsum, float* dk, float* dv, int n, int w,
               int causal, cudaStream_t stream) {
  auto kernel = routing_gathered_dkv_kernel<T, DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + BKR - 1) / BKR);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_q, pos_k, static_cast<const T*>(dO), lse,
      dsum, dk, dv, w, causal, 1.0f / sqrtf(static_cast<float>(DH)));
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
    return launch_dq<__nv_bfloat16, 128>(q, k, v, pos_q, pos_k, dO, lse, dsum,
                                         dq, n, w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, pos_q, pos_k, dO, lse, dsum,
                                        dq, n, w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dq<float, 128>(q, k, v, pos_q, pos_k, dO, lse, dsum, dq, n,
                                 w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dq<float, 64>(q, k, v, pos_q, pos_k, dO, lse, dsum, dq, n,
                                w, causal, s);
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
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, pos_q, pos_k, dO, lse,
                                          dsum, dk, dv, n, w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, pos_q, pos_k, dO, lse,
                                         dsum, dk, dv, n, w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dkv<float, 128>(q, k, v, pos_q, pos_k, dO, lse, dsum, dk,
                                  dv, n, w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dkv<float, 64>(q, k, v, pos_q, pos_k, dO, lse, dsum, dk,
                                 dv, n, w, causal, s);
  return cudaErrorInvalidValue;
}
