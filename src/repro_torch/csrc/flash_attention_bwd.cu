// Dense (full) flash attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// src/repro/kernels/flash_attention.py (backward of `flash_attention`).
// The mask is the forward's (csrc/flash_attention.cu): every key, or
// key row j <= query row i when causal. p is recomputed from the
// forward's lse and masked explicitly (see attn_bwd.cuh).
//
// dq kernel: one block per (batch*head, 64 query rows); it walks the key
// tiles of 32 rows up to the block's last query row (causal) or to M,
// dq = ds . K. dk/dv kernel: one block per (batch*query head, 64 key
// rows); it walks the query tiles of 32 rows from the block's first key
// row (causal) or from 0, to N. Causal tiles wholly above the diagonal
// are skipped, not masked. dk and dv come out per *query* head, fp32; the
// wrapper sums each kv head's query group (GQA), as the JAX package does
// in XLA. D = rowsum(do * out) is computed outside.
//
// What bounds it on this card: the dq kernel needs 6*dh flops per
// attended pair and the dk/dv kernel 8*dh; at qwen2's train shape
// (B 2, H 14, Hkv 2, N 4096, dh 64, causal) that is ~90 and ~120 GFLOP
// against ~65 and ~95 MB read or written once: far above the bf16 ridge, so
// the tensor cores bound an ideal kernel (~0.09 / ~0.12 ms). This version
// runs fp32 FMAs from shared memory (67 TFLOP/s peak), the tiles of the
// local-window and fused routing backward kernels; wgmma is a later step.
#include "attn_bwd.cuh"

namespace {

using namespace rt;

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dq, int H, int Hkv,
    int N, int M, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const size_t plane = static_cast<size_t>(bh) * N;
  const T* kb = k + kvh * M * DH;
  const T* vb = v + kvh * M * DH;

  auto qrows = [&](const T* base) {
    return [=](int r) -> const T* {
      return r < qn ? base + (plane + q0 + r) * DH : nullptr;
    };
  };
  load_rows<T, DH, BQ, DH + 1>(&sm.q[0][0], qrows(q));
  load_rows<T, DH, BQ, DH + 1>(&sm.dO[0][0], qrows(dO));
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
    auto krow = [&](const T* base) {
      return [=](int r) -> const T* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<T, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<T, DH, BK, DH + 1>(&sm.v[0][0], krow(vb));
    __syncthreads();
    t.consume(sm, nk, scale, [&](int row, int col) {
      return !causal || k0 + col <= q0 + row;
    });
  }
  t.store([&](int row) -> float* {
    return row < qn ? dq + (plane + q0 + row) * DH : nullptr;
  });
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Hkv, int N, int M, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int k0 = blockIdx.x * BKR;
  const int kn = min(BKR, M - k0);
  const size_t plane = static_cast<size_t>(bh) * N;

  auto krow = [&](const T* base) {
    return [=](int r) -> const T* {
      return r < kn ? base + (kvh * M + k0 + r) * DH : nullptr;
    };
  };
  load_rows<T, DH, BKR, DH + 1>(&sm.k[0][0], krow(k));
  load_rows<T, DH, BKR, DH + 1>(&sm.v[0][0], krow(v));
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
    auto qrows = [&](const T* base) {
      return [=](int r) -> const T* {
        return r < nq ? base + (plane + q0 + r) * DH : nullptr;
      };
    };
    load_rows<T, DH, BQT, DH + 1>(&sm.q[0][0], qrows(q));
    load_rows<T, DH, BQT, DH + 1>(&sm.dO[0][0], qrows(dO));
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

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* dsum, float* dq, int B, int H,
              int Hkv, int N, int M, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, dsum, dq, H,
      Hkv, N, M, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* dsum, float* dk, float* dv,
               int B, int H, int Hkv, int N, int M, int causal,
               cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BKR - 1) / BKR, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, dsum, dk, dv,
      H, Hkv, N, M, causal, 1.0f / sqrtf(static_cast<float>(DH)));
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
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dO, lse, dsum, dq, B, H,
                                         Hkv, N, M, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dO, lse, dsum, dq, B, H, Hkv,
                                        N, M, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dq<float, 128>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M,
                                 causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dq<float, 64>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M,
                                causal, s);
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
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dO, lse, dsum, dk, dv, B,
                                          H, Hkv, N, M, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dO, lse, dsum, dk, dv, B, H,
                                         Hkv, N, M, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dkv<float, 128>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv,
                                  N, M, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dkv<float, 64>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N,
                                 M, causal, s);
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
