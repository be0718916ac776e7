// Blocked local (sliding-window) attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// src/repro/kernels/local_attention.py (backward of
// `local_attention_kernel`). The mask is the forward's (csrc/
// local_attention.cu): query i (block b = i / w) attends key j when j lies
// in block b-1 or b (also b+1 when non-causal), j <= i when causal, and j
// is a valid key (optional pad mask). p is recomputed from the forward's
// lse (see attn_bwd.cuh).
//
// dq kernel: one block per (batch*head, 64 query rows); it walks the key
// range of its rows in tiles of 32, dq = ds . K. dk/dv kernel: one block
// per (batch*query head, 64 key rows); key j is attended by the queries of
// blocks blk(j) .. blk(j)+1 (blk(j)-1 .. blk(j)+1 non-causal), which it
// walks in tiles of 32. dk and dv come out per *query* head, fp32; the
// wrapper sums each kv head's query group (GQA), as the JAX package does
// in XLA.
//
// What bounds it on this card: per query ~1.5w keys at w = 256, dh = 128;
// the dq kernel needs 6*dh flops per attended pair and the dk/dv kernel
// 8*dh, against each bf16 row read once and the fp32 gradients written:
// ~190 flops per byte, under the bf16 ridge (~295), so device memory
// bounds an ideal kernel. This version runs fp32 FMAs from shared memory
// (67 TFLOP/s peak) and re-reads rows per tile, so it sits far from that
// bound; wgmma is a later step.
// What the design does about it: the TPU kernels hold the whole (w x 2w)
// tile in VMEM; here both kernels tile keys and queries (shared memory
// bounded by the tiles, not by w), mask the ragged last block and the pad
// mask themselves and take the kv head from the query head, so they take
// every input the forward kernel takes.
#include "attn_bwd.cuh"

namespace {

using namespace rt;

// Whether query i may attend key j (j < 0: padded key).
__device__ __forceinline__ bool local_keep(int i, int j, int w, int causal) {
  if (j < 0) return false;
  const int qblk = i / w, kblk = j / w;
  const bool near = kblk == qblk || kblk == qblk - 1 ||
                    (!causal && kblk == qblk + 1);
  return near && (!causal || j <= i);
}

// Whether key j of batch row b is a real token (no pad mask: all are).
__device__ __forceinline__ bool key_valid(const uint8_t* kvalid, int b, int N,
                                          int j) {
  return kvalid == nullptr || kvalid[static_cast<size_t>(b) * N + j];
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) local_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, const uint8_t* __restrict__ kvalid,
    float* __restrict__ dq, int H, int Hkv, int N, int w, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const size_t plane = static_cast<size_t>(bh) * N;
  const T* kb = k + kvh * N * DH;
  const T* vb = v + kvh * N * DH;

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
  const int qlast = q0 + qn - 1;
  const int kstart = max(0, (q0 / w - 1) * w);
  const int kend = causal ? qlast + 1 : min(N, (qlast / w + 2) * w);

  DqTile<DH> t;
  t.init();
  for (int k0 = kstart; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      const bool ok = threadIdx.x < nk && key_valid(kvalid, b, N, j);
      sm.kpos[threadIdx.x] = ok ? j : -1;
    }
    auto krow = [&](const T* base) {
      return [=](int r) -> const T* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<T, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<T, DH, BK, DH + 1>(&sm.v[0][0], krow(vb));
    __syncthreads();
    t.consume(sm, nk, scale, [&](int row, int col) {
      return local_keep(q0 + row, sm.kpos[col], w, causal);
    });
  }
  t.store([&](int row) -> float* {
    return row < qn ? dq + (plane + q0 + row) * DH : nullptr;
  });
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) local_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ dsum, const uint8_t* __restrict__ kvalid,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int N,
    int w, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int k0 = blockIdx.x * BKR;
  const int kn = min(BKR, N - k0);
  const size_t plane = static_cast<size_t>(bh) * N;

  if (threadIdx.x < BKR) {
    const int r = threadIdx.x, j = k0 + r;
    const bool ok = r < kn && key_valid(kvalid, b, N, j);
    sm.kpos[r] = ok ? j : -1;
  }
  auto krow = [&](const T* base) {
    return [=](int r) -> const T* {
      return r < kn ? base + (kvh * N + k0 + r) * DH : nullptr;
    };
  };
  load_rows<T, DH, BKR, DH + 1>(&sm.k[0][0], krow(k));
  load_rows<T, DH, BKR, DH + 1>(&sm.v[0][0], krow(v));
  const int klast = k0 + kn - 1;
  const int qs = causal ? k0 : max(0, (k0 / w - 1) * w);
  const int qe = min(N, (klast / w + 2) * w);

  DkvTile<DH> t;
  t.init();
  for (int q0 = qs; q0 < qe; q0 += BQT) {
    const int nq = min(BQT, qe - q0);
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
      return local_keep(q0 + col, sm.kpos[row], w, causal);
    });
  }
  t.store(
      [&](int row) -> float* {
        return row < kn ? dk + (plane + k0 + row) * DH : nullptr;
      },
      [&](int row) -> float* {
        return row < kn ? dv + (plane + k0 + row) * DH : nullptr;
      });
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* dsum, const uint8_t* kvalid,
              float* dq, int B, int H, int Hkv, int N, int w, int causal,
              cudaStream_t stream) {
  auto kernel = local_bwd_dq_kernel<T, DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, dsum, kvalid,
      dq, H, Hkv, N, w, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* dsum, const uint8_t* kvalid,
               float* dk, float* dv, int B, int H, int Hkv, int N, int w,
               int causal, cudaStream_t stream) {
  auto kernel = local_bwd_dkv_kernel<T, DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BKR - 1) / BKR, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, dsum, kvalid,
      dk, dv, H, Hkv, N, w, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q/do (B,H,N,dh), k/v (B,Hkv,N,dh), lse/dsum (B,H,N) fp32, kvalid (B,N)
// uint8 or null; dq (B,H,N,dh) fp32. dtype: 0 fp32, 1 bf16. Returns a
// cudaError_t code.
extern "C" int local_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const float* lse, const float* dsum,
                                      const uint8_t* kvalid, float* dq, int B,
                                      int H, int Hkv, int N, int dh, int w,
                                      int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dO, lse, dsum, kvalid, dq,
                                         B, H, Hkv, N, w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dO, lse, dsum, kvalid, dq, B,
                                        H, Hkv, N, w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dq<float, 128>(q, k, v, dO, lse, dsum, kvalid, dq, B, H,
                                 Hkv, N, w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dq<float, 64>(q, k, v, dO, lse, dsum, kvalid, dq, B, H, Hkv,
                                N, w, causal, s);
  return cudaErrorInvalidValue;
}

// As above; dk/dv (B,H,N,dh) fp32 per query head.
extern "C" int local_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const float* lse, const float* dsum,
                                       const uint8_t* kvalid, float* dk,
                                       float* dv, int B, int H, int Hkv, int N,
                                       int dh, int w, int causal, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dO, lse, dsum, kvalid, dk,
                                          dv, B, H, Hkv, N, w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dO, lse, dsum, kvalid, dk,
                                         dv, B, H, Hkv, N, w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_dkv<float, 128>(q, k, v, dO, lse, dsum, kvalid, dk, dv, B,
                                  H, Hkv, N, w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_dkv<float, 64>(q, k, v, dO, lse, dsum, kvalid, dk, dv, B, H,
                                 Hkv, N, w, causal, s);
  return cudaErrorInvalidValue;
}
