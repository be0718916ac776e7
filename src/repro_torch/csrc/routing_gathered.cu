// Gathered routed attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/routing_attention.py
// (forward of `routed_attention_blocks`). The caller has already gathered
// each cluster's member rows into contiguous blocks, as XLA does in the JAX
// package: q/k/v (n, w, dh) with n = B*H*k, and each row's original
// position (n, w) int32 (a padded key carries pos = SENTINEL = 2^30). One
// block of threads owns (cluster c, 64 query rows), walks the cluster's
// keys in tiles of 32 and runs an online softmax (`FlashTile`). The mask is
// causal on original positions (pos_q >= pos_k), or, non-causal, every key
// whose position is below SENTINEL. A row with no attendable key outputs 0.
// Writes out (n, w, dh) in q's type and lse = m + log(max(l, 1e-30)) fp32.
// Shared-QK passes the q blocks as k.
//
// What bounds it on this card: each cluster is a (w x w) problem of which
// the causal half is needed, ~4*dh flops per attended pair against q, k, v
// and out read or written once: ~85 flops per byte at w = 512 and dh 64 in
// bf16, under the bf16 ridge (~295), so device memory bounds an ideal
// kernel. This version computes all w^2 pairs with fp32 FMAs from shared
// memory, so it sits far from that bound; wgmma is a later step.
// What the design does about it: rows are contiguous, so each tile is one
// run of 16-byte vector loads; any w works (the ragged last tiles are
// masked: the TPU kernel asserts w % min(128, w) == 0, this one does not).
#include "common.cuh"

namespace {

using namespace rt;

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_gathered_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos_q, const int* __restrict__ pos_k,
    T* __restrict__ o, float* __restrict__ lse, int w, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FlashSmem<DH>*>(smem_raw);
  const size_t c = blockIdx.x;                 // cluster block
  const int q0 = blockIdx.y * BQ;
  const int qn = min(BQ, w - q0);
  const size_t base = c * w;                   // first row of the block
  const T* qb = q + base * DH;
  const T* kb = k + base * DH;
  const T* vb = v + base * DH;

  if (threadIdx.x < BQ) {
    const int r = threadIdx.x;
    sm.qpos[r] = r < qn ? pos_q[base + q0 + r] : 0;
  }
  load_rows<T, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const T* {
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
    auto krow = [&](const T* b) {
      return [=](int r) -> const T* {
        return r < nk ? b + static_cast<size_t>(k0 + r) * DH : nullptr;
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
  T* ob = o + base * DH;
  float* lb = lse + base;
  ft.template store<T>(
      [&](int row) -> T* {
        return row < qn ? ob + static_cast<size_t>(q0 + row) * DH : nullptr;
      },
      [&](int row) -> float* { return row < qn ? lb + q0 + row : nullptr; });
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* pos_q,
           const int* pos_k, void* o, float* lse, int n, int w, int causal,
           cudaStream_t stream) {
  auto kernel = routing_gathered_kernel<T, DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (w + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_q, pos_k, static_cast<T*>(o), lse, w,
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
    return launch<__nv_bfloat16, 128>(q, k, v, pos_q, pos_k, o, lse, n, w,
                                      causal, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, pos_q, pos_k, o, lse, n, w,
                                     causal, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, pos_q, pos_k, o, lse, n, w, causal, s);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, pos_q, pos_k, o, lse, n, w, causal, s);
  return cudaErrorInvalidValue;
}
