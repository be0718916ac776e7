// Blocked local (sliding-window) attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/local_attention.py
// (forward of `local_attention_kernel`). Query i (block b = i / w) attends
// key j when j lies in block b-1 or b (also b+1 when non-causal), j <= i
// when causal, and j is a valid key (optional pad mask). Emits the output
// and the per-row log-sum-exp. Rows with no valid key output 0.
//
// What bounds it on this card: at the serving shapes (w = 256, dh = 128)
// each query meets ~w..2w keys, about 4*dh*1.5w flops per query against
// 4*dh bytes in and out: a few hundred flops per byte, above the H100's
// bf16 ridge (~295), so tensor-core throughput is the bound. This version
// runs fp32 FMAs (67 TFLOP/s peak), so it sits well under that bound;
// wgmma is a later step.
// What the design does about it: the TPU kernel takes one softmax over the
// whole (w x 2w) score tile in VMEM; here a block of 64 queries walks its
// key range in tiles of 32 with an online softmax, so shared memory is
// bounded by the tile sizes and not by w (w = 2048 of rt-imagenet64 fits
// as well). GQA goes through the kv-head index; a ragged last block and the
// pad mask are masked in the kernel, so every prefill call can take it.
#include "common.cuh"

namespace {

using namespace rt;

template <typename T, int DH>
__global__ void __launch_bounds__(NT) local_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kvalid, T* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int N, int w, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FlashSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const T* qb = q + static_cast<size_t>(bh) * N * DH;
  const T* kb = k + kvh * N * DH;
  const T* vb = v + kvh * N * DH;

  load_rows<T, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const T* {
    return r < qn ? qb + static_cast<size_t>(q0 + r) * DH : nullptr;
  });
  const int qlast = q0 + qn - 1;
  const int kstart = max(0, (q0 / w - 1) * w);
  const int kend = causal ? qlast + 1 : min(N, (qlast / w + 2) * w);

  FlashTile<DH> ft;
  ft.init();
  for (int k0 = kstart; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      const bool ok = threadIdx.x < nk &&
                      (kvalid == nullptr || kvalid[static_cast<size_t>(b) * N + j]);
      sm.kpos[threadIdx.x] = ok ? j : -1;
    }
    auto krow = [&](const T* base) {
      return [=](int r) -> const T* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<T, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<T, DH, BK, DH>(&sm.v[0][0], krow(vb));
    __syncthreads();
    ft.consume(sm, nk, scale, [&](int row, int col) {
      const int i = q0 + row, j = sm.kpos[col];
      if (j < 0) return false;
      const int qblk = i / w, kblk = j / w;
      const bool near = kblk == qblk || kblk == qblk - 1 ||
                        (!causal && kblk == qblk + 1);
      return near && (!causal || j <= i);
    });
  }
  T* ob = o + static_cast<size_t>(bh) * N * DH;
  float* lb = lse + static_cast<size_t>(bh) * N;
  ft.template store<T>(
      [&](int row) -> T* {
        return row < qn ? ob + static_cast<size_t>(q0 + row) * DH : nullptr;
      },
      [&](int row) -> float* { return row < qn ? lb + q0 + row : nullptr; });
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const uint8_t* kvalid,
           void* o, float* lse, int B, int H, int Hkv, int N, int w,
           int causal, cudaStream_t stream) {
  auto kernel = local_fwd_kernel<T, DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kvalid, static_cast<T*>(o), lse, H, Hkv, N,
      w, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q (B,H,N,dh), k/v (B,Hkv,N,dh), kvalid (B,N) uint8 or null; o like q,
// lse (B,H,N) fp32. dtype: 0 fp32, 1 bf16. Returns a cudaError_t code.
extern "C" int local_attention_fwd(const void* q, const void* k,
                                   const void* v, const uint8_t* kvalid,
                                   void* o, float* lse, int B, int H, int Hkv,
                                   int N, int dh, int w, int causal,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, kvalid, o, lse, B, H, Hkv, N,
                                      w, causal, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, kvalid, o, lse, B, H, Hkv, N,
                                     w, causal, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, kvalid, o, lse, B, H, Hkv, N, w,
                              causal, s);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, kvalid, o, lse, B, H, Hkv, N, w,
                             causal, s);
  return cudaErrorInvalidValue;
}
