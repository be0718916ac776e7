// Dense (full) flash attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/flash_attention.py
// (forward of `flash_attention`). Query row i attends key row j of the
// same batch and kv head for every j (non-causal) or for j <= i (causal,
// on row indices also when M != N: the TPU kernel's `_causal_iota`, hence
// the backend's supports_positions=False). Scale 1/sqrt(dh). Emits the
// output in q's type and the per-row log-sum-exp m + log(max(l, 1e-30))
// in fp32. Any N, M >= 1; the ragged last tiles are masked.
//
// What bounds it on this card: per call 4*dh flops per attended pair
// against q, k, v and out read or written once; at qwen2's train shape
// (B 2, H 14, Hkv 2, N 4096, dh 64, causal, bf16) that is ~60 GFLOP per
// ~34 MB, far above the bf16 ridge (~295 flops per byte), so the tensor
// cores bound an ideal kernel (~0.06 ms). This version runs fp32 FMAs
// from shared memory (67 TFLOP/s peak, no tensor cores), so it sits far
// from that bound; wgmma is a later step.
// What the design does about it: a block of 64 query rows walks the key
// tiles of 32 rows with the online softmax of `FlashTile` (common.cuh),
// shared with the local-window and fused routing kernels. Causal key tiles
// wholly above the diagonal are skipped, not masked: the walk ends at the
// block's last query row, so the work is the causal half, not all N*M
// pairs. GQA goes through the kv-head index, no repeated k/v.
#include "common.cuh"

namespace {

using namespace rt;

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int N, int M,
    int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FlashSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const T* qb = q + static_cast<size_t>(bh) * N * DH;
  const T* kb = k + kvh * M * DH;
  const T* vb = v + kvh * M * DH;

  load_rows<T, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const T* {
    return r < qn ? qb + static_cast<size_t>(q0 + r) * DH : nullptr;
  });
  // causal: no key past the block's last query row
  const int kend = causal ? min(M, q0 + qn) : M;

  FlashTile<DH> ft;
  ft.init();
  for (int k0 = 0; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    auto krow = [&](const T* base) {
      return [=](int r) -> const T* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<T, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<T, DH, BK, DH>(&sm.v[0][0], krow(vb));
    __syncthreads();
    ft.consume(sm, nk, scale, [&](int row, int col) {
      return !causal || k0 + col <= q0 + row;
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int N, int M, int causal,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, N, M, causal,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q (B,H,N,dh), k/v (B,Hkv,M,dh); o like q, lse (B,H,N) fp32.
// dtype: 0 fp32, 1 bf16. Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int H, int Hkv, int N, int M, int dh,
                                   int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Hkv, N, M,
                                      causal, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Hkv, N, M,
                                     causal, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, o, lse, B, H, Hkv, N, M, causal, s);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, o, lse, B, H, Hkv, N, M, causal, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the forward kernels (the local,
// fused routing and flash forward kernels share FlashSmem), for reports;
// -1 for an unsupported dh.
extern "C" int forward_tile_smem_bytes(int dh) {
  if (dh == 128) return static_cast<int>(sizeof(FlashSmem<128>));
  if (dh == 64) return static_cast<int>(sizeof(FlashSmem<64>));
  return -1;
}
