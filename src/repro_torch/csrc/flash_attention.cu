// Dense (full) flash attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/flash_attention.py
// (:47, its `pallas_call` :181; the forward of `flash_attention`). Query
// row i attends key row j of the same batch and kv head for every j
// (non-causal) or for j <= i (causal, on row indices also when M != N: the
// TPU kernel's `_causal_iota`, hence the backend's
// supports_positions=False). The scale comes from the caller: 1/sqrt of
// the true head dim, which the wrapper pads to the next instance with zero
// columns (dh 64 or 128; in bf16 also 80, hubert-xlarge's heads, which
// run at their own width). Emits the output in q's type and the per-row
// log-sum-exp m + log(max(l, 1e-30)) in fp32. Any N, M >= 1; the ragged
// last tiles are masked. GQA goes through the kv-head index, no repeated
// k/v.
//
// What bounds it on this card: 4*dh flops per attended pair against q, k,
// v and out read or written once; at qwen2's train shape (B 2, H 14, Hkv
// 2, N 4096, dh 64, causal, bf16) that is ~60 GFLOP per ~34 MB, far above
// the bf16 ridge (~295 flops per byte), so the tensor cores bound it
// (~0.06 ms); at hubert-xlarge's (B 2, H 16, N 4096, dh 80, non-causal)
// ~172 GFLOP, 0.1737 ms.
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64, 80 and 128): `flash_fwd_wgmma`, on the tensor cores with
// the body of attn_fwd_sm90.cuh, which the local-window and gathered
// routing forwards share (the design is described there: 128 query rows a
// block, Q loaded once by TMA, 128-row K/V tiles through a ring, S = Q K^T
// and O += P V by wgmma, P rounded to bf16 once; a tile's exponentials do
// not overlap the next tile's products, and at dh 80 they cost ~83% as
// much as the products). Flash's policy (`FlashFwd`) masks on row indices:
// only tiles that cross the diagonal or the ragged end of the keys are
// masked; causal key tiles wholly above the diagonal are neither loaded
// nor computed, so the work is the causal half of the N*M pairs. The
// heaviest query blocks (the last ones, under causality) start first. The
// output is rounded to bf16 once.
// At dh 80 the tensor maps take the rows at their true width (160 bytes,
// a multiple of the 16 TMA's strides need): each tile row is two 64-column
// boxes, the second filled with zeros past column 80 by TMA, so no padded
// copy exists in device memory; S runs five k16 steps, O += P V is
// m64n80k16, and out is written 80 wide. The dh-128 instance on
// zero-padded inputs did 1.6x these products and took three pad copies
// and a cut per call; zero columns add exact zeros to S, and chip_smoke.py
// holds the two to the same bits.
//
// fp32: `flash_fwd_kernel`, fp32 FMAs from shared memory with the online
// softmax of `FlashTile` (common.cuh), shared with the local-window and
// fused routing kernels: a block of 64 query rows walks key tiles of 32
// rows, skipping those above the diagonal. It keeps full fp32 products,
// as PyTorch's fp32 matmul does (no TF32), at the FMA rate (67 TFLOP/s
// peak).
#include "attn_fwd_sm90.cuh"
#include "common.cuh"

namespace {

using namespace rt;

template <int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int N, int M, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FlashSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const float* qb = q + static_cast<size_t>(bh) * N * DH;
  const float* kb = k + kvh * M * DH;
  const float* vb = v + kvh * M * DH;

  load_rows<float, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const float* {
    return r < qn ? qb + static_cast<size_t>(q0 + r) * DH : nullptr;
  });
  // causal: no key past the block's last query row
  const int kend = causal ? min(M, q0 + qn) : M;

  FlashTile<DH> ft;
  ft.init();
  for (int k0 = 0; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    auto krow = [&](const float* base) {
      return [=](int r) -> const float* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<float, DH, BK, DH>(&sm.v[0][0], krow(vb));
    __syncthreads();
    ft.consume(sm, nk, scale, [&](int row, int col) {
      return !causal || k0 + col <= q0 + row;
    });
  }
  float* ob = o + static_cast<size_t>(bh) * N * DH;
  float* lb = lse + static_cast<size_t>(bh) * N;
  ft.template store<float>(
      [&](int row) -> float* {
        return row < qn ? ob + static_cast<size_t>(q0 + row) * DH : nullptr;
      },
      [&](int row) -> float* { return row < qn ? lb + q0 + row : nullptr; });
}

template <int DH>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hkv, int N, int M, int causal,
                float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, N,
      M, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the body is attn_fwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::FWD_KEYS;
using sm90::FWD_ROWS;

// Causality on row indices: query row i keeps key rows j <= i (every j
// < M when not causal). Only tiles that cross the diagonal or the keys'
// ragged end are masked; the walk stops at the block's last row.
struct FlashFwd {
  static constexpr bool kNoKeyRows = false;
  int qplane, kplane, q0, N, k_first, ntiles, M, causal;
  __device__ int row_tag(int row) const { return row; }
  __device__ static constexpr bool tile_tags() { return false; }
  __device__ void stage(int, int, int, int) const {}
  __device__ bool edge(int wg, int, int k0) const {
    return k0 + FWD_KEYS > M ||
           (causal && k0 + FWD_KEYS - 1 > q0 + 64 * wg);
  }
  __device__ bool drop(int, int, int, int col, int row) const {
    return col >= M || (causal && col > row);
  }
};

// The heaviest query blocks (the last ones, under causality) first.
template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int N, int M, int causal,
    float scale) {
  FlashFwd pol;
  pol.qplane = blockIdx.y;
  pol.kplane = (blockIdx.y / H) * Hkv + (blockIdx.y % H) / (H / Hkv);
  pol.q0 = (gridDim.x - 1 - blockIdx.x) * FWD_ROWS;
  pol.N = N;
  pol.M = M;
  pol.causal = causal;
  pol.k_first = 0;
  // causal: no key past the block's last query row
  const int kend = causal ? min(M, pol.q0 + min(FWD_ROWS, N - pol.q0)) : M;
  pol.ntiles = (kend + FWD_KEYS - 1) / FWD_KEYS;
  sm90::fwd_body<DH>(tq, tk, tv, o, lse, pol, scale);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hkv, int N, int M, int causal,
                float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = sm90::map_rows(&tq, q, B * H, N, DH, FWD_ROWS);
  if (err == cudaSuccess)
    err = sm90::map_rows(&tk, k, B * Hkv, M, DH, FWD_KEYS);
  if (err == cudaSuccess)
    err = sm90::map_rows(&tv, v, B * Hkv, M, DH, FWD_KEYS);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::FwdSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + FWD_ROWS - 1) / FWD_ROWS, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, N, M, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,N,dh), k/v (B,Hkv,M,dh); o like q, lse (B,H,N) fp32.
// dtype: 0 fp32, 1 bf16; dh 64 or 128, and 80 in bf16. scale: the
// softmax scale, 1 / sqrt of the true head dim (the wrapper runs another
// head dim zero-padded to dh). Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int H, int Hkv, int N, int M, int dh,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_bf16<128>(q, k, v, o, lse, B, H, Hkv, N, M, causal, scale,
                            s);
  if (dtype == 1 && dh == 80)
    return launch_bf16<80>(q, k, v, o, lse, B, H, Hkv, N, M, causal, scale,
                           s);
  if (dtype == 1 && dh == 64)
    return launch_bf16<64>(q, k, v, o, lse, B, H, Hkv, N, M, causal, scale,
                           s);
  if (dtype == 0 && dh == 128)
    return launch_fp32<128>(q, k, v, o, lse, B, H, Hkv, N, M, causal, scale,
                            s);
  if (dtype == 0 && dh == 64)
    return launch_fp32<64>(q, k, v, o, lse, B, H, Hkv, N, M, causal, scale,
                           s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the FMA forward tile FlashSmem
// (the local, fused routing and fp32 flash forward kernels share it), for
// reports; -1 for an unsupported dh.
extern "C" int forward_tile_smem_bytes(int dh) {
  if (dh == 128) return static_cast<int>(sizeof(FlashSmem<128>));
  if (dh == 64) return static_cast<int>(sizeof(FlashSmem<64>));
  return -1;
}

// Dynamic shared memory of one block of the bf16 flash forward on the
// tensor cores (Q, two K/V stages, barriers, alignment room; dh 80 takes
// dh 128's, two boxes a row), for reports; -1 for an unsupported dh.
extern "C" int flash_fwd_wgmma_smem_bytes(int dh) {
  using sm90::aligned_smem_bytes;
  using sm90::FwdSmemH;
  if (dh == 128) return static_cast<int>(aligned_smem_bytes<FwdSmemH<128>>());
  if (dh == 80) return static_cast<int>(aligned_smem_bytes<FwdSmemH<80>>());
  if (dh == 64) return static_cast<int>(aligned_smem_bytes<FwdSmemH<64>>());
  return -1;
}
