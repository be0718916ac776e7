// Blocked local (sliding-window) attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/local_attention.py
// (:34, its `pallas_call` :156; the forward of `local_attention_kernel`).
// Query i (block b = i / w) attends key j when j lies in block b-1 or b
// (also b+1 when non-causal), j <= i when causal, and j is a valid key
// (optional (B, N) pad mask). Emits the output in q's type and the per-row
// log-sum-exp in fp32. Rows with no valid key output 0 and lse
// NEG + log(1e-30). GQA goes through the kv-head index, no repeated k/v;
// a ragged last block and the pad mask are masked in the kernel, so every
// prefill call can take it.
//
// What bounds it on this card: each query meets ~w..2w keys (causal), 4*dh
// flops per kept pair against its q, k, v and out rows read or written
// once. At rt-enwik8's serving shape (w 256, dh 128, bf16) that is ~190
// flops per byte, under the bf16 ridge (~295), so device memory bounds an
// ideal kernel; at rt-cifar10's (w 512, dh 64) ~1.3e8 kept pairs a head
// set of B 8 x H 8 x N 3072 take ~0.035 ms of tensor-core time against
// ~0.030 ms of bytes, so the operations bound it, and the exponentials
// (one per kept pair, on the SFU) take about as long as the products.
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64, 128, 192 and 256): `local_fwd_wgmma`, on the tensor cores
// with the flash forward's body (attn_fwd_sm90.cuh: 128 query rows a
// block, Q loaded once by TMA, 128-row K/V tiles through a ring (64-row at
// dh 192 and 256, to fit shared memory), S = Q K^T and O += P V by wgmma,
// P rounded to bf16 once; at dh 256, recurrentgemma-9b's, O is a 64 x 256
// fp32 accumulator a warpgroup, 128 registers a thread, and P V one
// m64n256k16 chain). The dh-192 instance serves any head dim over 128
// (rt-pg19's 129), the dh-256 one any over 192: the wrapper pads q, k and
// v with zero columns and passes the true head dim's scale, which every
// instance takes from the caller. The TPU
// kernel takes one softmax over the whole (w x 2w) score tile in VMEM;
// here the block walks only its rows' window, from the window start of
// its first row, rounded down to a tile, to its causal end (non-causal:
// the end of the next block), with an online softmax, so shared memory
// does not grow with w.
// The kv plane is the query head's kv head (3-D maps over B * Hkv planes).
// When 128 divides w, each query tile lies in one window block, so only
// the diagonal tile and the ragged end are masked; otherwise a tile that
// crosses any of its rows' window start is masked too. With a pad mask
// every tile is masked, its key validity staged per warpgroup in shared
// memory (double-buffered by tile parity).
//
// fp32: `local_fwd_kernel`, fp32 FMAs from shared memory with the online
// softmax of `FlashTile` (common.cuh): a block of 64 queries walks its key
// range in tiles of 32. It keeps full fp32 products, as PyTorch's fp32
// matmul does (no TF32). At dh 256 its tile takes ~141 KB of dynamic
// shared memory (`local_fwd_smem_bytes`).
#include "attn_fwd_sm90.cuh"
#include "common.cuh"

namespace {

using namespace rt;

template <int DH>
__global__ void __launch_bounds__(NT) local_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ kvalid,
    float* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int N, int w, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<FlashSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const float* qb = q + static_cast<size_t>(bh) * N * DH;
  const float* kb = k + kvh * N * DH;
  const float* vb = v + kvh * N * DH;

  load_rows<float, DH, BQ, DH + 1>(&sm.q[0][0], [&](int r) -> const float* {
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
    auto krow = [&](const float* base) {
      return [=](int r) -> const float* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<float, DH, BK, DH>(&sm.v[0][0], krow(vb));
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
  float* ob = o + static_cast<size_t>(bh) * N * DH;
  float* lb = lse + static_cast<size_t>(bh) * N;
  ft.template store<float>(
      [&](int row) -> float* {
        return row < qn ? ob + static_cast<size_t>(q0 + row) * DH : nullptr;
      },
      [&](int row) -> float* { return row < qn ? lb + q0 + row : nullptr; });
}

template <int DH>
int launch_fp32(const void* q, const void* k, const void* v,
                const uint8_t* kvalid, void* o, float* lse, int B, int H,
                int Hkv, int N, int w, int causal, float scale,
                cudaStream_t stream) {
  auto kernel = local_fwd_kernel<DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kvalid, static_cast<float*>(o), lse, H,
      Hkv, N, w, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the body is attn_fwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::FWD_ROWS;

// The window on row indices (see the top of this file). An owned row's tag
// is its window [lo, hi] of key rows (hi clamped to the last key); the
// walked tiles have KEYS rows.
template <int KEYS>
struct LocalFwd {
  static constexpr bool kNoKeyRows = true;   // a row whose keys are padding
  struct Window {
    int lo, hi;
  };
  int qplane, kplane, q0, N, k_first, ntiles, w, causal;
  const uint8_t* kvalid;           // this batch row's (N,) pad mask, or null
  uint8_t (*valid)[2][KEYS];       // [warpgroup][tile % 2][key]
  __device__ Window row_tag(int i) const {
    const int b = i / w;
    const int hi = causal ? i : (b + 2) * w - 1;
    return {max(0, (b - 1) * w), min(hi, N - 1)};
  }
  __device__ bool tile_tags() const { return kvalid != nullptr; }
  __device__ void stage(int wg, int buf, int t, int j) const {
    valid[wg][buf][t] = j < N && kvalid[j];
  }
  // a tile is unmasked when every key of it lies in every row's window:
  // windows only move forward, so the warpgroup's last row has the latest
  // start and its first row the earliest end
  __device__ bool edge(int wg, int, int k0) const {
    if (kvalid != nullptr) return true;
    const int r = q0 + 64 * wg;
    return k0 < row_tag(r + 63).lo || k0 + KEYS - 1 > row_tag(r).hi;
  }
  __device__ bool drop(int wg, int buf, int c, int j, Window win) const {
    return j < win.lo || j > win.hi ||
           (kvalid != nullptr && !valid[wg][buf][c]);
  }
};

template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1) local_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const uint8_t* __restrict__ kvalid, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int N, int w, int causal,
    float scale) {
  constexpr int KEYS = sm90::fwd_keys<DH>();
  __shared__ uint8_t valid[2][2][KEYS];
  const int bh = blockIdx.y, b = bh / H;
  LocalFwd<KEYS> pol;
  pol.qplane = bh;
  pol.kplane = b * Hkv + (bh % H) / (H / Hkv);
  pol.q0 = blockIdx.x * FWD_ROWS;
  pol.N = N;
  pol.w = w;
  pol.causal = causal;
  pol.kvalid =
      kvalid == nullptr ? nullptr : kvalid + static_cast<size_t>(b) * N;
  pol.valid = valid;
  // from the window start of the first row, rounded down to a tile, to the
  // last row's causal end (non-causal: the end of its next block)
  const int last = min(pol.q0 + FWD_ROWS, N) - 1;
  pol.k_first = max(0, (pol.q0 / w - 1) * w) / KEYS * KEYS;
  const int kend = causal ? last + 1 : min(N, (last / w + 2) * w);
  pol.ntiles = (kend - pol.k_first + KEYS - 1) / KEYS;
  sm90::fwd_body<DH>(tq, tk, tv, o, lse, pol, scale);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v,
                const uint8_t* kvalid, void* o, float* lse, int B, int H,
                int Hkv, int N, int w, int causal, float scale,
                cudaStream_t stream) {
  constexpr int KEYS = sm90::fwd_keys<DH>();
  CUtensorMap tq, tk, tv;
  int err = sm90::map_rows(&tq, q, B * H, N, DH, FWD_ROWS);
  if (err == cudaSuccess)
    err = sm90::map_rows(&tk, k, B * Hkv, N, DH, KEYS);
  if (err == cudaSuccess)
    err = sm90::map_rows(&tv, v, B * Hkv, N, DH, KEYS);
  if (err != cudaSuccess) return err;
  auto kernel = local_fwd_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::FwdSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + FWD_ROWS - 1) / FWD_ROWS, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      tq, tk, tv, kvalid, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, N,
      w, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,N,dh), k/v (B,Hkv,N,dh), kvalid (B,N) uint8 or null; o like q,
// lse (B,H,N) fp32. dtype: 0 fp32, 1 bf16; dh 64, 128, 192 or 256 (any
// other head dim comes zero-padded to one of them); scale the softmax scale,
// 1 / sqrt of the true head dim. Returns a cudaError_t code.
extern "C" int local_attention_fwd(const void* q, const void* k,
                                   const void* v, const uint8_t* kvalid,
                                   void* o, float* lse, int B, int H, int Hkv,
                                   int N, int dh, int w, int causal,
                                   int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LOCAL_FWD(DH)                                                        \
  if (dh == DH && dtype == 1)                                                \
    return launch_bf16<DH>(q, k, v, kvalid, o, lse, B, H, Hkv, N, w, causal, \
                           scale, s);                                        \
  if (dh == DH && dtype == 0)                                                \
    return launch_fp32<DH>(q, k, v, kvalid, o, lse, B, H, Hkv, N, w, causal, \
                           scale, s);
  LOCAL_FWD(128)
  LOCAL_FWD(64)
  LOCAL_FWD(192)
  LOCAL_FWD(256)
#undef LOCAL_FWD
  return cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the forward at head dim dh in dtype
// (0 fp32, 1 bf16); 0 for a head dim it has no instance of.
extern "C" int local_fwd_smem_bytes(int dh, int dtype) {
#define LOCAL_FWD_SMEM(DH)                                                   \
  if (dh == DH)                                                              \
    return static_cast<int>(                                                 \
        dtype == 1 ? sm90::aligned_smem_bytes<sm90::FwdSmemH<DH>>()          \
                   : sizeof(rt::FlashSmem<DH>));
  LOCAL_FWD_SMEM(64)
  LOCAL_FWD_SMEM(128)
  LOCAL_FWD_SMEM(192)
  LOCAL_FWD_SMEM(256)
#undef LOCAL_FWD_SMEM
  return 0;
}
