// Blocked local (sliding-window) attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (:59) and `_bwd_dkv_kernel`
// (:85) of src/repro/kernels/local_attention.py (their `pallas_call`s :196
// and :220; the backward of `local_attention_kernel`). The mask is the
// forward's (csrc/local_attention.cu): query i (block b = i / w) attends
// key j when j lies in block b-1 or b (also b+1 when non-causal), j <= i
// when causal, and j is a valid key (optional (B, N) pad mask). p is
// recomputed from the forward's lse and masked explicitly (attn_bwd.cuh):
// a row that keeps no key has lse NEG + log(1e-30) and is dropped by a
// select. dk and dv come out per *query* head, fp32; the wrapper sums each
// kv head's query group (GQA), as the JAX package does in XLA. GQA goes
// through the kv-head index, no repeated k/v.
//
// What bounds them on this card: a query meets ~1.5w keys (causal); the dq
// kernel needs 6*dh flops per kept pair, the dk/dv kernel 8*dh, against
// each bf16 row read once and the fp32 gradients written once. At
// rt-enwik8's train shape (w 256, dh 128) that is ~190 flops per byte,
// under the bf16 ridge (~295), so device memory bounds an ideal kernel; at
// rt-cifar10's local layers (w 512, dh 64) the operations do, and the
// exponentials (one per kept pair and kernel, on the SFU) weigh about as
// much as the products. fp32 FMAs from shared memory (67 TFLOP/s peak,
// rows re-read per tile) took 35-47x that bound on the bf16 inputs
// (chip_smoke.py, H100 80GB HBM3 at 700 W).
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64, 128, 192 and 256; the dh-192 instances serve any head dim
// over 128, the dh-256 ones any over 192, zero-padded by the wrapper, with
// the true head dim's scale, which every instance takes from the caller):
// `local_bwd_dq_wgmma` and `local_bwd_dkv_wgmma`, on the tensor cores with
// the backward bodies the flash and gathered backwards run
// (attn_bwd_sm90.cuh: 128 owned rows a block loaded once by TMA, the other
// side's tiles through a ring, S and dP by wgmma, P and dS fed to their
// products as hi + lo bf16 pairs so that dq, dk and dv keep fp32's
// accuracy). The TPU kernels hold the whole (w x 2w) tile in VMEM; here
// each block walks only its rows' windows, so shared memory does not grow
// with w. The policies give the walk and the mask on row indices:
// - `LocalDq`: a block owns 128 query rows, each tagged with its window of
//   keys, and walks key tiles of KT rows (64; 32 at dh 256, where the owned
//   Q and dO take 128 KB: `dq_tile_keys`) from its first row's window
//   start, rounded down to a tile, to its last row's window end, as the
//   forward's `LocalFwd` walks 128-row tiles;
// - `LocalDkv`: a block owns 128 key rows, each tagged with the window of
//   queries that attend them (a padded key, or one past the plane, an empty
//   window), and walks query tiles of 64 rows (dh 64) or 32 (dh 128 and
//   over) from its first key's window start, rounded down to a tile, to its
//   last key's window end. Above dh 128 the walk runs twice
//   (`dkv_sweeps`): dV, then dK at dh 192; at dh 256 both over columns
//   0-127, then both over 128-255 (`dkv_col_parts`), so that no more than
//   two 64 x 128 fp32 accumulators a warpgroup are live.
// Windows only move forward, so a warpgroup masks a tile only when it
// leaves the window of its last row (latest start) or of its first row
// (earliest end); the ends are clamped to the plane, so a tile that
// crosses N is masked too (rows past N arrive from TMA as zeros). When the
// tile divides w that leaves the diagonal tile and the window's edges.
// With a pad mask every tile is masked: dq stages each key tile's validity
// per warpgroup and tile parity (`LocalDq<true, KT>`, its own instance, so
// the unpadded kernel stages nothing), dk/dv reads its owned keys'
// validity once, into their windows.
//
// fp32: `local_bwd_dq_kernel` and `local_bwd_dkv_kernel`, fp32 FMAs from
// shared memory (attn_bwd.cuh): one block per 64 query rows (dq) or 64 key
// rows (dk/dv), tiles of 32 over the same windows. They keep full fp32
// products, as PyTorch's fp32 matmul does (no TF32). At dh 256
// (recurrentgemma-9b's local-attention layers) they take ~207 KB (dq) and
// ~215 KB (dk/dv) of shared memory (`local_bwd_smem_bytes`); dk/dv keeps
// its 2 x 4 x 32 fp32 accumulators a thread, more than the registers hold,
// so part of them lives in local memory. They serve only the fp32 gates.
#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"

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
              float scale, cudaStream_t stream) {
  auto kernel = local_bwd_dq_kernel<T, DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, dsum, kvalid,
      dq, H, Hkv, N, w, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* dsum, const uint8_t* kvalid,
               float* dk, float* dv, int B, int H, int Hkv, int N, int w,
               int causal, float scale, cudaStream_t stream) {
  auto kernel = local_bwd_dkv_kernel<T, DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BKR - 1) / BKR, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, dsum, kvalid,
      dk, dv, H, Hkv, N, w, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the bodies are attn_bwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::HB;

// A window [lo, hi] of rows on the other side (lo > hi: empty), hi clamped
// to the plane's last row N - 1.
struct Window {
  int lo, hi;
};

// The keys that query row i may keep (the forward's `LocalFwd::row_tag`).
__device__ __forceinline__ Window keys_of(int i, int N, int w, int causal) {
  const int b = i / w;
  const int hi = causal ? i : (b + 2) * w - 1;
  return {max(0, (b - 1) * w), min(hi, N - 1)};
}

// The queries that may keep key row j: those of its block and the next
// (from j itself when causal; also the block before when non-causal).
__device__ __forceinline__ Window queries_of(int j, int N, int w,
                                             int causal) {
  const int b = j / w;
  return {causal ? j : max(0, (b - 1) * w), min((b + 2) * w - 1, N - 1)};
}

// dk/dv: the owned rows are keys, tagged with the window of queries that
// attend them; nothing is staged per tile.
struct LocalDkv {
  int qplane, kplane, k0, N, M, causal, q_first, ntiles, w;
  const uint8_t* kvalid;   // this batch row's (N,) pad mask, or null
  __device__ Window key_tag(int j) const {
    if (j >= N || (kvalid != nullptr && !kvalid[j])) return {1, 0};
    return queries_of(j, N, w, causal);
  }
  __device__ void stage(int, int, int, int) const {}
  // unmasked when the tile lies in the window of every key of the
  // warpgroup: its last key has the latest start, its first the earliest
  // end (clamped to the plane, so a tile that crosses N is masked)
  __device__ bool edge(int wg, int, int q0, int rows) const {
    const int a = k0 + 64 * wg;
    if (kvalid != nullptr || a + 63 >= N) return true;
    return q0 < queries_of(a + 63, N, w, causal).lo ||
           q0 + rows - 1 > queries_of(a, N, w, causal).hi;
  }
  __device__ bool drop(int, int, int, int col, Window win) const {
    return col < win.lo || col > win.hi;
  }
};

// dq: the owned rows are queries, tagged with their window of keys; with a
// pad mask (PAD) each walked key tile's validity (KT keys) is staged per
// warpgroup and tile parity, and every tile is masked.
template <bool PAD, int KT>
struct LocalDq {
  static constexpr bool kTileTags = PAD;
  int qplane, kplane, q0, N, causal, k_first, ntiles, w;
  const uint8_t* kvalid;         // this batch row's (N,) pad mask, or null
  uint8_t (*valid)[2][KT];       // [warpgroup][tile % 2][key]
  __device__ Window row_tag(int i) const { return keys_of(i, N, w, causal); }
  __device__ void stage(int wg, int buf, int t, int j) const {
    valid[wg][buf][t] = j < N && kvalid[j];
  }
  // unmasked when every key of the tile lies in every row's window: the
  // warpgroup's last row has the latest start, its first the earliest end
  __device__ bool edge(int wg, int, int k0, int rows) const {
    if (PAD) return true;
    const int r = q0 + 64 * wg;
    return k0 < keys_of(r + 63, N, w, causal).lo ||
           k0 + rows - 1 > keys_of(r, N, w, causal).hi;
  }
  __device__ bool drop(int wg, int buf, int c, int j, Window win) const {
    return j < win.lo || j > win.hi || (PAD && !valid[wg][buf][c]);
  }
};

__device__ __forceinline__ int kv_plane(int bh, int H, int Hkv) {
  return (bh / H) * Hkv + (bh % H) / (H / Hkv);
}

template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    local_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        const uint8_t* __restrict__ kvalid,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int H, int Hkv, int N, int w, int causal,
                        float scale) {
  constexpr int BQ = sm90::DkvSmemH<DH>::BQ;
  const int bh = blockIdx.y;
  LocalDkv pol;
  pol.qplane = bh;
  pol.kplane = kv_plane(bh, H, Hkv);
  pol.k0 = blockIdx.x * HB;
  pol.N = pol.M = N;
  pol.causal = causal;
  pol.w = w;
  pol.kvalid =
      kvalid == nullptr ? nullptr : kvalid + static_cast<size_t>(bh / H) * N;
  // the queries that attend the block's keys: from its first key's window
  // start, rounded down to a tile, to its last key's window end
  const int last = min(pol.k0 + HB, N) - 1;
  pol.q_first = queries_of(pol.k0, N, w, causal).lo / BQ * BQ;
  const int qend = queries_of(last, N, w, causal).hi + 1;
  pol.ntiles = (qend - pol.q_first + BQ - 1) / BQ;
  sm90::bwd_dkv_body<DH>(tq, tk, tv, tdo, lse, dsum, dk, dv, pol, scale);
}

template <int DH, bool PAD>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    local_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       const uint8_t* __restrict__ kvalid,
                       float* __restrict__ dq, int H, int Hkv, int N, int w,
                       int causal, float scale) {
  constexpr int KT = sm90::DqSmemH<DH>::KT;
  __shared__ uint8_t valid[2][2][KT];
  const int bh = blockIdx.y;
  LocalDq<PAD, KT> pol;
  pol.qplane = bh;
  pol.kplane = kv_plane(bh, H, Hkv);
  pol.q0 = blockIdx.x * HB;
  pol.N = N;
  pol.causal = causal;
  pol.w = w;
  pol.kvalid =
      kvalid == nullptr ? nullptr : kvalid + static_cast<size_t>(bh / H) * N;
  pol.valid = valid;
  // from the window start of the first row, rounded down to a tile, to the
  // last row's window end
  const int last = min(pol.q0 + HB, N) - 1;
  pol.k_first = keys_of(pol.q0, N, w, causal).lo / KT * KT;
  const int kend = keys_of(last, N, w, causal).hi + 1;
  pol.ntiles = (kend - pol.k_first + KT - 1) / KT;
  sm90::bwd_dq_body<DH>(tq, tk, tv, tdo, lse, dsum, dq, pol, scale);
}

// The four bf16 tensor maps of a backward call: q and do over B * H planes
// in boxes of ``qrows`` rows, k and v over B * Hkv planes in boxes of
// ``krows``, N rows each.
template <int DH>
int map_bwd(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
            const void* dO, int B, int H, int Hkv, int N, int qrows,
            int krows) {
  using sm90::map_rows;
  int err = map_rows(&m[0], q, B * H, N, DH, qrows);
  if (err == cudaSuccess) err = map_rows(&m[1], k, B * Hkv, N, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[2], v, B * Hkv, N, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[3], dO, B * H, N, DH, qrows);
  return err;
}

template <int DH>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* dsum,
                   const uint8_t* kvalid, float* dq, int B, int H, int Hkv,
                   int N, int w, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, B, H, Hkv, N, HB,
                        sm90::DqSmemH<DH>::KT);
  if (err != cudaSuccess) return err;
  auto kernel = kvalid == nullptr ? local_bwd_dq_wgmma<DH, false>
                                  : local_bwd_dq_wgmma<DH, true>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DqSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + HB - 1) / HB, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, kvalid, dq, H, Hkv, N, w, causal,
      scale);
  return cudaGetLastError();
}

template <int DH>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* dsum,
                    const uint8_t* kvalid, float* dk, float* dv, int B,
                    int H, int Hkv, int N, int w, int causal,
                    float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, B, H, Hkv, N,
                        sm90::DkvSmemH<DH>::BQ, HB);
  if (err != cudaSuccess) return err;
  auto kernel = local_bwd_dkv_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DkvSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + HB - 1) / HB, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, kvalid, dk, dv, H, Hkv, N, w,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q/do (B,H,N,dh), k/v (B,Hkv,N,dh), lse/dsum (B,H,N) fp32, kvalid (B,N)
// uint8 or null; dq (B,H,N,dh) fp32. dtype: 0 fp32, 1 bf16; dh 64, 128,
// 192 or 256 (any other head dim comes zero-padded to one of them); scale
// the softmax scale, 1 / sqrt of the true head dim. Returns a cudaError_t
// code.
extern "C" int local_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const float* lse, const float* dsum,
                                      const uint8_t* kvalid, float* dq, int B,
                                      int H, int Hkv, int N, int dh, int w,
                                      int causal, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LOCAL_DQ(DH)                                                         \
  if (dh == DH && dtype == 1)                                                \
    return launch_dq_bf16<DH>(q, k, v, dO, lse, dsum, kvalid, dq, B, H, Hkv, \
                              N, w, causal, scale, s);                       \
  if (dh == DH && dtype == 0)                                                \
    return launch_dq<float, DH>(q, k, v, dO, lse, dsum, kvalid, dq, B, H,    \
                                Hkv, N, w, causal, scale, s);
  LOCAL_DQ(128)
  LOCAL_DQ(64)
  LOCAL_DQ(192)
  LOCAL_DQ(256)
#undef LOCAL_DQ
  return cudaErrorInvalidValue;
}

// As above; dk/dv (B,H,N,dh) fp32 per query head.
extern "C" int local_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const float* lse, const float* dsum,
                                       const uint8_t* kvalid, float* dk,
                                       float* dv, int B, int H, int Hkv, int N,
                                       int dh, int w, int causal, int dtype,
                                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LOCAL_DKV(DH)                                                        \
  if (dh == DH && dtype == 1)                                                \
    return launch_dkv_bf16<DH>(q, k, v, dO, lse, dsum, kvalid, dk, dv, B, H, \
                               Hkv, N, w, causal, scale, s);                 \
  if (dh == DH && dtype == 0)                                                \
    return launch_dkv<float, DH>(q, k, v, dO, lse, dsum, kvalid, dk, dv, B,  \
                                 H, Hkv, N, w, causal, scale, s);
  LOCAL_DKV(128)
  LOCAL_DKV(64)
  LOCAL_DKV(192)
  LOCAL_DKV(256)
#undef LOCAL_DKV
  return cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the dq (which 0) or dk/dv (which 1)
// kernel at head dim dh in dtype (0 fp32, 1 bf16); 0 for a head dim it has
// no instance of.
extern "C" int local_bwd_smem_bytes(int dh, int dtype, int which) {
#define LOCAL_BWD_SMEM(DH)                                                   \
  if (dh == DH && dtype == 1)                                                \
    return static_cast<int>(                                                 \
        which == 0 ? sm90::aligned_smem_bytes<sm90::DqSmemH<DH>>()           \
                   : sm90::aligned_smem_bytes<sm90::DkvSmemH<DH>>());        \
  if (dh == DH)                                                              \
    return static_cast<int>(which == 0 ? sizeof(rt::DqSmem<DH>)              \
                                       : sizeof(rt::DkvSmem<DH>));
  LOCAL_BWD_SMEM(64)
  LOCAL_BWD_SMEM(128)
  LOCAL_BWD_SMEM(192)
  LOCAL_BWD_SMEM(256)
#undef LOCAL_BWD_SMEM
  return 0;
}
