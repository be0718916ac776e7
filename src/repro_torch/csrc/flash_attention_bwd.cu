// Dense (full) flash attention, backward — CUDA for sm_90a.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// src/repro/kernels/flash_attention.py (:90 / :123, their `pallas_call`s
// :225 / :249; the backward of `flash_attention`). Both recompute p from
// the forward's lse and mask it explicitly:
//   p  = keep ? exp(q.k * scale - lse) : 0
//   ds = p * (do.v - D) * scale,  D = rowsum(do * out) (computed outside)
//   dq = ds . K,   dk = ds^T . Q,   dv = p^T . dO
// with keep the forward's mask (csrc/flash_attention.cu): every key, or
// key row j <= query row i when causal, on row indices also when M != N.
// Causal tiles wholly above the diagonal are skipped, not masked. dk and
// dv come out per *query* head, fp32; the wrapper sums each kv head's
// query group (GQA), as the JAX package does in XLA. dq is fp32. The
// scale comes from the caller, 1/sqrt of the true head dim (the wrapper
// pads a narrower head dim to dh 64 or 128 with zero columns, whose dq, dk
// and dv come out zero and are cut off; in bf16 dh 80 has an instance of
// its own, below).
//
// What bounds it on this card: the dq kernel needs 6*dh flops per
// attended pair and the dk/dv kernel 8*dh; at qwen2's train shape
// (B 2, H 14, Hkv 2, N 4096, dh 64, causal) that is ~90 and ~120 GFLOP
// against ~65 and ~95 MB read or written once: far above the bf16 ridge,
// so the tensor cores bound an ideal kernel (~0.09 / ~0.12 ms).
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64, 80 and 128): `flash_bwd_dkv_wgmma` and `flash_bwd_dq_wgmma`, on
// the tensor cores, with the bodies of attn_bwd_sm90.cuh (shared with the
// gathered routing backward; the design is described there) and the
// policies `FlashDkv` and `FlashDq`: planes batch * heads for q, do, lse, D
// and the outputs, batch * kv heads for k and v; the mask on row indices.
// - dk/dv: a block of 128 key rows walks query tiles from the tile of its
//   first key row (causal) or from 0.
// - dq: a block of 128 query rows walks key tiles of 64 up to its last
//   query row (causal) or to M, the heaviest blocks (the last, under
//   causality) first.
// P and dS go in as hi + lo bf16 pairs: one bf16 value each puts dq, dk
// and dv 1.4-2.6e-3 of their largest value from the fp32 result at
// qwen2's shape (tests/test_torch_flash_bwd_split.py). The split alone
// leaves ~4e-6 (fp32 sums); on the card the tensor cores' own fp32
// accumulation adds the rest of the ~2e-5 chip_smoke.py reads against an
// fp64 reference. Only tiles that cross the diagonal or the ragged end
// are masked.
// At dh 80 (hubert-xlarge's heads) the tensor maps take the rows at their
// true width (160 bytes, a multiple of the 16 TMA's strides need): each
// tile row is two 64-column boxes, the second filled with zeros past
// column 80 by TMA, so no padded copy exists in device memory; the
// products read columns 0-79 only (five k16 steps for S and dP, n80 for
// dV, dK and dQ; attn_bwd_sm90.cuh), and the outputs are written 80 wide.
// The dh-128 instance on zero-padded inputs did 1.6x these products and
// took eight pad copies and three cuts per backward.
//
// fp32: `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, fp32 FMAs from
// shared memory with the tiles `DqTile` and `DkvTile` (attn_bwd.cuh),
// shared with the local-window and fused routing backward kernels: blocks
// of 64 query (key) rows walk key (query) tiles of 32 rows. They keep full
// fp32 products, as PyTorch's fp32 matmul does (no TF32).
#include "attn_bwd.cuh"
#include "attn_bwd_sm90.cuh"

namespace {

using namespace rt;

template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, int H, int Hkv, int N, int M, int causal,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qn = min(BQ, N - q0);
  const size_t plane = static_cast<size_t>(bh) * N;
  const float* kb = k + kvh * M * DH;
  const float* vb = v + kvh * M * DH;

  auto qrows = [&](const float* base) {
    return [=](int r) -> const float* {
      return r < qn ? base + (plane + q0 + r) * DH : nullptr;
    };
  };
  load_rows<float, DH, BQ, DH + 1>(&sm.q[0][0], qrows(q));
  load_rows<float, DH, BQ, DH + 1>(&sm.dO[0][0], qrows(dO));
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
    auto krow = [&](const float* base) {
      return [=](int r) -> const float* {
        return r < nk ? base + static_cast<size_t>(k0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BK, DH + 1>(&sm.k[0][0], krow(kb));
    load_rows<float, DH, BK, DH + 1>(&sm.v[0][0], krow(vb));
    __syncthreads();
    t.consume(sm, nk, scale, [&](int row, int col) {
      return !causal || k0 + col <= q0 + row;
    });
  }
  t.store([&](int row) -> float* {
    return row < qn ? dq + (plane + q0 + row) * DH : nullptr;
  });
}

template <int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int N,
    int M, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t kvh = static_cast<size_t>(b) * Hkv + h / (H / Hkv);
  const int k0 = blockIdx.x * BKR;
  const int kn = min(BKR, M - k0);
  const size_t plane = static_cast<size_t>(bh) * N;

  auto krow = [&](const float* base) {
    return [=](int r) -> const float* {
      return r < kn ? base + (kvh * M + k0 + r) * DH : nullptr;
    };
  };
  load_rows<float, DH, BKR, DH + 1>(&sm.k[0][0], krow(k));
  load_rows<float, DH, BKR, DH + 1>(&sm.v[0][0], krow(v));
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
    auto qrows = [&](const float* base) {
      return [=](int r) -> const float* {
        return r < nq ? base + (plane + q0 + r) * DH : nullptr;
      };
    };
    load_rows<float, DH, BQT, DH + 1>(&sm.q[0][0], qrows(q));
    load_rows<float, DH, BQT, DH + 1>(&sm.dO[0][0], qrows(dO));
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

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* dsum, float* dq, int B, int H,
              int Hkv, int N, int M, int causal, float scale,
              cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<DH>;
  const size_t smem = sizeof(DqSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, dsum,
      dq, H, Hkv, N, M, causal, scale);
  return cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* dsum, float* dk, float* dv,
               int B, int H, int Hkv, int N, int M, int causal,
               float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<DH>;
  const size_t smem = sizeof(DkvSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + BKR - 1) / BKR, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, dsum,
      dk, dv, H, Hkv, N, M, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the bodies are attn_bwd_sm90.cuh's)
// ---------------------------------------------------------------------------
using sm90::HB;
using sm90::HBN;

// The flash mask on row indices: a key row j is kept for query row i when
// j < M and, causal, j <= i. The query planes are batch * heads, the key
// planes batch * kv heads (GQA).
struct FlashDkv {
  int qplane, kplane, k0, N, M, causal, q_first, ntiles;
  __device__ int key_tag(int key) const { return key; }
  __device__ void stage(int, int, int, int) const {}
  __device__ bool edge(int wg, int, int q0, int rows) const {
    return q0 + rows > N || (causal && k0 + 64 * wg + 63 > q0);
  }
  __device__ bool drop(int, int, int, int col, int key) const {
    return col >= N || (causal && col < key);
  }
};

struct FlashDq {
  static constexpr bool kTileTags = false;
  int qplane, kplane, q0, N, M, causal, k_first, ntiles;
  __device__ int row_tag(int row) const { return row; }
  __device__ bool edge(int wg, int, int k0, int rows) const {
    return k0 + rows > M || (causal && k0 + rows - 1 > q0 + 64 * wg);
  }
  __device__ bool drop(int, int, int, int col, int row) const {
    return col >= M || (causal && col > row);
  }
};

__device__ __forceinline__ int kv_plane(int bh, int H, int Hkv) {
  return (bh / H) * Hkv + (bh % H) / (H / Hkv);
}

// dk/dv: a block owns 128 key rows and walks query tiles from the tile of
// its first key row (causal) or from 0.
template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int H, int Hkv, int N, int M, int causal,
                        float scale) {
  constexpr int BQ = sm90::DkvSmemH<DH>::BQ;
  FlashDkv pol;
  pol.qplane = blockIdx.y;
  pol.kplane = kv_plane(blockIdx.y, H, Hkv);
  pol.k0 = blockIdx.x * HB;
  pol.N = N;
  pol.M = M;
  pol.causal = causal;
  // causal: no query row before the block's first key row
  pol.q_first = causal ? pol.k0 : 0;
  pol.ntiles = pol.q_first < N ? (N - pol.q_first + BQ - 1) / BQ : 0;
  sm90::bwd_dkv_body<DH>(tq, tk, tv, tdo, lse, dsum, dk, dv, pol, scale);
}

// dq: a block owns 128 query rows and walks key tiles of 64 rows up to its
// last query row (causal) or to M, the heaviest blocks (the last, under
// causality) first.
template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       float* __restrict__ dq, int H, int Hkv, int N, int M,
                       int causal, float scale) {
  FlashDq pol;
  pol.qplane = blockIdx.y;
  pol.kplane = kv_plane(blockIdx.y, H, Hkv);
  pol.q0 = (gridDim.x - 1 - blockIdx.x) * HB;
  pol.N = N;
  pol.M = M;
  pol.causal = causal;
  // causal: no key past the block's last query row
  const int kend = causal ? min(M, pol.q0 + min(HB, N - pol.q0)) : M;
  pol.k_first = 0;
  pol.ntiles = (kend + HBN - 1) / HBN;
  sm90::bwd_dq_body<DH>(tq, tk, tv, tdo, lse, dsum, dq, pol, scale);
}

// The four bf16 tensor maps of a backward call: q and do in boxes of
// ``qrows`` rows, k and v of ``krows``.
template <int DH>
int map_bwd(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
            const void* dO, int B, int H, int Hkv, int N, int M, int qrows,
            int krows) {
  using sm90::map_rows;
  int err = map_rows(&m[0], q, B * H, N, DH, qrows);
  if (err == cudaSuccess) err = map_rows(&m[1], k, B * Hkv, M, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[2], v, B * Hkv, M, DH, krows);
  if (err == cudaSuccess) err = map_rows(&m[3], dO, B * H, N, DH, qrows);
  return err;
}

template <int DH>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dO, const float* lse, const float* dsum,
                   float* dq, int B, int H, int Hkv, int N, int M,
                   int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, B, H, Hkv, N, M, HB, HBN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DqSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + HB - 1) / HB, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, dq, H, Hkv, N, M, causal,
      scale);
  return cudaGetLastError();
}

template <int DH>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* dsum,
                    float* dk, float* dv, int B, int H, int Hkv, int N,
                    int M, int causal, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  int err = map_bwd<DH>(m, q, k, v, dO, B, H, Hkv, N, M,
                        sm90::DkvSmemH<DH>::BQ, HB);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<sm90::DkvSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + HB - 1) / HB, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, dk, dv, H, Hkv, N, M, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q/do (B,H,N,dh), k/v (B,Hkv,M,dh), lse/dsum (B,H,N) fp32; dq (B,H,N,dh)
// fp32. dtype: 0 fp32, 1 bf16; dh 64 or 128, and 80 in bf16. scale: the
// softmax scale, 1 / sqrt of the true head dim (the wrapper runs another
// head dim zero-padded to dh).
// Returns a cudaError_t code.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dO,
                                      const float* lse, const float* dsum,
                                      float* dq, int B, int H, int Hkv, int N,
                                      int M, int dh, int causal, int dtype,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dq_bf16<128>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M,
                               causal, scale, s);
  if (dtype == 1 && dh == 80)
    return launch_dq_bf16<80>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M,
                              causal, scale, s);
  if (dtype == 1 && dh == 64)
    return launch_dq_bf16<64>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M,
                              causal, scale, s);
  if (dtype == 0 && dh == 128)
    return launch_dq<128>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M, causal,
                          scale, s);
  if (dtype == 0 && dh == 64)
    return launch_dq<64>(q, k, v, dO, lse, dsum, dq, B, H, Hkv, N, M, causal,
                         scale, s);
  return cudaErrorInvalidValue;
}

// As above; dk/dv (B,H,M,dh) fp32 per query head.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const float* lse, const float* dsum,
                                       float* dk, float* dv, int B, int H,
                                       int Hkv, int N, int M, int dh,
                                       int causal, int dtype, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch_dkv_bf16<128>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N,
                                M, causal, scale, s);
  if (dtype == 1 && dh == 80)
    return launch_dkv_bf16<80>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N,
                               M, causal, scale, s);
  if (dtype == 1 && dh == 64)
    return launch_dkv_bf16<64>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N,
                               M, causal, scale, s);
  if (dtype == 0 && dh == 128)
    return launch_dkv<128>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N, M,
                           causal, scale, s);
  if (dtype == 0 && dh == 64)
    return launch_dkv<64>(q, k, v, dO, lse, dsum, dk, dv, B, H, Hkv, N, M,
                          causal, scale, s);
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

// Dynamic shared memory of one block of the bf16 flash dq (dkv = 0) or
// dk/dv (dkv = 1) kernel on the tensor cores (resident tiles, two ring
// stages, barriers, alignment room), for reports; -1 for an unsupported dh.
extern "C" int flash_bwd_wgmma_smem_bytes(int dh, int dkv) {
  using sm90::aligned_smem_bytes;
  using sm90::DkvSmemH;
  using sm90::DqSmemH;
  if (dh == 128)
    return static_cast<int>(dkv ? aligned_smem_bytes<DkvSmemH<128>>()
                                : aligned_smem_bytes<DqSmemH<128>>());
  if (dh == 80)
    return static_cast<int>(dkv ? aligned_smem_bytes<DkvSmemH<80>>()
                                : aligned_smem_bytes<DqSmemH<80>>());
  if (dh == 64)
    return static_cast<int>(dkv ? aligned_smem_bytes<DkvSmemH<64>>()
                                : aligned_smem_bytes<DqSmemH<64>>());
  return -1;
}
