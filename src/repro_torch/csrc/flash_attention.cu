// Dense (full) flash attention, forward — CUDA for sm_90a.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/flash_attention.py
// (:47, its `pallas_call` :181; the forward of `flash_attention`). Query
// row i attends key row j of the same batch and kv head for every j
// (non-causal) or for j <= i (causal, on row indices also when M != N: the
// TPU kernel's `_causal_iota`, hence the backend's
// supports_positions=False). Scale 1/sqrt(dh). Emits the output in q's
// type and the per-row log-sum-exp m + log(max(l, 1e-30)) in fp32. Any N,
// M >= 1; the ragged last tiles are masked. GQA goes through the kv-head
// index, no repeated k/v.
//
// What bounds it on this card: 4*dh flops per attended pair against q, k,
// v and out read or written once; at qwen2's train shape (B 2, H 14, Hkv
// 2, N 4096, dh 64, causal, bf16) that is ~60 GFLOP per ~34 MB, far above
// the bf16 ridge (~295 flops per byte), so the tensor cores bound it
// (~0.06 ms).
//
// The dtype alone picks the design; nothing falls back.
//
// bf16 (dh 64 and 128): `flash_fwd_wgmma`, on the tensor cores (sm90.cuh).
// A block of 256 threads takes 128 query rows of one (batch, head), 64 per
// warpgroup; TMA loads its Q once and walks key tiles of 128 rows through
// a ring of two K/V stages (`sm90::Ring`), from 3-D tensor maps (dh, rows,
// batch * heads): rows past a plane's end arrive as zeros, never as the
// next head's rows. At dh 128 a tile is two boxes of 64 columns. Per tile
// S = Q K^T is one SS wgmma chain (m64n128k16, K a K-major operand); the
// online softmax runs in fp32 on the accumulator registers (a row's max
// and sum over the 4 threads of a quad); P, zeroed where masked and
// rounded to bf16 in registers, is the A operand of the RS wgmma chain
// O += P V (V an MN-major operand). Only tiles that cross the diagonal or
// the ragged end of the keys are masked; causal key tiles wholly above the
// diagonal are neither loaded nor computed, so the work is the causal half
// of the N*M pairs. The heaviest query blocks (the last ones, under
// causality) start first. The output is rounded to bf16 once.
//
// fp32: `flash_fwd_kernel`, fp32 FMAs from shared memory with the online
// softmax of `FlashTile` (common.cuh), shared with the local-window and
// fused routing kernels: a block of 64 query rows walks key tiles of 32
// rows, skipping those above the diagonal. It keeps full fp32 products,
// as PyTorch's fp32 matmul does (no TF32), at the FMA rate (67 TFLOP/s
// peak).
#include "common.cuh"
#include "sm90.cuh"

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
                cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DH>;
  const size_t smem = sizeof(FlashSmem<DH>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, N,
      M, causal, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int HBM = 128;       // query rows per block: two warpgroups of 64
constexpr int HBN = 128;       // key rows per tile

template <int DH>
struct FwdSmemH {
  static constexpr int BOXES = DH / sm90::BOX_COLS;
  static constexpr uint32_t QBOX = HBM * sm90::ROW_BYTES;  // bytes of a box
  static constexpr uint32_t KBOX = HBN * sm90::ROW_BYTES;
  __nv_bfloat16 q[BOXES][HBM][sm90::BOX_COLS];
  __nv_bfloat16 k[sm90::RING_STAGES][BOXES][HBN][sm90::BOX_COLS];
  __nv_bfloat16 v[sm90::RING_STAGES][BOXES][HBN][sm90::BOX_COLS];
  uint64_t qbar;
  sm90::Ring ring;
};

template <int DH>
__global__ void __launch_bounds__(sm90::BLOCK_THREADS, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int Hkv, int N, int M, int causal,
    float scale) {
  using namespace sm90;
  using Sm = FwdSmemH<DH>;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int bh = blockIdx.y;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * HBM;
  const int qn = min(HBM, N - q0);
  // causal: no key past the block's last query row
  const int kend = causal ? min(M, q0 + qn) : M;
  const int ntiles = (kend + HBN - 1) / HBN;
  constexpr uint32_t KV_BYTES = 2 * Sm::BOXES * Sm::KBOX;

  auto load_kv = [&](int j) {
    const int s = j % sm90::RING_STAGES;
    uint64_t* bar = sm.ring.produce(j, KV_BYTES);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x) {
      tma_load_3d(&sm.k[s][x][0][0], &tk, bar, x * BOX_COLS, j * HBN, kvh);
      tma_load_3d(&sm.v[s][x][0][0], &tv, bar, x * BOX_COLS, j * HBN, kvh);
    }
  };
  sm.ring.init(&sm.qbar);
  if (tid == 0) {
    mbar_expect_tx(&sm.qbar, Sm::BOXES * Sm::QBOX);
#pragma unroll
    for (int x = 0; x < Sm::BOXES; ++x)
      tma_load_3d(&sm.q[x][0][0], &tq, &sm.qbar, x * BOX_COLS, q0, bh);
    sm.ring.prime(ntiles, load_kv);
  }

  const int lane = t % 32;
  const int r = 64 * wg + 16 * (t / 32) + lane / 4;   // rows r and r + 8
  const int cq = 2 * (lane % 4);
  const int row0 = q0 + r, row1 = row0 + 8;
  const float sl2 = scale * 1.4426950408889634f;      // scale * log2(e)
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const void* qtile = &sm.q[0][64 * wg][0];

  mbar_wait(&sm.qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % sm90::RING_STAGES;
    sm.ring.wait(j);
    float sc[HBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc, desc_k(qtile, kk, Sm::QBOX),
               desc_k(&sm.k[s][0][0][0], kk, Sm::KBOX), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int k0 = j * HBN;
    if (k0 + HBN > M || (causal && k0 + HBN - 1 > q0 + 64 * wg)) {
#pragma unroll
      for (int c = 0; c < HBN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * c + cq + e;
          if (col >= M || (causal && col > row0)) sc[4 * c + e] = -INFINITY;
          if (col >= M || (causal && col > row1))
            sc[4 * c + 2 + e] = -INFINITY;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < HBN / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    // a row with no unmasked key yet keeps max -inf: subtract 0 instead
    const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float alpha0 = exp2f(m0 * sl2 - ms0);
    const float alpha1 = exp2f(m1 * sl2 - ms1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < HBN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * c + e] = exp2f(fmaf(sc[4 * c + e], sl2, -ms0));
        sc[4 * c + 2 + e] = exp2f(fmaf(sc[4 * c + 2 + e], sl2, -ms1));
        sum0 += sc[4 * c + e];
        sum1 += sc[4 * c + 2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;   // this thread's share; summed over 4 at the end
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      acc[4 * c] *= alpha0;
      acc[4 * c + 1] *= alpha0;
      acc[4 * c + 2] *= alpha1;
      acc[4 * c + 3] *= alpha1;
    }
    uint32_t pa[HBN / 16][4];
    pack_a(sc, pa);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < HBN / 16; ++c)
      wgmma_rs(acc, pa[c], desc_mn(&sm.v[s][0][0][0], c, Sm::KBOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    // stage s is free once both warpgroups are done with it
    sm.ring.advance(j, ntiles, load_kv);
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const size_t plane = static_cast<size_t>(bh) * N;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const int col = 8 * c + cq;
    if (row0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + (plane + row0) * DH + col) =
          __floats2bfloat162_rn(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
    if (row1 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + (plane + row1) * DH + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] * inv1,
                                acc[4 * c + 3] * inv1);
  }
  if (lane % 4 == 0) {
    if (row0 < N) lse[plane + row0] = m0 * scale + logf(fmaxf(l0, 1e-30f));
    if (row1 < N) lse[plane + row1] = m1 * scale + logf(fmaxf(l1, 1e-30f));
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hkv, int N, int M, int causal,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = sm90::map_rows(&tq, q, B * H, N, DH, HBM);
  if (err == cudaSuccess) err = sm90::map_rows(&tk, k, B * Hkv, M, DH, HBN);
  if (err == cudaSuccess) err = sm90::map_rows(&tv, v, B * Hkv, M, DH, HBN);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma<DH>;
  const size_t smem = sm90::aligned_smem_bytes<FwdSmemH<DH>>();
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + HBM - 1) / HBM, B * H);
  kernel<<<grid, sm90::BLOCK_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, N, M, causal,
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
    return launch_bf16<128>(q, k, v, o, lse, B, H, Hkv, N, M, causal, s);
  if (dtype == 1 && dh == 64)
    return launch_bf16<64>(q, k, v, o, lse, B, H, Hkv, N, M, causal, s);
  if (dtype == 0 && dh == 128)
    return launch_fp32<128>(q, k, v, o, lse, B, H, Hkv, N, M, causal, s);
  if (dtype == 0 && dh == 64)
    return launch_fp32<64>(q, k, v, o, lse, B, H, Hkv, N, M, causal, s);
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
// tensor cores (Q, two K/V stages, barriers, alignment room), for reports;
// -1 for an unsupported dh.
extern "C" int flash_fwd_wgmma_smem_bytes(int dh) {
  using sm90::aligned_smem_bytes;
  if (dh == 128) return static_cast<int>(aligned_smem_bytes<FwdSmemH<128>>());
  if (dh == 64) return static_cast<int>(aligned_smem_bytes<FwdSmemH<64>>());
  return -1;
}
