// One wgmma product of each form the bf16 flash backward kernels
// (flash_attention_bwd.cu) and the dh-80 forward (flash_attention.cu)
// run, alone, for tests/test_torch_wgmma_probe.py
// to hold against torch.matmul on the card: a wrong shared-memory
// descriptor or fragment layout shows here on one tile, not as a wrong
// gradient somewhere in a whole kernel. Not on any model's path.
// - SS: D (64 x N) = A (64 x DH) B^T, A and B (N x DH) bf16, both K-major,
//   as S = Q K^T and dP = dO V^T (and their transposes in dk/dv).
// - RS: D (64 x DH) = A (64 x K, fp32) B, B (K x DH) bf16 MN-major, A as
//   the hi + lo bf16 pair `pack_a_split` makes, as dV += P^T dO,
//   dK += dS^T Q and dQ += dS K.
// At dh 80 (hubert-xlarge's) the operands take two 64-column boxes, the
// second zero-filled by TMA past column 80: SS reads K = 80 in five k16
// steps (the fifth from the second box), RS writes n80 across the two.
// The forward's forms are those at 128 rows: S over a 128-key tile
// (ss<128, 80>) and O += P V with B over 128 rows, its boxes 16 KB apart
// (rs<128, 80>; the forward's A is one bf16 value, the probe's the pair).
// One block of one warpgroup (128 threads); returns a cudaError_t code.
#include "sm90.cuh"
using namespace sm90;

template <int N, int DH>
struct SsSm {
  __nv_bfloat16 a[head_boxes<DH>()][64][64];
  __nv_bfloat16 b[head_boxes<DH>()][N][64];
  uint64_t bar;
};

template <int N, int DH>
__global__ void probe_ss_k(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, float* out) {
  extern __shared__ unsigned char raw[];
  auto& sm = aligned_smem<SsSm<N, DH>>(raw);
  const int t = threadIdx.x;
  if (t == 0) { mbar_init(&sm.bar, 1); fence_barrier_init(); }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(&sm.bar, head_boxes<DH>() * (64 + N) * 128);
    for (int x = 0; x < head_boxes<DH>(); ++x) {
      tma_load_3d(&sm.a[x][0][0], &ta, &sm.bar, 64 * x, 0, 0);
      tma_load_3d(&sm.b[x][0][0], &tb, &sm.bar, 64 * x, 0, 0);
    }
  }
  mbar_wait(&sm.bar, 0);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(d, desc_k(&sm.a[0][0][0], kk, 64 * 128),
             desc_k(&sm.b[0][0][0], kk, N * 128), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  const int lane = t % 32, r = 16 * (t / 32) + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 2; ++e) {
      out[r * N + 8 * j + cq + e] = d[4 * j + e];
      out[(r + 8) * N + 8 * j + cq + e] = d[4 * j + 2 + e];
    }
}

template <int K, int DH>
struct RsSm {
  __nv_bfloat16 b[head_boxes<DH>()][K][64];
  uint64_t bar;
};

template <int K, int DH>
__global__ void probe_rs_k(const float* a,
                           const __grid_constant__ CUtensorMap tb,
                           float* out) {
  extern __shared__ unsigned char raw[];
  auto& sm = aligned_smem<RsSm<K, DH>>(raw);
  const int t = threadIdx.x;
  if (t == 0) { mbar_init(&sm.bar, 1); fence_barrier_init(); }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(&sm.bar, head_boxes<DH>() * K * 128);
    for (int x = 0; x < head_boxes<DH>(); ++x)
      tma_load_3d(&sm.b[x][0][0], &tb, &sm.bar, 64 * x, 0, 0);
  }
  const int lane = t % 32, r = 16 * (t / 32) + lane / 4, cq = 2 * (lane % 4);
  float af[K / 2];
#pragma unroll
  for (int j = 0; j < K / 8; ++j)
    for (int e = 0; e < 2; ++e) {
      af[4 * j + e] = a[r * K + 8 * j + cq + e];
      af[4 * j + 2 + e] = a[(r + 8) * K + 8 * j + cq + e];
    }
  uint32_t hi[K / 16][4], lo[K / 16][4];
  pack_a_split(af, hi, lo);
  mbar_wait(&sm.bar, 0);
  float d[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) d[i] = 0.f;
  fence_regs(hi); fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < K / 16; ++c) {
    wgmma_rs(d, hi[c], desc_mn(&sm.b[0][0][0], c, K * 128), 1);
    wgmma_rs(d, lo[c], desc_mn(&sm.b[0][0][0], c, K * 128), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    for (int e = 0; e < 2; ++e) {
      out[r * DH + 8 * j + cq + e] = d[4 * j + e];
      out[(r + 8) * DH + 8 * j + cq + e] = d[4 * j + 2 + e];
    }
}

template <int N, int DH>
int ss(const void* a, const void* b, float* out) {
  CUtensorMap ma, mb;
  int e = map_rows(&ma, a, 1, 64, DH, 64);
  if (!e) e = map_rows(&mb, b, 1, N, DH, N);
  if (e) return e;
  size_t smem = aligned_smem_bytes<SsSm<N, DH>>();
  e = cudaFuncSetAttribute(probe_ss_k<N, DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  probe_ss_k<N, DH><<<1, 128, smem>>>(ma, mb, out);
  return cudaGetLastError();
}

template <int K, int DH>
int rs(const float* a, const void* b, float* out) {
  CUtensorMap mb;
  int e = map_rows(&mb, b, 1, K, DH, K);
  if (e) return e;
  size_t smem = aligned_smem_bytes<RsSm<K, DH>>();
  e = cudaFuncSetAttribute(probe_rs_k<K, DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  probe_rs_k<K, DH><<<1, 128, smem>>>(a, mb, out);
  return cudaGetLastError();
}

// a (64, dh) and b (n, dh) bf16, out (64, n) fp32.
extern "C" int probe_ss(const void* a, const void* b, float* out, int n,
                        int dh) {
  if (n == 32 && dh == 64) return ss<32, 64>(a, b, out);
  if (n == 32 && dh == 128) return ss<32, 128>(a, b, out);
  if (n == 64 && dh == 64) return ss<64, 64>(a, b, out);
  if (n == 64 && dh == 128) return ss<64, 128>(a, b, out);
  if (n == 32 && dh == 80) return ss<32, 80>(a, b, out);
  if (n == 64 && dh == 80) return ss<64, 80>(a, b, out);
  if (n == 128 && dh == 80) return ss<128, 80>(a, b, out);
  return cudaErrorInvalidValue;
}

// a (64, k) fp32, b (k, dh) bf16, out (64, dh) fp32.
extern "C" int probe_rs(const float* a, const void* b, float* out, int k,
                        int dh) {
  if (k == 32 && dh == 128) return rs<32, 128>(a, b, out);
  if (k == 64 && dh == 64) return rs<64, 64>(a, b, out);
  if (k == 64 && dh == 128) return rs<64, 128>(a, b, out);
  if (k == 32 && dh == 80) return rs<32, 80>(a, b, out);
  if (k == 64 && dh == 80) return rs<64, 80>(a, b, out);
  if (k == 128 && dh == 80) return rs<128, 80>(a, b, out);
  return cudaErrorInvalidValue;
}
