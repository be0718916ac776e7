// Shared device code of the port's attention kernels (sm_90a).
//
// `FlashTile` is the online-softmax core that the fused routing forward
// and the fp32 flash, local-window and gathered forwards share (their bf16
// instances run on the tensor cores, attn_fwd_sm90.cuh): a block of NT = 128 threads owns BQ = 64
// query rows in shared memory and consumes key tiles of BK = 32 rows.
// Thread t works on the 4 query rows 4*(t/8) .. 4*(t/8)+3; for the score
// tile it takes key columns (t%8) + 8j, for the output the head dims
// (t%8) + 8e. The 8 threads of a row group are 8 adjacent lanes of one
// warp, so the row max and row sum of the online softmax are 3 shuffles.
// Products run as fp32 FMAs from shared memory (no tensor cores yet);
// storage is fp32 or bf16, the softmax statistics are always fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG = -1e9f;          // masked logit, as in the JAX package
constexpr int SENTINEL = 1 << 30;     // position of a padded key
constexpr int NT = 128;               // threads per block
constexpr int BQ = 64;                // query rows per block
constexpr int BK = 32;                // key rows per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 16-byte vector loads converted to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// Copy ROWS rows of DH elements into fp32 shared memory with row stride
// STRIDE. row_ptr(r) gives the global row (nullptr: fill zeros).
template <typename T, int DH, int ROWS, int STRIDE, typename RowPtr>
__device__ __forceinline__ void load_rows(float* dst, RowPtr row_ptr) {
  constexpr int V = Vec<T>::N;
  constexpr int CH = DH / V;
  for (int ch = threadIdx.x; ch < ROWS * CH; ch += NT) {
    const int r = ch / CH, c = (ch % CH) * V;
    const T* src = row_ptr(r);
    float tmp[V];
    if (src != nullptr) {
      Vec<T>::load(src + c, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * STRIDE + c + i] = tmp[i];
  }
}

template <int DH>
struct FlashSmem {
  float q[BQ][DH + 1];
  float k[BK][DH + 1];
  float v[BK][DH];
  float p[BQ][BK + 1];
  int qrow[BQ];
  int qpos[BQ];
  int krow[BK];
  int kpos[BK];
};

template <int DH>
struct FlashTile {
  static constexpr int RPT = BQ / (NT / 8);   // query rows per thread: 4
  static constexpr int CPT = BK / 8;          // score columns per thread: 4
  static constexpr int EPT = DH / 8;          // output dims per thread
  float m[RPT], l[RPT], acc[RPT][EPT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      m[i] = NEG;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
    }
  }

  // One key tile: sm.k / sm.v hold nk <= BK rows; keep(row, col) says
  // whether query row `row` of the block may attend key column `col`.
  // Must be entered after a __syncthreads that publishes the tile; ends
  // with one, so the caller may overwrite the tile afterwards.
  template <typename Keep>
  __device__ __forceinline__ void consume(FlashSmem<DH>& sm, int nk,
                                          float scale, Keep keep) {
    const int rg = threadIdx.x >> 3, c = threadIdx.x & 7;
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sm.q[rg * RPT + i][d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sm.k[c + 8 * j][d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg * RPT + i;
      bool kp[CPT];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c + 8 * j;
        kp[j] = col < nk && keep(row, col);
        s[i][j] = kp[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = kp[j] ? expf(s[i][j] - mn) : 0.f;
        sm.p[row][c + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sm.p[rg * RPT + i][j];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float vv = sm.v[j][c + 8 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
    __syncthreads();
  }

  // out_row(row) -> output row pointer or nullptr (row not written);
  // lse_at(row) -> lse slot or nullptr. Rows that attended nothing get
  // out = 0 and lse = NEG + log(1e-30), as the plain version.
  template <typename T, typename OutRow, typename LseAt>
  __device__ __forceinline__ void store(OutRow out_row, LseAt lse_at) {
    const int rg = threadIdx.x >> 3, c = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg * RPT + i;
      T* dst = out_row(row);
      if (dst == nullptr) continue;
      const float lc = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / lc;
#pragma unroll
      for (int e = 0; e < EPT; ++e) dst[c + 8 * e] = from_f<T>(acc[i][e] * inv);
      float* ls = lse_at(row);
      if (c == 0 && ls != nullptr) *ls = m[i] + logf(lc);
    }
  }
};

// The gathered routing kernels' mask on original positions: causal, a key
// at or before the query; otherwise every key that is not padding.
__device__ __forceinline__ bool gathered_keep(int pq, int pk, int causal) {
  return causal ? pq >= pk : pk < SENTINEL;
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes`.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
