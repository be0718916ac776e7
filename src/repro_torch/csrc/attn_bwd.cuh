// Shared device code of the port's attention backward kernels (sm_90a).
//
// Both backward kernels of the local-window and of the fused routing
// attention recompute the probabilities from the forward's per-row
// log-sum-exp instead of storing them:
//   p  = keep ? exp(q.k * scale - lse) : 0
//   ds = p * (do.v - D) * scale,  D = rowsum(do * out) (computed outside)
//   dq = ds . K,   dk = ds^T . Q,   dv = p^T . dO
// p is masked explicitly, never by underflow: a row that attends no key
// has lse = -1e9 + log(1e-30), which rounds to -1e9 in fp32, so exp(s - lse)
// of a masked score (s = -1e9) would read ~1.
//
// `DqTile`: a block of NT = 128 threads owns BQ = 64 query rows (q, do,
// lse, D in shared memory) and walks key tiles of BK = 32 rows, as the
// forward's `FlashTile` does (same thread layout: 4 rows x 4 key columns
// per thread for the score tile, 4 rows x DH/8 dims for the sum).
// `DkvTile`: a block owns BKR = 64 key rows (k, v) and walks query tiles of
// BQT = 32 rows (q, do, lse, D); rows and columns swap roles.
// Products are fp32 FMAs from shared memory (no tensor cores yet); outputs
// are fp32, like the TPU kernels'.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int BKR = 64;               // key rows per dk/dv block
constexpr int BQT = 32;               // query rows per dk/dv sweep tile

template <int DH>
struct DqSmem {
  float q[BQ][DH + 1];
  float dO[BQ][DH + 1];
  float k[BK][DH + 1];
  float v[BK][DH + 1];
  float ds[BQ][BK + 1];
  float lse[BQ];
  float dsum[BQ];
  int qrow[BQ];
  int qpos[BQ];
  int krow[BK];
  int kpos[BK];
};

template <int DH>
struct DqTile {
  static constexpr int RPT = BQ / (NT / 8);   // query rows per thread: 4
  static constexpr int CPT = BK / 8;          // key columns per thread: 4
  static constexpr int EPT = DH / 8;          // output dims per thread
  float acc[RPT][EPT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
  }

  // One key tile of nk <= BK rows in sm.k / sm.v; keep(row, col) as in the
  // forward. Entered after a __syncthreads that publishes the tile (and the
  // query rows); ends with one.
  template <typename Keep>
  __device__ __forceinline__ void consume(DqSmem<DH>& sm, int nk,
                                          float scale, Keep keep) {
    const int rg = threadIdx.x >> 3, c = threadIdx.x & 7;
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = sm.q[rg * RPT + i][d];
        ov[i] = sm.dO[rg * RPT + i][d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = sm.k[c + 8 * j][d];
        vv[j] = sm.v[c + 8 * j][d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg * RPT + i;
      const float l = sm.lse[row], dd = sm.dsum[row];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c + 8 * j;
        const bool kp = col < nk && keep(row, col);
        const float p = kp ? expf(s[i][j] * scale - l) : 0.f;
        sm.ds[row][col] = p * (dp[i][j] - dd) * scale;
      }
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float dv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dv[i] = sm.ds[rg * RPT + i][j];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float kv = sm.k[j][c + 8 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][e] = fmaf(dv[i], kv, acc[i][e]);
      }
    }
    __syncthreads();
  }

  // out_row(row) -> fp32 output row or nullptr (row not written).
  template <typename OutRow>
  __device__ __forceinline__ void store(OutRow out_row) {
    const int rg = threadIdx.x >> 3, c = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float* dst = out_row(rg * RPT + i);
      if (dst == nullptr) continue;
#pragma unroll
      for (int e = 0; e < EPT; ++e) dst[c + 8 * e] = acc[i][e];
    }
  }
};

template <int DH>
struct DkvSmem {
  float k[BKR][DH + 1];
  float v[BKR][DH + 1];
  float q[BQT][DH + 1];
  float dO[BQT][DH + 1];
  float p[BKR][BQT + 1];
  float ds[BKR][BQT + 1];
  float lse[BQT];
  float dsum[BQT];
  int krow[BKR];
  int kpos[BKR];
  int qrow[BQT];
  int qpos[BQT];
};

template <int DH>
struct DkvTile {
  static constexpr int RPT = BKR / (NT / 8);  // key rows per thread: 4
  static constexpr int CPT = BQT / 8;         // query columns per thread: 4
  static constexpr int EPT = DH / 8;          // output dims per thread
  float dk[RPT][EPT], dv[RPT][EPT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < EPT; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  // One query tile of nq <= BQT rows in sm.q / sm.dO / sm.lse / sm.dsum;
  // keep(key_row, query_col). Entered after a __syncthreads that publishes
  // the tile (and the key rows); ends with one.
  template <typename Keep>
  __device__ __forceinline__ void consume(DkvSmem<DH>& sm, int nq,
                                          float scale, Keep keep) {
    const int rg = threadIdx.x >> 3, c = threadIdx.x & 7;
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = sm.k[rg * RPT + i][d];
        vv[i] = sm.v[rg * RPT + i][d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = sm.q[c + 8 * j][d];
        ov[j] = sm.dO[c + 8 * j][d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c + 8 * j;
        const bool kp = col < nq && keep(row, col);
        const float p = kp ? expf(s[i][j] * scale - sm.lse[col]) : 0.f;
        sm.p[row][col] = p;
        sm.ds[row][col] = p * (dp[i][j] - sm.dsum[col]) * scale;
      }
    }
    __syncthreads();
    for (int j = 0; j < nq; ++j) {
      float pv[RPT], sv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = sm.p[rg * RPT + i][j];
        sv[i] = sm.ds[rg * RPT + i][j];
      }
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float qv = sm.q[j][c + 8 * e], ov = sm.dO[j][c + 8 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dv[i][e] = fmaf(pv[i], ov, dv[i][e]);
          dk[i][e] = fmaf(sv[i], qv, dk[i][e]);
        }
      }
    }
    __syncthreads();
  }

  // dk_row(row) / dv_row(row) -> fp32 output rows or nullptr.
  template <typename KRow, typename VRow>
  __device__ __forceinline__ void store(KRow dk_row, VRow dv_row) {
    const int rg = threadIdx.x >> 3, c = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg * RPT + i;
      float* gk = dk_row(row);
      float* gv = dv_row(row);
      if (gk == nullptr) continue;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        gk[c + 8 * e] = dk[i][e];
        gv[c + 8 * e] = dv[i][e];
      }
    }
  }
};

}  // namespace rt
