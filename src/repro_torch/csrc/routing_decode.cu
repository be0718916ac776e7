// Paged routing decode — CUDA for sm_90a.
//
// Replaces the TPU kernel `_decode_kernel` of
// src/repro/kernels/routing_decode.py (`paged_routing_decode`). One block
// per (batch, routing head): it reads the token's cluster id c and the
// page's write counter rlen[c] itself, scores the routing vector r against
// the min(rlen, cap) occupied slots of page c of the (kc, cap, dh) cache,
// appends the self logit r.r / sqrt(dh), takes an fp32 softmax and returns
// the weighted sum of the page values plus the token's own value. Slots at
// or beyond min(rlen, cap) are never read.
//
// What bounds it on this card: 2 flops per byte of the page it reads, far
// below the ridge, so it is bound by memory: the selected page
// (2 * nvalid * dh elements) per (b, h).
// What the design does about it: only the selected page is read, once,
// with each warp taking whole rows (coalesced), and nothing is gathered to
// device memory first. Any cap works: the logits live in dynamic shared
// memory of cap + 1 floats.
#include "common.cuh"

namespace {

using namespace rt;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide reduction of NT threads; `scratch` holds NT / 32 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float y = scratch[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) y = MAX ? fmaxf(y, scratch[i]) : y + scratch[i];
  return y;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ v_new,
    const T* __restrict__ rk, const T* __restrict__ rv,
    const int* __restrict__ rlen, const int* __restrict__ cluster,
    T* __restrict__ o, int kc, int cap, float scale) {
  extern __shared__ float logits[];            // cap + 1
  __shared__ float rs[DH];
  __shared__ float scratch[NT / 32];
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = min(max(cluster[bh], 0), kc - 1);
  const int nvalid = min(max(rlen[static_cast<size_t>(bh) * kc + c], 0), cap);
  const size_t page = (static_cast<size_t>(bh) * kc + c) * cap * DH;
  const T* pk = rk + page;
  const T* pv = rv + page;

  for (int d = threadIdx.x; d < DH; d += NT)
    rs[d] = to_f(r[static_cast<size_t>(bh) * DH + d]);
  __syncthreads();

  // logits of the occupied slots, one warp per slot; the self logit last
  for (int j = warp; j <= nvalid; j += NT / 32) {
    const T* row = j < nvalid ? pk + static_cast<size_t>(j) * DH
                              : r + static_cast<size_t>(bh) * DH;
    float acc = 0.f;
    for (int d = lane; d < DH; d += 32) acc = fmaf(rs[d], to_f(row[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) logits[j] = acc * scale;
  }
  __syncthreads();

  float mx = NEG;
  for (int j = threadIdx.x; j <= nvalid; j += NT) mx = fmaxf(mx, logits[j]);
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.f;
  for (int j = threadIdx.x; j <= nvalid; j += NT) {
    const float p = expf(logits[j] - mx);
    logits[j] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, scratch);   // its barriers publish logits[]
  const float inv = 1.f / sum;

  for (int d = threadIdx.x; d < DH; d += NT) {
    float acc = logits[nvalid] * to_f(v_new[static_cast<size_t>(bh) * DH + d]);
    for (int j = 0; j < nvalid; ++j)
      acc = fmaf(logits[j], to_f(pv[static_cast<size_t>(j) * DH + d]), acc);
    o[static_cast<size_t>(bh) * DH + d] = from_f<T>(acc * inv);
  }
}

template <typename T, int DH>
int launch(const void* r, const void* v_new, const void* rk, const void* rv,
           const int* rlen, const int* cluster, void* o, int BH, int kc,
           int cap, cudaStream_t stream) {
  auto kernel = routing_decode_kernel<T, DH>;
  const size_t smem = static_cast<size_t>(cap + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<BH, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(v_new),
      static_cast<const T*>(rk), static_cast<const T*>(rv), rlen, cluster,
      static_cast<T*>(o), kc, cap, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// r/v_new (B*Hr, dh), rk/rv (B*Hr, kc, cap, dh), rlen (B*Hr, kc) int32,
// cluster (B*Hr) int32; o (B*Hr, dh). dtype: 0 fp32, 1 bf16.
extern "C" int routing_decode_fwd(const void* r, const void* v_new,
                                  const void* rk, const void* rv,
                                  const int* rlen, const int* cluster,
                                  void* o, int BH, int kc, int cap, int dh,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(r, v_new, rk, rv, rlen, cluster, o, BH,
                                      kc, cap, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(r, v_new, rk, rv, rlen, cluster, o, BH,
                                     kc, cap, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(r, v_new, rk, rv, rlen, cluster, o, BH, kc, cap,
                              s);
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(r, v_new, rk, rv, rlen, cluster, o, BH, kc, cap,
                             s);
  return cudaErrorInvalidValue;
}
