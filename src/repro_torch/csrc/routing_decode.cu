// Paged routing decode — CUDA for sm_90a.
//
// Replaces the TPU kernel `_decode_kernel` of
// src/repro/kernels/routing_decode.py (`paged_routing_decode`). For each
// (batch, routing head) it reads the token's cluster id c and the page's
// write counter rlen[c] itself, scores the routing vector r against the
// nvalid = min(rlen, cap) occupied slots of page c of the (kc, cap, dh)
// cache, appends the self logit r.r * scale (scale = 1 / sqrt of the true
// head dim, from the caller), takes an fp32 softmax and returns the
// weighted sum of the page values plus the token's own value, rounded
// once. Slots at or beyond nvalid are never read.
//
// What bounds it on this card: 2 flops per byte of the page it reads, far
// below the ridge, so memory: the selected page (2 * nvalid * dh elements)
// per (b, h). No tensor cores: there is one query row per (b, h), and
// wgmma's smallest M is 64. At the serving shapes the pages of one call
// take well under a microsecond of device memory time, under the time of a
// launch, so what the design wins is latency: the page spread over many
// SMs, wide copies and reads, no serial chain over the slots.
//
// Design: a thread-block cluster of S CTAs per (b, h), S = min(8,
// ceil(cap / 32)) chosen on the host from cap, grid S * B*Hr, one launch.
// - Every CTA reads c and the page lengths side by side (the first 128
//   entries of its rlen row into shared memory, so no load waits on
//   another; a larger c reads its own entry), clamps them as the plain
//   version does and takes its share of the occupied slots: [0, nvalid)
//   split evenly over the S ranks, per = ceil(nvalid / S) slots from
//   rank * per on (a partly filled page still spreads over every rank).
// - Thread 0 copies that range's K rows and V rows by 1-D bulk async copies
//   (cp.async.bulk, completion on an mbarrier), in chunks of C rows (8 KB
//   of K and 8 KB of V) through a two-stage ring, so one chunk's arithmetic
//   overlaps the next chunk's copy and shared memory stays fixed at any cap.
// - Logits with 16-byte reads: a row is NCH = dh * size / 16 chunks. Where
//   they divide a warp (dh 64 and 128), a row takes LPR = NCH lanes (16 at
//   dh 128 in bf16), a warp takes 32 / LPR rows at a time and reduces each
//   in its lane group by shuffles. At dh 192 (24 chunks in bf16, 48 in
//   fp32) a row takes the whole warp: lane q reads chunks q, q + 32, ...
//   (lanes 24-31 idle in bf16) and the warp reduces by shuffles. Warp w
//   owns rows w, w + 4, ... of a chunk.
// - Each warp keeps its own online softmax over its rows (running max m,
//   sum l and acc over all dh columns, dh / 32 a lane, so no thread idles at
//   dh 64); the four warps' partials are folded in warp order in shared
//   memory into the CTA's (m, l, acc), thread t taking columns t, t + 128.
// - The CTAs' partials are combined in distributed shared memory. Every
//   CTA arrives at the cluster barrier on entry and waits for that phase
//   before it writes to another CTA (so rank 0 has started); it then
//   writes its partial into rank 0's shared memory (mapa +
//   st.shared::cluster) and arrives again (release). Rank 0 waits for that
//   phase (acquire), folds the partials in rank order after the token's
//   own logit and value, divides, rounds once and writes o; the other CTAs
//   exit once they have arrived (a cluster barrier waits only for threads
//   that have not exited). One launch, no scratch in device memory.
// - A partial with l = 0 (no slots; its m is NEG) is skipped, so nothing
//   computes inf - inf, and a page with nvalid 0 gives o == v_new bit for
//   bit. Every sum runs in a fixed order (no atomics): the same inputs give
//   the same bits in every run.
// Arithmetic: fp32 logits, softmax and sums from bf16 or fp32 storage; one
// template for both dtypes and the page widths DH 64, 128 and 192. A head
// dim dh below its width (rt-pg19's 129 at 192) is stored in the pages
// zero-padded to it, while r, v_new and o keep their dh columns: r is read
// element by element into zeros past dh (its rows are no 16-byte
// multiple), and only the first dh columns of o are written. Zero columns
// leave every dot product, and so every logit, as it is; at dh == DH the
// 16-byte reads of r are the ones the kernel has always made.
#include "common.cuh"

namespace {

using namespace rt;

constexpr int WARPS = NT / 32;
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int SLOTS_PER_RANK = 32;    // S = min(MAX_CLUSTER, ceil(cap / 32))
constexpr int CHUNK_BYTES = 8192;     // of K, and of V, per ring stage

// ---------------------------------------------------------------------------
// Cluster, mbarrier and bulk-copy helpers (this kernel's own)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The cluster barrier, split: every thread of the cluster arrives once a
// phase (relaxed: orders nothing; release: its writes before, to the
// cluster), and a thread that waits (acquire) waits for every thread of the
// cluster that has not exited.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stores ``v`` at ``p``'s offset in the shared memory of the cluster's CTA
// ``rank``.
__device__ __forceinline__ void st_cluster(float* p, float v,
                                           uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a phase, announcing ``bytes`` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst``, both
// 16-byte aligned, by the copy engine; completes on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// E consecutive elements (4, 2 or 6; 16, 8 or 4 bytes a read) converted
// to fp32.
template <int E>
__device__ __forceinline__ void load_cols(const float* src, float* dst) {
  if constexpr (E == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + e);
      dst[e] = v.x; dst[e + 1] = v.y;
    }
  }
}
template <int E>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* src,
                                          float* dst) {
  if constexpr (E == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + e));
      dst[e] = a.x; dst[e + 1] = a.y;
    }
  }
}

template <typename T, int DH>
struct Decode {
  static constexpr int ROW_BYTES = DH * static_cast<int>(sizeof(T));
  static constexpr int C = CHUNK_BYTES / ROW_BYTES;  // rows a chunk, 10..64
  static constexpr int V = Vec<T>::N;                 // elements in 16 bytes
  static constexpr int NCH = DH / V;                  // 16-byte chunks a row
  // a warp a row where the chunks do not divide a warp (dh 192)
  static constexpr bool kWarpRow = NCH > 32 || 32 % NCH != 0;
  static constexpr int LPR = kWarpRow ? 32 : NCH;     // lanes a row (logits)
  static constexpr int RPS = 32 / LPR;                // rows a warp step
  static constexpr int CPL = (NCH + LPR - 1) / LPR;   // chunks a lane: 1, 2
  static constexpr int EPL = DH / 32;                 // value columns a lane
  static_assert(DH % 64 == 0 && EPL % 2 == 0 && C >= 1, "row layout");
  struct Smem {
    alignas(128) T k[2][C * DH];     // the ring: K rows of a chunk a stage
    alignas(128) T v[2][C * DH];     // and its V rows
    float logit[C];                  // a chunk's logits (row j: warp j % 4)
    float wacc[WARPS][DH];           // the warps' partials
    float wm[WARPS], wl[WARPS];
    float acc_of[MAX_CLUSTER][DH];   // rank 0: the CTAs' partials
    float m_of[MAX_CLUSTER], l_of[MAX_CLUSTER];
    int rlen[NT];                    // the first NT entries of the rlen row
    alignas(8) uint64_t full[2];     // a stage's copies have landed
  };
};

template <typename T, int DH>
__global__ void __launch_bounds__(NT) routing_decode_cluster(
    const T* __restrict__ r, const T* __restrict__ v_new,
    const T* __restrict__ rk, const T* __restrict__ rv,
    const int* __restrict__ rlen, const int* __restrict__ cluster,
    T* __restrict__ o, int kc, int cap, int dh, float scale) {
  using D = Decode<T, DH>;
  constexpr int C = D::C, V = D::V, LPR = D::LPR, RPS = D::RPS;
  constexpr int CPL = D::CPL, EPL = D::EPL;
  __shared__ typename D::Smem sm;
  // this CTA has started: the others may write to its shared memory once
  // they have waited for this phase
  cluster_arrive_relaxed();
  const uint32_t rank = cluster_rank(), S = cluster_ctas();
  const size_t bh = blockIdx.x / S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the cluster id and the page lengths, read side by side
  const int cl = cluster[bh];
  if (threadIdx.x < kc) sm.rlen[threadIdx.x] = rlen[bh * kc + threadIdx.x];
  if (threadIdx.x == 0) {
    mbar_init(&sm.full[0]);
    mbar_init(&sm.full[1]);
    fence_mbar_init();
  }
  // lane group g of LPR lanes takes a row; lane q of it the row's 16-byte
  // chunks q, q + LPR, ... (one chunk where the chunks divide a warp)
  const int g = lane / LPR, q = lane % LPR;
  float rs[CPL][V];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int ch = q + i * LPR;
    if (dh == DH && (!D::kWarpRow || ch < D::NCH)) {
      Vec<T>::load(r + bh * DH + ch * V, rs[i]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int col = ch * V + e;
        rs[i][e] = col < dh ? to_f(r[bh * dh + col]) : 0.f;
      }
    }
  }
  __syncthreads();   // the lengths and the mbarriers are ready

  // this rank's share of the occupied slots [0, nvalid) of page c
  const int c = min(max(cl, 0), kc - 1);
  const int nvalid = min(max(c < NT ? sm.rlen[c] : rlen[bh * kc + c], 0),
                         cap);
  const int per = (nvalid + static_cast<int>(S) - 1) / static_cast<int>(S);
  const int lo = min(static_cast<int>(rank) * per, nvalid);
  const int n = min(lo + per, nvalid) - lo;
  const int chunks = (n + C - 1) / C;
  const size_t first = ((bh * kc + c) * cap + lo) * DH;
  auto issue = [&](int i) {
    const int s = i & 1;
    const uint32_t bytes = min(C, n - i * C) * D::ROW_BYTES;
    const size_t at = first + static_cast<size_t>(i) * C * DH;
    mbar_expect_tx(&sm.full[s], 2 * bytes);
    bulk_copy(sm.k[s], rk + at, bytes, &sm.full[s]);
    bulk_copy(sm.v[s], rv + at, bytes, &sm.full[s]);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(chunks, 2); ++i) issue(i);

  float m = NEG, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int i = 0; i < chunks; ++i) {
    const int s = i & 1;
    const int rows = min(C, n - i * C);
    const int mine = rows > warp ? (rows - warp + WARPS - 1) / WARPS : 0;
    mbar_wait(&sm.full[s], (i >> 1) & 1);
    const T* ks = sm.k[s];
    const T* vs = sm.v[s];
    // the logits of this warp's rows, RPS rows a step
    for (int t0 = 0; t0 < mine; t0 += RPS) {
      const int t = t0 + g, j = warp + WARPS * t;
      float d = 0.f;
      if (t < mine) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int ch = q + i * LPR;
          if (D::kWarpRow && ch >= D::NCH) continue;
          float kv[V];
          Vec<T>::load(ks + j * DH + ch * V, kv);
#pragma unroll
          for (int e = 0; e < V; ++e) d = fmaf(rs[i][e], kv[e], d);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (q == 0 && t < mine) sm.logit[j] = d * scale;
    }
    __syncwarp();
    // the warp's online softmax and P V over its rows, all dh columns
    float mx = m;
    for (int j = warp; j < rows; j += WARPS) mx = fmaxf(mx, sm.logit[j]);
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
    for (int j = warp; j < rows; j += WARPS) {
      const float p = expf(sm.logit[j] - mx);
      float vv[EPL];
      load_cols<EPL>(vs + j * DH + lane * EPL, vv);
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
    }
    m = mx;
    __syncthreads();   // stage s and the logits are free
    if (threadIdx.x == 0 && i + 2 < chunks) issue(i + 2);
  }

  // the CTA's partial: the warps' folded in warp order
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm.wacc[warp][lane * EPL + e] = acc[e];
  if (lane == 0) {
    sm.wm[warp] = m;
    sm.wl[warp] = l;
  }
  __syncthreads();
  // rank 0 computes the token's own logit meanwhile
  float self = 0.f;
  if (rank == 0 && threadIdx.x < DH) {
    for (int e = lane; e < dh; e += 32) {
      const float x = to_f(r[bh * dh + e]);
      self = fmaf(x, x, self);
    }
    self = warp_sum(self) * scale;
  }
  cluster_wait();    // every CTA of the cluster has started
  for (int d = threadIdx.x; d < DH; d += NT) {
    float M = NEG, a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (sm.wl[w] > 0.f) M = fmaxf(M, sm.wm[w]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (sm.wl[w] > 0.f) {
        const float f = expf(sm.wm[w] - M);
        a = fmaf(f, sm.wacc[w][d], a);
        L = fmaf(f, sm.wl[w], L);
      }
    }
    // the CTA's partial, into rank 0's shared memory
    st_cluster(&sm.acc_of[rank][d], a, 0);
    if (d == 0) {
      st_cluster(&sm.m_of[rank], M, 0);
      st_cluster(&sm.l_of[rank], L, 0);
    }
  }
  cluster_arrive();  // release: this CTA's partial has been written
  if (rank != 0) return;
  cluster_wait();    // acquire: every CTA's partial is here

  for (int d = threadIdx.x; d < dh; d += NT) {
    float M = self;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < static_cast<int>(S) && sm.l_of[k] > 0.f)
        M = fmaxf(M, sm.m_of[k]);
    // the token itself first: with no occupied slot, o is v_new exactly
    const float fs = expf(self - M);
    float a = fs * to_f(v_new[bh * dh + d]), L = fs;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < static_cast<int>(S) && sm.l_of[k] > 0.f) {
        const float f = expf(sm.m_of[k] - M);
        a = fmaf(f, sm.acc_of[k][d], a);
        L = fmaf(f, sm.l_of[k], L);
      }
    }
    o[bh * dh + d] = from_f<T>(a / L);
  }
}

template <typename T, int DH>
int launch(const void* r, const void* v_new, const void* rk, const void* rv,
           const int* rlen, const int* cluster, void* o, int BH, int kc,
           int cap, int dh, float scale, cudaStream_t stream) {
  if (BH < 1 || kc < 1 || cap < 1 || dh < 1 || dh > DH)
    return cudaErrorInvalidValue;
  const int want = (cap + SLOTS_PER_RANK - 1) / SLOTS_PER_RANK;
  const int S = want < MAX_CLUSTER ? want : MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S) * static_cast<unsigned>(BH));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, routing_decode_cluster<T, DH>, static_cast<const T*>(r),
      static_cast<const T*>(v_new), static_cast<const T*>(rk),
      static_cast<const T*>(rv), rlen, cluster, static_cast<T*>(o), kc, cap,
      dh, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// r/v_new (B*Hr, dh), rk/rv (B*Hr, kc, cap, width), rlen (B*Hr, kc) int32,
// cluster (B*Hr) int32; o (B*Hr, dh). width: 64, 128 or 192, dh <= width
// (the pages' pad columns zero); scale: 1 / sqrt(dh). dtype: 0 fp32, 1
// bf16. Every pointer 16-byte aligned (the bulk copies and vector reads
// need it).
extern "C" int routing_decode_fwd(const void* r, const void* v_new,
                                  const void* rk, const void* rv,
                                  const int* rlen, const int* cluster,
                                  void* o, int BH, int kc, int cap, int dh,
                                  int width, int dtype, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && width == 128)
    return launch<__nv_bfloat16, 128>(r, v_new, rk, rv, rlen, cluster, o, BH,
                                      kc, cap, dh, scale, s);
  if (dtype == 1 && width == 64)
    return launch<__nv_bfloat16, 64>(r, v_new, rk, rv, rlen, cluster, o, BH,
                                     kc, cap, dh, scale, s);
  if (dtype == 1 && width == 192)
    return launch<__nv_bfloat16, 192>(r, v_new, rk, rv, rlen, cluster, o, BH,
                                      kc, cap, dh, scale, s);
  if (dtype == 0 && width == 128)
    return launch<float, 128>(r, v_new, rk, rv, rlen, cluster, o, BH, kc, cap,
                              dh, scale, s);
  if (dtype == 0 && width == 64)
    return launch<float, 64>(r, v_new, rk, rv, rlen, cluster, o, BH, kc, cap,
                             dh, scale, s);
  if (dtype == 0 && width == 192)
    return launch<float, 192>(r, v_new, rk, rv, rlen, cluster, o, BH, kc, cap,
                              dh, scale, s);
  return cudaErrorInvalidValue;
}
