// Hopper (sm_90a) building blocks of the port's tensor-core kernels (the
// bf16 forward body, attn_fwd_sm90.cuh, and backward bodies,
// attn_bwd_sm90.cuh, of the flash, local-window and routing kernels):
// mbarriers, a warpgroup's named barrier, TMA tile loads from a tensor
// map, a ring of stages that TMA fills and warpgroups consume, cp.async
// gathers of rows picked by index into the same swizzled tiles (the fused
// routing kernels), the wgmma shared-memory descriptor of the 128-byte
// swizzle, and the bf16 `wgmma` instructions (fp32 accumulators) in SS form
// (A and B from shared memory, both K-major, m64n32k16, m64n64k16 and
// m64n128k16) and RS form (A from registers, B MN-major, m64n64k16,
// m64n80k16, m64n128k16, m64n192k16 and m64n256k16), and the block-wide
// min/max reductions that the gathered kernels' walks take. Raw PTX, so a
// source that includes this header builds in seconds.
//
// Tiles: a tensor map cuts a (rows, dh) bf16 plane into boxes of 64
// columns (128 bytes, the widest box the 128-byte swizzle takes) by R
// rows; a box lands in shared memory as R rows of 128 bytes, 1024-byte
// aligned, swizzled in atoms of 8 rows. A head of 128 columns is two
// boxes, one after the other. A head of 80 is two boxes too: the second
// holds columns 64-79 and zeros, which TMA writes for the columns past
// the plane's dh (and counts in the box's bytes).
//
// wgmma reads such a box in two ways (the descriptor's fields are in
// 16-byte units):
// - K-major (the reduction runs along the row): 8-row groups 1024 bytes
//   apart (SBO); the k16 slice kk of a box starts kk * 32 bytes in.
// - MN-major (the reduction runs down the rows; the transpose bit): 8-row
//   groups 1024 bytes apart (SBO), 64-column groups one box apart (LBO);
//   the k16 slice kk starts kk * 16 rows = kk * 2048 bytes in.
//
// Fragments (m64nNk16, fp32 accumulator): thread t of the warpgroup holds
// rows r = 16 * (t / 32) + (t % 32) / 4 and r + 8; register 4j + e is
// (r, 8j + 2(t % 4) + e), register 4j + 2 + e is (r + 8, same column).
// The bf16 A fragment of an RS k16 slice c is the accumulator's columns
// 16c .. 16c + 15 packed in pairs: registers 8c .. 8c + 7 in order
// (`pack_a`), or as two: its bf16 rounding and the bf16 rounding of what
// that leaves (`pack_a_split`), whose two products sum to the fp32 value's
// product within ~2^-16 of it.
#pragma once

#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int BOX_COLS = 64;             // bf16 columns of one box (128 B)
constexpr int ROW_BYTES = 128;           // bytes of one box row
constexpr uint32_t ATOM_BYTES = 1024;    // 8 rows x 128 B: one swizzle atom
constexpr int RING_STAGES = 2;           // stages of a kernel's TMA ring
constexpr int BLOCK_THREADS = 2 * WG;    // two consumer warpgroups a block

// 64-column boxes of a tile row of dh columns: dh / 64, and two at dh 80
template <int DH>
__host__ __device__ constexpr int head_boxes() {
  return (DH + BOX_COLS - 1) / BOX_COLS;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces ``bytes`` of TMA transfers to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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

// The 128 threads of one warpgroup wait for each other (barrier ``id``,
// 1..15; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG) : "memory");
}

// ---------------------------------------------------------------------------
// A ring of shared-memory stages that TMA fills
// ---------------------------------------------------------------------------
// A block of BLOCK_THREADS keeps one set of tiles resident (loaded once,
// counted on its own barrier) and walks the others through the ring: tile
// j of the walk lands in stage j % RING_STAGES. Thread 0 of the block is
// the producer: a kernel's load(j) takes the barrier `produce` returns
// (once the stage's previous tile is released) for its TMA loads. Each
// consumer warpgroup waits for tile j with `wait`; `advance` releases the
// stage and has thread 0 load the tile that takes it next.
struct Ring {
  static constexpr int S = RING_STAGES;
  uint64_t full[S], empty[S];

  // The whole block: thread 0 initialises ``resident`` (one arrival, with
  // the resident tiles' bytes) and the ring (one release per warpgroup);
  // then the block syncs.
  __device__ __forceinline__ void init(uint64_t* resident) {
    if (threadIdx.x == 0) {
      mbar_init(resident, 1);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], BLOCK_THREADS / WG);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
  // Thread 0: the first tiles of a walk of ``ntiles``, one per stage.
  template <typename Load>
  __device__ __forceinline__ void prime(int ntiles, Load load) {
    for (int j = 0; j < min(S, ntiles); ++j) load(j);
  }
  __device__ __forceinline__ uint64_t* produce(int j, uint32_t bytes) {
    const int s = j % S;
    if (j >= S) mbar_wait(&empty[s], (j / S - 1) & 1);
    mbar_expect_tx(&full[s], bytes);
    return &full[s];
  }
  __device__ __forceinline__ void wait(int j) {
    mbar_wait(&full[j % S], (j / S) & 1);
  }
  // Every thread, once its warpgroup is done with tile j of ``ntiles``.
  template <typename Load>
  __device__ __forceinline__ void advance(int j, int ntiles, Load load) {
    if (threadIdx.x % WG == 0) mbar_arrive(&empty[j % S]);
    if (threadIdx.x == 0 && j + S < ntiles) load(j + S);
  }
};

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// The box of ``map`` at coordinates (c0 column, c1 row, c2 plane) into
// shared memory at ``dst``; completion is counted on ``bar``. Rows past the
// plane's end arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// cp.async: rows picked by index, into the tiles TMA would land
// ---------------------------------------------------------------------------
// 16 bytes from global ``src`` to shared ``dst`` (both 16-byte aligned);
// with ``bytes`` 0, 16 zero bytes, and nothing is read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most ``PENDING`` of the calling thread's committed groups
// of copies are still in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// Makes the calling thread's completed writes to shared memory through the
// generic proxy (cp.async, st.shared) visible to the async proxy, which
// wgmma reads through; a barrier then carries them to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ROWS rows of a bf16 (rows, DH) plane into a tile of DH / 64 boxes of
// ROWS x 128 bytes, laid out as TMA lands a box under
// CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk c of row r at byte
// r * 128 + ((c ^ (r % 8)) * 16) of its box (box base 1024-byte aligned).
// Tile row r is plane row ``row(r)``, or zeros where that is negative (as
// TMA fills rows past a plane). All BLOCK_THREADS threads, one 16-byte
// copy each at a time, neighbouring threads on neighbouring chunks of a
// row; each thread keeps one chunk and row % 8, so its swizzled offset is
// fixed. The copies belong to the calling thread's next committed group.
// At dh 192 a row's 24 chunks do not divide the block: each thread then
// keeps one chunk of a box row (8 a row) and copies it from each of the
// three boxes of its rows.
template <int DH, int ROWS, typename Row>
__device__ __forceinline__ void gather_rows(void* tile,
                                            const __nv_bfloat16* plane,
                                            Row row) {
  constexpr int CHUNKS = DH / 8;   // 16-byte chunks of a row
  if constexpr (BLOCK_THREADS % CHUNKS != 0) {
    constexpr int BOXES = DH / BOX_COLS, STEP = BLOCK_THREADS / 8;
    static_assert(ROWS % STEP == 0 && STEP % 8 == 0, "whole copies");
    const int c = threadIdx.x % 8, r0 = threadIdx.x / 8;
    char* dst = static_cast<char*>(tile) + r0 * ROW_BYTES +
                ((c ^ (r0 % 8)) * 16);
#pragma unroll
    for (int m = 0; m < ROWS / STEP; ++m) {
      const int i = row(r0 + m * STEP);   // (r0 + m * STEP) % 8 == r0 % 8
      const __nv_bfloat16* src =
          plane + static_cast<size_t>(i < 0 ? 0 : i) * DH + c * 8;
#pragma unroll
      for (int x = 0; x < BOXES; ++x)
        cp_async_16(dst + x * ROWS * ROW_BYTES + m * STEP * ROW_BYTES,
                    src + x * BOX_COLS, i < 0 ? 0u : 16u);
    }
  } else {
    constexpr int PER = ROWS * CHUNKS / BLOCK_THREADS;
    static_assert(PER * BLOCK_THREADS == ROWS * CHUNKS, "whole copies");
    const int c = threadIdx.x % CHUNKS, r0 = threadIdx.x / CHUNKS;
    char* dst = static_cast<char*>(tile) + (c / 8) * ROWS * ROW_BYTES +
                r0 * ROW_BYTES + (((c % 8) ^ (r0 % 8)) * 16);
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int r = r0 + m * (BLOCK_THREADS / CHUNKS);   // r % 8 == r0 % 8
      const int i = row(r);
      cp_async_16(dst + m * (BLOCK_THREADS / CHUNKS) * ROW_BYTES,
                  plane + static_cast<size_t>(i < 0 ? 0 : i) * DH + c * 8,
                  i < 0 ? 0u : 16u);
    }
  }
}

// P::kGatherRows where the policy has it, else false: whether a body's
// policy gathers its rows by cp.async (`gather_rows`) instead of TMA.
template <typename P, typename = void>
struct GathersRows {
  static constexpr bool value = false;
};
template <typename P>
struct GathersRows<P, decltype(void(P::kGatherRows))> {
  static constexpr bool value = P::kGatherRows;
};

// The gathering policies' wait for the copies of tile j: each thread's own,
// then the async proxy's view, then the block's.
__device__ __forceinline__ void gathered_tile_ready() {
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled tile in shared memory (1024-byte
// aligned); ``lbo`` and ``sbo`` in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(smem) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;   // layout: 128-byte swizzle
  return d;
}

// A K-major operand's k16 slice ``kk`` of a tile stored as boxes of
// ``box_bytes`` each (dh / 64 boxes of 64 columns).
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk,
                                           uint32_t box_bytes) {
  const char* p = static_cast<const char*>(tile) + (kk / 4) * box_bytes +
                  (kk % 4) * 32;
  return desc_sw128(p, 16, ATOM_BYTES);
}

// An MN-major operand's k16 slice ``kk`` (rows 16kk .. 16kk + 15) of a tile
// stored as boxes of ``box_bytes`` each.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk,
                                            uint32_t box_bytes) {
  const char* p = static_cast<const char*>(tile) + kk * 16 * ROW_BYTES;
  return desc_sw128(p, box_bytes, ATOM_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keeps the compiler from moving reads or writes of ``r`` across an
// asynchronous wgmma that uses them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The RS A fragments of an fp32 accumulator of R registers (R / 8 k16
// slices), rounded to bf16.
template <int R>
__device__ __forceinline__ void pack_a(const float (&d)[R],
                                       uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int c = 0; c < R / 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[c][i] = pack_bf16(d[8 * c + 2 * i], d[8 * c + 2 * i + 1]);
}

// The same, with the value x of each element as two bf16 fragments:
// hi = bf16(x) and lo = bf16(x - hi).
template <int R>
__device__ __forceinline__ void pack_a_split(const float (&d)[R],
                                             uint32_t (&hi)[R / 8][4],
                                             uint32_t (&lo)[R / 8][4]) {
#pragma unroll
  for (int c = 0; c < R / 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = d[8 * c + 2 * i], x1 = d[8 * c + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[c][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[c][i] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// D (64 x 32) (+)= A (64 x 16) . B (16 x 32), both from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64) (+)= A (64 x 16) . B (16 x 64), both from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128) (+)= A (64 x 16) . B (16 x 128), both from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64) (+)= A (64 x 16, registers) . B (16 x 64), B from shared
// memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 80) (+)= A (64 x 16, registers) . B (16 x 80), B from shared
// memory, MN-major (the transpose bit): the backward's dV, dK and dQ at dh
// 80, whose B spans the first box's 64 columns and the first 16 of the
// second (one box apart, as n128 reads them; TMA filled the rest of the
// second box with zeros, which this product does not read).
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 128) (+)= A (64 x 16, registers) . B (16 x 128), B from shared
// memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 192) (+)= A (64 x 16, registers) . B (16 x 192), B from shared
// memory, MN-major (the transpose bit): the products of the kernels' dh-192
// instances (three 64-column groups, one box apart).
__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 256) (+)= A (64 x 16, registers) . B (16 x 256), B from shared
// memory, MN-major (the transpose bit): the forward's P V at dh 256 (four
// 64-column groups, one box apart).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Block-wide reductions (the gathered kernels' walks)
// ---------------------------------------------------------------------------
// The smallest (low) and largest (high) of two per-thread values over the
// block (warps 0..7), and over the 64 owned rows of the calling thread's
// warpgroup when warps 0-3 hold one owned row a thread (warpgroup 0's in
// warps 0-1, 1's in 2-3); `red` holds one value per warp.
struct BlockMinMax {
  int low, high, rows_low, rows_high;
};
__device__ __forceinline__ BlockMinMax block_min_max(int low, int high,
                                                     int (&red)[2][8]) {
  const int warp = threadIdx.x / 32;
  low = __reduce_min_sync(0xffffffffu, low);
  high = __reduce_max_sync(0xffffffffu, high);
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = low;
    red[1][warp] = high;
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  BlockMinMax b{low, high, min(red[0][2 * wg], red[0][2 * wg + 1]),
                max(red[1][2 * wg], red[1][2 * wg + 1])};
#pragma unroll
  for (int i = 0; i < BLOCK_THREADS / 32; ++i) {
    b.low = min(b.low, red[0][i]);
    b.high = max(b.high, red[1][i]);
  }
  __syncthreads();   // red is free again
  return b;
}

// The walk over the other side's w rows: the tiles of ``rows`` rows from
// the first to the last row that ``needed`` keeps.
template <typename Needed>
__device__ __forceinline__ void walk(int w, int rows, int (&red)[2][8],
                                     Needed needed, int& first,
                                     int& ntiles) {
  int lo = INT_MAX, hi = -1;
  for (int i = threadIdx.x; i < w; i += BLOCK_THREADS)
    if (needed(i)) {
      lo = min(lo, i);
      hi = max(hi, i);
    }
  const BlockMinMax b = block_min_max(lo, hi, red);
  first = b.high < 0 ? 0 : b.low / rows * rows;
  ntiles = b.high < 0 ? 0 : b.high / rows - b.low / rows + 1;
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up at run time, so the
// library needs no -lcuda. cudaGetDriverEntryPointByVersion needs CUDA 12.5
// or later.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a bf16 tensor (planes, rows, dh), contiguous, in boxes of 64
// columns by ``box_rows`` rows of one plane, 128-byte swizzled; rows past a
// plane's end and columns past dh (the second box of dh 80) read as zeros.
// Returns a cudaError_t code.
inline int map_rows(CUtensorMap* map, const void* base, int planes, int rows,
                    int dh, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(dh) * 2,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(dh) * 2};
  const cuuint32_t box[3] = {BOX_COLS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A struct of tiles in dynamic shared memory, placed at the first 1024-byte
// boundary (the swizzle atoms need it): the bytes to ask for, and the place.
template <typename Sm>
constexpr size_t aligned_smem_bytes() {
  return sizeof(Sm) + 1024;
}
template <typename Sm>
__device__ __forceinline__ Sm& aligned_smem(unsigned char* raw) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(raw);
  return *reinterpret_cast<Sm*>((a + 1023) & ~uintptr_t(1023));
}

}  // namespace sm90
