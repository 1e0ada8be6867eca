// Hopper (sm_90a) mainloop of the port's prefill-shaped attention, shared by
//  * flash prefill (flash_attention.cu; TPU kernel
//    src/repro/kernels/flash_attention/kernel.py:104), and
//  * the unsplit (prefill-round) regime of the multi-query body
//    (mq_decode_attention.cuh), that is kernel 4 (TPU kernel
//    src/repro/kernels/decode_attention/multiquery.py:107) and its paged
//    form, kernel 5 (multiquery.py:248).
//
// Which body takes which shape:
//  * this mainloop: bf16 with 16-byte aligned rows (dh % 8 == 0 and
//    aligned bases, the wrappers' vector_ok), dh <= 128 and G <= 128; for the
//    multi-query kernels only when the wrapper runs them unsplit
//    (n_split == 1: the prefill rounds, q_len·G rows filling >= 2 blocks
//    per SM). dh 80 runs as 128: TMA fills the columns past dh with zeros.
//  * the mma.sync bodies (flash_attention.cu, mq_decode_attention.cuh):
//    dh 129-256, unaligned rows, the split (verify, q_len <= 9) regime of
//    the multi-query body; flash's fp32 inputs take its SIMT kernel.
//
// What it computes (the multi-query rule, which flash meets with
// qbase = q_offset and id(t) = t for t < Skv): query row r = qi·G + g
// (query head g of KV group kvh, position qbase(b) + qi) sees slot t iff
// its position id satisfies id >= 0, id <= qpos (when causal) and
// qpos - id < window. Scores, the online softmax (m, l) and the output
// accumulator stay fp32; probabilities are rounded to bf16 for PV (the
// contract with the plain versions). A row that sees nothing outputs 0.
//
// Bound on the H100: operations for the prefill shapes (QK^T and PV on
// the bf16 tensor cores, 989 TFLOP/s), bytes only where few rows share a
// K/V tile.
//
// Design:
//  * Warp specialisation. A work item is BM = 128 query rows of one (b, kv
//    head): 128 / G positions with all G heads of the group, so one K/V
//    tile serves all of them. A block of 384 threads: warpgroup 0 is the
//    producer (one warp of it works, setmaxnreg gives its registers away),
//    warpgroups 1 and 2 consume, 64 rows each (setmaxnreg raises them to
//    232 registers). The grid is persistent (one block per SM, items
//    round-robin, longest first), so the producer loads the next item's Q
//    and tiles while the consumers finish the current one.
//  * K and V by TMA. Each is one 4-d tensor map (dh, KV, rows, outer) in
//    the model layout: (B, S, KV, dh) for flash's K/V and the contiguous
//    cache, (P, page_size, KV, dh) for the pool. A 64-slot tile is
//    boxes of {64 dh, 1 head, box_rows slots} landing in a ring of 4
//    stages with the 128-byte swizzle; a stage completes on its
//    "full" mbarrier with its byte count and is freed by one arrival of
//    each consumer warpgroup on its "empty" mbarrier. Paged tiles take
//    gcd(page_size, 64) rows a box (one box per page at page 64).
//  * The producer reads a tile's ids (and pages) before it issues the
//    tile's copies, skips a tile no row of the block can see (the
//    mma.sync body's rule), and hands the consumers only the tiles it
//    loaded, with their ids, then an end marker. Boxes of unallocated
//    pages or past ctx are not loaded.
//  * Q by TMA too, into a double buffer: an item's rows are the box
//    {64 dh, G heads, 128 / G positions} of (B, q_len, H, dh), so row
//    p·G + g lands as the swizzled row the wgmma descriptor expects. The
//    output leaves the same way: O is written into the item's Q buffer in
//    that layout and one TMA store writes the box (edges clipped).
//  * S = Q·K^T on wgmma m64n64k16, Q and K from shared memory (K-major,
//    as stored). P stays in registers, rounded to bf16: the S accumulator
//    layout is the A-operand fragment layout of O += P·V (m64n{dh}k16),
//    whose B operand is V in its stored slot-major layout through the
//    transpose bit: V is never transposed or copied. Tile n's S and tile
//    n-1's PV are issued together and the softmax waits for S only, so it
//    overlaps PV on the tensor cores; O is rescaled once PV has landed.
//  * Slots with id < 0 (empty, unallocated, past ctx) are never read into
//    PV: their scores are replaced by NEG_INF before the softmax, and when
//    a stage holds such a slot each consumer warpgroup zeroes those V rows
//    before its PV (0 · NaN from stale memory would be NaN).
//  * The softmax takes a mask-free path on tiles every slot of which the
//    warp's rows see (the producer passes each tile's least and largest
//    id), and MUFU.EX2 in the log2 domain.
// Tile order, tile contents and arithmetic depend only on the slots' ids
// and K/V rows, so kernels 4 and 5 stay bit-identical on a gathered cache.
//
// Inside a CUDA graph: the four tensor maps are encoded on the host at
// each launch and passed as __grid_constant__ kernel parameters, which a
// stream capture copies into the graph's kernel node by value. They stay
// valid on every replay because every address they encode is one the
// graph keeps: q and out are tensors of the graph's memory pool (the same
// addresses each replay), K/V the cache or pool that the captured step's
// scope names (or, for flash, projections in the pool), and the paged
// kernel's block tables one static buffer. The maps hold no position or
// length that changes between replays (the position and ctx are read
// from device memory), so no map needs to live in device memory. Nothing
// host-side that a capture forbids runs here: the one-time
// cudaFuncSetAttribute and the SM count happen at the first launch of each
// instantiation, which a captured step's eager warm-up makes.
#pragma once

#include <algorithm>
#include <climits>
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include "common.cuh"

namespace repro {
namespace sm90 {
namespace {

constexpr int CONSUMERS = 2;             // consumer warpgroups, 64 rows each
constexpr int BM = 64 * CONSUMERS;       // query rows of one work item
constexpr int BN = 64;                   // slots per tile
constexpr int THREADS = 128 * (1 + CONSUMERS);  // + the producer warpgroup
constexpr int BOX_BYTES = 64 * 128;      // 64 rows of 64 bf16 (128 bytes)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;       // 128·40 + 256·232 <= 65536

// Shared-memory layout, byte offsets from a 1024-aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes).
template <int DHP>
struct Smem {
  static constexpr int NB = DHP / 64;                  // 64-wide dh boxes
  // K/V ring depth: the consumers hold 2 stages (the tile being scored,
  // the one whose PV is in flight), the rest are loading
  static constexpr int STAGES = 4;
  static constexpr int TILE = NB * BOX_BYTES;          // 64 rows x DHP
  static constexpr int QBOX = CONSUMERS * BOX_BYTES;   // BM rows x 64 dh
  static constexpr int QBUF = NB * QBOX;               // one item's Q
  static constexpr int Q_OFF = 0;                      // 2 Q buffers
  static constexpr int K_OFF = Q_OFF + 2 * QBUF;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int IDS_OFF = V_OFF + STAGES * TILE;      // int[STAGES][BN]
  static constexpr int HDR_OFF = IDS_OFF + STAGES * BN * 4;  // int[STAGES][4]
  static constexpr int BAR_OFF = HDR_OFF + STAGES * 16;  // u64 full, empty, qfull, qempty
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 4) * 8 + 1024;  // + align slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A pipeline that
// never delivers traps after ~2^35 cycles (~20 s) instead of hanging the
// card: the launch then fails and the wrapper's caller sees the error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  for (unsigned n = 1; !mbar_try_wait(bar, parity); ++n) {
    if ((n & 1023u) == 0 && clock64() - t0 > (1ll << 35)) __trap();
  }
}

// One TMA box of a 4-d tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA box from shared memory to a 4-d tensor map (bulk group).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma / TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// All consumer warpgroups (named barrier 1 + CONSUMERS).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(1 + CONSUMERS), "n"(128 * CONSUMERS) : "memory");
}

// 2^x (MUFU.EX2; 2^-huge is +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers a wgmma writes asynchronously: no use of them moves across this
// point (placed after a wait and before an issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (SWIZZLE_128B) in bits 62-63. K-major (Q, K): SBO = 1024 (next 8 rows),
// LBO unused. MN-major (V): LBO = the next 64-column box, SBO = 1024 (the
// next 8 slots).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 64 fp32) = A·B (scale_d == 0) or d + A·B, with A (64 x 16) and
// B (16 x 64) read from shared memory through their descriptors, both
// K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 fp32) += A·B with A (64 x 16 bf16) in registers, in the
// accumulator-derived fragment layout, and B (16 x 64) read from shared
// memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128 fp32) += A·B with A (64 x 16 bf16) in registers, in the
// accumulator-derived fragment layout, and B (16 x 128) read from shared
// memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Max and sum over the 16 elements of accumulator row rr (0: gid, 1:
// gid + 8) that a thread holds, as trees (no serial chain).
__device__ __forceinline__ float row_max(const float (&s)[32], int rr) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
  }
  return t[0];
}
__device__ __forceinline__ float row_sum(const float (&s)[32], int rr) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = s[4 * j + 2 * rr] + s[4 * j + 2 * rr + 1];
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] += t[j + w];
  }
  return t[0];
}

// O += P·V over one 64-slot tile: four k16 steps, P from registers, V
// from the stage at v_addr.
template <int DHP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DHP / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_addr) {
  const uint64_t dv = sw128_desc(v_addr, BOX_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (DHP == 64) {
      wgmma_rs_m64n64k16(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
    } else {
      wgmma_rs_m64n128k16(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
    }
  }
}

// One work item is BM query rows (P_blk = BM / G positions, all G heads
// of a KV group: row r is position pbase + r / G, head g = r % G) of one
// (b, kv head); items are ordered longest first (the last positions of a
// causal prefill see the most slots). The grid is persistent: block i
// takes items i, i + gridDim.x, ..., so the producer loads the next item's
// Q and first tiles while the consumers finish the current one.
__device__ __forceinline__ void item_coords(int item, int n_rt, int KV, int B, int& rt, int& kvh,
                                            int& b) {
  const int per_rt = KV * B;
  rt = n_rt - 1 - item / per_rt;
  kvh = (item % per_rt) % KV;
  b = (item % per_rt) / KV;
}

// Addr gives qbase(b, Q), the position of query 0 of sequence b;
// slot(b, kvh, t, off), the position id of slot t < S (-1: empty, never
// read; off is the mma.sync body's); box(b, t0, row, outer), the
// tensor-map coordinates of the box of box_rows slots from t0 (false:
// nothing to load there).
template <int DHP, typename Addr>
__global__ void __launch_bounds__(THREADS, 1) attention_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map, Addr addr, int Q,
    int S, int KV, int G, int window, int causal, float scale_log2, int B) {
  using L = Smem<DHP>;
  constexpr int NB = L::NB;
  extern __shared__ __align__(16) unsigned char sm90_smem[];
  unsigned char* sm = sm90_smem + ((1024 - (smem_u32(sm90_smem) & 1023)) & 1023);
  int* ids_s = reinterpret_cast<int*>(sm + L::IDS_OFF);
  // per stage: j0 (-1: the item's end), has_empty, least and largest id >= 0
  volatile int* hdr = reinterpret_cast<int*>(sm + L::HDR_OFF);
  const uint32_t full0 = smem_u32(sm + L::BAR_OFF);
  const uint32_t empty0 = full0 + L::STAGES * 8;
  const uint32_t qfull0 = empty0 + L::STAGES * 8;  // [2]: Q double buffer
  const uint32_t qempty0 = qfull0 + 2 * 8;

  const int P_blk = BM / G;                      // positions per item
  const int rows = P_blk * G;                    // live rows of an item
  const int n_rt = (Q + P_blk - 1) / P_blk;
  const int n_items = n_rt * KV * B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's arrive.expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull0 + 8 * s, 1);
      mbar_init(qempty0 + 8 * s, 1);  // after the item's O store has read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid >= 32) return;
    const int lane = tid;
    const int br = addr.box_rows, n_box = BN / br;
    const uint32_t box_tx = (uint32_t)br * 128;
    int stage = 0, phase = 0, qs = 0, qphase = 0;
    auto next_stage = [&]() {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
    };
    auto advance = [&]() {
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      int rt, kvh, b;
      item_coords(item, n_rt, KV, B, rt, kvh, b);
      const int pbase = rt * P_blk;
      const int qbase = addr.qbase(b, Q);
      const int qlo = qbase + pbase;                        // the item's rows
      const int qhi = qbase + min(pbase + P_blk, Q) - 1;    // span [qlo, qhi]

      // Q: rows (pbase + p, g) land as row p·G + g, 128 bytes of dh each
      mbar_wait(qempty0 + 8 * qs, qphase ^ 1);
      if (lane == 0) {
        const uint32_t qfull = qfull0 + 8 * qs;
        mbar_expect_tx(qfull, (uint32_t)(NB * 128 * rows));
        const uint32_t qd = smem_u32(sm + L::Q_OFF + qs * L::QBUF);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(qd + c * L::QBOX, &q_map, qfull, c * 64, kvh * G, pbase, b);
        }
      }
      if ((qs ^= 1) == 0) qphase ^= 1;

      auto sees = [&](int id) {  // visible to some row of the item
        return id >= 0 && (!causal || id <= qhi) && (long long)qlo - id < window;
      };
      for (int j0 = 0; j0 < S; j0 += BN) {
        const int t0 = j0 + lane, t1 = j0 + 32 + lane;
        long long off;
        const int id0 = t0 < S ? addr.slot(b, kvh, t0, off) : -1;
        const int id1 = t1 < S ? addr.slot(b, kvh, t1, off) : -1;
        if (!__any_sync(0xffffffffu, sees(id0) || sees(id1))) continue;
        const bool any_empty = __any_sync(0xffffffffu, id0 < 0 || id1 < 0);
        const int id_min = __reduce_min_sync(
            0xffffffffu, min(id0 < 0 ? INT_MAX : id0, id1 < 0 ? INT_MAX : id1));
        const int id_max = __reduce_max_sync(0xffffffffu, max(id0, id1));
        int row = 0, outer = 0;
        const int tb = j0 + lane * br;
        const bool load = lane < n_box && tb < S && addr.box(b, tb, row, outer);
        const unsigned boxes = __ballot_sync(0xffffffffu, load);
        next_stage();
        int* ids = ids_s + stage * BN;
        ids[lane] = id0;
        ids[lane + 32] = id1;
        if (lane == 0) {
          hdr[4 * stage] = j0;
          hdr[4 * stage + 1] = any_empty;
          hdr[4 * stage + 2] = id_min;
          hdr[4 * stage + 3] = id_max;
        }
        __syncwarp();
        const uint32_t full = full0 + 8 * stage;
        if (lane == 0) mbar_expect_tx(full, 2u * NB * box_tx * (uint32_t)__popc(boxes));
        const uint32_t ks = smem_u32(sm + L::K_OFF + stage * L::TILE);
        const uint32_t vs = smem_u32(sm + L::V_OFF + stage * L::TILE);
        for (int x = 0; x < n_box; ++x) {
          const int r = __shfl_sync(0xffffffffu, row, x);
          const int o = __shfl_sync(0xffffffffu, outer, x);
          if (lane == 0 && ((boxes >> x) & 1u)) {
#pragma unroll
            for (int c = 0; c < NB; ++c) {
              const uint32_t at = c * BOX_BYTES + x * box_tx;
              tma_load_4d(ks + at, &k_map, full, c * 64, kvh, r, o);
              tma_load_4d(vs + at, &v_map, full, c * 64, kvh, r, o);
            }
          }
        }
        advance();
      }
      next_stage();  // the item's end
      if (lane == 0) {
        hdr[4 * stage] = -1;
        mbar_arrive(full0 + 8 * stage);
      }
      advance();
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // rows this thread holds in the accumulator layout: wr and wr + 8 of the
  // item's BM
  const int wr = 64 * cw + 16 * warp + gid;
  int stage = 0, phase = 0, qs = 0, qphase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int rt, kvh, b;
    item_coords(item, n_rt, KV, B, rt, kvh, b);
    const int pbase = rt * P_blk;
    const int qbase = addr.qbase(b, Q);
    const int qp[2] = {qbase + pbase + wr / G, qbase + pbase + (wr + 8) / G};
    float o[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
    float mrow[2] = {NEG_INF, NEG_INF};  // running max, log2 domain
    float lrow[2] = {0.f, 0.f};          // this lane's partial row sums
    const uint64_t dq =
        sw128_desc(smem_u32(sm + L::Q_OFF + qs * L::QBUF + cw * 64 * 128), 16, 1024);
    mbar_wait(qfull0 + 8 * qs, qphase);

    // Tile n's softmax overlaps tile n-1's O += P·V on the tensor cores:
    // S_n and PV_{n-1} are issued together, the softmax waits for S_n only,
    // and O is rescaled once PV_{n-1} has landed.
    // Before the first tile P_{n-1} is 0 against the first tile's V (finite:
    // loaded, empty rows zeroed), so every iteration issues the same wgmma
    // sequence (a branch around a wgmma serialises them all).
    uint32_t pa[BN / 16][4];   // P_{n-1}, bf16, the A operand of PV
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    int prev = -1;             // the stage of tile n-1 (-1: none)
    for (;;) {
      mbar_wait(full0 + 8 * stage, phase);
      // j0 (-1: the item's end), has_empty, least and largest id >= 0
      const int4 h = *reinterpret_cast<const int4*>(sm + L::HDR_OFF + 16 * stage);
      if (h.x < 0) break;  // the item's end
      const int* ids = ids_s + stage * BN;
      unsigned char* Ks = sm + L::K_OFF + stage * L::TILE;
      unsigned char* Vs = sm + L::V_OFF + stage * L::TILE;
      const bool has_empty = h.y != 0;
      // every slot of the tile visible to this warp's rows: no mask
      const bool unmasked = __all_sync(
          0xffffffffu, !has_empty && (!causal || h.w <= qp[0]) && qp[1] - h.z < window);
      if (has_empty) {
        // zero the V rows of empty slots (a row's 128 bytes hold its
        // swizzled chunks, so the swizzle does not matter here)
        for (int c = tid; c < BN * NB * 8; c += 128) {
          const int r = c / (NB * 8), rest = c % (NB * 8);
          if (ids[r] < 0) {
            *reinterpret_cast<uint4*>(Vs + (rest / 8) * BOX_BYTES + r * 128 + (rest % 8) * 16) =
                make_uint4(0, 0, 0, 0);
          }
        }
        fence_proxy_async();
        warpgroup_sync(1 + cw);
      }

      // S = Q K^T (64 rows x 64 slots, dh / 16 steps of k16), then
      // PV_{n-1} behind it
      float s[32];
      const uint64_t dk = sw128_desc(smem_u32(Ks), 16, 1024);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        const uint32_t k_off = ((kk / 4) * BOX_BYTES + (kk % 4) * 32) >> 4;
        const uint32_t q_off = ((kk / 4) * L::QBOX + (kk % 4) * 32) >> 4;
        wgmma_ss_m64n64k16(s, dq + q_off, dk + k_off, kk > 0);
      }
      wgmma_commit();
      wgmma_pv<DHP>(o, pa, smem_u32(sm + L::V_OFF + (prev < 0 ? stage : prev) * L::TILE));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // scale + per-row mask, then the online-softmax update in the log2
      // domain (x = s·scale·log2 e); masked scores are NEG_INF, probability 0
      float mx[2] = {NEG_INF, NEG_INF};
      if (unmasked) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) mx[rr] = row_max(s, rr) * scale_log2;
      } else {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          const int2 id2 = *reinterpret_cast<const int2*>(ids + nt * 8 + tig * 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int id = (e & 1) ? id2.y : id2.x;
            const int p = qp[e >> 1];
            const bool valid = id >= 0 && (!causal || id <= p) && p - id < window;
            float& x = s[4 * nt + e];
            x = valid ? x * scale_log2 : NEG_INF;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        mx[rr] = fmaxf(mx[rr], mrow[rr]);
        corr[rr] = ex2(mrow[rr] - mx[rr]);
        mrow[rr] = mx[rr];
        lrow[rr] *= corr[rr];
      }
      if (unmasked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, -mrow[(i >> 1) & 1]));
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = s[i] <= NEG_INF ? 0.f : ex2(s[i] - mrow[(i >> 1) & 1]);
        }
      }
      lrow[0] += row_sum(s, 0);
      lrow[1] += row_sum(s, 1);
      wgmma_wait<0>();  // PV_{n-1} has landed: its stage is free
      fence_regs(o);
      fence_regs(pa);
      if (tid == 0 && prev >= 0) mbar_arrive(empty0 + 8 * prev);
      if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
        for (int i = 0; i < DHP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      // P_n, bf16, for the next iteration's PV against this tile's V rows
      // (read slot-major through the transpose bit)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
      prev = stage;
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the item's end: the last tile's PV (with P = 0 against the last
    // loaded V, or o reset, when the item loaded no tile), then free the
    // marker's stage
    fence_regs(o);
    wgmma_fence();
    wgmma_pv<DHP>(o, pa, smem_u32(sm + L::V_OFF + (prev < 0 ? 0 : prev) * L::TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (prev < 0) {
#pragma unroll
      for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
    }
    if (tid == 0) {
      if (prev >= 0) mbar_arrive(empty0 + 8 * prev);
      mbar_arrive(empty0 + 8 * stage);
    }
    if (++stage == L::STAGES) {
      stage = 0;
      phase ^= 1;
    }
    // O, normalized and rounded to bf16, into this warpgroup's rows of the
    // item's Q buffer (its S are done) in the same swizzled layout, then
    // one TMA store of the item's box: rows past the item and positions
    // past q_len are not written.
    unsigned char* Ob = sm + L::Q_OFF + qs * L::QBUF;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = lrow[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const int r = wr + 8 * rr;
#pragma unroll
      for (int t = 0; t < DHP / 8; ++t) {
        *reinterpret_cast<__nv_bfloat162*>(Ob + (t / 8) * L::QBOX + r * 128 +
                                           (((t % 8) ^ (r & 7)) * 16) + tig * 4) =
            __floats2bfloat162_rn(o[4 * t + 2 * rr] * inv, o[4 * t + 2 * rr + 1] * inv);
      }
    }
    fence_proxy_async();
    consumers_sync();
    if (threadIdx.x == 128) {
      const uint32_t ob = smem_u32(Ob);
#pragma unroll
      for (int c = 0; c < NB; ++c) tma_store_4d(&o_map, ob + c * L::QBOX, c * 64, kvh * G, pbase, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(qempty0 + 8 * qs);  // the buffer is read: Q of a later item may land
    }
    if ((qs ^= 1) == 0) qphase ^= 1;
  }
  if (threadIdx.x == 128) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- host side
// cuTensorMapEncodeTiled lives in libcuda, which the library does not link:
// it is looked up through the CUDA runtime's entry-point query.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The tiled map of a 4-d bf16 tensor in the model layout, innermost
// dimension dh first, in boxes of `box` (box[0] = 64: one 128-byte swizzled
// row); reads past an edge (dh < 64·k, rows past the end) fill zeros.
inline int encode_map(CUtensorMap* map, const void* base, const long long (&dims)[4],
                      const int (&box)[4]) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], elem[4];
  cuuint64_t stride = 2;
  for (int i = 0; i < 4; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    bdim[i] = (cuuint32_t)box[i];
    elem[i] = 1;
    if (i) gstride[i - 1] = stride;
    stride *= gdim[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim,
                        gstride, bdim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 0;
      return 132;
    }
  }
  return n;
}

// q, out: (B, Q, KV·G, dh); k, v: (outer, rows, KV, dh) bf16 in the model
// layout. The maps are encoded on the host at each launch and travel as
// kernel parameters (a captured launch keeps them by value, see the
// header); the grid is one block per SM (or per item, if fewer).
template <int DHP, typename Addr>
int launch(const void* q, const void* k, const void* v, const Addr& addr, void* out, int B,
           int Q, int S, long long rows, long long outer, int KV, int G, int dh, int window,
           int causal, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, o_map;
  const int P_blk = BM / G;
  int rc = encode_map(&q_map, q, {dh, (long long)KV * G, Q, B}, {64, G, P_blk, 1});
  if (!rc) rc = encode_map(&o_map, out, {dh, (long long)KV * G, Q, B}, {64, G, P_blk, 1});
  if (!rc) rc = encode_map(&k_map, k, {dh, KV, rows, outer}, {64, 1, addr.box_rows, 1});
  if (!rc) rc = encode_map(&v_map, v, {dh, KV, rows, outer}, {64, 1, addr.box_rows, 1});
  if (rc) return rc;
  constexpr int smem = Smem<DHP>::BYTES;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<DHP, Addr>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long items = (long long)((Q + P_blk - 1) / P_blk) * KV * B;
  const int grid = (int)std::min<long long>(items, sm_count());
  attention_kernel<DHP, Addr><<<grid, THREADS, smem, stream>>>(
      q_map, k_map, v_map, o_map, addr, Q, S, KV, G, window, causal,
      scale * 1.4426950408889634f, B);
  return 0;
}

// The shapes this mainloop takes (see the header note).
inline bool takes(int dh, int vec, int G) {
  return vec != 0 && dh % 8 == 0 && dh <= 128 && G <= BM;
}

template <typename Addr>
int dispatch(const void* q, const void* k, const void* v, const Addr& addr, void* out, int B,
             int Q, int S, long long rows, long long outer, int KV, int G, int dh, int window,
             int causal, float scale, cudaStream_t stream) {
  if (dh <= 64) {
    return launch<64>(q, k, v, addr, out, B, Q, S, rows, outer, KV, G, dh, window, causal,
                      scale, stream);
  }
  return launch<128>(q, k, v, addr, out, B, Q, S, rows, outer, KV, G, dh, window, causal, scale,
                     stream);
}

}  // namespace
}  // namespace sm90
}  // namespace repro
