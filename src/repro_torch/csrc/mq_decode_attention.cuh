// Multi-query (q_len >= 1) GQA decode attention, hand-written for Hopper
// (sm_90a): the bodies shared by the contiguous-cache kernel
// (mq_decode_attention.cu, TPU kernel
// src/repro/kernels/decode_attention/multiquery.py:107) and the paged one
// (mq_paged_decode_attention.cu, TPU kernel multiquery.py:248).
//
// Speculative verification scores q_len = k + 1 positions per sequence in
// one pass, and chunked prefill goes through the same step in rounds of up
// to 512 positions. Their K/V are written into the cache first; query row
// r = qi·G + g (query head g of the KV group) sits at position
// qbase(b) + qi and sees slot t iff the slot's position id lies in
// [0, qbase + qi] and (qbase + qi) - id < window. Scores, (m, l) and the
// output accumulator are fp32; probabilities are rounded to bf16 for PV
// on the tensor cores. A row that sees no slot outputs 0.
//
// Bound on the H100, two regimes:
//  * verify (q_len·G <= 128 rows per (b, kv head)): bytes. Every visible
//    K/V row is read once for all rows; at B 4, 1024 slots, KV 8, dh 128
//    that is 16.8 MB, ~5 us at 3.35 TB/s.
//  * chunked prefill (q_len 128-512, up to 4096 rows): operations,
//    2·2·B·H·(visible (row, slot) pairs)·dh on the tensor cores.
//
// Which body a call takes (mq_body; the wrappers' rule in multiquery.py
// mirrors it, and shapes alone decide, so kernels 4 and 5 pick alike):
//  * verify_sm90_kernel (below): bf16 rows the Hopper mainloop takes
//    (16-byte aligned, dh <= 128) and at most VERIFY_ROWS = 128 rows: the
//    verify passes, and q_len 1.
//  * the Hopper mainloop of attention_sm90.cuh (wgmma, TMA, a
//    warp-specialised pipeline), unsplit: the same rows with more than 128
//    of them (every prefill round, and a B 1 round of 128 positions).
//  * mq_tile_kernel (below): dh > 128 and unaligned rows.
//
// verify_sm90_kernel, against the byte bound:
//  * One launch. The S slots of a (b, kv head) are split over n_split <= 8
//    blocks of at least two 64-slot tiles each (verify_split_count in
//    multiquery.py: 4 splits of 256 slots at B 4, 8 of 128 at B 1), and
//    those blocks are one thread block cluster: they merge their partial
//    (acc, m, l) through distributed shared memory in rank order
//    (ClusterMerge, cluster_merge.cuh, shared with kernels 1 and 3). No
//    partials go through global memory. The partials land in the ring,
//    which is free once every block of the cluster is past its loop (one
//    cluster barrier there): 105 KB of shared memory a block at dh 128,
//    so two blocks share an SM and a cluster finds room in one wave (at
//    141 KB, one block an SM, clusters of 4 did not: the verify shape took
//    twice as long).
//  * Rows sized to q_len·G: a warp holds 16 query rows as one mma.sync m16
//    row fragment, and a block has 3, 5 or 8 warps (48, 80 or 128 rows):
//    the verify shape's 40 rows take three fragments (8 rows of padding)
//    instead of a 64-row tile. Q is read once per block, straight into
//    the A fragments.
//  * An asynchronous K/V ring. A block walks its split in 64-slot tiles
//    through a ring of 3 stages of K and V rows (cp.async 16-byte copies,
//    LDGSTS); every thread issues its share of each tile. The slot ids (or
//    block-table entries) of tile n + 3 are read while tile n is consumed;
//    a tile's visibility is voted when it is issued, and a tile no row can
//    see is skipped before its copies. Slots no row sees are zero-filled,
//    never read (they may hold NaN).
//  * QK^T and PV on mma.sync m16n8k16 (bf16 in, fp32 accumulate): K by
//    ldmatrix, V from its row-major tile by ldmatrix.trans (no transposed
//    copy), P from the QK^T accumulators rounded to bf16. K and V rows are
//    padded by 16 bytes so both ldmatrix forms are free of bank conflicts.
//    Scores live in the log2 domain (2^x on MUFU.EX2), row max and sum are
//    trees over a lane's values, and a row whose max did not move skips
//    its rescale.
//
// mq_tile_kernel (dh 129-256, unaligned rows): a block of 4 warps owns 64
// rows of one (b, kv head) and stages 64-slot tiles through shared memory
// with 16-byte loads (V stored transposed); its splits (at most 8) merge
// through the same cluster step.
//
// The two Addr policies share the bodies, the split counts, the tile order
// and the merge; they differ only in how a slot's row is found. So on a
// cache gathered from the pool (uniform ctx, pos = ctx - q_len) the paged
// kernel is bit-identical to the contiguous one.
//
// Addr interface: qbase(b, Q), the position of query 0 of sequence b;
// fetch(b, t), slot t's raw entry (a pos_id or a block-table page, -1:
// none; the only global load of the slot walk); locate(b, kvh, t, raw,
// off), slot t's position id (-1: empty, never read), setting off to the
// element offset of its K/V row; slot(b, kvh, t, off) = locate(fetch);
// and, for the Hopper mainloop, box(), map_rows, map_outer and box_rows
// (see attention_sm90.cuh).
#pragma once

#include "attention_sm90.cuh"
#include "cluster_merge.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// The verify body
// ---------------------------------------------------------------------------
constexpr int VERIFY_ROWS = 128;   // rows (q_len·G) the verify body takes
constexpr int VF_TILE = 64;        // slots per tile
constexpr int VF_STAGES = 3;       // ring depth

enum MqBody { MQ_VERIFY = 0, MQ_MAINLOOP = 1, MQ_MMA = 2 };

// Which body a call takes (multiquery.py's mq_body).
inline int mq_body(int dh, int vec, int Q, int G) {
  if (!sm90::takes(dh, vec, G)) return MQ_MMA;
  return Q * G <= VERIFY_ROWS ? MQ_VERIFY : MQ_MAINLOOP;
}

// Row warps of the verify body for R rows: 16 rows each.
inline int verify_row_warps(int R) { return R <= 48 ? 3 : R <= 80 ? 5 : 8; }

template <int DHP, int NW>
struct VerifyGeom {
  static constexpr int THREADS = 32 * NW;
  static constexpr int GM = 16 * NW;                // rows of the block (R <= GM)
  static constexpr int RS = DHP + 8;                // K / V row stride (elements)
  static constexpr int TILE_BYTES = VF_TILE * RS * 2;
  static constexpr int STAGE = 2 * TILE_BYTES;      // K tile, then V tile
  // the ids and row offsets of a tile, kept for STAGES + 1 tiles: the next
  // tile's are written while the warps still read the current one's
  static constexpr int IDS_OFF = VF_STAGES * STAGE;                        // int
  static constexpr int OFF_OFF = IDS_OFF + (VF_STAGES + 1) * VF_TILE * 4;  // long long
  static constexpr int BYTES = OFF_OFF + (VF_STAGES + 1) * VF_TILE * 8;
  // after the loop the ring holds the merge's receive region (its peers'
  // partials, once every block of the cluster is past its loop)
  static_assert(merge_floats<GM, DHP>() * 4 <= IDS_OFF, "the merge region fits the ring");
};

// Grid (n_split, KV, B), clusters of n_split blocks along x. Block `split`
// walks slots [split·chunk, min(S, (split + 1)·chunk)). Scores are kept in
// the log2 domain (scale2 = scale·log2 e; 2^x by MUFU.EX2); the merge gets
// m·ln 2.
template <int NW>
constexpr int verify_min_blocks() {
  return NW <= 5 ? 2 : 1;  // two blocks an SM up to 5 warps (<= 204 registers)
}

template <int DHP, int NW, typename Addr>
__global__ void __launch_bounds__(VerifyGeom<DHP, NW>::THREADS, verify_min_blocks<NW>())
    verify_sm90_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, Addr addr,
                       __nv_bfloat16* __restrict__ out, int Q, int S, int KV, int G, int dh,
                       int window, float scale2, int chunk) {
  using L = VerifyGeom<DHP, NW>;
  constexpr int KK = DHP / 16;               // mma K steps of QK^T
  constexpr int NC = DHP / 8;                // 16-byte chunks of a row
  constexpr int NT = VF_TILE / 8;            // slot octets of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  int* ids_s = reinterpret_cast<int*>(smem + L::IDS_OFF);
  long long* off_s = reinterpret_cast<long long*>(smem + L::OFF_OFF);
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int R = Q * G, H = KV * G;
  const int pos = addr.qbase(b, Q);
  const int qhi = pos + Q - 1;  // the block's rows sit at positions [pos, qhi]

  // this warp's rows wr, wr + 8 (positions qp[0], qp[1]) as the A operand:
  // a[0] row wr, a[1] row wr + 8, columns 16·kk + 2·tig (+ 8 for a[2],
  // a[3]); zero past R and dh
  const bool has_rows = warp * 16 < R;
  const int wr = warp * 16 + gid;
  const bool ok[2] = {wr < R, wr + 8 < R};
  const int qp[2] = {pos + wr / G, pos + (wr + 8) / G};
  uint32_t qa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wr + 8 * (j & 1), col = 16 * kk + 2 * tig + 8 * (j >> 1);
      qa[kk][j] = r < R && col < dh
                      ? ld_u32(q + (((size_t)b * Q + r / G) * H + (size_t)kvh * G + r % G) * dh +
                               col)
                      : 0u;
    }
  }

  const int s0 = split * chunk;
  const int s1 = min(S, s0 + chunk);
  const int n_t = s1 > s0 ? (s1 - s0 + VF_TILE - 1) / VF_TILE : 0;

  // tile t's raw entries: thread tid < VF_TILE reads slot tid's
  auto fetch = [&](int t) {
    const int s = s0 + t * VF_TILE + tid;
    return tid < VF_TILE && t < n_t && s < s1 ? addr.fetch(b, s) : -1;
  };
  // tile t into ring stage t % STAGES: its ids and row offsets, the vote
  // (whose barrier also says every warp is done with the stage), then the
  // copies, zero-filled for slots no row sees. One commit group per tile.
  unsigned live = 0;  // bit st: the tile in stage st has a slot some row sees
  auto issue = [&](int t, int raw) {
    const int st = t % VF_STAGES, is = t % (VF_STAGES + 1);
    int seen = 0;
    if (tid < VF_TILE) {
      long long off = 0;
      const int id = raw < 0 ? -1 : addr.locate(b, kvh, s0 + t * VF_TILE + tid, raw, off);
      // some row sees it: a position in [id, id + window) lies in [pos, qhi]
      seen = id >= 0 && id <= qhi && (long long)pos - id < window;
      ids_s[is * VF_TILE + tid] = id;
      off_s[is * VF_TILE + tid] = seen ? off : -1;
    }
    const bool any = __syncthreads_or(seen) != 0;
    live = any ? live | (1u << st) : live & ~(1u << st);
    if (any) {
      const uint32_t ks = ring + st * L::STAGE, vs = ks + L::TILE_BYTES;
#pragma unroll
      for (int c = tid; c < VF_TILE * NC; c += L::THREADS) {
        const int r = c / NC, d0 = (c % NC) * 8;
        const long long off = off_s[is * VF_TILE + r];
        const bool in = off >= 0 && d0 < dh;
        const size_t at = in ? (size_t)off + d0 : 0;
        cp_async16(ks + (r * L::RS + d0) * 2, k + at, in ? 16 : 0);
        cp_async16(vs + (r * L::RS + d0) * 2, v + at, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float o[DHP / 8][4];
#pragma unroll
  for (int t = 0; t < DHP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF};  // log2 domain
  float lrow[2] = {0.f, 0.f};          // this lane's partial row sums

  int raw[VF_STAGES];
#pragma unroll
  for (int t = 0; t < VF_STAGES; ++t) raw[t] = fetch(t);
#pragma unroll
  for (int t = 0; t < VF_STAGES; ++t) issue(t, raw[t]);
  int raw_next = fetch(VF_STAGES);

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<VF_STAGES - 1>();
    __syncthreads();  // tile t has landed for every thread
    const int st = t % VF_STAGES;
    if (has_rows && ((live >> st) & 1u)) {
      const uint32_t ks = ring + st * L::STAGE, vs = ks + L::TILE_BYTES;
      const int* ids = ids_s + (t % (VF_STAGES + 1)) * VF_TILE;

      // S (16 rows x 64 slots) = Q K^T: s[nt] rows wr, wr + 8 (c[0..1],
      // c[2..3]), slots 8·nt + 2·tig, + 1
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; kk += 2) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + ((nt * 8 + (lane & 7)) * L::RS + 16 * kk + 8 * (lane >> 3)) * 2);
          mma_bf16_16816(s[nt], qa[kk], kb[0], kb[1]);
          mma_bf16_16816(s[nt], qa[kk + 1], kb[2], kb[3]);
        }
      }

      // scale + per-row mask; the online-softmax update with tree
      // reductions over the lane's NT·2 values of each row
      float tm[2][NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int2 id = *reinterpret_cast<const int2*>(ids + nt * 8 + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e & 1) ? id.y : id.x, p = qp[e >> 1];
          const bool valid = ok[e >> 1] && i >= 0 && i <= p && p - i < window;
          s[nt][e] = valid ? s[nt][e] * scale2 : NEG_INF;
        }
        tm[0][nt] = fmaxf(s[nt][0], s[nt][1]);
        tm[1][nt] = fmaxf(s[nt][2], s[nt][3]);
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int w = NT / 2; w > 0; w >>= 1) {
#pragma unroll
          for (int j = 0; j < w; ++j) tm[rr][j] = fmaxf(tm[rr][j], tm[rr][j + w]);
        }
        float mx = fmaxf(mrow[rr], tm[rr][0]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[rr] = sm90::ex2(mrow[rr] - mx);
        mrow[rr] = mx;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = s[nt][e] <= NEG_INF ? 0.f : sm90::ex2(s[nt][e] - mrow[e >> 1]);
        }
        tm[0][nt] = s[nt][0] + s[nt][1];
        tm[1][nt] = s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int w = NT / 2; w > 0; w >>= 1) {
#pragma unroll
          for (int j = 0; j < w; ++j) tm[rr][j] += tm[rr][j + w];
        }
        lrow[rr] = lrow[rr] * corr[rr] + tm[rr][0];
      }
      // a row whose max moved rescales its output (x 1 changes nothing)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int t2 = 0; t2 < DHP / 8; ++t2) {
          o[t2][0] *= corr[0];
          o[t2][1] *= corr[0];
          o[t2][2] *= corr[1];
          o[t2][3] *= corr[1];
        }
      }

      // O += P V: the score accumulators of two adjacent slot octets form
      // one 16-wide A fragment; V's B fragments by ldmatrix.trans from the
      // slot-major tile (matrices: slots +0 / +8, columns +0 / +8)
#pragma unroll
      for (int kk = 0; kk < VF_TILE / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int vrow = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int c2 = 0; c2 < DHP / 16; ++c2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (vrow * L::RS + 16 * c2 + 8 * (lane >> 4)) * 2);
          mma_bf16_16816(o[2 * c2], a, vb[0], vb[1]);
          mma_bf16_16816(o[2 * c2 + 1], a, vb[2], vb[3]);
        }
      }
    }
    issue(t + VF_STAGES, raw_next);
    raw_next = fetch(t + VF_STAGES + 1);
  }
  cp_async_wait<0>();

  // this block is done with its ring, which receives the peers' partials:
  // every block arrives here and waits before its first push
  cluster_arrive();

  // this split's partial, pushed to the blocks that own its elements
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 1);
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 2);
  }
  const ClusterMerge<L::GM, DHP> merge(reinterpret_cast<float*>(smem), R, dh);
  cluster_wait();  // every block of the cluster is past its loop
  if (has_rows) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = wr + 8 * rr;
      if (r < R) {
        // column pairs 8·t2 + 2·tig, + 1 of row r (dh % 8 == 0 here)
        float* dst = merge.row_at(r);
#pragma unroll
        for (int t2 = 0; t2 < DHP / 8; ++t2) {
          const int col = 8 * t2 + 2 * tig;
          if (col < dh) {
            *reinterpret_cast<float2*>(dst + col) = make_float2(o[t2][2 * rr], o[t2][2 * rr + 1]);
          }
        }
        // m in the natural log domain
        if (tig == 0) merge.push_ml(r, mrow[rr] * 0.6931471805599453f, lrow[rr]);
      }
    }
  }
  merge.finish([&](int r) {
    return out + (((size_t)b * Q + r / G) * H + (size_t)kvh * G + r % G) * dh;
  });
}

template <int DHP, int NW, typename Addr>
int launch_verify_sm90(const void* q, const void* k, const void* v, const Addr& addr, void* out,
                       int B, int Q, int S, int KV, int G, int dh, int window, float scale,
                       int n_split, cudaStream_t stream) {
  static ClusterLaunch st;
  // whole tiles: none of the n_split chunks is empty (verify_split_count)
  const int chunk = VF_TILE * (((S + n_split - 1) / n_split + VF_TILE - 1) / VF_TILE);
  return launch_clustered(st, verify_sm90_kernel<DHP, NW, Addr>, VerifyGeom<DHP, NW>::THREADS,
                          VerifyGeom<DHP, NW>::BYTES, dim3(n_split, KV, B), n_split, stream,
                          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                          (const __nv_bfloat16*)v, addr, (__nv_bfloat16*)out, Q, S, KV, G, dh,
                          window, scale * 1.4426950408889634f, chunk);
}

// ---------------------------------------------------------------------------
// The mma.sync body of the other shapes (dh 129-256, unaligned rows)
// ---------------------------------------------------------------------------
constexpr int MQ_BM = 64;  // query rows per block: 4 warps x 16
constexpr int MQ_BN = 64;  // cache slots per tile
constexpr int MQ_THREADS = 128;

template <int DHP>
constexpr int mq_smem_bytes() {
  return ((MQ_BM + MQ_BN) * (DHP + 8) + DHP * (MQ_BN + 8)) * (int)sizeof(__nv_bfloat16) +
         MQ_BN * ((int)sizeof(long long) + (int)sizeof(int)) + merge_floats<MQ_BM, DHP>() * 4;
}

// Grid (n_split, n_rt · KV, B), clusters of n_split blocks along x: row
// tile rt = y / KV of kv head y % KV, slot split x.
template <int DHP, typename Addr>
__global__ void __launch_bounds__(MQ_THREADS) mq_tile_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Addr addr, __nv_bfloat16* __restrict__ out, int Q, int S,
    int KV, int G, int dh, int window, float scale, int vec) {
  constexpr int QS = DHP + 8;     // Q / K shared row stride (elements)
  constexpr int VS = MQ_BN + 8;   // V^T shared row stride
  constexpr int DC = DHP / 8;     // 8-element chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MQ_BM * QS;
  __nv_bfloat16* Vt = Ks + MQ_BN * QS;
  long long* off_s = reinterpret_cast<long long*>(Vt + DHP * VS);  // [MQ_BN]
  int* ids_s = reinterpret_cast<int*>(off_s + MQ_BN);               // [MQ_BN]
  float* recv = reinterpret_cast<float*>(ids_s + MQ_BN);            // the merge's region

  const int split = blockIdx.x, n_split = gridDim.x;
  const int rt = blockIdx.y / KV, kvh = blockIdx.y % KV, b = blockIdx.z;
  const int R = Q * G, H = KV * G;
  const int m0 = rt * MQ_BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool vec_ok = vec != 0;
  cluster_arrive_relaxed();  // this block runs (see cluster_wait below)
  const int pos = addr.qbase(b, Q);

  // Q tile: row r of R is query head g = r % G of position qi = r / G
  for (int c = threadIdx.x; c < MQ_BM * DC; c += MQ_THREADS) {
    const int r = c / DC, d0 = (c % DC) * 8;
    const int row = m0 + r;
    __nv_bfloat16 t[8];
    const __nv_bfloat16* src =
        q + (((size_t)b * Q + row / G) * H + (size_t)kvh * G + row % G) * dh;
    load8(t, src, 0, 0, row < R ? 1 : 0, d0, dh, vec_ok);
    *reinterpret_cast<uint4*>(Qs + r * QS + d0) = *reinterpret_cast<uint4*>(t);
  }

  // rows this thread holds in the accumulator layout: wr and wr + 8, at
  // positions qp[0], qp[1]; the block's rows span positions [qlo, qhi]
  const int wr = warp * 16 + gid;
  const int qp[2] = {pos + (m0 + wr) / G, pos + (m0 + wr + 8) / G};
  const int qlo = pos + m0 / G;
  const int qhi = pos + (min(m0 + MQ_BM, R) - 1) / G;
  float o[DHP / 8][4];
#pragma unroll
  for (int t = 0; t < DHP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF};
  float lrow[2] = {0.f, 0.f};  // this lane's partial row sums

  const int chunk = (S + n_split - 1) / n_split;
  const int s0 = split * chunk;
  const int s1 = min(S, s0 + chunk);
  for (int j0 = s0; j0 < s1; j0 += MQ_BN) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    int seen = 0;
    if (threadIdx.x < MQ_BN) {
      const int j = j0 + threadIdx.x;
      long long off = -1;
      const int id = j < s1 ? addr.slot(b, kvh, j, off) : -1;
      ids_s[threadIdx.x] = id;
      off_s[threadIdx.x] = id >= 0 ? off : -1;
      // visible to some row of the block: a position in [id, id+window)
      // lies within [qlo, qhi]
      seen = id >= 0 && id <= qhi && (long long)qlo - id < window;
    }
    if (!__syncthreads_or(seen)) continue;
    for (int c = threadIdx.x; c < MQ_BN * DC; c += MQ_THREADS) {
      const int r = c / DC, d0 = (c % DC) * 8;
      const long long off = off_s[r];            // empty slots read as 0
      const size_t at = off < 0 ? 0 : (size_t)off;
      const int n_rows = off < 0 ? 0 : 1;
      __nv_bfloat16 t[8];
      load8(t, k + at, 0, 0, n_rows, d0, dh, vec_ok);
      *reinterpret_cast<uint4*>(Ks + r * QS + d0) = *reinterpret_cast<uint4*>(t);
      load8(t, v + at, 0, 0, n_rows, d0, dh, vec_ok);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(d0 + e) * VS + r] = t[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 slots
    float s[MQ_BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < MQ_BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + wr * QS + kk * 16 + tig * 2;
      uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * QS), ld_u32(qa + 8), ld_u32(qa + 8 * QS + 8)};
#pragma unroll
      for (int nt = 0; nt < MQ_BN / 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + gid) * QS + kk * 16 + tig * 2;
        mma_bf16_16816(s[nt], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // scale + per-row mask, then the online-softmax update
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nt = 0; nt < MQ_BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int id = ids_s[nt * 8 + tig * 2 + (e & 1)];
        const int p = qp[e >> 1];
        const bool valid = id >= 0 && id <= p && p - id < window;
        s[nt][e] = valid ? s[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      corr[rr] = expf(mrow[rr] - mx[rr]);
      mrow[rr] = mx[rr];
      lrow[rr] *= corr[rr];
    }
#pragma unroll
    for (int nt = 0; nt < MQ_BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] <= NEG_INF ? 0.f : expf(s[nt][e] - mrow[e >> 1]);
        s[nt][e] = p;
        lrow[e >> 1] += p;
      }
    }
#pragma unroll
    for (int t = 0; t < DHP / 8; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // O += P V: the score accumulators of two adjacent slot octets form
    // one 16-wide A fragment
#pragma unroll
    for (int kk = 0; kk < MQ_BN / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int t = 0; t < DHP / 8; ++t) {
        const __nv_bfloat16* vp = Vt + (t * 8 + gid) * VS + kk * 16 + tig * 2;
        mma_bf16_16816(o[t], a, ld_u32(vp), ld_u32(vp + 8));
      }
    }
  }

  // this split's partial of the block's rows m0 .. m0 + 63, pushed to the
  // blocks that own its elements
  const ClusterMerge<MQ_BM, DHP> merge(recv, min(MQ_BM, R - m0), dh);
  cluster_wait();  // every block of the cluster runs
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = lrow[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = wr + 8 * rr;
#pragma unroll
    for (int t = 0; t < DHP / 8; ++t) {
      merge.push_acc(r, t * 8 + tig * 2, o[t][2 * rr]);
      merge.push_acc(r, t * 8 + tig * 2 + 1, o[t][2 * rr + 1]);
    }
    if (tig == 0) merge.push_ml(r, mrow[rr], l);
  }
  merge.finish([&](int r) {
    const int row = m0 + r;
    return out + (((size_t)b * Q + row / G) * H + (size_t)kvh * G + row % G) * dh;
  });
}

template <int DHP, typename Addr>
int launch_mq(const void* q, const void* k, const void* v, const Addr& addr, void* out, int B,
              int Q, int S, int KV, int G, int dh, int window, float scale, int n_split, int vec,
              cudaStream_t stream) {
  static ClusterLaunch st;
  const int n_rt = (Q * G + MQ_BM - 1) / MQ_BM;
  return launch_clustered(st, mq_tile_kernel<DHP, Addr>, MQ_THREADS, mq_smem_bytes<DHP>(),
                          dim3(n_split, n_rt * KV, B), n_split, stream,
                          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                          (const __nv_bfloat16*)v, addr, (__nv_bfloat16*)out, Q, S, KV, G, dh,
                          window, scale, vec);
}

// One launch a call, by mq_body: the verify body (clusters of n_split), the
// Hopper mainloop (n_split must be 1) or the mma.sync body (clusters of
// n_split).
template <typename Addr>
int dispatch_mq(const void* q, const void* k, const void* v, const Addr& addr, void* out,
                int B, int Q, int S, int KV, int G, int dh, int window, float scale, int n_split,
                int vec, cudaStream_t stream) {
  const int body = mq_body(dh, vec, Q, G);
  if (body == MQ_VERIFY) {
#define REPRO_VERIFY_SM90(DP, NW)                                                             \
  return launch_verify_sm90<DP, NW, Addr>(q, k, v, addr, out, B, Q, S, KV, G, dh, window, scale, \
                                          n_split, stream)
    const int nw = verify_row_warps(Q * G);
    if (dh <= 64) {
      if (nw == 3) REPRO_VERIFY_SM90(64, 3);
      if (nw == 5) REPRO_VERIFY_SM90(64, 5);
      REPRO_VERIFY_SM90(64, 8);
    }
    if (nw == 3) REPRO_VERIFY_SM90(128, 3);
    if (nw == 5) REPRO_VERIFY_SM90(128, 5);
    REPRO_VERIFY_SM90(128, 8);
#undef REPRO_VERIFY_SM90
  }
  if (body == MQ_MAINLOOP) {
    if (n_split != 1) return (int)cudaErrorInvalidValue;
    return sm90::dispatch(q, k, v, addr, out, B, Q, S, addr.map_rows, addr.map_outer, KV, G, dh,
                          window, /*causal=*/1, scale, stream);
  }
  if (dh <= 64) {
    return launch_mq<64>(q, k, v, addr, out, B, Q, S, KV, G, dh, window, scale, n_split, vec,
                         stream);
  }
  if (dh <= 128) {
    return launch_mq<128>(q, k, v, addr, out, B, Q, S, KV, G, dh, window, scale, n_split, vec,
                          stream);
  }
  if (dh <= 256) {
    return launch_mq<256>(q, k, v, addr, out, B, Q, S, KV, G, dh, window, scale, n_split, vec,
                          stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro
