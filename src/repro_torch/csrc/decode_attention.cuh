// One-token GQA decode attention, hand-written for Hopper (sm_90a): the
// body shared by the contiguous-cache kernel (decode_attention.cu, TPU
// kernel src/repro/kernels/decode_attention/kernel.py:88) and the paged one
// (paged_decode_attention.cu, TPU kernel
// src/repro/kernels/decode_attention/paged.py:119).
//
// What it computes: one query token per sequence; the G query heads of a
// KV group read one K/V stream; a slot is visible as the Addr policy says
// (contiguous: 0 <= pos_id <= pos and pos - pos_id < window; paged: t <
// ctx, the window, an allocated page); scores, the online softmax (m, l)
// with NEG_INF = -2e30 and the output accumulator are fp32, and the
// probabilities stay fp32 through PV; a head that sees no slot outputs 0.
//
// Bound on the H100: bytes. Each decode step reads every visible K/V row
// once and does ~2·G flops per element read (G = H/KV query heads per
// group), far below the card's ~295 flop/byte balance point. At the main
// path's shape (B 4, 1024 slots, KV 8, dh 128, bf16) that is 16.8 MB, ~5 us
// at 3.35 TB/s.
//
// Design against that bound (decode_sm90_kernel: bf16, 16-byte aligned rows,
// dh <= 128, G <= 16, the served shapes):
//  * One launch. The S slots of a (b, kv group) are split over n_split <=
//    8 blocks (flash-decoding, enough blocks to fill the SMs at B 1 and
//    B 4), and those blocks form one thread block cluster. Each block
//    pushes its split's partial (acc, m, l) into the shared memory of the
//    blocks that own its outputs (stores to distributed shared memory);
//    after one cluster barrier every block merges its slice of the G·dh
//    outputs over the splits in rank order. No partials go through global
//    memory, and the order is fixed, so the result is deterministic. The
//    merge (ClusterMerge) lives in cluster_merge.cuh, shared with the
//    multi-query bodies.
//  * An asynchronous K/V ring per warp. A block of 8 warps walks its
//    slots in 64-slot tiles, each warp an 8-slot share of every tile; a
//    warp streams its shares through a ring of 3 stages with cp.async
//    16-byte copies (LDGSTS), zero-filled for slots that are not visible
//    (never read: they may hold NaN). A share with no visible slot is
//    skipped before its copies. The warp reads the ids (or block-table
//    entries) of share n + 3 while it consumes share n, and works out a
//    share's visibility when it issues it, so HBM latency overlaps compute;
//    warps never wait for each other in the loop.
//  * QK^T on the tensor cores: mma.sync m16n8k16, bf16 Q (A, the G heads as
//    rows, padded to 16 with zeros, held in registers for the whole call)
//    times bf16 K (B, 8 slots, ldmatrix from the ring) into fp32: the
//    scores are the fp32 dot products of the same bf16 values up to
//    summation order. Padding rows never reach m, l or the output.
//  * PV on fp32 FMAs: each warp's probabilities go to shared memory, and
//    each lane accumulates dh/32 output columns of every head from the
//    share's V rows. The eight warps' partials merge in the block (fixed
//    warp order) before the cluster merge.
// Other shapes (fp32, dh 129-256, unaligned rows) take decode_tile_kernel:
// a block stages 32-slot tiles through shared memory with 16-byte loads,
// QK^T and PV on fp32 FMAs, and merges through the same cluster step.
// Which body runs is decode_sm90_takes (mirrored by the wrappers'
// takes_hopper_decode), a function of the shapes alone.
//
// The two Addr policies share the bodies, the split count, the tile order
// and the merge; they differ only in how a slot's row address is formed.
// So on a cache gathered from the pool (uniform ctx, pos = ctx - 1) the
// paged kernel is bit-identical to the contiguous one.
//
// Addr interface: begin(b) loads the per-sequence state; fetch(t) reads
// slot t's raw id (a pos_id or a block-table entry; the only global load
// of the slot walk); row(raw, t) is slot t's row in the (rows, KV, dh)
// view of the K/V tensors, or -1 when the slot is not visible.
#pragma once

#include "cluster_merge.cuh"

namespace repro {
namespace {

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int TS = 32;           // slots per tile of the fp32-FMA body

// The shapes decode_sm90_kernel takes (bf16 besides).
inline bool decode_sm90_takes(int dh, int vec, int G) {
  return vec != 0 && dh % 8 == 0 && dh <= 128 && G <= 16;
}

// ---------------------------------------------------------------------------
// The Hopper body
// ---------------------------------------------------------------------------
constexpr int SM90_WARPS = 8;
constexpr int SM90_THREADS = 32 * SM90_WARPS;
constexpr int SM90_TILE = 64;                 // slots per tile
constexpr int QS = SM90_TILE / SM90_WARPS;    // slots of a warp's share (one mma N)
constexpr int STAGES = 3;                   // ring depth of each warp

template <int DHP, int GM>
struct Sm90Geom {
  static constexpr int KS = DHP + 8;                     // K row stride (elements)
  static constexpr int K_BYTES = QS * KS * 2;
  static constexpr int V_BYTES = QS * DHP * 2;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int RING = STAGES * STAGE;            // one warp's ring
  static constexpr int P_OFF = SM90_WARPS * RING;        // float [warp][QS][GM]
  static constexpr int C_OFF = P_OFF + SM90_WARPS * QS * GM * 4;  // float [warp][GM]
  static constexpr int R_OFF = C_OFF + SM90_WARPS * GM * 4;    // the merge's receive region
  static constexpr int BYTES = R_OFF + merge_floats<GM, DHP>() * 4;
  // after the loop: a warp's partial (A [GM][DHP], M [GM], L [GM]) in its
  // own ring
  static constexpr int PART = (GM * DHP + 2 * GM) * 4;
  static_assert(PART <= RING, "a warp's partial must fit its ring");
};

template <int DHP, int GM>
constexpr int sm90_decode_smem_bytes() {
  return Sm90Geom<DHP, GM>::BYTES;
}

// Grid (n_split, KV, B), clusters of n_split blocks along x. Block `split`
// walks slots [split·chunk, min(S, (split + 1)·chunk)) in 64-slot tiles;
// warp w takes slots 8w .. 8w + 7 of each tile.
template <int DHP, int GM, typename Addr>
__global__ void __launch_bounds__(SM90_THREADS, GM <= 8 ? 2 : 1) decode_sm90_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Addr addr, __nv_bfloat16* __restrict__ out, int S,
    int KV, int G, int dh, float scale, int chunk) {
  using L = Sm90Geom<DHP, GM>;
  constexpr int KK = DHP / 16;       // mma K steps
  constexpr int NC = DHP / 8;        // 16-byte chunks of a row
  constexpr int CPL = DHP / 32;      // output columns of a lane in PV
  constexpr int CH = QS * NC / 32;   // chunks of a share's K (and V) per lane
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int H = KV * G;
  cluster_arrive_relaxed();  // this block runs (see cluster_wait below)
  Addr a = addr;
  a.begin(b);

  // Q as the A operand: a[0] rows gid, a[1] rows gid + 8, columns
  // 16·kk + 2·tig (+ 8 for a[2], a[3]); zero past G and dh
  uint32_t qa[KK][4];
  {
    const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G) * dh;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = gid + 8 * (j & 1), col = 16 * kk + 2 * tig + 8 * (j >> 1);
        qa[kk][j] = (GM > 8 || g < 8) && g < G && col < dh ? ld_u32(qb + g * dh + col) : 0u;
      }
    }
  }

  unsigned char* ring = smem + warp * L::RING;
  float* p_s = reinterpret_cast<float*>(smem + L::P_OFF) + warp * QS * GM;  // [QS][GM]
  float* c_s = reinterpret_cast<float*>(smem + L::C_OFF) + warp * GM;       // [GM]
  const uint32_t ring_u32 = (uint32_t)__cvta_generic_to_shared(ring);

  const int s0 = split * chunk;
  const int s1 = min(S, s0 + chunk);
  const int n_t = s1 > s0 ? (s1 - s0 + SM90_TILE - 1) / SM90_TILE : 0;
  const int my = warp * QS + (lane & (QS - 1));  // this lane's slot in a tile

  // Share t: slot ids read ahead (raw), issued into stage t % STAGES with
  // the visible-slot mask kept in oks (8 bits a stage).
  auto fetch = [&](int t) {
    const int s = s0 + t * SM90_TILE + my;
    return t < n_t && s < s1 ? a.fetch(s) : -1;
  };
  unsigned oks = 0;
  auto issue = [&](int t, int raw) {
    const int st = t % STAGES;
    const int row = raw < 0 ? -1 : a.row(raw, s0 + t * SM90_TILE + my);
    const unsigned okm = __ballot_sync(0xffffffffu, row >= 0) & ((1u << QS) - 1);
    oks = (oks & ~(0xffu << (8 * st))) | (okm << (8 * st));
    if (okm) {
      const uint32_t ks = ring_u32 + st * L::STAGE, vs = ks + L::K_BYTES;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int c = lane + 32 * u;
        const int r = c / NC, d0 = (c % NC) * 8;
        const int rr = __shfl_sync(0xffffffffu, row, r);
        const bool in = rr >= 0 && d0 < dh;
        const size_t off = in ? ((size_t)rr * KV + kvh) * dh + d0 : 0;
        cp_async16(ks + (r * L::KS + d0) * 2, k + off, in ? 16 : 0);
        cp_async16(vs + (r * DHP + d0) * 2, v + off, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float m[2] = {NEG_INF, NEG_INF};  // heads gid, gid + 8
  float l[2] = {0.f, 0.f};          // this lane's share of their sums
  float acc[GM][CPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
  }

  int raw[STAGES];
#pragma unroll
  for (int t = 0; t < STAGES; ++t) raw[t] = fetch(t);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t, raw[t]);
  int raw_next = raw[STAGES - 1];

  for (int t = 0; t < n_t; ++t) {
    issue(t + STAGES - 1, raw_next);
    raw_next = fetch(t + STAGES);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int st = t % STAGES;
    const unsigned okm = (oks >> (8 * st)) & 0xffu;
    if (okm) {
      // S (16 heads x 8 slots) = Q K^T: c[0], c[1] head gid, slots 2·tig,
      // 2·tig + 1; c[2], c[3] head gid + 8
      const uint32_t ks = ring_u32 + st * L::STAGE;
      // two accumulator chains (even and odd K steps), added at the end
      float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KK; kk += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + ((lane & 7) * L::KS + 16 * kk + 8 * (lane >> 3)) * 2);
        mma_bf16_16816(s, qa[kk], kb[0], kb[1]);
        mma_bf16_16816(s2, qa[kk + 1], kb[2], kb[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += s2[i];
      const bool ok0 = (okm >> (2 * tig)) & 1u, ok1 = (okm >> (2 * tig + 1)) & 1u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (GM <= 8 && h == 1) break;
        float s0v = ok0 ? s[2 * h] * scale : NEG_INF;
        float s1v = ok1 ? s[2 * h + 1] * scale : NEG_INF;
        float mx = fmaxf(s0v, s1v);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float p0 = ok0 ? expf(s0v - m_new) : 0.f;
        const float p1 = ok1 ? expf(s1v - m_new) : 0.f;
        const float corr = expf(m[h] - m_new);
        l[h] = l[h] * corr + (p0 + p1);
        m[h] = m_new;
        const int g = gid + 8 * h;
        p_s[(2 * tig) * GM + g] = p0;
        p_s[(2 * tig + 1) * GM + g] = p1;
        if (tig == 0) c_s[g] = corr;
      }
      __syncwarp();
      // PV: columns CPL·lane .. CPL·lane + CPL - 1 of every head
      const __nv_bfloat16* vst =
          reinterpret_cast<const __nv_bfloat16*>(ring + st * L::STAGE + L::K_BYTES);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float c = c_s[g];
#pragma unroll
          for (int e = 0; e < CPL; ++e) acc[g][e] *= c;
        }
      }
#pragma unroll
      for (int j = 0; j < QS; ++j) {
        float vv[CPL];
        if constexpr (CPL == 4) {
          const uint2 w = *reinterpret_cast<const uint2*>(vst + j * DHP + 4 * lane);
          const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
          vv[0] = __low2float(lo);
          vv[1] = __high2float(lo);
          vv[2] = __low2float(hi);
          vv[3] = __high2float(hi);
        } else {
          const __nv_bfloat162 w =
              *reinterpret_cast<const __nv_bfloat162*>(vst + j * DHP + 2 * lane);
          vv[0] = __low2float(w);
          vv[1] = __high2float(w);
        }
        const float4* pj = reinterpret_cast<const float4*>(p_s + j * GM);
#pragma unroll
        for (int g4 = 0; g4 < GM / 4; ++g4) {
          if (4 * g4 < G) {
            const float4 p = pj[g4];
            const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int e = 0; e < CPL; ++e) acc[4 * g4 + i][e] += pv[i] * vv[e];
            }
          }
        }
      }
    }
    __syncwarp();  // stage st and p_s are free for the next issue
  }
  cp_async_wait<0>();

  // this warp's partial into its own ring: A [GM][DHP], M [GM], L [GM]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncwarp();
  float* wA = reinterpret_cast<float*>(ring);
  float* wM = wA + GM * DHP;
  float* wL = wM + GM;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < CPL; ++e) wA[g * DHP + CPL * lane + e] = acc[g][e];
  }
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (GM > 8 || h == 0) {
        wM[gid + 8 * h] = m[h];
        wL[gid + 8 * h] = l[h];
      }
    }
  }
  __syncthreads();

  // the block's partial, the eight warps' merged in warp order, pushed to
  // the blocks that own its elements
  const ClusterMerge<GM, DHP> merge(reinterpret_cast<float*>(smem + L::R_OFF), G, dh);
  cluster_wait();  // every block of the cluster runs
  constexpr int EPT = GM * DHP / SM90_THREADS;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + SM90_THREADS * i;
    const int g = e / DHP, d = e % DHP;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < SM90_WARPS; ++w) {
      M = fmaxf(M, reinterpret_cast<const float*>(smem + w * L::RING)[GM * DHP + g]);
    }
    float Ls = 0.f, As = 0.f;
#pragma unroll
    for (int w = 0; w < SM90_WARPS; ++w) {
      const float* pw = reinterpret_cast<const float*>(smem + w * L::RING);
      const float c = expf(pw[GM * DHP + g] - M);
      Ls += pw[GM * DHP + GM + g] * c;
      As += pw[g * DHP + d] * c;
    }
    merge.push_acc(g, d, As);
    if (d == 0) merge.push_ml(g, M, Ls);
  }
  merge.finish([&](int g) { return out + (((size_t)b * KV + kvh) * G + g) * dh; });
}

// ---------------------------------------------------------------------------
// The fp32-FMA body (fp32, dh 129-256, unaligned rows)
// ---------------------------------------------------------------------------
template <typename T, int DHP>
struct TileGeom {
  // row stride in 4-byte words: an odd count keeps the lane-per-slot reads
  // of QK^T free of bank conflicts
  static constexpr int RW = DHP * (int)sizeof(T) / 4 + 1;
  static constexpr int CH = 16 / (int)sizeof(T);  // elements per 16-byte load
};

template <typename T, int GMAX, int DHP>
constexpr int decode_smem_bytes() {
  return (GMAX * DHP + 2 * TS * TileGeom<T, DHP>::RW + GMAX * TS + GMAX) * 4 +
         TS * (int)sizeof(long long) + merge_floats<GMAX, DHP>() * 4;
}

// Grid (n_split, KV, B), clusters of n_split blocks along x. Lanes take
// slots for QK^T (warp w owns heads w, w+4, ...), the warp reduces max and
// sum over its 32 slots with shuffles, and for PV each thread owns two
// columns of a few heads.
template <typename T, int GMAX, int DHP, typename Addr>
__global__ void __launch_bounds__(DEC_THREADS) decode_tile_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Addr addr,
    T* __restrict__ out, int S, int KV, int G, int dh, float scale, int chunk, int vec) {
  using Geo = TileGeom<T, DHP>;
  constexpr int RW = Geo::RW, CH = Geo::CH, NC = DHP / CH;
  constexpr int NDP = DHP / 2;                 // column pairs
  constexpr int NGG = DEC_THREADS / NDP;       // head groups in PV
  constexpr int GPT = (GMAX + NGG - 1) / NGG;  // heads per thread in PV
  constexpr int GPW = GMAX / DEC_WARPS;        // heads per warp in QK^T
  static_assert(DEC_THREADS % NDP == 0, "DHP must divide 256");

  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                          // [GMAX][DHP]
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + GMAX * DHP);  // [TS][RW]
  uint32_t* v_s = k_s + TS * RW;                // [TS][RW]
  float* p_s = reinterpret_cast<float*>(v_s + TS * RW);  // [GMAX][TS]
  float* corr_s = p_s + GMAX * TS;              // [GMAX]
  // [TS] row offsets, -1 = not visible (8-byte aligned: the float count
  // before it is even for every instantiation)
  long long* off_s = reinterpret_cast<long long*>(corr_s + GMAX);
  float* recv = reinterpret_cast<float*>(off_s + TS);  // the merge's receive region

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KV * G;
  cluster_arrive_relaxed();  // this block runs (see cluster_wait below)
  Addr a = addr;
  a.begin(b);

  for (int idx = tid; idx < GMAX * DHP; idx += DEC_THREADS) {
    const int g = idx / DHP, d = idx % DHP;
    q_s[idx] = (g < G && d < dh)
                   ? to_f(q[((size_t)b * H + (size_t)kvh * G + g) * dh + d])
                   : 0.f;
  }

  // QK^T / softmax state: warp w owns heads w + 4·i (replicated in lanes)
  float m[GPW], l[GPW];
#pragma unroll
  for (int i = 0; i < GPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  // PV state: columns 2·dp, 2·dp + 1 of heads gg + NGG·i
  const int dp = tid % NDP, gg = tid / NDP;
  float acc[GPT][2];
#pragma unroll
  for (int i = 0; i < GPT; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int s0 = split * chunk;
  const int s1 = min(S, s0 + chunk);
  for (int t0 = s0; t0 < s1; t0 += TS) {
    __syncthreads();  // the previous tile is consumed (and q_s is stored)
    int live = 0;
    if (tid < TS) {
      const int s = t0 + tid;
      const int row = s < s1 ? a.row(a.fetch(s), s) : -1;
      const long long off = row >= 0 ? ((long long)row * KV + kvh) * dh : -1;
      off_s[tid] = off;
      live = off >= 0;
    }
    if (!__syncthreads_or(live)) continue;  // no visible slot: skip the loads
    // stage K and V: 16-byte chunks, all issued before any is stored
    constexpr int PER = (TS * NC + DEC_THREADS - 1) / DEC_THREADS;
    uint4 kb[PER], vb[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = tid + u * DEC_THREADS;
      const int r = c / NC, d0 = (c % NC) * CH;
      kb[u] = vb[u] = make_uint4(0, 0, 0, 0);
      const long long off = c < TS * NC ? off_s[r] : -1;
      if (off >= 0 && d0 < dh) {
        const T* kp = k + off + d0;
        const T* vp = v + off + d0;
        if (vec && d0 + CH <= dh) {
          kb[u] = *reinterpret_cast<const uint4*>(kp);
          vb[u] = *reinterpret_cast<const uint4*>(vp);
        } else {
          T* kt = reinterpret_cast<T*>(&kb[u]);
          T* vt = reinterpret_cast<T*>(&vb[u]);
#pragma unroll
          for (int e = 0; e < CH; ++e) {
            if (d0 + e < dh) {
              kt[e] = kp[e];
              vt[e] = vp[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = tid + u * DEC_THREADS;
      if (c >= TS * NC) break;
      const int r = c / NC, w0 = (c % NC) * 4;  // 4 words per chunk
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kb[u]);
      const uint32_t* vw = reinterpret_cast<const uint32_t*>(&vb[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k_s[r * RW + w0 + e] = kw[e];
        v_s[r * RW + w0 + e] = vw[e];
      }
    }
    __syncthreads();

    // QK^T: lane = slot, warp = heads; then the warp's online softmax
    const bool ok = off_s[lane] >= 0;
    float sc[GPW];
#pragma unroll
    for (int i = 0; i < GPW; ++i) sc[i] = 0.f;
    const T* krow = reinterpret_cast<const T*>(k_s + lane * RW);
#pragma unroll 8
    for (int d = 0; d < DHP; d += 2) {
      const float k0 = to_f(krow[d]), k1 = to_f(krow[d + 1]);
#pragma unroll
      for (int i = 0; i < GPW; ++i) {
        const float* qg = q_s + (warp + DEC_WARPS * i) * DHP + d;
        sc[i] += qg[0] * k0 + qg[1] * k1;
      }
    }
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      const int g = warp + DEC_WARPS * i;
      const float s = ok ? sc[i] * scale : NEG_INF;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      p_s[g * TS + lane] = p;
      if (lane == 0) corr_s[g] = corr;
    }
    __syncthreads();

    // PV: this thread's two columns of heads gg + NGG·i
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int g = gg + NGG * i;
      if (g < GMAX) {
        const float c = corr_s[g];
        acc[i][0] *= c;
        acc[i][1] *= c;
      }
    }
#pragma unroll 4
    for (int j = 0; j < TS; ++j) {
      const T* vrow = reinterpret_cast<const T*>(v_s + j * RW);
      const float v0 = to_f(vrow[2 * dp]), v1 = to_f(vrow[2 * dp + 1]);
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        const int g = gg + NGG * i;
        if (g < GMAX) {
          const float p = p_s[g * TS + j];
          acc[i][0] += p * v0;
          acc[i][1] += p * v1;
        }
      }
    }
  }

  // this split's partial, pushed to the blocks that own its elements: acc
  // from every thread, (m, l) of each head from its owning warp
  const ClusterMerge<GMAX, DHP> merge(recv, G, dh);
  cluster_wait();  // every block of the cluster runs
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < GPW; ++i) merge.push_ml(warp + DEC_WARPS * i, m[i], l[i]);
  }
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    merge.push_acc(gg + NGG * i, 2 * dp, acc[i][0]);
    merge.push_acc(gg + NGG * i, 2 * dp + 1, acc[i][1]);
  }
  merge.finish([&](int g) { return out + (((size_t)b * KV + kvh) * G + g) * dh; });
}

// ---------------------------------------------------------------------------
// Launch: one kernel, clusters of n_split blocks
// ---------------------------------------------------------------------------
template <int DHP, int GM, typename Addr>
int launch_decode_sm90(const void* q, const void* k, const void* v, const Addr& addr,
                       void* out, int B, int S, int KV, int G, int dh, float scale,
                       int n_split, cudaStream_t stream) {
  static ClusterLaunch st;
  const int chunk = (S + n_split - 1) / n_split;
  return launch_clustered(st, decode_sm90_kernel<DHP, GM, Addr>, SM90_THREADS,
                          sm90_decode_smem_bytes<DHP, GM>(),
                          dim3(n_split, KV, B), n_split, stream, (const __nv_bfloat16*)q,
                          (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, addr,
                          (__nv_bfloat16*)out, S, KV, G, dh, scale, chunk);
}

template <typename T, int GMAX, int DHP, typename Addr>
int launch_decode(const void* q, const void* k, const void* v, const Addr& addr, void* out,
                  int B, int S, int KV, int G, int dh, float scale, int n_split, int vec,
                  cudaStream_t stream) {
  static ClusterLaunch st;
  const int chunk = (S + n_split - 1) / n_split;
  return launch_clustered(st, decode_tile_kernel<T, GMAX, DHP, Addr>, DEC_THREADS,
                          decode_smem_bytes<T, GMAX, DHP>(), dim3(n_split, KV, B), n_split,
                          stream, (const T*)q, (const T*)k, (const T*)v, addr, (T*)out, S, KV,
                          G, dh, scale, chunk, vec);
}

// The body by shape: decode_sm90_kernel for bf16 with decode_sm90_takes,
// decode_tile_kernel otherwise.
template <typename T, typename Addr>
int dispatch_decode(const void* q, const void* k, const void* v, const Addr& addr, void* out,
                    int B, int S, int KV, int G, int dh, float scale, int n_split, int vec,
                    int dtype, cudaStream_t stream) {
  if (dtype == DTYPE_BF16 && decode_sm90_takes(dh, vec, G)) {
#define REPRO_DECODE_SM90(DP, GM) \
  return launch_decode_sm90<DP, GM, Addr>(q, k, v, addr, out, B, S, KV, G, dh, scale, n_split, stream)
    if (dh <= 64) {
      if (G <= 8) REPRO_DECODE_SM90(64, 8);
      REPRO_DECODE_SM90(64, 16);
    }
    if (G <= 8) REPRO_DECODE_SM90(128, 8);
    REPRO_DECODE_SM90(128, 16);
#undef REPRO_DECODE_SM90
  }
#define REPRO_DECODE(GM, DP)                                                                \
  return launch_decode<T, GM, DP, Addr>(q, k, v, addr, out, B, S, KV, G, dh, scale, n_split, \
                                        vec, stream)
  if (G <= 8) {
    if (dh <= 64) REPRO_DECODE(8, 64);
    if (dh <= 128) REPRO_DECODE(8, 128);
    if (dh <= 256) REPRO_DECODE(8, 256);
  } else if (G <= 16) {
    if (dh <= 64) REPRO_DECODE(16, 64);
    if (dh <= 128) REPRO_DECODE(16, 128);
  }
#undef REPRO_DECODE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro
