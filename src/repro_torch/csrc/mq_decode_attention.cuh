// Multi-query (q_len >= 1) GQA decode attention, hand-written for Hopper
// (sm_90a): the body shared by the contiguous-cache kernel
// (mq_decode_attention.cu, TPU kernel
// src/repro/kernels/decode_attention/multiquery.py:107) and the paged one
// (mq_paged_decode_attention.cu, TPU kernel multiquery.py:248).
//
// Speculative verification scores q_len = k + 1 positions per sequence in
// one pass, and chunked prefill goes through the same step in rounds of up
// to 512 positions. Their K/V are written into the cache first; query row
// r = qi·G + g (query head g of the KV group) sits at position
// qbase(b) + qi and sees slot t iff the slot's position id lies in
// [0, qbase + qi] and (qbase + qi) - id < window. A row that sees no slot
// outputs 0.
//
// Bound on the H100, two regimes in one kernel:
//  * verify (q_len <= 9, R = q_len·G <= 72 rows per (b, kv head)): bytes.
//    Every visible K/V row is read once for all R rows; at B 4, 1024
//    slots, KV 8, dh 128 that is 16.8 MB, ~5 us at 3.35 TB/s.
//  * chunked prefill (q_len 128-512, R up to 4096): operations,
//    2·2·B·H·(visible (row, slot) pairs)·dh on the tensor cores.
//
// Design (the flash kernel's tensor-core tiles with a per-row mask):
//  * A block of 4 warps owns 64 rows of R for one (b, kv head), 16 rows per
//    warp, and loops over 64-slot tiles of its share of the slots. QK^T
//    and PV run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the score
//    tile and the running (m, l, acc) stay in registers, the QK^T
//    accumulator layout is reused as PV's A operand with P rounded to bf16
//    (what the tensor cores take), and V is stored transposed. The G query
//    heads of a group are rows of one tile, so each K/V row is loaded once
//    for all G heads and all q_len positions.
//  * Rows (b, qi, kv·G + g) are read and written in the model layout
//    (B, q_len, H, dh); K/V rows where the Addr policy finds them (a
//    contiguous (B, S_c, KV, dh) cache, or a (P, page_size, KV, dh) pool
//    through a block table): no transposes, no gather copy.
//  * A tile whose slots no row of the block can see (empty, unallocated,
//    stale ids past the block's last position, or outside the window) is
//    skipped before its K/V are loaded: a prefill chunk reads only the
//    filled part of the cache. Slots with id < 0 are never read.
//  * Enough blocks in flight: the verify shape's (row tile, kv, b) grid is
//    32 blocks, a quarter of the 132 SMs, so the wrapper splits the slots
//    over n_split blocks (flash-decoding) and a second pass merges the
//    partial (m, l, acc); the prefill shapes run unsplit.
// The two policies share this body, its split count and its tile order, so
// on a cache gathered from the pool (uniform ctx, pos = ctx - q_len) the
// paged kernel is bit-identical to the contiguous one.
// Correct first: wgmma, TMA and cp.async pipelining are later work.
#pragma once

#include "common.cuh"

namespace repro {
namespace {

constexpr int MQ_BM = 64;  // query rows per block: 4 warps x 16
constexpr int MQ_BN = 64;  // cache slots per tile
constexpr int MQ_THREADS = 128;

template <int DHP>
constexpr int mq_smem_bytes() {
  return ((MQ_BM + MQ_BN) * (DHP + 8) + DHP * (MQ_BN + 8)) * (int)sizeof(__nv_bfloat16) +
         MQ_BN * ((int)sizeof(long long) + (int)sizeof(int));
}

// Pass 1. Grid (n_rt · n_split, KV, B): row tile rt, slot split `split`.
// Writes the normalized output directly when n_split == 1, else
// part_acc[b, kv, split, r, :] (unnormalized) and part_ml[...] = (m, l).
// Addr::slot(b, kvh, t, off) returns slot t's position id (-1: empty) and
// sets off to the element offset of its K/V row; Addr::qbase(b, Q) is the
// position of query 0 of sequence b. S is the number of slots walked.
template <int DHP, typename Addr>
__global__ void __launch_bounds__(MQ_THREADS) mq_tile_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Addr addr, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int Q, int S, int KV, int G,
    int dh, int window, float scale, int n_rt, int vec) {
  constexpr int QS = DHP + 8;     // Q / K shared row stride (elements)
  constexpr int VS = MQ_BN + 8;   // V^T shared row stride
  constexpr int DC = DHP / 8;     // 8-element chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MQ_BM * QS;
  __nv_bfloat16* Vt = Ks + MQ_BN * QS;
  long long* off_s = reinterpret_cast<long long*>(Vt + DHP * VS);  // [MQ_BN]
  int* ids_s = reinterpret_cast<int*>(off_s + MQ_BN);               // [MQ_BN]

  const int rt = blockIdx.x % n_rt, split = blockIdx.x / n_rt;
  const int n_split = gridDim.x / n_rt;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int R = Q * G, H = KV * G;
  const int m0 = rt * MQ_BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool vec_ok = vec != 0;
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

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = lrow[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + wr + 8 * rr;
    if (row >= R) continue;
    if (n_split == 1) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      __nv_bfloat16* op =
          out + (((size_t)b * Q + row / G) * H + (size_t)kvh * G + row % G) * dh;
#pragma unroll
      for (int t = 0; t < DHP / 8; ++t) {
        const int col = t * 8 + tig * 2;
        if (col < dh) op[col] = __float2bfloat16(o[t][2 * rr] * inv);
        if (col + 1 < dh) op[col + 1] = __float2bfloat16(o[t][2 * rr + 1] * inv);
      }
    } else {
      const size_t p = (((size_t)b * KV + kvh) * n_split + split) * R + row;
      float* ap = part_acc + p * dh;
#pragma unroll
      for (int t = 0; t < DHP / 8; ++t) {
        const int col = t * 8 + tig * 2;
        if (col < dh) ap[col] = o[t][2 * rr];
        if (col + 1 < dh) ap[col + 1] = o[t][2 * rr + 1];
      }
      if (tig == 0) {
        part_ml[2 * p] = mrow[rr];
        part_ml[2 * p + 1] = l;
      }
    }
  }
}

// Pass 2. Grid (R, KV, B): one block merges the n_split partials of one
// row, a thread per output column.
__global__ void __launch_bounds__(MQ_THREADS) mq_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, int Q, int KV, int G, int dh, int n_split) {
  const int row = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int R = Q * G, H = KV * G;
  const size_t p0 = ((size_t)b * KV + kvh) * n_split * R + row;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[2 * (p0 + (size_t)s * R)]);
  __nv_bfloat16* op = out + (((size_t)b * Q + row / G) * H + (size_t)kvh * G + row % G) * dh;
  for (int d = threadIdx.x; d < dh; d += MQ_THREADS) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t p = p0 + (size_t)s * R;
      const float c = expf(part_ml[2 * p] - M);
      L += part_ml[2 * p + 1] * c;
      A += part_acc[p * dh + d] * c;
    }
    op[d] = __float2bfloat16(A / (L == 0.f ? 1.f : L));
  }
}

template <int DHP, typename Addr>
int launch_mq(const void* q, const void* k, const void* v, const Addr& addr, void* out,
              float* part_acc, float* part_ml, int B, int Q, int S, int KV, int G, int dh,
              int window, float scale, int n_split, int vec, cudaStream_t stream) {
  constexpr int smem = mq_smem_bytes<DHP>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(mq_tile_kernel<DHP, Addr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_rt = (Q * G + MQ_BM - 1) / MQ_BM;
  mq_tile_kernel<DHP, Addr><<<dim3(n_rt * n_split, KV, B), MQ_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, addr,
      (__nv_bfloat16*)out, part_acc, part_ml, Q, S, KV, G, dh, window, scale, n_rt, vec);
  if (n_split > 1) {
    mq_combine_kernel<<<dim3(Q * G, KV, B), MQ_THREADS, 0, stream>>>(
        part_acc, part_ml, (__nv_bfloat16*)out, Q, KV, G, dh, n_split);
  }
  return 0;
}

template <typename Addr>
int dispatch_mq(const void* q, const void* k, const void* v, const Addr& addr, void* out,
                float* part_acc, float* part_ml, int B, int Q, int S, int KV, int G, int dh,
                int window, float scale, int n_split, int vec, cudaStream_t stream) {
  if (dh <= 64) {
    return launch_mq<64>(q, k, v, addr, out, part_acc, part_ml, B, Q, S, KV, G, dh, window,
                         scale, n_split, vec, stream);
  }
  if (dh <= 128) {
    return launch_mq<128>(q, k, v, addr, out, part_acc, part_ml, B, Q, S, KV, G, dh, window,
                          scale, n_split, vec, stream);
  }
  if (dh <= 256) {
    return launch_mq<256>(q, k, v, addr, out, part_acc, part_ml, B, Q, S, KV, G, dh, window,
                          scale, n_split, vec, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro
