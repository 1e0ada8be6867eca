// One-token GQA decode attention, hand-written for Hopper (sm_90a): the
// body shared by the contiguous-cache kernel (decode_attention.cu, TPU
// kernel src/repro/kernels/decode_attention/kernel.py:88) and the paged one
// (paged_decode_attention.cu, TPU kernel
// src/repro/kernels/decode_attention/paged.py:119).
//
// Bound on the H100: bytes. Each decode step reads every visible K/V row
// once and does ~2·G flops per element read (G = H/KV query heads per
// group), far below the card's ~295 flop/byte balance point. At the main
// path's shape (B 4, 1024 slots, KV 8, dh 128, bf16) that is 16.8 MB, ~5 us
// at 3.35 TB/s.
//
// Design against that bound:
//  * K/V are read where they lie, in the model layout: row t of sequence b
//    is one KV·dh row, found by the Addr policy (a contiguous
//    (B, S_c, KV, dh) cache, or a (P, page_size, KV, dh) pool through a
//    block table). No transpose, no padding of dh in memory, no gather copy
//    before the kernel.
//  * One block serves all G query heads of a KV group, so each K/V row is
//    loaded once for the G heads that share it (the TPU kernel made G its
//    matmul M dimension for the same reason).
//  * Enough bytes in flight: (B, KV) alone gives 32 blocks at the main
//    path's shape, a quarter of the 132 SMs, so the S slots are split over
//    n_split blocks (flash-decoding; pass 2 merges the partial
//    (max, sum, acc)). Each block stages 32-slot K and V tiles through
//    shared memory with 16-byte loads, every thread issuing all of its
//    loads of a tile before it waits on any.
//  * Slot validity and address come from Addr; an invalid slot's row is
//    never read, and a tile with no valid slot is skipped before its loads
//    (bit-neutral: such a tile leaves (m, l, acc) exactly as they were). A
//    row with no valid slot outputs 0 (l == 0 -> 1).
//  * Online softmax in fp32 with NEG_INF = -2e30, as on the TPU; the
//    probabilities stay fp32 through PV.
// Per tile: lanes take slots for QK^T (warp w owns heads w, w+4, ...), the
// warp reduces max and sum over its 32 slots with shuffles, and for PV each
// thread owns two columns of a few heads. Simple and right first: cp.async
// double buffering is later work.
//
// The two policies share this body, its split count and its tile order, so
// on a cache gathered from the pool (uniform ctx, pos = ctx - 1) the paged
// kernel is bit-identical to the contiguous one.
#pragma once

#include "common.cuh"

namespace repro {
namespace {

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int TS = 32;  // slots per shared-memory tile (one per lane)

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
         TS * (int)sizeof(long long);
}

// Pass 1. Grid (n_split, KV, B). Writes part_ml[b, kv, split, g] = (m, l)
// and part_acc[b, kv, split, g, :] = acc, or with n_split == 1 the
// normalized output directly. Addr::offset(b, kvh, t) is the element
// offset of slot t's K/V row (of head kvh) or -1 when the slot is not
// visible; S is the number of slots walked.
template <typename T, int GMAX, int DHP, typename Addr>
__global__ void __launch_bounds__(DEC_THREADS) decode_tile_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Addr addr,
    T* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml, int S,
    int KV, int G, int dh, float scale, int chunk, int vec) {
  using Geo = TileGeom<T, DHP>;
  constexpr int RW = Geo::RW, CH = Geo::CH, NC = DHP / CH;
  constexpr int NDP = DHP / 2;                 // column pairs
  constexpr int NGG = DEC_THREADS / NDP;       // head groups in PV
  constexpr int GPT = (GMAX + NGG - 1) / NGG;  // heads per thread in PV
  constexpr int GPW = GMAX / DEC_WARPS;        // heads per warp in QK^T
  static_assert(DEC_THREADS % NDP == 0, "DHP must divide 256");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                            // [GMAX][DHP]
  uint32_t* k_s = reinterpret_cast<uint32_t*>(q_s + GMAX * DHP);  // [TS][RW]
  uint32_t* v_s = k_s + TS * RW;                // [TS][RW]
  float* p_s = reinterpret_cast<float*>(v_s + TS * RW);  // [GMAX][TS]
  float* corr_s = p_s + GMAX * TS;              // [GMAX]
  // [TS] row offsets, -1 = not visible (8-byte aligned: the float count
  // before it is even for every instantiation)
  long long* off_s = reinterpret_cast<long long*>(corr_s + GMAX);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KV * G;

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
      const long long off = s < s1 ? addr.offset(b, kvh, s) : -1;
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

  // (m, l) of each head from its owning warp, then write
  __syncthreads();
  float* m_s = p_s;             // reuse: [GMAX]
  float* l_s = p_s + GMAX;      // [GMAX]
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
      m_s[warp + DEC_WARPS * i] = m[i];
      l_s[warp + DEC_WARPS * i] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int g = gg + NGG * i;
    if (g >= G) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 2 * dp + e;
      if (d >= dh) continue;
      if (n_split == 1) {
        const float L = l_s[g];
        out[((size_t)b * H + (size_t)kvh * G + g) * dh + d] =
            from_f<T>(acc[i][e] / (L == 0.f ? 1.f : L));
      } else {
        const size_t p = (((size_t)b * KV + kvh) * n_split + split) * G + g;
        part_acc[p * dh + d] = acc[i][e];
        if (d == 0) {
          part_ml[2 * p] = m_s[g];
          part_ml[2 * p + 1] = l_s[g];
        }
      }
    }
  }
}

// Pass 2. Grid (KV, B): merge the n_split partials of each (b, kv, g).
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int KV, int G, int dh, int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = KV * G;
  for (int idx = threadIdx.x; idx < G * dh; idx += DEC_THREADS) {
    const int g = idx / dh, d = idx % dh;
    const size_t p0 = (((size_t)b * KV + kvh) * n_split) * G + g;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[2 * (p0 + (size_t)s * G)]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t p = p0 + (size_t)s * G;
      const float c = expf(part_ml[2 * p] - M);
      L += part_ml[2 * p + 1] * c;
      A += part_acc[p * dh + d] * c;
    }
    out[((size_t)b * H + (size_t)kvh * G + g) * dh + d] = from_f<T>(A / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int GMAX, int DHP, typename Addr>
int launch_decode(const void* q, const void* k, const void* v, const Addr& addr, void* out,
                  float* part_acc, float* part_ml, int B, int S, int KV, int G, int dh,
                  float scale, int n_split, int vec, cudaStream_t stream) {
  constexpr int smem = decode_smem_bytes<T, GMAX, DHP>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(decode_tile_kernel<T, GMAX, DHP, Addr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int chunk = (S + n_split - 1) / n_split;
  decode_tile_kernel<T, GMAX, DHP, Addr><<<dim3(n_split, KV, B), DEC_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, addr, (T*)out, part_acc, part_ml, S, KV, G, dh,
      scale, chunk, vec);
  if (n_split > 1) {
    decode_combine_kernel<T><<<dim3(KV, B), DEC_THREADS, 0, stream>>>(part_acc, part_ml, (T*)out,
                                                                       KV, G, dh, n_split);
  }
  return 0;
}

template <typename T, typename Addr>
int dispatch_decode(const void* q, const void* k, const void* v, const Addr& addr, void* out,
                    float* part_acc, float* part_ml, int B, int S, int KV, int G, int dh,
                    float scale, int n_split, int vec, cudaStream_t stream) {
#define REPRO_DECODE(GM, DP)                                                                   \
  return launch_decode<T, GM, DP, Addr>(q, k, v, addr, out, part_acc, part_ml, B, S, KV, G, dh, \
                                        scale, n_split, vec, stream)
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
