// The chunked (matrix-form) bodies of the recurrent scans, hand-written for
// Hopper (sm_90a): kernel 6 (WKV, wkv_scan.cu) and kernel 7 (selective
// scan, ssm_scan.cu) run them on every bf16 call of S >= SCAN_CHUNK_MIN_S
// steps, one launch a call.
//
// A call is cut into chunks of L steps, anchored at the call's first step.
// The chunks of one (b, h) are the blocks of one thread block cluster (at
// most CLUSTER_MAX; a longer call walks its chunks in rounds of n blocks,
// block `rank` taking chunk round·n + rank). Each block:
//  1. computes its chunk's contribution to the state dS (the chunk's final
//     state from a zero state) and its decay, on the tensor cores, into the
//     chunk's slot of an exchange buffer in global memory (L2);
//  2. after a cluster barrier, runs the recurrence over chunk states
//     S_{k+1} = decay_k ⊙ S_k + dS_k in chunk order from the call's
//     initial state for its share of the state's elements (ChunkChain),
//     writing each S_k over dS_k in the slot. Every element runs the same
//     fmaf chain whichever block carries it, so the state at a chunk
//     boundary is one fixed sequence of roundings: two calls split at a
//     multiple of L give the one call's result bit for bit;
//  3. after a second barrier, reads the state at its chunk's start from
//     its slot and computes its outputs.
// The blocks carrying the elements write the final state in place (each
// element is read and written by one thread). The exchange goes through
// L2 and not distributed shared memory: pushing or pulling the states
// through DSMEM cost 70-130 us at the prefill shape (tools/ablate_scan.py,
// PERF.md), far more than its bytes.
//
// Precision. The scans are held to 1e-4 of each vector's largest |value|
// (SCAN_REL), which one bf16 rounding of an fp32 factor (2^-9) breaks. The
// model's inputs (r, k, v, u; x, B, C) are bf16 and enter the tensor
// cores exactly. Every other operand (a decay-weighted input, a score, the
// fp32 state) enters as three bf16 terms hi + mid + lo, which hold it to
// 2^-26: three products against an exact operand, six (those of order up
// to 2^-16: hh, hm, mh, hl, mm, lh) when neither is exact. Products of
// bf16 values are exact in the fp32 accumulators. Two terms (2^-17) were
// the first design: they held random inputs to 2.8e-5 of the reference,
// but an output that cancels (r·S near 0 after a state reset by w = 0, or
// C_t·B_s near 0 after a step of dt 20) amplified them past 1e-4; three
// terms are as accurate as the sequential fp32 scan (tests/
// test_torch_scan_chunked.py holds both against fp64 there).
//
// Decays. Only products of decays in [0, 1] are formed, as running
// products over steps (never a ratio of two prefix products, never an exp
// of a difference of cumulative sums): nothing overflows, a decay of
// exactly 0 (or one that underflows) gives exact zeros, and no NaN can
// arise. No clamp is needed.
#pragma once

#include <initializer_list>

#include "cluster_merge.cuh"

namespace repro {
namespace {

constexpr int SCAN_CHUNK_MIN_S = 128;  // bf16 calls of this many steps take the chunked body
constexpr int SCAN_SUB = 16;           // steps of a sub-chunk: one mma m / k tile

// x as three bf16 terms h + m + l (both differences are exact in fp32)
__device__ __forceinline__ void split3(float x, __nv_bfloat16& h, __nv_bfloat16& m,
                                       __nv_bfloat16& l) {
  h = __float2bfloat16(x);
  const float r = x - __bfloat162float(h);
  m = __float2bfloat16(r);
  l = __float2bfloat16(r - __bfloat162float(m));
}

// ... stored at index `at` of the three tiles t[0..2]
__device__ __forceinline__ void split3_at(float x, __nv_bfloat16* const (&t)[3], int at) {
  split3(x, t[0][at], t[1][at], t[2][at]);
}

// two adjacent values x0, x1 as packed pairs of each term, stored at index
// `at` (even) of the three tiles
__device__ __forceinline__ void split3x2_at(float x0, float x1, __nv_bfloat16* const (&t)[3],
                                            int at) {
  __nv_bfloat162 p[3];
  split3(x0, p[0].x, p[1].x, p[2].x);
  split3(x1, p[0].y, p[1].y, p[2].y);
#pragma unroll
  for (int j = 0; j < 3; ++j) *reinterpret_cast<__nv_bfloat162*>(t[j] + at) = p[j];
}

// Fragments of mma.m16n8k16 from bf16 tiles in shared memory (`base` a
// shared-space address, `stride` the row stride in elements, a multiple
// of 8). A (16 x 16) at rows r0.., columns c0.. of a row-major tile:
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t base, int stride, int r0,
                                       int c0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(a, base + ((r0 + (l & 15)) * stride + c0 + 8 * (l >> 4)) * 2);
}
// B of the two n-tiles n0 and n0 + 8 over k in [k0, k0 + 16), from a tile
// stored k-major ([k][n]): b[0], b[1] for n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], uint32_t base, int stride, int k0,
                                          int n0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4_trans(b, base + ((k0 + (l & 15)) * stride + n0 + 8 * (l >> 4)) * 2);
}
// ... from a tile stored n-major ([n][k])
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], uint32_t base, int stride, int k0,
                                          int n0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(b, base + ((n0 + (l & 7) + 8 * (l >> 4)) * stride + k0 + 8 * ((l >> 3) & 1)) * 2);
}
// ... of the one n-tile n0
__device__ __forceinline__ void frag_b_kn1(uint32_t (&b)[2], uint32_t base, int stride, int k0,
                                           int n0) {
  const int l = threadIdx.x & 31;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(base + ((k0 + (l & 15)) * stride + n0) * 2));
}
// c[0..1] += a·b over the n-tile pair
__device__ __forceinline__ void mma_pair(float (&c)[2][4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_bf16_16816(c[0], a, b[0], b[1]);
  mma_bf16_16816(c[1], a, b[2], b[3]);
}
// c += a·b with a as three terms (tiles a3 at rows r0, columns c0) and b
// exact: three products
__device__ __forceinline__ void mma_3e(float (&c)[2][4], const uint32_t (&a3)[3], int astride,
                                       int r0, int c0, const uint32_t (&b)[4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uint32_t a[4];
    frag_a(a, a3[j], astride, r0, c0);
    mma_pair(c, a, b);
  }
}
// c[o] += the products of order o (2^-8·o) of a·b over one n-tile, both
// as three terms (b from k-major tiles): c[0] hh, c[1] hm + mh, c[2] hl +
// mm + lh. Three accumulators keep the chains of dependent mma short; they
// are added smallest first.
__device__ __forceinline__ void mma_33_1(float (&c)[3][4], const uint32_t (&a3)[3], int astride,
                                         int r0, int c0, const uint32_t (&b3)[3], int bstride,
                                         int k0, int n0) {
  uint32_t a[3][4], b[3][2];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    frag_a(a[j], a3[j], astride, r0, c0);
    frag_b_kn1(b[j], b3[j], bstride, k0, n0);
  }
  mma_bf16_16816(c[0], a[0], b[0][0], b[0][1]);
  mma_bf16_16816(c[1], a[0], b[1][0], b[1][1]);
  mma_bf16_16816(c[1], a[1], b[0][0], b[0][1]);
  mma_bf16_16816(c[2], a[0], b[2][0], b[2][1]);
  mma_bf16_16816(c[2], a[1], b[1][0], b[1][1]);
  mma_bf16_16816(c[2], a[2], b[0][0], b[0][1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A state (R x C fp32) held in registers in the mma accumulator layout:
// warp w < WARPS owns rows [16·(w % RT), +16) and columns [WN·(w / RT),
// +WN), WN = 16·NP, as NP n-tile pairs. Element e of pair p, tile h lies
// at row 16·rt + gid + 8·(e >> 1), column WN·ct + 16·p + 8·h + 2·tig +
// (e & 1).
template <int R, int C, int NW>
struct StateTile {
  static constexpr int WN = (R * C / (16 * NW)) < 16 ? 16 : R * C / (16 * NW);
  static constexpr int NP = WN / 16;
  static constexpr int RT = R / 16;
  static constexpr int WARPS = RT * (C / WN);
  static_assert(WARPS <= NW, "the state fits the block's warps");
  int rt, ct;
  bool owner;
  __device__ __forceinline__ StateTile() {
    const int w = threadIdx.x >> 5;
    rt = w % RT;
    ct = w / RT;
    owner = w < WARPS;
  }
  __device__ __forceinline__ int row(int e) const {
    return 16 * rt + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int p, int h) const {
    return WN * ct + 16 * p + 8 * h + 2 * (threadIdx.x & 3);
  }
};

// The thread's elements of an R x C fp32 state stored at `dst` (row
// stride ld), rows below `rows` only
template <typename ST>
__device__ __forceinline__ void state_store(const float (&s)[ST::NP][2][4], const ST& t,
                                            float* dst, int ld, int rows) {
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int i = t.row(e);
    if (i >= rows) continue;
#pragma unroll
    for (int p = 0; p < ST::NP; ++p) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<float2*>(dst + (size_t)i * ld + t.col(p, hh)) =
            make_float2(s[p][hh][e], s[p][hh][e + 1]);
      }
    }
  }
}

// ... as three bf16 tiles [row][col] (stride ld): the B operand of the
// products against the state
template <typename ST>
__device__ __forceinline__ void state_split(const float (&s)[ST::NP][2][4], const ST& t,
                                            __nv_bfloat16* const (&tiles)[3], int ld) {
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int i = t.row(e);
#pragma unroll
    for (int p = 0; p < ST::NP; ++p) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        split3x2_at(s[p][hh][e], s[p][hh][e + 1], tiles, i * ld + t.col(p, hh));
      }
    }
  }
}

template <typename ST>
__device__ __forceinline__ void state_zero(float (&s)[ST::NP][2][4]) {
#pragma unroll
  for (int p = 0; p < ST::NP; ++p) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[p][hh][e] = 0.f;
    }
  }
}

// n consecutive bf16 (fp32) values of shared memory, 16-byte aligned, as
// fp32 by 16-byte loads
template <int n>
__device__ __forceinline__ void load_bf16x(float (&v)[n], const __nv_bfloat16* p) {
#pragma unroll
  for (int c = 0; c < n; c += 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + c);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      v[c + 2 * e] = f.x;
      v[c + 2 * e + 1] = f.y;
    }
  }
}
template <int n>
__device__ __forceinline__ void load_f32x(float (&v)[n], const float* p) {
#pragma unroll
  for (int c = 0; c < n; c += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + c);
    v[c] = q.x;
    v[c + 1] = q.y;
    v[c + 2] = q.z;
    v[c + 3] = q.w;
  }
}

// the sum of x over G adjacent lanes (G a power of two <= 32); every lane
// of the warp calls it
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Step 2, the recurrence over one round's chunk states, S_{c+1} = dec_c
// ⊙_rows S_c + dS_c, element by element in chunk order, shared out over
// the cluster by elements: block `rank` of the n carries the element pairs
// [rank·per, min(PAIRS, (rank + 1)·per)) of the R x C state (row-major,
// per = ceil(PAIRS / n)), its thread tid the pairs tid + k·THREADS of them
// (k < KMAX; n >= NMIN). Chunk c's slot of the exchange buffer holds dS_c
// (R x C) then its decays (R floats; one for every row when dstride is 0).
// For each pair a thread reads every chunk's (dec, dS) first (L2 only:
// other SMs wrote them), then runs the chain, writing S_c over dS_c.
template <int R, int C, int THREADS, int NMIN>
struct ChunkChain {
  static constexpr int PAIRS = R * C / 2;
  static constexpr int SLOT = R * C + R;  // floats of a chunk's slot
  static constexpr int KMAX = ((PAIRS + NMIN - 1) / NMIN + THREADS - 1) / THREADS;
  float2 s[KMAX];  // the carried pairs: the state at the round's next chunk
  int p0, p1, kn;

  __device__ __forceinline__ ChunkChain(int n, int rank) {
    const int per = (PAIRS + n - 1) / n;
    p0 = rank * per;
    p1 = min(PAIRS, p0 + per);
    kn = (per + THREADS - 1) / THREADS;
  }
  // pair k of this thread: its row and column, or false past the slice
  __device__ __forceinline__ bool at(int k, int& i, int& j) const {
    const int p = p0 + (int)threadIdx.x + k * THREADS;
    i = 2 * p / C;
    j = 2 * p % C;
    return k < kn && p < p1;
  }
  // the pairs from (to) the call's state of `rows` rows (stride C), which
  // also holds a longer call's state between its rounds: rows from `rows`
  // on are 0 and not stored
  __device__ __forceinline__ void load(const float* src, int rows) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      int i, j;
      s[k] = at(k, i, j) && i < rows ? *reinterpret_cast<const float2*>(src + i * C + j)
                                     : make_float2(0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* dst, int rows) const {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      int i, j;
      if (at(k, i, j) && i < rows) *reinterpret_cast<float2*>(dst + i * C + j) = s[k];
    }
  }
  // one round over chunks 0..n_round-1, whose slots start at xch
  __device__ __forceinline__ void run(int n_round, float* xch, int dstride) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      int i, j;
      if (!at(k, i, j)) continue;
      float a[CLUSTER_MAX];
      float2 d[CLUSTER_MAX];
#pragma unroll
      for (int cc = 0; cc < CLUSTER_MAX; ++cc) {
        if (cc < n_round) {
          const float* slot = xch + (size_t)cc * SLOT;
          a[cc] = __ldcg(slot + R * C + i * dstride);
          d[cc] = __ldcg(reinterpret_cast<const float2*>(slot + i * C + j));
        }
      }
#pragma unroll
      for (int cc = 0; cc < CLUSTER_MAX; ++cc) {
        if (cc < n_round) {
          __stcg(reinterpret_cast<float2*>(xch + (size_t)cc * SLOT + i * C + j), s[k]);
          s[k].x = fmaf(a[cc], s[k].x, d[cc].x);
          s[k].y = fmaf(a[cc], s[k].y, d[cc].y);
        }
      }
      asm volatile("" ::: "memory");  // the next pair's loads stay below: registers
    }
  }
};

// the thread's elements of an R x C state (stride ld) in the StateTile
// layout from an exchange slot (L2 only: other SMs wrote it)
template <typename ST>
__device__ __forceinline__ void state_load_cg(float (&s)[ST::NP][2][4], const ST& t,
                                              const float* src, int ld) {
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int i = t.row(e);
#pragma unroll
    for (int p = 0; p < ST::NP; ++p) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 x = __ldcg(reinterpret_cast<const float2*>(src + i * ld + t.col(p, hh)));
        s[p][hh][e] = x.x;
        s[p][hh][e + 1] = x.y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 6 (WKV): the chunked body
// ---------------------------------------------------------------------------
// Per (b, h), with state S (dh x dh, row i = the k index) and the decay
// w_t acting on rows: o_t = r_t·(S_t + u ⊙ k_t ⊗ v_t), S_{t+1} =
// diag(w_t) S_t + k_tᵀ v_t. A chunk of L steps is four (two at dh 128)
// sub-chunks T of 16 steps. With pre_t = Π w over the sub-chunk's steps
// before t and suf_s = Π w over its steps after s (running products of
// each channel):
//  * the sub-chunk's contribution dS_T = (k ⊙ suf)ᵀ v (mma: k ⊙ suf as
//    three terms against the exact v) and its decay Π w;
//  * the chunk's dS = Σ_T (Π_{T' > T} decay_T') dS_T, in registers;
//  * the output of sub-chunk T from the state S_T at its start:
//    o = (r ⊙ pre)·S_T (mma, both as three terms) + D·v, where the 16 x 16
//    block D holds Σ_i r_t,i k_s,i Π_{s<j<t} w_j,i for s < t (a running
//    product per key and channel, fp32 FMAs) and Σ_i r_t,i u_i k_t,i on
//    its diagonal (D as three terms against v); S_{T+1} = decay_T ⊙ S_T +
//    dS_T.
template <int DH>
struct WkvChunkGeom {
  static constexpr int L = DH == 128 ? 32 : 64;  // steps per chunk
  static constexpr int NSUB = L / SCAN_SUB;
  static constexpr int THREADS = 256;
  static constexpr int NW = THREADS / 32;
  static constexpr int RS = DH + 8;          // bf16 stride of [step][channel], [i][j] tiles
  static constexpr int LS = L + 8;           // bf16 stride of the [channel][step] tiles
  static constexpr int WS = DH + 4;          // fp32 stride of the staged decays
  static constexpr int GS = SCAN_SUB + 8;    // bf16 stride of the diagonal blocks
  // lanes per (sub-chunk, key step) in the diagonal blocks (at most one
  // per 8 channels), channels each
  static constexpr int G0 = THREADS / (NSUB * SCAN_SUB);
  static constexpr int G = G0 < DH / 8 ? G0 : DH / 8;
  static constexpr int CPG = DH / G;
  static_assert(G >= 1 && G <= 32 && DH % G == 0 && (G * SCAN_SUB * NSUB) % 32 == 0,
                "the diagonal blocks' lanes");
  static constexpr int NMIN = (SCAN_CHUNK_MIN_S + L - 1) / L;  // fewest chunks a call
  static constexpr int MIN_BLOCKS = DH <= 64 ? 2 : 1;             // blocks an SM
  // byte offsets. One region holds in turn the staged r, k, w (steps
  // 1-3) and the state's three tiles (6).
  static constexpr int R_OFF = 0;
  static constexpr int K_OFF = R_OFF + L * RS * 2;
  static constexpr int W_OFF = K_OFF + L * RS * 2;
  static constexpr int STAGE = W_OFF + L * WS * 4;
  static constexpr int S_OFF = 0;                       // [3][DH][RS]
  static constexpr int S3 = 3 * DH * RS * 2;
  static constexpr int UNION = STAGE > S3 ? STAGE : S3;
  static constexpr int V_OFF = UNION;                   // v [L][RS]
  static constexpr int Q_OFF = V_OFF + L * RS * 2;      // r ⊙ pre, three terms [3][L][RS]
  static constexpr int K3_OFF = Q_OFF + 3 * L * RS * 2;  // k ⊙ suf, three terms [3][DH][LS]
  static constexpr int G_OFF = K3_OFF + 3 * DH * LS * 2;  // diagonal blocks, [3][L][GS]
  static constexpr int DSUB_OFF = G_OFF + 3 * L * GS * 2;   // sub-chunk decays [NSUB][DH]
  static constexpr int U_OFF = DSUB_OFF + NSUB * DH * 4;    // u [DH]
  static constexpr int BYTES = U_OFF + DH * 4;
};

// Grid (n, B·H), clusters of n = min(chunks, CLUSTER_MAX) blocks along x.
template <int DH>
__global__ void __launch_bounds__(WkvChunkGeom<DH>::THREADS, WkvChunkGeom<DH>::MIN_BLOCKS)
    wkv_scan_kernel_chunked(
    const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
    const __nv_bfloat16* __restrict__ u, float* __restrict__ state, float* __restrict__ out,
    float* __restrict__ xch, int S, int H) {
  using Gm = WkvChunkGeom<DH>;
  constexpr int L = Gm::L, NSUB = Gm::NSUB, THREADS = Gm::THREADS, NW = Gm::NW;
  constexpr int RS = Gm::RS, LS = Gm::LS, WS = Gm::WS, GS = Gm::GS;
  extern __shared__ __align__(128) unsigned char smem[];
  using bf = __nv_bfloat16;
  bf* rs = reinterpret_cast<bf*>(smem + Gm::R_OFF);
  bf* ks = reinterpret_cast<bf*>(smem + Gm::K_OFF);
  float* ws = reinterpret_cast<float*>(smem + Gm::W_OFF);
  bf* vs = reinterpret_cast<bf*>(smem + Gm::V_OFF);
  float* dsub = reinterpret_cast<float*>(smem + Gm::DSUB_OFF);
  float* us = reinterpret_cast<float*>(smem + Gm::U_OFF);
  bf* const s3[3] = {reinterpret_cast<bf*>(smem + Gm::S_OFF),
                     reinterpret_cast<bf*>(smem + Gm::S_OFF) + DH * RS,
                     reinterpret_cast<bf*>(smem + Gm::S_OFF) + 2 * DH * RS};
  bf* const q3[3] = {reinterpret_cast<bf*>(smem + Gm::Q_OFF),
                     reinterpret_cast<bf*>(smem + Gm::Q_OFF) + L * RS,
                     reinterpret_cast<bf*>(smem + Gm::Q_OFF) + 2 * L * RS};
  bf* const k3[3] = {reinterpret_cast<bf*>(smem + Gm::K3_OFF),
                     reinterpret_cast<bf*>(smem + Gm::K3_OFF) + DH * LS,
                     reinterpret_cast<bf*>(smem + Gm::K3_OFF) + 2 * DH * LS};
  bf* const g3[3] = {reinterpret_cast<bf*>(smem + Gm::G_OFF),
                     reinterpret_cast<bf*>(smem + Gm::G_OFF) + L * GS,
                     reinterpret_cast<bf*>(smem + Gm::G_OFF) + 2 * L * GS};
  uint32_t s3a[3], q3a[3], k3a[3], g3a[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s3a[j] = smem_addr(s3[j]);
    q3a[j] = smem_addr(q3[j]);
    k3a[j] = smem_addr(k3[j]);
    g3a[j] = smem_addr(g3[j]);
  }

  const int n = gridDim.x, rank = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_chunks = (S + L - 1) / L;
  const int rounds = (n_chunks + n - 1) / n;
  float* st = state + (size_t)bh * DH * DH;

  using Chain = ChunkChain<DH, DH, THREADS, Gm::NMIN>;
  float* xbh = xch + (size_t)bh * n_chunks * Chain::SLOT;  // this (b, h)'s chunk slots
  for (int i = tid; i < DH; i += THREADS) us[i] = __bfloat162float(u[(size_t)h * DH + i]);

  // A state (dS, then S_T) in registers by columns: warp w owns the n-tiles
  // w, w + NW, ... (8 columns each) over all DH rows, in the mma
  // accumulator layout: element (m, rt, e) lies at row 16·rt + gid +
  // 8·(e >> 1), column 8·(w + NW·m) + 2·tig + (e & 1). A warp's outputs
  // read only the state columns it holds, so step 6 needs no block barrier.
  constexpr int NT = DH / 8, RT = DH / 16, NTW = (NT + NW - 1) / NW;
  using Cols = float[NTW][RT][4];
  auto owns = [&](int m) { return warp + NW * m < NT; };
  auto col = [&](int m) { return 8 * (warp + NW * m) + 2 * tig; };
  auto row = [&](int rt, int e) { return 16 * rt + gid + 8 * (e >> 1); };
  // s = decay_T ⊙_rows s, then s += dS_T = (k ⊙ suf)ᵀ v over sub-chunk T's
  // 16 steps, on the tensor cores
  auto step_cols = [&](Cols& sc, int T, bool decay) {
#pragma unroll
    for (int m = 0; m < NTW; ++m) {
      if (!owns(m)) continue;
      uint32_t bv[2];
      frag_b_kn1(bv, smem_addr(vs), RS, SCAN_SUB * T, col(m) - 2 * tig);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        if (decay) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[m][rt][e] *= dsub[T * DH + row(rt, e)];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          uint32_t a[4];
          frag_a(a, k3a[j], LS, 16 * rt, SCAN_SUB * T);
          mma_bf16_16816(sc[m][rt], a, bv[0], bv[1]);
        }
      }
    }
  };

  for (int q = 0; q < rounds; ++q) {
    const int c = q * n + rank;  // this block's chunk
    const bool has = c < n_chunks;
    const int n_round = min(n, n_chunks - q * n);
    const int t0 = c * L;
    const int len = has ? min(L, S - t0) : 0;
    float* slot = xbh + (size_t)c * Chain::SLOT;
    if (has) {
      // 1. the chunk's r, k, v rows (zero past the call) and w (1 past it),
      // by 16-byte asynchronous copies
      constexpr int C8 = DH / 8, C4 = DH / 4;
      for (int x = tid; x < L * C8; x += THREADS) {
        const int t = x / C8, d0 = (x % C8) * 8;
        const bool in = t < len;
        const size_t off = in ? (((size_t)b * S + t0 + t) * H + h) * DH + d0 : 0;
        cp_async16(smem_addr(rs + t * RS + d0), r + off, in ? 16 : 0);
        cp_async16(smem_addr(ks + t * RS + d0), k + off, in ? 16 : 0);
        cp_async16(smem_addr(vs + t * RS + d0), v + off, in ? 16 : 0);
      }
      for (int x = tid; x < L * C4; x += THREADS) {
        const int t = x / C4, d0 = (x % C4) * 4;
        if (t < len) {
          cp_async16(smem_addr(ws + t * WS + d0),
                     w + (((size_t)b * S + t0 + t) * H + h) * DH + d0, 16);
        } else {
          *reinterpret_cast<float4*>(ws + t * WS + d0) = make_float4(1.f, 1.f, 1.f, 1.f);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // 2. per (channel, sub-chunk): r ⊙ pre and k ⊙ suf as three terms,
      // and the sub-chunk's decay
      for (int x = tid; x < DH * NSUB; x += THREADS) {
        const int i = x % DH, T = x / DH;
        float p = 1.f;
#pragma unroll
        for (int j = 0; j < SCAN_SUB; ++j) {
          const int t = T * SCAN_SUB + j;
          split3_at(__bfloat162float(rs[t * RS + i]) * p, q3, t * RS + i);
          p *= ws[t * WS + i];
        }
        dsub[T * DH + i] = p;
        p = 1.f;
#pragma unroll
        for (int j = SCAN_SUB - 1; j >= 0; --j) {
          const int s = T * SCAN_SUB + j;
          split3_at(__bfloat162float(ks[s * RS + i]) * p, k3, i * LS + s);
          p *= ws[s * WS + i];
        }
      }

      // 3. the diagonal blocks: G lanes per (sub-chunk T, key step s), CPG
      // channels each. Per channel a running product k_s ⊙ Π_{s<j<t} w_j
      // walks the sub-chunk's queries t > s, and r_t · it goes to query t's
      // sum; the G lanes then add theirs. Rows of r and w come in 16-byte
      // loads that the lanes of a group share.
      if (tid < Gm::G * SCAN_SUB * NSUB) {  // whole warps
        constexpr int G = Gm::G, CPG = Gm::CPG;
        static_assert(CPG % 8 == 0, "16-byte rows of the diagonal blocks' channels");
        const int g = tid % G, s = (tid / G) % SCAN_SUB, T = tid / (G * SCAN_SUB);
        const int c0 = g * CPG, tb = T * SCAN_SUB, sa = tb + s;
        float pk[CPG], rv[CPG], wv[CPG], acc[SCAN_SUB];
        load_bf16x(pk, ks + sa * RS + c0);
        load_bf16x(rv, rs + sa * RS + c0);
        load_f32x(wv, us + c0);
        float dg = 0.f;
#pragma unroll
        for (int x = 0; x < CPG; ++x) dg = fmaf(rv[x] * wv[x], pk[x], dg);
#pragma unroll
        for (int t = 0; t < SCAN_SUB; ++t) {
          acc[t] = 0.f;
          if (t > s) {
            load_bf16x(rv, rs + (tb + t) * RS + c0);
            load_f32x(wv, ws + (tb + t) * WS + c0);
            float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int x = 0; x < CPG; ++x) {
              a4[x & 3] = fmaf(rv[x], pk[x], a4[x & 3]);
              pk[x] *= wv[x];
            }
            acc[t] = (a4[0] + a4[1]) + (a4[2] + a4[3]);
          }
        }
        dg = group_sum<G>(dg);
#pragma unroll
        for (int t = 0; t < SCAN_SUB; ++t) acc[t] = group_sum<G>(acc[t]);
        if (g == 0) {
#pragma unroll
          for (int t = 0; t < SCAN_SUB; ++t)
            split3_at(t < s ? 0.f : t == s ? dg : acc[t], g3, (tb + t) * GS + s);
        }
      }
      __syncthreads();  // the staged r, k, w are read: dS goes over them

      // 4. the chunk's dS (Horner over its sub-chunks: decay, then the
      // products accumulate onto it) and decays, into its slot
      {
        Cols acc;
#pragma unroll
        for (int m = 0; m < NTW; ++m)
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][rt][e] = 0.f;
        for (int T = 0; T < NSUB; ++T) step_cols(acc, T, T > 0);
#pragma unroll
        for (int m = 0; m < NTW; ++m) {
          if (!owns(m)) continue;
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int e = 0; e < 4; e += 2)
              *reinterpret_cast<float2*>(slot + row(rt, e) * DH + col(m)) =
                  make_float2(acc[m][rt][e], acc[m][rt][e + 1]);
        }
      }
      for (int i = tid; i < DH; i += THREADS) {
        float p = dsub[i];
        for (int T = 1; T < NSUB; ++T) p *= dsub[T * DH + i];
        slot[DH * DH + i] = p;
      }
    }
    __threadfence();
    cluster_arrive();
    cluster_wait();  // every chunk's (decays, dS) of this round is in its slot

    // 5. the states at the chunk starts (ChunkChain), the round's last (the
    // final state after the last round) in place
    {
      Chain chain(n, rank);
      chain.load(st, DH);
      chain.run(n_round, xbh + (size_t)q * n * Chain::SLOT, 1);
      chain.store(st, DH);
    }
    __threadfence();
    cluster_arrive();
    cluster_wait();  // every chunk's state is in its slot

    // 6. the outputs, sub-chunk by sub-chunk, each warp for its columns
    if (has) {
      Cols sc;  // the state at the start of sub-chunk T, from the slot
#pragma unroll
      for (int m = 0; m < NTW; ++m) {
        if (!owns(m)) continue;
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float2 x =
                __ldcg(reinterpret_cast<const float2*>(slot + row(rt, e) * DH + col(m)));
            sc[m][rt][e] = x.x;
            sc[m][rt][e + 1] = x.y;
          }
      }
      for (int T = 0; T < NSUB; ++T) {
#pragma unroll
        for (int m = 0; m < NTW; ++m) {  // S_T's three terms, this warp's columns
          if (!owns(m)) continue;
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int e = 0; e < 4; e += 2)
              split3x2_at(sc[m][rt][e], sc[m][rt][e + 1], s3, row(rt, e) * RS + col(m));
        }
        __syncwarp();
#pragma unroll
        for (int m = 0; m < NTW; ++m) {
          if (!owns(m)) continue;
          const int j0 = col(m) - 2 * tig;
          float c3[3][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) c3[0][e] = c3[1][e] = c3[2][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < RT; ++kk)
            mma_33_1(c3, q3a, RS, SCAN_SUB * T, 16 * kk, s3a, RS, 16 * kk, j0);
          uint32_t bv[2];
          frag_b_kn1(bv, smem_addr(vs), RS, SCAN_SUB * T, j0);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            uint32_t a[4];
            frag_a(a, g3a[j], GS, SCAN_SUB * T, 0);
            mma_bf16_16816(c3[j], a, bv[0], bv[1]);
          }
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int t = SCAN_SUB * T + gid + 8 * e2;
            if (t < len) {
              *reinterpret_cast<float2*>(out + (((size_t)b * S + t0 + t) * H + h) * DH + j0 +
                                         2 * tig) =
                  make_float2((c3[2][2 * e2] + c3[1][2 * e2]) + c3[0][2 * e2],
                              (c3[2][2 * e2 + 1] + c3[1][2 * e2 + 1]) + c3[0][2 * e2 + 1]);
            }
          }
        }
        // S_{T+1} = decay_T ⊙ S_T + dS_T
        if (T + 1 < NSUB) step_cols(sc, T, true);
        __syncwarp();  // this warp's columns of the tiles are read
      }
      __syncthreads();  // every warp is done with the chunk's tiles
    }
  }
}

template <int DH>
int launch_wkv_chunked(const __nv_bfloat16* r, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const float* w, const __nv_bfloat16* u, float* state, float* out,
                       float* xch, int B, int S, int H, cudaStream_t stream) {
  using Gm = WkvChunkGeom<DH>;
  static ClusterLaunch st;
  const int n_chunks = (S + Gm::L - 1) / Gm::L;
  const int n = n_chunks < CLUSTER_MAX ? n_chunks : CLUSTER_MAX;
  return launch_clustered(st, wkv_scan_kernel_chunked<DH>, Gm::THREADS, Gm::BYTES,
                          dim3(n, B * H), n, stream, r, k, v, w, u, state, out, xch, S, H);
}

// ---------------------------------------------------------------------------
// Kernel 7 (selective scan): the chunked body
// ---------------------------------------------------------------------------
// Per (b, h), with state h (N x dh) and one decay a_t = exp(A_h·dt_t) per
// step: h_t = a_t h_{t-1} + (dt_t B_t)ᵀ x_t, y_t = C_t·h_t. Over a chunk of
// L = 64 steps from the state h_c at its start, with F(s, t) = Π_{s<j<=t}
// a_j (formed from running products over the chunk's four 16-step blocks,
// never as a ratio):
//  * y_t = F(-1, t)·(C_t·h_c) + Σ_{s<=t} [(C_t·B_s) F(s, t) dt_s] x_s:
//    C·h_c on the tensor cores (h_c as three terms against the exact C),
//    scaled per row in fp32; C·Bᵀ (exact operands, one product) times F
//    and dt gives the L x L matrix M, which meets the exact x as three
//    terms;
//  * the chunk's contribution dh = Σ_s (F(s, L-1) dt_s B_s)ᵀ x_s (the
//    weighted B as three terms) and its decay F(-1, L-1).
// C·Bᵀ is computed by each head's blocks: it is 32 mma per chunk at N 16,
// and sharing it across the heads of a batch row would cut the grid by
// the head count.
template <int DH, int NP>
struct SsmChunkGeom {
  static constexpr int L = 64;
  static constexpr int NB = L / SCAN_SUB;  // 16-step blocks of the decay products
  static constexpr int THREADS = 256;
  static constexpr int NW = THREADS / 32;
  static constexpr int XS = DH + 8;   // bf16 stride of x [L][XS] and the state's tiles [NP][XS]
  static constexpr int NS = NP + 8;   // bf16 stride of B, C [L][NS]
  static constexpr int LS = L + 8;    // bf16 stride of [n][s] and [t][s] tiles
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X_OFF + L * XS * 2;
  static constexpr int C_OFF = B_OFF + L * NS * 2;
  static constexpr int BW_OFF = C_OFF + L * NS * 2;     // weighted B, [3][NP][LS]
  static constexpr int M_OFF = BW_OFF + 3 * NP * LS * 2;  // M, [3][L][LS]
  static constexpr int H_OFF = M_OFF + 3 * L * LS * 2;    // state, [3][NP][XS]
  static constexpr int NMIN = (SCAN_CHUNK_MIN_S + L - 1) / L;  // fewest chunks a call
  static constexpr int MIN_BLOCKS = NP * DH <= 1024 ? 2 : 1;    // blocks an SM
  // fp32 scalars: dt, a, pre (F(-1, t)), suf (F(s, L-1)), preb (from the
  // step's block start, inclusive), sufb (to its block end, exclusive),
  // blk (a block's product), mid (the blocks strictly between two), the
  // chunk's decay, F within each block
  static constexpr int F_OFF = H_OFF + 3 * NP * XS * 2;
  static constexpr int FLOATS = 6 * L + NB + NB * NB + 4 + L * SCAN_SUB;
  static_assert(2 * L <= THREADS, "step 2's threads");
  static constexpr int BYTES = F_OFF + FLOATS * 4;
};

// Grid (n, B·H), clusters of n = min(chunks, CLUSTER_MAX) blocks along x.
template <int DH, int NP>
__global__ void __launch_bounds__(SsmChunkGeom<DH, NP>::THREADS, SsmChunkGeom<DH, NP>::MIN_BLOCKS)
    ssm_scan_kernel_chunked(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    const float* __restrict__ A, float* __restrict__ state, float* __restrict__ y,
    float* __restrict__ xch, int S, int H, int N) {
  using Gm = SsmChunkGeom<DH, NP>;
  using ST = StateTile<NP, DH, Gm::NW>;
  constexpr int L = Gm::L, NB = Gm::NB, THREADS = Gm::THREADS, SP = ST::NP;
  constexpr int XS = Gm::XS, NS = Gm::NS, LS = Gm::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  using bf = __nv_bfloat16;
  bf* xs = reinterpret_cast<bf*>(smem + Gm::X_OFF);
  bf* bs = reinterpret_cast<bf*>(smem + Gm::B_OFF);
  bf* cs = reinterpret_cast<bf*>(smem + Gm::C_OFF);
  bf* const bw3[3] = {reinterpret_cast<bf*>(smem + Gm::BW_OFF),
                      reinterpret_cast<bf*>(smem + Gm::BW_OFF) + NP * LS,
                      reinterpret_cast<bf*>(smem + Gm::BW_OFF) + 2 * NP * LS};
  bf* const m3[3] = {reinterpret_cast<bf*>(smem + Gm::M_OFF),
                     reinterpret_cast<bf*>(smem + Gm::M_OFF) + L * LS,
                     reinterpret_cast<bf*>(smem + Gm::M_OFF) + 2 * L * LS};
  bf* const h3[3] = {reinterpret_cast<bf*>(smem + Gm::H_OFF),
                     reinterpret_cast<bf*>(smem + Gm::H_OFF) + NP * XS,
                     reinterpret_cast<bf*>(smem + Gm::H_OFF) + 2 * NP * XS};
  uint32_t bw3a[3], m3a[3], h3a[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    bw3a[j] = smem_addr(bw3[j]);
    m3a[j] = smem_addr(m3[j]);
    h3a[j] = smem_addr(h3[j]);
  }
  float* dts = reinterpret_cast<float*>(smem + Gm::F_OFF);
  float* as = dts + L;
  float* pre = as + L;
  float* suf = pre + L;
  float* preb = suf + L;
  float* sufb = preb + L;
  float* blk = sufb + L;
  float* mid = blk + NB;
  float* dch = mid + NB * NB;
  float* fin = dch + 4;  // [L][SCAN_SUB]: F(s, t) for t in s's block

  const int n = gridDim.x, rank = blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, hd = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_chunks = (S + L - 1) / L;
  const int rounds = (n_chunks + n - 1) / n;
  const ST tile;
  const float a_h = A[hd];
  float* st = state + (size_t)bh * N * DH;

  using Chain = ChunkChain<NP, DH, THREADS, Gm::NMIN>;
  float* xbh = xch + (size_t)bh * n_chunks * Chain::SLOT;  // this (b, h)'s chunk slots
  float smine[SP][2][4];

  for (int q = 0; q < rounds; ++q) {
    const int c = q * n + rank;
    const bool has = c < n_chunks;
    const int n_round = min(n, n_chunks - q * n);
    const int t0 = c * L;
    const int len = has ? min(L, S - t0) : 0;
    float* slot = xbh + (size_t)c * Chain::SLOT;
    if (has) {
      // 1. x rows by 16-byte asynchronous copies (zero past the call); B, C
      // (zero past N and past the call), dt (0 past the call) and the decay
      // a = exp(A·dt) (1 past it)
      constexpr int C8 = DH / 8;
      for (int i = tid; i < L * C8; i += THREADS) {
        const int t = i / C8, d0 = (i % C8) * 8;
        const bool in = t < len;
        const size_t off = in ? (((size_t)b * S + t0 + t) * H + hd) * DH + d0 : 0;
        cp_async16(smem_addr(xs + t * XS + d0), x + off, in ? 16 : 0);
      }
      cp_async_commit();
      for (int i = tid; i < L * NP; i += THREADS) {
        const int t = i / NP, nn = i % NP;
        const bool in = t < len && nn < N;
        const size_t off = ((size_t)b * S + t0 + t) * N + nn;
        bs[t * NS + nn] = in ? bm[off] : __float2bfloat16(0.f);
        cs[t * NS + nn] = in ? cm[off] : __float2bfloat16(0.f);
      }
      for (int t = tid; t < L; t += THREADS) {
        const float dv = t < len ? dt[((size_t)b * S + t0 + t) * H + hd] : 0.f;
        dts[t] = dv;
        as[t] = t < len ? expf(a_h * dv) : 1.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // 2. the decay products: within each 16-step block (one thread a
      // block), then across the blocks
      if (tid < NB) {
        float p = 1.f;
        for (int j = 0; j < SCAN_SUB; ++j) {
          p *= as[tid * SCAN_SUB + j];
          preb[tid * SCAN_SUB + j] = p;
        }
        blk[tid] = p;
        p = 1.f;
        for (int j = SCAN_SUB - 1; j >= 0; --j) {
          sufb[tid * SCAN_SUB + j] = p;
          p *= as[tid * SCAN_SUB + j];
        }
      }
      __syncthreads();
      if (tid == 0) {
        for (int qs = 0; qs < NB; ++qs) {
          float p = 1.f;
          for (int qt = qs + 1; qt < NB; ++qt) {
            mid[qs * NB + qt] = p;
            p *= blk[qt];
          }
        }
        float p = 1.f;
        for (int qq = 0; qq < NB; ++qq) p *= blk[qq];
        *dch = p;
      }
      if (tid >= THREADS - L) {  // F(s, t) within s's block: a running product
        const int sx = tid - (THREADS - L), q0 = sx / SCAN_SUB * SCAN_SUB;
        float f = 1.f;
        fin[sx * SCAN_SUB + sx - q0] = f;
        for (int t = sx + 1; t < q0 + SCAN_SUB; ++t) {
          f *= as[t];
          fin[sx * SCAN_SUB + t - q0] = f;
        }
      }
      if (tid < L) {
        const int qb = tid / SCAN_SUB;
        float p = preb[tid], s2 = sufb[tid];
        for (int qq = qb - 1; qq >= 0; --qq) p *= blk[qq];
        for (int qq = qb + 1; qq < NB; ++qq) s2 *= blk[qq];
        pre[tid] = p;
        suf[tid] = s2;
      }
      __syncthreads();

      // 3. the weighted B (dt_s B_s F(s, L-1), [n][s]) and M = C·Bᵀ ⊙ F ⊙ dt
      // ([t][s], zero above the diagonal), as three terms each
      for (int i = tid; i < L * NP; i += THREADS) {
        const int nn = i / L, s = i % L;
        split3_at(__bfloat162float(bs[s * NS + nn]) * dts[s] * suf[s], bw3, nn * LS + s);
      }
      for (int task = warp; task < (L / 16) * (L / 16); task += Gm::NW) {
        const int rt = task / (L / 16), np = task % (L / 16);
        float cb[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[0][e] = cb[1][e] = 0.f;
        if (np <= rt) {
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk) {
            uint32_t ca[4], bb[4];
            frag_a(ca, smem_addr(cs), NS, 16 * rt, 16 * kk);
            frag_b_nk(bb, smem_addr(bs), NS, 16 * kk, 16 * np);
            mma_pair(cb, ca, bb);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * rt + gid + 8 * (e >> 1);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int s = 16 * np + 8 * h2 + 2 * tig + (e & 1);
            float m = 0.f;
            if (s <= t) {
              float f;
              const int qs = s / SCAN_SUB, qt = t / SCAN_SUB;
              if (qs == qt) {
                f = fin[s * SCAN_SUB + t - qt * SCAN_SUB];
              } else {
                f = sufb[s] * mid[qs * NB + qt] * preb[t];
              }
              m = cb[h2][e] * f * dts[s];
            }
            split3_at(m, m3, t * LS + s);
          }
        }
      }
      __syncthreads();

      // 4. the chunk's contribution dS = (weighted B)ᵀ x, on the tensor cores
      if (tile.owner) {
        float d[SP][2][4];
        state_zero<ST>(d);
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
#pragma unroll
          for (int p = 0; p < SP; ++p) {
            uint32_t bx[4];
            frag_b_kn(bx, smem_addr(xs), XS, 16 * kk, ST::WN * tile.ct + 16 * p);
            mma_3e(d[p], bw3a, LS, 16 * tile.rt, 16 * kk, bx);
          }
        }
        state_store(d, tile, slot, DH, NP);
      }
      if (tid == 0) slot[NP * DH] = *dch;
    }
    __threadfence();
    cluster_arrive();
    cluster_wait();  // every chunk's (decay, dS) of this round is in its slot

    // 5. the states at the chunk starts, as in the WKV body (one decay a
    // chunk, for every row)
    {
      Chain chain(n, rank);
      chain.load(st, N);
      chain.run(n_round, xbh + (size_t)q * n * Chain::SLOT, 0);
      chain.store(st, N);
    }
    __threadfence();
    cluster_arrive();
    cluster_wait();  // every chunk's state is in its slot

    // 6. the outputs: y = pre ⊙ (C·h_c) + M·x, 16 rows x 16 columns a task
    if (has) {
      if (tile.owner) {
        state_load_cg(smine, tile, slot, DH);
        state_split(smine, tile, h3, XS);
      }
      __syncthreads();
      for (int task = warp; task < (L / 16) * (DH / 16); task += Gm::NW) {
        const int rt = task / (DH / 16), j0 = 16 * (task % (DH / 16));
        float o[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[0][e] = o[1][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          uint32_t ca[4];
          frag_a(ca, smem_addr(cs), NS, 16 * rt, 16 * kk);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            uint32_t bh3[4];
            frag_b_kn(bh3, h3a[j], XS, 16 * kk, j0);
            mma_pair(o, ca, bh3);
          }
        }
        const float p0 = pre[16 * rt + gid], p1 = pre[16 * rt + gid + 8];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          o[h2][0] *= p0;
          o[h2][1] *= p0;
          o[h2][2] *= p1;
          o[h2][3] *= p1;
        }
        float o2[2][4];  // odd k-steps: a second chain of dependent mma
#pragma unroll
        for (int e = 0; e < 4; ++e) o2[0][e] = o2[1][e] = 0.f;
        for (int kk = 0; kk <= rt; ++kk) {
          uint32_t bx[4];
          frag_b_kn(bx, smem_addr(xs), XS, 16 * kk, j0);
          if (kk & 1) {
            mma_3e(o2, m3a, LS, 16 * rt, 16 * kk, bx);
          } else {
            mma_3e(o, m3a, LS, 16 * rt, 16 * kk, bx);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[0][e] += o2[0][e];
          o[1][e] += o2[1][e];
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int t = 16 * rt + gid + 8 * e2;
          if (t >= len) continue;
          float* dst = y + (((size_t)b * S + t0 + t) * H + hd) * DH + j0 + 2 * tig;
          *reinterpret_cast<float2*>(dst) = make_float2(o[0][2 * e2], o[0][2 * e2 + 1]);
          *reinterpret_cast<float2*>(dst + 8) = make_float2(o[1][2 * e2], o[1][2 * e2 + 1]);
        }
      }
      __syncthreads();  // x, M and the state's tiles are read
    }
  }
}

template <int DH, int NP>
int launch_ssm_chunked(const __nv_bfloat16* x, const float* dt, const __nv_bfloat16* bm,
                       const __nv_bfloat16* cm, const float* A, float* state, float* y,
                       float* xch, int B, int S, int H, int N, cudaStream_t stream) {
  using Gm = SsmChunkGeom<DH, NP>;
  static ClusterLaunch st;
  const int n_chunks = (S + Gm::L - 1) / Gm::L;
  const int n = n_chunks < CLUSTER_MAX ? n_chunks : CLUSTER_MAX;
  return launch_clustered(st, ssm_scan_kernel_chunked<DH, NP>, Gm::THREADS, Gm::BYTES,
                          dim3(n, B * H), n, stream, x, dt, bm, cm, A, state, y, xch, S, H,
                          N);
}

}  // namespace
}  // namespace repro
