// Blocked causal / bidirectional GQA flash attention for prefill,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, its pallas_call at :104; wrapper ops.py:41).
//
// Bound on the H100 at the main path's shape (B 4, S 512, H 64, KV 8,
// dh 128, causal): bytes, barely. Q, K, V and the output are 75.5 MB
// (22.5 us at 3.35 TB/s); QK^T and PV over the 131,328 visible (i, j)
// pairs of each head are 17.2 GFLOP (17.4 us at the bf16 tensor-core peak
// of 989 TFLOP/s). The two are close: the kernel has to stream its inputs
// once and keep the tensor cores busy at the same time.
//
// Which body runs:
//  * bf16 with 16-byte aligned rows (dh % 8 == 0, aligned bases) and
//    dh <= 128 (LLaMA's 128 with G 8, Hymba's 64 with G 5 and window
//    1024): the Hopper mainloop of attention_sm90.cuh. Its query rows are
//    the G heads of a KV group packed as i·G + g, so one K/V tile serves
//    all G heads; the mask is the multi-query rule with qbase = q_offset,
//    id(j) = j for j < Skv, and causal as given. Design there: a producer
//    warp feeding K/V by TMA into a 3-stage ring, two consumer warpgroups
//    on wgmma, V read slot-major through wgmma's transpose bit.
//  * other bf16 shapes (dh 129-256, unaligned rows): the mma.sync kernel
//    below. A block of 4 warps owns 64 query rows of one head, 16 rows per
//    warp, and loops over 64-key tiles; the score tile and (m, l, acc)
//    stay in registers, the QK^T accumulator layout is PV's A operand with
//    P rounded to bf16; Q, K and V^T tiles sit in padded shared memory.
//  * fp32 inputs: a simple SIMT kernel (one warp per query row, fp32
//    throughout), exact, not on the main path.
// Mask in every body: j < Skv, causal j <= i with i = q_offset + row, and
// i - j < window, as in the TPU kernel. Masked scores get probability 0,
// so a fully-masked row outputs 0 (l == 0 -> 1).

#include "attention_sm90.cuh"
#include "common.cuh"

namespace repro {
namespace {

constexpr int FA_BM = 64;
constexpr int FA_BN = 64;
constexpr int FA_THREADS = 128;

template <int DHP>
__global__ void __launch_bounds__(FA_THREADS) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq, int Skv,
    int H, int KV, int dh, int causal, int window, int q_offset, float scale, int vec) {
  constexpr int QS = DHP + 8;   // Q / K shared row stride (elements)
  constexpr int VS = FA_BN + 8; // V^T shared row stride
  constexpr int DC = DHP / 8;   // 8-element chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + FA_BM * QS;
  __nv_bfloat16* Vt = Ks + FA_BN * QS;

  const int m0 = blockIdx.x * FA_BM, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, kvh = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t q_stride = (size_t)H * dh, kv_stride = (size_t)KV * dh;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * dh;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * KV + kvh) * dh;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * KV + kvh) * dh;
  const bool vec_ok = vec != 0;

  for (int c = threadIdx.x; c < FA_BM * DC; c += FA_THREADS) {
    const int r = c / DC, d0 = (c % DC) * 8;
    __nv_bfloat16 t[8];
    load8(t, qb, q_stride, m0 + r, Sq, d0, dh, vec_ok);
    *reinterpret_cast<uint4*>(Qs + r * QS + d0) = *reinterpret_cast<uint4*>(t);
  }

  // rows this thread holds in the accumulator layout: r0 and r0 + 8
  const int wr = warp * 16 + gid;
  const int i0 = q_offset + m0 + wr, i1 = i0 + 8;
  float o[DHP / 8][4];
#pragma unroll
  for (int t = 0; t < DHP / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF};
  float lrow[2] = {0.f, 0.f};  // this lane's partial row sums

  // kv tiles that can hold a visible key for some row of the block
  const int i_lo = q_offset + m0;
  const int i_hi = q_offset + min(m0 + FA_BM, Sq) - 1;
  const int j_end = causal ? min(Skv, i_hi + 1) : Skv;
  const long long jl = (long long)i_lo - (long long)window + 1;
  const int j_start = jl > 0 ? (int)((jl / FA_BN) * FA_BN) : 0;

  for (int j0 = j_start; j0 < j_end; j0 += FA_BN) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int c = threadIdx.x; c < FA_BN * DC; c += FA_THREADS) {
      const int r = c / DC, d0 = (c % DC) * 8;
      __nv_bfloat16 t[8];
      load8(t, kb, kv_stride, j0 + r, Skv, d0, dh, vec_ok);
      *reinterpret_cast<uint4*>(Ks + r * QS + d0) = *reinterpret_cast<uint4*>(t);
      load8(t, vb, kv_stride, j0 + r, Skv, d0, dh, vec_ok);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(d0 + e) * VS + r] = t[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[FA_BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + wr * QS + kk * 16 + tig * 2;
      uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * QS), ld_u32(qa + 8), ld_u32(qa + 8 * QS + 8)};
#pragma unroll
      for (int nt = 0; nt < FA_BN / 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + gid) * QS + kk * 16 + tig * 2;
        mma_bf16_16816(s[nt], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // scale + mask, then the online-softmax update
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nt = 0; nt < FA_BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e < 2) ? i0 : i1;
        const int j = j0 + nt * 8 + tig * 2 + (e & 1);
        const bool valid = j < Skv && (!causal || j <= i) && (i - j < window);
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
    for (int nt = 0; nt < FA_BN / 8; ++nt) {
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

    // O += P V: the score accumulators of two adjacent key octets form one
    // 16-wide A fragment
#pragma unroll
    for (int kk = 0; kk < FA_BN / 16; ++kk) {
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
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int row = m0 + wr + 8 * rr;
    if (row >= Sq) continue;
    __nv_bfloat16* op = out + ((size_t)b * Sq + row) * q_stride + (size_t)h * dh;
#pragma unroll
    for (int t = 0; t < DHP / 8; ++t) {
      const int col = t * 8 + tig * 2;
      if (col < dh) op[col] = __float2bfloat16(o[t][2 * rr] * inv);
      if (col + 1 < dh) op[col + 1] = __float2bfloat16(o[t][2 * rr + 1] * inv);
    }
  }
}

// fp32 path: one warp per query row, fp32 throughout; a lane holds the
// columns d = lane + 32·i. Grid (ceil(Sq / 4), H, B).
__global__ void __launch_bounds__(FA_THREADS) flash_simt_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int Sq, int Skv, int H, int KV, int dh, int causal, int window,
    int q_offset, float scale) {
  constexpr int NV = 8;  // dh <= 256
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (FA_THREADS / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= Sq) return;
  const int G = H / KV, kvh = h / G;
  const size_t kv_stride = (size_t)KV * dh;
  const float* qr = q + (((size_t)b * Sq + row) * H + h) * dh;
  const float* kb = k + ((size_t)b * Skv * KV + kvh) * dh;
  const float* vb = v + ((size_t)b * Skv * KV + kvh) * dh;
  float qv[NV], acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int d = lane + 32 * t;
    qv[t] = d < dh ? qr[d] : 0.f;
    acc[t] = 0.f;
  }
  const int i = q_offset + row;
  const int j_end = causal ? min(Skv, i + 1) : Skv;
  const long long jl = (long long)i - (long long)window + 1;
  const int j_start = jl > 0 ? (int)jl : 0;
  float m = NEG_INF, l = 0.f;
  for (int j = j_start; j < j_end; ++j) {
    const float* kr = kb + (size_t)j * kv_stride;
    float part = 0.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int d = lane + 32 * t;
      part += d < dh ? qv[t] * kr[d] : 0.f;
    }
    const float s = warp_sum(part) * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    const float* vr = vb + (size_t)j * kv_stride;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int d = lane + 32 * t;
      acc[t] = acc[t] * corr + (d < dh ? p * vr[d] : 0.f);
    }
    m = m_new;
  }
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  float* orow = out + (((size_t)b * Sq + row) * H + h) * dh;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int d = lane + 32 * t;
    if (d < dh) orow[d] = acc[t] * inv;
  }
}

// Flash's slots for the Hopper mainloop: key j of sequence b is row
// (b, j) of the (B, Skv, KV, dh) K/V with position id j.
struct FlashAddr {
  int q_offset;
  long long map_rows, map_outer;  // Skv, B
  int box_rows;                   // 64: a tile is one box
  __device__ __forceinline__ int qbase(int, int) const { return q_offset; }
  __device__ __forceinline__ int slot(int, int, int t, long long&) const { return t; }
  __device__ __forceinline__ bool box(int b, int t0, int& row, int& outer) const {
    row = t0;
    outer = b;
    return true;
  }
};

template <int DHP>
int launch_flash_mma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                     int Skv, int H, int KV, int dh, int causal, int window, int q_offset,
                     float scale, int vec, cudaStream_t stream) {
  constexpr int smem =
      ((FA_BM + FA_BN) * (DHP + 8) + DHP * (FA_BN + 8)) * (int)sizeof(__nv_bfloat16);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_mma_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + FA_BM - 1) / FA_BM, H, B);
  flash_mma_kernel<DHP><<<grid, FA_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, Sq, Skv, H, KV, dh, causal, window, q_offset, scale, vec);
  return 0;
}

}  // namespace
}  // namespace repro

// q (B, Sq, H, dh); k, v (B, Skv, KV, dh); out (B, Sq, H, dh); dh <= 256.
// vec != 0 promises dh % 8 == 0 and 16-byte aligned bases (bf16 path).
// Returns cudaGetLastError() after the launch (or a refusal code).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Sq, int Skv, int H, int KV, int dh, int causal,
                                     int window, int q_offset, float scale, int vec, int dtype,
                                     void* stream) {
  using namespace repro;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (dtype == DTYPE_BF16 && KV > 0 && H % KV == 0 && sm90::takes(dh, vec, H / KV)) {
    const FlashAddr addr{q_offset, Skv, B, 64};
    rc = sm90::dispatch(q, k, v, addr, out, B, Sq, Skv, addr.map_rows, addr.map_outer, KV, H / KV,
                        dh, window, causal, scale, st);
  } else if (dtype == DTYPE_BF16) {
    if (dh <= 64) {
      rc = launch_flash_mma<64>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                                scale, vec, st);
    } else if (dh <= 128) {
      rc = launch_flash_mma<128>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                                 scale, vec, st);
    } else if (dh <= 256) {
      rc = launch_flash_mma<256>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                                 scale, vec, st);
    } else {
      rc = (int)cudaErrorInvalidValue;
    }
  } else if (dtype == DTYPE_F32 && dh <= 256) {
    dim3 grid((Sq + FA_THREADS / 32 - 1) / (FA_THREADS / 32), H, B);
    flash_simt_f32_kernel<<<grid, FA_THREADS, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Skv, H, KV, dh,
        causal, window, q_offset, scale);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
