// RWKV6 (Finch) WKV recurrence, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// (wkv_kernel, its pallas_call at :80; wrapper ops.py:24). Per (b, h) and
// time step t, with a dh x dh fp32 state S:
//
//   a = k_tᵀ v_t;   o_t = r_t · (S + u ⊙ a);   S ← diag(w_t) S + a
//
// (the decay w_t scales row i of S: it applies on the k index).
//
// Two bodies, one launch a call (wkv_takes_chunked, below; ops.py's
// takes_chunked):
//
// The chunked body (bf16 calls of S >= 128: every prefill), in
// scan_chunked.cuh: chunks of 64 steps (32 at dh 128) are the blocks of a
// thread block cluster per (b, h), 16-step sub-chunks inside, the products
// on the tensor cores (mma.sync) with three-term bf16 operands. Bound on
// the H100: bytes. At RWKV6-3B's prefill shape (B 4, S 512, H 40, dh 64;
// r/k/v bf16, w and o fp32) a call moves ~79 MB (~23.5 us at 3.35 TB/s);
// its matrix products are ~2 GFLOP (~2 us at the bf16 tensor-core peak),
// where the sequential body's ~1.7 GFLOP of fp32 FMAs would take ~25 us at
// the SIMT peak and, in order, far longer. What holds it above the bytes
// is the latency of each block's phases (tools/ablate_scan.py: its
// outputs' fragment loads from shared memory, the staging wait, the
// cluster barriers; PERF.md); what the design does about the scan's
// sequential axis is to run every chunk in parallel (1280 blocks at B 4,
// 320 at B 1) and leave only the chunk-state recurrence, element by
// element, in order.
//
// The sequential body (decode steps, short calls, fp32 inputs): column j
// of S evolves alone, o_j = Σ_i r_i (S_ij + u_i k_i v_j) and S_ij ← w_i
// S_ij + k_i v_j. One block per (b, h), one thread per column j holding its
// dh fp32 column of S in registers for the whole call (the TPU kernel kept
// S in VMEM across its sequential grid axis; a loop inside the block takes
// that axis's place). r, k, v and w of TC steps are staged in shared
// memory with coalesced loads, eight rows in flight; within a step every
// thread reads the same r_i, k_i, w_i, u_i (broadcasts). o_j's dot product
// runs in four partial sums. Its arithmetic is the reference's but for fp32
// summation order. At S 1 it is bound by the state's bytes (2.6 MB read
// and written at B 4) and the launch: ~4.3 us in a serve.
//
// Both read the model layout (B, S, H, dh) and write o in place (no
// transpose, no padding), and read the initial state from and write the
// final one to the same buffer (the decode cache's layer state, in place).

#include "scan_chunked.cuh"

namespace repro {
namespace {

template <int DH>
struct WkvGeom {
  static constexpr int TC = 2048 / DH;  // time steps per staged chunk (16-64)
};

template <typename T, int DH>
__global__ void __launch_bounds__(DH) wkv_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const T* __restrict__ u, float* __restrict__ state,
    float* __restrict__ out, int S, int H) {
  constexpr int TC = WkvGeom<DH>::TC;
  __shared__ float rs[TC][DH], ks[TC][DH], vs[TC][DH], ws[TC][DH];
  __shared__ float us[DH];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  float* st = state + (size_t)bh * DH * DH;

  float s[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) s[i] = st[(size_t)i * DH + j];
  us[j] = to_f(u[(size_t)h * DH + j]);

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = (((size_t)b * S + t0 + tt) * H + h) * DH + j;
      rs[tt][j] = to_f(r[off]);
      ks[tt][j] = to_f(k[off]);
      vs[tt][j] = to_f(v[off]);
      ws[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int i = 0; i < DH; i += 4) {
        const float a0 = ks[tt][i] * vj, a1 = ks[tt][i + 1] * vj;
        const float a2 = ks[tt][i + 2] * vj, a3 = ks[tt][i + 3] * vj;
        o0 += rs[tt][i] * (s[i] + us[i] * a0);
        o1 += rs[tt][i + 1] * (s[i + 1] + us[i + 1] * a1);
        o2 += rs[tt][i + 2] * (s[i + 2] + us[i + 2] * a2);
        o3 += rs[tt][i + 3] * (s[i + 3] + us[i + 3] * a3);
        s[i] = ws[tt][i] * s[i] + a0;
        s[i + 1] = ws[tt][i + 1] * s[i + 1] + a1;
        s[i + 2] = ws[tt][i + 2] * s[i + 2] + a2;
        s[i + 3] = ws[tt][i + 3] * s[i + 3] + a3;
      }
      out[(((size_t)b * S + t0 + tt) * H + h) * DH + j] = (o0 + o1) + (o2 + o3);
    }
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) st[(size_t)i * DH + j] = s[i];
}

template <typename T>
int launch_wkv(const void* r, const void* k, const void* v, const float* w, const void* u,
               float* state, float* out, int B, int S, int H, int dh, cudaStream_t st) {
  const dim3 grid(B * H);
  const T *rp = (const T*)r, *kp = (const T*)k, *vp = (const T*)v, *up = (const T*)u;
  switch (dh) {
    case 32:
      wkv_scan_kernel<T, 32><<<grid, 32, 0, st>>>(rp, kp, vp, w, up, state, out, S, H);
      break;
    case 64:
      wkv_scan_kernel<T, 64><<<grid, 64, 0, st>>>(rp, kp, vp, w, up, state, out, S, H);
      break;
    case 128:
      wkv_scan_kernel<T, 128><<<grid, 128, 0, st>>>(rp, kp, vp, w, up, state, out, S, H);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Which body a call takes (ops.py's takes_chunked): bf16 calls of at least
// two full chunks run the chunked body (scan_chunked.cuh), everything else
// (decode steps, short calls, fp32 inputs) the sequential one above.
inline bool wkv_takes_chunked(int S, int dtype, int dh) {
  return dtype == DTYPE_BF16 && S >= SCAN_CHUNK_MIN_S && (dh == 32 || dh == 64 || dh == 128);
}

int launch_wkv_chunked_dh(const void* r, const void* k, const void* v, const float* w,
                          const void* u, float* state, float* out, float* xch, int B, int S,
                          int H, int dh, cudaStream_t st) {
  if (xch == nullptr) return (int)cudaErrorInvalidValue;
  for (const void* p : {r, k, v, (const void*)w, (const void*)state, (const void*)out,
                        (const void*)xch}) {
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  }
  using T = __nv_bfloat16;
  const T *rp = (const T*)r, *kp = (const T*)k, *vp = (const T*)v, *up = (const T*)u;
  switch (dh) {
    case 32: return launch_wkv_chunked<32>(rp, kp, vp, w, up, state, out, xch, B, S, H, st);
    case 64: return launch_wkv_chunked<64>(rp, kp, vp, w, up, state, out, xch, B, S, H, st);
    case 128: return launch_wkv_chunked<128>(rp, kp, vp, w, up, state, out, xch, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// r, k, v (B, S, H, dh) of `dtype` (bf16 or fp32); w (B, S, H, dh) fp32;
// u (H, dh) of `dtype`; state (B, H, dh, dh) fp32, read as the initial
// state and overwritten with the final one; out (B, S, H, dh) fp32;
// scratch, for the chunked body only (null otherwise), B·H·ceil(S / L)
// slots of dh·dh + dh fp32 (L = 32 at dh 128, else 64): the chunks'
// exchange buffer. dh in {32, 64, 128}. Returns cudaGetLastError() after
// the launch (or a refusal code).
extern "C" int repro_wkv_scan(const void* r, const void* k, const void* v, const void* w,
                              const void* u, void* state, void* out, void* scratch, int B,
                              int S, int H, int dh, int dtype, void* stream) {
  using namespace repro;
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (wkv_takes_chunked(S, dtype, dh)) {
    rc = launch_wkv_chunked_dh(r, k, v, (const float*)w, u, (float*)state, (float*)out,
                               (float*)scratch, B, S, H, dh, st);
  } else if (dtype == DTYPE_BF16) {
    rc = launch_wkv<__nv_bfloat16>(r, k, v, (const float*)w, u, (float*)state, (float*)out, B,
                                   S, H, dh, st);
  } else if (dtype == DTYPE_F32) {
    rc = launch_wkv<float>(r, k, v, (const float*)w, u, (float*)state, (float*)out, B, S, H,
                           dh, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
