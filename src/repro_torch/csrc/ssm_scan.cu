// Mamba selective scan of Hymba's SSM heads, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (ssm_scan_kernel, its pallas_call at :80; wrapper ops.py:23). Per
// (b, h) and time step t, with an N x dh fp32 state h:
//
//   h ← exp(A_h · dt_t) h + (dt_t · B_t) ⊗ x_t;   y_t = C_t · h
//
// B_t and C_t (N values) are shared by every head of a batch row.
//
// Two bodies, one launch a call (ssm_takes_chunked, below; ops.py's
// takes_chunked):
//
// The chunked (SSD, matrix-form) body (bf16 calls of S >= 128: every
// prefill), in scan_chunked.cuh: chunks of 64 steps are the blocks of a
// thread block cluster per (b, h); C·Bᵀ, the L x L decay-weighted matrix
// times x, C·h and the chunk's state contribution run on the tensor cores
// (mma.sync) with three-term bf16 operands. Bound on the H100: bytes. At
// Hymba-1.5B's prefill shape (B 4, S 512, H 25, dh 64, N 16; x bf16, y
// fp32) a call moves ~21 MB (~6.2 us at 3.35 TB/s) against ~0.7 GFLOP of
// matrix products; what holds it above is the latency of each block's
// phases and of the cluster barriers (tools/ablate_scan.py, PERF.md).
//
// The sequential body (decode steps, short calls, fp32 inputs): column d
// of h evolves alone. One block per (b, h), one thread per column d
// holding its N fp32 state values in registers for the whole call. x, B_t
// and C_t of SSM_TC steps are staged in shared memory (fp32), with dt_t and
// the decay exp(A_h · dt_t), one scalar per (b, t, h), computed once per
// step; a chunk's loads are issued eight rows at a time before its steps
// run (a first version loaded x inside the step loop and paid one load
// latency per step: 0.32 ms at the prefill shape). The update keeps the
// reference's order, (dt · B_n) · x_d, then y_d = Σ_n C_n h_nd. At S 1 it
// is bound by the launch: ~3 us in a serve.
//
// Both read x and write y in the model layout (B, S, H, dh), and read the
// initial state from and write the final one to the same buffer (the
// decode cache's layer state, in place).

#include "scan_chunked.cuh"

namespace repro {
namespace {

constexpr int SSM_TC = 32;  // time steps per staged chunk

template <typename T, int DH, int NP>
__global__ void __launch_bounds__(DH) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ A, float* __restrict__ state,
    float* __restrict__ y, int S, int H, int N) {
  __shared__ float xs[SSM_TC][DH], bs[SSM_TC][NP], cs[SSM_TC][NP];
  __shared__ float dts[SSM_TC], decs[SSM_TC];

  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int d = threadIdx.x;
  const float a_h = A[hh];
  float* st = state + (size_t)bh * N * DH;

  float s[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) s[n] = n < N ? st[(size_t)n * DH + d] : 0.f;

  for (int t0 = 0; t0 < S; t0 += SSM_TC) {
    const int nt = min(SSM_TC, S - t0);
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt)
      xs[tt][d] = to_f(x[(((size_t)b * S + t0 + tt) * H + hh) * DH + d]);
#pragma unroll 8
    for (int e = d; e < nt * N; e += DH) {
      const int tt = e / N, n = e % N;
      const size_t off = ((size_t)b * S + t0 + tt) * N + n;
      bs[tt][n] = to_f(bm[off]);
      cs[tt][n] = to_f(cm[off]);
    }
    for (int tt = d; tt < nt; tt += DH) {
      const float dv = dt[((size_t)b * S + t0 + tt) * H + hh];
      dts[tt] = dv;
      decs[tt] = expf(a_h * dv);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float xd = xs[tt][d];
      const float dv = dts[tt], dec = decs[tt];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (n < N) {
          s[n] = dec * s[n] + (dv * bs[tt][n]) * xd;
          acc += cs[tt][n] * s[n];
        }
      }
      y[(((size_t)b * S + t0 + tt) * H + hh) * DH + d] = acc;
    }
  }
#pragma unroll
  for (int n = 0; n < NP; ++n)
    if (n < N) st[(size_t)n * DH + d] = s[n];
}

template <typename T, int DH>
int launch_ssm_n(const T* x, const float* dt, const T* bm, const T* cm, const float* A,
                 float* state, float* y, int B, int S, int H, int N, cudaStream_t st) {
  const dim3 grid(B * H);
  if (N <= 16) {
    ssm_scan_kernel<T, DH, 16><<<grid, DH, 0, st>>>(x, dt, bm, cm, A, state, y, S, H, N);
  } else if (N <= 32) {
    ssm_scan_kernel<T, DH, 32><<<grid, DH, 0, st>>>(x, dt, bm, cm, A, state, y, S, H, N);
  } else {
    ssm_scan_kernel<T, DH, 64><<<grid, DH, 0, st>>>(x, dt, bm, cm, A, state, y, S, H, N);
  }
  return 0;
}

template <typename T>
int launch_ssm(const void* x, const float* dt, const void* bm, const void* cm,
               const float* A, float* state, float* y, int B, int S, int H, int dh, int N,
               cudaStream_t st) {
  const T *xp = (const T*)x, *bp = (const T*)bm, *cp = (const T*)cm;
  switch (dh) {
    case 32: return launch_ssm_n<T, 32>(xp, dt, bp, cp, A, state, y, B, S, H, N, st);
    case 64: return launch_ssm_n<T, 64>(xp, dt, bp, cp, A, state, y, B, S, H, N, st);
    case 128: return launch_ssm_n<T, 128>(xp, dt, bp, cp, A, state, y, B, S, H, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Which body a call takes (ops.py's takes_chunked): bf16 calls of at least
// two full chunks run the chunked body (scan_chunked.cuh), everything else
// (decode steps, short calls, fp32 inputs) the sequential one above.
inline bool ssm_takes_chunked(int S, int dtype, int dh, int N) {
  return dtype == DTYPE_BF16 && S >= SCAN_CHUNK_MIN_S && (dh == 32 || dh == 64 || dh == 128) &&
         N >= 1 && N <= 64;
}

template <int DH>
int launch_ssm_chunked_n(const __nv_bfloat16* x, const float* dt, const __nv_bfloat16* bm,
                         const __nv_bfloat16* cm, const float* A, float* state, float* y,
                         float* xch, int B, int S, int H, int N, cudaStream_t st) {
  if (N <= 16)
    return launch_ssm_chunked<DH, 16>(x, dt, bm, cm, A, state, y, xch, B, S, H, N, st);
  if (N <= 32)
    return launch_ssm_chunked<DH, 32>(x, dt, bm, cm, A, state, y, xch, B, S, H, N, st);
  return launch_ssm_chunked<DH, 64>(x, dt, bm, cm, A, state, y, xch, B, S, H, N, st);
}

int launch_ssm_chunked_dh(const void* x, const float* dt, const void* bm, const void* cm,
                          const float* A, float* state, float* y, float* xch, int B, int S,
                          int H, int dh, int N, cudaStream_t st) {
  if (xch == nullptr) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, (const void*)state, (const void*)y, (const void*)xch}) {
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  }
  using T = __nv_bfloat16;
  const T *xp = (const T*)x, *bp = (const T*)bm, *cp = (const T*)cm;
  switch (dh) {
    case 32: return launch_ssm_chunked_n<32>(xp, dt, bp, cp, A, state, y, xch, B, S, H, N, st);
    case 64: return launch_ssm_chunked_n<64>(xp, dt, bp, cp, A, state, y, xch, B, S, H, N, st);
    case 128:
      return launch_ssm_chunked_n<128>(xp, dt, bp, cp, A, state, y, xch, B, S, H, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// x (B, S, H, dh) of `dtype` (bf16 or fp32); dt (B, S, H) fp32; B_in, C_in
// (B, S, N) of `dtype`; A (H,) fp32; state (B, H, N, dh) fp32, read as the
// initial state and overwritten with the final one; y (B, S, H, dh) fp32;
// scratch, for the chunked body only (null otherwise), B·H·ceil(S / 64)
// slots of NP·dh + NP fp32 (NP = N rounded up to 16, 32 or 64): the
// chunks' exchange buffer. dh in {32, 64, 128}, 1 <= N <= 64. Returns
// cudaGetLastError() after the launch (or a refusal code).
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* bm, const void* cm,
                              const void* A, void* state, void* y, void* scratch, int B, int S,
                              int H, int dh, int N, int dtype, void* stream) {
  using namespace repro;
  if (B < 1 || S < 1 || H < 1 || N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (ssm_takes_chunked(S, dtype, dh, N)) {
    rc = launch_ssm_chunked_dh(x, (const float*)dt, bm, cm, (const float*)A, (float*)state,
                               (float*)y, (float*)scratch, B, S, H, dh, N, st);
  } else if (dtype == DTYPE_BF16) {
    rc = launch_ssm<__nv_bfloat16>(x, (const float*)dt, bm, cm, (const float*)A,
                                   (float*)state, (float*)y, B, S, H, dh, N, st);
  } else if (dtype == DTYPE_F32) {
    rc = launch_ssm<float>(x, (const float*)dt, bm, cm, (const float*)A, (float*)state,
                           (float*)y, B, S, H, dh, N, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
