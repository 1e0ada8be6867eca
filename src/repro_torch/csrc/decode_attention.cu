// One-token GQA decode attention against a contiguous or ring-buffer KV
// cache, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_kernel, its pallas_call at :88; wrapper ops.py:25).
// The kernel body, its bound on the H100 and its design are in
// decode_attention.cuh; this file gives it the contiguous cache's slot
// rule: slot t of sequence b is row (b, t) of the (B, S_c, KV, dh) cache,
// visible iff its pos_id is in [0, pos] and pos - pos_id < window, so ring
// buffers and sliding windows need nothing else. The position is read from
// device memory once per block (as the TPU kernel reads its SMEM scalar), so
// a captured CUDA graph replays one launch at every position.

#include "decode_attention.cuh"

namespace repro {
namespace {

struct ContigAddr {
  const int* pos_ids;
  const int* pos_ptr;  // the current position, one int32 on the device
  int S_c, window;
  int base;  // row of slot 0 of this sequence
  int pos;   // *pos_ptr, loaded by begin
  __device__ __forceinline__ void begin(int b) {
    base = b * S_c;
    pos = *pos_ptr;
  }
  __device__ __forceinline__ int fetch(int t) const { return pos_ids[t]; }
  __device__ __forceinline__ int row(int id, int t) const {
    return (id < 0 || id > pos || pos - id >= window) ? -1 : base + t;
  }
};

}  // namespace
}  // namespace repro

// q (B, 1, H, dh); k, v (B, S_c, KV, dh); pos_ids (S_c,) int32; pos one
// int32 on the device; out (B, 1, H, dh). One launch: n_split (1-16)
// blocks per (b, kv group) in one cluster. vec != 0 promises 16-byte aligned q/K/V bases and
// dh·sizeof(T) % 16 == 0. Returns cudaGetLastError() after the launch (or
// a refusal code).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* pos_ids, void* out, int B, int S_c, int H,
                                      int KV, int dh, const void* pos, int window, float scale,
                                      int n_split, int vec, int dtype, void* stream) {
  using namespace repro;
  if (KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const ContigAddr addr{(const int*)pos_ids, (const int*)pos, S_c, window, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dtype == DTYPE_BF16) {
    rc = dispatch_decode<__nv_bfloat16>(q, k, v, addr, out, B, S_c, KV, G, dh, scale, n_split,
                                        vec, dtype, st);
  } else if (dtype == DTYPE_F32) {
    rc = dispatch_decode<float>(q, k, v, addr, out, B, S_c, KV, G, dh, scale, n_split, vec,
                                dtype, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
