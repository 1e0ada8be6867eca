// One-token GQA decode attention against a contiguous or ring-buffer KV
// cache, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_kernel, its pallas_call at :88; wrapper ops.py:25).
// The kernel body, its bound on the H100 and its design are in
// decode_attention.cuh; this file gives it the contiguous cache's slot
// rule: slot t of sequence b is row (b, t) of the (B, S_c, KV, dh) cache,
// visible iff its pos_id is in [0, pos] and pos - pos_id < window, so ring
// buffers and sliding windows need nothing else.

#include "decode_attention.cuh"

namespace repro {
namespace {

struct ContigAddr {
  const int* pos_ids;
  int S_c, KV, dh, pos, window;
  __device__ __forceinline__ long long offset(int b, int kvh, int t) const {
    const int id = pos_ids[t];
    if (id < 0 || id > pos || pos - id >= window) return -1;
    return (((long long)b * S_c + t) * KV + kvh) * dh;
  }
};

}  // namespace
}  // namespace repro

// q (B, 1, H, dh); k, v (B, S_c, KV, dh); pos_ids (S_c,) int32;
// out (B, 1, H, dh); part_acc (B, KV, n_split, G, dh) and part_ml
// (B, KV, n_split, G, 2) fp32 scratch, unused (may be null) when n_split == 1.
// vec != 0 promises 16-byte aligned K/V bases and dh·sizeof(T) % 16 == 0.
// Returns cudaGetLastError() after the launches (or a refusal code).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* pos_ids, void* out, void* part_acc,
                                      void* part_ml, int B, int S_c, int H, int KV, int dh,
                                      int pos, int window, float scale, int n_split, int vec,
                                      int dtype, void* stream) {
  using namespace repro;
  if (KV < 1 || H % KV || n_split < 1) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const ContigAddr addr{(const int*)pos_ids, S_c, KV, dh, pos, window};
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dtype == DTYPE_BF16) {
    rc = dispatch_decode<__nv_bfloat16>(q, k, v, addr, out, (float*)part_acc, (float*)part_ml,
                                        B, S_c, KV, G, dh, scale, n_split, vec, st);
  } else if (dtype == DTYPE_F32) {
    rc = dispatch_decode<float>(q, k, v, addr, out, (float*)part_acc, (float*)part_ml, B, S_c,
                                KV, G, dh, scale, n_split, vec, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
