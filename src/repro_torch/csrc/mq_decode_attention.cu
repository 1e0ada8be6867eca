// Multi-query (q_len >= 1) GQA decode attention against a contiguous or
// ring-buffer KV cache, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/multiquery.py
// (mq_decode_attention_kernel, its pallas_call at :107; wrapper :136).
// The kernel body, its bound on the H100 and its design are in
// mq_decode_attention.cuh; this file gives it the contiguous cache's slot
// rule: slot t of sequence b is row (b, t) of the (B, S_c, KV, dh) cache
// with position id pos_ids[t] (-1: empty), and query 0 sits at `pos` for
// every sequence.

#include "mq_decode_attention.cuh"

namespace repro {
namespace {

struct ContigMqAddr {
  const int* pos_ids;
  int S_c, KV, dh, pos;
  __device__ __forceinline__ int qbase(int, int) const { return pos; }
  __device__ __forceinline__ int slot(int b, int kvh, int t, long long& off) const {
    off = (((long long)b * S_c + t) * KV + kvh) * dh;
    return pos_ids[t];
  }
};

}  // namespace
}  // namespace repro

// q (B, Q, H, dh) bf16; k, v (B, S_c, KV, dh) bf16; pos_ids (S_c,) int32;
// out (B, Q, H, dh); part_acc (B, KV, n_split, Q·G, dh) and part_ml
// (B, KV, n_split, Q·G, 2) fp32 scratch, unused (may be null) when
// n_split == 1. vec != 0 promises dh % 8 == 0 and 16-byte aligned bases.
// Returns cudaGetLastError() after the launches (or a refusal code).
extern "C" int repro_mq_decode_attention(const void* q, const void* k, const void* v,
                                         const void* pos_ids, void* out, void* part_acc,
                                         void* part_ml, int B, int Q, int S_c, int H, int KV,
                                         int dh, int pos, int window, float scale, int n_split,
                                         int vec, int dtype, void* stream) {
  using namespace repro;
  if (dtype != DTYPE_BF16 || KV < 1 || H % KV || Q < 1 || n_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const ContigMqAddr addr{(const int*)pos_ids, S_c, KV, dh, pos};
  const int rc = dispatch_mq(q, k, v, addr, out, (float*)part_acc, (float*)part_ml, B, Q, S_c,
                             KV, H / KV, dh, window, scale, n_split, vec,
                             (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
