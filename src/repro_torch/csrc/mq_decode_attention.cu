// Multi-query (q_len >= 1) GQA decode attention against a contiguous or
// ring-buffer KV cache, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/multiquery.py
// (mq_decode_attention_kernel, its pallas_call at :107; wrapper :136).
// The kernel body, its bound on the H100 and its design are in
// mq_decode_attention.cuh; this file gives it the contiguous cache's slot
// rule: slot t of sequence b is row (b, t) of the (B, S_c, KV, dh) cache
// with position id pos_ids[t] (-1: empty), and query 0 sits at `pos` for
// every sequence. `pos` is one int32 in device memory, read where a block
// (or a mainloop work item) starts, as the TPU kernel reads its SMEM
// scalar, so a captured CUDA graph replays one launch at every position.

#include "mq_decode_attention.cuh"

namespace repro {
namespace {

struct ContigMqAddr {
  const int* pos_ids;
  const int* pos;  // the position of query 0, one int32 on the device
  int S_c, KV, dh;
  long long map_rows, map_outer;  // the cache as (B, S_c, KV, dh) for TMA
  int box_rows;                   // 64: a tile is one box
  __device__ __forceinline__ int qbase(int, int) const { return *pos; }
  __device__ __forceinline__ int fetch(int, int t) const { return pos_ids[t]; }
  __device__ __forceinline__ int locate(int b, int kvh, int t, int raw, long long& off) const {
    off = (((long long)b * S_c + t) * KV + kvh) * dh;
    return raw;
  }
  __device__ __forceinline__ int slot(int b, int kvh, int t, long long& off) const {
    return locate(b, kvh, t, fetch(b, t), off);
  }
  __device__ __forceinline__ bool box(int b, int t0, int& row, int& outer) const {
    row = t0;
    outer = b;
    return true;
  }
};

}  // namespace
}  // namespace repro

// q (B, Q, H, dh) bf16; k, v (B, S_c, KV, dh) bf16; pos_ids (S_c,) int32;
// pos one int32 on the device; out (B, Q, H, dh). One launch: n_split (1-8) blocks per (b, kv head) in
// one cluster, or the Hopper mainloop unsplit (see mq_body). vec != 0
// promises dh % 8 == 0 and 16-byte aligned bases. Returns
// cudaGetLastError() after the launch (or a refusal code).
extern "C" int repro_mq_decode_attention(const void* q, const void* k, const void* v,
                                         const void* pos_ids, void* out, int B, int Q, int S_c,
                                         int H, int KV, int dh, const void* pos, int window, float scale,
                                         int n_split, int vec, int dtype, void* stream) {
  using namespace repro;
  if (dtype != DTYPE_BF16 || KV < 1 || H % KV || Q < 1 || n_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const ContigMqAddr addr{(const int*)pos_ids, (const int*)pos, S_c, KV, dh, S_c, B, 64};
  const int rc = dispatch_mq(q, k, v, addr, out, B, Q, S_c, KV, H / KV, dh, window, scale,
                             n_split, vec, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
