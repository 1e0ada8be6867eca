// Multi-query (q_len >= 1) GQA decode attention over a paged KV pool,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/multiquery.py
// (mq_paged_decode_attention_kernel, its pallas_call at :248; wrapper
// :347). It scores the prefix cache's prefill rounds (and paged verify
// passes) through the block tables. Bound on the H100: bytes at verify
// sizes, operations at prefill-round sizes (see mq_decode_attention.cuh,
// whose body this is). This file gives it the paged slot rule:
//  * the pool keeps the model layout (P, page_size, KV, dh): slot t of
//    sequence b is row (bt[b, t / ps], t % ps), read in place (the TPU
//    wrapper's move to (P, KV, ps, dh) and dh padding would copy a layer's
//    whole pool per call on the card).
//  * ctx_lens[b] counts tokens including the q_len new ones, so query 0 of
//    sequence b sits at ctx[b] - q_len and row r at ctx[b] - q_len + r / G.
//  * slot t holds position t when its page is allocated and t < ctx[b];
//    otherwise it is empty (never read). With the tile skip, a prefill
//    round reads only the filled pages below ctx.
//  * the slot walk (S = max_pages · ps), body, split count and tile order
//    are the contiguous kernel's, so on the gathered cache (pos = ctx - q_len,
//    pos_ids = t below ctx, -1 past it) the result is bit-identical to it.

#include "mq_decode_attention.cuh"

namespace repro {
namespace {

struct PagedMqAddr {
  const int* block_tables;  // (B, max_pages), -1 = unallocated
  const int* ctx_lens;      // (B,), including the q_len new tokens
  int max_pages, page_size, KV, dh;
  long long map_rows, map_outer;  // the pool as (P, page_size, KV, dh) for TMA
  int box_rows;                   // gcd(page_size, 64): a box never spans pages
  __device__ __forceinline__ int qbase(int b, int Q) const { return ctx_lens[b] - Q; }
  // the page of slot t, -1 past ctx or unallocated
  __device__ __forceinline__ int fetch(int b, int t) const {
    return t < ctx_lens[b] ? block_tables[(size_t)b * max_pages + t / page_size] : -1;
  }
  __device__ __forceinline__ int locate(int, int kvh, int t, int page, long long& off) const {
    if (page < 0) return -1;
    off = (((long long)page * page_size + t % page_size) * KV + kvh) * dh;
    return t;
  }
  __device__ __forceinline__ int slot(int b, int kvh, int t, long long& off) const {
    return locate(b, kvh, t, fetch(b, t), off);
  }
  __device__ __forceinline__ bool box(int b, int t0, int& row, int& outer) const {
    if (t0 >= ctx_lens[b]) return false;
    outer = block_tables[(size_t)b * max_pages + t0 / page_size];
    row = t0 % page_size;
    return outer >= 0;
  }
};

}  // namespace
}  // namespace repro

// q (B, Q, H, dh) bf16; k_pool, v_pool (P, page_size, KV, dh) bf16 (P pages);
// block_tables (B, max_pages) int32; ctx_lens (B,) int32; out
// (B, Q, H, dh). One launch, as repro_mq_decode_attention's over
// S = max_pages · page_size slots. Returns cudaGetLastError() after the
// launch (or a refusal code).
extern "C" int repro_mq_paged_decode_attention(const void* q, const void* k_pool,
                                               const void* v_pool, const void* block_tables,
                                               const void* ctx_lens, void* out, int B, int Q,
                                               int P, int max_pages, int page_size, int H,
                                               int KV, int dh, int window, float scale,
                                               int n_split, int vec, int dtype, void* stream) {
  using namespace repro;
  if (dtype != DTYPE_BF16 || KV < 1 || H % KV || Q < 1 || n_split < 1 || page_size < 8 ||
      page_size % 8) {
    return (int)cudaErrorInvalidValue;
  }
  int box_rows = 64;
  while (page_size % box_rows) box_rows /= 2;  // gcd(page_size, 64): page_size % 8 == 0
  const PagedMqAddr addr{(const int*)block_tables, (const int*)ctx_lens, max_pages, page_size,
                         KV, dh, page_size, P, box_rows};
  const int rc = dispatch_mq(q, k_pool, v_pool, addr, out, B, Q, max_pages * page_size, KV,
                             H / KV, dh, window, scale, n_split, vec, (cudaStream_t)stream);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
