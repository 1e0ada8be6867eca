// One-token GQA decode attention over a paged KV pool, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention_kernel, its pallas_call at :119; wrapper :218).
// Bound on the H100: bytes, as the contiguous decode kernel (each visible
// K/V row read once for the G heads of its group; B 4, ctx 1019, KV 8,
// dh 128 is 16.7 MB, ~5 us at 3.35 TB/s). The body is decode_attention.cuh's;
// this file gives it the paged slot rule:
//  * the pool keeps the model layout (P, page_size, KV, dh): slot t of
//    sequence b is row (bt[b, t / ps], t % ps) of it, read in place. The
//    TPU wrapper moved the pool to (P, KV, ps, dh) and padded dh to 128;
//    on the card that would copy a layer's whole pool on every call.
//  * slot t is visible iff its page is allocated (bt >= 0), t < ctx[b] and
//    ctx[b] - 1 - t < window; ctx is per sequence. A tile of slots whose
//    pages are unallocated or lie past ctx[b] is skipped before its loads,
//    so a sequence costs what it holds, not max_pages · ps.
//  * the slot walk (S = max_pages · ps), split count and tile order are the
//    contiguous kernel's, so on the gathered cache (pos = ctx - 1,
//    pos_ids = arange) the result is bit-identical to it.
// A page size is any multiple of 8; the wrapper refuses others.

#include "decode_attention.cuh"

namespace repro {
namespace {

struct PagedAddr {
  const int* block_tables;  // (B, max_pages), -1 = unallocated
  const int* ctx_lens;      // (B,)
  int max_pages, page_size, KV, dh, window;
  __device__ __forceinline__ long long offset(int b, int kvh, int t) const {
    const int ctx = ctx_lens[b];
    if (t >= ctx || ctx - 1 - t >= window) return -1;
    const int page = block_tables[(size_t)b * max_pages + t / page_size];
    if (page < 0) return -1;
    return (((long long)page * page_size + t % page_size) * KV + kvh) * dh;
  }
};

}  // namespace
}  // namespace repro

// q (B, 1, H, dh); k_pool, v_pool (P, page_size, KV, dh); block_tables
// (B, max_pages) int32; ctx_lens (B,) int32; out (B, 1, H, dh); part_acc /
// part_ml as repro_decode_attention's over S = max_pages · page_size slots.
// Returns cudaGetLastError() after the launches (or a refusal code).
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* block_tables,
                                            const void* ctx_lens, void* out, void* part_acc,
                                            void* part_ml, int B, int max_pages,
                                            int page_size, int H, int KV, int dh, int window,
                                            float scale, int n_split, int vec, int dtype,
                                            void* stream) {
  using namespace repro;
  if (KV < 1 || H % KV || n_split < 1 || page_size < 8 || page_size % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = H / KV;
  const int S = max_pages * page_size;
  const PagedAddr addr{(const int*)block_tables, (const int*)ctx_lens, max_pages, page_size,
                       KV, dh, window};
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (dtype == DTYPE_BF16) {
    rc = dispatch_decode<__nv_bfloat16>(q, k_pool, v_pool, addr, out, (float*)part_acc,
                                        (float*)part_ml, B, S, KV, G, dh, scale, n_split, vec,
                                        st);
  } else if (dtype == DTYPE_F32) {
    rc = dispatch_decode<float>(q, k_pool, v_pool, addr, out, (float*)part_acc,
                                (float*)part_ml, B, S, KV, G, dh, scale, n_split, vec, st);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
