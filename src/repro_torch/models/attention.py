"""GQA attention, dense subset (counterpart of ``repro.models.attention``).

Projections, rope and the attention paths of the model: the chunked
reference used for prefill, the cached one-token decode, and the cached
multi-query decode of verification and chunked prefill. ``impl``
selects "ref" (the reference's own jnp-style math, here in PyTorch) or
"kernel" (the hand-written CUDA kernels; on CPU tensors their plain
versions). Layouts are the JAX package's: q (B, S, H, dh), cache
(B, S_c, KV, dh), paged pool (P, page_size, KV, dh), wq (D, H, dh),
wo (H, dh, D).

Cross-attention (the encoder-decoder family) attends from the decoder to
the encoder's projected frames (B, S_enc, KV, dh), with no rope. The
reference computes it in jnp under every impl: the prompt pass with its
chunked attention, decode with ``decode_attention_ref`` at position
2^30. Under impl="kernel" the port routes both through the hand-written
kernels, which compute the same functions: the prompt pass through
flash attention with causal=False (Sq the prompt, Skv the frames), a
decode step through the one-token decode kernel with every frame below
enc_len visible. That kernel keeps a slot only if pos - pos_id < window,
and a window of None means 2^30 (GLOBAL_WINDOW), so at the reference's
position 2^30 it would drop frame 0: the kernel route asks at position
S_enc - 1 instead, where the pos_ids alone decide.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.decode_attention import multiquery as mq_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import paged as pg_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.modules import apply_rope
from repro_torch.models.spec import ParamSpec

NEG_INF = -2.0e30
IMPLS = ("ref", "kernel")
CROSS_POS = 2 ** 30      # the reference's cross-attention decode position


def attention_specs(d_model: int, n_heads: int, n_kv_heads: int,
                    head_dim: int) -> dict:
    return {
        "wq": ParamSpec((d_model, n_heads, head_dim)),
        "wk": ParamSpec((d_model, n_kv_heads, head_dim)),
        "wv": ParamSpec((d_model, n_kv_heads, head_dim)),
        "wo": ParamSpec((n_heads, head_dim, d_model)),
    }


def _sdpa_chunk(q, k, v, mask, scale):
    """q: (B,C,KV,G,dh); k,v: (B,S,KV,dh); mask: (C,S) bool ->
    (B,C,KV,G,dh). Probabilities are rounded to v's dtype before PV."""
    scores = torch.einsum("bckgd,bskd->bkgcs", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgcs,bskd->bckgd", probs.float(),
                        v.float()).to(v.dtype)


def chunked_attention(q, k, v, *, causal: bool, window, q_offset: int = 0,
                      chunk_size: int = 1024):
    """Blocked attention over query chunks; each chunk sees its full key
    row, so a plain softmax suffices. q: (B, Sq, H, dh); k, v:
    (B, Skv, KV, dh). Key j is visible to query i iff (not causal or
    j <= i) and i - j < window."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qg = q.reshape(B, Sq, KV, G, dh)
    C = min(chunk_size, Sq)
    if Sq % C:
        C = Sq
    j = torch.arange(Skv, device=q.device)
    outs = []
    for c0 in range(0, Sq, C):
        i = q_offset + c0 + torch.arange(C, device=q.device)
        mask = torch.ones((C, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= j[None, :] <= i[:, None]
        if window is not None:
            mask &= (i[:, None] - j[None, :]) < window
        outs.append(_sdpa_chunk(qg[:, c0:c0 + C], k, v, mask, scale))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, dh)


def _proj(x, w):
    """x (B, S, D) @ w (D, N, dh) -> (B, S, N, dh)."""
    D, N, dh = w.shape
    return (x @ w.reshape(D, N * dh)).reshape(*x.shape[:-1], N, dh)


def _out_proj(o, wo):
    """o (B, S, H, dh) @ wo (H, dh, D) -> (B, S, D)."""
    H, dh, D = wo.shape
    return o.reshape(*o.shape[:-2], H * dh) @ wo.reshape(H * dh, D)


def attn_forward(params, x, *, rope_theta, causal=True, window=None,
                 impl: str = "ref"):
    """Sequence self-attention (prefill). Returns (out, (k, v)) with the
    rope'd keys and values for cache seeding."""
    B, S, _ = x.shape
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if impl == "kernel":
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window)
    return _out_proj(out, params["wo"]), (k, v)


def attn_decode(params, x, cache_k, cache_v, pos_ids, pos, slots, *,
                rope_theta, window=None, impl: str = "ref"):
    """Single-token decode. x: (B, 1, D); cache_k/v: (B, S_c, KV, dh),
    updated IN PLACE at slots[0] before attention reads them (the JAX
    reference returns new arrays; writing in place saves a cache copy per
    layer); pos_ids: (S_c,) already holding `pos` at that slot. pos: the
    current position, a 0-d int32 tensor on x's device; slots: (1,) int64
    on x's device. Both stay on the device (read there by the kernel), so
    a captured CUDA graph of the step serves every position."""
    B = x.shape[0]
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    posb = pos.expand(B, 1)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    cache_k.index_copy_(1, slots, k)
    cache_v.index_copy_(1, slots, v)
    if impl == "kernel":
        out = da_ops.decode_attention(q, cache_k, cache_v, pos_ids, pos,
                                      window=window)
    else:
        out = da_ops.decode_attention_plain(q, cache_k, cache_v, pos_ids, pos,
                                            window=window)
    return _out_proj(out, params["wo"])


def attn_decode_multi(params, x, cache_k, cache_v, pos_ids, pos, slots, *,
                      rope_theta, window=None, impl: str = "ref"):
    """q_len-token decode (speculative verification, chunked prefill).
    x: (B, q_len, D), query i at position pos + i (pos a 0-d int32 tensor
    on x's device). The q_len new K/V are written IN PLACE at slots
    (q_len,) int64, contiguous (callers keep the window off the ring's
    end), before attention reads them; pos_ids already holds pos + i at
    slots[i]. The queries see each other through the cache, and causality
    between them is the per-query validity pos_ids <= pos + i: the
    arithmetic of q_len sequential attn_decode steps."""
    B, Q, _ = x.shape
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    posb = (pos + torch.arange(Q, device=x.device))[None, :].expand(B, Q)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    cache_k.index_copy_(1, slots, k)
    cache_v.index_copy_(1, slots, v)
    if impl == "kernel":
        out = mq_ops.mq_decode_attention(q, cache_k, cache_v, pos_ids, pos,
                                         window=window)
    else:
        out = mq_ops.mq_decode_attention_plain(q, cache_k, cache_v, pos_ids,
                                               pos, window=window)
    return _out_proj(out, params["wo"])


def paged_attn_decode(params, x, k_pool, v_pool, page_ids, slot,
                      block_tables, ctx_lens, pos, *, rope_theta,
                      window=None, impl: str = "ref"):
    """Single-token decode against a paged KV pool. x: (B, 1, D);
    k_pool/v_pool: (P, page_size, KV, dh), one layer's pages, updated IN
    PLACE at (page_ids[b], slot) before attention reads them (the JAX
    reference returns new pools); page_ids: (B,) int64 page receiving this
    token; slot: its row inside the page, a 0-d int64 tensor (all
    sequences share `pos`, a 0-d int32 tensor; both on x's device);
    block_tables: (B, max_pages) int32; ctx_lens: (B,) int32 tokens live
    including this one. "ref" takes the plain page walk, "kernel" the
    paged decode kernel."""
    B = x.shape[0]
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    posb = pos.expand(B, 1)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    rows = slot.expand(B)
    k_pool.index_put_((page_ids, rows), k[:, 0])
    v_pool.index_put_((page_ids, rows), v[:, 0])
    fn = pg_ops.paged_decode_attention if impl == "kernel" \
        else pg_ops.paged_decode_attention_plain
    out = fn(q, k_pool, v_pool, block_tables, ctx_lens, window=window)
    return _out_proj(out, params["wo"])


def paged_attn_decode_multi(params, x, k_pool, v_pool, page_ids, slots,
                            block_tables, ctx_lens, pos, *, rope_theta,
                            window=None, impl: str = "ref"):
    """q_len-token decode against a paged KV pool (verification, chunked
    and suffix prefill). x: (B, q_len, D), query i at position pos + i
    (pos a 0-d int32 tensor on x's device); page_ids: (B, q_len) int64
    page of each new token; slots: (q_len,) int64 rows inside those pages;
    ctx_lens: (B,) int32 tokens live including the q_len new ones. The new
    K/V are written IN PLACE before attention reads them; causality
    between the queries is the per-row mask of the paged multi-query
    attention."""
    B, Q, _ = x.shape
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    posb = (pos + torch.arange(Q, device=x.device))[None, :].expand(B, Q)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    rows = slots[None, :].expand(B, Q)
    k_pool[page_ids, rows] = k
    v_pool[page_ids, rows] = v
    fn = mq_ops.mq_paged_decode_attention if impl == "kernel" \
        else mq_ops.mq_paged_decode_attention_plain
    out = fn(q, k_pool, v_pool, block_tables, ctx_lens, window=window)
    return _out_proj(out, params["wo"])


@functools.lru_cache(maxsize=None)
def cross_pos_ids(S_enc: int, enc_len: int, device: torch.device):
    """(S_enc,) int32 pos_ids of the encoder's frames: frame j where
    j < enc_len, else -1 (masked), as the reference's cross-attention
    decode builds them. One tensor per (S_enc, enc_len, device), kept for
    good: a decode step reads it in every layer, and a captured step's
    graph reads it at its address."""
    ar = torch.arange(S_enc, dtype=torch.int32, device=device)
    return torch.where(ar < enc_len, ar, torch.full_like(ar, -1))


@functools.lru_cache(maxsize=None)
def cross_pos(S_enc: int, device: torch.device):
    """The kernel route's cross-attention decode position S_enc - 1 (see
    the module docstring) as a 0-d int32 device constant, made once per
    (S_enc, device) (seed_cross_kv makes it) and kept, as cross_pos_ids."""
    return torch.full((), S_enc - 1, dtype=torch.int32, device=device)


def cross_kv(params, src):
    """Cross K/V (B, S_enc, KV, dh) of the encoder's output src (B, S_enc,
    D): src @ wk and src @ wv, no rope."""
    return _proj(src, params["wk"]), _proj(src, params["wv"])


def cross_attn_prefill(params, x, ck, cv, *, impl: str = "ref"):
    """Cross-attention of a prompt pass: x (B, S, D) attends to every one
    of the encoder's frames ck, cv (B, S_enc, KV, dh) (the reference's
    prompt pass does not mask by enc_len), no rope on q. "ref": the
    chunked attention, causal=False; "kernel": flash attention,
    causal=False."""
    q = _proj(x, params["wq"])
    if impl == "kernel":
        out = fa_ops.flash_attention(q, ck, cv, causal=False, window=None)
    else:
        out = chunked_attention(q, ck, cv, causal=False, window=None)
    return _out_proj(out, params["wo"])


def cross_attn_decode(params, x, ck, cv, enc_len: int, *, impl: str = "ref"):
    """Cross-attention of a decode step against the precomputed encoder
    K/V ck, cv (B, S_enc, KV, dh): x (B, 1, D) sees the frames below
    enc_len, no rope on q. "ref" is the reference's own call (pos 2^30,
    no window); "kernel" the decode kernel at pos S_enc - 1, which sees
    the same frames (see the module docstring)."""
    q = _proj(x, params["wq"])
    S_enc = ck.shape[1]
    ids = cross_pos_ids(S_enc, int(enc_len), ck.device)
    if impl == "kernel":
        out = da_ops.decode_attention(q, ck, cv, ids, cross_pos(S_enc, ck.device),
                                      window=None)
    else:
        out = da_ops.decode_attention_plain(q, ck, cv, ids, CROSS_POS,
                                            window=None)
    return _out_proj(out, params["wo"])
