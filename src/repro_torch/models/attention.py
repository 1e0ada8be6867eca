"""GQA attention, dense subset (counterpart of ``repro.models.attention``).

Projections, rope and the attention paths of the model: the chunked
reference used for prefill, the cached one-token decode, and the cached
multi-query decode of verification and chunked prefill. ``impl``
selects "ref" (the reference's own jnp-style math, here in PyTorch) or
"kernel" (the hand-written CUDA kernels; on CPU tensors their plain
versions). Layouts are the JAX package's: q (B, S, H, dh), cache
(B, S_c, KV, dh), wq (D, H, dh), wo (H, dh, D).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import multiquery as mq_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.modules import apply_rope
from repro_torch.models.spec import ParamSpec

NEG_INF = -2.0e30
IMPLS = ("ref", "kernel")


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


def attn_decode(params, x, cache_k, cache_v, pos_ids, pos: int, slot: int, *,
                rope_theta, window=None, impl: str = "ref"):
    """Single-token decode. x: (B, 1, D); cache_k/v: (B, S_c, KV, dh),
    updated IN PLACE at `slot` before attention reads them (the JAX
    reference returns new arrays; writing in place saves a cache copy per
    layer); pos_ids: (S_c,) already holding `pos` at `slot`."""
    B = x.shape[0]
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    if impl == "kernel":
        out = da_ops.decode_attention(q, cache_k, cache_v, pos_ids, pos,
                                      window=window)
    else:
        out = da_ops.decode_attention_plain(q, cache_k, cache_v, pos_ids, pos,
                                            window=window)
    return _out_proj(out, params["wo"])


def attn_decode_multi(params, x, cache_k, cache_v, pos_ids, pos: int,
                      slot: int, *, rope_theta, window=None,
                      impl: str = "ref"):
    """q_len-token decode (speculative verification, chunked prefill).
    x: (B, q_len, D), query i at position pos + i. The q_len new K/V are
    written IN PLACE at slots slot .. slot + q_len - 1 before attention
    reads them (contiguous: callers keep the window off the ring's end);
    pos_ids already holds pos + i at slot + i. The queries see each other
    through the cache, and causality between them is the per-query
    validity pos_ids <= pos + i: the arithmetic of q_len sequential
    attn_decode steps."""
    B, Q, _ = x.shape
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    posb = pos + torch.arange(Q, device=x.device)[None, :].expand(B, Q)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    cache_k[:, slot:slot + Q] = k
    cache_v[:, slot:slot + Q] = v
    if impl == "kernel":
        out = mq_ops.mq_decode_attention(q, cache_k, cache_v, pos_ids, pos,
                                         window=window)
    else:
        out = mq_ops.mq_decode_attention_plain(q, cache_k, cache_v, pos_ids,
                                               pos, window=window)
    return _out_proj(out, params["wo"])
