"""Multi-query (q_len >= 1) GQA decode attention: kernel wrapper and plain
version.

Counterpart of ``repro.kernels.decode_attention.multiquery.
mq_decode_attention`` (the TPU kernel ``mq_decode_attention_kernel``,
its pallas_call at ``multiquery.py:107``). Speculative verification and
the interleaved engine's chunked prefill score q_len positions per
sequence in one pass: their K/V are written into the cache first, and
query row qi·G + g (head g of the group, position pos + qi) sees slot s
iff 0 <= pos_ids[s] <= pos + qi and (pos + qi) - pos_ids[s] < window. The
CUDA kernel is ``repro_torch/csrc/mq_decode_attention.cu``; its header
says what bounds it on the H100 and how the design meets that.

Model layout in and out: q (B, q_len, H, dh), cache (B, S_c, KV, dh),
pos_ids (S_c,) int32 with -1 for an empty slot.

The paged form (``mq_paged_decode_attention``, counterpart of the TPU
kernel ``mq_paged_decode_attention_kernel``, its pallas_call at
``multiquery.py:248``) reads K/V through block tables from a pool
(P, page_size, KV, dh); ctx_lens (B,) counts each sequence's tokens
including the q_len new ones, so row qi·G + g sits at position
ctx_lens[b] - q_len + qi. Its CUDA kernel is
``repro_torch/csrc/mq_paged_decode_attention.cu``, this kernel's body with
paged addressing.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _launch, build
from repro_torch.kernels.decode_attention.ops import (GLOBAL_WINDOW, NEG_INF,
                                                      _sm_count)
from repro_torch.kernels.decode_attention.paged import (_walk_pages,
                                                        check_tables)

ROWS_PER_BLOCK = 64   # query rows (q_len·G) of one block in the kernel
TILE_SLOTS = 64       # cache slots per shared-memory tile in the kernel

launches = 0          # kernel launches since the last reset (main-path proof)
paged_launches = 0    # the same for the paged kernel


def mq_decode_attention_plain(q, k_cache, v_cache, pos_ids, pos, *,
                              window=None):
    """Plain PyTorch version (mirrors ``mq_decode_attention_ref``): fp32
    scores, softmax, probabilities rounded to the cache dtype before the PV
    product. A query row with no visible slot outputs 0, as the kernel (and
    the TPU kernel) does."""
    B, Q, H, dh = q.shape
    S_c, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, Q, KV, G, dh).float()
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg, k_cache.float()) \
        * (dh ** -0.5)
    qpos = pos + torch.arange(Q, device=q.device)[:, None]       # (Q, 1)
    valid = (pos_ids[None, :] >= 0) & (pos_ids[None, :] <= qpos)  # (Q, S_c)
    if window is not None:
        valid &= (qpos - pos_ids[None, :]) < window
    vmask = valid[None, :, None, None, :]
    scores = torch.where(vmask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype) \
        * vmask.any(-1, keepdim=True)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs.float(), v_cache.float())
    return out.to(v_cache.dtype).reshape(B, Q, H, dh)


def _n_split(blocks: int, S_c: int, device) -> int:
    """Split the cache over blocks when the (row tile, kv head, batch) grid
    alone gives fewer than about two blocks per SM (the verify shape): about
    four blocks per SM, each a whole number of the kernel's slot tiles."""
    sms = _sm_count(device.index)
    if blocks >= 2 * sms:
        return 1
    want = max(1, math.ceil(4 * sms / blocks))
    chunk = TILE_SLOTS * max(1, math.ceil(S_c / (want * TILE_SLOTS)))
    return math.ceil(S_c / chunk)


def mq_decode_attention(q, k_cache, v_cache, pos_ids, pos, *, window=None):
    """q: (B, q_len, H, dh); k/v_cache: (B, S_c, KV, dh); pos_ids: (S_c,)
    int32; pos: int, the position of query 0 -> (B, q_len, H, dh). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise (bf16 only: the kernel's products run on bf16 tensor cores)."""
    global launches
    if q.device.type == "cpu":
        return mq_decode_attention_plain(q, k_cache, v_cache, pos_ids, pos,
                                         window=window)
    dtype = _launch.check_cuda_inputs("mq_decode_attention", q, k_cache,
                                      v_cache)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"mq_decode_attention: dtype {q.dtype} not "
                        "supported (bfloat16)")
    B, Q, H, dh = q.shape
    Bc, S_c, KV, dhc = k_cache.shape
    if Bc != B or dhc != dh or v_cache.shape != k_cache.shape or Q < 1:
        raise ValueError(f"mq_decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if H % KV:
        raise ValueError(f"mq_decode_attention: H={H} not divisible by "
                         f"KV={KV}")
    if dh > _launch.MAX_HEAD_DIM:
        raise ValueError(f"mq_decode_attention: dh={dh} > "
                         f"{_launch.MAX_HEAD_DIM} not supported")
    if pos_ids.shape != (S_c,) or pos_ids.dtype != torch.int32 \
            or pos_ids.device != q.device or not pos_ids.is_contiguous():
        raise ValueError("mq_decode_attention: pos_ids must be a contiguous "
                         f"({S_c},) int32 tensor on {q.device}")
    window = GLOBAL_WINDOW if window is None else int(window)
    if window < 1:
        raise ValueError(f"mq_decode_attention: window={window} must be >= 1")
    R = Q * (H // KV)
    n_split = _n_split(math.ceil(R / ROWS_PER_BLOCK) * KV * B, S_c, q.device)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B, KV, n_split, R, dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, KV, n_split, R, 2), dtype=torch.float32,
                              device=q.device)
    rc = build.load().repro_mq_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_ids.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        B, Q, S_c, H, KV, dh, int(pos), window, float(dh) ** -0.5, n_split,
        _launch.vector_ok(dh, q, k_cache, v_cache), dtype,
        _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"mq_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out


def mq_paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                    ctx_lens, *, window=None):
    """Plain PyTorch version (mirrors ``mq_paged_decode_attention_ref``): a
    page-by-page online softmax, fp32 throughout, probabilities not
    rounded (unlike ``mq_decode_attention_plain``, whose reference rounds
    them). A row that sees no slot outputs 0. Returns (B, q_len, H, dh)."""
    B, Q, H, dh = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    R = Q * G
    w = GLOBAL_WINDOW if window is None else window
    qg = q.reshape(B, Q, KV, G, dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, R, dh).float()
    rows = torch.arange(R, device=q.device) // G
    qpos = (ctx_lens.long()[:, None] - Q + rows[None, :])[:, :, None]

    def visible(ip, t):                                   # (B, R, ps)
        t = t[None, None, :]
        return (t <= qpos) & ((qpos - t) < w)

    out = _walk_pages(qg, k_pool, v_pool, block_tables, visible, dh ** -0.5)
    out = out.to(q.dtype).reshape(B, KV, Q, G, dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Q, H, dh)


def mq_paged_decode_attention(q, k_pool, v_pool, block_tables, ctx_lens, *,
                              window=None):
    """q: (B, q_len, H, dh); k/v_pool: (P, page_size, KV, dh);
    block_tables: (B, max_pages) int32; ctx_lens: (B,) int32 including the
    q_len new tokens -> (B, q_len, H, dh). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (bf16 only)."""
    global paged_launches
    if q.device.type == "cpu":
        return mq_paged_decode_attention_plain(q, k_pool, v_pool,
                                               block_tables, ctx_lens,
                                               window=window)
    name = "mq_paged_decode_attention"
    dtype = _launch.check_cuda_inputs(name, q, k_pool, v_pool)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (bfloat16)")
    B, Q, H, dh = q.shape
    P, ps, KV, dhp = k_pool.shape
    if dhp != dh or v_pool.shape != k_pool.shape or Q < 1:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    if H % KV:
        raise ValueError(f"{name}: H={H} not divisible by KV={KV}")
    if dh > _launch.MAX_HEAD_DIM:
        raise ValueError(f"{name}: dh={dh} > {_launch.MAX_HEAD_DIM} not "
                         "supported")
    check_tables(name, q, k_pool, block_tables, ctx_lens)
    window = GLOBAL_WINDOW if window is None else int(window)
    if window < 1:
        raise ValueError(f"{name}: window={window} must be >= 1")
    max_pages = block_tables.shape[1]
    R = Q * (H // KV)
    # the contiguous kernel's split of the same S = max_pages · ps slots
    n_split = _n_split(math.ceil(R / ROWS_PER_BLOCK) * KV * B,
                       max_pages * ps, q.device)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B, KV, n_split, R, dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, KV, n_split, R, 2), dtype=torch.float32,
                              device=q.device)
    rc = build.load().repro_mq_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        B, Q, max_pages, ps, H, KV, dh, window, float(dh) ** -0.5, n_split,
        _launch.vector_ok(dh, q, k_pool, v_pool), dtype,
        _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    paged_launches += 1
    return out
