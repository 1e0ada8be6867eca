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

from repro_torch.kernels import _launch, build, tuning
from repro_torch.kernels.decode_attention.ops import (CLUSTER_MAX,
                                                      GLOBAL_WINDOW, NEG_INF,
                                                      _sm_count)
from repro_torch.kernels.decode_attention.paged import (_walk_pages,
                                                        check_tables)

ROWS_PER_BLOCK = 64   # query rows (q_len·G) of one block of the mma.sync body
TILE_SLOTS = 64       # cache slots per tile of every body
VERIFY_ROWS = 128     # rows (q_len·G) the verify body takes (csrc VERIFY_ROWS)

launches = 0          # kernel launches since the last reset (main-path proof)
paged_launches = 0    # the same for the paged kernel
hopper_launches = 0   # launches of each through the Hopper mainloop (the
paged_hopper_launches = 0  # prefill rounds: mq_body "mainloop")
verify_sm90_launches = 0   # launches of each through the verify body
paged_verify_sm90_launches = 0  # (verify_sm90_kernel: mq_body "verify")


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


def mq_body(Q: int, G: int, dh: int, vec: int) -> str:
    """Which body a call launches, the rule of ``mq_body`` in
    ``csrc/mq_decode_attention.cuh``: "verify" (verify_sm90_kernel) for
    the rows the Hopper mainloop takes (16-byte aligned bf16, dh <= 128)
    when there are at most VERIFY_ROWS of them per (b, kv head), the
    Hopper mainloop of ``csrc/attention_sm90.cuh`` ("mainloop") for more,
    and the mma.sync body ("mma") for dh > 128 and unaligned rows. Shapes
    alone decide, so kernels 4 and 5 pick alike."""
    if not _launch.hopper_mainloop(dh, vec, G):
        return "mma"
    return "verify" if Q * G <= VERIFY_ROWS else "mainloop"


def verify_split_count(B: int, KV: int, S: int, sms: int) -> int:
    """Blocks per (b, kv head) of the verify body: about one block per SM,
    at most CLUSTER_MAX (they merge as one thread block cluster), each a
    whole number of at least two 64-slot tiles, so no split is empty (4
    splits of 256 slots at the verify shape B 4, KV 8, S 1024; 8 of 128 at
    B 1). The paged kernel splits its S = max_pages · page_size slots by
    the same rule."""
    want = min(CLUSTER_MAX, max(1, math.ceil(sms / (B * KV))))
    chunk = TILE_SLOTS * max(2, math.ceil(S / (want * TILE_SLOTS)))
    return math.ceil(S / chunk)


def split_count(B: int, Q: int, H: int, KV: int, S: int, sms: int) -> int:
    """The mma.sync body's split: split the S slots over blocks when the
    (64-row tile, kv head, batch) grid alone gives fewer than about two
    blocks per SM: about four blocks per SM, at most CLUSTER_MAX, each a
    whole number of the kernel's slot tiles. 1: unsplit."""
    blocks = split_blocks("mma", B, Q, H, KV)
    if blocks >= 2 * sms:
        return 1
    want = min(CLUSTER_MAX, max(1, math.ceil(4 * sms / blocks)))
    chunk = TILE_SLOTS * max(1, math.ceil(S / (want * TILE_SLOTS)))
    return math.ceil(S / chunk)


def n_splits(body: str, B: int, Q: int, H: int, KV: int, S: int,
             sms: int) -> int:
    """The split count of a call that takes `body` (``mq_body``): the
    mainloop runs unsplit."""
    if body == "verify":
        return verify_split_count(B, KV, S, sms)
    return 1 if body == "mainloop" else split_count(B, Q, H, KV, S, sms)


def split_blocks(body: str, B: int, Q: int, H: int, KV: int) -> int:
    """The blocks a split multiplies: what ``n_splits``' rule reads
    besides the slots and the SM count (B · KV for the verify body, the
    row tiles times B · KV for the mma.sync body)."""
    if body == "verify":
        return B * KV
    return math.ceil(Q * (H // KV) / ROWS_PER_BLOCK) * KV * B


def tuned_split(kernel: str, body: str, S: int, dh: int, override,
                rule: int, at=None) -> int:
    """The split a call of `body` launches with: the mainloop's is 1 and
    has no knob; the verify body takes splits of at least two tiles, the
    mma.sync body of one (``tuning.resolve``: override, table, rule; `at`
    the call's launch geometry)."""
    if body == "mainloop":
        if override not in (None, 1):
            raise ValueError(f"{kernel}: the Hopper mainloop runs unsplit, "
                             f"not n_split={override}")
        return 1
    tiles = 2 if body == "verify" else 1
    return tuning.resolve(kernel, S, dh, "n_split", override, rule,
                          lambda n: tuning.split_legal(n, S, tiles), at)


def mq_decode_attention(q, k_cache, v_cache, pos_ids, pos, *, window=None,
                        n_split=None):
    """q: (B, q_len, H, dh); k/v_cache: (B, S_c, KV, dh); pos_ids: (S_c,)
    int32; pos: the position of query 0, an int or a 0-d int32 tensor on
    q's device (``_launch.device_position``: the kernel reads it from
    device memory) -> (B, q_len, H, dh). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (bf16 only: the
    kernel's products run on bf16 tensor cores). Every body runs inside a
    CUDA graph: the prefill rounds' (mq_body "mainloop") TMA descriptors
    are kernel parameters, copied into the graph by value at capture, and
    encode addresses the graph keeps (q and out in its pool, the cache
    in its scope), see ``csrc/attention_sm90.cuh``. n_split: the verify
    and mma.sync bodies' split count (``tuning.split_legal``; the
    mainloop runs unsplit); None: the tuned table's, else n_splits'."""
    global launches, hopper_launches, verify_sm90_launches
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
    pos = _launch.device_position("mq_decode_attention", pos, q.device)
    vec = _launch.vector_ok(dh, q, k_cache, v_cache)
    body = mq_body(Q, H // KV, dh, vec)
    n_split = tuned_split("mq_decode_attention", body, S_c, dh, n_split,
                          n_splits(body, B, Q, H, KV, S_c,
                                   _sm_count(q.device.index)),
                          {"blocks": split_blocks(body, B, Q, H, KV)})
    out = torch.empty_like(q)
    rc = build.load().repro_mq_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos_ids.data_ptr(), out.data_ptr(), B, Q, S_c, H, KV, dh, pos.data_ptr(),
        window, float(dh) ** -0.5, n_split, vec, dtype,
        _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"mq_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    hopper_launches += body == "mainloop"
    verify_sm90_launches += body == "verify"
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
                              window=None, n_split=None):
    """q: (B, q_len, H, dh); k/v_pool: (P, page_size, KV, dh);
    block_tables: (B, max_pages) int32; ctx_lens: (B,) int32 including the
    q_len new tokens -> (B, q_len, H, dh). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (bf16 only). n_split
    as ``mq_decode_attention``'s."""
    global paged_launches, paged_hopper_launches, paged_verify_sm90_launches
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
    vec = _launch.vector_ok(dh, q, k_pool, v_pool)
    # the contiguous kernel's body and split of the same S = max_pages · ps
    # slots
    body = mq_body(Q, H // KV, dh, vec)
    n_split = tuned_split(name, body, max_pages * ps, dh, n_split,
                          n_splits(body, B, Q, H, KV, max_pages * ps,
                                   _sm_count(q.device.index)),
                          {"blocks": split_blocks(body, B, Q, H, KV),
                           "page_size": ps})
    out = torch.empty_like(q)
    rc = build.load().repro_mq_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        B, Q, P, max_pages, ps, H, KV, dh, window, float(dh) ** -0.5, n_split,
        vec, dtype, _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    paged_launches += 1
    paged_hopper_launches += body == "mainloop"
    paged_verify_sm90_launches += body == "verify"
    return out
