"""One-token GQA decode attention over a paged KV pool: kernel wrapper and
plain version.

Counterpart of ``repro.kernels.decode_attention.paged.
paged_decode_attention`` (the TPU kernel ``paged_decode_attention_kernel``,
its pallas_call at ``paged.py:119``). The CUDA kernel is
``repro_torch/csrc/paged_decode_attention.cu``, the contiguous decode
kernel's body with paged addressing; its header says what bounds it on
the H100 and how the design meets that.

Model layout in and out: q (B, 1, H, dh); k/v pools (P, page_size, KV, dh)
read in place; block_tables (B, max_pages) int32, -1 = unallocated;
ctx_lens (B,) int32, the tokens each sequence holds including this one.
Slot t of sequence b (page block_tables[b, t // page_size], row
t % page_size) is visible iff its page is allocated, t < ctx_lens[b] and
ctx_lens[b] - 1 - t < window.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch, build
from repro_torch.kernels.decode_attention.ops import (GLOBAL_WINDOW, NEG_INF,
                                                      _n_split)

PAGE_MULTIPLE = 8     # the kernel takes page sizes that are multiples of 8

launches = 0          # kernel launches since the last reset (main-path proof)


def _walk_pages(qg, k_pool, v_pool, block_tables, visible, scale):
    """The page-by-page online softmax of the JAX references (paged.py:
    148-208, multiquery.py:277-341): fp32 scores and probabilities, the
    probabilities kept in fp32 through PV. qg: (B, KV, R, dh) fp32;
    visible(ip, t) -> (B, R, ps) bool for logical page ip holding
    positions t. A row that sees no slot keeps l == 0 and outputs 0 (the
    JAX references give the uniform average of V there, the kernels 0)."""
    B, KV, R, dh = qg.shape
    ps = k_pool.shape[1]
    safe = block_tables.clamp(min=0).long()
    m = torch.full((B, KV, R, 1), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, R, dh), dtype=torch.float32, device=qg.device)
    for ip in range(block_tables.shape[1]):
        k = k_pool[safe[:, ip]].float()                   # (B, ps, KV, dh)
        v = v_pool[safe[:, ip]].float()
        s = torch.einsum("bkrd,bskd->bkrs", qg, k) * scale
        t = ip * ps + torch.arange(ps, device=qg.device)
        vm = (visible(ip, t) & (block_tables[:, ip] >= 0)[:, None, None]
              )[:, None]                                  # (B, 1, R, ps)
        s = torch.where(vm, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vm, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkrs,bskd->bkrd", p, v)
        m = m_new
    return acc / torch.where(l == 0, torch.ones_like(l), l)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, ctx_lens,
                                 *, window=None):
    """Plain PyTorch version (mirrors ``paged_decode_attention_ref``): a
    page-by-page online softmax, fp32 throughout, probabilities not
    rounded. Returns (B, 1, H, dh) in q's dtype."""
    B, _, H, dh = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    w = GLOBAL_WINDOW if window is None else window
    ctx = ctx_lens.long()[:, None, None]                  # (B, 1, 1)

    def visible(ip, t):
        t = t[None, None, :]
        return ((t < ctx) & ((ctx - 1 - t) < w)).expand(B, G, -1)

    out = _walk_pages(q.reshape(B, KV, G, dh).float(), k_pool, v_pool,
                      block_tables, visible, dh ** -0.5)
    return out.to(q.dtype).reshape(B, 1, H, dh)


def check_tables(name, q, pool, block_tables, ctx_lens):
    """The block-table and ctx arguments a paged kernel takes: contiguous
    int32 on q's device, (B, max_pages) and (B,); a page size the kernel
    takes."""
    B = q.shape[0]
    ps = pool.shape[1]
    if ps % PAGE_MULTIPLE or ps < PAGE_MULTIPLE:
        raise ValueError(f"{name}: page_size {ps} is not a multiple of "
                         f"{PAGE_MULTIPLE}")
    for arg, t, shape in (("block_tables", block_tables,
                           (B, block_tables.shape[-1])),
                          ("ctx_lens", ctx_lens, (B,))):
        if t.dim() != len(shape) or tuple(t.shape) != shape \
                or t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {shape} "
                             f"int32 tensor on {q.device}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, ctx_lens, *,
                           window=None):
    """q: (B, 1, H, dh); k/v_pool: (P, page_size, KV, dh); block_tables:
    (B, max_pages) int32; ctx_lens: (B,) int32 -> (B, 1, H, dh). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            ctx_lens, window=window)
    name = "paged_decode_attention"
    dtype = _launch.check_cuda_inputs(name, q, k_pool, v_pool)
    B, one, H, dh = q.shape
    P, ps, KV, dhp = k_pool.shape
    if one != 1 or dhp != dh or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    if H % KV:
        raise ValueError(f"{name}: H={H} not divisible by KV={KV}")
    G = H // KV
    if dh > _launch.MAX_HEAD_DIM or not (G <= 8 or (G <= 16 and dh <= 128)):
        raise ValueError(f"{name}: G={G}, dh={dh} not supported (dh <= 256 "
                         f"with G <= 8, or dh <= 128 with G <= 16)")
    check_tables(name, q, k_pool, block_tables, ctx_lens)
    window = GLOBAL_WINDOW if window is None else int(window)
    max_pages = block_tables.shape[1]
    # the contiguous kernel's split of the same S = max_pages · ps slots
    n_split = _n_split(B, KV, max_pages * ps, q.device)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B, KV, n_split, G, dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, KV, n_split, G, 2), dtype=torch.float32,
                              device=q.device)
    rc = build.load().repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        B, max_pages, ps, H, KV, dh, window, float(dh) ** -0.5, n_split,
        _launch.vector_ok(dh, k_pool, v_pool), dtype,
        _launch.stream_handle(q.device))
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def gather_pages(pool, block_tables):
    """Each sequence's cache laid out contiguously: pool (P, ps, KV, dh),
    block_tables (B, max_pages) -> (B, max_pages · ps, KV, dh). An
    unallocated (-1) entry gathers page 0, which every consumer masks by
    position (the JAX ``gather_page_row``, batched). A test and
    measurement helper: the serving path never gathers."""
    B, maxp = block_tables.shape
    out = pool[block_tables.clamp(min=0).long()]         # (B, maxp, ps, ...)
    return out.reshape(B, maxp * pool.shape[1], *pool.shape[2:])
