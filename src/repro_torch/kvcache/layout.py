"""Dense <-> paged K/V movement on the device (counterpart of
``repro.kvcache.layout``).

One pair of functions owns the byte movement between the two layouts, so
seeding a paged cache from a dense prefill can never diverge from reading
it back on partial-last-page arithmetic:

  dense  (L, B, S, *rest)          per-sequence contiguous token rows
  pool   (L, P, page_size, *rest)  physical pages, any owner

Both write in place with one indexed copy on the pool's device and move
only the first `ctx` tokens of each sequence (the tail past ctx holds no
tokens: its pages are unallocated, and every consumer masks it by
position). The JAX package loops over pages on host numpy buffers and its
paged cache's seed() round-trips the whole pool through a host fp32 copy;
here the pool never leaves the card, and the move is exact (bit for bit)
at any dtype.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kvcache.allocator import BlockTable


def _slot_index(tables: Sequence[BlockTable], ctx: int, page_size: int,
                device) -> Tuple[torch.Tensor, ...]:
    """(sequence, token, page, row-in-page) of every live slot: the first
    `ctx` tokens of each table, as far as its pages reach."""
    bs, ts, pages, rows = [], [], [], []
    for b, t in enumerate(tables):
        n = min(ctx, len(t.pages) * page_size)
        tok = np.arange(n)
        bs.append(np.full(n, b))
        ts.append(tok)
        pages.append(np.asarray(t.pages, np.int64)[tok // page_size])
        rows.append(tok % page_size)
    idx = np.stack([np.concatenate(a) if a else np.zeros(0, np.int64)
                    for a in (bs, ts, pages, rows)]).astype(np.int64)
    return tuple(torch.from_numpy(idx).to(device))


def scatter_to_pages(pool: torch.Tensor, dense: torch.Tensor,
                     tables: Sequence[BlockTable], ctx: int) -> torch.Tensor:
    """dense[:, b, :ctx] -> pool pages named by tables[b], in place."""
    b, t, page, row = _slot_index(tables, ctx, pool.shape[2], pool.device)
    pool[:, page, row] = dense[:, b, t].to(pool.dtype)
    return pool


def gather_from_pages(dense_out: torch.Tensor, pool: torch.Tensor,
                      tables: Sequence[BlockTable], ctx: int) -> torch.Tensor:
    """Inverse of scatter_to_pages: pool pages -> dense_out[:, b, :ctx]."""
    b, t, page, row = _slot_index(tables, ctx, pool.shape[2], pool.device)
    dense_out[:, b, t] = pool[:, page, row].to(dense_out.dtype)
    return dense_out
