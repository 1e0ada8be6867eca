"""Single-device decode over a paged KV cache (counterpart of
``repro.kvcache.paged_decode``).

The dense decode path (models/model.decode_step) owns a contiguous
(L, B, S_c, KV, dh) cache per batch. This module is the same decode with
the cache paged: K/V live in one physical pool per layer,
(L, P, page_size, KV, dh) bf16 on the device, each sequence names its
pages through a block table, and attention reads through the table
(kernels/decode_attention/paged.py and the paged multi-query attention).
Pages come from a PagePool as generation crosses page boundaries and go
back when the batch releases them; a radix prefix cache over the same
pool carries full pages from one epoch to the next.

As in the port's model, the per-layer body runs in a Python loop (the JAX
package scans the layers) and the pools are updated IN PLACE: each layer
writes its new K/V into its own view of the pool before attention reads
them. That is safe beside radix-shared pages because a shared page is a
full page below `pos` (matches are page-aligned and capped below the
prompt's end), so no write of a later position can land on one.

Host/device split: BlockTable + PagePool bookkeeping is host-side Python;
the kernels read a device copy of the tables, (B, max_pages) int32,
uploaded again only when a table changed (`bt_uploads` counts them). The
shared position `pos` stays a host int, as in the model.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kvcache.allocator import BlockTable
from repro_torch.kvcache.layout import scatter_to_pages
from repro_torch.kvcache.pool import PagedKVConfig, PagePool
from repro_torch.models import model as M
from repro_torch.models.attention import (IMPLS, paged_attn_decode,
                                          paged_attn_decode_multi)
from repro_torch.models.modules import embed, mlp, rms_norm, unembed


def _check(cfg: ModelConfig, impl: str) -> None:
    if cfg.family != Family.DENSE or cfg.parallel_block:
        raise NotImplementedError(
            f"paged decode in the port serves the dense family, not "
            f"{cfg.family} (recurrent state is O(1) per sequence: nothing "
            f"to page)")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")


class PagedDecodeCache:
    """Owns the pools and block tables of one decode batch. `impl` "ref"
    reads K/V with the plain page walks, "kernel" with the paged decode
    and paged multi-query kernels (their plain versions on the CPU)."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 page_size: int = 64, pool: Optional[PagePool] = None,
                 impl: str = "ref", device=None):
        _check(cfg, impl)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.impl = impl
        self.device = resolve_device(device)
        self.max_pages = -(-max_len // page_size)
        if pool is None:
            pool = PagePool(PagedKVConfig(
                page_size=page_size,
                device_pages=batch * self.max_pages))
        assert pool.page_size == page_size
        self.pool = pool
        self.tables: List[BlockTable] = [BlockTable(page_size)
                                         for _ in range(batch)]
        shp = (cfg.n_layers, pool.alloc.n_pages, page_size, cfg.n_kv_heads,
               cfg.head_dim)
        self.k_pool = torch.zeros(shp, dtype=torch.bfloat16, device=self.device)
        self.v_pool = torch.zeros(shp, dtype=torch.bfloat16, device=self.device)
        self.pos = 0
        self._bt_dev = None
        self._spec_len = 0
        self.bt_uploads = 0       # host -> device copies of the block table

    @property
    def pool_bytes(self) -> int:
        return 2 * self.k_pool.numel() * self.k_pool.element_size()

    # -- table <-> device bridge -------------------------------------------------
    def _device_tables(self) -> torch.Tensor:
        if self._bt_dev is None:
            bt = np.full((self.batch, self.max_pages), -1, np.int32)
            for b, t in enumerate(self.tables):
                bt[b, :len(t.pages)] = t.pages
            self._bt_dev = torch.from_numpy(bt).to(self.device)
            self.bt_uploads += 1
        return self._bt_dev

    def _extend_all(self, n_tokens: int) -> None:
        for t in self.tables:
            if self.pool.extend_table(t, n_tokens):
                self._bt_dev = None      # table grew: refresh device copy

    # -- epoch lifecycle over a persistent pool ------------------------------------
    def reset_tables(self) -> None:
        """Release this batch's tables (radix-shared pages survive their
        increfs) and rewind `pos`: the pool and its K/V bytes persist, so
        a prefix cache built over it carries state across epochs."""
        for i, t in enumerate(self.tables):
            self.pool.release_table(t)
            self.tables[i] = BlockTable(self.pool.page_size)
        self.pos = 0
        self._bt_dev = None

    def adopt_tables(self, tables: List[BlockTable], pos: int) -> None:
        """Take ownership of externally built tables (radix prefix forks:
        shared full pages up front, `pos` tokens committed). The caller
        has already increfed the shared pages into them."""
        assert len(tables) == self.batch, (len(tables), self.batch)
        self.tables = tables
        self.pos = pos
        self._bt_dev = None

    # -- seeding from a dense prefill cache --------------------------------------
    def seed(self, cache: Dict) -> None:
        """Adopt a model-layout cache (M.prefill output, not ring-wrapped):
        scatter its first `pos` K/V rows through freshly allocated block
        tables into the live pools on the device. Pages the radix tree
        owns keep their bytes (only this batch's new pages are written)."""
        pos = int(cache["pos"])
        self._extend_all(pos)
        scatter_to_pages(self.k_pool, cache["k"][:, :self.batch], self.tables,
                         pos)
        scatter_to_pages(self.v_pool, cache["v"][:, :self.batch], self.tables,
                         pos)
        self.pos = pos

    # -- the stack ---------------------------------------------------------------
    def _run(self, params, tokens: torch.Tensor, multi: bool):
        """tokens (B, Q) at positions pos .. pos + Q - 1, their pages
        already in the tables: every layer writes their K/V and attends
        through the tables. Returns logits (B, Q, PV)."""
        cfg = self.cfg
        B, Q = tokens.shape
        ps = self.pool.page_size
        dev = self.device
        bt = self._device_tables()
        qpos = torch.arange(self.pos, self.pos + Q, device=dev)
        page_ids = bt.index_select(1, qpos // ps).long()     # (B, Q)
        ctx = torch.full((B,), self.pos + Q, dtype=torch.int32, device=dev)
        x = embed(params, tokens).to(torch.bfloat16)
        for l, window in enumerate(M.layer_windows(cfg, cfg.n_layers)):
            p = M.layer_params(params, l)
            xn = rms_norm(x, p["ln1"], cfg.norm_eps)
            if multi:
                a_out = paged_attn_decode_multi(
                    p["attn"], xn, self.k_pool[l], self.v_pool[l], page_ids,
                    qpos % ps, bt, ctx, self.pos, rope_theta=cfg.rope_theta,
                    window=window, impl=self.impl)
            else:
                a_out = paged_attn_decode(
                    p["attn"], xn, self.k_pool[l], self.v_pool[l],
                    page_ids[:, 0], self.pos % ps, bt, ctx, self.pos,
                    rope_theta=cfg.rope_theta, window=window, impl=self.impl)
            x = x + a_out
            x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(params, x)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).long().to(self.device)

    # -- suffix / chunked prefill ------------------------------------------------
    def prefill(self, params, tokens, *, chunk: int = 0):
        """Process `tokens` (B, T), the prompt or just its uncached suffix
        when the tables already hold a radix-matched prefix at `pos`,
        through ceil(T / chunk) multi-query rounds (`chunk` 0: one round).
        Each round is the verify pass scoring chunk positions and writing
        their K/V through the block tables. Returns the final position's
        logits (B, PV), the distribution the first sampled token draws
        from."""
        tokens = self._tokens(tokens)
        T = tokens.shape[1]
        if T == 0:
            raise ValueError("prefill needs at least one uncached token "
                             "(the match cap guarantees it)")
        chunk = T if chunk <= 0 else min(chunk, T)
        last = None
        for off in range(0, T, chunk):
            q = tokens[:, off:off + chunk]
            logits = self.verify(params, q)
            self.commit(q.shape[1])
            last = logits[:, -1]
        return last

    # -- one decode step ---------------------------------------------------------
    def step(self, params, token):
        """token: (B, 1) int -> logits (B, 1, PV). Allocates the next page
        of every sequence when `pos` crosses a page boundary."""
        if self.pos >= self.max_len:
            raise ValueError(f"decode past max_len ({self.max_len})")
        self._extend_all(self.pos + 1)
        logits = self._run(params, self._tokens(token), multi=False)
        self.pos += 1
        return logits

    # -- verify / commit ---------------------------------------------------------
    def verify(self, params, tokens):
        """Score q_len positions in one pass. tokens: (B, q_len) int.
        Allocates pages for all q_len positions and writes their K/V;
        returns logits (B, q_len, PV). `pos` does not advance: commit()
        takes the accepted count."""
        tokens = self._tokens(tokens)
        Q = tokens.shape[1]
        if self.pos + Q > self.max_len:
            raise ValueError(f"verify past max_len ({self.pos}+{Q} > "
                             f"{self.max_len})")
        self._extend_all(self.pos + Q)
        logits = self._run(params, tokens, multi=True)
        self._spec_len = Q
        return logits

    def commit(self, n_tokens: int) -> None:
        """Advance `pos` by the accepted count and roll back the rejected
        suffix: tables truncate to the committed length, and pages that
        back only rejected slots return to the pool."""
        assert 0 <= n_tokens <= self._spec_len, n_tokens
        new_pos = self.pos + n_tokens
        for t in self.tables:
            if self.pool.truncate_table(t, new_pos):
                self._bt_dev = None      # table shrank: refresh device copy
        self.pos = new_pos
        self._spec_len = 0

    def release(self) -> None:
        for t in self.tables:
            self.pool.release_table(t)
        self._bt_dev = None

    @property
    def pages_in_use(self) -> int:
        return sum(len(t.pages) for t in self.tables)
