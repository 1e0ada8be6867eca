"""Execution backend of the port (counterpart of
``repro.serving.backend.EngineBackend``, single-device dense path).

The protocol the scheduler drives (duck-typed, as in the JAX package):

  n_slots            batch slots the backend co-schedules
  can_join_running   may the scheduler refill freed slots mid-flight?
  now()              current time (seconds)
  advance_to(t)      idle until t (arrival wait)
  kv_budget_tokens() KV capacity in tokens, or None (unbounded)
  start_batch(reqs)  admit an idle-state batch; returns first token per
                     request
  decode_active(slots) one decode step; {slot: token} per live slot
  join(slot, req)    mid-flight admission (only if can_join_running)
  release(slot)      slot freed by the scheduler

Without an engine the backend runs the model's own prefill and
decode_step on one device. With an InterleavedEngine (weights larger than
HBM) it prefills through the engine's chunked multi-query rounds
(prefill_partial) and decodes through its interleaved passes; with a
SpecConfig (draft="resident") each decode round drafts k greedy tokens on
the engine's live resident tier and verifies them in one pass. retier()
moves the engine's tier boundary between steps.

Without an engine, `paged` routes the single-device path through a paged
KV cache (kvcache/paged_decode: one pool, block tables, the paged decode
and multi-query kernels), and `prefix_cache` adds a radix prefix cache
over that pool, persistent across epochs: an epoch of equal-length
prompts forks its matched page-aligned prefix into fresh block tables and
prefills only the uncached suffix (in chunks of prefill_chunk_tokens),
and a finished request donates its pages to the tree. The JAX backend
builds its paged cache with the reference math; this one passes its own
`impl` through, so the default runs the paged kernels.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kvcache.allocator import BlockTable
from repro_torch.kvcache.paged_decode import PagedDecodeCache
from repro_torch.kvcache.pool import PagedKVConfig, PagePool
from repro_torch.models import model as M
from repro_torch.prefixcache import RadixPrefixCache
from repro_torch.serving.sampling import SamplerConfig, sample
from repro_torch.specdec import DepthController, SpecDecodeController


class EngineBackend:
    """Wall-clock backend over the model's single-device decode path, or
    over an InterleavedEngine.

    Epoch batching: prefill fixes batch membership, so freed slots pad the
    batch until the epoch drains (can_join_running = False). Arrival waits
    don't sleep — advance_to() skews the clock, so a trace with long idle
    gaps runs in real compute time while latency math still sees the gaps.

    Speculative decoding (spec, engine only): the shared-pos cache layout
    (prompts left-padded, one position per batch) forces lockstep commits:
    every live slot advances by the minimum committed count and the rest is
    re-verified next round, which greedy re-derives exactly.
    """

    can_join_running = False

    def __init__(self, cfg, params, *, engine=None, n_slots: int = 0,
                 max_len: int = 512, sampler: Optional[SamplerConfig] = None,
                 prompt_seed: int = 0, impl: str = "kernel", spec=None,
                 prefill_chunk_tokens: int = 0, paged: bool = False,
                 prefix_cache: bool = False, page_size: int = 64,
                 cache_pages: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.engine = engine
        self.max_len = max_len
        self.impl = impl
        self.device = engine.device if engine is not None \
            else resolve_device(device)
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.chunk = max(int(prefill_chunk_tokens), 0)
        # radix prefix cache over the real paged pool: prompts matched
        # against cached pages, only the uncached suffix prefilled,
        # finished requests donate their pages back. It rides the
        # single-device paged path (the engine keeps a dense cache per
        # slot: there is no shared pool to fork from).
        if prefix_cache and engine is not None:
            raise NotImplementedError(
                "prefix_cache shares real KV pages through the "
                "single-device paged pool; the engine's cache layout has "
                "no shared pool to fork from")
        self.prefix_cache = prefix_cache
        self.paged = (paged or prefix_cache) and engine is None
        self.page_size = page_size
        self._cache_pages = cache_pages   # radix headroom (0: one full
                                          # batch's worth of extra pages)
        self._paged_cache = None
        self._radix = None
        self._slot_tokens = None          # per-slot donatable prompt ids
        self._slot_out = None             # per-slot committed output ids
        self._saved_tokens = 0            # prompt tokens seeded from cache
        self.spec = spec
        self._ctl = None
        self._depth = None
        self._pos = 0                         # host mirror of the cache pos
        if spec is not None:
            if engine is None:
                raise NotImplementedError(
                    "the port drafts on the engine's resident tier: "
                    "speculative decoding needs an InterleavedEngine")
            if engine.k_res_cap == 0:
                raise ValueError("draft='resident' needs a resident tier; "
                                 "this plan streams every layer")
            if spec.adapt_k:
                self._depth = DepthController(k_max=spec.k,
                                              prior=spec.acceptance)
            # verify windows must not wrap the cache ring; past its end the
            # plain ring-aware step takes over (decode_active fallback)
            self._spec_cap = min(engine.S_c, max_len)
        self._adapt = {"retier_events": 0, "layers_demoted": 0,
                       "layers_promoted": 0, "hbm_returned_bytes": 0.0}
        # batch_width: what a step computes (fixed); n_slots: what the
        # scheduler may co-schedule (sporadic serves 1 through a wide
        # engine, the spare rows ride as padding)
        self.batch_width = engine.mb if engine is not None \
            else max(n_slots or 1, 1)
        self.n_slots = min(n_slots, self.batch_width) if n_slots \
            else self.batch_width
        # (k, tokens committed per live slot) of each decode round; (0, 1)
        # for a plain decode step
        self.rounds: List[Tuple[int, int]] = []
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.sampler.seed)
        self._prompt_rng_seed = prompt_seed
        self._t0 = time.monotonic()
        self._skew = 0.0
        self._state = None
        self._cur = None                      # (batch_width, 1) last tokens

    # -- clock -------------------------------------------------------------------
    def now(self) -> float:
        return (time.monotonic() - self._t0) + self._skew

    def advance_to(self, t: float) -> None:
        cur = self.now()
        if t > cur:
            self._skew += t - cur

    # -- capacity ----------------------------------------------------------------
    def kv_budget_tokens(self) -> Optional[int]:
        # the cache is statically shaped: max_len per slot
        return self.n_slots * self.max_len

    def max_request_tokens(self) -> Optional[int]:
        """Per-slot ceiling: a single request's prompt + max_new must fit
        the statically-shaped cache."""
        return self.max_len

    def fits_batch(self, batch: Sequence, req) -> bool:
        """Prompts are LEFT-padded to the batch max, so every co-scheduled
        request decodes from position max(prompt_len): each one's max
        prompt + own max_new must fit max_len."""
        cand = list(batch) + [req]
        mp = max(r.prompt_len for r in cand)
        return all(mp + r.max_new_tokens <= self.max_len for r in cand)

    # -- helpers -----------------------------------------------------------------
    def _materialize_prompt(self, r) -> np.ndarray:
        if r.prompt is not None:
            return np.asarray(r.prompt, np.int32)
        rng = np.random.default_rng(self._prompt_rng_seed + r.rid)
        n = max(r.prompt_len, 1)
        return rng.integers(1, self.cfg.vocab_size, size=n).astype(np.int32)

    @staticmethod
    def _pad_prompts(prompts: List[np.ndarray]) -> np.ndarray:
        """Left-pad with token 0. There is no pad mask: pads are attended
        causally, exactly as in the JAX reference."""
        S = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), S), np.int32)
        for i, p in enumerate(prompts):
            toks[i, S - len(p):] = p
        return toks

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.sampler, self._gen, self.cfg.vocab_size)

    # -- online memory adaptation --------------------------------------------------
    def retier(self, stage: int, delta: int) -> float:
        """Move `delta` resident slots of `stage` across the engine's tier
        boundary between steps of the live serve (positive: demote).
        Returns HBM bytes freed (< 0 on promote). The OnlinePlanner and
        page-pool drive of it come with the paged-KV slice."""
        eng = self.engine
        before = eng.demoted(stage)
        self._state, freed = eng.retier(self._state, stage, delta)
        moved = abs(eng.demoted(stage) - before)
        if moved:
            self._adapt["retier_events"] += 1
            key = "layers_demoted" if freed > 0 else "layers_promoted"
            self._adapt[key] += moved
            self._adapt["hbm_returned_bytes"] += max(freed, 0.0)
            self._sync_depth_rung()
        return freed

    def _sync_depth_rung(self) -> None:
        """Tell the DepthController the tier boundary moved: the new rung
        (demoted slots) starts from the acceptance prior scaled by the
        live resident fraction."""
        if self._depth is None:
            return
        eng = self.engine
        rung = sum(eng.demoted(d) for d in range(eng.plan.n_stage))
        self._depth.note_rung(
            rung, prior=self.spec.acceptance * eng.resident_fraction())

    @property
    def adapt_stats(self):
        if self.engine is None:
            return None
        return dict(self._adapt, layers_streamed_now=sum(
            self.engine.demoted(d) for d in range(self.engine.plan.n_stage)))

    @property
    def spec_stats(self):
        return self._ctl.stats.to_dict() if self._ctl is not None else None

    # -- protocol ----------------------------------------------------------------
    def start_batch(self, reqs: Sequence) -> List[Optional[int]]:
        prompts = [self._materialize_prompt(r) for r in reqs]
        toks = self._pad_prompts(prompts)
        if toks.shape[0] < self.batch_width:  # pad batch with replicas
            toks = np.concatenate(
                [toks, np.tile(toks[-1:], (self.batch_width - toks.shape[0],
                                           1))], 0)
        toks_t = torch.from_numpy(toks).long().to(self.device)
        if self.prefix_cache:
            last = self._start_batch_prefix(reqs, prompts, toks_t)
        elif self.engine is not None:
            # chunked prefill through the engine itself: the weights do not
            # fit the card, so there is no prefill over all of them at once
            state = self.engine.init_state(self.params)
            logits, self._state = self.engine.prefill_partial(
                state, toks_t, chunk=self.chunk)
            last = logits[:, -1]
        else:
            cache = M.init_cache(self.cfg, toks.shape[0], self.max_len,
                                 device=self.device)
            logits, cache = M.prefill(self.cfg, self.params, toks_t, cache,
                                      impl=self.impl)
            last = logits[:, -1]
            self._state = cache
            if self.paged:                # the dense prefill, into pages
                if self._paged_cache is not None:
                    self._paged_cache.release()
                self._paged_cache = PagedDecodeCache(
                    self.cfg, toks.shape[0], self.max_len,
                    page_size=self.page_size, impl=self.impl,
                    device=self.device)
                self._paged_cache.seed(cache)
                self._state = None
        tok = self._sample(last)
        self._cur = tok[:, None]
        if self.spec is not None:
            if self._ctl is None:
                self._ctl = SpecDecodeController(self.spec, self.sampler,
                                                 self.cfg.vocab_size)
            self._pos = int(toks.shape[1])    # left-padded prompt span
        host = tok.tolist()
        if self.prefix_cache:
            for slot in range(len(reqs)):
                self._slot_out[slot].append(host[slot])
        return [host[slot] for slot in range(len(reqs))]

    def decode_active(self, slots: Sequence[int]):
        if self.spec is not None:
            # a speculative round when a draft fits before the cache/ring
            # end (the last position is reserved for the committed token)
            if self._depth is not None:
                self._sync_depth_rung()
            k_cap = self.spec.k if self._depth is None else self._depth.k()
            k = min(k_cap, self._spec_cap - self._pos - 1)
            if slots and k >= 1:
                return self._decode_active_spec(slots, k)
        self.rounds.append((0, 1))
        active = torch.zeros(self.batch_width, dtype=torch.bool,
                             device=self.device)
        active[list(slots)] = True
        if self.engine is not None:
            lg, self._state = self.engine.decode_requests(self._state,
                                                          self._cur, active)
        elif self.paged:
            if self.prefix_cache:
                self._ensure_room(self._paged_cache, 1)
            lg = self._paged_cache.step(self.params, self._cur)[:, 0]
        else:
            lg, self._state = M.decode_step(self.cfg, self.params,
                                            self._state, self._cur,
                                            impl=self.impl)
            lg = lg[:, 0]
        tok = self._sample(lg)
        self._pos += 1
        # freed slots keep replaying their last token as batch padding
        self._cur = torch.where(active[:, None], tok[:, None], self._cur)
        host = tok.tolist()
        if self.prefix_cache:
            for s in slots:
                self._slot_out[s].append(host[s])
        return {s: host[s] for s in slots}

    def _decode_active_spec(self, slots: Sequence[int], k: int):
        """One speculative round: k resident-tier drafts per live slot,
        verified in ONE multi-query pass (one weight stream); commit the
        lockstep-min accepted prefix, roll the rejected suffix back."""
        eng = self.engine
        active = np.zeros(self.batch_width, bool)
        active[list(slots)] = True
        draft = self._draft_resident(active, k)            # (B, k)
        cur = self._cur.cpu().numpy()                      # (B, 1)
        mat = np.tile(cur, (1, 1 + k))                     # padding: replicas
        mat[active, 1:] = draft[active]
        lg, self._state = eng.verify_requests(
            self._state, torch.from_numpy(mat).to(self.device), active)
        lg = lg.float().cpu().numpy()                      # (B, k+1, PV)
        committed = {s: self._ctl.verify(lg[s], draft[s]) for s in slots}
        c = min(len(v) for v in committed.values())
        for s in slots:
            # accepted AND committed drafts only (truncated tokens are
            # drafted again next round and must not count twice)
            self._ctl.note_round(k, min(c, len(committed[s]) - 1))
        if self._depth is not None:
            self._depth.note_round(
                k * len(slots),
                sum(min(c, len(committed[s]) - 1) for s in slots))
        committed = {s: v[:c] for s, v in committed.items()}
        self.rounds.append((k, c))
        self._pos += c
        self._state = eng.rollback(self._state, self._pos)
        eng.note_committed(self._pos, active)
        for s in slots:
            cur[s, 0] = committed[s][-1]
        self._cur = torch.from_numpy(cur).to(self.device)
        return committed

    def _draft_resident(self, active: np.ndarray, k: int) -> np.ndarray:
        """k greedy tokens per slot from the engine's resident-only step
        (the live tier boundary, the real slot caches), then a rollback to
        the committed position so the verify pass overwrites every drafted
        position. Returns (B, k) int64."""
        eng = self.engine
        cur = self._cur
        out = []
        for _ in range(k):
            lg, self._state = eng.draft_requests(self._state, cur, active)
            cur = torch.argmax(lg[:, :self.cfg.vocab_size], -1)[:, None]
            out.append(cur)
        self._state = eng.rollback(self._state, self._pos)
        return torch.cat(out, 1).cpu().numpy()

    def join(self, slot: int, req) -> Optional[int]:
        raise NotImplementedError("batches are fixed at prefill time")

    def release(self, slot: int) -> None:
        """The slot keeps padding the fixed batch until the epoch drains.
        With the prefix cache, its committed pages become future prefix
        hits now (the table itself lives until the next epoch's
        reset_tables; the tree's increfs carry the pages on)."""
        if self.prefix_cache:
            self._donate_slot(slot)

    # -- radix prefix cache over the real paged pool ---------------------------
    def _prefix_structures(self):
        """Persistent pool + paged cache + radix tree, built at first use:
        they outlive epochs, which is the whole point of the cache."""
        if self._radix is None:
            B = self.batch_width
            max_pages = -(-self.max_len // self.page_size)
            extra = self._cache_pages or B * max_pages
            pool = PagePool(PagedKVConfig(page_size=self.page_size,
                                          device_pages=B * max_pages + extra))
            self._paged_cache = PagedDecodeCache(
                self.cfg, B, self.max_len, page_size=self.page_size,
                pool=pool, impl=self.impl, device=self.device)
            self._radix = RadixPrefixCache(pool)
        return self._paged_cache, self._radix

    def _ensure_room(self, pc, n_new_tokens: int) -> None:
        """Free device pages for the coming growth: unpinned radix pages
        are evicted first. Cached prefixes are reclaimable, live tables
        are not (the pool is sized so that this always suffices)."""
        need = sum(pc.pool.pages_for(pc.pos + n_new_tokens) - len(t.pages)
                   for t in pc.tables)
        short = need - pc.pool.free_pages()
        if short > 0:
            self._radix.evict(short)

    def _start_batch_prefix(self, reqs, prompts, toks):
        """Seed the epoch from shared pages where the radix tree has them,
        then prefill only the uncached suffix (chunked when configured).
        The shared-pos cache layout forces one matched length for the
        whole batch, so hits need equal-length prompts and align on the
        batch-minimum match; the batch's replica rows ride the last
        request's match. Unequal-length epochs run cold through the dense
        prefill, scattered into pages (their left-padded prefixes would
        key pad tokens, so they never donate). Returns the last
        position's logits (B, PV)."""
        pc, radix = self._prefix_structures()
        B = self.batch_width
        pc.reset_tables()                 # radix increfs keep shared pages
        self._slot_tokens = [None] * B
        self._slot_out = [[] for _ in range(B)]
        ps = self.page_size
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            cache = M.init_cache(self.cfg, B, self.max_len,
                                 device=self.device)
            logits, cache = M.prefill(self.cfg, self.params, toks, cache,
                                      impl=self.impl)
            self._ensure_room(pc, int(cache["pos"]))
            pc.seed(cache)
            self._state = None
            return logits[:, -1]
        L = lens.pop()
        matches = [radix.match(p, max_pages=(L - 1) // ps) for p in prompts]
        m = min(n for _, n in matches)    # shared pos: batch-min match
        self._saved_tokens += m * len(reqs)
        for r in reqs:                    # visibility in serving reports
            r.cached_tokens = max(r.cached_tokens, m)
        while len(matches) < B:           # padded replicas ride the last
            matches.append(matches[-1])   # request's match
        if m > 0:
            tables = []
            for pages, _ in matches:
                t = BlockTable(ps)
                for pid in pages[:m // ps]:
                    pc.pool.incref_page(pid)
                t.pages = list(pages[:m // ps])
                t.tokens = m
                tables.append(t)
            pc.adopt_tables(tables, m)
        self._ensure_room(pc, L - pc.pos)
        last = pc.prefill(self.params, toks[:, pc.pos:], chunk=self.chunk)
        for slot, p in enumerate(prompts):
            self._slot_tokens[slot] = [int(x) for x in p]
        self._state = None
        return last

    def _donate_slot(self, slot: int) -> None:
        """Insert `slot`'s committed pages (prompt + sampled output so
        far) into the radix tree. Slots whose prompt rode left-padding
        have no donatable tokens: their early positions hold pad KV."""
        if self._radix is None or self._slot_tokens is None \
                or self._slot_tokens[slot] is None:
            return
        toks = self._slot_tokens[slot] + self._slot_out[slot]
        table = self._paged_cache.tables[slot]
        self._radix.insert(toks, table.pages,
                           n_tokens=min(len(toks), table.tokens))

    @property
    def prefix_stats(self):
        if self._radix is None:
            return None
        r = self._radix
        return {"prefix_lookups": r.lookups, "prefix_hits": r.hits,
                "cached_tokens": r.cached_tokens(),
                "prefix_pages": r.n_pages,
                "prefill_tokens_saved": self._saved_tokens}
