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
moves the engine's tier boundary between steps. Paged KV and the prefix
cache come with their slices.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
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
                 prefill_chunk_tokens: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.engine = engine
        self.max_len = max_len
        self.impl = impl
        self.device = engine.device if engine is not None \
            else resolve_device(device)
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.chunk = max(int(prefill_chunk_tokens), 0)
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
        if self.engine is not None:
            # chunked prefill through the engine itself: the weights do not
            # fit the card, so there is no prefill over all of them at once
            state = self.engine.init_state(self.params)
            logits, self._state = self.engine.prefill_partial(
                state, toks_t, chunk=self.chunk)
        else:
            cache = M.init_cache(self.cfg, toks.shape[0], self.max_len,
                                 device=self.device)
            logits, self._state = M.prefill(self.cfg, self.params, toks_t,
                                            cache, impl=self.impl)
        tok = self._sample(logits[:, -1])
        self._cur = tok[:, None]
        if self.spec is not None:
            if self._ctl is None:
                self._ctl = SpecDecodeController(self.spec, self.sampler,
                                                 self.cfg.vocab_size)
            self._pos = int(toks.shape[1])    # left-padded prompt span
        host = tok.tolist()
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
        """The slot keeps padding the fixed batch until the epoch drains."""
