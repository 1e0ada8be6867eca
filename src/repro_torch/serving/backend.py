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

This slice runs the model's own prefill and decode_step on one device;
the interleaved engine, paged KV, speculative decoding and the prefix
cache come with their slices.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.sampling import SamplerConfig, sample


class EngineBackend:
    """Wall-clock backend over the model's single-device decode path.

    Epoch batching: prefill fixes batch membership, so freed slots pad the
    batch until the epoch drains (can_join_running = False). Arrival waits
    don't sleep — advance_to() skews the clock, so a trace with long idle
    gaps runs in real compute time while latency math still sees the gaps.
    """

    can_join_running = False

    def __init__(self, cfg, params, *, n_slots: int = 0, max_len: int = 512,
                 sampler: Optional[SamplerConfig] = None,
                 prompt_seed: int = 0, impl: str = "kernel", device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.impl = impl
        self.device = resolve_device(device)
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.batch_width = max(n_slots or 1, 1)
        self.n_slots = self.batch_width
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

    # -- protocol ----------------------------------------------------------------
    def start_batch(self, reqs: Sequence) -> List[Optional[int]]:
        prompts = [self._materialize_prompt(r) for r in reqs]
        toks = self._pad_prompts(prompts)
        if toks.shape[0] < self.batch_width:  # pad batch with replicas
            toks = np.concatenate(
                [toks, np.tile(toks[-1:], (self.batch_width - toks.shape[0],
                                           1))], 0)
        toks_t = torch.from_numpy(toks).long().to(self.device)
        cache = M.init_cache(self.cfg, toks.shape[0], self.max_len,
                             device=self.device)
        logits, self._state = M.prefill(self.cfg, self.params, toks_t, cache,
                                        impl=self.impl)
        tok = self._sample(logits[:, -1])
        self._cur = tok[:, None]
        host = tok.tolist()
        return [host[slot] for slot in range(len(reqs))]

    def decode_active(self, slots: Sequence[int]):
        active = torch.zeros(self.batch_width, dtype=torch.bool,
                             device=self.device)
        active[list(slots)] = True
        lg, self._state = M.decode_step(self.cfg, self.params, self._state,
                                        self._cur, impl=self.impl)
        tok = self._sample(lg[:, 0])
        # freed slots keep replaying their last token as batch padding
        self._cur = torch.where(active[:, None], tok[:, None], self._cur)
        host = tok.tolist()
        return {s: host[s] for s in slots}

    def join(self, slot: int, req) -> Optional[int]:
        raise NotImplementedError("batches are fixed at prefill time")

    def release(self, slot: int) -> None:
        """The slot keeps padding the fixed batch until the epoch drains."""
