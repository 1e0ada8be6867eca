"""Continuous-batching scheduler (counterpart of ``repro.serving.scheduler``).

The port's copy keeps the reserve policy, whole:

  admission   a request is admitted only when the KV budget can hold its
              worst case (prompt + max_new tokens) beside every
              co-resident request (paper Eq. 5 accounting); one that could
              never fit is shed at intake.
  queueing    FIFO past the admission gate; arrivals beyond `max_queue`
              are rejected rather than queued forever.
  batching    up to `backend.n_slots` requests ride the batch. Backends
              that can (`can_join_running`) refill freed slots mid-flight;
              epoch backends (the model's cache fixes batch membership at
              prefill) drain a batch, then form the next.

Speculative backends emit a list of committed tokens per round; the
backend's spec and retier counters join the stats at the end of a run.
What the JAX scheduler also carries comes back with the slice that needs
it: the paged KV policy with preemption, the prefix-cache and chunked
prefill hooks and retier reclaim with the paged-KV slice, tracer calls, SLO feeds and bounded-memory
histograms (`hist_capacity`) with the observability slice, and the
fleet's live load signals with the fleet slice.

The loop is clock-agnostic: `backend.now()` is whatever the backend says.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry


@dataclasses.dataclass
class Request:
    """One serving request, from arrival to completion."""
    rid: int
    prompt: Optional[np.ndarray]    # (S,) int32 token ids; None -> length-only
    max_new_tokens: int
    arrival_s: float = 0.0
    prompt_len: int = 0
    output: List[int] = dataclasses.field(default_factory=list)
    generated: int = 0              # tokens emitted
    done: bool = False
    rejected: bool = False
    preempted: int = 0              # times evicted mid-generation (always 0
                                    # under the reserve policy)
    first_token_s: Optional[float] = None
    admitted_s: Optional[float] = None  # left the queue (TTFT split:
                                        # queue wait vs prefill compute)
    finish_s: Optional[float] = None
    session_id: Optional[int] = None    # multiturn conversation id

    def __post_init__(self):
        if self.prompt is not None:
            self.prompt = np.asarray(self.prompt, np.int32)
            self.prompt_len = len(self.prompt)
        self.max_new_tokens = max(int(self.max_new_tokens), 1)

    @property
    def kv_tokens(self) -> int:
        """Worst-case KV footprint in tokens (reservation currency)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.first_token_s is None \
            else self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finish_s is None \
            else self.finish_s - self.arrival_s


def requests_from_arrivals(arrivals, *, start_rid: int = 0,
                           vocab_size: int = 32768,
                           seed: int = 0) -> List[Request]:
    """ArrivalEvents (traffic.py) -> Requests. Template-bearing events
    (shared_prefix / multiturn) materialize real token ids; plain events
    stay length-only (the backend draws their prompts from its seed)."""
    from repro_torch.serving.traffic import template_tokens
    out = []
    for i, ev in enumerate(arrivals):
        rid = start_rid + i
        prompt = None
        if ev.template_id is not None:
            shared = template_tokens(ev.template_id, ev.template_len,
                                     vocab_size=vocab_size, seed=seed)
            uniq = template_tokens(rid, ev.prompt_len - ev.template_len,
                                   vocab_size=vocab_size, seed=seed, salt=1)
            prompt = np.concatenate([shared, uniq])
        out.append(Request(rid, prompt, ev.max_new_tokens,
                           arrival_s=ev.time_s, prompt_len=ev.prompt_len,
                           session_id=getattr(ev, "session_id", None)))
    return out


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_queue: int = 4096                    # beyond this: shed (rejected)
    kv_budget_tokens: Optional[int] = None   # None -> ask the backend


class ContinuousBatchingScheduler:
    """Drives a serving backend through an arrival stream."""

    def __init__(self, backend, config: SchedulerConfig = SchedulerConfig()):
        self.backend = backend
        self.config = config
        self._kv_in_use = 0
        budget = config.kv_budget_tokens
        if budget is None:
            budget = backend.kv_budget_tokens()
        self.kv_budget = budget               # None -> unbounded
        # per-request ceiling (the statically-shaped per-slot cache):
        # pooled headroom must not admit an over-long request
        cap_fn = getattr(backend, "max_request_tokens", None)
        self.max_request = cap_fn() if cap_fn else None
        # batch-composition constraint (left-padding makes co-scheduled
        # requests share position space)
        self._fits_batch = getattr(backend, "fits_batch", None)
        self.metrics = MetricsRegistry()
        self.metrics.gauge("peak_active")
        self.begin([])

    @property
    def stats(self) -> Dict[str, float]:
        """Flat stats view (the registry is the source of truth)."""
        return self.metrics.to_stats_dict()

    # -- admission -------------------------------------------------------------
    def _admits(self, req: Request) -> bool:
        if self.kv_budget is None:
            return True
        return self._kv_in_use + req.kv_tokens <= self.kv_budget

    def _oversized(self, req: Request) -> bool:
        """Can never be served, even on an idle backend."""
        if self.max_request is not None and req.kv_tokens > self.max_request:
            return True
        return self.kv_budget is not None and req.kv_tokens > self.kv_budget

    # -- run state ---------------------------------------------------------------
    def begin(self, requests: List[Request]) -> None:
        """Install a run: requests sorted by arrival, nothing admitted."""
        self._pending: Deque[Request] = deque(
            sorted(requests, key=lambda r: r.arrival_s))
        self._q: Deque[Request] = deque()
        self._active: Dict[int, Request] = {}  # slot -> request
        self._done: List[Request] = []
        self._shed: List[Request] = []

    def now(self) -> float:
        return self.backend.now()

    def _reject(self, r: Request) -> None:
        r.rejected = True
        self._shed.append(r)

    def _intake(self, now: float) -> None:
        while self._pending and self._pending[0].arrival_s <= now:
            r = self._pending.popleft()
            if self._oversized(r) or len(self._q) >= self.config.max_queue:
                self._reject(r)
            else:
                self._q.append(r)

    def _next_admits(self, batch) -> bool:
        """Can the queue head join `batch`?"""
        if not self._q:
            return False
        r = self._q[0]
        if not self._admits(r):
            return False
        return self._fits_batch is None or not batch \
            or self._fits_batch(batch, r)

    def _admit(self) -> Request:
        r = self._q.popleft()
        self._kv_in_use += r.kv_tokens
        r.admitted_s = self.backend.now()
        return r

    def _emit(self, r: Request, slot: int, tok, t: float) -> None:
        r.generated += 1
        if r.first_token_s is None:
            r.first_token_s = t
        if tok is not None:
            r.output.append(tok)
        if r.generated >= r.max_new_tokens:
            r.done = True
            r.finish_s = t
            self._kv_in_use -= r.kv_tokens
            self._done.append(r)
            del self._active[slot]
            self.backend.release(slot)

    def step(self) -> bool:
        """One scheduler iteration: intake due arrivals, then either form
        an admission batch or run one decode round. Returns False when the
        run is drained (nothing pending, queued, or live)."""
        if not (self._pending or self._q or self._active):
            return False
        self._intake(self.backend.now())
        active = self._active

        if not active:
            if not self._q:
                if not self._pending:   # intake shed the last arrivals
                    return False
                # idle: jump to the next arrival
                self.backend.advance_to(self._pending[0].arrival_s)
                self._intake(self.backend.now())
                return True
            batch = []
            while len(batch) < self.backend.n_slots and self._next_admits(batch):
                batch.append(self._admit())
            if not batch:
                # head-of-line blocked with nothing in flight: only
                # reachable when budget < kv_tokens, which _oversized()
                # already shed — defensive guard
                self._reject(self._q.popleft())
                return True
            first = self.backend.start_batch(batch)
            t = self.backend.now()
            for slot, r in enumerate(batch):
                active[slot] = r
            for slot, (r, tok) in enumerate(zip(batch, first)):
                self._emit(r, slot, tok, t)
            self.metrics.set_gauge("peak_active", len(batch))
            return True

        # one decode round for every live slot; speculative backends emit
        # several committed tokens per round, and tokens past max_new are
        # dropped (the backend over-decodes padding, never user output)
        emitted = self.backend.decode_active(sorted(active))
        t = self.backend.now()
        for slot, toks in emitted.items():
            if not isinstance(toks, (list, tuple)):
                toks = [toks]
            for tok in toks:
                if slot not in active:
                    break
                self._emit(active[slot], slot, tok, t)

        # continuous batching: refill freed slots mid-flight
        if self.backend.can_join_running and active:
            self._intake(self.backend.now())
            for slot in range(self.backend.n_slots):
                if slot in active:
                    continue
                if not self._next_admits(list(active.values())):
                    break
                r = self._admit()
                active[slot] = r
                self._emit(r, slot, self.backend.join(slot, r),
                           self.backend.now())
            self.metrics.set_gauge("peak_active", len(active))
        return True

    def serve(self, requests: List[Request]) -> List[Request]:
        """Run every request to completion (or rejection); returns them
        all, completion order first, then rejected."""
        self.begin(requests)
        while self.step():
            pass
        return self.finish_run()

    def finish_run(self) -> List[Request]:
        for name in ("spec_stats", "adapt_stats"):
            stats = getattr(self.backend, name, None)
            if stats:             # drafted/accepted, retier counters
                self.metrics.update(stats)
        return self._done + self._shed
