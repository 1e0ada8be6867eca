"""Continuous-batching scheduler (counterpart of ``repro.serving.scheduler``).

  admission   two policies (SchedulerConfig.kv_policy):
              "reserve" — a request is admitted only when the KV budget
              can hold its worst case (prompt + max_new tokens) beside
              every co-resident request (paper Eq. 5 accounting).
              "paged"   — page-granular: admission allocates
              ceil((prompt+1)/page_size) pages from a two-tier PagePool
              (kvcache/manager.py) and one page per page_size generated
              tokens after that, so co-residency is bounded by actual
              occupancy. Before refusing an admission or preempting, the
              scheduler asks the backend for retier headroom
              (reclaim_kv_pages: demoted resident layers return their HBM
              as pages); when the pool still runs dry mid-generation the
              latest-admitted request is preempted: its pages spill to the
              host tier (fetched back on resume) or are dropped for
              recompute. Every occupancy change is reported to the backend
              (note_kv_pages), whose OnlinePlanner walks its TS ladder on
              it.
  queueing    FIFO past the admission gate; arrivals beyond `max_queue`
              are rejected rather than queued forever. Preempted requests
              resume ahead of fresh admissions.
  batching    up to `backend.n_slots` requests ride the batch. Backends
              that can (`can_join_running`) refill freed slots mid-flight;
              epoch backends (the model's cache fixes batch membership at
              prefill) drain a batch, then form the next.

Speculative backends emit a list of committed tokens per round; paged
growth reserves a whole round (k + 1 tokens). The backend's spec, retier
and radix prefix-cache counters join the stats at the end of a run. The
JAX scheduler's decisions are reproduced exactly (same admissions,
preemptions, resumes and reclaims on the same stream). What it also
carries comes back with the slice that needs it: its own radix prefix
cache over the admission pool and the chunked mixed rounds (only the
simulator backend runs them) with the simulator, tracer calls, SLO feeds
and bounded-memory histograms with the observability slice, and the
fleet's live load signals with the fleet slice.

The loop is clock-agnostic: `backend.now()` is whatever the backend says.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.kvcache import PagedKVConfig, PagedKVManager, PagePool
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
    preempted: int = 0              # times evicted mid-generation
    restart_tokens: int = 0         # recompute-resume: context to re-prefill
    first_token_s: Optional[float] = None
    admitted_s: Optional[float] = None  # left the queue (TTFT split:
                                        # queue wait vs prefill compute)
    finish_s: Optional[float] = None
    session_id: Optional[int] = None    # multiturn conversation id
    cached_tokens: int = 0          # prompt tokens served from a prefix
                                    # cache instead of a prefill round

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
    def kv_tokens_now(self) -> int:
        """Actual KV occupancy in tokens (page-admission currency)."""
        return self.prompt_len + self.generated

    @property
    def prefill_tokens(self) -> int:
        """Context span the backend sees at (re-)admission: the prompt for
        a fresh request, prompt + generated for a resumed one."""
        return self.prompt_len + self.generated

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
    kv_policy: str = "reserve"               # "reserve" | "paged"
    page_size: int = 64                      # paged: tokens per page
    preempt: str = "spill"                   # paged: "spill" | "recompute"
    host_kv_budget_tokens: Optional[int] = None  # paged: spill-tier size
                                                 # (None -> device budget)


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
        # page-granular admission state
        if config.kv_policy not in ("reserve", "paged"):
            raise ValueError(f"kv_policy {config.kv_policy!r}")
        self.paged = config.kv_policy == "paged" and budget is not None
        self.mgr: Optional[PagedKVManager] = None
        if self.paged:
            host = config.host_kv_budget_tokens
            host = budget if host is None else host
            self.mgr = PagedKVManager(PagePool(PagedKVConfig(
                page_size=config.page_size,
                device_pages=budget // config.page_size,
                host_pages=host // config.page_size,
                page_bytes=self._page_bytes())))
            # the pool retiered weight HBM is credited to
            attach = getattr(backend, "attach_page_pool", None)
            if attach:
                attach(self.mgr.pool)
        # tokens a live request can commit in ONE decode round: 1, or up
        # to k+1 when the backend decodes speculatively; paged growth
        # reserves the whole round
        self._round_tokens = 1 + getattr(getattr(backend, "spec", None),
                                         "k", 0)
        self.metrics = MetricsRegistry()
        for k in ("kv_pages_spilled", "kv_pages_fetched",
                  "kv_migrated_bytes"):
            self.metrics.counter(k)
        self.metrics.gauge("peak_active")
        self.metrics.gauge("peak_kv_pages")
        self.begin([])

    @property
    def stats(self) -> Dict[str, float]:
        """Flat stats view (the registry is the source of truth)."""
        return self.metrics.to_stats_dict()

    def _page_bytes(self) -> float:
        fn = getattr(self.backend, "kv_bytes_per_token", None)
        return (fn() if fn else 0.0) * self.config.page_size

    # -- admission -------------------------------------------------------------
    def _admits(self, req: Request, active_count: int = 0) -> bool:
        if self.kv_budget is None:
            return True
        if self.paged:
            # watermark: keep one free page per already-resident request
            # (each wants another page within page_size steps)
            need = req.prefill_tokens + 1
            if self.mgr.can_admit(need, headroom_pages=active_count):
                return True
            # retier headroom: before refusing, ask the backend to demote
            # resident layers; their HBM grows the device tier
            short = self.mgr.pool.pages_for(need) + active_count \
                - self.mgr.pool.free_pages()
            if short > 0 and self._reclaim(short):
                return self.mgr.can_admit(need, headroom_pages=active_count)
            return False
        return self._kv_in_use + req.kv_tokens <= self.kv_budget

    def _reclaim(self, n_pages: int) -> int:
        """Ask the backend for retier headroom (demote resident layers ->
        device KV pages; no-op on backends without online adaptation).
        Ordered before preemption: retiering costs steady-state load,
        preemption costs a live request its progress."""
        fn = getattr(self.backend, "reclaim_kv_pages", None)
        if fn is None:
            return 0
        got = fn(n_pages)
        if got:
            self.metrics.inc("retier_reclaimed_pages", got)
        return got

    def _on_admit(self, req: Request) -> None:
        if self.paged:
            self.mgr.admit(req.rid, req.prefill_tokens + 1)
        else:
            self._kv_in_use += req.kv_tokens

    def _on_finish(self, req: Request) -> None:
        if self.paged:
            self.mgr.release(req.rid)
        else:
            self._kv_in_use -= req.kv_tokens

    def _oversized(self, req: Request) -> bool:
        """Can never be served, even on an idle backend. Paged capacity is
        page-rounded: floor(budget / page_size) whole pages."""
        if self.max_request is not None and req.kv_tokens > self.max_request:
            return True
        if self.kv_budget is None:
            return False
        if self.paged:
            return self.mgr.pool.pages_for(req.kv_tokens) \
                > self.mgr.pool.cfg.device_pages
        return req.kv_tokens > self.kv_budget

    def _note_occupancy(self, active_count: int) -> None:
        self.metrics.set_gauge("peak_active", active_count)
        if self.paged:
            pages = self.mgr.device_pages_in_use()
            self.metrics.set_gauge("peak_kv_pages", pages)
            note = getattr(self.backend, "note_kv_pages", None)
            if note:
                note(pages, self.config.page_size)

    def _charge(self, nbytes: float) -> None:
        if nbytes:
            fn = getattr(self.backend, "charge_transfer", None)
            if fn:
                fn(nbytes)

    # -- paged growth + preemption ----------------------------------------------
    def _grow_active(self, active: Dict[int, Request],
                     order: List[int], suspended: Deque[Request]) -> None:
        """Before a decode round every live request needs room for one more
        round of tokens. On a dry pool, reclaim retier headroom for the
        shortfall, then preempt latest-admitted victims until the
        extension fits; a request that cannot even self-extend after
        evicting everyone else suspends itself (defensive: _oversized()
        gates admission)."""
        for slot in list(sorted(active, key=lambda s: order.index(s))):
            r = active.get(slot)
            if r is None:
                continue
            grow_to = r.kv_tokens_now + min(self._round_tokens,
                                            max(r.max_new_tokens
                                                - r.generated, 1))
            while not self.mgr.extend(r.rid, grow_to):
                need = self.mgr.pool.pages_for(grow_to) \
                    - self.mgr.pages_of(r.rid)
                # reclaim only the shortfall past the free pages: the
                # gross requirement would over-demote resident layers
                short = need - self.mgr.pool.free_pages()
                if short > 0 and self._reclaim(short):
                    continue
                victims = [s for s in sorted(active,
                                             key=lambda s: order.index(s),
                                             reverse=True) if s != slot]
                victim = victims[0] if victims else slot
                self._preempt(victim, active, suspended)
                if victim == slot:
                    break

    def _preempt(self, slot: int, active: Dict[int, Request],
                 suspended: Deque[Request]) -> None:
        if not getattr(self.backend, "resumes_preempted", True):
            r = active[slot]
            raise RuntimeError(
                f"request {r.rid} must be preempted ({self.mgr.pool.free_pages()} "
                f"free KV pages), but {type(self.backend).__name__} resumes a "
                f"request from its prompt alone and would drop the "
                f"{r.generated} tokens it generated: raise kv_budget_tokens or "
                f"give the engine retier headroom")
        r = active.pop(slot)
        r.preempted += 1
        moved = self.mgr.preempt(r.rid, self.config.preempt)
        self._charge(moved)
        if not self.mgr.table(r.rid).pages:   # recompute (or spill fallback)
            r.restart_tokens = r.kv_tokens_now
        suspended.append(r)
        self.backend.release(slot)

    def _try_resume(self, req: Request) -> bool:
        kept = bool(self.mgr.table(req.rid).pages)   # spilled, not dropped
        moved = self.mgr.resume(req.rid)
        if moved is None:
            return False
        self._charge(moved)
        req.restart_tokens = 0        # resumed: no pending recompute span
        # a spill kept the KV: the re-entry step prefills nothing;
        # recompute re-prefills the whole span
        req.cached_tokens = req.kv_tokens_now if kept else 0
        return True

    # -- run state ---------------------------------------------------------------
    def begin(self, requests: List[Request]) -> None:
        """Install a run: requests sorted by arrival, nothing admitted."""
        self._pending: Deque[Request] = deque(
            sorted(requests, key=lambda r: r.arrival_s))
        self._q: Deque[Request] = deque()
        self._susp: Deque[Request] = deque()  # preempted, resume first
        self._active: Dict[int, Request] = {}  # slot -> request
        self._order: List[int] = []            # admission order of slots
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

    def _next_candidate(self, batch):
        """Head-of-line pick: suspended (resume) before fresh."""
        n_resident = len(self._active) + len(batch)
        if self._susp:
            r = self._susp[0]
            if not self.mgr.can_resume(r.rid, headroom_pages=n_resident):
                return None
            if self._fits_batch is not None and batch \
                    and not self._fits_batch(batch, r):
                return None
            return "suspended"
        if self._q:
            r = self._q[0]
            if not self._admits(r, n_resident):
                return None
            if self._fits_batch is not None and batch \
                    and not self._fits_batch(batch, r):
                return None
            return "queue"
        return None

    def _pop_candidate(self, kind) -> Request:
        if kind == "suspended":
            r = self._susp.popleft()
            self._try_resume(r)
            # the re-entry step emits a token; make room for its KV
            # (best effort: _grow_active preempts if this lost a race)
            self.mgr.extend(r.rid, r.kv_tokens_now + 1)
        else:
            r = self._q.popleft()
            self._on_admit(r)
        if r.admitted_s is None:
            r.admitted_s = self.backend.now()
        return r

    def _finish_req(self, r: Request, slot: int, t: float) -> None:
        r.done = True
        r.finish_s = t
        self._on_finish(r)
        self._done.append(r)
        del self._active[slot]
        self.backend.release(slot)

    def _emit(self, r: Request, slot: int, tok, t: float) -> bool:
        """Count one emitted token; True when it finished the request."""
        r.generated += 1
        if r.first_token_s is None:
            r.first_token_s = t
        if tok is not None:
            r.output.append(tok)
        if r.generated >= r.max_new_tokens:
            self._finish_req(r, slot, t)
            return True
        return False

    def step(self) -> bool:
        """One scheduler iteration: intake due arrivals, then either form
        an admission batch or run one decode round. Returns False when the
        run is drained (nothing pending, queued, suspended or live)."""
        pending, queue = self._pending, self._q
        suspended, active = self._susp, self._active
        if not (pending or queue or suspended or active):
            return False
        self._intake(self.backend.now())

        if not active:
            if not queue and not suspended:
                if not pending:   # intake shed the last arrivals
                    return False
                # idle: jump to the next arrival
                self.backend.advance_to(pending[0].arrival_s)
                self._intake(self.backend.now())
                return True
            batch = []
            while len(batch) < self.backend.n_slots:
                kind = self._next_candidate(batch)
                if kind is None:
                    break
                batch.append(self._pop_candidate(kind))
            if not batch:
                # head-of-line blocked with nothing in flight: only
                # reachable when budget < kv_tokens, which _oversized()
                # already shed — defensive guard
                if suspended:
                    r = suspended.popleft()
                    self.mgr.release(r.rid)   # don't leak its pages
                else:
                    r = queue.popleft()
                self._reject(r)
                return True
            self._order = list(range(len(batch)))
            first = self.backend.start_batch(batch)
            t = self.backend.now()
            for slot, (r, tok) in enumerate(zip(batch, first)):
                active[slot] = r
                self._emit(r, slot, tok, t)
            self._note_occupancy(len(batch))
            return True

        # one decode round for every live slot
        if self.paged:
            self._grow_active(active, self._order, suspended)
            self._note_occupancy(len(active))
            if not active:
                return True       # everyone preempted (defensive)
        emitted = self.backend.decode_active(sorted(active))
        t = self.backend.now()
        for slot, toks in emitted.items():
            r = active.get(slot)
            if r is None:         # preempted out of this round
                continue
            # speculative backends emit several committed tokens per
            # round; tokens past max_new are dropped (the backend
            # over-decodes padding, never user output)
            if not isinstance(toks, (list, tuple)):
                toks = [toks]
            for tok in toks:
                if self._emit(r, slot, tok, t):
                    break

        # continuous batching: refill freed slots mid-flight
        if self.backend.can_join_running and active:
            self._intake(self.backend.now())
            free = [s for s in range(self.backend.n_slots)
                    if s not in active]
            for slot in free:
                kind = self._next_candidate(list(active.values()))
                if kind is None:
                    break
                r = self._pop_candidate(kind)
                active[slot] = r
                if slot in self._order:
                    self._order.remove(slot)
                self._order.append(slot)
                self._emit(r, slot, self.backend.join(slot, r),
                           self.backend.now())
            self._note_occupancy(len(active))
        return True

    def serve(self, requests: List[Request]) -> List[Request]:
        """Run every request to completion (or rejection); returns them
        all, completion order first, then rejected."""
        self.begin(requests)
        while self.step():
            pass
        return self.finish_run()

    def finish_run(self) -> List[Request]:
        """Drain-time accounting: fold the pool's and the backend's
        counters into the registry and return every request record."""
        if self.paged:
            pool = self.mgr.pool
            self.metrics.set("kv_pages_spilled", pool.spilled_pages)
            self.metrics.set("kv_pages_fetched", pool.fetched_pages)
            self.metrics.set("kv_migrated_bytes", pool.migrated_bytes)
        for name in ("prefix_stats", "spec_stats", "adapt_stats"):
            stats = getattr(self.backend, name, None)
            if stats:             # radix hits, drafted/accepted, retier
                self.metrics.update(stats)
        return self._done + self._shed
