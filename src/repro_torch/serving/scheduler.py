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

  prefix      with SchedulerConfig.prefix_cache (paged admission only) a
              radix prefix cache over the admission pool: a matched
              page-aligned prompt prefix forks copy-on-write into the
              request's block table and only the uncached suffix is
              prefilled; finished requests (and speculative commits with
              real ids) donate their pages; cached pages are reclaimed
              first under pool pressure. A real backend keeps its own
              radix tree over its real KV pages instead (prefix_stats).
  chunking    with SchedulerConfig.prefill_chunk_tokens, on backends that
              expose decode_mixed (the simulator), prompts drain chunk by
              chunk through mixed rounds beside the live decode streams.

Speculative backends emit a list of committed tokens per round; paged
growth reserves a whole round (k + 1 tokens). The backend's spec, retier
and radix prefix-cache counters join the stats at the end of a run. The
JAX scheduler's decisions are reproduced exactly (same admissions,
preemptions, resumes, reclaims, prefix hits and chunks on the same
stream), and so are its flight-recorder events (obs/trace: the request
lifecycle on "req:<rid>", occupancy counters, reclaims), its SLO feeds
(attach_slo) and the load signals a dashboard or the fleet router reads
(queue_depth, in_flight, outstanding, free_kv_pages).

The loop is a resumable state machine, as the JAX package's: begin()
installs a run, step() runs one iteration (one admission wave or one
decode round), submit() delivers an arrival mid-run, finish_run() does
the drain-time accounting; serve() composes them. The fleet
(repro_torch.fleet) co-steps N replica schedulers this way.

The loop is clock-agnostic: `backend.now()` is whatever the backend says;
an installed tracer's clock is bound to it at construction, so every
event of a run shares the backend's timebase.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.kvcache import PagedKVConfig, PagedKVManager, PagePool
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import get_tracer, req_track


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
    prefix_cache: bool = False               # radix KV reuse over the
                                             # admission pool (needs
                                             # kv_policy="paged" and
                                             # token-bearing requests)
    prefill_chunk_tokens: Optional[int] = None   # split prompt processing
                                                 # into chunks that ride
                                                 # mixed rounds with decode
                                                 # (None = monolithic)
    hist_capacity: Optional[int] = None      # bounded-memory histograms
                                             # (obs.sketch reservoir of
                                             # this many samples; None =
                                             # exact raw-sample mode)


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
        # radix prefix cache: shares the paged pool; matched prompt
        # prefixes fork copy-on-write into fresh block tables and only the
        # uncached suffix is prefilled
        if config.prefix_cache and not self.paged:
            raise ValueError("prefix_cache needs kv_policy='paged' "
                             "(the radix tree shares the page pool)")
        self.prefix = None
        if config.prefix_cache and self.paged:
            from repro_torch.prefixcache import RadixPrefixCache
            self.prefix = RadixPrefixCache(self.mgr.pool)
        # chunked prefill: prompts are processed prefill_chunk_tokens at a
        # time in mixed rounds beside live decode streams, only on
        # backends that expose decode_mixed (the simulator); epoch
        # backends chunk inside their own prefill
        self.chunk = config.prefill_chunk_tokens
        self._mixed = getattr(backend, "decode_mixed", None) \
            if self.chunk else None
        self._fill: Dict[int, int] = {}   # rid -> prefill tokens remaining
        self.metrics = MetricsRegistry(hist_capacity=config.hist_capacity)
        for k in ("kv_pages_spilled", "kv_pages_fetched",
                  "kv_migrated_bytes", "prefix_lookups", "prefix_hits",
                  "cached_tokens", "prefill_tokens_saved",
                  "prefix_pages", "prefix_evicted_pages"):
            self.metrics.counter(k)
        self.metrics.gauge("peak_active")
        self.metrics.gauge("peak_kv_pages")
        # flight recorder: when a tracer is installed, slave its clock to
        # the backend's, so every event this run emits shares one timebase
        self._tr = get_tracer()
        if self._tr is not None:
            self._tr.clock = backend.now
        # online SLO engine (attach_slo): finishes and rejections feed its
        # burn-rate windows, its pressure reaches the backend's planner
        self.slo = None
        self._slo_pressure_fn = getattr(backend, "note_slo_pressure", None)
        # empty run state, so the load signals read sanely before begin()
        self.begin([])

    @property
    def stats(self) -> Dict[str, float]:
        """Flat stats view (the registry is the source of truth)."""
        return self.metrics.to_stats_dict()

    def attach_slo(self, engine) -> None:
        """Install an obs.slo.SLOEngine: every finish and rejection from
        now on feeds its burn-rate windows."""
        self.slo = engine

    def _note_slo(self, req: Request, now: float,
                  rejected: bool = False) -> None:
        if self.slo is None:
            return
        if rejected:
            self.slo.observe_reject(req, now)
        else:
            self.slo.observe_request(req, now)
        if self._slo_pressure_fn is not None:
            self._slo_pressure_fn(self.slo.pressure())

    def _page_bytes(self) -> float:
        fn = getattr(self.backend, "kv_bytes_per_token", None)
        return (fn() if fn else 0.0) * self.config.page_size

    # -- admission -------------------------------------------------------------
    def _lookup(self, req: Request):
        """Radix match for `req`'s prompt, capped below the last prompt
        token (page-aligned) so at least one token is always prefilled.
        Returns (shared page ids, matched token count)."""
        if self.prefix is None or req.prompt is None or req.preempted:
            # a resumed request re-enters with its own pages (spill) or a
            # pending recompute span: forking would double-count
            return [], 0
        cap = (req.prompt_len - 1) // self.config.page_size
        return self.prefix.match(req.prompt, max_pages=cap)

    def _admits(self, req: Request, active_count: int = 0) -> bool:
        if self.kv_budget is None:
            return True
        if self.paged:
            # watermark: keep one free page per already-resident request
            # (each wants another page within page_size steps)
            need = req.prefill_tokens + 1
            if self.prefix is not None:
                # a prefix hit needs pages for the uncached suffix only
                pages, _ = self._lookup(req)
                if self.mgr.can_admit_prefix(need, pages,
                                             headroom_pages=active_count):
                    return True
                # pool pressure: cached pages go first (the cold
                # requirement bounds the hit's actual shortfall)
                short = self.mgr.pool.pages_for(need) \
                    + active_count - self.mgr.pool.free_pages()
                if short > 0 and self._evict_cached(short):
                    pages, _ = self._lookup(req)   # eviction may have
                    if self.mgr.can_admit_prefix(  # pruned the match
                            need, pages, headroom_pages=active_count):
                        return True
                # then retier headroom, for the prefix requirement's
                # shortfall (only the uncached suffix needs fresh pages)
                pages, _ = self._lookup(req)
                short = self.mgr.pool.pages_for(need) - len(pages) \
                    + active_count - self.mgr.pool.free_pages()
                if short > 0 and self._reclaim(short):
                    pages, _ = self._lookup(req)
                    return self.mgr.can_admit_prefix(
                        need, pages, headroom_pages=active_count)
                return False
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
            if self._tr is not None:
                self._tr.instant(tr_ev.RETIER_RECLAIM, track=tr_ev.TRACK_KV,
                                 args={"pages": got, "asked": n_pages})
        return got

    def _evict_cached(self, n_pages: int) -> int:
        """Reclaim device-tier radix pages (the callers are short of
        device capacity; host-tier cached leaves would free the wrong
        tier)."""
        if self.prefix is None:
            return 0
        from repro_torch.kvcache.pool import DEVICE
        freed = self.prefix.evict(n_pages, tier=DEVICE)
        self.metrics.set("prefix_evicted_pages", self.prefix.evicted_pages)
        return freed

    def _on_admit(self, req: Request) -> None:
        if self.paged:
            if self.prefix is not None:
                pages, ctok = self._lookup(req)
                moved = self.mgr.admit_with_prefix(
                    req.rid, pages, ctok, req.prefill_tokens + 1)
                self._charge(moved)
                req.cached_tokens = ctok
                # hit accounting per admission (the tree's own counters
                # also see head-of-line re-checks)
                self.metrics.inc("prefix_lookups")
                self.metrics.inc("prefix_hits", int(ctok > 0))
                self.metrics.inc("prefill_tokens_saved", ctok)
            else:
                self.mgr.admit(req.rid, req.prefill_tokens + 1)
        else:
            self._kv_in_use += req.kv_tokens

    def _on_finish(self, req: Request) -> None:
        if self.paged:
            self._maybe_insert(req)
            self.mgr.release(req.rid)
        else:
            self._kv_in_use -= req.kv_tokens

    def _maybe_insert(self, req: Request) -> None:
        """Donate `req`'s committed pages to the radix tree (on finish and
        at speculative commit boundaries), keyed by the tokens whose ids
        are known: the prompt and any real emitted ids (the simulator
        emits None placeholders, which cannot key a page)."""
        if self.prefix is None or req.prompt is None:
            return
        toks = list(req.prompt)
        for t in req.output:
            if t is None:
                break
            toks.append(t)
        table = self.mgr.table(req.rid)
        self.prefix.insert(toks, table.pages,
                           n_tokens=min(len(toks), table.tokens))

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
        if self._tr is not None:
            self._tr.counter("active_requests", track=tr_ev.TRACK_SCHED,
                             active=active_count)
        if self.paged:
            pages = self.mgr.device_pages_in_use()
            self.metrics.set_gauge("peak_kv_pages", pages)
            if self._tr is not None:
                self._tr.counter("kv_pages", track=tr_ev.TRACK_KV,
                                 device=pages)
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
        round of tokens. On a dry pool, evict cached radix pages, reclaim
        retier headroom for the shortfall, then preempt latest-admitted victims until the
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
                # unpinned radix-cached pages go first (they serve future
                # hits, not a live decode), then retier headroom
                if self._evict_cached(need):
                    continue
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
        if self._tr is not None:
            mode = "spill" if self.mgr.table(r.rid).pages else "recompute"
            self._tr.instant(tr_ev.REQ_PREEMPT, track=req_track(r.rid),
                             args={"slot": slot, "mode": mode,
                                   "moved_bytes": moved})
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
        if self._tr is not None:
            self._tr.instant(tr_ev.REQ_RESUME, track=req_track(req.rid),
                             args={"kept_kv": kept,
                                   "moved_bytes": moved})
        return True

    def _trace_lifecycle(self, r: Request) -> None:
        """Emit `r`'s lifecycle spans at completion, rebuilt from the
        timestamps the scheduler records anyway (arrival_s, admitted_s,
        first_token_s, finish_s): emitted at finish, not live, a long
        run's request spans survive the ring's wraparound."""
        tr = self._tr
        track = req_track(r.rid)
        if r.admitted_s is not None:
            tr.complete(tr_ev.REQ_QUEUE, ts=r.arrival_s,
                        dur=r.admitted_s - r.arrival_s, track=track)
            if r.first_token_s is not None:
                tr.complete(tr_ev.REQ_PREFILL, ts=r.admitted_s,
                            dur=r.first_token_s - r.admitted_s,
                            track=track,
                            args={"prompt_len": r.prompt_len,
                                  "cached_tokens": r.cached_tokens})
        if r.first_token_s is not None and r.finish_s is not None:
            tr.complete(tr_ev.REQ_DECODE, ts=r.first_token_s,
                        dur=r.finish_s - r.first_token_s, track=track,
                        args={"generated": r.generated})
        if r.finish_s is not None:
            tr.complete(tr_ev.REQ_SPAN, ts=r.arrival_s,
                        dur=r.finish_s - r.arrival_s, track=track,
                        args={"prompt_len": r.prompt_len,
                              "generated": r.generated,
                              "preempted": r.preempted})
            tr.instant(tr_ev.REQ_FINISH, ts=r.finish_s, track=track)

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

    def submit(self, req: Request) -> None:
        """Deliver one arrival into a running serve (fleet routing),
        keeping `_pending` sorted by arrival time."""
        p = self._pending
        if not p or req.arrival_s >= p[-1].arrival_s:
            p.append(req)
            return
        # out-of-order delivery: rebuild sorted (streams are small)
        self._pending = deque(sorted(list(p) + [req],
                                     key=lambda r: r.arrival_s))

    # -- live load signals (what a dashboard and the router read) ----------------
    @property
    def queue_depth(self) -> int:
        """Requests accepted but not yet (re-)running."""
        return len(self._q) + len(self._susp)

    @property
    def in_flight(self) -> int:
        """Requests occupying batch slots right now."""
        return len(self._active)

    @property
    def outstanding(self) -> int:
        """Everything submitted and not yet finished or shed."""
        return len(self._pending) + len(self._q) + len(self._susp) \
            + len(self._active)

    def free_kv_pages(self) -> Optional[int]:
        """Device-tier KV headroom in pages (None: not page-managed)."""
        return self.mgr.pool.free_pages() if self.paged else None

    @property
    def has_live_work(self) -> bool:
        """Anything past intake: a step() now does real work regardless
        of the clock."""
        return bool(self._q or self._susp or self._active)

    @property
    def next_pending_s(self) -> Optional[float]:
        """Arrival time of the earliest not-yet-ingested request."""
        return self._pending[0].arrival_s if self._pending else None

    def now(self) -> float:
        return self.backend.now()

    def _reject(self, r: Request) -> None:
        r.rejected = True
        self._shed.append(r)
        if self._tr is not None:
            self._tr.instant(tr_ev.REQ_REJECT, track=req_track(r.rid),
                             args={"prompt_len": r.prompt_len})
        self._note_slo(r, self.backend.now(), rejected=True)

    def _intake(self, now: float) -> None:
        while self._pending and self._pending[0].arrival_s <= now:
            r = self._pending.popleft()
            if self._tr is not None:
                self._tr.instant(tr_ev.REQ_ARRIVE, ts=r.arrival_s,
                                 track=req_track(r.rid),
                                 args={"prompt_len": r.prompt_len,
                                       "max_new": r.max_new_tokens})
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
        tr = self._tr
        if kind == "suspended":
            r = self._susp.popleft()
            self._try_resume(r)
            # the re-entry step emits a token; make room for its KV
            # (best effort: _grow_active preempts if this lost a race)
            self.mgr.extend(r.rid, r.kv_tokens_now + 1)
        else:
            r = self._q.popleft()
            self._on_admit(r)
            if tr is not None and r.cached_tokens > 0:
                tr.instant(tr_ev.REQ_PREFIX_HIT, track=req_track(r.rid),
                           args={"cached_tokens": r.cached_tokens})
        if r.admitted_s is None:
            r.admitted_s = self.backend.now()
        if tr is not None:
            tr.instant(tr_ev.REQ_ADMIT, track=req_track(r.rid),
                       args={"resumed": kind == "suspended",
                             "cached_tokens": r.cached_tokens})
        if self._mixed is not None:
            # chunked prefill: the uncached span drains chunk by chunk
            # through mixed rounds instead of one monolithic pass
            fill_left = self._fill.get(r.rid, 0)
            if kind == "suspended" and fill_left > 0 \
                    and r.cached_tokens > 0:
                # spill-resumed mid-prefill: the KV computed so far came
                # back with the pages; only the remainder still rides
                r.cached_tokens = max(r.prefill_tokens - fill_left, 0)
            else:
                self._fill[r.rid] = max(r.prefill_tokens
                                        - r.cached_tokens, 0)
        return r

    def _finish_req(self, r: Request, slot: int, t: float) -> None:
        r.done = True
        r.finish_s = t
        self._on_finish(r)
        self._done.append(r)
        del self._active[slot]
        self.backend.release(slot)
        if self._tr is not None:
            self._trace_lifecycle(r)
        self._note_slo(r, t)

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
            if self._mixed is not None:
                # chunked: register the slots only; prompts drain through
                # the mixed rounds below, a request's first token emitted
                # when its last chunk lands
                for slot, r in enumerate(batch):
                    active[slot] = r
                    self.backend.attach_slot(slot, r, r.cached_tokens)
                self._note_occupancy(len(batch))
                return True
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
        if self._mixed is not None:
            # mixed round: prefilling slots consume one chunk each,
            # decoding slots commit a round of tokens, all riding the same
            # weight stream
            work = {}
            for slot in sorted(active):
                r = active[slot]
                rem = self._fill.get(r.rid, 0)
                if rem > 0:
                    n = min(self.chunk, rem)
                    work[slot] = ("prefill", n, n == rem)
                    self._fill[r.rid] = rem - n
                else:
                    work[slot] = ("decode",)
            emitted = self._mixed(work)
        else:
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
        # speculative commit boundary: multi-token commits with real ids
        # cross page boundaries mid-flight; donate completed pages now so
        # concurrent same-prefix requests hit without waiting for a finish
        if self.prefix is not None \
                and getattr(self.backend, "spec", None) is not None:
            for r in active.values():
                if r.output:
                    self._maybe_insert(r)

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
                if self._mixed is not None:
                    # chunked: the joiner's prompt drains through the
                    # coming mixed rounds, no join pass
                    self.backend.attach_slot(slot, r, r.cached_tokens)
                    continue
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
        if self.prefix is not None:
            self.metrics.set("cached_tokens", self.prefix.cached_tokens())
            self.metrics.set("prefix_pages", self.prefix.n_pages)
            self.metrics.set("prefix_evicted_pages",
                             self.prefix.evicted_pages)
            names = ("spec_stats", "adapt_stats")
        else:                     # a real backend's own radix tree
            names = ("prefix_stats", "spec_stats", "adapt_stats")
        for name in names:
            stats = getattr(self.backend, name, None)
            if stats:             # radix hits, drafted/accepted, retier
                self.metrics.update(stats)
        return self._done + self._shed
