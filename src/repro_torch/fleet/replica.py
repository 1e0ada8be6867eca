"""One fleet member: a scheduler + backend pair with the fleet-facing
surface the router scores on (counterpart of ``repro.fleet.replica``).

A replica is a full single-pipeline serving stack — its own
`InferenceBackend` (sim or engine, over its own device subset /
`ExecutionPlan`), its own `ContinuousBatchingScheduler`, its own KV pool
and radix cache. The fleet layer never reaches into those; it sees only:

  load        queue_depth / in_flight / free_kv_frac — the router's
              congestion signals, read live between steps
  affinity    digest() — the radix cache's cumulative-hash summary
              (prefixcache/digest.py), what prefix-affinity scores against
  lifecycle   draining / live / retired_s — elastic membership state
              (Fleet.drain / Fleet.join drive these)

step() wraps `scheduler.step()` with this replica's trace namespace and
clock: N replicas share ONE tracer ring, so each step temporarily rewrites
track names to "rK:..." and points the tracer clock at this replica's
backend — the Chrome exporter then renders one Perfetto process group per
replica.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.obs.trace import get_tracer
from repro_torch.prefixcache.digest import PrefixDigest
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, SchedulerConfig)


class Replica:
    """A named single-pipeline serving stack inside a fleet."""

    def __init__(self, index: int, backend,
                 config: SchedulerConfig = SchedulerConfig(),
                 name: Optional[str] = None):
        self.index = index
        self.name = name or f"r{index}"
        self.backend = backend
        self.sched = ContinuousBatchingScheduler(backend, config)
        self.draining = False          # admits stopped, in-flight finishing
        self.live = True               # member of the fleet
        self.joined_s = 0.0            # when it entered the score table
        self.retired_s: Optional[float] = None  # drain completed
        self.routed = 0                # requests the router ever sent here

    # -- load signals ------------------------------------------------------------
    def now(self) -> float:
        return self.backend.now()

    @property
    def queue_depth(self) -> int:
        return self.sched.queue_depth

    @property
    def in_flight(self) -> int:
        return self.sched.in_flight

    @property
    def outstanding(self) -> int:
        return self.sched.outstanding

    def health(self) -> float:
        """SLO health in [0, 1] from an attached SLOEngine: 1.0 while every target holds (or no engine is attached), 0
        under runaway burn. The router subtracts w_health * (1 - health)
        from this replica's score, shedding traffic off a breaching
        replica."""
        slo = getattr(self.sched, "slo", None)
        return slo.health if slo is not None else 1.0

    def free_kv_frac(self) -> float:
        """Free device-tier KV as a fraction of capacity (1.0 when the
        replica is not page-managed — no KV pressure signal to score)."""
        if not self.sched.paged:
            return 1.0
        pool = self.sched.mgr.pool
        cap = pool.cfg.device_pages
        return pool.free_pages() / cap if cap > 0 else 1.0

    @property
    def page_size(self) -> int:
        return self.sched.config.page_size

    # -- affinity ----------------------------------------------------------------
    def digest(self) -> Optional[PrefixDigest]:
        """The radix cache's router-side summary; None when no cache."""
        p = self.sched.prefix
        return p.digest() if p is not None else None

    # -- work --------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.routed += 1
        self.sched.submit(req)

    def has_work(self, until: Optional[float] = None) -> bool:
        """True when a step() would make progress: live work, or a pending
        arrival due by `until` (None: ever). Prevents idle replicas from
        jumping their clock past a routing decision the fleet has not made
        yet."""
        s = self.sched
        if s.has_live_work:
            return True
        nxt = s.next_pending_s
        return nxt is not None and (until is None or nxt <= until)

    def step(self) -> bool:
        """One scheduler iteration under this replica's trace namespace
        and clock (restored afterwards — the ring is shared)."""
        tr = get_tracer()
        if tr is None:
            return self.sched.step()
        prev_ns, prev_clock = tr.namespace, tr.clock
        tr.namespace, tr.clock = self.name, self.backend.now
        try:
            return self.sched.step()
        finally:
            tr.namespace, tr.clock = prev_ns, prev_clock

    def finish(self) -> List[Request]:
        """Drain-time accounting for this replica (scheduler.finish_run)."""
        return self.sched.finish_run()

    def __repr__(self) -> str:
        state = "draining" if self.draining else \
            ("live" if self.live else "retired")
        return (f"Replica({self.name}, {state}, q={self.queue_depth}, "
                f"active={self.in_flight}, routed={self.routed})")
