"""Fleet executor: co-steps N replica schedulers on one timeline
(counterpart of ``repro.fleet.fleet``).

Each replica keeps its own backend clock (virtual time for sim replicas,
wall time for engine replicas). The executor merges three event streams —
request arrivals, scheduled drains, scheduled joins — into time order and,
before acting on an event at time t, steps every replica that still has
*actionable* work due by t, laggard first. A routing decision therefore
sees every replica's true state as of the arrival: queue depths, free KV
pages, and radix digests are live, not start-of-run snapshots.

Elastic membership:

  drain(name, at_s)   at t: the replica stops receiving admits (the
                      router skips draining members) but keeps stepping —
                      every request already routed to it finishes. When
                      its last request drains the replica retires
                      (live=False, retired_s stamped) and the router
                      forgets its sessions/digest.
  join(replica, at_s) at t: the replica's clock is advanced to t and it
                      enters the candidate set; load-based scoring pulls
                      traffic onto the empty newcomer within a few admits
                      (asserted in tests).

run() returns a FleetResult: pooled request records plus per-replica
partitions, from which report() builds the exact merged FleetReport.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import get_tracer
from repro_torch.serving.scheduler import Request

from repro_torch.fleet.replica import Replica
from repro_torch.fleet.report import FleetResult
from repro_torch.fleet.router import FleetRouter, RouterConfig


class Fleet:
    """N replicas + a router + a membership timeline."""

    def __init__(self, replicas: List[Replica],
                 router: Optional[FleetRouter] = None,
                 config: Optional[RouterConfig] = None):
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas: List[Replica] = list(replicas)
        self.router = router if router is not None \
            else FleetRouter(config or RouterConfig())
        self._events = []            # (at_s, seq, kind, payload)
        self._seq = 0
        self.shed: List[Request] = []

    def replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica {name!r}; "
                       f"have {[r.name for r in self.replicas]}")

    # -- elastic membership ------------------------------------------------------
    def drain(self, name: str, at_s: float = 0.0) -> None:
        """Schedule `name` to stop receiving admits at `at_s`; it retires
        once every request already routed to it has finished."""
        self.replica(name)                       # fail fast on a typo
        self._events.append((at_s, self._seq, "drain", name))
        self._seq += 1
        self._events.sort(key=lambda e: (e[0], e[1]))

    def join(self, replica: Replica, at_s: float = 0.0) -> None:
        """Schedule `replica` to enter the candidate set at `at_s`."""
        if any(r.name == replica.name for r in self.replicas):
            raise ValueError(f"replica {replica.name!r} already present")
        self._events.append((at_s, self._seq, "join", replica))
        self._seq += 1
        self._events.sort(key=lambda e: (e[0], e[1]))

    def _apply_membership(self, until: float) -> None:
        tr = get_tracer()
        while self._events and self._events[0][0] <= until:
            at_s, _, kind, payload = self._events.pop(0)
            if kind == "drain":
                rep = self.replica(payload)
                rep.draining = True
                if tr is not None:
                    tr.instant(tr_ev.FLEET_DRAIN, ts=at_s,
                               track=tr_ev.TRACK_ROUTER,
                               args={"replica": rep.name,
                                     "outstanding": rep.outstanding})
                self._maybe_retire(rep)          # idle drain: immediate
            else:                                # join
                rep: Replica = payload
                rep.backend.advance_to(at_s)
                rep.live = True
                rep.joined_s = at_s
                self.replicas.append(rep)
                if tr is not None:
                    tr.instant(tr_ev.FLEET_JOIN, ts=at_s,
                               track=tr_ev.TRACK_ROUTER,
                               args={"replica": rep.name})

    def _maybe_retire(self, rep: Replica) -> None:
        if rep.draining and rep.live and rep.outstanding == 0:
            rep.live = False
            rep.retired_s = rep.now()
            self.router.forget(rep.name)
            tr = get_tracer()
            if tr is not None:
                tr.instant(tr_ev.FLEET_DRAINED, ts=rep.retired_s,
                           track=tr_ev.TRACK_ROUTER,
                           args={"replica": rep.name})

    # -- co-stepping -------------------------------------------------------------
    def _advance(self, until: float) -> None:
        """Step every replica with actionable work due by `until` whose
        clock lags it, laggard first — replica states are current as of
        `until` when this returns."""
        while True:
            cands = [r for r in self.replicas
                     if r.live and r.now() < until and r.has_work(until)]
            if not cands:
                return
            rep = min(cands, key=lambda r: (r.now(), r.index))
            rep.step()
            self._maybe_retire(rep)

    def _drain_all(self) -> None:
        """Run every replica to completion (end of the arrival stream)."""
        while True:
            busy = [r for r in self.replicas if r.live and r.has_work()]
            if not busy:
                return
            rep = min(busy, key=lambda r: (r.now(), r.index))
            rep.step()
            self._maybe_retire(rep)

    # -- the run loop ------------------------------------------------------------
    def run(self, requests: List[Request]) -> FleetResult:
        """Route and serve `requests` (plus any scheduled drain/join
        events) to completion."""
        arrivals = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        for req in arrivals:
            t = req.arrival_s
            self._advance(t)
            self._apply_membership(t)
            target = self.router.route(req, self.replicas)
            if target is None:
                req.rejected = True
                self.shed.append(req)
                continue
            target.submit(req)
        # membership events past the last arrival still apply (a drain
        # scheduled late must retire its replica before reporting)
        self._apply_membership(math.inf)
        self._drain_all()
        per: Dict[str, List[Request]] = {}
        pooled: List[Request] = list(self.shed)
        for rep in self.replicas:
            recs = rep.finish()
            per[rep.name] = recs
            pooled.extend(recs)
        return FleetResult(requests=pooled, per_replica=per,
                           replicas=list(self.replicas),
                           router=self.router, shed=list(self.shed))
