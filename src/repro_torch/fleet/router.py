"""FleetRouter: scored request placement across pipeline replicas
(counterpart of ``repro.fleet.router``).

Placement is a pure function of (request, replica states, router state),
so the same stream against the same fleet always routes identically —
the determinism property tests/test_torch_fleet.py asserts. Four policies:

  roundrobin  cycle over non-draining replicas (baseline)
  random      seeded uniform choice (baseline the bench beats)
  sticky      session affinity + load (no token inspection)
  prefix      the full score (default):

    score(r) = w_prefix * overlap(r) + w_sticky * [home(session) == r]
             - w_queue * queue_depth(r)/n_slots - w_kv * (1 - free_kv(r))
             - w_health * (1 - health(r))

  health(r) is the replica's SLO health: 1.0 when no
  SLOEngine is attached or every target holds, falling toward 0 under
  burn — traffic sheds away from a breaching replica before its queue
  compounds the breach.

  overlap(r) is the matched-prefix *fraction* of the prompt against
  replica r's digest — the live radix summary unioned with an
  *optimistic* digest of prompts already routed there (so the second
  request of a template sticks before the first one finishes).

Two stabilizers keep the score from thrashing:

  hysteresis  a sticky session moves off its incumbent replica only when
              a challenger beats the incumbent's score by `hysteresis` —
              near-ties don't flap a conversation between replicas (each
              flap abandons cached KV).
  spillover   when the chosen replica is saturated (queue_depth >=
              saturation_queue) the request spills to the least-loaded
              live replica instead — affinity is a latency optimization,
              not a correctness constraint, and a saturated favorite
              would cost more in queueing than the prefix hit saves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import get_tracer
from repro_torch.prefixcache.digest import PrefixDigest
from repro_torch.serving.scheduler import Request

from repro_torch.fleet.replica import Replica

POLICIES = ("prefix", "sticky", "random", "roundrobin")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    policy: str = "prefix"        # one of POLICIES
    w_prefix: float = 1.0         # per unit matched-prefix fraction
    w_sticky: float = 0.5         # incumbent-home bonus
    w_queue: float = 0.25         # per queued request (slot-normalized)
    w_kv: float = 0.25            # per unit KV fullness
    w_health: float = 1.0         # per unit SLO unhealth (1 - health)
    saturation_queue: int = 8     # spillover threshold (queue depth)
    hysteresis: float = 0.15      # margin to move a sticky session
    seed: int = 0                 # random policy / any future jitter

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown router policy {self.policy!r}; "
                             f"have {POLICIES}")


class FleetRouter:
    """Stateful placement: score table + session homes + optimistic
    digests. One instance per fleet."""

    def __init__(self, config: RouterConfig = RouterConfig()):
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._rr = 0                                  # roundrobin cursor
        self._home: Dict[int, str] = {}               # session -> replica
        self._optimistic: Dict[str, PrefixDigest] = {}
        self.stats: Dict[str, float] = {
            "routed": 0, "spillover": 0, "sticky_kept": 0,
            "sticky_moved": 0, "prefix_matched": 0, "no_replica": 0,
        }

    # -- scoring -----------------------------------------------------------------
    def _overlap(self, req: Request, rep: Replica) -> float:
        """Matched-prefix fraction of the prompt on `rep` (live digest
        unioned with optimistically-routed prompts)."""
        if req.prompt is None or req.prompt_len <= 0:
            return 0.0
        matched = 0
        d = rep.digest()
        if d is not None:
            matched = d.match_tokens(req.prompt)
        opt = self._optimistic.get(rep.name)
        if opt is not None:
            matched = max(matched, opt.match_tokens(req.prompt))
        return matched / req.prompt_len

    def score(self, req: Request, rep: Replica) -> float:
        cfg = self.config
        s = 0.0
        if cfg.policy == "prefix":
            s += cfg.w_prefix * self._overlap(req, rep)
        if req.session_id is not None \
                and self._home.get(req.session_id) == rep.name:
            s += cfg.w_sticky
        s -= cfg.w_queue * rep.queue_depth / max(rep.backend.n_slots, 1)
        s -= cfg.w_kv * (1.0 - rep.free_kv_frac())
        s -= cfg.w_health * (1.0 - rep.health())
        return s

    # -- placement ---------------------------------------------------------------
    def route(self, req: Request,
              replicas: List[Replica]) -> Optional[Replica]:
        """Pick the replica for `req`, or None when no live non-draining
        replica exists. Updates session homes / optimistic digests."""
        cfg = self.config
        cands = sorted((r for r in replicas if r.live and not r.draining),
                       key=lambda r: r.index)
        if not cands:
            self.stats["no_replica"] += 1
            return None
        spilled = False
        if cfg.policy == "roundrobin":
            pick = cands[self._rr % len(cands)]
            self._rr += 1
        elif cfg.policy == "random":
            pick = cands[int(self._rng.integers(0, len(cands)))]
        else:                                   # scored: sticky | prefix
            scores = {r.name: self.score(req, r) for r in cands}
            pick = max(cands, key=lambda r: (scores[r.name], -r.index))
            home = self._home.get(req.session_id) \
                if req.session_id is not None else None
            if home is not None and home != pick.name:
                inc = next((r for r in cands if r.name == home), None)
                if inc is not None and scores[pick.name] \
                        < scores[inc.name] + cfg.hysteresis:
                    pick = inc                  # challenger inside margin
                    self.stats["sticky_kept"] += 1
                else:
                    self.stats["sticky_moved"] += 1
            elif home is not None:
                self.stats["sticky_kept"] += 1
            if pick.queue_depth >= cfg.saturation_queue:
                alt = min(cands, key=lambda r: (r.queue_depth, r.index))
                if alt is not pick \
                        and alt.queue_depth < cfg.saturation_queue:
                    pick, spilled = alt, True
                    self.stats["spillover"] += 1
            if cfg.policy == "prefix" and self._overlap(req, pick) > 0:
                self.stats["prefix_matched"] += 1
        # bookkeeping: the session now lives where the request landed, and
        # (prefix policy) the routed prompt's chain is optimistically
        # assumed cached there
        if req.session_id is not None and cfg.policy in ("prefix",
                                                         "sticky"):
            self._home[req.session_id] = pick.name
        if cfg.policy == "prefix" and req.prompt is not None:
            opt = self._optimistic.get(pick.name)
            if opt is None:
                opt = self._optimistic[pick.name] = \
                    PrefixDigest(pick.page_size)
            opt.add_prompt(req.prompt,
                           max_pages=(req.prompt_len - 1) // pick.page_size)
        self.stats["routed"] += 1
        tr = get_tracer()
        if tr is not None:
            tr.instant(tr_ev.FLEET_ROUTE, ts=req.arrival_s,
                       track=tr_ev.TRACK_ROUTER,
                       args={"rid": req.rid, "to": pick.name,
                             "policy": cfg.policy, "spillover": spilled})
        return pick

    def forget(self, name: str) -> None:
        """Drop a retired replica from router state (drain completion):
        its sessions re-home on their next turn, its optimistic digest
        dies with its cache."""
        self._optimistic.pop(name, None)
        self._home = {s: n for s, n in self._home.items() if n != name}
