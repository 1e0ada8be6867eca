"""Online SLO engine: declarative targets, multi-window burn-rate alerts,
and a live health signal (DESIGN.md §17).

The flight recorder (obs/trace) *records* what happened; this module
*judges* it while serving. The model is the SRE burn-rate alert (Google SRE workbook
ch. 5), adapted to the backend clock so the same engine evaluates a
discrete-event sim run and a wall-clock engine run identically:

  target      a declarative objective: "metric M must be good for at
              least `target` of events", where good is `value <= threshold`
              for latency metrics and non-occurrence for event metrics
              (reject). The error budget is 1 - target.
  burn rate   bad_fraction(window) / error_budget: 1.0 means the budget
              is being spent exactly at sustainable pace, B means B x
              faster. Evaluated over TWO windows (fast + slow): the fast
              window makes alerts prompt, the slow window makes them
              *sticky to real trouble* — a single bad request in an idle
              second spikes the fast burn but not the slow one, so no
              alert. Breach fires when BOTH windows burn above
              `burn_threshold`; recovery requires the fast window back
              under threshold x recovery_frac (hysteresis, no flapping).
  health      1.0 while every target holds; a breaching target pulls
              health toward 0 as 1/(1 + excess burn). The FleetRouter
              subtracts w_health x (1 - health) from a replica's score —
              traffic sheds away from a breaching replica — and backends
              forward (1 - health) to the OnlinePlanner as pressure,
              which scales its TS thresholds so weight demotion frees KV
              *before* the next admission would queue.

All state is bounded: per-target one WindowedCounter ring (sized to the
slow window) and one ReservoirSketch for the dashboard's live percentile
readout. Nothing here retains per-request records.

Copied from ``repro.obs.slo`` with the imports pointed at the port: the
PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the framework-free modules.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import get_tracer
from repro_torch.obs.sketch import ReservoirSketch, WindowedCounter

# metric vocabulary: how a request record maps to per-event observations
#   ttft     first_token_s - arrival_s        (seconds; threshold-judged)
#   tpot     (finish-first)/(generated-1)     (seconds/token; threshold)
#   latency  finish_s - arrival_s             (seconds; threshold-judged)
#   goodput  finished within latency threshold (same observation stream as
#            latency — a separate target name for a separate budget)
#   reject   request shed at intake           (occurrence is bad)
METRICS = ("ttft", "tpot", "latency", "goodput", "reject")


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One declarative objective, burn-rate evaluated."""
    name: str                     # "ttft_p99" — report/alert key
    metric: str                   # one of METRICS
    threshold_s: float = 0.0      # good iff value <= threshold (latency
                                  # metrics; unused for "reject")
    target: float = 0.99          # required good fraction (p99 -> 0.99)
    fast_window_s: float = 30.0   # prompt-alert window
    slow_window_s: float = 300.0  # sustained-burn window
    burn_threshold: float = 4.0   # budget multiple that trips the alert
    recovery_frac: float = 0.5    # fast burn must drop below
                                  # burn_threshold x this to recover

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"unknown SLO metric {self.metric!r}; "
                             f"have {METRICS}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0,1): {self.target}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed slow window")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def default_targets(*, ttft_p99_s: float = 8.0, tpot_p50_s: float = 1.0,
                    latency_p95_s: float = 30.0,
                    reject_target: float = 0.95,
                    fast_window_s: float = 30.0,
                    slow_window_s: float = 300.0,
                    burn_threshold: float = 4.0) -> List[SLOTarget]:
    """The serving defaults --slo enables: TTFT p99, TPOT p50, goodput
    (latency p95), and reject rate. Thresholds are CLI-tunable; the
    shipped numbers suit the sim's E3 fleet at benchmark scale."""
    w = dict(fast_window_s=fast_window_s, slow_window_s=slow_window_s,
             burn_threshold=burn_threshold)
    return [
        SLOTarget("ttft_p99", "ttft", ttft_p99_s, target=0.99, **w),
        SLOTarget("tpot_p50", "tpot", tpot_p50_s, target=0.50, **w),
        SLOTarget("goodput_p95", "goodput", latency_p95_s, target=0.95,
                  **w),
        SLOTarget("reject_rate", "reject", target=reject_target, **w),
    ]


class _TargetState:
    """Mutable evaluation state for one target."""
    __slots__ = ("target", "window", "sketch", "breached", "breaches",
                 "recoveries", "breach_s", "last_fast_burn",
                 "last_slow_burn")

    def __init__(self, t: SLOTarget, sketch_capacity: int, seed: int):
        self.target = t
        # one ring sized to the slow window answers both windows
        self.window = WindowedCounter(t.slow_window_s, n_buckets=60)
        self.sketch = ReservoirSketch(sketch_capacity, seed=seed)
        self.breached = False
        self.breaches = 0
        self.recoveries = 0
        self.breach_s: Optional[float] = None
        self.last_fast_burn = 0.0
        self.last_slow_burn = 0.0


class SLOEngine:
    """Evaluates a set of SLOTargets over a live request stream.

    Clock-explicit: every entry point takes `now` on the backend clock.
    The scheduler calls observe_request / observe_reject at completion
    and shedding; evaluate() (called after each observation, and by the
    dashboard on its render tick) rolls the windows, flips breach states,
    and emits slo.breach / slo.recover tracer instants."""

    def __init__(self, targets: Optional[List[SLOTarget]] = None, *,
                 sketch_capacity: int = 1024, seed: int = 0):
        self.targets = list(targets) if targets is not None \
            else default_targets()
        names = [t.name for t in self.targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO target names: {names}")
        self._states: Dict[str, _TargetState] = {
            t.name: _TargetState(t, sketch_capacity, seed=seed + i)
            for i, t in enumerate(self.targets)}
        self.health = 1.0

    # -- observation --------------------------------------------------------------
    def _metric_values(self, req) -> Dict[str, float]:
        """Extract per-metric observations from a finished request
        record (anything with the Request timestamp attributes)."""
        out: Dict[str, float] = {}
        if req.first_token_s is not None:
            out["ttft"] = req.first_token_s - req.arrival_s
        if req.finish_s is not None:
            out["latency"] = req.finish_s - req.arrival_s
            out["goodput"] = out["latency"]
            gen = getattr(req, "generated", 0)
            if req.first_token_s is not None and gen > 1:
                out["tpot"] = (req.finish_s - req.first_token_s) \
                    / (gen - 1)
        return out

    def observe_request(self, req, now: float) -> None:
        """One finished request: judge it against every latency target
        and count it as a good (non-)rejection."""
        vals = self._metric_values(req)
        for st in self._states.values():
            t = st.target
            if t.metric == "reject":
                st.window.add(now, good=1.0)
                continue
            v = vals.get(t.metric)
            if v is None:
                continue
            st.sketch.observe(v)
            good = v <= t.threshold_s
            st.window.add(now, good=float(good), bad=float(not good))
        self.evaluate(now)

    def observe_reject(self, req, now: float) -> None:
        for st in self._states.values():
            if st.target.metric == "reject":
                st.window.add(now, bad=1.0)
        self.evaluate(now)

    # -- evaluation ---------------------------------------------------------------
    def burn_rates(self, name: str, now: float) -> tuple:
        """(fast, slow) burn rates for one target: bad fraction over the
        window divided by the error budget."""
        st = self._states[name]
        t = st.target
        fast = st.window.bad_fraction(t.fast_window_s, now) / t.budget
        slow = st.window.bad_fraction(t.slow_window_s, now) / t.budget
        return fast, slow

    def evaluate(self, now: float) -> List[str]:
        """Roll windows, flip breach states, emit tracer events; returns
        the names of targets that changed state this call. Also refreshes
        `health`."""
        changed: List[str] = []
        tr = get_tracer()
        health = 1.0
        for st in self._states.values():
            t = st.target
            fast, slow = self.burn_rates(t.name, now)
            st.last_fast_burn, st.last_slow_burn = fast, slow
            if not st.breached:
                # both windows must burn: prompt AND sustained
                if fast >= t.burn_threshold and slow >= t.burn_threshold:
                    st.breached = True
                    st.breaches += 1
                    st.breach_s = now
                    changed.append(t.name)
                    if tr is not None:
                        tr.instant(tr_ev.SLO_BREACH, ts=now,
                                   track=tr_ev.TRACK_SLO,
                                   args={"target": t.name,
                                         "fast_burn": fast,
                                         "slow_burn": slow,
                                         "threshold": t.burn_threshold})
            else:
                if fast < t.burn_threshold * t.recovery_frac:
                    st.breached = False
                    st.recoveries += 1
                    st.breach_s = None
                    changed.append(t.name)
                    if tr is not None:
                        tr.instant(tr_ev.SLO_RECOVER, ts=now,
                                   track=tr_ev.TRACK_SLO,
                                   args={"target": t.name,
                                         "fast_burn": fast})
            if st.breached:
                # health decays with excess burn past the threshold:
                # breach at exactly threshold -> 0.5, runaway burn -> 0
                excess = max(fast, 1e-9) / t.burn_threshold
                health = min(health, 1.0 / (1.0 + excess))
        self.health = health
        return changed

    # -- signals ------------------------------------------------------------------
    @property
    def breaching(self) -> List[str]:
        return [n for n, st in self._states.items() if st.breached]

    def pressure(self) -> float:
        """1 - health: what backends forward to the OnlinePlanner so the
        TS ladder fires early under SLO stress (0 when healthy)."""
        return 1.0 - self.health

    # -- reporting ----------------------------------------------------------------
    def snapshot(self, now: float) -> dict:
        """JSON-able state for the dashboard / bench reports."""
        self.evaluate(now)
        out: Dict[str, dict] = {}
        for name, st in self._states.items():
            t = st.target
            out[name] = {
                "metric": t.metric,
                "threshold_s": t.threshold_s,
                "target": t.target,
                "fast_burn": st.last_fast_burn,
                "slow_burn": st.last_slow_burn,
                "burn_threshold": t.burn_threshold,
                "breached": st.breached,
                "breaches": st.breaches,
                "recoveries": st.recoveries,
                "observed": st.sketch.count,
                # None, not NaN, when nothing observed: NaN is not valid
                # JSON and json.dumps would emit a non-portable literal
                "p50": (st.sketch.quantile(50) if st.sketch.count else
                        None),
                "p99": (st.sketch.quantile(99) if st.sketch.count else
                        None),
            }
        return {"health": self.health, "targets": out,
                "breaching": self.breaching}
