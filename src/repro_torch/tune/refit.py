"""Online re-fit: serving telemetry -> live CostEnv -> ladder rebuild
(counterpart of ``repro.tune.refit``, the JAX package's code unchanged).

A measured profile is stale the moment the device thermal-throttles or a
neighbour starts hammering the SSD. This module closes the loop during
serving: EWMA estimators (repro_torch.obs.sketch, on the serving clock) track
the *observed* weight-fetch bandwidth and stage-compute speed per device
— the same quantities the `weight.fetch` / `stage.compute` tracer spans
carry — and when the observation drifts more than `drift_tol` (default
20%) from what the planned CostEnv assumes, the planned env's device is
updated to the measured value and the OnlinePlanner's TS ladders are
rebuilt against it.

The rebuild passes `chunk_scale` = measured/planned load bandwidth, so a
slowed loader plans smaller demotion chunks (less extra streaming per
segment) instead of blindly keeping the sized-for-fast-SSD plan — the
mechanism that keeps an injected bandwidth drift from turning into
admission preemptions.

Updates are applied *in place* on `env.devices` so every holder of the
env (sim, planner, KV protocol, scheduler) sees the re-fit without
reference rewiring; `CostEnv.replace_device` exists for callers that
want a copy instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cost_model import CostEnv
from repro_torch.obs import trace as tr_ev
from repro_torch.obs.log import get_logger
from repro_torch.obs.sketch import EWMA
from repro_torch.obs.trace import get_tracer


@dataclasses.dataclass(frozen=True)
class RefitConfig:
    drift_tol: float = 0.20    # rebuild when |measured/planned - 1| exceeds
    half_life_s: float = 2.0   # EWMA half-life on the serving clock
    min_samples: int = 4       # per-device observations before trusting
    cooldown_s: float = 1.0    # min clock time between rebuilds


@dataclasses.dataclass(frozen=True)
class RefitEvent:
    now: float
    dev_idx: int
    field: str                 # "load_bw" | "flops"
    planned: float
    measured: float

    @property
    def ratio(self) -> float:
        return self.measured / self.planned if self.planned > 0 else 1.0


class OnlineRefit:
    """Per-device drift estimators + the planned-env update rule."""

    def __init__(self, env: CostEnv, planner=None, *,
                 config: RefitConfig = RefitConfig()):
        self.env = env
        self.planner = planner
        self.cfg = config
        if not isinstance(env.devices, list):
            env.devices = list(env.devices)   # in-place updates need a list
        n = len(env.devices)
        self._bw = [EWMA(config.half_life_s) for _ in range(n)]
        self._bw_n = [0] * n
        # compute speed as planned_time / observed_time (> 1 = faster)
        self._comp = [EWMA(config.half_life_s) for _ in range(n)]
        self._comp_n = [0] * n
        self._last_refit = -float("inf")
        self.events: List[RefitEvent] = []

    # -- observations ----------------------------------------------------------
    def observe_fetch(self, i: int, nbytes: float, seconds: float, *,
                      now: float) -> None:
        """One weight-fetch completion on device i's loader channel."""
        if seconds > 0 and nbytes > 0:
            self._bw[i].update(nbytes / seconds, now)
            self._bw_n[i] += 1

    def observe_compute(self, i: int, seconds: float,
                        planned_seconds: float, *, now: float) -> None:
        """One stage-compute completion: observed vs planned-model time."""
        if seconds > 0 and planned_seconds > 0:
            self._comp[i].update(planned_seconds / seconds, now)
            self._comp_n[i] += 1

    def consume_events(self, events) -> int:
        """Ingest tracer events (the `weight.fetch` spans on
        "dev:<i>:loader" tracks carry bytes + duration); returns the
        number consumed. The sim feeds observations directly — this path
        serves replay/offline analysis of an exported trace."""
        n = 0
        for e in events:
            if e[tr_ev.EVT_NAME] != tr_ev.WEIGHT_FETCH:
                continue
            track = e[tr_ev.EVT_TRACK]
            args = e[tr_ev.EVT_ARGS] or {}
            if not (track.startswith("dev:") and track.endswith(":loader")):
                continue
            try:
                i = int(track.split(":")[1])
            except ValueError:
                continue
            if 0 <= i < len(self.env.devices) and "bytes" in args:
                self.observe_fetch(i, float(args["bytes"]),
                                   float(e[tr_ev.EVT_DUR]),
                                   now=float(e[tr_ev.EVT_TS]
                                             + e[tr_ev.EVT_DUR]))
                n += 1
        return n

    # -- drift readout ---------------------------------------------------------
    def drift(self, i: int) -> Dict[str, float]:
        """{field: measured/planned} for device i, only for fields with
        enough samples to trust."""
        out: Dict[str, float] = {}
        dev = self.env.devices[i]
        if self._bw_n[i] >= self.cfg.min_samples and dev.load_bw > 0:
            out["load_bw"] = self._bw[i].value() / dev.load_bw
        if self._comp_n[i] >= self.cfg.min_samples:
            out["flops"] = self._comp[i].value()
        return out

    # -- the update rule -------------------------------------------------------
    def maybe_refit(self, now: float) -> List[RefitEvent]:
        """Fold any out-of-tolerance drift into the planned env and
        rebuild the planner's ladders once per call at most. Returns the
        RefitEvents applied (empty inside cooldown or within tolerance)."""
        if now - self._last_refit < self.cfg.cooldown_s:
            return []
        fired: List[RefitEvent] = []
        scales: List[float] = []
        for i, dev in enumerate(self.env.devices):
            d = self.drift(i)
            updates = {}
            if "load_bw" in d and abs(d["load_bw"] - 1.0) > self.cfg.drift_tol:
                measured = self._bw[i].value()
                updates["load_bw"] = measured
                fired.append(RefitEvent(now, i, "load_bw", dev.load_bw,
                                        measured))
                scales.append(d["load_bw"])
            if "flops" in d and abs(d["flops"] - 1.0) > self.cfg.drift_tol:
                measured = dev.flops * d["flops"]
                updates["flops"] = measured
                fired.append(RefitEvent(now, i, "flops", dev.flops,
                                        measured))
            if updates:
                # in-place so every env holder sees the re-fit
                self.env.devices[i] = dataclasses.replace(dev, **updates)
        if not fired:
            return []
        self._last_refit = now
        self.events.extend(fired)
        chunk_scale = min(scales) if scales else 1.0
        if self.planner is not None:
            self.planner.rebuild(self.env, chunk_scale=chunk_scale)
        log = get_logger("repro_torch.tune")
        tr = get_tracer()
        for ev in fired:
            log.info("online re-fit applied", dev=ev.dev_idx, field=ev.field,
                     planned=f"{ev.planned:.3g}",
                     measured=f"{ev.measured:.3g}",
                     ratio=f"{ev.ratio:.2f}")
            if tr is not None:
                tr.instant(tr_ev.TUNE_REFIT, ts=now, track=tr_ev.TRACK_TUNE,
                           args={"dev": ev.dev_idx, "field": ev.field,
                                 "planned": ev.planned,
                                 "measured": ev.measured,
                                 "chunk_scale": chunk_scale})
        return fired

    @property
    def n_refits(self) -> int:
        return len(self.events)
