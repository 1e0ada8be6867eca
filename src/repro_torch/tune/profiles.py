"""MeasuredProfile: a DeviceProfile whose numbers were *timed*, not typed
(counterpart of ``repro.tune.profiles``, the JAX package's code unchanged).

The profiles of `repro_torch.core.profiles` are typed constants: the
paper's Jetson figures are the JAX package's calibration knobs, and the
H100's are data-sheet peaks scaled by shares read in earlier runs; every
plan the offline scheduler emits and every TS ladder the online planner
walks inherits that uncertainty. A MeasuredProfile carries the same
fields the cost model prices (so it flows through CostEnv / allocate /
OnlinePlanner unchanged) plus provenance: where the numbers came from,
when, how many trials, and a per-field confidence (coefficient of
variation across trials, so a consumer can tell a tight measurement from
a noisy one).

JSON round-trip follows the repo convention (DESIGN.md §17): NaN is not
valid JSON, so unknown confidences serialize as null and come back as
NaN (`to_dict` / `from_dict` are exact inverses on every non-NaN field).

`check_sane` is the poisoned-cache guard: a measured field more than
SANITY_FACTOR (3x) away from its analytic counterpart usually means a
broken clock, a CPU run timed as if it were the card, or a unit slip; it
logs a warning through `repro_torch.obs.log` rather than failing,
because a genuinely 4x-faster device is possible and the plan comparison
benchmarks decide what wins.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Mapping, Optional

from repro_torch.core.profiles import DeviceProfile
from repro_torch.obs.log import get_logger

SANITY_FACTOR = 3.0

# the DeviceProfile fields the harness measures / the cost model prices
MEASURED_FIELDS = ("flops", "mem_bw", "load_bw", "load_write_bw", "host_bw")


@dataclasses.dataclass(frozen=True)
class MeasuredProfile(DeviceProfile):
    """DeviceProfile + measurement provenance. `confidence` maps a
    measured field name to its coefficient of variation across trials
    (NaN = not measured this run, e.g. a field adopted from the analytic
    base)."""
    device_kind: str = ""          # the card's name or "cpu": cache key
    source: str = "measured"       # measured | cache | synthetic
    measured_at: str = ""          # ISO-8601, provenance only
    n_trials: int = 0
    confidence: Mapping[str, float] = dataclasses.field(default_factory=dict)
    extras: Mapping[str, float] = dataclasses.field(default_factory=dict)
    # extras: raw harness observations that don't map onto a priced field
    # (decode tok/s, prefill seconds, insert bandwidth, ...) — provenance
    # for humans and benchmarks, never consumed by the cost model

    # -- JSON ------------------------------------------------------------------
    @staticmethod
    def _null_nan(m: Mapping) -> Dict:
        return {k: (None if isinstance(v, float) and math.isnan(v) else v)
                for k, v in dict(m).items()}

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["confidence"] = self._null_nan(self.confidence)
        d["extras"] = self._null_nan(self.extras)
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), allow_nan=False, **kw)

    @classmethod
    def from_dict(cls, d: Mapping) -> "MeasuredProfile":
        d = dict(d)
        for key in ("confidence", "extras"):
            d[key] = {k: (float("nan") if v is None else float(v))
                      for k, v in dict(d.get(key) or {}).items()}
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    # -- sanity ----------------------------------------------------------------
    def deviation(self, analytic: DeviceProfile) -> Dict[str, float]:
        """measured / analytic per priced field (only fields both sides
        have non-zero; a 0-vs-0 field is in agreement, not a deviation)."""
        out = {}
        for f in MEASURED_FIELDS:
            a, m = getattr(analytic, f), getattr(self, f)
            if a > 0 and m > 0:
                out[f] = m / a
        return out

    def check_sane(self, analytic: DeviceProfile, *,
                   factor: float = SANITY_FACTOR) -> Dict[str, float]:
        """Warn (repro_torch.obs.log) on any measured field > `factor`x away
        from the analytic counterpart in either direction; returns the
        offending {field: ratio} map so callers/tests can assert on it."""
        log = get_logger("repro_torch.tune")
        bad = {f: r for f, r in self.deviation(analytic).items()
               if r > factor or r < 1.0 / factor}
        for f, r in sorted(bad.items()):
            log.warning("measured profile deviates from analytic",
                        device=self.name, kind=self.device_kind, field=f,
                        ratio=f"{r:.3g}", factor=factor,
                        hint="broken clock / CPU timing?")
        return bad


def from_analytic(base: DeviceProfile, *, device_kind: str,
                  source: str = "synthetic",
                  **overrides) -> MeasuredProfile:
    """Lift an analytic profile into a MeasuredProfile, overriding the
    fields a measurement (or a replayed drift) supplies. Fields not
    overridden keep the analytic value and get confidence NaN."""
    vals = {f.name: getattr(base, f.name)
            for f in dataclasses.fields(DeviceProfile)}
    vals.update(overrides)
    conf = {f: (0.0 if f in overrides else float("nan"))
            for f in MEASURED_FIELDS}
    return MeasuredProfile(device_kind=device_kind, source=source,
                           confidence=conf, **vals)
