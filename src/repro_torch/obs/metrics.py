"""MetricsRegistry: counters / gauges / histograms for the serving path
(DESIGN.md §15).

Replaces the ad-hoc `stats` dicts that used to flow scheduler ->
`serving.metrics.summarize()`: the scheduler now increments typed
instruments and `ServingReport` is a *derived view* over the flattened
registry (`to_stats_dict()` keeps the exact key vocabulary the legacy
dicts used, so the report is field-identical either way — asserted in
tests/test_obs.py).

Instrument semantics:

  Counter    monotonic; `inc(n)` adds, `set(v)` adopts an externally
             accumulated total (the pool's spilled_pages etc. — counters
             owned by a subsystem the scheduler reads at drain time).
  Gauge      last-written value + high-water mark (`peak`): occupancy
             style quantities where the report wants the max. The peak
             tracks from the FIRST observation — a gauge that only ever
             goes negative peaks at its (negative) maximum, not at the
             0.0 it was constructed with.
  Histogram  nearest-rank percentiles over either every raw observation
             (exact — the default, right for benchmark-sized runs) or a
             bounded reservoir sketch (`MetricsRegistry(hist_capacity=m)`,
             DESIGN.md §17): million-request runs keep m samples per
             histogram instead of all of them, percentiles carry the
             documented reservoir rank-error bound
             (obs/sketch.reservoir_rank_error), and fleet merge() still
             pools correctly (reservoir merge is population-weighted).

Copied unchanged from ``repro.obs.metrics``: the PyTorch port imports nothing of
the JAX package, so it keeps its own copy of the framework-free modules.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.obs.sketch import ReservoirSketch


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = v


class Gauge:
    __slots__ = ("name", "value", "_peak")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._peak: Optional[float] = None   # None until first set():
        # initializing to 0.0 would make every never-positive gauge
        # report a phantom peak of 0.0

    @property
    def peak(self) -> float:
        """High-water mark since the first observation; 0.0 before any
        (the legacy empty-gauge value, kept for report compatibility)."""
        return 0.0 if self._peak is None else self._peak

    def set(self, v: float) -> None:
        self.value = v
        if self._peak is None or v > self._peak:
            self._peak = v


class Histogram:
    """Raw-sample (exact) or reservoir-backed (bounded) percentile
    tracker. `values` is the raw list in exact mode; in bounded mode it
    stays empty and the samples live in `sketch` (percentiles then carry
    the sketch's rank-error bound, not exactness)."""

    __slots__ = ("name", "values", "sketch")

    def __init__(self, name: str, capacity: Optional[int] = None,
                 seed: int = 0):
        self.name = name
        self.sketch: Optional[ReservoirSketch] = None
        if capacity is not None:
            # per-histogram seed: two same-capacity sketches in one
            # registry must not share their replacement schedule
            self.sketch = ReservoirSketch(
                capacity, seed=seed ^ (hash(name) & 0xFFFF))
        self.values: List[float] = []

    @property
    def bounded(self) -> bool:
        return self.sketch is not None

    def observe(self, v: float) -> None:
        if self.sketch is not None:
            self.sketch.observe(v)
        else:
            self.values.append(v)

    @property
    def count(self) -> int:
        return self.sketch.count if self.sketch is not None \
            else len(self.values)

    def percentile(self, p: float) -> float:
        """Nearest-rank (serving.metrics convention); NaN when empty.
        Bounded mode: nearest rank over the reservoir — within the
        documented rank-error bound of the exact answer."""
        if self.sketch is not None:
            return self.sketch.quantile(p)
        if not self.values:
            return float("nan")
        xs = sorted(self.values)
        k = max(math.ceil(p / 100.0 * len(xs)) - 1, 0)
        return xs[min(k, len(xs) - 1)]

    def merge_from(self, other: "Histogram") -> None:
        """Pool `other`'s observations into self (the fleet fold).
        exact+exact concatenates (merged percentiles == pooled, exact);
        any bounded side merges reservoirs (population-weighted — the
        bound survives). An exact self folding a bounded other promotes
        itself to bounded first (the raw samples seed the reservoir);
        mixing modes across a fleet is legal but the result is bounded."""
        if self.sketch is None and other.sketch is None:
            self.values.extend(other.values)
            return
        if self.sketch is None:           # promote: raw -> reservoir
            self.sketch = ReservoirSketch(
                other.sketch.capacity,
                seed=hash(self.name) & 0xFFFF)
            for v in self.values:
                self.sketch.observe(v)
            self.values = []
        if other.sketch is not None:
            self.sketch.merge(other.sketch)
        else:
            for v in other.values:
                self.sketch.observe(v)


class MetricsRegistry:
    """Get-or-create instrument registry with a flat dict view.

    `hist_capacity=None` (default) keeps every histogram observation —
    exact percentiles, memory grows with the run. `hist_capacity=m`
    (DESIGN.md §17) bounds every histogram at an m-sample reservoir:
    constant memory at any request count, percentiles within
    `obs.sketch.reservoir_rank_error(m)` rank error of exact, and
    fleet merge() still pools correctly."""

    def __init__(self, hist_capacity: Optional[int] = None, seed: int = 0):
        self.hist_capacity = hist_capacity
        self._seed = seed
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- instruments -------------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, self.hist_capacity,
                                              seed=self._seed)
        return h

    # -- shorthands (the scheduler's hot-path calls) -----------------------------
    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.counter(name).set(v)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def update(self, stats: Dict[str, float]) -> None:
        """Adopt a subsystem's counter dict (spec stats, adapt stats,
        engine prefix stats — totals owned elsewhere, merged at drain)."""
        for k, v in stats.items():
            self.counter(k).set(v)

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry into this one — the fleet aggregation
        primitive (DESIGN.md §16). Counters sum (totals across replicas),
        gauges take the max (a fleet's peak occupancy is the max of the
        replicas' peaks, not their sum — each replica's pool is its own),
        histograms pool raw samples so merged percentiles equal
        percentiles over the pooled observations *exactly* (asserted in
        tests; merging precomputed percentiles would not be) — unless a
        side is reservoir-bounded, in which case the merge is population-
        weighted and the rank-error bound carries over. Returns self so
        merges chain."""
        for name, c in other._counters.items():
            self.counter(name).inc(c.value)
        for name, g in other._gauges.items():
            mine = self.gauge(name)
            # a never-set local gauge adopts the other's value outright —
            # max() against the constructed 0.0 would invent a zero
            # observation
            if mine._peak is None:
                mine.value, mine._peak = g.value, g._peak
            elif g._peak is not None:
                mine.value = max(mine.value, g.value)
                mine._peak = max(mine._peak, g._peak)
        for name, h in other._hists.items():
            self.histogram(name).merge_from(h)
        return self

    # -- views -------------------------------------------------------------------
    def to_stats_dict(self) -> Dict[str, float]:
        """The legacy flat `stats` vocabulary: counters under their own
        name, gauges under their *peak* when the name says so ("peak_*")
        else current value, histograms as "<name>_p50"/"<name>_p99"."""
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.peak if name.startswith("peak_") else g.value
        for name, h in self._hists.items():
            # empty histogram -> None (not NaN): the stats dict gets
            # json.dumps'd into reports, and NaN is not valid JSON
            p50, p99 = h.percentile(50), h.percentile(99)
            out[f"{name}_p50"] = None if p50 != p50 else p50
            out[f"{name}_p99"] = None if p99 != p99 else p99
            out[f"{name}_count"] = h.count
        return out

    def get(self, name: str, default: float = 0.0) -> float:
        if name in self._counters:
            return self._counters[name].value
        if name in self._gauges:
            g = self._gauges[name]
            return g.peak if name.startswith("peak_") else g.value
        return default
