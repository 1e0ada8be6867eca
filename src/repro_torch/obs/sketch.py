"""Bounded streaming instruments: quantile sketches and windowed rates
(DESIGN.md §17).

PR 7's `Histogram` holds every raw sample — exact percentiles, unbounded
memory. At fleet scale ("millions of users", DESIGN.md §16) a serving run
observes far more latencies than it can afford to keep, and the SLO engine
(obs/slo.py) needs *online* quantiles and rates, not a drain-time sort.
This module provides the bounded replacements, all O(1) or O(capacity)
memory, all with documented error bounds, and — where the fleet layer
needs it — exact-capacity `merge()` so replica sketches pool into one
fleet sketch.

  ReservoirSketch   fixed-capacity uniform reservoir (Vitter's Algorithm R
                    with chained-merge weighting). Quantile error is
                    *rank* error: for capacity m, the estimated q-quantile
                    is an order statistic whose rank deviates by at most
                    eps = 2/sqrt(m) of the population with ~95% confidence
                    (binomial tail on m uniform draws: sd of the empirical
                    CDF at any point is sqrt(q(1-q)/m) <= 1/(2 sqrt(m));
                    two sds = 1/sqrt(m), doubled for the nearest-rank
                    rounding). m=1024 -> rank error ~3%: p99 of a million
                    samples lands between the true p96 and the max —
                    tight enough for burn-rate math, 1000x less memory.
                    merge() subsamples each side proportionally to its
                    population count, so a merged sketch is again a
                    uniform sample of the pooled population (same bound).
  P2Quantile        Jain & Chlamtac's P² estimator: ONE quantile in O(1)
                    memory (5 markers), no samples kept. Asymptotically
                    consistent; empirical error on smooth distributions is
                    well under the reservoir's for the same quantile, but
                    it cannot merge and cannot answer new quantiles after
                    the fact. Used for cheap per-replica live readouts;
                    the registry's bounded histograms use reservoirs so
                    fleet merge stays exact-capacity.
  EWMA              exponentially-weighted mean with a configurable
                    half-life on the *caller's* clock (virtual or wall):
                    weight of a sample aged `t` is 2^(-t/half_life).
  WindowedCounter   good/bad event counts over a ring of fixed-width time
                    buckets — the burn-rate engine's window algebra reads
                    totals over the trailing fast/slow windows in O(ring).

Everything here is clock-explicit: callers pass `now` (the scheduler's
backend clock — virtual for the sim, wall for the engine), nothing reads
time.time(), so sim runs are deterministic and tests seed everything.

Copied unchanged from ``repro.obs.sketch``: the PyTorch port imports nothing of
the JAX package, so it keeps its own copy of the framework-free modules.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

# Documented rank-error bound for ReservoirSketch.quantile (see module
# docstring): eps = RANK_ERROR_FACTOR / sqrt(capacity) at ~95% confidence.
RANK_ERROR_FACTOR = 2.0


def reservoir_rank_error(capacity: int) -> float:
    """The documented rank-error bound eps for a given capacity: the
    estimated q-quantile is within the true [q-eps, q+eps] quantile band
    with ~95% confidence. bench_slo.py enforces this against exact
    nearest-rank on pooled fleet samples."""
    return RANK_ERROR_FACTOR / math.sqrt(max(capacity, 1))


class _LCG:
    """Tiny deterministic RNG (numpy-free hot path; splittable by seed).
    Same constants as glibc's rand48 family."""
    __slots__ = ("state",)

    def __init__(self, seed: int):
        self.state = (seed * 0x5DEECE66D + 0xB) & 0xFFFFFFFFFFFF

    def next_float(self) -> float:
        self.state = (self.state * 0x5DEECE66D + 0xB) & 0xFFFFFFFFFFFF
        return (self.state >> 16) / float(1 << 32)

    def next_below(self, n: int) -> int:
        return int(self.next_float() * n) % max(n, 1)


class ReservoirSketch:
    """Fixed-capacity uniform sample of an unbounded stream, mergeable.

    observe() is Vitter's Algorithm R: sample i (1-based) replaces a
    random slot with probability m/i, which leaves every sample in the
    reservoir with probability exactly m/n. merge() re-samples both sides
    proportionally to their population counts — the result is again a
    uniform m-sample of the pooled population, so the quantile bound
    survives arbitrary merge trees (the fleet's per-replica -> aggregate
    fold)."""

    __slots__ = ("capacity", "count", "samples", "_rng", "_min", "_max")

    def __init__(self, capacity: int = 1024, seed: int = 0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.count = 0                    # population size seen
        self.samples: List[float] = []
        self._rng = _LCG(seed ^ (capacity << 20))
        self._min = math.inf
        self._max = -math.inf

    @property
    def rank_error(self) -> float:
        return reservoir_rank_error(self.capacity)

    def observe(self, v: float) -> None:
        self.count += 1
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if len(self.samples) < self.capacity:
            self.samples.append(v)
        else:
            j = self._rng.next_below(self.count)
            if j < self.capacity:
                self.samples[j] = v

    def extend(self, vs: Sequence[float]) -> None:
        for v in vs:
            self.observe(v)

    def quantile(self, p: float) -> float:
        """Nearest-rank quantile of the reservoir (p in [0,100], the
        serving.metrics convention); NaN when empty. Min/max are tracked
        exactly, so p=0 and p=100 are always exact."""
        if not self.samples:
            return float("nan")
        if p <= 0:
            return self._min
        if p >= 100:
            return self._max
        xs = sorted(self.samples)
        k = max(math.ceil(p / 100.0 * len(xs)) - 1, 0)
        return xs[min(k, len(xs) - 1)]

    def merge(self, other: "ReservoirSketch") -> "ReservoirSketch":
        """Fold `other` into self. Each side contributes slots in
        proportion to its population count (hypergeometric split of the
        capacity), sampled without replacement from its reservoir — the
        merged reservoir is a uniform sample of the pooled population.
        Returns self so merges chain (MetricsRegistry.merge)."""
        total = self.count + other.count
        if other.count == 0:
            return self
        if self.count == 0:
            self.count = other.count
            self.samples = list(other.samples)
            self._min, self._max = other._min, other._max
            return self
        cap = self.capacity
        mine, theirs = list(self.samples), list(other.samples)
        if total <= cap and len(mine) + len(theirs) <= cap:
            merged = mine + theirs        # everything fits: stay exact
        else:
            take_mine = round(cap * self.count / total)
            take_mine = min(max(take_mine, cap - len(theirs)), len(mine))
            take_theirs = min(cap - take_mine, len(theirs))
            merged = self._sample(mine, take_mine) \
                + self._sample(theirs, take_theirs)
        self.samples = merged
        self.count = total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    def _sample(self, xs: List[float], k: int) -> List[float]:
        """k distinct elements of xs (partial Fisher-Yates, seeded)."""
        if k >= len(xs):
            return list(xs)
        xs = list(xs)
        for i in range(k):
            j = i + self._rng.next_below(len(xs) - i)
            xs[i], xs[j] = xs[j], xs[i]
        return xs[:k]

    def to_dict(self) -> dict:
        return {"capacity": self.capacity, "count": self.count,
                "p50": self.quantile(50), "p99": self.quantile(99),
                "rank_error": self.rank_error}


class P2Quantile:
    """Jain & Chlamtac's P² algorithm: one streaming quantile, O(1) state.

    Five markers track (min, q/2-ish, q, (1+q)/2-ish, max) heights and
    positions; each observation nudges interior markers toward their
    ideal positions with a piecewise-parabolic height update. No samples
    are retained, so it cannot merge — use ReservoirSketch where fleet
    aggregation matters. Error is not worst-case bounded (the estimate is
    asymptotically consistent for continuous distributions); tests gate
    it empirically at ~2 x the reservoir bound on smooth streams."""

    __slots__ = ("q", "n", "heights", "pos", "ideal", "inc")

    def __init__(self, q: float = 0.99):
        if not 0.0 < q < 1.0:
            raise ValueError(f"q must be in (0,1), got {q}")
        self.q = q
        self.n = 0
        self.heights: List[float] = []
        self.pos = [1, 2, 3, 4, 5]
        self.ideal = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self.inc = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def observe(self, v: float) -> None:
        self.n += 1
        if len(self.heights) < 5:
            self.heights.append(v)
            if len(self.heights) == 5:
                self.heights.sort()
            return
        h = self.heights
        if v < h[0]:
            h[0], k = v, 0
        elif v >= h[4]:
            h[4], k = v, 3
        else:
            k = next(i for i in range(4) if h[i] <= v < h[i + 1])
        for i in range(k + 1, 5):
            self.pos[i] += 1
        for i in range(5):
            self.ideal[i] += self.inc[i]
        # adjust interior markers toward their ideal positions
        for i in range(1, 4):
            d = self.ideal[i] - self.pos[i]
            if (d >= 1 and self.pos[i + 1] - self.pos[i] > 1) or \
               (d <= -1 and self.pos[i - 1] - self.pos[i] < -1):
                s = 1 if d >= 0 else -1
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:                     # parabolic overshoots: linear
                    h[i] += s * (h[i + s] - h[i]) \
                        / (self.pos[i + s] - self.pos[i])
                self.pos[i] += s

    def _parabolic(self, i: int, s: int) -> float:
        h, p = self.heights, self.pos
        return h[i] + s / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + s) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - s) * (h[i] - h[i - 1]) / (p[i] - p[i - 1]))

    def value(self) -> float:
        """Current estimate of the q-quantile; NaN before any sample.
        With < 5 samples, falls back to the exact small-sample quantile."""
        if not self.heights:
            return float("nan")
        if self.n < 5:
            xs = sorted(self.heights)
            k = max(math.ceil(self.q * len(xs)) - 1, 0)
            return xs[min(k, len(xs) - 1)]
        return self.heights[2]


class EWMA:
    """Exponentially-weighted mean with a half-life on the caller's clock.

    A sample aged `t` seconds weighs 2^(-t / half_life): update() decays
    the accumulated weight by the elapsed time, then adds the new sample
    at weight 1. value() is the weighted mean — a latency tracker. rate()
    divides the decayed event *weight* by the effective window
    (half_life / ln 2, the integral of the decay kernel) — an events-per-
    second tracker that forgets bursts at the same half-life."""

    __slots__ = ("half_life", "weight", "weighted_sum", "last_s")

    def __init__(self, half_life_s: float = 60.0):
        if half_life_s <= 0:
            raise ValueError(f"half_life_s must be positive: {half_life_s}")
        self.half_life = half_life_s
        self.weight = 0.0
        self.weighted_sum = 0.0
        self.last_s: Optional[float] = None

    def _decay_to(self, now: float) -> None:
        if self.last_s is None:
            self.last_s = now
            return
        dt = now - self.last_s
        if dt > 0:
            f = 2.0 ** (-dt / self.half_life)
            self.weight *= f
            self.weighted_sum *= f
            self.last_s = now

    def update(self, v: float, now: float) -> None:
        self._decay_to(now)
        self.weight += 1.0
        self.weighted_sum += v

    def value(self, now: Optional[float] = None) -> float:
        """Weighted mean of observed samples; NaN before any sample.
        (Decay cancels in the ratio, so `now` only matters for rate.)"""
        if now is not None:
            self._decay_to(now)
        return self.weighted_sum / self.weight if self.weight > 0 \
            else float("nan")

    def rate(self, now: float) -> float:
        """Decayed events/second: total decayed event weight over the
        kernel's effective window half_life/ln2."""
        self._decay_to(now)
        return self.weight / (self.half_life / math.log(2.0))


class WindowedCounter:
    """Good/bad event counts over a ring of fixed-width time buckets.

    The burn-rate engine asks "how many bad events in the last W seconds"
    for two W's (fast/slow). One ring sized to the *slow* window answers
    both: `totals(window_s, now)` sums the trailing ceil(W/bucket)
    buckets. Memory is n_buckets regardless of traffic; bucket width
    quantizes window edges (documented algebra: a window of W covers
    between W and W + bucket seconds of events — tests pin this)."""

    __slots__ = ("bucket_s", "n_buckets", "_t0", "_good", "_bad",
                 "_head_idx")

    def __init__(self, window_s: float, n_buckets: int = 60):
        if window_s <= 0 or n_buckets <= 0:
            raise ValueError(f"bad window: {window_s}s x {n_buckets}")
        self.bucket_s = window_s / n_buckets
        self.n_buckets = n_buckets
        self._t0: Optional[float] = None   # epoch of bucket index 0
        self._good = [0.0] * n_buckets
        self._bad = [0.0] * n_buckets
        self._head_idx = 0                 # absolute index of newest bucket

    def _bucket(self, now: float) -> int:
        if self._t0 is None:
            self._t0 = now
        idx = int(max(now - self._t0, 0.0) / self.bucket_s)
        # advance: zero every bucket between the old head and the new
        if idx > self._head_idx:
            for i in range(self._head_idx + 1,
                           min(idx, self._head_idx + self.n_buckets) + 1):
                self._good[i % self.n_buckets] = 0.0
                self._bad[i % self.n_buckets] = 0.0
            if idx - self._head_idx > self.n_buckets:
                for i in range(self.n_buckets):
                    self._good[i] = self._bad[i] = 0.0
            self._head_idx = idx
        return min(idx, self._head_idx)

    def add(self, now: float, *, good: float = 0.0, bad: float = 0.0) -> None:
        i = self._bucket(now) % self.n_buckets
        self._good[i] += good
        self._bad[i] += bad

    def totals(self, window_s: float, now: float) -> Tuple[float, float]:
        """(good, bad) summed over the trailing `window_s` seconds —
        bucket-quantized: covers ceil(window/bucket) whole buckets
        including the (partial) current one."""
        self._bucket(now)                  # roll the ring forward first
        k = min(int(math.ceil(window_s / self.bucket_s)), self.n_buckets)
        good = bad = 0.0
        for j in range(k):
            i = (self._head_idx - j) % self.n_buckets
            if self._head_idx - j < 0:
                break
            good += self._good[i]
            bad += self._bad[i]
        return good, bad

    def bad_fraction(self, window_s: float, now: float) -> float:
        """bad / (good + bad) over the trailing window; 0.0 when empty
        (an idle window burns no budget)."""
        good, bad = self.totals(window_s, now)
        total = good + bad
        return bad / total if total > 0 else 0.0
