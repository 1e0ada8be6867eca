"""Critical-path attribution over flight-recorder events (DESIGN.md §17).

The tracer (§15) records *what overlapped*; this module answers *what the
time went to*. Every pipeline round (`step` span) is decomposed into
wall-clock buckets by partitioning the round window into atomic slices at
every span boundary and classifying each slice by priority:

  compute       some device is executing a stage (stage.compute)
  weight_stall  no device computes, but one waits on a weight fetch
                (weight.stall — the uncovered-load window, paper Eq. 3)
  act_hop       only activation hand-offs are in flight (act.hop)
  kv_migration  only KV movement spans are in flight (kv.*)
  bubble        nothing recorded — pipeline bubble / scheduling idle

Because the slices partition the window, the buckets sum to the measured
round time *by construction* — the conservation property tests and
bench_slo assert (within float rounding). A round's bottleneck device is
the one busy (compute + stall) the largest share of the window.

Requests decompose the same way: `req.queue` is the queue bucket, and the
service window (admit -> finish) is clipped against the classified
timeline, so one request's latency splits into queue / compute / stall /
hop / kv / bubble and sums to its measured latency.

Works live (Tracer.events()) and offline (exporters.read_jsonl), on
single-pipeline traces and on fleet traces (pass the replica namespace,
e.g. "r0", to attribute one replica's timeline).

Copied from ``repro.obs.critical_path`` with the imports pointed at the port: the
PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the framework-free modules.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import (EVT_DUR, EVT_NAME, EVT_PH, EVT_TRACK, EVT_TS,
                             Event)

# classification priority (first match wins on each atomic slice)
BUCKETS = ("compute", "weight_stall", "act_hop", "kv_migration", "bubble")

_SPAN_CLASS = {
    tr_ev.STAGE_COMPUTE: "compute",
    tr_ev.WEIGHT_STALL: "weight_stall",
    tr_ev.ACT_HOP: "act_hop",
}

Interval = Tuple[float, float]


# -- track helpers -----------------------------------------------------------
def split_track(track: str) -> Tuple[Optional[str], str]:
    """'r2:dev:3' -> ('r2', 'dev:3'); 'dev:3' -> (None, 'dev:3')."""
    ns, sep, rest = track.partition(":")
    if sep and rest and len(ns) > 1 and ns[0] == "r" and ns[1:].isdigit():
        return ns, rest
    return None, track


def namespaces(events: Sequence[Event]) -> List[Optional[str]]:
    """Distinct replica namespaces present (None = un-namespaced)."""
    seen = {split_track(e[EVT_TRACK])[0] for e in events}
    return sorted(seen, key=lambda x: (x is not None, x))


# -- interval algebra --------------------------------------------------------
def _merge(ivs: List[Interval]) -> List[Interval]:
    """Sorted union of possibly-overlapping intervals."""
    out: List[Interval] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _clip_total(ivs: List[Interval], lo: float, hi: float) -> float:
    """Total length of (merged, sorted) `ivs` inside [lo, hi]."""
    total = 0.0
    for a, b in ivs:
        if b <= lo:
            continue
        if a >= hi:
            break
        total += min(b, hi) - max(a, lo)
    return total


def _covers(ivs: List[Interval], starts: List[float], a: float,
            b: float) -> bool:
    """Does some interval of merged `ivs` contain the atomic [a, b]?
    `starts` is the precomputed list of interval starts (bisect key)."""
    i = bisect_right(starts, a) - 1
    return i >= 0 and ivs[i][1] >= b


# -- report dataclasses ------------------------------------------------------
@dataclasses.dataclass
class RoundBreakdown:
    """One pipeline round, bucket-decomposed (buckets sum to dur)."""
    ts: float
    dur: float
    buckets: Dict[str, float]
    bottleneck: Optional[str]          # "dev:<i>" busiest this round
    dev_busy: Dict[str, float]         # per-device compute+stall seconds

    def to_dict(self) -> dict:
        return {"ts": self.ts, "dur": self.dur,
                "buckets": dict(self.buckets),
                "bottleneck": self.bottleneck,
                "dev_busy": dict(self.dev_busy)}


@dataclasses.dataclass
class RequestBreakdown:
    """One finished request, bucket-decomposed (queue + buckets = total)."""
    rid: int
    arrival_s: float
    queue_s: float
    prefill_s: float
    decode_s: float
    total_s: float
    buckets: Dict[str, float]          # service-window share per bucket

    def to_dict(self) -> dict:
        return {"rid": self.rid, "arrival_s": self.arrival_s,
                "queue_s": self.queue_s, "prefill_s": self.prefill_s,
                "decode_s": self.decode_s, "total_s": self.total_s,
                "buckets": dict(self.buckets)}


@dataclasses.dataclass
class CriticalPathReport:
    namespace: Optional[str]
    rounds: List[RoundBreakdown]
    requests: List[RequestBreakdown]
    totals: Dict[str, float]           # bucket seconds over all rounds
    bottlenecks: Dict[str, int]        # device -> rounds it dominated

    @property
    def round_time_s(self) -> float:
        return sum(r.dur for r in self.rounds)

    @property
    def fractions(self) -> Dict[str, float]:
        t = self.round_time_s
        return {k: (v / t if t > 0 else 0.0) for k, v in self.totals.items()}

    def conservation_error(self) -> float:
        """max over rounds of |sum(buckets) - dur| / dur — ~0 by
        construction; bench_slo enforces < 1%."""
        worst = 0.0
        for r in self.rounds:
            if r.dur <= 0:
                continue
            err = abs(sum(r.buckets.values()) - r.dur) / r.dur
            worst = max(worst, err)
        return worst

    def to_dict(self) -> dict:
        return {"namespace": self.namespace,
                "n_rounds": len(self.rounds),
                "round_time_s": self.round_time_s,
                "totals": dict(self.totals),
                "fractions": self.fractions,
                "bottlenecks": dict(self.bottlenecks),
                "conservation_error": self.conservation_error(),
                "requests": [r.to_dict() for r in self.requests]}

    # -- text rendering -----------------------------------------------------------
    def render(self, *, max_requests: int = 12, width: int = 40) -> str:
        lines = [f"critical path: {len(self.rounds)} rounds, "
                 f"{self.round_time_s:.3f}s on the pipeline"
                 + (f" [{self.namespace}]" if self.namespace else "")]
        fr = self.fractions
        for k in BUCKETS:
            lines.append(f"  {k:<13} {self.totals.get(k, 0.0):>9.3f}s "
                         f"{100.0 * fr.get(k, 0.0):5.1f}%")
        if self.bottlenecks:
            top = sorted(self.bottlenecks.items(),
                         key=lambda kv: -kv[1])
            lines.append("  bottleneck: " + "  ".join(
                f"{d} x{n}" for d, n in top[:4]))
        if self.requests:
            lines.append(render_waterfall(self.requests,
                                          max_requests=max_requests,
                                          width=width))
        return "\n".join(lines)


def render_waterfall(requests: List[RequestBreakdown], *,
                     max_requests: int = 12, width: int = 40) -> str:
    """Per-request latency waterfall: queue '.', prefill '=', decode '#',
    one scaled lane per request, slowest requests first."""
    if not requests:
        return "  (no finished requests in trace)"
    show = sorted(requests, key=lambda r: -r.total_s)[:max_requests]
    t_max = max(r.total_s for r in show)
    scale = width / t_max if t_max > 0 else 0.0
    lines = [f"  slowest {len(show)}/{len(requests)} requests "
             f"(. queue  = prefill  # decode):"]
    for r in show:
        nq = int(round(r.queue_s * scale))
        np_ = int(round(r.prefill_s * scale))
        nd = max(int(round(r.decode_s * scale)), 1)
        bar = "." * nq + "=" * np_ + "#" * nd
        lines.append(f"  req {r.rid:>5} |{bar:<{width}}| "
                     f"q {r.queue_s:.3f}s p {r.prefill_s:.3f}s "
                     f"d {r.decode_s:.3f}s = {r.total_s:.3f}s")
    return "\n".join(lines)


# -- attribution -------------------------------------------------------------
def _collect(events: Sequence[Event], namespace: Optional[str]):
    """Split one namespace's events into classified span-interval pools,
    step windows, per-device busy intervals, and request phase spans."""
    class_iv: Dict[str, List[Interval]] = {
        "compute": [], "weight_stall": [], "act_hop": [],
        "kv_migration": []}
    steps: List[Tuple[float, float]] = []
    dev_iv: Dict[str, List[Interval]] = {}
    req_phase: Dict[int, Dict[str, Tuple[float, float]]] = {}
    for e in events:
        ns, base = split_track(e[EVT_TRACK])
        if ns != namespace or e[EVT_PH] != "X":
            continue
        name, ts, dur = e[EVT_NAME], e[EVT_TS], e[EVT_DUR]
        if name == tr_ev.STEP and base == tr_ev.TRACK_PIPELINE:
            steps.append((ts, ts + dur))
            continue
        cls = _SPAN_CLASS.get(name)
        if cls is None and name.startswith("kv."):
            cls = "kv_migration"
        if cls is not None and dur > 0:
            class_iv[cls].append((ts, ts + dur))
            if cls in ("compute", "weight_stall") \
                    and base.startswith("dev:"):
                dev = base.split(":")[0] + ":" + base.split(":")[1]
                dev_iv.setdefault(dev, []).append((ts, ts + dur))
            continue
        if base.startswith("req:") and name in (
                tr_ev.REQ_QUEUE, tr_ev.REQ_PREFILL, tr_ev.REQ_DECODE,
                tr_ev.REQ_SPAN):
            rid = int(base.split(":", 1)[1])
            req_phase.setdefault(rid, {})[name] = (ts, dur)
    return class_iv, steps, dev_iv, req_phase


def _classified_timeline(class_iv: Dict[str, List[Interval]]
                         ) -> Dict[str, List[Interval]]:
    """Priority-resolve overlapping class intervals into disjoint,
    merged per-class interval lists (compute wins, then stall, ...)."""
    merged = {k: _merge(v) for k, v in class_iv.items()}
    starts = {k: [a for a, _ in v] for k, v in merged.items()}
    pts = sorted({p for ivs in merged.values() for ab in ivs for p in ab})
    out: Dict[str, List[Interval]] = {k: [] for k in merged}
    for a, b in zip(pts, pts[1:]):
        if b <= a:
            continue
        for cls in ("compute", "weight_stall", "act_hop", "kv_migration"):
            if _covers(merged[cls], starts[cls], a, b):
                out[cls].append((a, b))
                break
    return {k: _merge(v) for k, v in out.items()}


def analyze(events: Sequence[Event], *,
            namespace: Optional[str] = None) -> CriticalPathReport:
    """Attribute one namespace's timeline. Events may come straight from
    Tracer.events() (live) or exporters.read_jsonl (offline)."""
    class_iv, steps, dev_iv, req_phase = _collect(events, namespace)
    timeline = _classified_timeline(class_iv)
    dev_merged = {d: _merge(v) for d, v in dev_iv.items()}

    rounds: List[RoundBreakdown] = []
    totals = {k: 0.0 for k in BUCKETS}
    bottlenecks: Dict[str, int] = {}
    for t0, t1 in sorted(steps):
        if t1 <= t0:
            continue
        buckets = {k: _clip_total(timeline[k], t0, t1)
                   for k in timeline}
        classified = sum(buckets.values())
        buckets["bubble"] = max((t1 - t0) - classified, 0.0)
        busy = {d: _clip_total(v, t0, t1) for d, v in dev_merged.items()}
        busy = {d: s for d, s in busy.items() if s > 0}
        bott = max(busy, key=lambda d: busy[d]) if busy else None
        if bott is not None:
            bottlenecks[bott] = bottlenecks.get(bott, 0) + 1
        rounds.append(RoundBreakdown(ts=t0, dur=t1 - t0, buckets=buckets,
                                     bottleneck=bott, dev_busy=busy))
        for k, v in buckets.items():
            totals[k] += v

    requests: List[RequestBreakdown] = []
    for rid, phases in sorted(req_phase.items()):
        span = phases.get(tr_ev.REQ_SPAN)
        if span is None:
            continue
        arr, total = span
        q_ts, q_dur = phases.get(tr_ev.REQ_QUEUE, (arr, 0.0))
        p_dur = phases.get(tr_ev.REQ_PREFILL, (0.0, 0.0))[1]
        d_dur = phases.get(tr_ev.REQ_DECODE, (0.0, 0.0))[1]
        svc_lo, svc_hi = q_ts + q_dur, arr + total
        buckets = {k: _clip_total(timeline[k], svc_lo, svc_hi)
                   for k in timeline}
        svc = max(svc_hi - svc_lo, 0.0)
        buckets["bubble"] = max(svc - sum(buckets.values()), 0.0)
        requests.append(RequestBreakdown(
            rid=rid, arrival_s=arr, queue_s=q_dur, prefill_s=p_dur,
            decode_s=d_dur, total_s=total, buckets=buckets))

    return CriticalPathReport(namespace=namespace, rounds=rounds,
                              requests=requests, totals=totals,
                              bottlenecks=bottlenecks)


def analyze_all(events: Sequence[Event]) -> Dict[Optional[str],
                                                 CriticalPathReport]:
    """One report per namespace present (fleet traces: one per replica)."""
    return {ns: analyze(events, namespace=ns)
            for ns in namespaces(events)}


def analyze_jsonl(path: str, *,
                  namespace: Optional[str] = None) -> CriticalPathReport:
    """Offline entry point: attribute an exported JSONL trace."""
    from repro_torch.obs.exporters import read_jsonl
    _, events = read_jsonl(path)
    return analyze(events, namespace=namespace)
