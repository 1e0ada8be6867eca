"""Serving metrics (counterpart of ``repro.serving.metrics``: the same
``ServingReport`` fields and ``summarize`` arithmetic, so the two
packages print comparable JSON).

Latency accounting is measured from *arrival*:

  TTFT     first_token_s − arrival_s    (queueing + prefill + first decode)
  latency  finish_s − arrival_s         (end-to-end per request)
  ms/token span_s / total generated tokens × 1e3 (fleet-level pace)

Percentiles use the nearest-rank method.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence

SCHEMA_VERSION = 2


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile; NaN for empty input."""
    if not values:
        return float("nan")
    xs = sorted(values)
    k = max(math.ceil(p / 100.0 * len(xs)) - 1, 0)
    return xs[min(k, len(xs) - 1)]


@dataclasses.dataclass
class ServingReport:
    pattern: str
    backend: str
    n_requests: int
    n_rejected: int                # shed at intake (queue/KV oversize)
    total_tokens: int
    span_s: float                  # first arrival -> last completion
    ms_per_token: float
    throughput_tok_s: float
    throughput_req_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    latency_p50_s: float
    latency_p99_s: float
    # TTFT split (DESIGN.md §12): time stuck in the queue vs time spent
    # prefilling after admission — a prefix hit shrinks the second term,
    # better scheduling the first
    ttft_queue_p50_s: float = float("nan")
    ttft_queue_p99_s: float = float("nan")
    ttft_prefill_p50_s: float = float("nan")
    ttft_prefill_p99_s: float = float("nan")
    # per-request decode pace: generated tokens / (finish - first token),
    # the steady-state rate users see after TTFT (NaN when no request
    # decoded more than one token)
    decode_tok_s_p50: float = float("nan")
    decode_tok_s_p99: float = float("nan")
    # paged-KV accounting (DESIGN.md §10; zero under reservation policy)
    n_preempted: int = 0           # preemption events (spill or recompute)
    peak_active: int = 0           # max co-resident requests
    peak_kv_pages: int = 0         # max device-tier pages in use
    kv_pages_spilled: int = 0
    kv_pages_fetched: int = 0
    kv_migrated_bytes: float = 0.0
    # speculative decoding (DESIGN.md §11; zero when spec is off)
    spec_rounds: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_acceptance_rate: float = 0.0
    # radix prefix cache (DESIGN.md §12; zero when the cache is off)
    prefix_hit_rate: float = 0.0   # admissions that matched a cached prefix
    cached_tokens: int = 0         # tokens held by the radix tree at end
    prefill_tokens_saved: int = 0  # prompt tokens served from cache instead
                                   # of riding a prefill round
    # online memory adaptation (DESIGN.md §13; zero when --adapt is off)
    retier_events: int = 0         # tier moves fired (planner + reclaim)
    layers_demoted: int = 0        # resident layers moved to the streamed
                                   # tier (whole-layer equivalents)
    layers_promoted: int = 0       # moved back when pressure dropped
    hbm_returned_bytes: float = 0.0  # weight HBM credited to the KV pool
    retier_reclaimed_pages: int = 0  # pages granted by scheduler-driven
                                     # reclaim (before any preemption)
    # schema versioning (satellite of DESIGN.md §15): benchmark JSON is
    # compared across PRs — a version stamp lets readers warn instead of
    # KeyError when the field set moves under them
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> Dict:
        # NaN (empty-percentile sentinel) is not valid JSON — json.dumps
        # happily emits a bare `NaN` token that strict parsers (jq,
        # browsers, other languages) reject. Serialize it as null;
        # report_from_dict maps null back to NaN on the way in.
        return {k: (None if isinstance(v, float) and math.isnan(v) else v)
                for k, v in dataclasses.asdict(self).items()}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent,
                          allow_nan=False)


def summarize(requests: List, *, pattern: str = "", backend: str = "",
              stats: Optional[Dict] = None) -> ServingReport:
    """Build a ServingReport from served request records (anything with
    arrival_s / first_token_s / finish_s / output / rejected attributes).
    `stats`: the scheduler's counters — a plain dict or a
    repro.obs.MetricsRegistry (the report is a derived view either way,
    field-identical by construction)."""
    served = [r for r in requests if not getattr(r, "rejected", False)
              and r.finish_s is not None]
    rejected = [r for r in requests if getattr(r, "rejected", False)]
    if stats is not None and hasattr(stats, "to_stats_dict"):
        stats = stats.to_stats_dict()
    stats = stats or {}
    total_tokens = sum(getattr(r, "generated", 0) or len(r.output)
                      for r in served)
    if served:
        t0 = min(r.arrival_s for r in served)
        t1 = max(r.finish_s for r in served)
        span = max(t1 - t0, 1e-12)
    else:
        span = 0.0
    ttfts = [r.first_token_s - r.arrival_s for r in served
             if r.first_token_s is not None]
    lats = [r.finish_s - r.arrival_s for r in served]
    # TTFT split: arrival -> admission (queue wait) and admission ->
    # first token (prefill compute + any preemption detour)
    queues = [r.admitted_s - r.arrival_s for r in served
              if getattr(r, "admitted_s", None) is not None]
    prefills = [r.first_token_s - r.admitted_s for r in served
                if getattr(r, "admitted_s", None) is not None
                and r.first_token_s is not None]
    # p50/p99 of per-request decode pace; the first token belongs to TTFT,
    # the remaining generated-1 span first_token_s..finish_s
    rates = [(r.generated - 1) / max(r.finish_s - r.first_token_s, 1e-12)
             for r in served
             if r.first_token_s is not None
             and getattr(r, "generated", 0) > 1]
    # acceptance is DERIVED from the raw counters (single source of
    # truth) — a pre-computed stats entry is ignored, not trusted
    spec_drafted = int(stats.get("spec_drafted", 0))
    spec_accepted = int(stats.get("spec_accepted", 0))
    return ServingReport(
        pattern=pattern, backend=backend,
        n_requests=len(served), n_rejected=len(rejected),
        total_tokens=total_tokens, span_s=span,
        ms_per_token=(1e3 * span / total_tokens if total_tokens
                      else float("nan")),
        throughput_tok_s=(total_tokens / span if span else 0.0),
        throughput_req_s=(len(served) / span if span else 0.0),
        ttft_p50_s=percentile(ttfts, 50), ttft_p99_s=percentile(ttfts, 99),
        latency_p50_s=percentile(lats, 50),
        latency_p99_s=percentile(lats, 99),
        ttft_queue_p50_s=percentile(queues, 50),
        ttft_queue_p99_s=percentile(queues, 99),
        ttft_prefill_p50_s=percentile(prefills, 50),
        ttft_prefill_p99_s=percentile(prefills, 99),
        decode_tok_s_p50=percentile(rates, 50),
        decode_tok_s_p99=percentile(rates, 99),
        n_preempted=sum(getattr(r, "preempted", 0) for r in requests),
        spec_rounds=int(stats.get("spec_rounds", 0)),
        spec_drafted=spec_drafted,
        spec_accepted=spec_accepted,
        spec_acceptance_rate=(spec_accepted / spec_drafted
                              if spec_drafted else 0.0),
        prefix_hit_rate=(float(stats.get("prefix_hits", 0))
                         / max(float(stats.get("prefix_lookups", 0)), 1.0)),
        cached_tokens=int(stats.get("cached_tokens", 0)),
        prefill_tokens_saved=int(stats.get("prefill_tokens_saved", 0)),
        retier_events=int(stats.get("retier_events", 0)),
        layers_demoted=int(stats.get("layers_demoted", 0)),
        layers_promoted=int(stats.get("layers_promoted", 0)),
        hbm_returned_bytes=float(stats.get("hbm_returned_bytes", 0.0)),
        retier_reclaimed_pages=int(stats.get("retier_reclaimed_pages", 0)),
        peak_active=int(stats.get("peak_active", 0)),
        peak_kv_pages=int(stats.get("peak_kv_pages", 0)),
        kv_pages_spilled=int(stats.get("kv_pages_spilled", 0)),
        kv_pages_fetched=int(stats.get("kv_pages_fetched", 0)),
        kv_migrated_bytes=float(stats.get("kv_migrated_bytes", 0.0)))


def report_from_dict(d: Dict, *, source: str = "",
                     warn=None) -> ServingReport:
    """Rehydrate a ServingReport from benchmark/baseline JSON,
    tolerantly: missing fields fall back to dataclass defaults, unknown
    fields are dropped, and a schema_version mismatch warns (via `warn`
    or repro_torch.obs.log) instead of raising, so old baselines stay
    readable across schema growth."""
    if warn is None:
        from repro_torch.obs.log import get_logger
        warn = get_logger("repro_torch.metrics").warning
    fields = {f.name: f for f in dataclasses.fields(ServingReport)}
    ver = d.get("schema_version")
    if ver != SCHEMA_VERSION:
        warn("baseline schema mismatch", source=source or "<dict>",
             baseline=ver, current=SCHEMA_VERSION)
    unknown = sorted(set(d) - set(fields))
    if unknown:
        warn("baseline has unknown report fields (dropped)",
             source=source or "<dict>", fields=",".join(unknown))
    required = {"pattern", "backend", "n_requests", "n_rejected",
                "total_tokens", "span_s", "ms_per_token",
                "throughput_tok_s", "throughput_req_s", "ttft_p50_s",
                "ttft_p99_s", "latency_p50_s", "latency_p99_s"}
    missing = sorted(required - set(d))
    if missing:
        warn("baseline missing report fields (defaults used)",
             source=source or "<dict>", fields=",".join(missing))
    kw = {k: v for k, v in d.items() if k in fields}
    # null in the JSON is the wire form of an empty-percentile NaN
    # (to_dict wrote it); restore the float sentinel for numeric fields
    for name, v in list(kw.items()):
        if v is None and str(fields[name].type) == "float":
            kw[name] = float("nan")
    fill = {"str": "", "int": 0, "float": float("nan")}
    for name in required - set(kw):
        kw[name] = fill.get(str(fields[name].type), 0)
    return ServingReport(**kw)
