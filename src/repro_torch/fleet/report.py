"""FleetReport: exact fleet-level aggregation of per-replica serving runs
(counterpart of ``repro.fleet.report``).

A ServingReport stores percentiles, not samples — averaging replica
percentiles would be wrong (the p99 of a union is not the mean of p99s).
So the fleet aggregates one level down, where exactness is possible:

  latency metrics   the pooled raw Request records from every replica run
                    through the same `summarize()` a single pipeline uses
  counters/gauges/  `MetricsRegistry.merge` — counters sum, gauges max,
  histograms        histograms concatenate raw samples (merged
                    percentiles == pooled-sample percentiles, asserted
                    in tests/test_torch_fleet.py)

The per-replica ServingReports are kept alongside the aggregate: a fleet
whose aggregate looks healthy can still hide one replica eating all the
queueing — the per-replica breakdown is where that shows.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.metrics import SCHEMA_VERSION, ServingReport, summarize
from repro_torch.serving.scheduler import Request


@dataclasses.dataclass
class FleetReport:
    pattern: str
    backend: str
    n_replicas: int                    # ever members (incl. retired)
    router_policy: str
    aggregate: ServingReport           # over the pooled request records
    replicas: Dict[str, ServingReport]  # per-replica breakdown
    router: Dict[str, float]           # FleetRouter.stats
    membership: Dict[str, dict]        # per-replica routed/joined/retired
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "pattern": self.pattern,
            "backend": self.backend,
            "n_replicas": self.n_replicas,
            "router_policy": self.router_policy,
            "aggregate": self.aggregate.to_dict(),
            "replicas": {k: v.to_dict() for k, v in self.replicas.items()},
            "router": dict(self.router),
            "membership": {k: dict(v) for k, v in self.membership.items()},
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


@dataclasses.dataclass
class FleetResult:
    """What Fleet.run returns: the raw material a FleetReport is built
    from (pooled + partitioned records, final replica/router state)."""
    requests: List[Request]            # every record, all replicas + shed
    per_replica: Dict[str, List[Request]]
    replicas: List                     # final Replica objects
    router: object                     # the FleetRouter (stats + config)
    shed: List[Request]                # router-level rejections

    def report(self, *, pattern: str = "", backend: str = "") -> FleetReport:
        merged = MetricsRegistry()
        per: Dict[str, ServingReport] = {}
        membership: Dict[str, dict] = {}
        for rep in self.replicas:
            per[rep.name] = summarize(self.per_replica.get(rep.name, []),
                                      pattern=pattern, backend=backend,
                                      stats=rep.sched.metrics)
            merged.merge(rep.sched.metrics)
            membership[rep.name] = {
                "routed": rep.routed,
                "joined_s": rep.joined_s,
                "retired_s": rep.retired_s,
                "draining": rep.draining,
                "live": rep.live,
                "health": rep.health(),
            }
            slo = getattr(rep.sched, "slo", None)
            if slo is not None:
                membership[rep.name]["slo"] = slo.snapshot(rep.now())
        aggregate = summarize(self.requests, pattern=pattern,
                              backend=backend, stats=merged)
        return FleetReport(pattern=pattern, backend=backend,
                           n_replicas=len(self.replicas),
                           router_policy=self.router.config.policy,
                           aggregate=aggregate, replicas=per,
                           router=dict(self.router.stats),
                           membership=membership)
