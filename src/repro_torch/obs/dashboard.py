"""Text dashboard over the SLO engine, scheduler, and flight recorder
(DESIGN.md §17).

One renderer, two modes:

  live     the serving loop calls `tick(now)` between scheduler steps; at
           most once per `interval_s` it returns a text snapshot (SLO
           table with burn rates + breach state, queue/in-flight load,
           rolling critical-path fractions from the tracer ring).
           `snapshot(now)` returns the same state as a JSON-able dict.
  offline  `render_offline(path)` re-renders an exported JSONL trace:
           critical-path decomposition + per-request waterfalls, no live
           objects needed. `python -m repro_torch.obs.dashboard trace.jsonl`
           is the CLI wrapper CI's dashboard smoke drives.

The renderer never touches the process clock: `now` comes from the
caller (virtual seconds in sim runs, wall seconds on the engine).

Copied from ``repro.obs.dashboard`` with the imports pointed at the port: the
PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the framework-free modules.
"""
from __future__ import annotations

import json
from typing import List, Optional

from repro_torch.obs import critical_path as cp


def _fmt_s(v: Optional[float]) -> str:
    return "-" if v is None or v != v else f"{v:7.3f}s"


class Dashboard:
    """Periodic snapshot renderer. All inputs optional — it renders
    whatever it was given a handle to."""

    def __init__(self, *, slo=None, sched=None, tracer=None,
                 interval_s: float = 5.0):
        self.slo = slo
        self.sched = sched
        self.tracer = tracer
        self.interval_s = max(interval_s, 0.0)
        self._last: Optional[float] = None
        self.renders = 0

    # -- cadence -----------------------------------------------------------------
    def due(self, now: float) -> bool:
        return self._last is None or now - self._last >= self.interval_s

    def tick(self, now: float) -> Optional[str]:
        """Render iff the interval elapsed; the serving loop calls this
        every iteration and prints whatever comes back."""
        if not self.due(now):
            return None
        self._last = now
        self.renders += 1
        return self.render(now)

    # -- snapshots ---------------------------------------------------------------
    def snapshot(self, now: float) -> dict:
        out: dict = {"t_s": now}
        if self.slo is not None:
            out["slo"] = self.slo.snapshot(now)
        if self.sched is not None:
            out["load"] = {"queue_depth": self.sched.queue_depth,
                           "in_flight": self.sched.in_flight,
                           "outstanding": self.sched.outstanding}
        if self.tracer is not None:
            per_ns = cp.analyze_all(self.tracer.events())
            out["critical_path"] = {
                ns if ns is not None else "": rep.to_dict()
                for ns, rep in per_ns.items() if rep.rounds}
        return out

    def render(self, now: float) -> str:
        lines: List[str] = [f"== slo dashboard @ t={now:.3f}s " + "=" * 24]
        if self.slo is not None:
            snap = self.slo.snapshot(now)
            lines.append(f"health {snap['health']:.2f}   breaching: "
                         + (", ".join(snap["breaching"]) or "-"))
            lines.append(f"  {'target':<14}{'metric':<9}{'p50':>9}"
                         f"{'p99':>9}{'fast':>7}{'slow':>7}  state")
            for name, t in snap["targets"].items():
                state = "BREACH" if t["breached"] else "ok"
                lines.append(
                    f"  {name:<14}{t['metric']:<9}"
                    f"{_fmt_s(t['p50']):>9}{_fmt_s(t['p99']):>9}"
                    f"{t['fast_burn']:>7.2f}{t['slow_burn']:>7.2f}"
                    f"  {state}")
        if self.sched is not None:
            lines.append(f"load: queue {self.sched.queue_depth}  "
                         f"in-flight {self.sched.in_flight}  "
                         f"outstanding {self.sched.outstanding}")
        if self.tracer is not None:
            for ns, rep in cp.analyze_all(self.tracer.events()).items():
                if not rep.rounds:
                    continue
                fr = rep.fractions
                tag = f" [{ns}]" if ns else ""
                lines.append(
                    f"critical path{tag} ({len(rep.rounds)} rounds): "
                    + "  ".join(f"{k} {100.0 * fr.get(k, 0.0):.0f}%"
                                for k in cp.BUCKETS))
        return "\n".join(lines)


# -- offline ------------------------------------------------------------------
def render_offline(path: str, *, namespace: Optional[str] = None,
                   max_requests: int = 12) -> str:
    """Re-render an exported JSONL trace: critical-path decomposition per
    namespace (or just one), with per-request waterfalls."""
    from repro_torch.obs.exporters import read_jsonl
    _, events = read_jsonl(path)
    if not events:
        return f"(empty trace: {path})"
    blocks: List[str] = []
    spaces = [namespace] if namespace is not None else cp.namespaces(events)
    for ns in spaces:
        rep = cp.analyze(events, namespace=ns)
        if rep.rounds or rep.requests:
            blocks.append(rep.render(max_requests=max_requests))
    return "\n\n".join(blocks) if blocks else \
        f"(no step/request spans in trace: {path})"


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="offline dashboard: critical-path attribution over an "
                    "exported JSONL trace")
    ap.add_argument("trace", help="JSONL trace (Tracer.export *.jsonl)")
    ap.add_argument("--namespace", default=None,
                    help="fleet replica namespace, e.g. r0 (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON snapshot instead of text")
    ap.add_argument("--max-requests", type=int, default=12)
    args = ap.parse_args(argv)
    if args.json:
        from repro_torch.obs.exporters import read_jsonl
        _, events = read_jsonl(args.trace)
        spaces = [args.namespace] if args.namespace is not None \
            else cp.namespaces(events)
        out = {ns if ns is not None else "":
               cp.analyze(events, namespace=ns).to_dict() for ns in spaces}
        print(json.dumps(out, indent=2))
    else:
        print(render_offline(args.trace, namespace=args.namespace,
                             max_requests=args.max_requests))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
