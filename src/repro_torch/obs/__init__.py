"""repro_torch.obs: the port's flight recorder, metrics registry, structured
logging and online SLO engine (copies of ``repro.obs``'s framework-free
modules, the same event vocabulary, so traces of both packages read alike).

  trace          ring-buffered Tracer + the stable event vocabulary; zero
                 cost when no tracer is installed (get_tracer() -> None)
  exporters      Chrome trace-event JSON (Perfetto) + JSONL round-trip +
                 schema validation
  metrics        MetricsRegistry (counters/gauges/histograms) behind the
                 scheduler's stats — ServingReport is a derived view
  log            level-gated structured logger (quiet under pytest)
  sketch         bounded streaming instruments: ReservoirSketch, P2Quantile,
                 EWMA, WindowedCounter
  slo            declarative SLO targets, multi-window burn-rate alerts,
                 live health the planner consumes
  critical_path  per-round latency attribution + per-request waterfalls
  dashboard      periodic text/JSON snapshots, live or offline from JSONL
"""
from repro_torch.obs.critical_path import (CriticalPathReport,  # noqa: F401
                                           analyze, analyze_all,
                                           analyze_jsonl)
from repro_torch.obs.dashboard import Dashboard, render_offline  # noqa: F401
from repro_torch.obs.exporters import (export_chrome,  # noqa: F401
                                       export_jsonl, read_jsonl, to_chrome,
                                       validate_chrome, validate_chrome_file)
from repro_torch.obs.log import get_logger  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.sketch import (EWMA, P2Quantile,  # noqa: F401
                                    ReservoirSketch, WindowedCounter,
                                    reservoir_rank_error)
from repro_torch.obs.slo import (SLOEngine, SLOTarget,  # noqa: F401
                                 default_targets)
from repro_torch.obs.trace import (Tracer, get_tracer,  # noqa: F401
                                   set_tracer, tracing)
