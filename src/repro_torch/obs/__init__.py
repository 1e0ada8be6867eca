"""Metrics registry and streaming sketches (copies of ``repro.obs``'s
framework-free modules; tracing and SLOs come with later slices)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.sketch import ReservoirSketch  # noqa: F401
