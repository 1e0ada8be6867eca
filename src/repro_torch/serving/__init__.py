"""LIME-Serve in the port: traffic -> scheduler -> backend -> metrics."""
from repro_torch.serving.backend import EngineBackend, SimBackend  # noqa: F401
from repro_torch.serving.metrics import (ServingReport, percentile,  # noqa: F401
                                         summarize)
from repro_torch.serving.sampling import (SamplerConfig, filter_logits,  # noqa: F401
                                          sample)
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,  # noqa: F401
                                           Request, SchedulerConfig,
                                           requests_from_arrivals)
from repro_torch.serving.server import LimeServer, RequestQueue  # noqa: F401
from repro_torch.serving.traffic import (PATTERNS, ArrivalEvent,  # noqa: F401
                                         cli_arrivals, make_arrivals)
