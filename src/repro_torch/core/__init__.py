"""The interleaved offload engine of the port, its plan geometry, and the
paper's planning and simulator substrate (counterpart of ``repro.core``):
cost_model, offline_scheduler, online_planner, kv_transfer, pipeline_sim,
baselines.

The exports below touch no array; the engine (core/engine.py) is imported
from its module.
"""
from repro_torch.core.cost_model import (CostEnv, ExecutionPlan,  # noqa: F401
                                         StageAlloc, Workload)
from repro_torch.core.offline_scheduler import (ScheduleResult,  # noqa: F401
                                                allocate)
from repro_torch.core.online_planner import OnlinePlanner  # noqa: F401
from repro_torch.core.kv_transfer import KVTransferProtocol  # noqa: F401
from repro_torch.core.pipeline_sim import (InterleavedPipelineSim,  # noqa: F401
                                           SimResult, simulate_lime)
