"""Tuning of the port (counterpart of ``repro.tune``).

  refit  online EWMA re-fit of a CostEnv from serving telemetry: the
         simulator backend's weight-fetch and stage-compute observations
         fold measured drift back into the planned model and rebuild the
         OnlinePlanner's ladders

The rest of the JAX package's tuner (the measurement harness, measured
profiles, their cache and the kernel sweep) is not ported yet.
"""
from repro_torch.tune.refit import (OnlineRefit, RefitConfig,  # noqa: F401
                                    RefitEvent)
