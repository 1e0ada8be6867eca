"""Measured-profile autotuner of the port (counterpart of ``repro.tune``).

measure  - microbenchmark harness -> MeasuredProfile (CUDA events on the
           card)
profiles - MeasuredProfile (DeviceProfile + provenance/confidence)
sweep    - split-count autotuner of the hand-written CUDA kernels
cache    - TuneCache JSON persistence + kernel-table install
refit    - online EWMA re-fit of a CostEnv from serving telemetry: the
           simulator backend's weight-fetch and stage-compute
           observations, or the engine backend's load timings
           (note_load_timing), fold measured drift back into the planned
           model and rebuild the OnlinePlanner's ladders
"""
from repro_torch.tune.profiles import (MEASURED_FIELDS, SANITY_FACTOR,
                                       MeasuredProfile, from_analytic)
from repro_torch.tune.cache import TuneCache, default_cache_path
from repro_torch.tune.refit import OnlineRefit, RefitConfig, RefitEvent

__all__ = ["MEASURED_FIELDS", "SANITY_FACTOR", "MeasuredProfile",
           "from_analytic", "TuneCache", "default_cache_path",
           "OnlineRefit", "RefitConfig", "RefitEvent"]
