"""Lossless speculative decoding of the port (counterpart of
``repro.specdec``), trimmed to the interleaved engine's resident
self-draft: k greedy tokens drafted through the live resident tier, one
multi-query verify pass over all of them, the lockstep-min accepted
prefix committed.

  sampler.py        greedy acceptance (rejection sampling waits)
  controller.py     SpecConfig, SpecStats and the verify/commit loop
  resident_draft.py DepthController: draft depth per retier rung
"""
from repro_torch.specdec.controller import (SpecConfig,  # noqa: F401
                                            SpecDecodeController, SpecStats)
from repro_torch.specdec.resident_draft import DepthController  # noqa: F401
from repro_torch.specdec.sampler import greedy_verify  # noqa: F401
