"""SpecConfig, SpecStats and the verify/commit loop (counterpart of
``repro.specdec.controller``), trimmed to external drafts: the backend
drafts on the engine's resident tier itself (draft="resident") and uses
the controller for acceptance and the drafted/accepted counters. The
n-gram and small-model drafts wait for their slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.serving.sampling import SamplerConfig
from repro_torch.specdec.sampler import greedy_verify


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """k           drafted tokens per round (verify scores k+1); with
                   adapt_k the cap the depth controller adapts under
    draft       "resident": a truncated forward through the target's own
                live resident tier (the only draft the port has so far)
    acceptance  full-residency acceptance prior; the depth controller
                seeds each retier rung with it x the live resident share
    adapt_k     adapt depth per retier rung (DepthController)"""
    k: int = 4
    draft: str = "resident"
    acceptance: float = 0.8
    adapt_k: bool = True

    def __post_init__(self):
        if self.draft != "resident":
            raise NotImplementedError(
                f"draft={self.draft!r}: the port drafts on the engine's "
                "resident tier only (the ngram and model drafts wait)")
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1")


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0          # drafted tokens that survived verification

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def to_dict(self) -> Dict[str, float]:
        return {"spec_rounds": self.rounds, "spec_drafted": self.drafted,
                "spec_accepted": self.accepted}


class SpecDecodeController:
    """Greedy acceptance plus round accounting for one serving batch."""

    def __init__(self, spec: SpecConfig, sampler: SamplerConfig,
                 real_vocab: int):
        if sampler.temperature > 0.0:
            raise NotImplementedError(
                "speculative decoding in the port is greedy; rejection "
                "sampling (temperature > 0) waits")
        self.spec = spec
        self.real_vocab = real_vocab
        self.stats = SpecStats()

    def verify(self, logits: np.ndarray, draft: np.ndarray) -> List[int]:
        """logits: (k+1, PV) target logits of one slot; returns the
        committed tokens (1..k+1). Counters are not touched here: the
        backend may truncate the result (lockstep commit) and reports what
        it committed through note_round()."""
        return greedy_verify(logits, draft, self.real_vocab)

    def note_round(self, drafted: int, accepted_committed: int) -> None:
        """Per-slot accounting after the commit: accepted_committed counts
        drafted tokens that survived verification and made it into the
        committed prefix."""
        self.stats.rounds += 1
        self.stats.drafted += drafted
        self.stats.accepted += accepted_committed
