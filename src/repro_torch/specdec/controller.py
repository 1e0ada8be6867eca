"""SpecDecodeController: the propose -> verify -> commit loop
(counterpart of ``repro.specdec.controller``).

The controller owns everything host-side about a speculative round for a
batch of slots: per-slot draft providers, the acceptance walk over the
target's multi-position logits, and the drafted/accepted counters the
serving metrics report. It never touches device state: the backend runs
the multi-query verify pass (engine.verify_requests, model.verify_step or
PagedDecodeCache.verify) and applies the commit the controller returns
(a pos rollback or a block-table truncation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.sampling import SamplerConfig
from repro_torch.specdec.draft import make_draft_provider
from repro_torch.specdec.sampler import (greedy_verify, rejection_verify,
                                         target_probs)

DRAFTS = ("ngram", "model", "resident")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Knobs for speculative decoding.

    k                 drafted tokens per round (verify scores k+1); with
                      adapt_k the cap the depth controller adapts under
    draft             "ngram" (prompt-lookup self-draft, no weights),
                      "model" (a small model's draft, a registered config
                      smoke-reduced) or "resident" (a truncated forward
                      through the target's own resident tier)
    max_ngram         longest tail n-gram the lookup draft matches
    draft_arch        registry arch of draft="model" (gemma3-1b if None)
    draft_temperature sampling temperature of the model and resident
                      drafts (0: greedy point-mass proposals)
    acceptance        full-residency acceptance prior of draft="resident":
                      the depth controller seeds each retier rung with it
                      x the live resident share
    resident_layers   draft="resident" without an engine: the bottom layers
                      that form the draft (default n_layers // 2); the
                      engine drafts on its live tier instead
    adapt_k           draft="resident": adapt the depth per retier rung
                      (DepthController; k stays the cap)
    seed              host-side rng (rejection sampling, the draft's
                      sampling and the model draft's weights)"""
    k: int = 4
    draft: str = "ngram"
    max_ngram: int = 3
    draft_arch: Optional[str] = None
    draft_temperature: float = 0.0
    acceptance: float = 0.8
    resident_layers: Optional[int] = None
    adapt_k: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.draft not in DRAFTS:
            raise KeyError(f"unknown draft provider {self.draft!r} "
                           f"(one of {DRAFTS})")
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
    """Per-slot drafting and lossless acceptance for one serving batch."""

    def __init__(self, spec: SpecConfig, sampler: SamplerConfig,
                 target_cfg, n_slots: int, *, target_params=None,
                 external_drafts: bool = False,
                 device=None, impl: str = "kernel", graph_pool=None):
        """external_drafts: the backend proposes tokens itself (the
        engine's resident draft) and uses the controller only for
        acceptance and counters; no host providers are built and
        begin/observe do nothing. device / impl: where and through which
        attention the model and resident drafts run; graph_pool: the
        backend's graph pool their decode steps and the prefill of their
        reset capture into (None: eager)."""
        self.spec = spec
        self.sampler = sampler
        self.cfg = target_cfg
        if external_drafts:
            self.drafts = None
        else:
            self.drafts = [
                make_draft_provider(spec, target_cfg,
                                    target_params=target_params,
                                    device=device, impl=impl,
                                    graph_pool=graph_pool)
                for _ in range(n_slots)]
        self._rng = np.random.default_rng(spec.seed)
        self.stats = SpecStats()

    # -- sequence lifecycle ------------------------------------------------------
    def begin(self, slot: int, tokens) -> None:
        """Start a sequence on `slot`: prompt + the first sampled token."""
        if self.drafts is not None:
            self.drafts[slot].reset(tokens)

    def observe(self, slot: int, tokens) -> None:
        """Feed the round's committed tokens back to the draft."""
        if self.drafts is not None:
            self.drafts[slot].observe(tokens)

    # -- one round ---------------------------------------------------------------
    def propose(self, slot: int,
                k: Optional[int] = None) -> Tuple[np.ndarray,
                                                  Optional[np.ndarray]]:
        """k: the round's cap from the backend (near the cache end it
        shrinks below spec.k)."""
        assert self.drafts is not None, \
            "external_drafts controller: the backend proposes"
        return self.drafts[slot].propose(self.spec.k if k is None else k)

    def verify(self, logits: np.ndarray, draft: np.ndarray,
               draft_probs: Optional[np.ndarray] = None) -> List[int]:
        """logits: (k+1, PV) target logits of one slot (array or tensor);
        returns the committed tokens (1..k+1), greedy at temperature 0 and
        rejection sampled otherwise, both exactly the serving sampler's
        distribution. Counters are not touched here: the backend may
        truncate the result (lockstep commit) and reports what it
        committed through note_round()."""
        if self.sampler.temperature <= 0.0:
            return greedy_verify(logits, draft, self.cfg.vocab_size)
        p = target_probs(logits, self.sampler, self.cfg.vocab_size)
        return rejection_verify(self._rng, p, draft, draft_probs)

    def note_round(self, drafted: int, accepted_committed: int) -> None:
        """Per-slot accounting after the commit: accepted_committed counts
        drafted tokens that survived verification and made it into the
        committed prefix (lockstep truncation drops the rest: they are
        drafted again and must not count twice)."""
        self.stats.rounds += 1
        self.stats.drafted += drafted
        self.stats.accepted += accepted_committed
