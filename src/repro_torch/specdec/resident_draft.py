"""DepthController (counterpart of ``repro.specdec.resident_draft``): the
draft depth of the resident self-draft, adapted per retier rung.

State is an acceptance-rate EMA per rung (rung = demoted layer slots):
retier events switch rungs instead of polluting one global average, so a
rung revisited after a promotion remembers what the draft was worth there.
Unseen rungs start from a prior; callers pass acceptance x live resident
fraction, so a demotion shrinks k at once instead of waiting for
rejections to pile up. The draft itself runs on the engine
(InterleavedEngine.draft_step); the host-side ResidentDraft of the JAX
package (a truncated model without an engine) is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional


class DepthController:
    def __init__(self, k_max: int, *, k_min: int = 1, decay: float = 0.7,
                 prior: float = 0.6):
        self.k_max = max(int(k_max), 1)
        self.k_min = min(max(int(k_min), 1), self.k_max)
        self.decay = float(decay)
        self.prior = min(max(float(prior), 0.0), 0.99)
        self._ema: Dict[int, float] = {}
        self._rung = 0

    @property
    def rung(self) -> int:
        return self._rung

    def note_rung(self, rung: int, prior: Optional[float] = None) -> None:
        """Switch to ``rung``; seed its EMA from ``prior`` if unseen."""
        self._rung = int(rung)
        if self._rung not in self._ema:
            p = self.prior if prior is None else float(prior)
            self._ema[self._rung] = min(max(p, 0.0), 0.99)

    def note_round(self, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        rate = min(max(accepted / drafted, 0.0), 1.0)
        e = self._ema.get(self._rung, self.prior)
        self._ema[self._rung] = self.decay * e + (1.0 - self.decay) * rate

    @property
    def acceptance(self) -> float:
        return self._ema.get(self._rung, self.prior)

    def k(self) -> int:
        """Expected accepted-run length of a geometric(a) stream."""
        a = self.acceptance
        k = int(round(a / max(1.0 - a, 1e-6)))
        return min(max(k, self.k_min), self.k_max)
