"""Resident-tier self-speculative drafting (counterpart of
``repro.specdec.resident_draft``).

The offload split leaves a resident tier in HBM while the streamed tier
pays a weight copy per pass. That split is a free draft model: a forward
through only the resident layers, with the final norm and LM head as an
early-exit head, costs no extra weight memory and no stream. The full
verify pass keeps the output lossless; the draft only sets acceptance.

  truncate_stack   (cfg, params) restricted to some layer ids: views of
                   the stacked layer tensors where the ids are contiguous
                   (the model code only reads them), shared embeddings,
                   final norm and LM head
  ResidentDraft    host-side draft provider over a truncated stack (the
                   single-device analogue of the engine's draft_step,
                   which the engine path runs instead); retier() rebuilds
                   it when the live tier boundary moves and replays the
                   committed history
  DepthController  the draft depth per retier rung: an acceptance-rate EMA
                   per rung (rung = demoted layer slots), so a rung
                   revisited after a promotion remembers what the draft
                   was worth there. Unseen rungs start from a prior;
                   callers pass acceptance x live resident fraction, so a
                   demotion shrinks k at once. k = round(a / (1 - a))
                   clipped to [k_min, k_max], the expected accepted run of
                   a geometric(a) acceptance stream
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.specdec.draft import SmallModelDraft


def default_resident_ids(cfg, n: Optional[int] = None) -> List[int]:
    """First-n layer ids for an engine-less resident draft (the bottom of
    the stack is what a uniform plan keeps resident)."""
    if n is None:
        n = max(1, cfg.n_layers // 2)
    return list(range(min(max(int(n), 1), cfg.n_layers)))


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def truncate_stack(cfg, params, resident_ids: Sequence[int]):
    """(cfg, params) restricted to ``resident_ids`` of the stacked layers;
    embeddings, final norm and LM head are shared (early exit). A
    contiguous id range slices views of the layer tensors; other sets
    gather copies."""
    ids = sorted({int(i) for i in resident_ids})
    if not ids:
        raise ValueError("resident draft needs at least one resident layer")
    if any(i < 0 or i >= cfg.n_layers for i in ids):
        raise ValueError(f"resident ids {ids} outside 0..{cfg.n_layers - 1}")
    if "dense_layers" in params:
        raise NotImplementedError(
            "resident draft supports homogeneous stacked layers only")
    sel = slice(ids[0], ids[-1] + 1) \
        if ids == list(range(ids[0], ids[-1] + 1)) else ids
    sub = {k: (_map(lambda a: a[sel], v) if k == "layers" else v)
           for k, v in params.items()}
    return dataclasses.replace(cfg, n_layers=len(ids)), sub


class ResidentDraft(SmallModelDraft):
    """Draft provider running the target's own resident layers as the
    draft. Snapshot-and-advance comes from SmallModelDraft (the truncated
    stack keeps its own committed-only cache); it also keeps the committed
    token history, so retier() can rebuild the truncated stack for a moved
    tier boundary and replay the history through it.

    Windowed configs index their window pattern by position in the
    truncated stack, so a truncated model may see another local/global mix
    than the same layers in the full model: draft quality only."""

    def __init__(self, cfg, params, resident_ids: Sequence[int], *,
                 max_len: int = 512, temperature: float = 0.0,
                 seed: int = 0, device=None, impl: str = "kernel",
                 graph_pool=None):
        self._full_cfg = cfg
        self._full_params = params
        self.resident_ids = tuple(sorted({int(i) for i in resident_ids}))
        sub_cfg, sub_params = truncate_stack(cfg, params, self.resident_ids)
        super().__init__(sub_cfg, sub_params, max_len=max_len,
                         temperature=temperature, seed=seed, device=device,
                         impl=impl, graph_pool=graph_pool)
        self._tokens: List[int] = []

    def reset(self, tokens) -> None:
        self._tokens = [int(t) for t in tokens]
        super().reset(tokens)

    def observe(self, tokens) -> None:
        self._tokens.extend(int(t) for t in tokens)
        super().observe(tokens)

    def retier(self, resident_ids: Sequence[int]) -> None:
        """The live tier boundary moved: rebuild the truncated stack and
        replay the committed history through it (a new depth: a new cache,
        so its graph is captured again)."""
        ids = tuple(sorted({int(i) for i in resident_ids}))
        if ids == self.resident_ids:
            return
        self.resident_ids = ids
        self.cfg, self.params = truncate_stack(self._full_cfg,
                                               self._full_params, ids)
        self._cache = None
        if self._tokens:
            super().reset(self._tokens)


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
