"""Draft providers (counterpart of ``repro.specdec.draft``).

A draft provider is per-sequence host-side state with three hooks:

  reset(tokens)    start a sequence (prompt + first sampled token)
  observe(tokens)  tokens the verifier committed this round
  propose(k)       -> (tokens (k,) int32, probs (k, V) float64 or None);
                   probs is the proposal distribution q of the rejection
                   sampler, None a point-mass draft (q(token) = 1)

Correctness never depends on the draft: any proposal stream is verified
losslessly, a poor draft only costs acceptance.

  NgramDraft      prompt lookup [Saxena'23]: the continuation of the most
                  recent earlier occurrence of the longest matching tail
                  n-gram. No weights, no device work.
  SmallModelDraft autoregressive draft from a small model's own cache
                  (models/model.py prefill / decode_step on the backend's
                  device, impl "kernel": kernels 2 and 1 at the draft's
                  shapes; on the card each decode step, and the prefill
                  of reset, replays a captured CUDA graph over the
                  draft's own cache, the JAX draft's jitted step and
                  prefill). The cache only ever holds committed tokens.

The port's caches are written in place (the JAX package's draft keeps an
immutable snapshot for free), so propose() saves what its k decode steps
overwrite (the K/V rows and pos_ids of the k slots they touch, the
recurrent states, pos) and puts it back afterwards: past the cache's end
the ring's slots hold older positions still in view, which a rolled-back
pos alone would not restore.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.capture import CapturedStep
from repro_torch.device import resolve_device


class NgramDraft:
    """Prompt lookup: the continuation of the most recent earlier
    occurrence of the longest matching tail n-gram."""

    def __init__(self, max_ngram: int = 3):
        assert max_ngram >= 1
        self.max_ngram = max_ngram
        self._hist: List[int] = []

    def reset(self, tokens) -> None:
        self._hist = [int(t) for t in tokens]

    def observe(self, tokens) -> None:
        self._hist.extend(int(t) for t in tokens)

    def propose(self, k: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        h = self._hist
        for n in range(min(self.max_ngram, max(len(h) - 1, 0)), 0, -1):
            pat = h[-n:]
            # the most recent earlier occurrence wins (repeated spans tend
            # to continue the way they did last time)
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == pat:
                    cont = h[i + n:i + n + k]
                    if cont:
                        out = cont + [cont[-1]] * (k - len(cont))
                        return np.asarray(out[:k], np.int32), None
        last = h[-1] if h else 0
        return np.full(k, last, np.int32), None


class SmallModelDraft:
    """Greedy (or sampled) k-token draft from a small model's own cache.

    The cache only ever holds committed tokens: observe() advances it by
    teacher-forcing the committed tokens through decode_step, propose()
    decodes k steps and then restores what they overwrite (eagerly,
    outside the graph). The cache is allocated once and cleared in place
    by reset(), so its graphs (decode_step and, one per prompt length,
    the prefill of reset, each through a CapturedStep in the backend's
    graph_pool; None: eager) survive requests."""

    def __init__(self, cfg, params, *, max_len: int = 512,
                 temperature: float = 0.0, seed: int = 0, device=None,
                 impl: str = "kernel", graph_pool=None):
        from repro_torch.models import model as M
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self.impl = impl
        self._rng = np.random.default_rng(seed)
        self._M = M
        self._cache = None
        self._pending: Optional[int] = None   # last token not yet in cache
        self._steps = CapturedStep.sharing(graph_pool, self.device)
        self._prefill_steps = CapturedStep.sharing(graph_pool, self.device)

    def _tok(self, t: int) -> torch.Tensor:
        return torch.full((1, 1), t, dtype=torch.long, device=self.device)

    def _decode(self, cache: dict, t: int) -> torch.Tensor:
        """One decode step of token t; returns its logits (real vocab)."""
        logits, _ = self._M.decode_step(self.cfg, self.params, cache,
                                        self._tok(t), impl=self.impl,
                                        steps=self._steps)
        return logits.reshape(-1)[:self.cfg.vocab_size]

    def _empty_cache(self) -> dict:
        """The draft's cache, empty: allocated once (again after a
        ResidentDraft's retier changes its depth), then cleared in
        place."""
        if self._cache is not None:
            return self._M.clear_cache(self._cache)
        return self._M.init_cache(self.cfg, 1, self.max_len,
                                  device=self.device)

    def reset(self, tokens) -> None:
        toks = [int(t) for t in tokens]
        assert toks, "reset needs at least one token"
        cache = self._empty_cache()
        if len(toks) > 1:
            self._M.prefill(self.cfg, self.params, torch.tensor(
                [toks[:-1]], dtype=torch.long, device=self.device), cache,
                impl=self.impl, steps=self._prefill_steps)
        self._cache = cache
        self._pending = toks[-1]

    def observe(self, tokens) -> None:
        for t in tokens:
            self._decode(self._cache, self._pending)
            self._pending = int(t)

    def _save(self, k: int) -> dict:
        """What k decode steps from the committed cache overwrite."""
        c = self._cache
        snap = {"pos": c["pos"]}
        if "pos_ids" in c:
            S_c = c["pos_ids"].shape[0]
            slots = torch.arange(c["pos"], c["pos"] + min(k, S_c),
                                 device=c["pos_ids"].device) % S_c
            snap["slots"] = slots
            snap["pos_ids"] = c["pos_ids"][slots]
            snap["k"] = c["k"][:, :, slots]
            snap["v"] = c["v"][:, :, slots]
        for key, val in c.items():
            if key not in ("pos", "pos_ids", "k", "v"):
                snap[key] = val.clone()       # recurrent state: O(1) a step
        return snap

    def _restore(self, snap: dict) -> None:
        c = self._cache
        c["pos"] = snap["pos"]
        if "slots" in snap:
            s = snap["slots"]
            c["pos_ids"][s] = snap["pos_ids"]
            c["k"][:, :, s] = snap["k"]
            c["v"][:, :, s] = snap["v"]
        for key, val in snap.items():
            if key not in ("pos", "slots", "pos_ids", "k", "v"):
                c[key].copy_(val)

    def propose(self, k: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        snap = self._save(k)
        cur = self._pending
        V = self.cfg.vocab_size
        toks = np.zeros(k, np.int32)
        probs = np.zeros((k, V), np.float64) if self.temperature > 0 \
            else None
        try:
            for i in range(k):
                lg = self._decode(self._cache, cur)
                if self.temperature > 0:
                    lv = lg.double().cpu().numpy() / self.temperature
                    lv -= lv.max()
                    q = np.exp(lv)
                    q /= q.sum()
                    cur = int(self._rng.choice(V, p=q))
                    probs[i] = q
                else:
                    cur = int(lg.argmax())
                toks[i] = cur
        finally:
            self._restore(snap)
        return toks, probs


def make_draft_provider(spec, target_cfg, *, target_params=None,
                        device=None, impl: str = "kernel", graph_pool=None):
    """One provider from a SpecConfig (controller.py), on `device`; the
    model drafts capture their decode step into graph_pool (None:
    eager).

    target_params only matters for draft="resident": the resident draft
    truncates the target's own stacked layers to the bottom
    spec.resident_layers (an early-exit head), so it needs the real
    weights. draft="model"
    draws the registry's smoke config of spec.draft_arch (gemma3-1b by
    default) at the target's vocabulary from spec.seed."""
    if spec.draft == "ngram":
        return NgramDraft(max_ngram=spec.max_ngram)
    if spec.draft == "resident":
        from repro_torch.specdec.resident_draft import (ResidentDraft,
                                                        default_resident_ids)
        if target_params is None:
            raise ValueError(
                "draft='resident' needs the target params (the draft is "
                "the target's resident tier)")
        return ResidentDraft(target_cfg, target_params,
                             default_resident_ids(target_cfg, spec.resident_layers),
                             temperature=spec.draft_temperature,
                             seed=spec.seed, device=device, impl=impl,
                             graph_pool=graph_pool)
    if spec.draft == "model":
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import model as M
        cfg = get_smoke_config(spec.draft_arch or "gemma3-1b")
        if cfg.vocab_size != target_cfg.vocab_size:
            cfg = dataclasses.replace(cfg, vocab_size=target_cfg.vocab_size)
        dev = resolve_device(device)
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(spec.seed), dev)
        return SmallModelDraft(cfg, params,
                               temperature=spec.draft_temperature,
                               seed=spec.seed, device=dev, impl=impl,
                               graph_pool=graph_pool)
    raise KeyError(f"unknown draft provider {spec.draft!r}")
