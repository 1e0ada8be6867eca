"""Token sampling (counterpart of ``repro.serving.sampling``).

``filter_logits`` is the single source of truth for the sampling
distribution: temperature scaling, then top-k, then nucleus (top-p)
filtering, each expressed as masking logits to -1e30. ``sample`` takes
the argmax for greedy decoding and otherwise draws from the filtered
distribution with an explicit ``torch.Generator`` (a different random
stream than JAX's, so only greedy picks and filtered logits are
comparable across the two packages).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => full softmax
    top_p: float = 1.0              # 1 => no nucleus filtering
    seed: int = 0


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig,
                  real_vocab: int) -> torch.Tensor:
    """logits: (..., PV) -> (..., real_vocab) fp32 with temperature applied
    and tokens outside the top-k / nucleus set masked to NEG_INF."""
    lv = logits[..., :real_vocab].float()
    if cfg.temperature > 0.0:
        lv = lv / cfg.temperature
    neg = torch.tensor(NEG_INF, dtype=lv.dtype, device=lv.device)
    if cfg.top_k and cfg.top_k < real_vocab:
        thresh = torch.topk(lv, cfg.top_k, dim=-1).values[..., -1:]
        lv = torch.where(lv >= thresh, lv, neg)
    if 0.0 < cfg.top_p < 1.0:
        # nucleus: keep the smallest prefix of the descending-prob order
        # whose mass reaches top_p (the head token always survives)
        srt = torch.sort(lv, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep = (csum - probs) < cfg.top_p      # mass *before* this token
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        lv = torch.where(lv >= thresh, lv, neg)
    return lv


def sample(logits: torch.Tensor, cfg: SamplerConfig,
           generator: Optional[torch.Generator], real_vocab: int
           ) -> torch.Tensor:
    """logits: (B, PV) -> (B,) int64 token ids."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits[:, :real_vocab], dim=-1)
    probs = torch.softmax(filter_logits(logits, cfg, real_vocab), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
