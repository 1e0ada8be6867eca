"""Parameter specification trees (counterpart of ``repro.models.spec``).

A model is declared once as a nested dict of :class:`ParamSpec`;
``init`` materializes it with the same distributions as the JAX package:
normal scaled by ``1/sqrt(fan_in)`` (or the spec's own ``scale``), zeros
for norm scales, ``0.01 * N(0, 1)`` for the recurrent blocks' small
parameters (token-shift mixes, decay LoRA, conv taps, SSM scalars). ``fan_in`` is the leading dim of the leaf *as stacked*,
so for scan-stacked layer weights it is ``n_layers`` — a quirk of the
reference kept on purpose, so both packages build the same model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                   # normal | zeros | small
    scale: Optional[float] = None          # override fan-in scaling


def _init_one(s: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "small":
        scale = 0.01
    else:
        fan_in = s.shape[0] if len(s.shape) > 1 else max(s.shape[0], 1)
        scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(s.dtype)


def init(specs: dict, generator: torch.Generator, device: torch.device):
    """Materialize a spec tree; leaves are drawn in sorted-key order."""
    return {k: (init(v, generator, device) if isinstance(v, dict)
                else _init_one(v, generator, device))
            for k, v in sorted(specs.items())}


def stack(spec_tree: dict, n: int) -> dict:
    """Prepend a stacking dim of size n (per-layer parameter stacks)."""
    return {k: (stack(v, n) if isinstance(v, dict)
                else dataclasses.replace(v, shape=(n,) + v.shape))
            for k, v in spec_tree.items()}
