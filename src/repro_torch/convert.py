"""Numpy bridge: the JAX package's parameter pytrees into the port.

``params_from_numpy`` takes ``repro.models.model.init_params`` output
already converted to numpy by the caller (nested dicts of arrays) and
returns the port's parameter tree on ``device``, in the same layout.
bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses: they go through float32, which holds every
bf16 value exactly, and back to bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    dev = resolve_device(device)
    return {k: (params_from_numpy(v, dev) if isinstance(v, dict)
                else _leaf(v, dev)) for k, v in tree.items()}
