"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

Carries the architectures the port runs so far: the paper's LLaMA-3.3-70B
(the main path), gemma3-1b, whose local:global windows and ring-buffer
caches the CPU tests exercise, and the recurrent families: RWKV6-3B (SSM,
the WKV scan) and Hymba-1.5B (hybrid: sliding-window attention beside
Mamba heads, the selective scan).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, reduced

ARCHS: List[str] = ["llama3.3-70b", "gemma3-1b", "rwkv6-3b", "hymba-1.5b"]

_MOD = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
        for a in ARCHS}

_cache: Dict[str, ModelConfig] = {}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _cache:
        if arch_id not in _MOD:
            raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MOD)}")
        _cache[arch_id] = importlib.import_module(_MOD[arch_id]).CONFIG
    return _cache[arch_id]


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
