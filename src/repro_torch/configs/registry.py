"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

Carries the architectures the port runs so far:

* the paper's three models (Tab. III, ``PAPER_MODELS``): LLaMA-2-13B (MHA:
  40 KV heads, G 1), Qwen3-32B (G 8) and LLaMA-3.3-70B (the main path);
* the other dense decoders: internlm2-1.8b (G 2), codeqwen1.5-7b (G 1),
  stablelm-12b (parallel attention and MLP blocks on one pre-norm, head
  dim 160) and gemma3-1b, whose local:global windows and ring-buffer
  caches the CPU tests exercise;
* pixtral-12b, the VLM: its decoder backbone, prefilled with patch
  embeddings before the text;
* the recurrent families: RWKV6-3B (SSM, the WKV scan) and Hymba-1.5B
  (hybrid: sliding-window attention beside Mamba heads, the selective
  scan);
* the MoE family: DeepSeekMoE-16B (64 routed top-6 + 2 shared experts)
  and Kimi-K2 (384 routed top-8 + 1 shared), each with a dense first
  layer;
* the encoder-decoder family: SeamlessM4T-medium (12 bidirectional
  encoder layers over frame embeddings, 12 decoder layers with
  cross-attention to the encoder's output).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, reduced

PAPER_MODELS: List[str] = [
    "llama2-13b",      # paper Tab. III row 1
    "qwen3-32b",       # paper Tab. III row 2
    "llama3.3-70b",    # paper Tab. III row 3
]

ARCHS: List[str] = PAPER_MODELS + [
    "internlm2-1.8b", "codeqwen1.5-7b", "stablelm-12b", "pixtral-12b",
    "gemma3-1b", "rwkv6-3b", "hymba-1.5b", "deepseek-moe-16b",
    "kimi-k2-1t-a32b", "seamless-m4t-medium"]

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
