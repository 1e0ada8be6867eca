"""Pixtral-12B — VLM: mistral-nemo decoder backbone + (stubbed) Pixtral-ViT frontend.

Only the language backbone is implemented: prefill takes precomputed patch
embeddings (frontend_tokens of them) of shape (B, n_patch, d_model).
[hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="pixtral-12b", family=Family.VLM,
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    attn_kind=AttnKind.FULL, rope_theta=1_000_000_000.0,
    frontend_tokens=256,  # 16x16 patch grid worth of image embeddings
    source="Pixtral-12B-2409 model card [hf:mistralai/Pixtral-12B-2409]",
)
