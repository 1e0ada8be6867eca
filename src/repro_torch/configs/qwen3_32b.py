"""Qwen3-32B — paper Tab. III row 2 (64L, hidden 5120, 64H, kv=8)."""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="qwen3-32b", family=Family.DENSE,
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128,
    attn_kind=AttnKind.FULL, rope_theta=1_000_000.0,
    source="LIME paper Tab. III / Qwen3 [arXiv:2505.09388]",
)
