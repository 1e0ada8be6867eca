"""Llama3.3-70B-Instruct — paper Tab. III row 3 (80L, hidden 8192, 64H, kv=8)."""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="llama3.3-70b", family=Family.DENSE,
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    attn_kind=AttnKind.FULL, rope_theta=500_000.0,
    source="LIME paper Tab. III / Llama3 herd [arXiv:2407.21783]",
)
