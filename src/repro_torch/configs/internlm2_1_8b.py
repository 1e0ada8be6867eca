"""InternLM2-1.8B — dense GQA decoder. [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="internlm2-1.8b", family=Family.DENSE,
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92544, head_dim=128,
    attn_kind=AttnKind.FULL, rope_theta=1_000_000.0,
    source="InternLM2 technical report [arXiv:2403.17297]",
)
