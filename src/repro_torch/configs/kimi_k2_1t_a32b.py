"""Kimi-K2 1T-A32B — trillion-parameter MoE, 384 experts top-8 + 1 shared.
Assignment specifies GQA kv=8 (paper-table variant). [arXiv:2501.kimi2]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family=Family.MOE,
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432,           # dense first layer d_ff
    moe_d_ff=2048,        # fine-grained expert d_ff
    vocab_size=163840, head_dim=128,
    n_experts=384, n_shared_experts=1, top_k=8, first_dense_layers=1,
    attn_kind=AttnKind.FULL, rope_theta=50_000.0,
    source="Kimi K2 paper table [arXiv:2501.kimi2]",
)
