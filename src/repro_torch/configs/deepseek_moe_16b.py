"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6, first layer
dense. [arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family=Family.MOE,
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,          # dense first-layer d_ff
    moe_d_ff=1408,       # fine-grained expert d_ff
    vocab_size=102400, head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, first_dense_layers=1,
    attn_kind=AttnKind.FULL,
    source="DeepSeekMoE [arXiv:2401.06066]",
)
