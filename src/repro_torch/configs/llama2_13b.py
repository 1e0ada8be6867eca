"""Llama2-13B-Instruct — paper Tab. III row 1 (MHA: kv=40)."""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="llama2-13b", family=Family.DENSE,
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=13824, vocab_size=32000, head_dim=128,
    attn_kind=AttnKind.FULL,
    source="LIME paper Tab. III / Llama2 [arXiv:2307.09288]",
)
