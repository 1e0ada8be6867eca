"""RWKV6 (Finch) 3B — attention-free RNN with data-dependent decay.
wkv head size 64 -> 40 heads at d_model=2560. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="rwkv6-3b", family=Family.SSM,
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=0,
    d_ff=8960, vocab_size=65536, head_dim=64,
    attn_kind=AttnKind.NONE, ssm_state_size=64,
    source="RWKV6 Finch [arXiv:2404.05892]",
)
