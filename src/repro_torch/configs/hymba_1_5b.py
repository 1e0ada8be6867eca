"""Hymba-1.5B — hybrid-head: parallel attention + Mamba heads in each block,
sliding-window attention on most layers, ssm_state=16. [arXiv:2411.13676]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="hymba-1.5b", family=Family.HYBRID,
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    attn_kind=AttnKind.SLIDING, window_size=1024,
    ssm_state_size=16, ssm_heads=25,
    source="Hymba [arXiv:2411.13676]",
)
