"""Gemma3-1B — dense GQA, 5:1 local(sliding-1024):global, 128k ctx, kv=1.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="gemma3-1b", family=Family.DENSE,
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    attn_kind=AttnKind.LOCAL_GLOBAL, window_size=1024, local_global_ratio=5,
    rope_theta=1_000_000.0, tie_embeddings=True,
    source="Gemma 3 model card [hf:google/gemma-3-1b-pt]",
)
