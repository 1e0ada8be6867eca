"""CodeQwen1.5-7B — dense, qwen1.5 arch (GQA kv=32 == MHA). [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family=Family.DENSE,
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab_size=92416, head_dim=128,
    attn_kind=AttnKind.FULL, rope_theta=1_000_000.0,
    source="CodeQwen1.5 model card [hf:Qwen/CodeQwen1.5-7B]",
)
