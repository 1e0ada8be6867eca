"""StableLM-2-12B — dense GQA with stablelm-2 parallel attn+MLP blocks.
[hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="stablelm-12b", family=Family.DENSE,
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    attn_kind=AttnKind.FULL, parallel_block=True,
    source="StableLM-2 model card [hf:stabilityai/stablelm-2-1_6b]",
)
