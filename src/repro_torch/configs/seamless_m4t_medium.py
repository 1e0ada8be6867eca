"""SeamlessM4T-medium — encoder-decoder transformer backbone (audio frontend
stubbed: input_specs() feeds conv-feature frame embeddings). [arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig, Family, AttnKind

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family=Family.ENCDEC,
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    n_encoder_layers=12, frontend_tokens=512,
    attn_kind=AttnKind.FULL,
    source="SeamlessM4T [arXiv:2308.11596]",
)
