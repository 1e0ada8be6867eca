"""Model/architecture configuration system.

Every assigned architecture (and the paper's own three models) is expressed as a
:class:`ModelConfig`. Configs are *data*: they carry exact dimensions from the
source paper / model card (cited in each ``configs/<id>.py``) plus the knobs the
LIME scheduler needs (block memory proportions p_A / p_M are *derived*, not
hard-coded).

Copied unchanged from ``repro.configs.base``: the PyTorch port imports nothing of
the JAX package, so it keeps its own copy of the framework-free modules.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENCDEC = "encdec"   # audio / seq2seq backbone
    VLM = "vlm"         # decoder backbone consuming patch embeddings


class AttnKind(str, enum.Enum):
    FULL = "full"                 # full causal attention
    SLIDING = "sliding"           # sliding-window attention
    LOCAL_GLOBAL = "local_global" # gemma3-style N local : 1 global
    NONE = "none"                 # attention-free (SSM)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # --- attention structure ---
    attn_kind: AttnKind = AttnKind.FULL
    window_size: int = 1024                 # for sliding / local layers
    local_global_ratio: int = 5             # gemma3: 5 local : 1 global
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None          # per-expert d_ff (fine-grained MoE)
    first_dense_layers: int = 0             # deepseek-moe: layer 0 dense
    router_aux_coef: float = 0.01
    # --- SSM / hybrid ---
    ssm_state_size: int = 0
    ssm_heads: int = 0                      # hymba: # mamba heads in parallel
    # --- enc-dec ---
    n_encoder_layers: int = 0
    # --- modality frontend stub ---
    frontend_tokens: int = 0                # patch/frame embeddings prepended
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    parallel_block: bool = False            # stablelm-2 style parallel attn+MLP
    max_seq_len: int = 524_288
    source: str = ""                        # citation from assignment

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        assert self.n_kv_heads == 0 or self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.name}: n_heads={self.n_heads} not divisible by kv={self.n_kv_heads}")

    # ------------------------------------------------------------------
    # Derived quantities used by the LIME cost model (§IV-B, Tab. I).
    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == AttnKind.NONE

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_params_per_layer(self) -> int:
        """Parameter count of the MHA block (q,k,v,o projections)."""
        if self.is_attention_free:
            # RWKV time-mix block plays the MHA role: r,k,v,g,o + decay.
            return 5 * self.d_model * self.d_model + 2 * self.d_model
        hd = self.head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        if self.family == Family.HYBRID and self.ssm_heads > 0:
            # hymba: parallel SSM heads share the block (in/out proj + ssm params)
            o += 2 * self.d_model * self.d_model + self.ssm_heads * self.ssm_state_size * 2
        if self.family == Family.ENCDEC:
            o += q + kv + o  # cross-attention block in decoder layers
        return q + kv + o

    def mlp_params_per_layer(self, layer_idx: int = 1) -> int:
        """Parameter count of the MLP / expert block of one layer."""
        if self.is_moe and layer_idx >= self.first_dense_layers:
            dff = self.moe_d_ff or self.d_ff
            routed = self.n_experts * 3 * self.d_model * dff
            shared = self.n_shared_experts * 3 * self.d_model * dff
            router = self.d_model * self.n_experts
            return routed + shared + router
        return 3 * self.d_model * self.d_ff  # gated (silu) MLP: up, gate, down

    def layer_params(self, layer_idx: int = 1) -> int:
        return (self.attn_params_per_layer() + self.mlp_params_per_layer(layer_idx)
                + 2 * self.d_model)  # two RMSNorm scales

    def total_params(self) -> int:
        body = sum(self.layer_params(i) for i in range(self.n_layers))
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.n_encoder_layers:
            enc_layer = (4 * self.d_model * self.d_model
                         + 3 * self.d_model * self.d_ff + 2 * self.d_model)
            enc = self.n_encoder_layers * enc_layer
        return body + emb + enc + self.d_model

    def active_params(self) -> int:
        """Activated parameters per token (= total for dense)."""
        if not self.is_moe:
            return self.total_params()
        dff = self.moe_d_ff or self.d_ff
        act_mlp = (self.top_k + self.n_shared_experts) * 3 * self.d_model * dff
        per_layer = self.attn_params_per_layer() + act_mlp + 2 * self.d_model
        dense_layers = self.first_dense_layers
        dense_part = dense_layers * (self.attn_params_per_layer()
                                     + 3 * self.d_model * self.d_ff)
        body = (self.n_layers - dense_layers) * per_layer + dense_part
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        return body + emb + self.d_model

    # LIME block-granularity proportions (Tab. I: p_A, p_M).
    def p_A(self, layer_idx: int = 1) -> float:
        a = self.attn_params_per_layer()
        return a / max(self.layer_params(layer_idx), 1)

    def p_M(self, layer_idx: int = 1) -> float:
        m = self.mlp_params_per_layer(layer_idx)
        return m / max(self.layer_params(layer_idx), 1)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per token across all layers (cost-model `mem(token)`)."""
        if self.is_attention_free:
            return 0  # O(1) state, not per-token
        kv_layers = self.n_layers
        if self.attn_kind == AttnKind.LOCAL_GLOBAL:
            pass  # window caps length, not per-token width
        return kv_layers * 2 * self.n_kv_heads * self.head_dim * dtype_bytes

    def layer_bytes(self, dtype_bytes: int = 2, layer_idx: int = 1) -> int:
        return self.layer_params(layer_idx) * dtype_bytes

    def supports_long_context(self) -> bool:
        """True if decode KV state is sub-linear in context (long_500k eligible)."""
        return self.attn_kind in (AttnKind.NONE, AttnKind.SLIDING,
                                  AttnKind.LOCAL_GLOBAL)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (2 layers, d_model<=512)."""
    small = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads else 0,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        head_dim=64 if cfg.head_dim and cfg.head_dim > 64 else cfg.head_dim,
        max_seq_len=4096,
    )
    if cfg.is_moe:
        small.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     moe_d_ff=min(cfg.moe_d_ff or cfg.d_ff, 128),
                     first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.ssm_state_size:
        small.update(ssm_state_size=min(cfg.ssm_state_size, 16))
    if cfg.ssm_heads:
        small.update(ssm_heads=min(cfg.ssm_heads, 2))
    if cfg.n_encoder_layers:
        small.update(n_encoder_layers=2)
    if cfg.frontend_tokens:
        small.update(frontend_tokens=min(cfg.frontend_tokens, 16))
    if cfg.attn_kind in (AttnKind.SLIDING, AttnKind.LOCAL_GLOBAL):
        small.update(window_size=min(cfg.window_size, 128))
    small.update(overrides)
    fixed = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fixed.update(small)
    # keep head count consistent with kv heads
    if fixed["n_kv_heads"] and fixed["n_heads"] % fixed["n_kv_heads"]:
        fixed["n_heads"] = fixed["n_kv_heads"] * max(
            1, fixed["n_heads"] // fixed["n_kv_heads"])
    # hybrid blocks fuse equal-width attention/SSM head groups
    if fixed["ssm_heads"]:
        fixed["ssm_heads"] = fixed["n_heads"]
    return ModelConfig(**fixed)
