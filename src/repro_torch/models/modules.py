"""Shared building blocks (counterpart of ``repro.models.modules``).

Each function rounds where the JAX reference rounds, so the two packages
agree to bf16 rounding order: e.g. ``rms_norm`` casts the normalized x
back to the input dtype before the ``(1 + scale)`` multiply, and
``apply_rope`` rotates in fp32 before casting back.
"""
from __future__ import annotations

import torch

from repro_torch.models.spec import ParamSpec


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * (1.0 + scale.to(dt))


def rms_norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), init="zeros")


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / (theta ** ex)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Half-split rotation. x: (..., S, H, dh); positions: broadcastable
    to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (dh/2,)
    ang = positions[..., None].float() * freqs                # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ----------------------------------------------------------------------------
def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "wi_gate": ParamSpec((d_model, d_ff)),
        "wi_up": ParamSpec((d_model, d_ff)),
        "wo": ParamSpec((d_ff, d_model)),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu is x * logistic(x), and XLA expands logistic as
    # 1 / (1 + exp(-x)) rounding to x.dtype after each op; F.silu rounds
    # once and disagrees with the reference on ~1 bf16 value in 4
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = silu(x @ params["wi_gate"])
    return (g * (x @ params["wi_up"])) @ params["wo"]


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------
def round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def embed_specs(vocab: int, d_model: int, tie: bool) -> dict:
    pv = round_up(vocab, 256)   # padded vocab, as the reference's sharding pad
    out = {"embedding": ParamSpec((pv, d_model), scale=1.0)}
    if not tie:
        out["lm_head"] = ParamSpec((d_model, pv))
    return out


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "lm_head" in params:
        return x @ params["lm_head"]
    # tied embeddings (gemma-style): normalize logit scale by 1/sqrt(d)
    return (x * (x.shape[-1] ** -0.5)) @ params["embedding"].T
