"""State-space / linear-recurrence blocks (counterpart of
``repro.models.ssm``).

* RWKV6 ("Finch") time-mix with data-dependent decay, and the channel-mix
  FFN [arXiv:2404.05892].
* Mamba-style selective-SSM heads of Hymba's hybrid blocks
  [arXiv:2411.13676].

Projections, token shift, the decay LoRA, the causal conv, the D skip,
norms and gates are plain torch, rounding where XLA rounds in the JAX
package (bf16 activations, the decay and dt in fp32, the scan in fp32 and
its output cast to bf16 before the norm). Only the recurrence runs in a
kernel: ``impl="kernel"`` takes kernel 6 (WKV) or 7 (selective scan),
``impl="ref"`` the reference's own time loop (the kernels' plain versions).

The states each block is given (token-shift rows, conv rows, recurrent
state) are updated IN PLACE and returned too, where the JAX functions
return new ones: the model hands in its cache's per-layer views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.modules import rms_norm, silu
from repro_torch.models.spec import ParamSpec

# the reference scans (repro.models.ssm.wkv_scan_ref / ssm_scan_ref) are
# the kernels' plain versions
wkv_scan_ref = wkv_ops.wkv_plain
ssm_scan_ref = ssm_ops.ssm_scan_plain


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.sigmoid as XLA expands it: 1 / (1 + exp(-x)), rounding to
    # x.dtype after each op (see modules.silu)
    return 1.0 / (1.0 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# ----------------------------------------------------------------------------
# RWKV6
# ----------------------------------------------------------------------------
def rwkv_timemix_specs(d: int, n_heads: int, head_dim: int,
                       decay_lora: int = 64) -> dict:
    small = {k: ParamSpec((d,), init="small")
             for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0")}
    return {
        **small,
        "wr": ParamSpec((d, d)),
        "wk": ParamSpec((d, d)),
        "wv": ParamSpec((d, d)),
        "wg": ParamSpec((d, d)),
        "wo": ParamSpec((d, d)),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x_w A) B))
        "wA": ParamSpec((d, decay_lora), init="small"),
        "wB": ParamSpec((decay_lora, d), init="small"),
        "u": ParamSpec((n_heads, head_dim), init="small"),
        "ln_out": ParamSpec((d,), init="zeros"),
    }


def rwkv_channelmix_specs(d: int, d_ff: int) -> dict:
    return {
        "mu_k": ParamSpec((d,), init="small"),
        "mu_r": ParamSpec((d,), init="small"),
        "wk": ParamSpec((d, d_ff)),
        "wv": ParamSpec((d_ff, d)),
        "wr": ParamSpec((d, d)),
    }


def _token_shift(x, last):
    """x: (B, S, D); last: (B, D) token preceding x[:, 0]. Returns the
    shifted sequence and the new last token (a view of x)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1), x[:, -1, :]


def _rwkv_proj(p, x, xs):
    def mix(mu):
        return x + mu.to(x.dtype) * (xs - x)
    r = mix(p["mu_r"]) @ p["wr"]
    k = mix(p["mu_k"]) @ p["wk"]
    v = mix(p["mu_v"]) @ p["wv"]
    g = silu(mix(p["mu_g"]) @ p["wg"])
    xw = mix(p["mu_w"]).float()
    logw = p["w0"].float() + torch.tanh(xw @ p["wA"].float()) @ p["wB"].float()
    w = torch.exp(-torch.exp(logw))              # (B, S, D) in (0, 1)
    return r, k, v, g, w


def rwkv_timemix(p, x, last_x, state, *, n_heads: int, head_dim: int,
                 norm_eps: float, impl: str = "ref"):
    """x: (B, S, D). last_x (B, D) and state (B, H, dh, dh) fp32 are
    updated in place. Returns (out, last_x, state)."""
    B, S, D = x.shape
    xs, new_last = _token_shift(x, last_x)
    r, k, v, g, w = _rwkv_proj(p, x, xs)
    last_x.copy_(new_last)
    hd = (B, S, n_heads, head_dim)
    r, k, v, w = (t.reshape(hd) for t in (r, k, v, w))
    if impl == "kernel":
        out = wkv_ops.wkv(r, k, v, w, p["u"], state)
    else:
        out, new = wkv_scan_ref(r, k, v, w, p["u"], state)
        state.copy_(new)
    out = rms_norm(out.reshape(B, S, D).to(x.dtype), p["ln_out"], norm_eps)
    return (out * g) @ p["wo"], last_x, state


def rwkv_channelmix(p, x, last_x):
    """x: (B, S, D); last_x (B, D) is updated in place. Returns (out,
    last_x)."""
    xs, new_last = _token_shift(x, last_x)
    xk = x + p["mu_k"].to(x.dtype) * (xs - x)
    xr = x + p["mu_r"].to(x.dtype) * (xs - x)
    last_x.copy_(new_last)
    k = torch.square(torch.relu(xk @ p["wk"]))
    return sigmoid(xr @ p["wr"]) * (k @ p["wv"]), last_x


# ----------------------------------------------------------------------------
# Mamba-style selective SSM heads (Hymba)
# ----------------------------------------------------------------------------
def mamba_head_specs(d: int, n_heads: int, head_dim: int, state: int,
                     conv_k: int = 4) -> dict:
    d_inner = n_heads * head_dim
    return {
        "in_x": ParamSpec((d, d_inner)),
        "in_z": ParamSpec((d, d_inner)),
        "conv": ParamSpec((conv_k, d_inner), init="small"),
        "w_dt": ParamSpec((d, n_heads), init="small"),
        "dt_bias": ParamSpec((n_heads,), init="small"),
        "w_B": ParamSpec((d, state), init="small"),
        "w_C": ParamSpec((d, state), init="small"),
        "A_log": ParamSpec((n_heads,), init="small"),
        "D_skip": ParamSpec((n_heads,), init="small"),
        "ln": ParamSpec((d_inner,), init="zeros"),
    }


def _causal_conv(x, kernel, conv_state):
    """Depthwise causal conv. x: (B, S, C), kernel: (K, C), conv_state:
    (B, K-1, C). Returns (out, new conv state) without touching
    conv_state."""
    K = kernel.shape[0]
    xp = torch.cat([conv_state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * kernel[i] for i in range(K))
    return out, (xp[:, -(K - 1):, :] if K > 1 else conv_state)


def mamba_forward(p, x, conv_state, ssm_state, *, n_heads: int, head_dim: int,
                  ssm_size: int, norm_eps: float, impl: str = "ref"):
    """x: (B, S, D). conv_state (B, K-1, H·dh) and ssm_state (B, H, N, dh)
    fp32 are updated in place. Returns (out_heads (B, S, H·dh), conv_state,
    ssm_state)."""
    B, S, D = x.shape
    xi = x @ p["in_x"]
    z = x @ p["in_z"]
    xi, new_conv = _causal_conv(xi, p["conv"], conv_state)
    conv_state.copy_(new_conv)
    xi = silu(xi)
    dt = softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(B, S, n_heads, head_dim)
    if impl == "kernel":
        y = ssm_ops.ssm_scan(xh, dt, Bm, Cm, A, ssm_state)
    else:
        y, new = ssm_scan_ref(xh, dt, Bm, Cm, A, ssm_state)
        ssm_state.copy_(new)
    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, -1).to(x.dtype)
    y = rms_norm(y, p["ln"], norm_eps) * silu(z)
    return y, conv_state, ssm_state
