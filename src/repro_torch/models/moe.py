"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``): top-k
routing and sort-based grouped expert compute.

Tokens are sorted by expert id (a stable sort), packed into a
capacity-bounded (E, C, D) buffer, the experts run as three batched
products (``torch.bmm``, as XLA runs the reference's einsums), and the
outputs scatter back weighted by the router's probabilities. The layer
computes the reference's function exactly, capacity drops included:

* capacity ``max(1, int(T·K/E·cf + 0.999))`` in Python floats, T the
  token count of *this call*: the caller must call the layer over exactly
  the rows the reference does (a decode step's B, a prefill's B·S, a
  verify pass's B·q_len);
* top-k by a stable descending sort, so the first of tied experts wins,
  as the reference's ``top_k``;
* the router's logits from a full fp32 product (its weights are fp32; no
  TF32 on the card);
* the combine adds each token's kept contributions in ascending expert id
  (the reference's scatter-add order), rounding to the activation dtype
  after each add: deterministic, where ``index_add_`` with atomics on the
  card is not.

The reference's ``_moe_local`` also takes ``expert_slice`` / ``n_local``
(each model shard computing its E/|model| experts inside ``shard_map``),
``constraint_mesh`` (GSPMD pins of the expert dim) and ``moe_forward``
its ``mesh`` / ``mode``: a mesh of devices, which one card does not have.
They are left out; on one device every path of the reference computes
this function.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.modules import mlp, mlp_specs, silu
from repro_torch.models.spec import ParamSpec


def moe_specs(d_model: int, n_experts: int, moe_d_ff: int,
              n_shared: int) -> dict:
    out = {
        "router": ParamSpec((d_model, n_experts), dtype=torch.float32,
                            init="small"),
        "wi_gate": ParamSpec((n_experts, d_model, moe_d_ff)),
        "wi_up": ParamSpec((n_experts, d_model, moe_d_ff)),
        "wo": ParamSpec((n_experts, moe_d_ff, d_model)),
    }
    if n_shared:
        out["shared"] = mlp_specs(d_model, n_shared * moe_d_ff)
    return out


@contextlib.contextmanager
def _full_fp32(device: torch.device):
    """fp32 products in full fp32 on the card (TF32 off) for the block."""
    if device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def _route(router: torch.Tensor, x_flat: torch.Tensor, top_k: int):
    """Returns (weights (T, K) fp32, ids (T, K) int64, probs (T, E) fp32):
    the top-k of the softmax over the fp32 router logits, renormalised."""
    with _full_fp32(x_flat.device):
        logits = x_flat.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, ids, probs


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert for a call over n_tokens tokens."""
    return max(1, int(n_tokens * top_k / n_experts * capacity_factor + 0.999))


def _group_tokens(ids: torch.Tensor, capacity: int, n_experts: int):
    """Sort token-slots by expert; compute packed buffer indices.

    ids: (T, K) -> (order (T·K,), buf_idx (T·K,), keep (T·K,)). buf_idx
    indexes an (E·C + 1)-row buffer; dropped slots go to the dump row."""
    TK = ids.numel()
    e_flat = ids.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order].contiguous()
    # rank within expert = position - first occurrence of this expert id
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.arange(TK, device=ids.device) - first
    keep = rank < capacity
    buf_idx = torch.where(keep, e_sorted * capacity + rank,
                          n_experts * capacity)
    return order, buf_idx, keep


def _expert_ffn(wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor,
                buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, D) -> (E, C, D): each expert's gated MLP on its rows."""
    g = silu(torch.bmm(buf, wg))
    u = torch.bmm(buf, wu)
    return torch.bmm(g * u, wo)


def _moe_local(params: dict, x_flat: torch.Tensor, *, top_k: int,
               n_experts: int, capacity_factor: float, aux: bool = True):
    """The routed experts over x_flat (T, D). Returns (out (T, D), aux),
    aux None unless asked for (serving drops it, as XLA drops the
    reference's unused aux)."""
    T, D = x_flat.shape
    dt = x_flat.dtype
    weights, ids, probs = _route(params["router"], x_flat, top_k)
    cap = capacity(T, top_k, n_experts, capacity_factor)
    order, buf_idx, keep = _group_tokens(ids, cap, n_experts)
    tok = order // top_k                   # slot t·K + k belongs to token t
    w_sorted = weights.reshape(-1)[order]

    # dropped slots all land in the dump row, which is cut off: the
    # reference's x * keep there changes nothing that is read
    buf = x_flat.new_zeros((n_experts * cap + 1, D))
    buf[buf_idx] = x_flat[tok]
    buf = buf[:-1].reshape(n_experts, cap, D)
    y = _expert_ffn(params["wi_gate"], params["wi_up"], params["wo"], buf)
    y = torch.cat([y.reshape(-1, D), x_flat.new_zeros((1, D))], 0)
    gathered = y[buf_idx] * (w_sorted * keep).to(dt)[:, None]

    # the reference's out.at[tok].add(gathered) applies the updates in the
    # sorted-slot order, so a token's contributions add in ascending
    # expert id; its top-k ids are distinct, so ordering them is exact
    per_slot = torch.empty_like(gathered)
    per_slot[order] = gathered                       # (t, k) slot order
    per_slot = per_slot.reshape(T, top_k, D)
    by_expert = torch.argsort(ids, dim=-1)
    per_slot = per_slot.gather(1, by_expert[..., None].expand(T, top_k, D))
    out = per_slot[:, 0]
    for k in range(1, top_k):
        out = out + per_slot[:, k]

    if not aux:
        return out, None
    # Switch-style load-balance aux loss
    me = probs.mean(0)                                        # (E,)
    # counted on the device without a host sync (bincount sizes its
    # output on the host); integer counts add exactly in fp32
    ce = probs.new_zeros((n_experts,)).index_add_(
        0, ids.reshape(-1), probs.new_ones((T * top_k,))) / (T * top_k)
    return out, n_experts * torch.sum(me * ce)


def moe_forward(params: dict, x: torch.Tensor, *, cfg,
                capacity_factor: float = 1.25, aux: bool = True):
    """x: (B, S, D). Returns (out, aux_loss); the router and routed experts
    see the B·S rows of this call as one batch of tokens, then the shared
    experts add a plain gated MLP over every row. aux=False skips the
    aux loss (None), which serving never reads."""
    B, S, D = x.shape
    x_flat = x.reshape(-1, D)
    out_flat, aux = _moe_local(params, x_flat, top_k=cfg.top_k,
                               n_experts=cfg.n_experts,
                               capacity_factor=capacity_factor, aux=aux)
    if "shared" in params:
        out_flat = out_flat + mlp(params["shared"], x_flat)
    return out_flat.reshape(B, S, D), aux


def moe_forward_naive(params: dict, x: torch.Tensor, *, cfg) -> torch.Tensor:
    """O(T·E) per-token oracle for tests: every expert on every token."""
    B, S, D = x.shape
    x_flat = x.reshape(-1, D)
    weights, ids, _ = _route(params["router"], x_flat, cfg.top_k)
    ys = _expert_ffn(params["wi_gate"], params["wi_up"], params["wo"],
                     x_flat.expand((cfg.n_experts,) + tuple(x_flat.shape)))
    onehot = F.one_hot(ids, cfg.n_experts).float()                # (T,K,E)
    w_e = (weights[..., None] * onehot).sum(1)                    # (T,E)
    out = torch.einsum("te,etd->td", w_e.to(x.dtype), ys)
    if "shared" in params:
        out = out + mlp(params["shared"], x_flat)
    return out.reshape(B, S, D)
