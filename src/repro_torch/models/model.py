"""Dense decoder model (counterpart of ``repro.models.model``, Family.DENSE).

* ``build_param_specs(cfg)`` / ``init_params(cfg, generator, device)`` —
  the parameter tree in the JAX package's layout, layers stacked on a
  leading L axis
* ``init_cache`` — per-layer K/V (L, B, S_c, KV, dh), ``pos_ids`` (S_c,)
  starting at -1, and ``pos``
* ``prefill`` — the prompt pass, filling the cache (ring-rolled when the
  prompt outruns it) and returning last-token logits
* ``decode_step`` — one token, written at slot ``pos % S_c``
* ``verify_step`` — q_len tokens in one pass (speculative verification
  and the engine's chunked prefill), written contiguously from slot
  ``pos % S_c``
* ``decode_layer`` — the one per-layer body that ``decode_step``,
  ``verify_step`` and the interleaved engine all run
* ``init_params_by_layer`` — shared weights plus a layer *source* that
  draws each layer on demand, for models whose layers do not fit the card
  together

The cache dict is updated in place (the JAX reference returns a new one;
PyTorch runs eagerly and copying an 8-layer 70B-width cache per token buys
nothing). ``pos`` stays a host int: the slot arithmetic then needs no
device-to-host sync in every layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import AttnKind, Family, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import spec as pspec
from repro_torch.models.attention import (IMPLS, attention_specs, attn_decode,
                                          attn_decode_multi, attn_forward)
from repro_torch.models.modules import (embed, embed_specs, mlp, mlp_specs,
                                        rms_norm, rms_norm_spec, unembed)

GLOBAL_WINDOW = 2 ** 30   # sentinel: effectively unwindowed


def _check(cfg: ModelConfig, impl: str) -> None:
    if cfg.family != Family.DENSE or cfg.parallel_block:
        raise NotImplementedError(
            f"the port runs the dense family so far, not {cfg.family}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")


# ============================================================================
# Params
# ============================================================================
def _dense_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": rms_norm_spec(cfg.d_model),
        "attn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim),
        "ln2": rms_norm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
    }


def build_param_specs(cfg: ModelConfig) -> dict:
    _check(cfg, "ref")
    specs = dict(embed_specs(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings))
    specs["final_norm"] = rms_norm_spec(cfg.d_model)
    specs["layers"] = pspec.stack(_dense_layer_specs(cfg), cfg.n_layers)
    return specs


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random parameters from a seeded generator (seed 0 when none is
    given), on the card unless ``device='cpu'``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return pspec.init(build_param_specs(cfg), generator, dev)


def init_params_by_layer(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Shared weights (embedding, lm_head, final norm) drawn now, and
    ``"layers"`` a source ``l -> layer l's parameter dict`` that draws
    each layer from its own seed when asked, with init_params'
    distributions (layer weights scaled 1/sqrt(n_layers), the stacked
    fan-in quirk). The values differ from init_params' (other random
    streams); the interleaved engine builds its tiers from such a source
    so the whole model never sits on the card at once."""
    _check(cfg, "ref")
    dev = resolve_device(device)
    shared = dict(embed_specs(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings))
    shared["final_norm"] = rms_norm_spec(cfg.d_model)
    params = pspec.init(shared, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    scale = cfg.n_layers ** -0.5

    def quirk(t):
        return {k: quirk(v) for k, v in t.items()} if isinstance(t, dict) \
            else dataclasses.replace(t, scale=scale)
    layer_specs = quirk(_dense_layer_specs(cfg))

    def source(l: int) -> dict:
        gen = torch.Generator(device=dev).manual_seed(
            (seed + 1) * 1_000_003 + l)
        return pspec.init(layer_specs, gen, dev)
    params["layers"] = source
    return params


def layer_params(params: dict, l: int) -> dict:
    """Layer l's parameters: a view of the stacked tree, or what the
    layer source of init_params_by_layer draws."""
    layers = params["layers"]
    if callable(layers):
        return layers(l)

    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[l]
    return take(layers)


# ============================================================================
# Windows and cache
# ============================================================================
def layer_windows(cfg: ModelConfig, n_layers: int, long_mode: bool = False,
                  offset: int = 0):
    """Visibility window per layer (list of ints)."""
    if cfg.attn_kind == AttnKind.SLIDING:
        return [cfg.window_size] * n_layers
    if cfg.attn_kind == AttnKind.LOCAL_GLOBAL:
        if long_mode:   # long-context serving: cap globals to the window too
            return [cfg.window_size] * n_layers
        return [GLOBAL_WINDOW if (i + offset + 1) % (cfg.local_global_ratio + 1)
                == 0 else cfg.window_size for i in range(n_layers)]
    return [GLOBAL_WINDOW] * n_layers


def kv_cache_len(cfg: ModelConfig, max_len: int, long_mode: bool = False) -> int:
    if cfg.attn_kind == AttnKind.NONE:
        return 0
    if cfg.attn_kind == AttnKind.SLIDING:
        return min(max_len, cfg.window_size)
    if cfg.attn_kind == AttnKind.LOCAL_GLOBAL and long_mode:
        return min(max_len, cfg.window_size)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               long_mode: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    S_c = kv_cache_len(cfg, max_len, long_mode)
    kv = (cfg.n_layers, batch, S_c, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pos": 0,
        "k": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
        "v": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
        "pos_ids": torch.full((S_c,), -1, dtype=torch.int32, device=dev),
    }


# ============================================================================
# Prefill and decode
# ============================================================================
def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache: dict,
            *, impl: str = "ref"):
    """Run the prompt, fill the cache in place, return (last-token logits
    (B, 1, PV), cache). tokens: (B, S) int."""
    _check(cfg, impl)
    B, S = tokens.shape
    S_c = cache["k"].shape[2]
    x = embed(params, tokens).to(torch.bfloat16)
    for l, window in enumerate(layer_windows(cfg, cfg.n_layers)):
        p = layer_params(params, l)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        a_out, (k, v) = attn_forward(p["attn"], xn, rope_theta=cfg.rope_theta,
                                     causal=True, window=window, impl=impl)
        x = x + a_out
        x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        if S <= S_c:      # contiguous fill at slots [0, S)
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
        else:             # ring: keep the last S_c tokens; slot(p) = p mod S_c
            sh = S % S_c
            cache["k"][l] = torch.roll(k[:, S - S_c:], sh, dims=1)
            cache["v"][l] = torch.roll(v[:, S - S_c:], sh, dims=1)
    ar = torch.arange(S_c, dtype=torch.int32, device=tokens.device)
    if S <= S_c:
        ids = torch.where(ar < S, ar, torch.full_like(ar, -1))
    else:
        ids = torch.roll(ar + (S - S_c), S % S_c)
    cache["pos_ids"].copy_(ids)
    cache["pos"] = S
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(params, x), cache


def new_positions(cache: dict, q_len: int) -> int:
    """Mark the q_len positions pos .. pos + q_len - 1 in pos_ids at their
    slots and return the first slot. While pos < S_c, pos % S_c == pos, so
    one rule covers contiguous caches and ring buffers alike. A window of
    q_len > 1 is written contiguously and must not wrap the ring (the
    serving backend caps verify rounds at the cache end)."""
    pos, pos_ids = cache["pos"], cache["pos_ids"]
    S_c = pos_ids.shape[0]
    slot = pos % S_c
    if q_len == 1:
        pos_ids[slot] = pos
    elif slot + q_len > S_c:
        raise ValueError(f"a {q_len}-token window at slot {slot} would wrap "
                         f"the {S_c}-slot cache ring")
    else:
        pos_ids[slot:slot + q_len] = torch.arange(
            pos, pos + q_len, dtype=pos_ids.dtype, device=pos_ids.device)
    return slot


def decode_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 l: int, slot: int, window: int, *, impl: str,
                 multi: bool) -> torch.Tensor:
    """One decoder layer over x (B, q_len, D) at positions cache["pos"] +
    i, writing its K/V into layer l's cache rows from `slot`. multi picks
    the multi-query attention of verify_step (any q_len) over the
    one-token attention of decode_step (q_len 1)."""
    attn = attn_decode_multi if multi else attn_decode
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn(p["attn"], xn, cache["k"][l], cache["v"][l],
                 cache["pos_ids"], cache["pos"], slot,
                 rope_theta=cfg.rope_theta, window=window, impl=impl)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def _step(cfg, params, cache, tokens, *, impl, multi, long_mode=False):
    _check(cfg, impl)
    pos = cache["pos"]
    x = embed(params, tokens).to(torch.bfloat16)
    slot = new_positions(cache, tokens.shape[1])
    for l, window in enumerate(layer_windows(cfg, cfg.n_layers, long_mode)):
        x = decode_layer(cfg, layer_params(params, l), x, cache, l, slot,
                         window, impl=impl, multi=multi)
    cache["pos"] = pos + tokens.shape[1]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, *, impl: str = "ref", long_mode: bool = False):
    """token: (B, 1) int -> (logits (B, 1, PV), cache), cache updated in
    place and pos advanced by one."""
    return _step(cfg, params, cache, token, impl=impl, multi=False,
                 long_mode=long_mode)


def verify_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, *, impl: str = "ref",
                long_mode: bool = False):
    """Score q_len positions in one pass (speculative verification).
    tokens: (B, q_len) int, position pos + i holding tokens[:, i]. Returns
    (logits (B, q_len, PV), cache) with all q_len K/V written and pos
    advanced by q_len. Rolling back rejected positions is resetting
    cache["pos"]: their entries carry pos_ids > pos, invisible to every
    later read until decoding reaches them again."""
    return _step(cfg, params, cache, tokens, impl=impl, multi=True,
                 long_mode=long_mode)
