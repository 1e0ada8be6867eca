"""Decoder models (counterpart of ``repro.models.model``): the dense
family (with StableLM-2's parallel blocks: attention and MLP on one
pre-norm, no second norm), the VLM family (the dense backbone, prefilled
with patch embeddings before the text), the MoE family (attention, then
routed and shared experts, ``models/moe.py``; DeepSeekMoE and Kimi-K2
put ``first_dense_layers`` dense layers first, stacked apart as
``"dense_layers"``), the SSM family (RWKV6), the hybrid family (Hymba:
attention and Mamba heads side by side in each block) and the
encoder-decoder family (SeamlessM4T: a bidirectional encoder over frame
embeddings, stacked as ``"encoder"``; decoder layers of causal
self-attention, cross-attention to the encoder's output, then the MLP).

* ``build_param_specs(cfg)`` / ``init_params(cfg, generator, device)`` —
  the parameter tree in the JAX package's layout, layers stacked on a
  leading L axis
* ``init_cache`` — per family: K/V (L, B, S_c, KV, dh), ``pos_ids`` (S_c,)
  starting at -1 (dense, hybrid); the RWKV state (L, B, H, dh, dh) fp32 and
  the two token-shift rows (L, B, D) (SSM); the conv rows (L, B, 3,
  H_ssm·dh) and the scan state (L, B, H_ssm, N, dh) fp32 (hybrid); the
  cross K/V ``xk`` / ``xv`` (L, B, S_enc, KV, dh) beside K/V
  (encoder-decoder, given ``enc_out`` or ``enc_len``); and ``pos``
* ``encode`` — the encoder-decoder family's encoder: frame embeddings
  (B, S_enc, D) through bidirectional self-attention layers with rope
* ``cross_kv_layer`` / ``seed_cross_kv`` — a decoder layer's cross K/V
  projected from the encoder's output, one layer / every layer into the
  cache
* ``prefill`` — the prompt pass, filling the cache (K/V ring-rolled when
  the prompt outruns the cache, the recurrent states as the scans leave
  them) and returning last-token logits; ``frontend_embeds`` (B, n_patch,
  d_model) go in front of the prompt's embeddings and take its first
  positions (the encoder-decoder family: they feed the encoder, and
  ``enc_out`` seeds the cross K/V)
* ``decode_step`` — one token, written at slot ``pos % S_c``; the
  recurrent families advance their states by one step; the
  encoder-decoder family sees the encoder's frames below ``enc_len``
* ``verify_step`` — q_len tokens in one pass (speculative verification
  and the engine's chunked prefill), written contiguously from slot
  ``pos % S_c``; dense and MoE only (a recurrent state cannot roll back
  by masking; the VLM and the encoder-decoder family are refused as the
  reference refuses them)
* ``step_layer`` / ``prefill_layer`` — the one per-layer body of a
  decode (or verify) step and of a prompt pass, by family, that the
  model and the interleaved engine both run (``decode_layer`` is the dense
  one of a step)
* ``init_params_by_layer`` — shared weights plus a layer *source* that
  draws each layer on demand, for models whose layers do not fit the card
  together (every family of ``_LAYER_SPECS``)

The cache dict is updated in place (the JAX reference returns a new one;
PyTorch runs eagerly and copying an 8-layer 70B-width cache per token buys
nothing). ``cache["pos"]`` stays a host int, the JAX API every caller
reads. A step is split as the JAX package's jitted step is: a host
prelude (the checks, the ring-wrap check of a verify window), a device
body (``step_body``: pure tensor work that reads the position from a 0-d
int32 device tensor mirroring ``cache["pos"]``, writes K/V and pos_ids at
slots computed on the device, and reads no host value that changes
between tokens) and a host epilogue (``cache["pos"] += q_len``). The
prefill is split alike (``prefill_prelude``: the checks, the
frontend-embedding branch, the cross K/V buffers; ``prefill_body``;
``prefill_epilogue``: ``cache["pos"]``). The eager step and a captured
one (``steps=``, a ``core.capture.CapturedStep`` replaying one CUDA graph
per shape, a prefill's per prompt shape) run the same body.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.base import AttnKind, Family, ModelConfig
from repro_torch.core import capture
from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import spec as pspec
from repro_torch.models.attention import (IMPLS, attention_specs, attn_decode,
                                          attn_decode_multi, attn_forward,
                                          cross_attn_decode,
                                          cross_attn_prefill, cross_kv,
                                          cross_pos)
from repro_torch.models.modules import (embed, embed_specs, mlp, mlp_specs,
                                        rms_norm, rms_norm_spec, unembed)
from repro_torch.models.ssm import (mamba_forward, mamba_head_specs,
                                    rwkv_channelmix, rwkv_channelmix_specs,
                                    rwkv_timemix, rwkv_timemix_specs)

GLOBAL_WINDOW = 2 ** 30   # sentinel: effectively unwindowed


FAMILIES = (Family.DENSE, Family.VLM, Family.MOE, Family.SSM, Family.HYBRID,
            Family.ENCDEC)
# the families whose per-layer decode state is K/V alone (a verify pass
# rolls back by masking), as the reference's verify_step admits
PURE_KV = (Family.DENSE, Family.MOE)


def _check(cfg: ModelConfig, impl: str) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port runs the dense, VLM, MoE, SSM, hybrid and "
            f"encoder-decoder families, not {cfg.family}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")


def _check_pure_kv(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in PURE_KV:
        raise NotImplementedError(
            f"{what} needs pure-KV per-layer state (the dense family or "
            f"MoE), not {cfg.family}")


# ============================================================================
# Params
# ============================================================================
def _dense_layer_specs(cfg: ModelConfig) -> dict:
    s = {
        "ln1": rms_norm_spec(cfg.d_model),
        "attn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim),
    }
    if not cfg.parallel_block:
        s["ln2"] = rms_norm_spec(cfg.d_model)
    s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff)
    return s


def _moe_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": rms_norm_spec(cfg.d_model),
        "attn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim),
        "ln2": rms_norm_spec(cfg.d_model),
        "moe": moe_mod.moe_specs(cfg.d_model, cfg.n_experts,
                                 cfg.moe_d_ff or cfg.d_ff,
                                 cfg.n_shared_experts),
    }


def _rwkv_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": rms_norm_spec(cfg.d_model),
        "tm": rwkv_timemix_specs(cfg.d_model, cfg.n_heads, cfg.head_dim),
        "ln2": rms_norm_spec(cfg.d_model),
        "cm": rwkv_channelmix_specs(cfg.d_model, cfg.d_ff),
    }


def _hymba_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": rms_norm_spec(cfg.d_model),
        "attn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim),
        "mamba": mamba_head_specs(cfg.d_model, cfg.ssm_heads, cfg.head_dim,
                                  cfg.ssm_state_size),
        "ln_attn": rms_norm_spec(cfg.n_heads * cfg.head_dim),
        "ln_ssm": rms_norm_spec(cfg.ssm_heads * cfg.head_dim),
        "w_fuse": pspec.ParamSpec((cfg.n_heads * cfg.head_dim, cfg.d_model)),
        "ln2": rms_norm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
    }


def _encdec_decoder_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": rms_norm_spec(cfg.d_model),
        "attn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim),
        "ln_x": rms_norm_spec(cfg.d_model),
        "xattn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim),
        "ln2": rms_norm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
    }


_LAYER_SPECS = {Family.DENSE: _dense_layer_specs, Family.VLM: _dense_layer_specs,
                Family.MOE: _moe_layer_specs, Family.SSM: _rwkv_layer_specs,
                Family.HYBRID: _hymba_layer_specs,
                Family.ENCDEC: _encdec_decoder_layer_specs}


def n_dense_first(cfg: ModelConfig) -> int:
    """The MoE family's leading dense layers (0 for every other family)."""
    return cfg.first_dense_layers if cfg.family == Family.MOE else 0


def layer_specs(cfg: ModelConfig, l: int) -> dict:
    """Layer l's (unstacked) parameter specs: a dense layer below
    first_dense_layers of an MoE config, else the family's layer."""
    if l < n_dense_first(cfg):
        return _dense_layer_specs(cfg)
    return _LAYER_SPECS[cfg.family](cfg)


def _shared_specs(cfg: ModelConfig) -> dict:
    """The weights outside the decoder stack: embedding, lm_head, final
    norm, and an encoder-decoder config's encoder stack (dense layers) and
    its final norm."""
    specs = dict(embed_specs(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings))
    specs["final_norm"] = rms_norm_spec(cfg.d_model)
    if cfg.family == Family.ENCDEC:
        specs["encoder"] = pspec.stack(_dense_layer_specs(cfg),
                                       cfg.n_encoder_layers)
        specs["enc_final_norm"] = rms_norm_spec(cfg.d_model)
    return specs


def build_param_specs(cfg: ModelConfig) -> dict:
    """The reference's tree: an MoE config's dense first layers stacked
    as "dense_layers", the rest as "layers"; an encoder-decoder config's
    encoder as "encoder" beside "enc_final_norm"."""
    _check(cfg, "ref")
    specs = _shared_specs(cfg)
    nd = n_dense_first(cfg)
    if nd:
        specs["dense_layers"] = pspec.stack(_dense_layer_specs(cfg), nd)
    specs["layers"] = pspec.stack(_LAYER_SPECS[cfg.family](cfg),
                                  cfg.n_layers - nd)
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
    """Shared weights (embedding, lm_head, final norm; an encoder-decoder
    config's encoder stack, at its own stack's scale, and its final norm)
    drawn now, and ``"layers"`` a source ``l -> layer l's parameter
    dict`` that draws each decoder layer from its own seed when asked,
    with init_params' distributions (layer weights scaled 1/sqrt(n) for a
    stack of n, the stacked fan-in quirk: an MoE config's dense first
    layers at their own stack's scale), for any family ``_LAYER_SPECS``
    names. The values
    differ from init_params' (other random streams); the interleaved
    engine builds its tiers from such a source so the whole model never
    sits on the card at once."""
    _check(cfg, "ref")
    dev = resolve_device(device)
    params = pspec.init(_shared_specs(cfg),
                        torch.Generator(device=dev).manual_seed(seed), dev)
    nd = n_dense_first(cfg)

    def quirk(t, scale):
        return {k: quirk(v, scale) for k, v in t.items()} \
            if isinstance(t, dict) else dataclasses.replace(t, scale=scale)

    def source(l: int) -> dict:
        gen = torch.Generator(device=dev).manual_seed(
            (seed + 1) * 1_000_003 + l)
        stack = nd if l < nd else cfg.n_layers - nd
        return pspec.init(quirk(layer_specs(cfg, l), stack ** -0.5), gen, dev)
    params["layers"] = source
    return params


def _take(t: dict, l: int) -> dict:
    """Entry l of every leaf of a stacked tree (views)."""
    return {k: _take(v, l) for k, v in t.items()} if isinstance(t, dict) \
        else t[l]


def layer_params(params: dict, l: int) -> dict:
    """Layer l's parameters: a view of the stacked tree (an MoE config's
    "dense_layers" first, then "layers"), or what the layer source of
    init_params_by_layer draws."""
    layers = params["layers"]
    if callable(layers):
        return layers(l)
    if "dense_layers" in params:
        nd = next(_tensors(params["dense_layers"])).shape[0]
        if l < nd:
            layers = params["dense_layers"]
        else:
            l -= nd
    return _take(layers, l)


def _tensors(t):
    for v in t.values():
        yield from (_tensors(v) if isinstance(v, dict) else (v,))


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
               long_mode: bool = False, device=None, *,
               enc_out: Optional[torch.Tensor] = None,
               enc_len: int = 0) -> dict:
    """An empty cache for `batch` sequences of up to max_len positions.
    An encoder-decoder config given the encoder's output enc_out (B,
    S_enc, D), or its length enc_len, also holds zero cross K/V ``xk`` /
    ``xv`` (L, B, S_enc, KV, dh) bf16, as the reference's cache_specs;
    seed_cross_kv fills them."""
    _check(cfg, "ref")
    dev = resolve_device(device)
    L = cfg.n_layers
    cache = {"pos": 0}
    S_c = kv_cache_len(cfg, max_len, long_mode)
    if S_c:
        kv = (L, batch, S_c, cfg.n_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(kv, dtype=torch.bfloat16, device=dev)
        cache["v"] = torch.zeros(kv, dtype=torch.bfloat16, device=dev)
        cache["pos_ids"] = torch.full((S_c,), -1, dtype=torch.int32,
                                      device=dev)
    if cfg.family == Family.SSM:
        cache["rwkv_state"] = torch.zeros(
            (L, batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
            dtype=torch.float32, device=dev)
        for key in ("last_tm", "last_cm"):
            cache[key] = torch.zeros((L, batch, cfg.d_model),
                                     dtype=torch.bfloat16, device=dev)
    if cfg.family == Family.HYBRID:
        d_inner = cfg.ssm_heads * cfg.head_dim
        cache["conv_state"] = torch.zeros((L, batch, 3, d_inner),
                                          dtype=torch.bfloat16, device=dev)
        cache["ssm_state"] = torch.zeros(
            (L, batch, cfg.ssm_heads, cfg.ssm_state_size, cfg.head_dim),
            dtype=torch.float32, device=dev)
    if enc_out is not None:
        enc_len = enc_out.shape[1]
    if cfg.family == Family.ENCDEC and enc_len:
        xkv = (L, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        cache["xk"] = torch.zeros(xkv, dtype=torch.bfloat16, device=dev)
        cache["xv"] = torch.zeros(xkv, dtype=torch.bfloat16, device=dev)
    return cache


def clear_cache(cache: dict) -> dict:
    """init_cache's values written into an existing cache in place (K/V
    and states zero, pos_ids -1, pos 0): its tensors keep their addresses,
    so a captured step's graph over them stays valid. Returns the cache."""
    clear_tensors(cache)
    cache["pos"] = 0
    return cache


def clear_tensors(cache: dict) -> None:
    """clear_cache's device work alone (the host pos left as it is): the
    part a captured prompt pass runs inside its graph."""
    for key, t in cache.items():
        if key == "pos_ids":
            t.fill_(-1)
        elif isinstance(t, torch.Tensor):
            t.zero_()


# ============================================================================
# Encoder and cross K/V (encoder-decoder family)
# ============================================================================
def encode(cfg: ModelConfig, params: dict, frame_embeds: torch.Tensor, *,
           impl: str = "ref") -> torch.Tensor:
    """The encoder pass: frame embeddings (B, S_enc, D), cast to bf16,
    through the encoder's dense layers with bidirectional self-attention
    (rope, no window; flash attention with causal=False under impl
    "kernel"), then its final norm. Returns (B, S_enc, D)."""
    _check(cfg, impl)
    x = frame_embeds.to(torch.bfloat16)
    enc = params["encoder"]
    for l in range(cfg.n_encoder_layers):
        p = _take(enc, l)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        a_out, _ = attn_forward(p["attn"], xn, rope_theta=cfg.rope_theta,
                                causal=False, window=None, impl=impl)
        x = dense_rest(cfg, p, x, xn, a_out)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def cross_kv_layer(p: dict, enc_out: torch.Tensor):
    """A decoder layer's cross K/V (B, S_enc, KV, dh): the encoder's output
    through that layer's own xattn.wk / wv. The one body of seed_cross_kv
    and of the interleaved engine's prompt pass."""
    return cross_kv(p["xattn"], enc_out.to(p["xattn"]["wk"].dtype))


def seed_cross_kv(cfg: ModelConfig, params: dict, cache: dict,
                  enc_out: torch.Tensor) -> dict:
    """Every decoder layer's cross K/V of the encoder's output enc_out
    (B, S_enc, D) into the cache's ``xk`` / ``xv`` (allocated where the
    cache holds none of that length), in place; returns the cache."""
    _ensure_cross(cfg, cache, enc_out)
    _write_cross(cfg, params, cache, enc_out)
    return cache


def _ensure_cross(cfg: ModelConfig, cache: dict, src: torch.Tensor) -> None:
    """The host half of seed_cross_kv: ``xk`` / ``xv`` allocated for src's
    (B, S_enc) where the cache holds none of that shape, and the decode
    kernel's constant made (cross_pos), before any captured body runs."""
    B, S_enc = src.shape[:2]
    shape = (cfg.n_layers, B, S_enc, cfg.n_kv_heads, cfg.head_dim)
    if "xk" not in cache or tuple(cache["xk"].shape) != shape:
        for key in ("xk", "xv"):
            cache[key] = torch.zeros(shape, dtype=torch.bfloat16,
                                     device=src.device)
    cross_pos(S_enc, src.device)


def _write_cross(cfg: ModelConfig, params: dict, cache: dict,
                 enc_out: torch.Tensor) -> None:
    for l in range(cfg.n_layers):
        cache["xk"][l], cache["xv"][l] = cross_kv_layer(
            layer_params(params, l), enc_out)


# ============================================================================
# Recurrent layer bodies (one body for a prompt and for one token)
# ============================================================================
def _rwkv_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                l: int, *, impl: str) -> torch.Tensor:
    """One RWKV6 layer over x (B, S, D), advancing layer l's token-shift
    rows and WKV state in the cache in place."""
    h, _, _ = rwkv_timemix(p["tm"], rms_norm(x, p["ln1"], cfg.norm_eps),
                           cache["last_tm"][l], cache["rwkv_state"][l],
                           n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                           norm_eps=cfg.norm_eps, impl=impl)
    x = x + h
    h, _ = rwkv_channelmix(p["cm"], rms_norm(x, p["ln2"], cfg.norm_eps),
                           cache["last_cm"][l])
    return x + h


def _hymba_rest(cfg: ModelConfig, p: dict, x: torch.Tensor, xn: torch.Tensor,
                a_out: torch.Tensor, cache: dict, l: int, *,
                impl: str) -> torch.Tensor:
    """The rest of a Hymba layer once its attention a_out over the normed
    xn is known: the Mamba heads on xn (layer l's conv rows and scan state
    advanced in place), the fused head groups, then the MLP."""
    m_out, _, _ = mamba_forward(p["mamba"], xn, cache["conv_state"][l],
                                cache["ssm_state"][l], n_heads=cfg.ssm_heads,
                                head_dim=cfg.head_dim,
                                ssm_size=cfg.ssm_state_size,
                                norm_eps=cfg.norm_eps, impl=impl)
    fused = 0.5 * (rms_norm(a_out, p["ln_attn"], cfg.norm_eps)
                   + rms_norm(m_out, p["ln_ssm"], cfg.norm_eps))
    return dense_rest(cfg, p, x, xn, fused @ p["w_fuse"])


def _encdec_rest(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 a_out: torch.Tensor, cache: dict, l: int,
                 cross) -> torch.Tensor:
    """The rest of an encoder-decoder layer once its self-attention a_out
    is known: the residual add, cross-attention on its own pre-norm
    (ln_x) against layer l's cross K/V, then the MLP on ln2.
    cross(params, xn, ck, cv) is a prompt pass's or a step's
    cross-attention."""
    x = x + a_out
    xn = rms_norm(x, p["ln_x"], cfg.norm_eps)
    x = x + cross(p["xattn"], xn, cache["xk"][l], cache["xv"][l])
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def _check_cross(cache: dict) -> None:
    if "xk" not in cache:
        raise ValueError(
            "an encoder-decoder cache needs its cross K/V: prefill with "
            "enc_out= (or frontend_embeds=, which feed the encoder), or "
            "seed_cross_kv (the reference's serving route, M.prefill "
            "without enc_out, fails here with KeyError 'xk')")


def dense_rest(cfg: ModelConfig, p: dict, x: torch.Tensor, xn: torch.Tensor,
               a_out: torch.Tensor) -> torch.Tensor:
    """The rest of a dense or MoE layer once its attention a_out over the
    normed xn is known: the MLP (an MoE layer's experts, over the B·S rows
    of x as one batch of tokens: the reference's capacity) after the
    residual add, on its own pre-norm; or, for a parallel block
    (StableLM-2), the MLP on the attention's pre-norm xn, both added to
    the residual. The MoE layer's aux loss is not computed (serving)."""
    if cfg.parallel_block:
        return x + a_out + mlp(p["mlp"], xn)
    x = x + a_out
    if "moe" in p:
        m_out, _ = moe_mod.moe_forward(
            p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg=cfg, aux=False)
        return x + m_out
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


# ============================================================================
# Prefill and decode
# ============================================================================
def _write_kv(cache: dict, l: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Layer l's prompt K/V (B, S, KV, dh) into the cache: slots [0, S), or
    the last S_c positions ring-rolled so that slot(p) = p mod S_c."""
    S, S_c = k.shape[1], cache["k"].shape[2]
    if S <= S_c:
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
    else:
        sh = S % S_c
        cache["k"][l] = torch.roll(k[:, S - S_c:], sh, dims=1)
        cache["v"][l] = torch.roll(v[:, S - S_c:], sh, dims=1)


def _prompt_pos_ids(cache: dict, S: int) -> None:
    pos_ids = cache["pos_ids"]
    S_c = pos_ids.shape[0]
    ar = torch.arange(S_c, dtype=torch.int32, device=pos_ids.device)
    if S <= S_c:
        ids = torch.where(ar < S, ar, torch.full_like(ar, -1))
    else:
        ids = torch.roll(ar + (S - S_c), S % S_c)
    pos_ids.copy_(ids)


def prefill_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                  l: int, window: int, *, impl: str) -> torch.Tensor:
    """Layer l of a prompt pass over x (B, S, D) with weights p: its K/V
    written into layer l's cache rows (ring-rolled past S_c), its
    recurrent states advanced over the S steps, in place (an
    encoder-decoder layer reads its cross K/V, already in the cache). The
    one body of prefill and of the interleaved engine's prefill over its
    tiers."""
    if cfg.family == Family.SSM:
        return _rwkv_layer(cfg, p, x, cache, l, impl=impl)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    a_out, (k, v) = attn_forward(p["attn"], xn, rope_theta=cfg.rope_theta,
                                 causal=True, window=window, impl=impl)
    _write_kv(cache, l, k, v)
    if cfg.family == Family.HYBRID:
        return _hymba_rest(cfg, p, x, xn, a_out, cache, l, impl=impl)
    if cfg.family == Family.ENCDEC:
        return _encdec_rest(cfg, p, x, a_out, cache, l, functools.partial(
            cross_attn_prefill, impl=impl))
    return dense_rest(cfg, p, x, xn, a_out)


def prefill_positions(cache: dict, S: int) -> None:
    """After every layer of an S-position prompt pass: the attention
    families' cache holds positions 0 .. S - 1 (pos_ids ring-rolled past
    S_c); the SSM family's continues from its position. The device half
    (prompt_pos_ids) and the host half (prefill_epilogue) in one."""
    prompt_pos_ids(cache, S)
    prefill_epilogue(cache, S)


def prompt_pos_ids(cache: dict, S: int) -> None:
    """The device half of prefill_positions: pos_ids of an S-position
    prompt (a function of S alone, a static shape)."""
    if "pos_ids" in cache:
        _prompt_pos_ids(cache, S)


def prefill_epilogue(cache: dict, S: int) -> None:
    """The host half of prefill_positions: cache["pos"] = S, or + S for
    the SSM family, which continues from its position."""
    if "pos_ids" in cache:
        cache["pos"] = S
    else:
        cache["pos"] += S


def prefill_prelude(cfg: ModelConfig, cache: dict, *,
                    frontend_embeds: Optional[torch.Tensor], impl: str,
                    enc_out: Optional[torch.Tensor]):
    """The host prelude of prefill: the checks, the frontend-embedding
    branch taken, the cross K/V buffers allocated. Returns (kind, inputs):
    kind None (tokens alone), "enc_out" (the encoder's output seeds the
    cross K/V), "frames" (frame embeddings feed the encoder first) or
    "patches" (patch embeddings in front of the tokens), and the body's
    static inputs (that tensor, or none)."""
    _check(cfg, impl)
    if cfg.family == Family.ENCDEC:
        if frontend_embeds is not None and enc_out is not None:
            raise ValueError("frontend_embeds feed the encoder: give them or "
                             "enc_out, not both")
        src = frontend_embeds if frontend_embeds is not None else enc_out
        if src is not None:
            _ensure_cross(cfg, cache, src)
        _check_cross(cache)
        if src is None:
            return None, ()
        return ("frames" if frontend_embeds is not None else "enc_out"), (src,)
    if enc_out is not None:
        raise ValueError(f"enc_out feeds the encoder-decoder family, not "
                         f"{cfg.family}")
    if frontend_embeds is None:
        return None, ()
    if cfg.family == Family.SSM:
        raise NotImplementedError("frontend embeddings feed the attention "
                                  "families' prefill, not the SSM's")
    return "patches", (frontend_embeds,)


def prefill_body(cfg: ModelConfig, params: dict, cache: dict,
                 tokens: torch.Tensor, pos: torch.Tensor, *inputs,
                 impl: str, kind: Optional[str] = None) -> torch.Tensor:
    """The device body of prefill: tokens (B, S) (and the prelude's static
    inputs) through every layer, the cache filled in place (the cross K/V
    first, from the encoder's output, which "frames" computes here) and
    pos_ids written. pos (a 0-d int32 device tensor equal to cache["pos"])
    is read by no family: the attention families start at position 0, the
    SSM family's layers carry no position. Returns the last-token logits
    (B, 1, PV); reads no host value that changes between calls."""
    src = inputs[0] if inputs else None
    if kind == "frames":
        src = encode(cfg, params, src, impl=impl)
    if kind in ("frames", "enc_out"):
        _write_cross(cfg, params, cache, src)
    x = embed(params, tokens).to(torch.bfloat16)
    if kind == "patches":
        x = torch.cat([src.to(x.dtype), x], 1)
    windows = layer_windows(cfg, cfg.n_layers)
    for l in range(cfg.n_layers):
        x = prefill_layer(cfg, layer_params(params, l), x, cache, l,
                          windows[l], impl=impl)
    prompt_pos_ids(cache, x.shape[1])
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed(params, x)


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache: dict,
            *, frontend_embeds: Optional[torch.Tensor] = None,
            impl: str = "ref", enc_out: Optional[torch.Tensor] = None,
            steps: Optional[capture.CapturedStep] = None):
    """Run the prompt, fill the cache in place, return (last-token logits
    (B, 1, PV), cache). tokens: (B, S) int. The SSM family continues from
    the cache's states and position (as the reference's _ssm_prefill);
    the attention families start from an empty cache. frontend_embeds
    (B, n_patch, d_model), where given (the VLM's patch embeddings), are
    cast to bf16 and run in front of the tokens: they take positions
    0 .. n_patch - 1 and the cache counts them. The encoder-decoder
    family: enc_out (B, S_enc, D), the encoder's output, seeds the cross
    K/V first (seed_cross_kv); frontend_embeds (its frame embeddings) go
    through encode to give it, never in front of the tokens; with
    neither, the cache must hold seeded cross K/V. Split as a step is:
    prefill_prelude, prefill_body, prefill_epilogue; with `steps` (a
    CapturedStep) the body replays its CUDA graph for this prompt shape
    (the counterpart of the JAX package's jax.jit of prefill)."""
    kind, inputs = prefill_prelude(cfg, cache, frontend_embeds=frontend_embeds,
                                   impl=impl, enc_out=enc_out)

    def body(tok, pos, *inp):
        return prefill_body(cfg, params, cache, tok, pos, *inp, impl=impl,
                            kind=kind)
    logits = capture.run(
        steps, ("prefill", kind, impl), body, tokens, cache["pos"],
        scope=lambda: (id(params), capture.tensor_scope(cache)),
        device=params["final_norm"].device, inputs=inputs)
    S = tokens.shape[1] + (inputs[0].shape[1] if kind == "patches" else 0)
    prefill_epilogue(cache, S)
    return logits, cache


def check_window(cache: dict, q_len: int) -> None:
    """Host prelude of a step: a window of q_len > 1 is written
    contiguously from slot pos % S_c and must not wrap the cache ring (the
    serving backend caps verify rounds at the cache end)."""
    pos, S_c = cache["pos"], cache["pos_ids"].shape[0]
    slot = pos % S_c
    if q_len > 1 and slot + q_len > S_c:
        raise ValueError(f"a {q_len}-token window at slot {slot} would wrap "
                         f"the {S_c}-slot cache ring")


def new_positions(cache: dict, q_len: int, pos: torch.Tensor) -> torch.Tensor:
    """Mark the q_len positions pos .. pos + q_len - 1 in pos_ids at their
    slots (pos + i) % S_c and return the slots (q_len,) int64, all on the
    device (pos: a 0-d int32 tensor there). While pos < S_c, pos % S_c ==
    pos, so one rule covers contiguous caches and ring buffers alike; a
    window of q_len > 1 does not wrap (check_window), so its slots are
    contiguous."""
    pos_ids = cache["pos_ids"]
    qpos = pos + torch.arange(q_len, device=pos_ids.device)
    slots = qpos % pos_ids.shape[0]
    pos_ids.index_copy_(0, slots, qpos.to(pos_ids.dtype))
    return slots


def decode_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 l: int, slots: torch.Tensor, pos: torch.Tensor, window: int,
                 *, impl: str, multi: bool) -> torch.Tensor:
    """One dense decoder layer over x (B, q_len, D) at positions pos + i
    (pos a 0-d int32 device tensor), writing its K/V into layer l's cache
    rows at `slots`. multi picks the multi-query attention of verify_step
    (any q_len) over the one-token attention of decode_step (q_len 1)."""
    attn = attn_decode_multi if multi else attn_decode
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    a_out = attn(p["attn"], xn, cache["k"][l], cache["v"][l],
                 cache["pos_ids"], pos, slots,
                 rope_theta=cfg.rope_theta, window=window, impl=impl)
    return dense_rest(cfg, p, x, xn, a_out)


def _hymba_decode_layer(cfg: ModelConfig, p: dict, x: torch.Tensor,
                        cache: dict, l: int, slots: torch.Tensor,
                        pos: torch.Tensor, window: int, *,
                        impl: str) -> torch.Tensor:
    """One Hymba layer over one token x (B, 1, D): its K/V written at
    `slots`, its recurrent state advanced by one step."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    a_out = attn_decode(p["attn"], xn, cache["k"][l], cache["v"][l],
                        cache["pos_ids"], pos, slots,
                        rope_theta=cfg.rope_theta, window=window, impl=impl)
    return _hymba_rest(cfg, p, x, xn, a_out, cache, l, impl=impl)


def _encdec_decode_layer(cfg: ModelConfig, p: dict, x: torch.Tensor,
                         cache: dict, l: int, slots: torch.Tensor,
                         pos: torch.Tensor, window: int, *, impl: str,
                         enc_len: int) -> torch.Tensor:
    """One encoder-decoder layer over one token x (B, 1, D): its K/V
    written at `slots`, its cross-attention over the frames below
    enc_len."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    a_out = attn_decode(p["attn"], xn, cache["k"][l], cache["v"][l],
                        cache["pos_ids"], pos, slots,
                        rope_theta=cfg.rope_theta, window=window, impl=impl)
    return _encdec_rest(cfg, p, x, a_out, cache, l, functools.partial(
        cross_attn_decode, enc_len=enc_len, impl=impl))


def step_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
               l: int, slots: Optional[torch.Tensor], pos: torch.Tensor,
               window: int, *, impl: str, multi: bool = False,
               enc_len: int = 0) -> torch.Tensor:
    """Layer l of a decode step (or, dense and MoE only, a verify pass: multi)
    with weights p, by family: RWKV6 advances its states by one step
    (slots, pos and window unused), Hymba, the dense and the
    encoder-decoder families write their K/V at `slots` (new_positions')
    for the positions pos + i (the last cross-attending to the encoder's
    frames below enc_len). The one per-layer body of step_body and of the
    interleaved engine's passes."""
    if cfg.family == Family.SSM:
        return _rwkv_layer(cfg, p, x, cache, l, impl=impl)
    if cfg.family == Family.HYBRID:
        return _hymba_decode_layer(cfg, p, x, cache, l, slots, pos, window,
                                   impl=impl)
    if cfg.family == Family.ENCDEC:
        return _encdec_decode_layer(cfg, p, x, cache, l, slots, pos, window,
                                    impl=impl, enc_len=enc_len)
    return decode_layer(cfg, p, x, cache, l, slots, pos, window, impl=impl,
                        multi=multi)


def check_enc_len(cfg: ModelConfig, cache: dict, enc_len: int) -> None:
    """An encoder-decoder decode step needs seeded cross K/V and enc_len >
    0: at enc_len 0 the reference masks every frame and its softmax over
    all-masked scores averages every frame's V alike, which the port's
    kernels (a row that sees no slot outputs 0) do not compute."""
    if cfg.family != Family.ENCDEC:
        return
    _check_cross(cache)
    if int(enc_len) <= 0:
        raise ValueError(
            "an encoder-decoder decode step needs enc_len > 0, the "
            "encoder's frames it sees (at 0 the reference averages every "
            "frame's V alike, which the port does not compute)")


def step_prelude(cfg: ModelConfig, cache: dict, q_len: int, *, impl: str,
                 multi: bool, enc_len: int = 0) -> None:
    """The host checks of a step, before its device body runs."""
    _check(cfg, impl)
    if multi:
        _check_pure_kv(cfg, "speculative verification")
    check_enc_len(cfg, cache, enc_len)
    if "pos_ids" in cache:
        check_window(cache, q_len)


def step_body(cfg: ModelConfig, params: dict, cache: dict,
              tokens: torch.Tensor, pos: torch.Tensor, *, impl: str,
              multi: bool, long_mode: bool = False,
              enc_len: int = 0) -> torch.Tensor:
    """The device body of a decode (or verify) step: tokens (B, q_len) at
    positions pos + i, pos a 0-d int32 tensor on the cache's device equal
    to cache["pos"]. Writes pos_ids, K/V and the recurrent states in place
    and returns the logits (B, q_len, PV); reads no host value that changes
    between tokens (cache["pos"] is the epilogue's), so one captured graph
    serves every position."""
    x = embed(params, tokens).to(torch.bfloat16)
    slots = new_positions(cache, tokens.shape[1], pos) \
        if "pos_ids" in cache else None
    for l, window in enumerate(layer_windows(cfg, cfg.n_layers, long_mode)):
        x = step_layer(cfg, layer_params(params, l), x, cache, l, slots, pos,
                       window, impl=impl, multi=multi, enc_len=enc_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x)


def _step(cfg, params, cache, tokens, *, impl, multi, long_mode=False,
          enc_len=0, steps=None):
    q_len = tokens.shape[1]
    step_prelude(cfg, cache, q_len, impl=impl, multi=multi, enc_len=enc_len)

    def body(tok, pos):
        return step_body(cfg, params, cache, tok, pos, impl=impl, multi=multi,
                         long_mode=long_mode, enc_len=enc_len)
    key = ("model", multi, long_mode, int(enc_len), impl)
    logits = capture.run(
        steps, key, body, tokens, cache["pos"],
        scope=lambda: (id(params), capture.tensor_scope(cache)),
        device=params["final_norm"].device)
    cache["pos"] += q_len
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, *, impl: str = "ref", long_mode: bool = False,
                enc_len: int = 0, steps: Optional[capture.CapturedStep] = None):
    """token: (B, 1) int -> (logits (B, 1, PV), cache), cache updated in
    place and pos advanced by one. The recurrent families launch their
    scan kernel once per layer at S = 1 under impl="kernel" (the
    reference pins its jnp scan there for an old-XLA partitioner fault of
    the TPU engine, which has no counterpart on the card). The
    encoder-decoder family cross-attends to the encoder's frames below
    enc_len, which must be > 0 (check_enc_len). With `steps` (a
    CapturedStep) the body replays its CUDA graph for this shape."""
    return _step(cfg, params, cache, token, impl=impl, multi=False,
                 long_mode=long_mode, enc_len=enc_len, steps=steps)


def verify_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, *, impl: str = "ref",
                long_mode: bool = False,
                steps: Optional[capture.CapturedStep] = None):
    """Score q_len positions in one pass (speculative verification).
    tokens: (B, q_len) int, position pos + i holding tokens[:, i]. Returns
    (logits (B, q_len, PV), cache) with all q_len K/V written and pos
    advanced by q_len. Rolling back rejected positions is resetting
    cache["pos"]: their entries carry pos_ids > pos, invisible to every
    later read until decoding reaches them again. Dense and MoE families
    only: a recurrent state cannot roll back by masking (the reference
    refuses the same families). An MoE layer routes the B·q_len rows of
    the pass as one batch, so its capacity, and with it a verify pass's
    logits, differ from q_len decode steps' (as in the reference). With
    `steps` the body replays its CUDA graph for this q_len."""
    return _step(cfg, params, cache, tokens, impl=impl, multi=True,
                 long_mode=long_mode, steps=steps)
