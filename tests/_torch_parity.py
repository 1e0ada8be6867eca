"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: config and parameter conversion, and the near-tie rule."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model as JM
from repro_torch.configs.base import AttnKind, Family, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as PM

# Largest |port logits - JAX logits| measured on the test configs over a
# prefill and 10 decode steps is 0.12 (typically 0.02-0.07), i.e. under 8
# bf16 ulps at |logit| ~ 4: jit-compiled XLA fuses across ops and skips
# some bf16 roundings that op-by-op PyTorch takes. Greedy picks are
# compared only where the reference's top-2 margin exceeds it.
LOGIT_TOL = 0.15
# K/V and recurrent states after a prompt, against the JAX package: the two
# round bf16 activations at different points, and a layer's K/V, conv rows
# and scan state see what the layers below rounded. Measured up to 0.020
# of an entry's largest |value| on the smoke configs (2 layers, both
# impls); STATE_TOL is 2.5x that.
STATE_TOL = 0.05


def port_cfg(cfg) -> ModelConfig:
    """The port's ModelConfig equal to a JAX package ModelConfig."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["family"] = Family(cfg.family.value)
    d["attn_kind"] = AttnKind(cfg.attn_kind.value)
    return ModelConfig(**d)


def jax_params(cfg, seed: int = 0):
    """(JAX params, numpy copy, the port's params on the CPU)."""
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    npt = jax.tree.map(np.asarray, jp)
    return jp, npt, params_from_numpy(npt, "cpu")


def f32(x):
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def margin(logits):
    """Top-1 minus top-2 per row of (B, V) logits."""
    s = np.sort(logits, axis=-1)
    return s[..., -1] - s[..., -2]


def logits_along(cfg, jp, pp, prompt, tokens, max_len):
    """Reference and port logits (T, V) of one (left-padded) prompt
    followed by `tokens`, teacher-forced, on the single-device paths."""
    pcfg = port_cfg(cfg)
    toks = np.asarray(prompt, np.int32)[None]
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks), JM.init_cache(cfg, 1, max_len))
    pl, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                        PM.init_cache(pcfg, 1, max_len, device="cpu"))
    jd = jax.jit(functools.partial(JM.decode_step, cfg))
    a, b = [f32(jl)[0, -1]], [f32(pl)[0, -1]]
    for t in tokens:
        jl, jc = jd(jp, jc, jnp.asarray([[t]], jnp.int32))
        pl, pc = PM.decode_step(pcfg, pp, pc, torch.tensor([[t]]))
        a.append(f32(jl)[0, -1])
        b.append(f32(pl)[0, -1])
    v = cfg.vocab_size
    return np.stack(a)[:, :v], np.stack(b)[:, :v]


def assert_same_or_near_tie(cfg, jp, pp, prompts, got, ref, max_len,
                            width=None):
    """Served tokens `got` against the reference's `ref` (lists per
    request): equal, or the first divergence is a near tie of the
    reference (top-2 margin below LOGIT_TOL) where the port's logits stay
    within LOGIT_TOL. `width`: the left-padded batch prompt length."""
    for p, a, b in zip(prompts, got, ref):
        assert len(a) == len(b)
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        padded = p if width is None else np.pad(p, (width - len(p), 0))
        la, lb = logits_along(cfg, jp, pp, padded, b[:t], max_len)
        assert margin(la[t:t + 1])[0] < LOGIT_TOL, \
            f"token {t} diverges outside a near tie"
        np.testing.assert_allclose(lb[t], la[t], atol=LOGIT_TOL)


def assert_converts_leaf_for_leaf(cfg):
    """A JAX init_params tree converts leaf for leaf into the tree the port
    declares for the same config: same keys, shapes, dtypes (bf16, or the
    spec's own: the MoE router's fp32) and values."""
    _, npt, pp = jax_params(cfg)

    def walk(s, n, p):
        assert set(s) == set(n) == set(p)
        for k in s:
            if isinstance(s[k], dict):
                walk(s[k], n[k], p[k])
                continue
            assert tuple(s[k].shape) == n[k].shape == tuple(p[k].shape)
            assert p[k].dtype == s[k].dtype
            assert n[k].dtype.name == str(s[k].dtype).split(".")[-1]
            np.testing.assert_array_equal(f32(p[k]), n[k].astype(np.float32))
    walk(PM.build_param_specs(port_cfg(cfg)), npt, pp)


def assert_cache_close(pc, jc):
    """The port's cache `pc` against the JAX cache `jc`: the same entries,
    equal pos_ids, each per-layer entry within STATE_TOL of its largest
    |ref|."""
    assert set(pc) == set(jc)
    for key, val in pc.items():
        if key == "pos":
            continue
        ref = f32(jc[key])
        if key == "pos_ids":
            np.testing.assert_array_equal(val.numpy(), ref)
            continue
        np.testing.assert_allclose(f32(val), ref,
                                   atol=STATE_TOL * np.abs(ref).max(),
                                   err_msg=key)


def jax_stepwise(cfg, jp, toks, feed, max_len):
    """The JAX package's token-by-token run: the (B, S) prompts `toks` fed
    one token at a time through M.decode_step from an empty cache, then
    the (B, T) tokens `feed`. Returns (logits (T + 1, B, V) fp32, row t
    after the prompt and feed[:, :t]; the final cache). This is the
    reference's own decode contract, which its hybrid prefill breaks (it
    returns the right logits but leaves the cache empty, ROADMAP)."""
    jd = jax.jit(functools.partial(JM.decode_step, cfg))
    toks, feed = np.asarray(toks, np.int32), np.asarray(feed, np.int32)
    jc = JM.init_cache(cfg, toks.shape[0], max_len)
    for t in range(toks.shape[1]):
        jl, jc = jd(jp, jc, jnp.asarray(toks[:, t:t + 1]))
    out = [f32(jl)[:, -1]]
    for t in range(feed.shape[1]):
        jl, jc = jd(jp, jc, jnp.asarray(feed[:, t:t + 1]))
        out.append(f32(jl)[:, -1])
    return np.stack(out)[..., :cfg.vocab_size], jc


def jax_stepwise_greedy(cfg, jp, toks, n_new, max_len):
    """Greedy continuation (B, n_new) of the prompts `toks` by the JAX
    package's token-by-token decode (see jax_stepwise), and its logits
    (n_new, B, V)."""
    jd = jax.jit(functools.partial(JM.decode_step, cfg))
    toks = np.asarray(toks, np.int32)
    jc = JM.init_cache(cfg, toks.shape[0], max_len)
    for t in range(toks.shape[1]):
        jl, jc = jd(jp, jc, jnp.asarray(toks[:, t:t + 1]))
    out, logits = [], []
    for t in range(n_new):
        lg = f32(jl)[:, -1, :cfg.vocab_size]
        logits.append(lg)
        out.append(lg.argmax(-1))
        if t + 1 < n_new:
            jl, jc = jd(jp, jc, jnp.asarray(out[-1][:, None], jnp.int32))
    return np.stack(out, 1), np.stack(logits)


def port_forced(pcfg, pp, toks, feed, max_len, impl="ref"):
    """The port's logits (T + 1, B, V) fp32 of the prompts `toks` through
    prefill, then the (B, T) tokens `feed` through decode_step."""
    pl, pc = PM.prefill(pcfg, pp, torch.from_numpy(np.asarray(toks)).long(),
                        PM.init_cache(pcfg, len(toks), max_len, device="cpu"),
                        impl=impl)
    out = [f32(pl)[:, -1]]
    for t in range(np.asarray(feed).shape[1]):
        pl, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(
            np.asarray(feed)[:, t:t + 1]).long(), impl=impl)
        out.append(f32(pl)[:, -1])
    return np.stack(out)[..., :pcfg.vocab_size], pc


def assert_greedy_vs_stepwise(cfg, jp, pp, toks, got, max_len):
    """Served tokens `got` (B, T) against the JAX package's token-by-token
    greedy decode of the same (left-padded) prompts `toks`: equal, or the
    first divergence is a near tie of the reference (top-2 margin below
    LOGIT_TOL) where the port's logits, fed the reference's tokens, stay
    within LOGIT_TOL."""
    got = np.asarray(got)
    ref, _ = jax_stepwise_greedy(cfg, jp, toks, got.shape[1], max_len)
    for b in range(got.shape[0]):
        if (got[b] == ref[b]).all():
            continue
        t = int(np.argmax(got[b] != ref[b]))
        la, _ = jax_stepwise(cfg, jp, toks[b:b + 1], ref[b:b + 1, :t], max_len)
        lb, _ = port_forced(port_cfg(cfg), pp, toks[b:b + 1], ref[b:b + 1, :t],
                            max_len)
        assert margin(la[t])[0] < LOGIT_TOL, \
            f"row {b}: token {t} diverges outside a near tie"
        np.testing.assert_allclose(lb[t], la[t], atol=LOGIT_TOL)
