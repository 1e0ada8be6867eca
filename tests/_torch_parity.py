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
