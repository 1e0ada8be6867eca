"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: config and parameter conversion, and the near-tie rule."""
import dataclasses

import jax
import numpy as np

from repro.models import model as JM
from repro_torch.configs.base import AttnKind, Family, ModelConfig
from repro_torch.convert import params_from_numpy

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
