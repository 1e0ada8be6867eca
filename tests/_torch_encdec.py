"""Shared helpers of the encoder-decoder tests (test_torch_encdec.py, the
model; test_torch_encdec_engine.py, the engine): SeamlessM4T-medium's
smoke config, its weights, inputs from numpy seeds, the JAX package's
reference flow run once per process, and the tolerances."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import LOGIT_TOL, f32, margin
from repro.configs.registry import get_smoke_config
from repro.models import model as JM
from repro_torch.convert import params_from_numpy

ARCH = "seamless-m4t-medium"
B, P, S_ENC, MAX_LEN = 2, 10, 12, 32
N_STEPS = 6                                         # decode steps per flow
IMPLS = [("ref", "ref"), ("kernel", "pallas")]      # (port, JAX)
# The encoder's output against JAX's: both round bf16 activations after
# each op, and differ by a GEMM's summation order, XLA's fusions and the
# kernel route's fp32 probabilities (JAX's "pallas" interpret mode keeps
# them fp32 too, its "ref" rounds them to bf16). Measured up to 1.3% of
# the output's largest |value| on the smoke config; 2^-5 is 2.4x.
ENC_TOL = 2.0 ** -5
# One cross-attention call, or the cross K/V, on the same bf16 inputs: the
# two packages' products round alike (measured: equal, or within 0.06% of
# the largest |value|); 2^-6 is 2-4 bf16 ulps.
CROSS_TOL = 2.0 ** -6
# The weights: JAX's init_params, with every stacked matrix (the decoder's
# and the encoder's) scaled to std 1/sqrt(d_model). The stacked fan-in
# quirk draws them at 1/sqrt(L), 11x that on the smoke config's 256-wide
# layers: attention scores then reach |s| ~ 300-450, both softmaxes (self
# and cross) are one-hot, and where a row's top two scores lie within ~1
# (measured down to 0.39) one bf16 ulp of q, a GEMM's summation order
# between the packages, flips the row: logits then moved by up to 0.41
# and a few rows of the next layer's K/V by 0.13 of their largest value.
# Scores of std ~1 keep every frame and key in play, so a masking or
# routing fault shows in the comparison instead of hiding behind a
# one-hot row, and _torch_parity's LOGIT_TOL and STATE_TOL apply
# (measured: logits within 0.059, caches within 1.2% of their largest
# |value|).


def cfg_of(n_layers=None):
    cfg = get_smoke_config(ARCH)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


@functools.lru_cache(maxsize=None)
def weights(n_layers=None):
    """(JAX params, numpy copy, the port's params on the CPU): JAX's
    init_params with the stacked matrices at std 1/sqrt(d_model) (see
    above), converted through params_from_numpy."""
    cfg = cfg_of(n_layers)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    for stack in ("layers", "encoder"):
        n = jax.tree.leaves(jp[stack])[0].shape[0]
        jp[stack] = jax.tree.map(
            lambda a: (a.astype(jnp.float32) * (n / cfg.d_model) ** 0.5
                       ).astype(a.dtype) if a.ndim >= 3 else a, jp[stack])
    npt = jax.tree.map(np.asarray, jp)
    return jp, npt, params_from_numpy(npt, "cpu")


def frames(cfg, seed=3, n=B, length=S_ENC):
    return np.random.default_rng(seed).standard_normal(
        (n, length, cfg.d_model)).astype(np.float32)


def prompts(cfg, seed=5, n=B, length=P):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (n, length)).astype(np.int32)


def tokens(a):
    return torch.from_numpy(np.asarray(a)).long()


def close(got, ref, tol, what):
    """Every element of got within tol x the largest |ref|."""
    ref, got = f32(ref), f32(got)
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(),
                               err_msg=what)


def compare(jl, pl, V):
    """Logits within LOGIT_TOL, greedy equal outside near ties (the
    reference's top-2 margin above LOGIT_TOL); returns the number of
    positions clear of a near tie (6 to 9 of a flow's 14 on these
    seeds, which vary with XLA's thread count: the tests ask for a
    third)."""
    a, b = f32(jl)[..., :V], f32(pl)[..., :V]
    np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
    clear = margin(a) > LOGIT_TOL
    np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
    return int(clear.sum())


@functools.lru_cache(maxsize=None)
def _jitted(n_layers, jimpl, enc_len):
    cfg = cfg_of(n_layers)
    return (jax.jit(functools.partial(JM.encode, cfg, impl=jimpl)),
            jax.jit(functools.partial(JM.seed_cross_kv, cfg)),
            jax.jit(functools.partial(JM.prefill, cfg, impl=jimpl)),
            jax.jit(functools.partial(JM.decode_step, cfg, impl=jimpl,
                                      enc_len=enc_len)))


@functools.lru_cache(maxsize=None)
def jax_flow(n_layers, jimpl, enc_len, frame_seed=3, prompt_seed=5):
    """The reference's flow (its dryrun and arch smoke test), jit-compiled:
    encode -> seed_cross_kv -> prefill -> N_STEPS decode_step(enc_len=),
    each fed the previous step's greedy pick. Returns a dict: "enc" the
    encoder's output, "cache" the prefilled cache, "logits" [(B, 1, PV)]
    of the prefill and every step, "feed" (B, N_STEPS) the tokens fed."""
    cfg = cfg_of(n_layers)
    jp = weights(n_layers)[0]
    encode, seed, prefill, step = _jitted(n_layers, jimpl, enc_len)
    enc = encode(jp, jnp.asarray(frames(cfg, frame_seed)))
    jc = seed(jp, JM.init_cache(cfg, B, MAX_LEN, enc_out=enc), enc)
    jl, jc = prefill(jp, jnp.asarray(prompts(cfg, prompt_seed)), jc)
    out = {"enc": enc, "cache": jc, "logits": [jl]}
    feed = []
    for _ in range(N_STEPS):
        tok = f32(jl)[:, -1, :cfg.vocab_size].argmax(-1)
        feed.append(tok)
        jl, jc = step(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
        out["logits"].append(jl)
    out["feed"] = np.stack(feed, 1)
    return out
