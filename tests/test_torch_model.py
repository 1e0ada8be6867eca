"""The port's dense model against the JAX package, on the same weights.

Weights come from the JAX package's init_params, converted through numpy;
inputs are numpy arrays handed to both sides. Blocks agree to one bf16
ulp; logits of whole passes to LOGIT_TOL (see _torch_parity), and greedy
picks exactly wherever the reference's top-2 margin exceeds it.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import LOGIT_TOL, f32, jax_params, margin, port_cfg  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import modules as JMod  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import modules as PMod  # noqa: E402
from repro_torch.serving import sampling as PS  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

BF16_ULP = 2.0 ** -7      # relative spacing of bf16 values


def _configs(tiny_dense_factory):
    g = get_smoke_config("gemma3-1b")
    return {"tiny": tiny_dense_factory(),
            "gemma-smoke": g,
            "gemma-window6": dataclasses.replace(g, window_size=6)}


@pytest.mark.parametrize("name", ["tiny", "gemma-smoke"])
def test_params_from_numpy(name, tiny_dense_factory):
    cfg = _configs(tiny_dense_factory)[name]
    _, npt, pp = jax_params(cfg)
    # the port declares the same tree, shapes and dtype
    specs = PM.build_param_specs(port_cfg(cfg))
    shapes = jax.tree.map(lambda a: tuple(a.shape), npt)

    def spec_shapes(t):
        return {k: spec_shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}
    assert spec_shapes(specs) == shapes
    flat_np = jax.tree.leaves(npt)
    flat_pt = jax.tree.leaves(pp)
    assert len(flat_np) == len(flat_pt)
    for a, t in zip(flat_np, flat_pt):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(f32(t), a.astype(np.float32))


def test_init_params_distributions():
    """Same distributions as the reference: unit-scale embedding, zero
    norm scales, and 1/sqrt(leading dim of the STACKED leaf) elsewhere —
    n_layers for layer weights, the reference's quirk kept on purpose."""
    cfg = port_cfg(get_smoke_config("gemma3-1b"))
    p = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.count_nonzero(p["final_norm"]) == 0
    assert torch.count_nonzero(p["layers"]["ln1"]) == 0
    assert abs(p["embedding"].float().std().item() - 1.0) < 0.02
    want = cfg.n_layers ** -0.5
    assert abs(p["layers"]["mlp"]["wi_gate"].float().std().item() - want) < 0.02
    again = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["attn"]["wq"], p["layers"]["attn"]["wq"])


def test_blocks_vs_jax(tiny_dense_factory):
    cfg = get_smoke_config("gemma3-1b")
    jp, _, pp = jax_params(cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    px = torch.from_numpy(x).bfloat16()
    scale = jp["layers"]["ln1"][0] + 0.25      # nonzero scale
    pscale = pp["layers"]["ln1"][0] + 0.25
    np.testing.assert_allclose(
        f32(PMod.rms_norm(px, pscale, cfg.norm_eps)),
        f32(JMod.rms_norm(jx, scale, cfg.norm_eps)), rtol=BF16_ULP, atol=1e-6)
    q = x[..., :4 * 64].reshape(2, 12, 4, 64)
    pos = np.arange(100, 112)[None]
    np.testing.assert_allclose(
        f32(PMod.apply_rope(torch.from_numpy(q).bfloat16(),
                            torch.from_numpy(pos), cfg.rope_theta)),
        f32(JMod.apply_rope(jnp.asarray(q).astype(jnp.bfloat16),
                            jnp.asarray(pos), cfg.rope_theta)),
        rtol=BF16_ULP, atol=1e-6)
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    pm = {k: v[0] for k, v in pp["layers"]["mlp"].items()}
    ref = f32(JMod.mlp(jm, jx))
    np.testing.assert_allclose(f32(PMod.mlp(pm, px)), ref, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(ref).max())


# name, impl, batch, prompt length, max_len: gemma's max_len 16 < prompt 20
# rolls the prefill into the ring, and 10 decode steps wrap it again
CASES = [
    ("tiny", "ref", 2, 12, 32),
    ("tiny", "kernel", 2, 12, 32),
    ("gemma-smoke", "ref", 2, 20, 16),
    ("gemma-window6", "kernel", 2, 20, 16),
]


@pytest.mark.parametrize("name,impl,B,S,max_len", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_prefill_and_decode_vs_jax(name, impl, B, S, max_len,
                                   tiny_dense_factory):
    cfg = _configs(tiny_dense_factory)[name]
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    jprefill = jax.jit(functools.partial(JM.prefill, cfg))
    jdecode = jax.jit(functools.partial(JM.decode_step, cfg))

    jl, jc = jprefill(jp, jnp.asarray(toks, jnp.int32),
                      JM.init_cache(cfg, B, max_len))
    pl, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks),
                        PM.init_cache(pcfg, B, max_len, device="cpu"),
                        impl=impl)

    def compare(jl, pl, jc, pc):
        a = f32(jl)[:, -1, :cfg.vocab_size]
        b = f32(pl)[:, -1, :cfg.vocab_size]
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
        clear = margin(a) > LOGIT_TOL
        np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
        np.testing.assert_array_equal(pc["pos_ids"].numpy(),
                                      np.asarray(jc["pos_ids"]))
        assert pc["pos"] == int(jc["pos"])
        for key in ("k", "v"):
            ref = f32(jc[key])
            np.testing.assert_allclose(f32(pc[key]), ref, rtol=4 * BF16_ULP,
                                       atol=4 * BF16_ULP * np.abs(ref).max())
        return a.argmax(-1)

    tok = compare(jl, pl, jc, pc)
    assert int(jc["pos"]) == S and (S > max_len) == (name != "tiny")
    for _ in range(10):        # teacher-forced on the reference's picks
        jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
        pl, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(tok[:, None]),
                                impl=impl)
        tok = compare(jl, pl, jc, pc)


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.7, 20, 1.0), (1.0, 0, 0.9), (0.5, 50, 0.8)])
def test_filter_logits_vs_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 256)) * 3).astype(np.float32)
    jcfg = JS.SamplerConfig(temperature=temperature, top_k=top_k, top_p=top_p)
    pcfg = PS.SamplerConfig(temperature=temperature, top_k=top_k, top_p=top_p)
    ref = np.asarray(JS.filter_logits(jnp.asarray(logits), jcfg, 200))
    got = PS.filter_logits(torch.from_numpy(logits), pcfg, 200).numpy()
    np.testing.assert_array_equal(got <= PS.NEG_INF, ref <= JS.NEG_INF)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_greedy_sample_vs_jax():
    """argmax over the real vocab, first index on ties, padded tail
    ignored — as the reference picks."""
    logits = np.zeros((3, 16), np.float32)
    logits[0, [3, 7]] = 5.0           # tie: first index wins
    logits[1, 15] = 9.0               # padding column beyond vocab 12
    logits[1, 2] = 1.0
    logits[2] = np.arange(16)[::-1]
    ref = np.asarray(JS.sample(jnp.asarray(logits, jnp.bfloat16),
                               JS.SamplerConfig(), None, 12))
    got = PS.sample(torch.from_numpy(logits).bfloat16(), PS.SamplerConfig(),
                    None, 12).numpy()
    np.testing.assert_array_equal(got, ref)


def test_temperature_sample_distribution():
    """Stochastic draws come from another random stream than JAX's, so
    they are held to the filtered distribution statistically: 4000 draws,
    each frequency within 0.03 of its probability (> 5 sigma)."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.0, -1.0, -3.0, 3.0, 0.5]])
    cfg = PS.SamplerConfig(temperature=0.8, top_k=5)
    probs = torch.softmax(PS.filter_logits(logits, cfg, 8), -1)[0]
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([PS.sample(logits, cfg, gen, 8) for _ in range(4000)])
    freq = torch.bincount(draws, minlength=8).float() / len(draws)
    assert torch.all(freq[probs == 0] == 0)
    assert torch.max(torch.abs(freq - probs)).item() < 0.03
