"""The port's MoE family against the JAX package on the CPU, at smoke sizes
(the kernels run their plain versions).

- ``models/moe.py``: ``_group_tokens`` equal to JAX's exactly (order,
  buffer indices, keep) over a hypothesis sweep and at DeepSeek's decode
  shape (T 4, K 6, E 64: capacity 1, slots collide); ``_route``'s ids equal
  (ties to the first expert), weights within fp32 rounding;
  ``moe_forward`` equal to JAX's with capacity drops (cf 1.25, E 16, K 6,
  B 4) in fp32 and within bf16 rounding in bf16, and to the oracle
  ``moe_forward_naive`` without drops (cf 8); aux equal.
- The model (smoke deepseek-moe-16b and kimi-k2-1t-a32b: a dense first
  layer, then MoE layers): prefill, decode steps and a verify pass against
  JAX's M.prefill / M.decode_step / M.verify_step, logits within
  LOGIT_TOL, greedy equal outside near ties. Every MoE call's routes are
  recorded on both sides: in fp32 (both trees and the activations cast, as
  the JAX engine's test does) they are identical; in bf16 a route may
  differ only where the two probabilities it swaps lie within the
  measured error of that call's router probabilities, and the logits of
  the rows such a flip moved are not held at that step.
- The engine on the folded stack (first_dense_layers=0, the homogeneous
  stack JAX's engine asserts): bit for bit equal to the port's model
  (chunked prefill rounds, the prompt pass over the tiers, decode, verify,
  the resident draft), held to JAX's single-device model, a stack with a
  dense first layer refused in JAX's words, and every packed fp32 router
  bit-equal to its source in both tiers.
- Speculation on the single-device MoE path (n-gram drafts) serves JAX's
  tokens; the resident draft on the folded engine commits its verify
  passes' greedy.
- The cost model and Alg. 1 on DeepSeekMoE-16B equal JAX's at three
  weight budgets; the launcher serves MoE with and without --hbm-bytes.
"""
import contextlib
import dataclasses
import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from _torch_parity import (LOGIT_TOL, assert_converts_leaf_for_leaf,  # noqa: E402
                           f32, jax_params, margin, port_cfg)
from repro.configs.base import Family, ModelConfig  # noqa: E402
from repro.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro.core import cost_model as JC  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import offline_scheduler as JS  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import spec as JSpec  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core import offline_scheduler as PS  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import moe as PMoE  # noqa: E402
from repro_torch.serving import LimeServer  # noqa: E402
from repro_torch.specdec import SpecConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

MOE_ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
B, P, MAX_LEN = 2, 10, 32
# the folded engine stack: 4 MoE layers, 2 segments of 1 resident + 1
# streamed layer
PLAN = PE.UniformPlan(1, 2, 1, 1)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _compare(jl, pl, V, tol=LOGIT_TOL):
    """Logits within tol, greedy equal outside near ties; returns the
    reference's argmax."""
    a, b = f32(jl)[..., :V], f32(pl)[..., :V]
    np.testing.assert_allclose(b, a, atol=tol)
    clear = margin(a) > tol
    np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
    return a.argmax(-1)


# ----------------------------------------------------------------------------
# models/moe.py
# ----------------------------------------------------------------------------
def _group_both(ids, cap, E):
    jo, jb, jk = JMoE._group_tokens(jnp.asarray(ids, jnp.int32), cap, E)
    po, pb, pk = PMoE._group_tokens(torch.from_numpy(ids).long(), cap, E)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    return pk.numpy()


@given(st.integers(1, 64), st.integers(2, 16), st.integers(1, 4))
@settings(max_examples=8, deadline=None)
def test_group_tokens_equals_jax(T, E, K):
    K = min(K, E)
    ids = np.random.default_rng(T * 131 + E).integers(0, E, (T, K))
    _group_both(ids, max(1, (T * K) // E), E)


@pytest.mark.parametrize("seed", range(4))
def test_group_tokens_decode_shape_collides(seed):
    """DeepSeek's decode step: T 4 tokens, top-6 of 64 experts, capacity 1
    (cf 1.25): routes drawn from 8 experts collide, and the stable sort
    keeps the first slot of each expert in both packages."""
    assert PMoE.capacity(4, 6, 64, 1.25) == 1
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(8)[:6] for _ in range(4)])
    keep = _group_both(ids, 1, 64)
    assert keep.sum() == len(np.unique(ids)) < ids.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_equals_jax(dtype):
    """ids equal (an exact tie goes to the first expert, as JAX's top_k),
    weights and probabilities within fp32 rounding, weights renormalised."""
    rng = np.random.default_rng(1)
    router = (0.05 * rng.standard_normal((64, 16))).astype(np.float32)
    router[:, 5] = router[:, 2]          # experts 2 and 5 tie on every token
    x = rng.standard_normal((24, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    jw, ji, jpr = JMoE._route(jnp.asarray(router), jx, 6)
    pw, pi, ppr = PMoE._route(torch.from_numpy(router), px, 6)
    assert torch.equal(ppr[:, 2], ppr[:, 5])
    both = ((pi == 2) | (pi == 5)).sum(-1) == 2
    assert both.any()
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ppr.numpy(), np.asarray(jpr), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(pw.sum(-1).numpy(), 1.0, atol=1e-6)


def _moe_cfg(E, K, shared):
    return ModelConfig(name="t", family=Family.MOE, n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128,
                       head_dim=16, n_experts=E, top_k=K,
                       n_shared_experts=shared, moe_d_ff=48)


def _moe_params(cfg, fp32):
    jp = JSpec.init(jax.random.PRNGKey(0), JMoE.moe_specs(
        cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.n_shared_experts))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_moe_forward_with_drops_equals_jax(fp32):
    """cf 1.25 at E 16, K 6 over B 4 x S 8 tokens: capacity 15 of 192
    slots, and some experts overflow. The same routes, the same drops;
    the outputs within fp32 rounding (fp32), or within 2^-6 of the largest
    |out| (bf16: the products' and the combine's bf16 rounding, in the
    reference's order); aux equal."""
    cfg = _moe_cfg(16, 6, 2)
    jp, pp = _moe_params(cfg, fp32)
    x = np.random.default_rng(2).standard_normal((4, 8, cfg.d_model)) \
        .astype(np.float32)
    dt = (jnp.float32, torch.float32) if fp32 else (jnp.bfloat16, torch.bfloat16)
    jout, jaux = jax.jit(functools.partial(JMoE.moe_forward, cfg=cfg))(
        jp, jnp.asarray(x, dt[0]))
    pout, paux = PMoE.moe_forward(pp, torch.from_numpy(x).to(dt[1]), cfg=cfg)
    _, ids, _ = PMoE._route(pp["router"], torch.from_numpy(x).to(dt[1])
                            .reshape(-1, cfg.d_model), cfg.top_k)
    cap = PMoE.capacity(32, 6, 16, 1.25)
    assert cap == 15
    assert not PMoE._group_tokens(ids, cap, 16)[2].all()      # drops
    ref = f32(jout)
    rel = 1e-5 if fp32 else 2.0 ** -6
    np.testing.assert_allclose(f32(pout), ref, atol=rel * np.abs(ref).max())
    assert float(paux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("E,K,shared", [(4, 2, 0), (8, 2, 1), (4, 1, 2),
                                        (16, 6, 2)])
def test_moe_forward_without_drops_equals_naive(E, K, shared):
    """Ample capacity (cf 8): no slot is dropped, and the grouped layer is
    the every-expert-on-every-token oracle, in the port and against JAX's
    oracle (fp32, test_moe.py's cases)."""
    cfg = _moe_cfg(E, K, shared)
    jp, pp = _moe_params(cfg, True)
    x = np.random.default_rng(3).standard_normal((2, 8, cfg.d_model)) \
        .astype(np.float32)
    out, aux = PMoE.moe_forward(pp, torch.from_numpy(x), cfg=cfg,
                                capacity_factor=8.0)
    naive = PMoE.moe_forward_naive(pp, torch.from_numpy(x), cfg=cfg)
    jnaive = jax.jit(functools.partial(JMoE.moe_forward_naive, cfg=cfg))(
        jp, jnp.asarray(x))
    _, jaux = jax.jit(functools.partial(JMoE.moe_forward, cfg=cfg,
                                        capacity_factor=8.0))(jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), naive.numpy(), atol=2e-5)
    np.testing.assert_allclose(naive.numpy(), np.asarray(jnaive), atol=2e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6) and float(aux) > 0


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_and_specs(arch):
    """JAX's tree, with its dense_layers stack and fp32 routers, converts
    leaf for leaf; init_params draws the same layout and fan-in scales."""
    cfg = get_smoke_config(arch)
    assert_converts_leaf_for_leaf(cfg)
    pcfg = port_cfg(dataclasses.replace(cfg, n_layers=4))
    p = PM.init_params(pcfg, device="cpu")
    assert p["dense_layers"]["mlp"]["wi_gate"].shape[0] == 1
    assert p["layers"]["moe"]["wi_gate"].shape[0] == 3
    assert p["layers"]["moe"]["router"].dtype == torch.float32
    # the stacked fan-in quirk: a stack of n layers draws at 1/sqrt(n)
    assert abs(p["dense_layers"]["attn"]["wq"].float().std().item() - 1.0) < 0.05
    assert abs(p["layers"]["moe"]["wi_up"].float().std().item()
               - 3 ** -0.5) < 0.02
    src = PM.init_params_by_layer(pcfg, device="cpu")["layers"]
    assert abs(src(0)["attn"]["wq"].float().std().item() - 1.0) < 0.05
    assert "moe" in src(1) and "mlp" in src(0)
    assert abs(src(2)["moe"]["wi_up"].float().std().item() - 3 ** -0.5) < 0.02
    assert PM.layer_params(p, 0).keys() == src(0).keys()
    assert torch.equal(PM.layer_params(p, 2)["moe"]["router"],
                       p["layers"]["moe"]["router"][1])


class _Routes:
    """Every _route call of both packages, as (ids, probs) numpy pairs,
    held to each other one step at a time (check). exact: identical
    routes. Else a token's route may differ only at a rank where the
    reference's two neighbouring probabilities lie within twice that
    call's largest |probability difference| (each may move by that much).
    A flip so allowed moves its token's expert mix, so the step's logits
    of that token's batch row are not held to the logit limit; of every
    row where the call's capacity binds (a drop moves other tokens)."""

    def __init__(self, exact):
        self.exact = exact
        self.jax, self.port = [], []
        self.seen = self.flips = 0

    def check(self, q_len):
        """The calls since the last check: returns the batch rows whose
        logits an allowed flip may move (None: every row)."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.port) > self.seen
        pairs = list(zip(self.jax[self.seen:], self.port[self.seen:]))
        self.seen = len(self.jax)
        rows = set()
        for (ji, jp), (pi, pp) in pairs:
            assert ji.shape == pi.shape
            differ = np.flatnonzero((ji != pi).any(-1))
            if self.exact:
                assert not len(differ)
                continue
            err = np.abs(pp - jp).max()
            srt = -np.sort(-jp, axis=-1)
            for t in differ:
                r = int(np.argmax(ji[t] != pi[t]))    # first differing rank
                assert srt[t, r] - srt[t, r + 1] <= 2 * err, (t, r, err)
            self.flips += len(differ)
            if len(differ):
                T, K = ji.shape
                cap = PMoE.capacity(T, K, jp.shape[1], 1.25)
                if not PMoE._group_tokens(torch.from_numpy(ji).long(), cap,
                                          jp.shape[1])[2].all():
                    return None
                rows |= {int(t) // q_len for t in differ}
        return rows


@contextlib.contextmanager
def _recorded_routes(monkeypatch, exact):
    rec = _Routes(exact)
    jorig, porig = JMoE._route, PMoE._route

    def jrec(router, x, k):
        w, i, p = jorig(router, x, k)
        # inside jit and scan: an ordered host callback per call
        jax.debug.callback(lambda i, p: rec.jax.append(
            (np.asarray(i), np.asarray(p, np.float32))), i, p, ordered=True)
        return w, i, p

    def prec(router, x, k):
        w, i, p = porig(router, x, k)
        rec.port.append((i.numpy(), p.float().numpy()))
        return w, i, p
    monkeypatch.setattr(JMoE, "_route", jrec)
    monkeypatch.setattr(PMoE, "_route", prec)
    yield rec
    jax.effects_barrier()
    monkeypatch.setattr(JMoE, "_route", jorig)
    monkeypatch.setattr(PMoE, "_route", porig)


def _compare_routed(jl, pl, V, rec, q_len=1, tol=LOGIT_TOL):
    """_compare on the batch rows no allowed route flip of this step
    moved; returns the reference's argmax."""
    rows = rec.check(q_len)
    a = f32(jl)[..., :V]
    keep = [b for b in range(a.shape[0]) if rows is not None and b not in rows]
    if keep:
        _compare(a[keep], f32(pl)[keep], V, tol)
    return a.argmax(-1)


def _model_run(cfg, jp, pp, toks, rng, rec):
    """prefill, 3 decode steps and a 4-wide verify pass through both
    packages, teacher-forced on the reference's picks, each step's routes
    held by rec."""
    pcfg = port_cfg(cfg)
    V = cfg.vocab_size
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks), JM.init_cache(cfg, B, MAX_LEN))
    pl, pc = PM.prefill(pcfg, pp, _t(toks),
                        PM.init_cache(pcfg, B, MAX_LEN, device="cpu"))
    tok = _compare_routed(jl[:, -1], pl[:, -1], V, rec, P)
    jdecode = jax.jit(functools.partial(JM.decode_step, cfg))
    for _ in range(3):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
        pl, pc = PM.decode_step(pcfg, pp, pc, _t(tok[:, None]))
        tok = _compare_routed(jl[:, -1], pl[:, -1], V, rec)
    mat = np.concatenate([tok[:, None], rng.integers(1, V, (B, 3))], 1)
    jl, jc = jax.jit(functools.partial(JM.verify_step, cfg))(
        jp, jc, jnp.asarray(mat, jnp.int32))
    pl, pc = PM.verify_step(pcfg, pp, pc, _t(mat))
    _compare_routed(jl, pl, V, rec, 4)
    assert pc["pos"] == int(jc["pos"]) == P + 3 + 4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_vs_jax_bf16_routes_within_error(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    jp, _, pp = jax_params(cfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)
    with _recorded_routes(monkeypatch, exact=False) as rec:
        _model_run(cfg, jp, pp, toks, rng, rec)
    # one MoE call per MoE layer per pass: prefill, 3 decode steps, verify
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(rec.port) == 5 * n_moe
    assert [i.shape[0] for i, _ in rec.port[::n_moe]] == [B * P, B, B, B, B * 4]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_vs_jax_fp32_routes_identical(arch, monkeypatch):
    """Both trees and the activations in fp32 (the JAX engine test's
    jnp.bfloat16 = jnp.float32, mirrored on the port's torch.bfloat16):
    every route of every call identical, every row's logits held."""
    cfg = get_smoke_config(arch)
    jp, npt, _ = jax_params(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    pp = params_from_numpy(jax.tree.map(lambda a: a.astype(np.float32), npt),
                           "cpu")
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)
    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    monkeypatch.setattr(torch, "bfloat16", torch.float32)
    with _recorded_routes(monkeypatch, exact=True) as rec:
        _model_run(cfg, jp, pp, toks, rng, rec)
    assert all(p.dtype == np.float32 for _, p in rec.port)


def test_capacity_follows_the_calls_token_count(monkeypatch):
    """Capacity is computed from the rows of each call: B·S in a prefill,
    B in a decode step, B·q_len in a verify pass (the reference's), and
    the model routes exactly those rows per layer."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"), n_layers=3)
    pcfg = port_cfg(cfg)
    pp = PM.init_params(pcfg, device="cpu")
    seen = []
    orig = PMoE.capacity

    def spy(n, k, e, cf):
        seen.append(n)
        return orig(n, k, e, cf)
    monkeypatch.setattr(PMoE, "capacity", spy)
    cache = PM.init_cache(pcfg, 3, MAX_LEN, device="cpu")
    PM.prefill(pcfg, pp, torch.ones((3, 7), dtype=torch.long), cache)
    PM.decode_step(pcfg, pp, cache, torch.ones((3, 1), dtype=torch.long))
    PM.verify_step(pcfg, pp, cache, torch.ones((3, 5), dtype=torch.long))
    assert seen == [21, 21, 3, 3, 15, 15]


# ----------------------------------------------------------------------------
# the folded stack through the interleaved engine
# ----------------------------------------------------------------------------
def _folded(n_layers=4):
    return dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                               n_layers=n_layers, first_dense_layers=0)


def _engine(cfg, pp, mb=B, headroom=1, plan=PLAN):
    eng = PE.InterleavedEngine(port_cfg(cfg), plan, mb=mb, max_len=MAX_LEN,
                               retier_headroom=headroom, device="cpu")
    return eng, eng.init_state(pp)


def _tree_index(t, ids):
    return {k: _tree_index(v, ids) for k, v in t.items()} \
        if isinstance(t, dict) else t[ids]


def test_folded_engine_matches_port_model_bitwise():
    """Chunked prefill rounds, decode, verify and a resident draft step
    equal the port's model at the same grouping (mb rows a pass) bit for
    bit, and the prompt pass over the tiers equals M.prefill."""
    cfg = _folded()
    pcfg = port_cfg(cfg)
    _, _, pp = jax_params(cfg)
    toks = _t(np.random.default_rng(6).integers(1, cfg.vocab_size, (B, P)))
    eng, st = _engine(cfg, pp)
    assert eng.resident_layer_ids() == [0, 2]
    mc = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")

    def same(a, b):
        assert torch.equal(a, b)
        for key in ("k", "v", "pos_ids"):
            assert torch.equal(st[key], mc[key]), key
        assert st["pos"] == mc["pos"]

    el, st = eng.prefill_partial(st, toks, chunk=4)
    for off in range(0, P, 4):
        ml, mc = PM.verify_step(pcfg, pp, mc, toks[:, off:off + 4])
    same(el, ml)
    tok = ml[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(2):
        el, st = eng.decode_step(st, tok)
        ml, mc = PM.decode_step(pcfg, pp, mc, tok)
        same(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    mat = torch.cat([tok, toks[:, :3]], 1)
    el, st = eng.verify_step(st, mat)
    ml, mc = PM.verify_step(pcfg, pp, mc, mat)
    same(el, ml)
    # the draft step is the model cut to the resident layers
    res = eng.resident_layer_ids()
    tcfg = dataclasses.replace(pcfg, n_layers=len(res))
    tpar = {k: v for k, v in pp.items() if k != "layers"}
    tpar["layers"] = _tree_index(pp["layers"], res)
    tc = {"pos": st["pos"], "pos_ids": st["pos_ids"].clone(),
          "k": st["k"][res].clone(), "v": st["v"][res].clone()}
    el, st = eng.draft_step(st, tok)
    ml, tc = PM.decode_step(tcfg, tpar, tc, tok)
    assert torch.equal(el, ml[:, 0])
    assert torch.equal(st["k"][res], tc["k"])
    # the prompt pass over the tiers
    el, cache = eng.prefill(toks)
    ml, mc = PM.prefill(pcfg, pp, toks,
                        PM.init_cache(pcfg, B, MAX_LEN, device="cpu"),
                        impl="kernel")
    assert torch.equal(el, ml)
    for key in ("k", "v", "pos_ids"):
        assert torch.equal(cache[key], mc[key]), key


def _op_by_op(fn):
    def run(*a):
        with jax.disable_jit():
            return fn(*a)
    return run


def test_folded_engine_vs_jax_single_device(monkeypatch):
    """The engine against JAX's single-device model on the folded smoke
    stack (2 MoE layers, one resident and one streamed, within
    _torch_parity's 2-layer LOGIT_TOL): the prompt pass + seed_cache
    against M.prefill, decode steps against M.decode_step, a verify pass
    against M.verify_step; chunked prefill rounds against M.verify_step
    over the same rounds (the same token count per call, so the same
    capacity), routes held as in the model's bf16 test (a flip within the
    router's error frees its row's logits at that step). Deeper stacks are held to the port's model bit for bit
    above. The reference's steps run op by op (its prefill jit-compiled):
    on this stack the jit-compiled reference's third decode step moves
    0.46 from its own op-by-op run (XLA fusion; the port's impl "ref"
    equals the op-by-op run there bit for bit)."""
    cfg = _folded(2)
    V = cfg.vocab_size
    jp, _, pp = jax_params(cfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, V, (B, P)).astype(np.int32)
    jdecode = _op_by_op(functools.partial(JM.decode_step, cfg))
    jverify = _op_by_op(functools.partial(JM.verify_step, cfg))
    eng, st = _engine(cfg, pp, plan=PE.UniformPlan(1, 1, 1, 1))
    assert eng.resident_layer_ids() == [0]
    with _recorded_routes(monkeypatch, exact=False) as rec:
        jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
            jp, jnp.asarray(toks), JM.init_cache(cfg, B, MAX_LEN))
        pl, cache = eng.prefill(_t(toks))
        st = eng.seed_cache(st, cache)
        tok = _compare_routed(jl[:, -1], pl[:, -1], V, rec, P)
        for _ in range(3):
            jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
            pl, st = eng.decode_step(st, _t(tok[:, None]))
            tok = _compare_routed(jl[:, -1], pl, V, rec)
        mat = np.concatenate([tok[:, None], rng.integers(1, V, (B, 4))], 1)
        jl, jc = jverify(jp, jc, jnp.asarray(mat, jnp.int32))
        pl, st = eng.verify_step(st, _t(mat))
        _compare_routed(jl, pl, V, rec, 5)
        np.testing.assert_array_equal(st["pos_ids"].numpy(),
                                      np.asarray(jc["pos_ids"]))
        # chunked prefill: rounds of 5 from an empty cache
        st = eng.init_state(pp)
        pl, st = eng.prefill_partial(st, _t(toks), chunk=5)
        jc = JM.init_cache(cfg, B, MAX_LEN)
        for off in range(0, P, 5):
            jl, jc = jverify(jp, jc, jnp.asarray(toks[:, off:off + 5]))
        _compare_routed(jl, pl, V, rec, 5)


def test_engine_refuses_a_dense_first_layer():
    """A stack with a dense first layer is refused in the JAX engine's
    words, at construction (the config) and at init_state (a tree with
    dense_layers); the folded config builds."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"), n_layers=4)
    jp = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    je = JE.InterleavedEngine(cfg, jax.make_mesh((1,), ("data",)),
                              JE.UniformPlan(1, 2, 1, 1), mb=B,
                              max_len=MAX_LEN, fetch_mode="slot")
    with pytest.raises(AssertionError) as jerr:
        je.init_state(jp)
    with pytest.raises(ValueError) as perr:
        PE.InterleavedEngine(port_cfg(cfg), PLAN, device="cpu")
    assert str(perr.value) == str(jerr.value) == PE.HOMOGENEOUS
    eng = PE.InterleavedEngine(port_cfg(_folded()), PLAN, device="cpu")
    with pytest.raises(ValueError) as perr:
        eng.init_state(PM.init_params(port_cfg(cfg), device="cpu"))
    assert str(perr.value) == str(jerr.value)


def test_packed_router_is_bit_equal_in_both_tiers():
    """Every leaf of every layer reads back from the engine's tiers bit
    for bit, the fp32 router included (a view of the packed bytes, not a
    bf16 cast): resident layers in HBM, streamed ones in the pinned store
    and after a fetch into a load buffer, and a demoted layer after a
    retier. packed_layer_bytes prices the router at 4 bytes."""
    cfg = port_cfg(_folded())
    params = PM.init_params_by_layer(cfg, seed=3, device="cpu")
    eng = PE.InterleavedEngine(cfg, PLAN, mb=B, max_len=MAX_LEN,
                               retier_headroom=1, device="cpu")
    st = eng.init_state(params)
    leaves = list(PE._leaves(PM._LAYER_SPECS[cfg.family](cfg)))
    assert ((("moe", "router"), (cfg.d_model, cfg.n_experts), torch.float32)
            in leaves)
    raw = sum(math.prod(shape) * dt.itemsize for _, shape, dt in leaves)
    assert 0 <= PE.packed_layer_bytes(cfg) - raw < 256 * len(leaves)
    assert eng.layer_bytes == PE.packed_layer_bytes(cfg)

    def same(tree, src):
        for k, v in src.items():
            if isinstance(v, dict):
                same(tree[k], v)
            else:
                assert tree[k].dtype == v.dtype and torch.equal(tree[k], v), k

    def check_all():
        for l in range(cfg.n_layers):
            src = params["layers"](l)
            assert src["moe"]["router"].dtype == torch.float32
            if l in eng._res_views:
                same(eng._res_views[l], src)
            else:
                s, h = np.argwhere(eng._off_ids[:, 0] == l)[0]
                same(eng._views(eng._store.data[s, h]), src)
                eng._streamer.fetch(1, eng._store.data[s, h])
                eng._streamer.acquire(1)
                same(eng._buf_views[1], src)
    check_all()
    st, freed = eng.retier(st, 0, +1)
    assert freed > 0 and eng.resident_layer_ids() == []
    check_all()


def _record_rounds(eng):
    """Wrap the engine's verify and decode entry points: each call's
    (kind, tokens, active, logits) appended to the returned list."""
    log = []
    for name in ("verify_requests", "decode_requests"):
        orig = getattr(eng, name)

        def rec(state, tokens, active, _orig=orig, _name=name, **kw):
            lg, state = _orig(state, tokens, active, **kw)
            log.append((_name, tokens.clone(), torch.as_tensor(active).clone(),
                        lg.clone()))
            return lg, state
        setattr(eng, name, rec)
    return log


def test_folded_engine_resident_spec_serve_commits_verify_greedy():
    """LimeServer through the folded engine with the resident self-draft
    (k 3) on a bursty batch: every round's verify logits equal the port
    model's verify_step on the same tokens from the same cache state (the
    drafts share the pass's capacity, so only the same rows reproduce
    them), and each slot commits the greedy prefix of its own logits (the
    lockstep minimum)."""
    cfg = _folded()
    pcfg = port_cfg(cfg)
    _, _, pp = jax_params(cfg)
    eng = PE.InterleavedEngine(pcfg, PLAN, mb=4, max_len=MAX_LEN, device="cpu")
    log = _record_rounds(eng)
    srv = LimeServer(pcfg, pp, engine=eng, max_len=MAX_LEN, pattern="bursty",
                     spec=SpecConfig(k=3, draft="resident", adapt_k=False),
                     device="cpu")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (8, 6, 8, 5)]
    for i, p in enumerate(prompts):
        srv.queue.submit(p, 6 + i)
    done = sorted(srv.serve_all(), key=lambda r: r.rid)
    rounds = [e for e in log if e[0] == "verify_requests"]
    assert rounds
    # replay on the model: the left-padded prompt, then each round
    from repro_torch.serving.backend import EngineBackend
    toks = _t(EngineBackend._pad_prompts(prompts))
    mc = PM.init_cache(pcfg, 4, MAX_LEN, device="cpu")
    ml, mc = PM.verify_step(pcfg, pp, mc, toks)
    out = [[int(t)] for t in ml[:, -1, :cfg.vocab_size].argmax(-1)]
    V = cfg.vocab_size
    for kind, mat, active, lg in log:
        pos = mc["pos"]
        mat = torch.where(active[:, None], mat, 0)     # inactive: padding
        if kind == "decode_requests":
            ml, mc = PM.decode_step(pcfg, pp, mc, mat)
            assert torch.equal(ml[:, 0], lg)
            for s in np.flatnonzero(active.numpy()):
                out[s].append(int(lg[s, :V].argmax()))
            continue
        ml, mc = PM.verify_step(pcfg, pp, mc, mat)
        assert torch.equal(ml, lg)
        picks = lg[..., :V].argmax(-1)
        acc = [next((j for j in range(mat.shape[1] - 1)
                     if mat[s, j + 1] != picks[s, j]), mat.shape[1] - 1) + 1
               for s in np.flatnonzero(active.numpy())]
        c = min(acc)
        for s in np.flatnonzero(active.numpy()):
            out[s].extend(int(t) for t in picks[s, :c])
        mc["pos"] = pos + c
    for r in done:
        assert r.output == out[r.rid][:len(r.output)]


def test_spec_ngram_single_device_serves_jax_tokens():
    """n-gram speculation (k 3) on the single-device MoE path serves the
    JAX package's backend's tokens under the same SpecConfig: the verify
    passes route the same drafted rows in both."""
    from repro.serving import ContinuousBatchingScheduler as JaxSched
    from repro.serving import EngineBackend as JaxBackend
    from repro.serving import Request as JaxRequest
    from repro.serving import SchedulerConfig as JaxSchedCfg
    from repro.specdec import SpecConfig as JaxSpec
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     EngineBackend, Request, SchedulerConfig)
    cfg = get_smoke_config("deepseek-moe-16b")
    jp, _, pp = jax_params(cfg)
    # a repeating prompt gives the n-gram draft matches to propose
    lens, new = (12, 9), (8, 6)

    def reqs(cls):
        return [cls(i, None, max_new_tokens=n, prompt_len=p)
                for i, (p, n) in enumerate(zip(lens, new))]
    jbe = JaxBackend(cfg, jp, n_slots=2, max_len=48, spec=JaxSpec(k=3))
    jdone = JaxSched(jbe, JaxSchedCfg()).serve(reqs(JaxRequest))
    be = EngineBackend(port_cfg(cfg), pp, n_slots=2, max_len=48,
                       spec=SpecConfig(k=3), device="cpu")
    done = ContinuousBatchingScheduler(be, SchedulerConfig()).serve(
        reqs(Request))
    assert [r.output for r in sorted(done, key=lambda r: r.rid)] \
        == [r.output for r in sorted(jdone, key=lambda r: r.rid)]
    assert be.spec_stats["spec_rounds"] > 0
    assert all(1 <= c <= k + 1 for k, c in be.rounds if k)


# ----------------------------------------------------------------------------
# planning and the launcher
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("budget", [8e9, 16e9, 24e9])
def test_cost_model_and_alg1_on_deepseek_match_jax(budget):
    """DeepSeekMoE-16B on the launcher's one-card H100 env: the workload's
    block split (Alg. 1's p_M >= p_A branch), T_total of plan_for's plan
    and Alg. 1's result (candidates, plan, T_total) equal JAX's within
    1e-12."""
    cfg = get_config("deepseek-moe-16b")
    pe = launch.cost_env(port_cfg(cfg), budget / launch.HBM_FRAC, width=4,
                         prompt_len=512, load_bw=44.8e9)
    jdev = JP.DeviceProfile(**dataclasses.asdict(pe.devices[0]))
    je = JC.CostEnv([jdev], pe.bw_net, JC.Workload(cfg, 4, 512, 1),
                    net_latency=pe.net_latency)
    assert pe.work.p_M >= pe.work.p_A
    for f in ("l_size", "attn_block_bytes", "mlp_block_bytes", "p_A", "p_M"):
        assert getattr(pe.work, f) == pytest.approx(getattr(je.work, f),
                                                    rel=1e-12), f
    pplan = PE.plan_for(port_cfg(cfg), 1, hbm_frac_for_weights=launch.HBM_FRAC,
                        hbm_bytes=budget / launch.HBM_FRAC)
    jplan = JE.plan_for(cfg, 1, hbm_frac_for_weights=launch.HBM_FRAC,
                        hbm_bytes=budget / launch.HBM_FRAC)
    assert (pplan.n_seg, pplan.k_res_list, pplan.k_off_list) \
        == (jplan.n_seg, jplan.k_res_list, jplan.k_off_list)
    assert pe.evaluate(pplan).t_total == pytest.approx(
        je.evaluate(jplan).t_total, rel=1e-12)
    for n_emp in (512, 1024):
        jr = JS.allocate(je, cfg.n_layers, n_emp=n_emp)
        pr = PS.allocate(pe, cfg.n_layers, n_emp=n_emp)
        assert (pr.feasible, pr.reason) == (jr.feasible, jr.reason)
        assert [n for n, _ in pr.candidates] == [n for n, _ in jr.candidates]
        for (_, a), (_, b) in zip(pr.candidates, jr.candidates):
            assert a == pytest.approx(b, rel=1e-12)
        if jr.plan is not None:
            assert [dataclasses.astuple(s) for s in pr.plan.stages] \
                == [dataclasses.astuple(s) for s in jr.plan.stages]
            assert pr.plan.t_total == pytest.approx(jr.plan.t_total, rel=1e-12)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_serves_moe_single_device(arch, capsys):
    rc = launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--pattern", "bursty", "--requests", "4", "--max-new",
                      "3", "--prompt-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["backend"] == "fallback" and report["total_tokens"] == 12


def test_launcher_serves_the_folded_stack_through_the_engine(capsys):
    """--hbm-bytes on the folded stack plans residency by the packed
    layer (the fp32 router makes it larger than the config's count) and
    streams half of the 4 layers; resident self-speculation runs on it."""
    rc = launch.main(["--arch", "deepseek-moe-16b", "--smoke", "--layers",
                      "4", "--fold-dense", "--device", "cpu", "--hbm-bytes",
                      "4e6", "--spec", "--spec-draft", "resident",
                      "--spec-k", "2", "--pattern", "bursty", "--requests",
                      "4", "--max-new", "4", "--prompt-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              n_layers=4, first_dense_layers=0)
    packed = PE.packed_layer_bytes(port_cfg(cfg))
    assert packed > cfg.layer_params() * 2
    assert (f"engine: n_seg 2, k_res 1, k_off 1, resident layers 2, family "
            f"moe, packed layer {packed} B") in out
    report = json.loads(out[out.index("{"):])
    assert report["backend"] == "engine" and report["total_tokens"] == 16


def test_launcher_refuses_an_unfolded_stack_on_the_engine():
    with pytest.raises(SystemExit, match="homogeneous stack"):
        launch.main(["--arch", "deepseek-moe-16b", "--smoke", "--layers",
                     "4", "--device", "cpu", "--hbm-bytes", "4e6",
                     "--pattern", "bursty", "--requests", "2"])
