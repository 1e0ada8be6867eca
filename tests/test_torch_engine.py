"""The port's interleaved engine against the JAX package and the port's
own model, on the CPU (the streamed tier is plain host memory there, the
copies synchronous; the kernels run their plain versions).

- Plan geometry: plan_layout / split_layer_stack / plan_for equal the JAX
  functions on the plans of tests/test_engine_hetero.py.
- The engine (2 segments of 1 resident + 1 streamed layer, retier headroom
  1) against the JAX package's single-device M.prefill / M.decode_step /
  M.verify_step on the same weights: the JAX engine's own contract
  (repro/core/engine.py:38); the multi-device JAX engine fails on this
  tree. Logits within LOGIT_TOL (below), greedy picks equal wherever the
  reference's top-2 margin exceeds it.
- The engine against the port's model bit for bit (torch.equal): both run
  models.model.decode_layer on the same inputs.
- A mid-stream retier(+1) then retier(-1) changes no logit.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import f32, jax_params, margin, port_cfg  # noqa: E402
from repro.configs.base import Family, ModelConfig  # noqa: E402
from repro.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core.cost_model import ExecutionPlan as JPlan  # noqa: E402
from repro.core.cost_model import StageAlloc as JStage  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.cost_model import ExecutionPlan as PPlan  # noqa: E402
from repro_torch.core.cost_model import StageAlloc as PStage  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

# The engine equals the port's model bit for bit (below), so it drifts
# from jit-compiled JAX exactly as the model does: XLA fuses across ops and
# skips bf16 roundings that eager PyTorch takes, and the drift grows with
# depth. At 2 layers it stays under _torch_parity's 0.15; at these 4-layer
# configs it reaches 0.18 at |logit| ~3 (prefill 0.15, decode 0.18, for
# the port's own M.prefill and M.decode_step as much as for the engine).
LOGIT_TOL = 0.25
HETERO = [(4, 1), (2, 2), (6, 0), (0, 3)]


def _plans(name):
    """(JAX plan, port plan) of the same geometry."""
    if name == "hetero":
        return (JPlan(2, [JStage(*a) for a in HETERO]),
                PPlan(2, [PStage(*a) for a in HETERO]))
    args = {"uniform": (4, 2, 1, 1), "llama80": (1, 2, 19, 21),
            "single": (1, 2, 1, 1)}[name]
    return JE.UniformPlan(*args), PE.UniformPlan(*args)


LAYOUTS = [("uniform", 0, None), ("uniform", 1, [0, 1, 1, 0]),
           ("hetero", 2, None), ("hetero", 2, [1, 1, 3, 0]),
           ("llama80", 1, None), ("llama80", 1, [18])]


@pytest.mark.parametrize("name,headroom,live", LAYOUTS,
                         ids=[f"{n}-h{h}-{'live' if lv else 'build'}"
                              for n, h, lv in LAYOUTS])
def test_plan_layout_matches_jax(name, headroom, live):
    jp, pp = _plans(name)
    for attr in ("n_stage", "n_chunks", "k_res_list", "k_off_list", "k_max",
                 "n_layers"):
        assert getattr(pp, attr) == getattr(jp, attr), attr
    assert pp.layers_total() == jp.layers_total()
    for a, b in zip(PE.plan_layout(pp, headroom, live),
                    JE.plan_layout(jp, headroom, live)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,headroom,live", LAYOUTS[:4],
                         ids=[f"{n}-h{h}-{'live' if lv else 'build'}"
                              for n, h, lv in LAYOUTS[:4]])
def test_split_layer_stack_matches_jax(name, headroom, live):
    jp, pp = _plans(name)
    L = jp.layers_total()
    w = np.arange(L * 3, dtype=np.float32).reshape(L, 3)
    jr, jo = JE.split_layer_stack({"a": {"w": jnp.asarray(w)}}, jp,
                                  headroom=headroom, k_res_live=live)
    pr, po = PE.split_layer_stack({"a": {"w": torch.from_numpy(w)}}, pp,
                                  headroom=headroom, k_res_live=live)
    np.testing.assert_array_equal(pr["a"]["w"].numpy(), np.asarray(jr["a"]["w"]))
    np.testing.assert_array_equal(po["a"]["w"].numpy(), np.asarray(jo["a"]["w"]))


def test_plan_for_matches_jax():
    """The budget cases of test_plan_for_covers_and_fits_budget, plus one
    stage (the port's only case) and LLaMA-3.3-70B at H100-sized budgets."""
    cfgs = [ModelConfig(name="t", family=Family.DENSE, n_layers=n,
                        d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
                        vocab_size=1024, head_dim=64) for n in range(1, 41)]
    cases = [(c, s, frac, hbm) for c in cfgs for s in (1, 2, 3, 4, 8)
             for frac, hbm in ((0.002, 5e7), (0.01, 2e8), (0.05, 1e9),
                               (0.3, 1e9), (0.6, 16e9))]
    llama = get_config("llama3.3-70b")
    cases += [(llama, 1, frac, hbm) for frac in (0.9, 1.0)
              for hbm in (20e9, 60e9, 70e9, 75e9, 150e9)]
    for cfg, n_stage, frac, hbm in cases:
        a = JE.plan_for(cfg, n_stage, hbm_frac_for_weights=frac, hbm_bytes=hbm)
        b = PE.plan_for(port_cfg(cfg), n_stage, hbm_frac_for_weights=frac,
                        hbm_bytes=hbm)
        assert (b.n_seg, b.k_res_list, b.k_off_list) \
            == (a.n_seg, a.k_res_list, a.k_off_list), (cfg.n_layers, n_stage,
                                                       frac, hbm)


# ----------------------------------------------------------------------------
# the engine's passes
# ----------------------------------------------------------------------------
def _cfg(name, tiny_dense_factory):
    if name == "tiny":
        return tiny_dense_factory(n_layers=4)
    return dataclasses.replace(get_smoke_config("gemma3-1b"), n_layers=4,
                               window_size=6)


def _engine(cfg, pp, B, max_len, plan=None, headroom=1):
    plan = plan or PE.UniformPlan(1, 2, 1, 1)
    eng = PE.InterleavedEngine(port_cfg(cfg), plan, mb=B, max_len=max_len,
                               retier_headroom=headroom, device="cpu")
    return eng, eng.init_state(pp)


def _compare(jl, pl, V):
    """Logits within LOGIT_TOL, greedy equal outside near ties; returns the
    reference's argmax."""
    a, b = f32(jl)[..., :V], f32(pl)[..., :V]
    np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
    clear = margin(a) > LOGIT_TOL
    np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
    return a.argmax(-1)


@pytest.mark.parametrize("name,max_len", [("tiny", 32), ("gemma-window6", 16)])
def test_engine_vs_jax_single_device(name, max_len, tiny_dense_factory):
    """prefill_partial (rounds of 4) + 6 decode steps + one verify of
    q_len 4 + rollback + 2 decode steps, teacher-forced on the reference's
    picks. gemma: sliding window 6 on every layer, and the verify round
    lands at slot 0 of the 16-slot ring after 16 positions."""
    cfg = _cfg(name, tiny_dense_factory)
    V = cfg.vocab_size
    jp, _, pp = jax_params(cfg)
    B, P = 2, 10
    rng = np.random.default_rng(5)
    toks = rng.integers(1, V, (B, P)).astype(np.int32)
    eng, st = _engine(cfg, pp, B, max_len)
    assert eng.resident_layer_ids() == [0, 2]
    jdecode = jax.jit(functools.partial(JM.decode_step, cfg))
    jverify = jax.jit(functools.partial(JM.verify_step, cfg))
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks), JM.init_cache(cfg, B, max_len))
    pl, st = eng.prefill_partial(st, torch.from_numpy(toks).long(), chunk=4)
    tok = _compare(jl[:, -1], pl[:, -1], V)
    for _ in range(6):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
        pl, st = eng.decode_step(st, torch.from_numpy(tok[:, None]).long())
        tok = _compare(jl[:, -1], pl, V)
    p0 = st["pos"]
    assert p0 == int(jc["pos"]) == P + 6
    mat = np.concatenate([tok[:, None], rng.integers(1, V, (B, 3))], 1)
    jl, jc = jverify(jp, jc, jnp.asarray(mat, jnp.int32))
    pl, st = eng.verify_step(st, torch.from_numpy(mat).long())
    am = _compare(jl, pl, V)                             # (B, 4)
    np.testing.assert_array_equal(st["pos_ids"].numpy(), np.asarray(jc["pos_ids"]))
    # commit column 1 (one draft accepted): feed the pick after it
    jc = dict(jc, pos=jnp.int32(p0 + 2))
    st = eng.rollback(st, p0 + 2)
    tok = am[:, 1]
    for _ in range(2):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
        pl, st = eng.decode_step(st, torch.from_numpy(tok[:, None]).long())
        tok = _compare(jl[:, -1], pl, V)


def _model_cache(cfg, B, max_len):
    return PM.init_cache(port_cfg(cfg), B, max_len, device="cpu")


def test_engine_matches_port_model_bitwise(tiny_dense_factory):
    """Prefill rounds, decode, verify and a draft step equal the port's
    model bit for bit: the engine runs the model's decode_layer on weights
    copied through its tiers (the streamed ones through the load
    buffers)."""
    cfg = tiny_dense_factory(n_layers=4)
    pcfg = port_cfg(cfg)
    _, _, pp = jax_params(cfg)
    B, max_len = 2, 32
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (B, 10))).long()
    eng, st = _engine(cfg, pp, B, max_len)
    mc = _model_cache(cfg, B, max_len)

    def same(a, b):
        assert torch.equal(a, b)
        for key in ("k", "v", "pos_ids"):
            assert torch.equal(st[key], mc[key]), key
        assert st["pos"] == mc["pos"]

    el, st = eng.prefill_partial(st, toks, chunk=4)
    for off in range(0, 10, 4):
        ml, mc = PM.verify_step(pcfg, pp, mc, toks[:, off:off + 4])
    same(el, ml)
    tok = ml[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(2):
        el, st = eng.decode_step(st, tok)
        ml, mc = PM.decode_step(pcfg, pp, mc, tok)
        same(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    mat = torch.cat([tok, toks[:, :2]], 1)
    el, st = eng.verify_step(st, mat)
    ml, mc = PM.verify_step(pcfg, pp, mc, mat)
    same(el, ml)
    # the draft step is the model cut to the resident layers
    res = eng.resident_layer_ids()
    tcfg = dataclasses.replace(pcfg, n_layers=len(res))
    tpar = {k: v for k, v in pp.items() if k != "layers"}
    tpar["layers"] = {k: {n: t[res] for n, t in d.items()} if isinstance(d, dict)
                      else d[res] for k, d in pp["layers"].items()}
    tc = {"pos": st["pos"], "pos_ids": st["pos_ids"].clone(),
          "k": st["k"][res].clone(), "v": st["v"][res].clone()}
    el, st = eng.draft_step(st, tok)
    ml, tc = PM.decode_step(tcfg, tpar, tc, tok)
    assert torch.equal(el, ml[:, 0])
    assert torch.equal(st["k"][res], tc["k"]) and torch.equal(st["v"][res], tc["v"])
    assert torch.equal(st["pos_ids"], tc["pos_ids"])


def test_layer_source_state_matches_model(tiny_dense_factory):
    """init_params_by_layer's source draws each layer deterministically:
    the engine built from it and the model reading it agree bit for bit,
    and a second init_state reuses the loaded tiers with a fresh cache."""
    pcfg = port_cfg(tiny_dense_factory(n_layers=4))
    params = PM.init_params_by_layer(pcfg, seed=3, device="cpu")
    w0 = params["layers"](1)["mlp"]["wo"]
    assert torch.equal(params["layers"](1)["mlp"]["wo"], w0)
    assert not torch.equal(params["layers"](2)["mlp"]["wo"], w0)
    assert abs(w0.float().std().item() - 4 ** -0.5) < 0.05
    eng = PE.InterleavedEngine(pcfg, PE.UniformPlan(1, 2, 1, 1), mb=2,
                               max_len=16, retier_headroom=1, device="cpu")
    st = eng.init_state(params)
    flat0 = eng._res[0]
    tok = torch.tensor([[3], [5]])
    el, st = eng.decode_step(st, tok)
    ml, _ = PM.decode_step(pcfg, params, PM.init_cache(pcfg, 2, 16,
                                                       device="cpu"), tok)
    assert torch.equal(el, ml[:, 0])
    st = eng.init_state(params)
    assert eng._res[0] is flat0 and st["pos"] == 0
    assert int((st["pos_ids"] >= 0).sum()) == 0


def test_retier_mid_stream_changes_no_token(tiny_dense_factory):
    """Greedy decode with retier(+1) after step 2 and retier(-1) after step
    4 gives the logits of the run without retier, bit for bit (mirrors
    test_engine_hetero_and_retier_token_identical). 6 layers in 2 chunks
    of 2 resident + 1 streamed: a demotion moves layers 1 and 4 into the
    streamed tier, ahead of the streamed tails 2 and 5."""
    cfg = tiny_dense_factory(n_layers=6)
    _, _, pp = jax_params(cfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, (2, 8))).long()
    runs = []
    for retier in (False, True):
        eng, st = _engine(cfg, pp, 2, 32, plan=PE.UniformPlan(1, 2, 2, 1))
        lg, st = eng.prefill_partial(st, toks, chunk=8)
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        out = [lg[:, -1]]
        for step in range(8):
            if retier and step == 2:
                w1 = eng._res[1].clone()
                st, freed = eng.retier(st, 0, +1)
                assert freed == eng.slot_hbm_bytes() > 0
                assert eng.resident_layer_ids() == [0, 3]
                assert eng.demoted(0) == 1 and eng.demote_capacity(0) == 0
                assert [l for l, _ in eng._order(False)] == list(range(6))
                assert torch.equal(eng.store.data[0, 0], w1)   # headroom slot
                assert eng.retier(st, 0, +1)[1] == 0.0         # no capacity
            if retier and step == 4:
                st, freed = eng.retier(st, 0, -1)
                assert freed == -eng.slot_hbm_bytes()
                assert eng.resident_layer_ids() == [0, 1, 3, 4]
                assert torch.equal(eng._res[1], w1)
            lg, st = eng.decode_step(st, tok)
            out.append(lg)
            tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        runs.append(torch.stack(out))
        assert eng.retier_stats()["k_res_live"] == [2]
    assert torch.equal(runs[0], runs[1])
