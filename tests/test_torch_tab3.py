"""The rest of the JAX package's dense decoder configs in the port, held
against the JAX package on the CPU, on the same numpy weights (JAX's
init_params, converted through params_from_numpy):

- the paper's Tab. III rows 1 and 2, LLaMA-2-13B (MHA: G 1) and Qwen3-32B
  (G 8); internlm2-1.8b (G 2); codeqwen1.5-7b (G 1);
- StableLM-2-12B: parallel blocks (attention and MLP on one pre-norm, no
  second norm) at head_dim 160;
- Pixtral-12B: the VLM backbone, patch embeddings prefilled in front of
  the text.

Each config is cut to 2 layers of narrow width by ``reduced`` with
overrides that keep its full config's G and head_dim (``reduced`` alone
makes head_dim 64 and G <= 2). Logits are held to LOGIT_TOL
(``_torch_parity``) and greedy picks must be equal wherever the
reference's top-2 margin exceeds it. The reference runs op by op
(``jax.disable_jit``): at head_dim 128 and 160 XLA's fusion, which skips
bf16 roundings that op-by-op code takes, moves the jit-compiled
reference's logits by up to 0.25 from its own op-by-op run, while the
port stays within 0.07 of that run. The engine is held to the port's own
model bit for bit. The cost model and Alg. 1 are held to JAX at the full
configs within 1e-12.
"""
import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import LOGIT_TOL, f32, jax_params, margin, port_cfg  # noqa: E402
from test_torch_planning import ENVS, _envs, _same_result, close  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.configs.base import Family as JFamily  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.core import cost_model as JC  # noqa: E402
from repro.core import offline_scheduler as JS  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.kvcache.paged_decode import PagedDecodeCache as JPDC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core import offline_scheduler as PS  # noqa: E402
from repro_torch.kvcache.paged_decode import PagedDecodeCache  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serving import LimeServer  # noqa: E402
from repro_torch.specdec import SpecConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

NEW_ARCHS = ["llama2-13b", "qwen3-32b", "internlm2-1.8b", "codeqwen1.5-7b",
             "stablelm-12b", "pixtral-12b"]
BF16_ULP = 2.0 ** -7
B, S, MAX_LEN, N_DECODE, Q_VERIFY = 2, 12, 32, 8, 4


def small(arch, n_layers=2):
    """The arch cut to n_layers at d_model 256, with its full config's G
    and head_dim (at least 4 query heads)."""
    cfg = JR.get_config(arch)
    G = cfg.n_heads // cfg.n_kv_heads
    H = max(4, G)
    return reduced(cfg, n_layers=n_layers, n_heads=H, n_kv_heads=H // G,
                   head_dim=cfg.head_dim)


def _inputs(cfg, seed=1):
    """(prompt tokens (B, S), patch embeddings (B, n_patch, d_model) fp32
    for the VLM, else None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fe = None
    if cfg.family == JFamily.VLM:
        fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)) \
            .astype(np.float32)
    return toks, fe


# ----------------------------------------------------------------------------
# the configs
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_registered_field_for_field(arch):
    jcfg = JR.get_config(arch)
    assert arch in PR.ARCHS
    assert PR.get_config(arch) == port_cfg(jcfg)
    assert PR.get_smoke_config(arch) == port_cfg(JR.get_smoke_config(arch))
    small_cfg = small(arch)
    assert small_cfg.head_dim == jcfg.head_dim
    assert small_cfg.n_heads // small_cfg.n_kv_heads \
        == jcfg.n_heads // jcfg.n_kv_heads
    assert small_cfg.parallel_block == jcfg.parallel_block


def test_paper_models_match_jax():
    assert PR.PAPER_MODELS == JR.PAPER_MODELS
    assert set(PR.PAPER_MODELS) <= set(PR.ARCHS)
    for arch in JR.PAPER_MODELS:
        assert PR.get_config(arch) == port_cfg(JR.get_config(arch))


# ----------------------------------------------------------------------------
# prefill, decode and verify against the JAX package
# ----------------------------------------------------------------------------
# the JAX package's impl for each of the port's: the reference math, or
# its Pallas kernels (interpret mode on the CPU), whose plain versions the
# port's kernel wrappers run on the CPU
JAX_IMPL = {"ref": "ref", "kernel": "pallas"}


def _jax_run(arch, impl):
    """The JAX package's prefill, N_DECODE decode steps teacher-forced on
    its own greedy picks, and (not for the VLM) one verify pass of
    Q_VERIFY tokens, op by op under `impl`: logits, caches and the tokens
    fed, as numpy."""
    cfg = small(arch)
    jp, _, _ = jax_params(cfg)
    toks, fe = _inputs(cfg)
    kw = {} if fe is None else {"frontend_embeds": jnp.asarray(fe)}
    V = cfg.vocab_size
    with jax.disable_jit():
        jl, jc = JM.prefill(cfg, jp, jnp.asarray(toks),
                            JM.init_cache(cfg, B, MAX_LEN), impl=impl, **kw)
        steps = [(f32(jl)[:, -1, :V], jax.tree.map(np.asarray, jc))]
        fed = []
        for _ in range(N_DECODE):
            fed.append(steps[-1][0].argmax(-1).astype(np.int32))
            jl, jc = JM.decode_step(cfg, jp, jc, jnp.asarray(fed[-1][:, None]),
                                    impl=impl)
            steps.append((f32(jl)[:, -1, :V], jax.tree.map(np.asarray, jc)))
        verify = None
        if cfg.family != JFamily.VLM:
            mat = np.concatenate([steps[-1][0].argmax(-1)[:, None],
                                  np.random.default_rng(2).integers(
                                      1, V, (B, Q_VERIFY - 1))], 1) \
                .astype(np.int32)
            jl, jc = JM.verify_step(cfg, jp, jc, jnp.asarray(mat), impl=impl)
            verify = (mat, f32(jl)[..., :V], jax.tree.map(np.asarray, jc))
    return steps, fed, verify


def _compare(a, b, pc=None, jc=None):
    """Logits within LOGIT_TOL, greedy equal where the reference's top-2
    margin exceeds it; the caches' pos_ids equal and K/V within 4 bf16
    ulps of their largest entry."""
    np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
    clear = margin(a) > LOGIT_TOL
    np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
    if pc is not None:
        np.testing.assert_array_equal(pc["pos_ids"].numpy(), jc["pos_ids"])
        assert pc["pos"] == int(jc["pos"])
        for key in ("k", "v"):
            ref = f32(jc[key])
            np.testing.assert_allclose(f32(pc[key]), ref, rtol=4 * BF16_ULP,
                                       atol=4 * BF16_ULP * np.abs(ref).max())
    return int(clear.sum())


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_verify_vs_jax(arch, impl):
    """Prefill (the VLM's with patch embeddings in front), 8 decode steps
    teacher-forced on the reference's picks, then a verify pass of 4
    tokens (the VLM's is refused on both sides); the port's impl against
    its JAX counterpart (JAX_IMPL)."""
    cfg = small(arch)
    pcfg = port_cfg(cfg)
    _, _, pp = jax_params(cfg)
    toks, fe = _inputs(cfg)
    steps, fed, verify = _jax_run(arch, JAX_IMPL[impl])
    kw = {} if fe is None else {"frontend_embeds": torch.from_numpy(fe)}
    pl, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                        PM.init_cache(pcfg, B, MAX_LEN, device="cpu"),
                        impl=impl, **kw)
    V = cfg.vocab_size
    n_clear = _compare(steps[0][0], f32(pl)[:, -1, :V], pc, steps[0][1])
    assert pc["pos"] == S + (0 if fe is None else cfg.frontend_tokens)
    for t, tok in enumerate(fed):
        pl, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(tok[:, None]).long(),
                                impl=impl)
        n_clear += _compare(steps[t + 1][0], f32(pl)[:, -1, :V], pc,
                            steps[t + 1][1])
    # most positions are clear of a near tie: the greedy check has teeth
    assert n_clear >= (N_DECODE + 1) * B // 2
    if verify is None:
        with pytest.raises(NotImplementedError):
            PM.verify_step(pcfg, pp, pc, torch.zeros((B, Q_VERIFY)).long())
        with pytest.raises(NotImplementedError):
            JM.verify_step(cfg, jax_params(cfg)[0], JM.init_cache(cfg, B, MAX_LEN),
                           jnp.zeros((B, Q_VERIFY), jnp.int32))
        return
    mat, jl, jc = verify
    pl, pc = PM.verify_step(pcfg, pp, pc, torch.from_numpy(mat).long(), impl=impl)
    _compare(jl, f32(pl)[..., :V], pc, jc)


def test_pixtral_patch_prefill_rolls_the_ring_vs_jax():
    """Pixtral's prefill with 16 patch embeddings before a 12-token prompt
    into a 24-slot cache, against JAX's: the patches take positions 0-15
    (pos and pos_ids count them; the 28 positions roll into the ring),
    they change the logits, and 4 decode steps follow. The paths that take
    no patch embeddings refuse the VLM, as JAX's do: paged decode, the
    engine, speculative decoding."""
    max_len = 24
    cfg = small("pixtral-12b")
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg)
    toks, fe = _inputs(cfg, seed=3)
    with jax.disable_jit():
        jl, jc = JM.prefill(cfg, jp, jnp.asarray(toks),
                            JM.init_cache(cfg, B, max_len),
                            frontend_embeds=jnp.asarray(fe))
    pl, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                        PM.init_cache(pcfg, B, max_len, device="cpu"),
                        frontend_embeds=torch.from_numpy(fe))
    V = cfg.vocab_size
    a = f32(jl)[:, -1, :V]
    _compare(a, f32(pl)[:, -1, :V], pc, jc)
    assert pc["pos"] == cfg.frontend_tokens + S > max_len
    bare, _ = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                         PM.init_cache(pcfg, B, max_len, device="cpu"))
    assert np.abs(f32(bare)[:, -1, :V] - a).max() > 10 * LOGIT_TOL
    tok = a.argmax(-1)
    for _ in range(4):
        with jax.disable_jit():
            jl, jc = JM.decode_step(cfg, jp, jc,
                                    jnp.asarray(tok[:, None], jnp.int32))
        pl, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(tok[:, None]).long())
        a = f32(jl)[:, -1, :V]
        _compare(a, f32(pl)[:, -1, :V], pc, jc)
        tok = a.argmax(-1)
    with pytest.raises(NotImplementedError):
        PagedDecodeCache(pcfg, B, max_len, page_size=8, device="cpu")
    with pytest.raises(NotImplementedError):
        JPDC(cfg, B, max_len, page_size=8)
    with pytest.raises(NotImplementedError):
        PE.InterleavedEngine(pcfg, PE.UniformPlan(1, 2, 1, 0), device="cpu")
    with pytest.raises(ValueError, match="pure-KV"):
        LimeServer(pcfg, pp, max_len=max_len, spec=SpecConfig(k=2, draft="resident"),
                   device="cpu").make_backend()


# ----------------------------------------------------------------------------
# the engine against the port's model
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama2-13b", "qwen3-32b", "stablelm-12b"],
                         ids=["G1", "G8", "parallel-block"])
def test_engine_matches_port_model_bitwise(arch):
    """4 layers as 2 segments of 1 resident + 1 streamed layer, retier
    headroom 1: chunked prefill rounds, decode steps with a retier(+1) in
    between (both resident layers streamed through the headroom slots), a
    verify pass and a draft step equal the port's model bit for bit; so do
    decode steps of an engine built from a layer source (init_params_by_
    layer, whose parallel-block layers hold no ln2)."""
    cfg = small(arch, n_layers=4)
    pcfg = port_cfg(cfg)
    _, _, pp = jax_params(cfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (B, 10))).long()
    eng = PE.InterleavedEngine(pcfg, PE.UniformPlan(1, 2, 1, 1), mb=B,
                               max_len=MAX_LEN, retier_headroom=1, device="cpu")
    st = eng.init_state(pp)
    mc = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")

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
    for step in range(3):
        if step == 1:
            st, freed = eng.retier(st, 0, +1)
            assert freed > 0 and eng.resident_layer_ids() == []
        el, st = eng.decode_step(st, tok)
        ml, mc = PM.decode_step(pcfg, pp, mc, tok)
        same(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    st, _ = eng.retier(st, 0, -1)
    mat = torch.cat([tok, toks[:, :2]], 1)
    el, st = eng.verify_step(st, mat)
    ml, mc = PM.verify_step(pcfg, pp, mc, mat)
    same(el, ml)
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
    # an engine built from a layer source, against the model reading it
    src = PM.init_params_by_layer(pcfg, seed=3, device="cpu")
    assert ("ln2" in src["layers"](0)) == (not cfg.parallel_block)
    eng2 = PE.InterleavedEngine(pcfg, PE.UniformPlan(1, 2, 1, 1), mb=B,
                                max_len=16, device="cpu")
    st2 = eng2.init_state(src)
    mc2 = PM.init_cache(pcfg, B, 16, device="cpu")
    tok = toks[:, :1]
    for _ in range(2):
        el, st2 = eng2.decode_step(st2, tok)
        ml, mc2 = PM.decode_step(pcfg, src, mc2, tok)
        assert torch.equal(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)


# ----------------------------------------------------------------------------
# paged decode and verify for the parallel block
# ----------------------------------------------------------------------------
def test_stablelm_paged_vs_jax():
    """StableLM's parallel blocks through the paged path: seed from a
    dense prefill, decode across page boundaries, verify 4 and commit 2,
    decode again; the port's PagedDecodeCache (plain page walks) against
    JAX's PagedDecodeCache and JAX's dense decode_step, logits within
    LOGIT_TOL; page counts equal and no page left after release."""
    cfg = small("stablelm-12b")
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg)
    Sp, ps = 11, 8
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (B, Sp)) \
        .astype(np.int32)
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks), JM.init_cache(cfg, B, MAX_LEN))
    jpc = JPDC(cfg, B, MAX_LEN, page_size=ps)
    jpc.seed(jc)
    _, pc_dense = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                             PM.init_cache(pcfg, B, MAX_LEN, device="cpu"))
    ppc = PagedDecodeCache(pcfg, B, MAX_LEN, page_size=ps, impl="kernel",
                           device="cpu")
    ppc.seed(pc_dense)
    assert ppc.pages_in_use == jpc.pages_in_use == B * 2
    jdec = jax.jit(functools.partial(JM.decode_step, cfg))
    V = cfg.vocab_size
    tok = np.array(jnp.argmax(jl[:, -1, :V], -1), np.int32)[:, None]

    def both(j, p):
        j, p = f32(j)[..., :V], f32(p)[..., :V]
        np.testing.assert_allclose(p, j, atol=LOGIT_TOL)
        clear = margin(j) > LOGIT_TOL
        np.testing.assert_array_equal(p.argmax(-1)[clear], j.argmax(-1)[clear])
        return j

    for _ in range(7):                        # positions 11..17: page 2 opens
        jd, jc = jdec(jp, jc, jnp.asarray(tok))
        want = both(jpc.step(jp, jnp.asarray(tok)),
                    ppc.step(pp, torch.from_numpy(tok)))
        np.testing.assert_allclose(f32(jd)[..., :V], want, atol=LOGIT_TOL)
        tok = want[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert ppc.pages_in_use == jpc.pages_in_use == B * 3
    draft = np.concatenate([tok, np.random.default_rng(8).integers(
        1, V, (B, 3)).astype(np.int32)], 1)
    both(jpc.verify(jp, draft), ppc.verify(pp, torch.from_numpy(draft)))
    jpc.commit(2)
    ppc.commit(2)
    assert ppc.pos == jpc.pos == 20 and ppc.pages_in_use == jpc.pages_in_use
    tok = draft[:, 2:3]
    for _ in range(2):
        want = both(jpc.step(jp, jnp.asarray(tok)),
                    ppc.step(pp, torch.from_numpy(tok)))
        tok = want[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert [t.pages for t in ppc.tables] == [t.pages for t in jpc.tables]
    ppc.release()
    assert ppc.pool.pages_in_use() == 0 and ppc.pool.alloc.used_pages == 0


# ----------------------------------------------------------------------------
# the launcher (LimeServer on these configs: tests/test_torch_serving.py)
# ----------------------------------------------------------------------------
LAUNCH = ["--smoke", "--device", "cpu", "--pattern", "bursty", "--requests",
          "2", "--max-new", "3", "--prompt-len", "6", "--max-len", "32"]


@pytest.mark.parametrize("arch,extra,backend", [
    (a, [], "fallback") for a in NEW_ARCHS] + [
    ("qwen3-32b", ["--layers", "4", "--hbm-bytes", "4.6e6", "--plan",
                   "hetero"], "engine"),
    ("stablelm-12b", ["--layers", "4", "--hbm-bytes", "3e6"], "engine")],
    ids=NEW_ARCHS + ["qwen3-hetero", "stablelm-engine"])
def test_launcher_accepts_arch_on_cpu(arch, extra, backend, capsys):
    assert launch.main(["--arch", arch] + LAUNCH + extra) == 0
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{"):])
    assert rep["backend"] == backend and rep["n_requests"] == 2
    assert rep["total_tokens"] == 2 * 3 and rep["n_rejected"] == 0
    if backend == "engine":
        assert "predicted T_total" in out or "resident layers" in out


# ----------------------------------------------------------------------------
# the cost model and Alg. 1 at the full configs
# ----------------------------------------------------------------------------
PAPER_NEW = ["llama2-13b", "qwen3-32b"]


@pytest.mark.parametrize("env", list(ENVS))
@pytest.mark.parametrize("arch", PAPER_NEW)
def test_workload_and_alg1_match_jax(arch, env):
    """Workload's per-layer bytes and FLOPs (MHA at KV 40 included) and
    Alg. 1's plans and candidates on the JAX package's device profiles,
    equal to JAX within 1e-12."""
    for mb in (1, 4):
        je, pe = _envs(arch, mb, env)
        jw, pw = je.work, pe.work
        for f in ("l_size", "attn_block_bytes", "mlp_block_bytes", "p_A",
                  "p_M", "h_size"):
            close(getattr(pw, f), getattr(jw, f))
        for f in ("kv_bytes_per_token_layer", "layer_flops",
                  "layer_bytes_touched"):
            close(getattr(pw, f)(), getattr(jw, f)())
        cfg = pw.cfg
        assert pw.kv_bytes_per_token_layer() \
            == 2 * cfg.n_kv_heads * cfg.head_dim * 2 * mb
        n_layers = cfg.n_layers
        for n_emp in (128, 512):
            _same_result(JS.allocate(je, n_layers, n_emp=n_emp),
                         PS.allocate(pe, n_layers, n_emp=n_emp))


# (weight budget, memory scale, (n_seg, resident layers) or None for every
# layer resident) of the launcher's --plan hetero at n_emp 512 on the H100
# profile. Alg. 1 finds LLaMA-2-13B's offloading plans at few budgets: its
# memory formula counts a segment's whole streamed set as a load buffer,
# so only one streamed layer a segment fits (22e9: 28 resident + 12
# streamed, the plan chip_smoke.py serves; 20e9 is relaxed x1.96 to all
# 40 resident). Qwen3-32B at 40e9 streams 28 of 64 layers.
H100_PLANS = {
    "llama2-13b": ((20e9, 1.96, None), (22e9, 1.0, (12, 28)),
                   (24e9, 1.0, (9, 31)), (30e9, 1.0, None)),
    "qwen3-32b": ((36e9, 1.0, (32, 32)), (40e9, 1.0, (28, 36)),
                  (75e9, 1.0, None))}


@pytest.mark.parametrize("arch", PAPER_NEW)
def test_h100_hetero_plan_matches_jax(arch):
    """The launcher's --plan hetero on the H100 profile (allocate_with_retry
    over cost_env) against JAX's ladder on the same envs: the same scale,
    plan and candidates."""
    pcfg = PR.get_config(arch)
    jcfg = JR.get_config(arch)
    for budget, want_scale, want in H100_PLANS[arch]:
        r, env, scale = launch.hetero_plan(pcfg, budget, width=4,
                                           prompt_len=512, n_emp=512,
                                           load_bw=44.8e9)

        def mk_jax(s):
            pdev = launch.cost_env(pcfg, budget * s, width=4, prompt_len=512,
                                   load_bw=44.8e9).devices[0]
            dev = JP.DeviceProfile(**dataclasses.asdict(pdev))
            return JC.CostEnv([dev], env.bw_net, JC.Workload(jcfg, 4, 512, 1),
                              net_latency=0.0)
        jr, jenv, jscale = JS.allocate_with_retry(mk_jax, jcfg.n_layers,
                                                  n_emp=512)
        assert scale == jscale == pytest.approx(want_scale)
        close(env.devices[0].mem_bytes, jenv.devices[0].mem_bytes)
        _same_result(jr, r)
        p = r.plan
        if want is None:
            assert (p.n_seg, p.stages[0].resident_total) == (1, jcfg.n_layers)
        else:
            assert (p.n_seg, p.stages[0].resident_total,
                    p.stages[0].off_layers_seg()) == want + (1,)
