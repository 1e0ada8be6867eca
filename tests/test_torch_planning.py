"""The port's planning modules against the JAX package on the same inputs:
the cost model (Workload, CostEnv), Alg. 1 (allocate, allocate_with_retry)
and the OnlinePlanner (its ladders and walks). None of them touches an
array, so the port keeps copies of the JAX code; these tests hold the
copies to it: integers, plans and ladders exactly, times within a relative
1e-12. Profiles are the JAX package's (Jetson environments E1-E3, the
low-memory settings), carried over through dataclasses.asdict, plus the
port's own H100 profile at the card's weight budget (75.19 GB, and its
0.92 resident share 69.17 GB).

Also pinned: the units of the engine path's ladder walk. The backend
hands the planner pages_in_use x page_size summed over every slot, while
the ladder's per-token bytes already cover every sequence of the batch;
the JAX simulator divides by n_micro, the JAX engine path (and the port,
which reproduces it) does not.
"""
import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import port_cfg  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.core import cost_model as JC  # noqa: E402
from repro.core import offline_scheduler as JS  # noqa: E402
from repro.core import online_planner as JO  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.serving.backend import EngineBackend as JaxBackend  # noqa: E402
from repro.serving.backend import SimBackend as JaxSim  # noqa: E402
from repro_torch.core import cost_model as PC  # noqa: E402
from repro_torch.core import offline_scheduler as PS  # noqa: E402
from repro_torch.core import online_planner as PO  # noqa: E402
from repro_torch.core import profiles as PP  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serving.backend import EngineBackend  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

REL = 1e-12
ARCHS = ("llama3.3-70b", "gemma3-1b")
ENVS = {"E1": JP.env_E1, "E2": JP.env_E2, "E3": JP.env_E3,
        "lowmem1": lambda: JP.env_lowmem(1), "lowmem2": lambda: JP.env_lowmem(2),
        "lowmem3": lambda: JP.env_lowmem(3)}
CELLS = [(a, mb, e) for a in ARCHS for mb in (1, 4) for e in ENVS]
CELL_IDS = [f"{a}-mb{mb}-{e}" for a, mb, e in CELLS]
# the one-card budget of the 80-layer engine (free HBM less the KV cache,
# two layer buffers and the shared weights) and its resident share
H100_BUDGET = 75.19e9


def close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


def _envs(arch, mb, env, ctx=512, n_micro=1):
    """(JAX CostEnv, port CostEnv) on the same profiles and workload."""
    jdevs = ENVS[env]()
    pdevs = [PP.DeviceProfile(**dataclasses.asdict(d)) for d in jdevs]
    cfg = get_config(arch)
    return (JC.CostEnv(jdevs, JP.mbps(200), JC.Workload(cfg, mb, ctx, n_micro)),
            PC.CostEnv(pdevs, PP.mbps(200),
                       PC.Workload(port_cfg(cfg), mb, ctx, n_micro)))


def _h100_envs(mem, load_bw=44.8e9):
    """The H100 env of the launcher (no network hop) in both packages."""
    cfg = get_config("llama3.3-70b")
    pe = launch.cost_env(port_cfg(cfg), mem / launch.HBM_FRAC, width=4,
                         prompt_len=512, load_bw=load_bw)
    jdev = JP.DeviceProfile(**dataclasses.asdict(pe.devices[0]))
    je = JC.CostEnv([jdev], pe.bw_net, JC.Workload(cfg, 4, 512, 1),
                    net_latency=pe.net_latency)
    return je, pe


def _same_plan(jp, pp):
    assert (jp is None) == (pp is None)
    if jp is None:
        return
    assert pp.n_seg == jp.n_seg and pp.off_trim == jp.off_trim
    assert [dataclasses.astuple(s) for s in pp.stages] \
        == [dataclasses.astuple(s) for s in jp.stages]
    for f in ("t_comp", "t_comm", "t_uncover", "t_total"):
        close(getattr(pp, f), getattr(jp, f))
    for f in ("k_res_list", "k_off_list", "n_layers", "n_chunks", "k_max",
              "is_uniform"):
        assert getattr(pp, f) == getattr(jp, f), f
    assert pp.layers_total() == jp.layers_total()


def _plans(n_dev):
    """Plans of every shape the cost model prices: no offload, uniform
    offload, block splits, a padded segment split, uneven stages."""
    out = []
    for n_seg, res, full, attn, mlp, trim in (
            (1, 10, 0, 0, 0, 0), (2, 4, 1, 0, 0, 0), (3, 6, 1, 1, 0, 1),
            (4, 8, 0, 1, 1, 0), (5, 0, 2, 0, 1, 2)):
        out.append(((n_seg, trim), [(res + 2 * i, full, attn, mlp + i % 2)
                                    for i in range(n_dev)]))
    return out


def _build(mod, spec):
    (n_seg, trim), stages = spec
    return mod.ExecutionPlan(n_seg, [mod.StageAlloc(*s) for s in stages],
                             off_trim=trim)


# ----------------------------------------------------------------------------
# the cost model
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch,mb,env", CELLS, ids=CELL_IDS)
def test_workload_and_cost_env_match_jax(arch, mb, env):
    je, pe = _envs(arch, mb, env)
    jw, pw = je.work, pe.work
    for f in ("l_size", "attn_block_bytes", "mlp_block_bytes", "p_A", "p_M",
              "h_size"):
        close(getattr(pw, f), getattr(jw, f))
    for f in ("kv_bytes_per_token_layer", "layer_flops", "layer_bytes_touched"):
        close(getattr(pw, f)(), getattr(jw, f)())
    close(pw.layer_bytes_touched(1e6), jw.layer_bytes_touched(1e6))
    close(pe.comm_seg(), je.comm_seg())
    for i, (jd, pd) in enumerate(zip(je.devices, pe.devices)):
        close(pw.comp_layer(pd), jw.comp_layer(jd))
        close(pe.comp_layers(i, 3.5), je.comp_layers(i, 3.5))
        close(pe.load_time(i, 1e9), je.load_time(i, 1e9))
        close(pe.kv_reserve_bytes(7, 300), je.kv_reserve_bytes(7, 300))
    for spec in _plans(len(je.devices)):
        jp, pp = je.evaluate(_build(JC, spec)), pe.evaluate(_build(PC, spec))
        _same_plan(jp, pp)
        for i in range(len(je.devices)):
            close(pe.idle_seg(pp, i), je.idle_seg(jp, i))
            close(pp.stages[i].load_bytes_seg(pw), jp.stages[i].load_bytes_seg(jw))
            close(pp.stages[i].resident_bytes(pw, pp.n_seg),
                  jp.stages[i].resident_bytes(jw, jp.n_seg))
        for n_tok in (0, 128, 512, 4096, 1 << 16):
            assert pe.mem_ok(pp, n_tok) == je.mem_ok(jp, n_tok)
    # replace_device swaps one profile and leaves the env alone
    slow = dataclasses.replace(pe.devices[0], load_bw=1e6)
    pe2 = pe.replace_device(0, slow)
    assert pe2.devices[0] is slow and pe.devices[0] is not slow


def test_h100_profile_and_env():
    """The port's one profile: data-sheet peaks times the card's measured
    shares; the launcher's env gives the device the weight budget's
    resident share and has no network hop."""
    p = PP.H100_SXM
    assert (p.flops, p.mem_bw, p.load_bw) == (989.4e12 * 0.79, 2.85e12, 44.77e9)
    env = launch.cost_env(port_cfg(get_config("llama3.3-70b")), H100_BUDGET,
                          width=4, prompt_len=512)
    assert env.devices[0].mem_bytes == H100_BUDGET * launch.HBM_FRAC
    assert env.devices[0].load_bw == p.load_bw
    assert env.bw_net == p.mem_bw and env.net_latency == 0.0
    assert (env.work.mb, env.work.n_micro, env.work.ctx) == (4, 1, 512)
    assert not hasattr(PP, "TPU_V5E")


# ----------------------------------------------------------------------------
# Alg. 1
# ----------------------------------------------------------------------------
def _same_result(jr, pr):
    assert (pr.feasible, pr.reason) == (jr.feasible, jr.reason)
    assert len(pr.candidates) == len(jr.candidates)
    for (pn, pt), (jn, jt) in zip(pr.candidates, jr.candidates):
        assert pn == jn
        close(pt, jt)
    _same_plan(jr.plan, pr.plan)


@pytest.mark.parametrize("balance", (True, False), ids=("balance", "literal"))
@pytest.mark.parametrize("arch,mb,env", CELLS, ids=CELL_IDS)
def test_allocate_matches_jax(arch, mb, env, balance):
    je, pe = _envs(arch, mb, env)
    n_layers = get_config(arch).n_layers
    for n_emp in (128, 512, 2048):
        _same_result(JS.allocate(je, n_layers, n_emp=n_emp, balance=balance),
                     PS.allocate(pe, n_layers, n_emp=n_emp, balance=balance))
    _same_result(JS.allocate(je, n_layers, max_seg=3),
                 PS.allocate(pe, n_layers, max_seg=3))


@pytest.mark.parametrize("arch,env", [(a, e) for a in ARCHS for e in ENVS],
                         ids=[f"{a}-{e}" for a in ARCHS for e in ENVS])
def test_allocate_with_retry_matches_jax(arch, env):
    """The relaxation ladder on memory too tight for any plan: both
    packages climb the same scales to the same plan."""
    je, pe = _envs(arch, 4, env)
    n_layers = get_config(arch).n_layers

    def mk(mod, base):
        def mk_env(scale):
            # half a layer a device at scale 1: nothing fits
            devs = [dataclasses.replace(d, mem_bytes=0.5 * base.work.l_size
                                        * (1 + i) * scale)
                    for i, d in enumerate(base.devices)]
            return mod.CostEnv(devs, base.bw_net, base.work)
        return mk_env
    jr, jenv, js = JS.allocate_with_retry(mk(JC, je), n_layers, n_emp=1024)
    pr, penv, ps = PS.allocate_with_retry(mk(PC, pe), n_layers, n_emp=1024)
    assert ps == js and ps > 1.0
    close(penv.devices[0].mem_bytes, jenv.devices[0].mem_bytes)
    _same_result(jr, pr)


# (weight budget, n_emp) -> (n_seg, resident layers, streamed per segment)
# of allocate on the device memory itself: the card's full budget plans 38
# segments; its 0.92 resident share (the launcher's env) 41 segments of 39
# resident layers and one streamed; n_emp 1024 does not fit that share
H100_CASES = [(H100_BUDGET / launch.HBM_FRAC, 512, (38, 42, 1)),
              (H100_BUDGET / launch.HBM_FRAC, 1024, (38, 42, 1)),
              (H100_BUDGET, 512, (41, 39, 1)),
              (H100_BUDGET, 1024, None)]


@pytest.mark.parametrize("budget,n_emp,want", H100_CASES,
                         ids=[f"{b * launch.HBM_FRAC / 1e9:.2f}GB-n_emp{n}"
                              for b, n, _ in H100_CASES])
def test_allocate_h100_matches_jax(budget, n_emp, want):
    je, pe = _h100_envs(budget * launch.HBM_FRAC)
    jr, pr = JS.allocate(je, 80, n_emp=n_emp), PS.allocate(pe, 80, n_emp=n_emp)
    _same_result(jr, pr)
    if want is not None:
        p = pr.plan
        assert (p.n_seg, p.stages[0].resident_total,
                p.stages[0].off_layers_seg()) == want
    # the launcher's hetero path: allocate_with_retry over cost_env at
    # budget x scale, against the JAX ladder on the same envs
    r, env, scale = launch.hetero_plan(pe.work.cfg, budget, width=4,
                                       prompt_len=512, n_emp=n_emp,
                                       load_bw=44.8e9)

    def mk_jax(s):
        dev = JP.DeviceProfile(**dataclasses.asdict(_h100_envs(
            budget * s * launch.HBM_FRAC)[1].devices[0]))
        return JC.CostEnv([dev], pe.bw_net, je.work, net_latency=0.0)
    jr2, jenv, jscale = JS.allocate_with_retry(mk_jax, 80, n_emp=n_emp)
    assert scale == jscale
    close(env.devices[0].mem_bytes, jenv.devices[0].mem_bytes)
    _same_result(jr2, r)
    if want is None:                  # relaxed past the card: 1.4^2
        assert not pr.feasible and scale == pytest.approx(1.96)
    else:
        assert scale == 1.0
        _same_plan(r.plan, pr.plan)


def test_network_term_moves_to_uncover_on_one_card():
    """JAX's launcher network (200 Mbps, 1 ms) against the one-card env (no
    hop): the same n_seg-41 plan and the same total, the time moved from
    T_comm into T_uncover (the load is the bottleneck either way)."""
    je, pe = _h100_envs(H100_BUDGET * launch.HBM_FRAC)
    net = JC.CostEnv(je.devices, JP.mbps(200), je.work, net_latency=1e-3)
    a, b = JS.allocate(net, 80, n_emp=512).plan, PS.allocate(pe, 80, n_emp=512).plan
    assert (a.n_seg, dataclasses.astuple(a.stages[0])) \
        == (b.n_seg, dataclasses.astuple(b.stages[0]))
    assert a.t_total == pytest.approx(b.t_total, rel=1e-9)
    assert a.t_comm > 0.1 and b.t_comm < 1e-5
    assert b.t_uncover == pytest.approx(a.t_uncover + a.t_comm - b.t_comm,
                                        rel=1e-9)


# ----------------------------------------------------------------------------
# the OnlinePlanner
# ----------------------------------------------------------------------------
def test_min_load_plan_matches_jax():
    rng = np.random.default_rng(0)
    n = 0
    for need in list(np.linspace(-1e8, 4e9, 37)) + list(rng.uniform(0, 3e9, 40)):
        for attn_b, mlp_b in ((3.0e8, 1.4e9), (1.0e8, 1.0e8), (5e8, 2e8)):
            for a_max in (0, 1, 3, 8):
                for b_max in (0, 2, 5):
                    for n_seg in (1, 2, 5, 41):
                        args = (float(need), attn_b, mlp_b, a_max, b_max, n_seg)
                        assert PO._min_load_plan(*args) == JO._min_load_plan(*args)
                        n += 1
    assert n > 10000


def _ladder_cells():
    cells = []
    for arch, mb, env in CELLS[::3]:
        cells.append((arch, mb, env))
    return cells


def _fit_memory(je, pe, plan_spec):
    """The envs with each device's memory set to what the plan's weights
    hold plus room for -50, 650, 1350, ... tokens of its KV, so the
    ladder's thresholds land inside the horizon."""
    jp = _build(JC, plan_spec)
    pp = _build(PC, plan_spec)
    jdevs, pdevs = [], []
    for i, (jd, pd) in enumerate(zip(je.devices, pe.devices)):
        st = pp.stages[i]
        kv_tok = st.layers_total(pp.n_seg) * pe.work.kv_bytes_per_token_layer()
        mem = st.resident_bytes(pe.work, pp.n_seg) + (700 * i - 50) * kv_tok
        jdevs.append(dataclasses.replace(jd, mem_bytes=mem))
        pdevs.append(dataclasses.replace(pd, mem_bytes=mem))
    assert jp.n_seg == pp.n_seg
    return (dataclasses.replace(je, devices=jdevs),
            dataclasses.replace(pe, devices=pdevs))


def _planners(je, pe, plan_spec, horizon, chunk):
    jp, pp = _build(JC, plan_spec), _build(PC, plan_spec)
    return (JO.OnlinePlanner(je, jp, horizon_tokens=horizon,
                             ladder_chunk_tokens=chunk),
            PO.OnlinePlanner(pe, pp, horizon_tokens=horizon,
                             ladder_chunk_tokens=chunk))


def _same_state(jpl, ppl):
    assert [[dataclasses.astuple(s) for s in lad] for lad in ppl.ladders] \
        == [[dataclasses.astuple(s) for s in lad] for lad in jpl.ladders]
    assert [dataclasses.astuple(s) for s in ppl.states] \
        == [dataclasses.astuple(s) for s in jpl.states]
    assert (ppl.chunk, ppl.rebuilds, ppl.slo_pressure) \
        == (jpl.chunk, jpl.rebuilds, jpl.slo_pressure)
    for i in range(len(ppl.states)):
        assert ppl.next_threshold(i) == jpl.next_threshold(i)
        close(ppl.extra_load_bytes_seg(i), jpl.extra_load_bytes_seg(i))


@pytest.mark.parametrize("arch,mb,env", _ladder_cells(),
                         ids=[f"{a}-mb{m}-{e}" for a, m, e in _ladder_cells()])
def test_online_planner_ladders_and_walks_match_jax(arch, mb, env):
    """Ladders of Alg. 1's plan and of hand-built plans (memory scaled so
    thresholds land inside the horizon), then the same walk in both:
    on_token with and without transferred tokens, on_pages, SLO pressure,
    a rebuild on a slower env and more tokens after it."""
    je, pe = _envs(arch, mb, env)
    n_layers = get_config(arch).n_layers
    specs = [((1, 0), [(n_layers // len(je.devices) + 1, 0, 0, 0)]
              * len(je.devices))]
    specs += _plans(len(je.devices))[1:]
    r = JS.allocate(je, n_layers, n_emp=512)
    if r.plan is not None:
        specs.append(((r.plan.n_seg, r.plan.off_trim),
                      [dataclasses.astuple(s) for s in r.plan.stages]))
    n_fired = 0
    for spec, fit in [(sp, f) for sp in specs for f in (False, True)]:
        je_, pe_ = _fit_memory(je, pe, spec) if fit else (je, pe)
        for horizon, chunk in ((4096, 256), (1 << 16, 64)):
            jpl, ppl = _planners(je_, pe_, spec, horizon, chunk)
            _same_state(jpl, ppl)
            D = len(je.devices)
            walk = [("tok", t, None) for t in (0, 10, 300, 301, 2000)]
            walk += [("tok", 2500, [t * 100 for t in range(D)])]
            walk += [("pages", 60, 64), ("slo", 0.5, None), ("tok", 3000, None),
                     ("slo", 0.0, None), ("rebuild", 0.5, None),
                     ("tok", 5000, None), ("pages", 200, 64),
                     ("rebuild", 3.0, None), ("tok", 1 << 15, None)]
            for kind, a, b in walk:
                if kind == "tok":
                    got, want = ppl.on_token(a, b), jpl.on_token(a, b)
                elif kind == "pages":
                    got, want = ppl.on_pages(a, b), jpl.on_pages(a, b)
                elif kind == "slo":
                    ppl.note_slo_pressure(a)
                    jpl.note_slo_pressure(a)
                    got = want = []
                else:
                    slow = [dataclasses.replace(d, load_bw=d.load_bw * a)
                            for d in je_.devices]
                    jpl.rebuild(dataclasses.replace(je_, devices=slow),
                                chunk_scale=a)
                    ppl.rebuild(dataclasses.replace(pe_, devices=[
                        PP.DeviceProfile(**dataclasses.asdict(d)) for d in slow]),
                        chunk_scale=a)
                    got = want = []
                assert [(i, dataclasses.astuple(s)) for i, s in got] \
                    == [(i, dataclasses.astuple(s)) for i, s in want]
                n_fired += len(got)
                _same_state(jpl, ppl)
    assert n_fired > 0


def test_online_planner_h100_ladders():
    """plan_for's 80-layer plan on the card (2 segments, 40 resident): the
    JAX memory formula counts a whole segment's streamed set as a buffer
    (102.7 GB against 69.17), so all rungs but the last (everything
    evicted, 89 tokens) sit at 0 tokens, and the first occupancy note of a
    bursty batch (4 x 9 pages of 64) fires all of them; Alg. 1's n_seg-41
    plan has an empty ladder within the 4096-token horizon."""
    from repro.core.engine import plan_for as jplan_for
    from repro_torch.core.engine import plan_for as pplan_for
    je, pe = _h100_envs(H100_BUDGET * launch.HBM_FRAC)
    cfg = get_config("llama3.3-70b")
    jp = jplan_for(cfg, 1, hbm_frac_for_weights=launch.HBM_FRAC,
                   hbm_bytes=H100_BUDGET)
    pp = pplan_for(port_cfg(cfg), 1, hbm_frac_for_weights=launch.HBM_FRAC,
                   hbm_bytes=H100_BUDGET)
    assert (pp.n_seg, pp.k_res, pp.k_off) == (2, 20, 20)
    close(pp.stages[0].resident_bytes(pe.work, 2), 60 * pe.work.l_size)
    for horizon in (4096, 4 * 4 * 1024):
        jpl = JO.OnlinePlanner(je, jp, horizon_tokens=horizon)
        ppl = PO.OnlinePlanner(pe, pp, horizon_tokens=horizon)
        _same_state(jpl, ppl)
        lad = ppl.ladders[0]
        assert len(lad) == 82 and all(s.threshold_tokens == 0 for s in lad[:-1])
        assert (lad[-1].threshold_tokens, lad[-1].alpha, lad[-1].beta) \
            == (89, 20, 20)
        fired = [(i, dataclasses.astuple(s)) for i, s in ppl.on_pages(36, 64)]
        assert len(fired) == len(lad)
        assert fired == [(i, dataclasses.astuple(s))
                         for i, s in jpl.on_pages(36, 64)]
    a1 = PS.allocate(pe, 80, n_emp=512).plan
    assert PO.OnlinePlanner(pe, a1, horizon_tokens=4096).ladders == [[]]


class _StubEngine:
    """Just enough engine for a backend's planner hooks: one stage of
    k_res resident slots, retier headroom H; retier moves counters."""

    def __init__(self, plan, H, mb=4):
        self.plan, self.H, self.mb, self.n_mb = plan, H, mb, 1
        self.k_res_b = plan.k_res_list
        self.live = list(self.k_res_b)
        self.device = torch.device("cpu")
        self.paged = False
        self.moves = []

    def demoted(self, stage):
        return self.k_res_b[stage] - self.live[stage]

    def demote_capacity(self, stage):
        return min(self.k_res_b[stage], self.H) - self.demoted(stage)

    def resident_fraction(self):
        return sum(self.live) / max(sum(self.k_res_b), 1)

    def retier(self, state, stage, delta):
        self.moves.append((stage, delta))
        self.live[stage] -= delta
        return state, delta * 1e9


def test_engine_path_ladder_units_are_batch_totals():
    """Pins the reference's units (ROADMAP §C): the engine path walks the
    ladder on pages_in_use x page_size over all slots, the simulator on
    that total divided by n_micro, while the ladder's per-token KV bytes
    cover every sequence in flight (mb x n_micro). The port's backend
    walks exactly as the JAX engine backend does."""
    cfg = get_config("llama3.3-70b")
    n_micro, pages, ps = 4, 12, 64
    je = JC.CostEnv(JP.env_E2(), JP.mbps(200),
                    JC.Workload(cfg, mb=1, ctx=512, n_micro=n_micro))
    pe = PC.CostEnv([PP.DeviceProfile(**dataclasses.asdict(d))
                     for d in JP.env_E2()], PP.mbps(200),
                    PC.Workload(port_cfg(cfg), mb=1, ctx=512, n_micro=n_micro))
    close(pe.work.kv_bytes_per_token_layer(),
          n_micro * 2 * cfg.n_kv_heads * cfg.head_dim * 2)
    spec = ((2, 0), [(20, 1, 0, 0)] * 3)
    jpl, ppl = _planners(je, pe, spec, 4096, 256)
    jb = JaxBackend(cfg, {}, engine=_StubEngine(_build(JC, spec), H=2),
                    planner=jpl)
    pb = EngineBackend(port_cfg(cfg), {}, engine=_StubEngine(_build(PC, spec), H=2),
                       planner=ppl)
    jb.note_kv_pages(pages, ps)
    pb.note_kv_pages(pages, ps)
    assert [s.last_eff for s in ppl.states] == [s.last_eff for s in jpl.states] \
        == [pages * ps] * 3
    assert pb.engine.moves == jb.engine.moves
    _same_state(jpl, ppl)
    sim = types.SimpleNamespace(env=je, _kv_pages=(pages, ps), _ctx={})
    assert JaxSim._planner_tokens(sim) == math.ceil(pages * ps / n_micro)
