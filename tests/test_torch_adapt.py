"""The online memory adaptation and Alg. 1's plans on the port's engine,
on the CPU (4 layers of the LLaMA-3.3-70B smoke config; a forced weight
budget keeps 2 of them resident, the rest streamed):

- an adaptive serve (paged admission, an OnlinePlanner on the engine's
  plan) whose ladder fires a demotion while requests are live;
- a tight-budget serve that reclaims retier headroom before it would
  preempt (the port's counterpart of the JAX package's
  test_adaptive_backend_reclaims_instead_of_preempting), where the static
  engine refuses to preempt (it could resume a request only from its
  prompt);
- serves on Alg. 1's plans (one with a block-split layer, streamed whole
  by the engine; one whose resident count does not divide the segments,
  laid out exactly).

Each one's tokens equal the non-adapted serve's exactly (a retier moves
weights only, plans only place layers) and the JAX package's
single-device greedy serve, under test_torch_engine.py's near-tie rule
(the engine drifts from jit-compiled JAX by up to 0.18 at 4 layers, held
at 0.25). Also the launcher's --adapt and --plan hetero on the CPU.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import jax_params, logits_along, margin, port_cfg  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.serving.server import LimeServer as JaxServer  # noqa: E402
from repro_torch.core.cost_model import ExecutionPlan, StageAlloc  # noqa: E402
from repro_torch.core.engine import InterleavedEngine, plan_for, plan_layout  # noqa: E402
from repro_torch.core.online_planner import OnlinePlanner  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 LimeServer, SchedulerConfig, summarize)
from repro_torch.specdec import SpecConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

MAX_LEN = 32
MAX_NEW = 12
PAGE = 8
HBM = 4.6e6        # weight budget: 2 of the 4 layers resident
# test_torch_engine.py's rule: the engine equals the port's model bit for
# bit and drifts from jit-compiled JAX by up to 0.18 at 4 layers
LOGIT_TOL = 0.25
# one smoke layer's HBM holds 144 tokens of the 4-wide batch's KV, under
# the planner's default rung of 256 tokens (a 70B layer holds ~1300): the
# planner tests take rungs of 128
RUNG = 128


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_smoke_config("llama3.3-70b"), n_layers=4)
    jp, _, pp = jax_params(cfg)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(4)]
    ref = JaxServer(cfg, jp, max_len=MAX_LEN, pattern="bursty")
    for p in prompts:
        ref.queue.submit(p, MAX_NEW)
    ref = sorted(ref.serve_all(), key=lambda r: r.rid)
    return cfg, jp, pp, prompts, [r.output for r in ref]


def _engine(cfg, plan, headroom):
    return InterleavedEngine(port_cfg(cfg), plan, mb=4, max_len=MAX_LEN,
                             retier_headroom=headroom, device="cpu")


def _serve(cfg, pp, prompts, eng, scfg, *, planner=None, spec=None):
    """Serve the bursty batch step by step; returns (requests by rid,
    stats, backend, [(decode rounds so far, live requests) at each step
    where the retier count grew])."""
    srv = LimeServer(port_cfg(cfg), pp, engine=eng, max_len=MAX_LEN,
                     pattern="bursty", spec=spec, prefill_chunk_tokens=4,
                     planner=planner, device="cpu")
    for p in prompts:
        srv.queue.submit(p, MAX_NEW)
    be = srv.make_backend()
    sched = ContinuousBatchingScheduler(be, scfg)
    reqs = srv.queue.drain()
    sched.begin(reqs)
    fired, events = [], 0
    while sched.step():
        if be.adapt_stats["retier_events"] > events:
            events = be.adapt_stats["retier_events"]
            fired.append((len(be.rounds), sum(not r.done for r in reqs)))
    done = sorted(sched.finish_run(), key=lambda r: r.rid)
    return done, sched.stats, be, fired


def _check_tokens(model, got, want=None):
    """Served tokens equal `want` (the non-adapted serve) and the JAX
    greedy serve's, or first diverge from the latter at a near tie of the
    reference (top-2 margin below LOGIT_TOL) where the port's logits, fed
    the reference's tokens, stay within LOGIT_TOL."""
    cfg, jp, pp, prompts, ref = model
    outs = [r.output for r in got]
    assert all(len(o) == MAX_NEW for o in outs)
    if want is not None:
        assert outs == want
    for p, a, b in zip(prompts, outs, ref):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        la, lb = logits_along(cfg, jp, pp, p, b[:t], MAX_LEN)
        assert margin(la[t:t + 1])[0] < LOGIT_TOL, \
            f"token {t} diverges outside a near tie"
        np.testing.assert_allclose(lb[t], la[t], atol=LOGIT_TOL)


@pytest.fixture(scope="module")
def plain_outputs(model):
    """The non-adapted serve: plan_for's plan, no headroom, reserve policy."""
    cfg, _, pp, prompts, _ = model
    plan = plan_for(port_cfg(cfg), 1, hbm_frac_for_weights=launch.HBM_FRAC,
                    hbm_bytes=HBM)
    out = {}
    for k in (0, 3):
        eng = _engine(cfg, plan, 0)
        done, _, _, _ = _serve(cfg, pp, prompts, eng, SchedulerConfig(),
                               spec=SpecConfig(k=k, draft="resident",
                                               adapt_k=False) if k else None)
        out[k] = [r.output for r in done]
        assert eng.resident_layer_ids() == [0, 2]
        eng.close()
    return out


@pytest.mark.parametrize("k", (0, 3), ids=("decode", "spec-k3"))
def test_adaptive_serve_planner_retiers_mid_serve(k, model, plain_outputs):
    """The ladder of plan_for's plan (one rung at 84 tokens of occupancy,
    rungs of RUNG tokens; the default rung leaves it empty) fires once the
    batch's pages pass 84 tokens, after the prefill and before the last round;
    max(alpha, beta) = 1 slot demotes (the headroom's cap) and the pool
    grows by the slot's HBM in pages. The served tokens are the
    non-adapted serve's."""
    cfg, _, pp, prompts, _ = model
    pcfg = port_cfg(cfg)
    plan = plan_for(pcfg, 1, hbm_frac_for_weights=launch.HBM_FRAC,
                    hbm_bytes=HBM)
    env = launch.cost_env(pcfg, HBM, width=4, prompt_len=8)
    freed_tokens = pcfg.layer_params() * 2 \
        // (env.work.kv_bytes_per_token_layer() * pcfg.n_layers)
    assert freed_tokens == 144
    assert OnlinePlanner(env, plan, horizon_tokens=4 * 4 * MAX_LEN).ladders \
        == [[]]
    planner = OnlinePlanner(env, plan, horizon_tokens=4 * 4 * MAX_LEN,
                            ladder_chunk_tokens=RUNG)
    assert [(s.threshold_tokens, s.alpha, s.beta) for s in planner.ladders[0]] \
        == [(84, 1, 1)]
    eng = _engine(cfg, plan, 1)
    scfg = SchedulerConfig(kv_policy="paged", page_size=PAGE)
    done, stats, be, fired = _serve(cfg, pp, prompts, eng, scfg,
                                    planner=planner,
                                    spec=SpecConfig(k=k, draft="resident",
                                                    adapt_k=False) if k else None)
    n_rounds = len(be.rounds)
    assert len(fired) == 1
    at, live = fired[0]
    assert 1 <= at < n_rounds and live == 4          # mid-serve
    assert planner.states[0].plan_idx >= 1
    assert stats["retier_events"] == 1 and stats["layers_demoted"] == 1
    assert stats["layers_streamed_now"] == 1
    assert stats["hbm_returned_bytes"] == eng.slot_hbm_bytes()
    assert eng.resident_layer_ids() == []        # the slot of both segments
    pool = be._pool
    grown = int(eng.slot_hbm_bytes() // be._page_bytes())
    assert pool.cfg.device_pages + grown == pool.free_pages() + pool.pages_in_use()
    assert sum(r.preempted for r in done) == 0
    _check_tokens(model, done, plain_outputs[k])
    eng.close()


def test_adaptive_serve_reclaims_before_preempting(model, plain_outputs):
    """88 tokens of pages (11) admit the batch (2 pages each plus the
    watermark) but cannot hold its growth to 3 pages each: the static
    engine (no headroom) would have to preempt, and refuses (the backend
    resumes a request from its prompt alone, so a resumed request would
    repeat its first tokens); the adaptive one demotes a resident slot
    first (its HBM in pages) and preempts nothing; its tokens are the
    non-adapted serve's."""
    cfg, _, pp, prompts, _ = model
    plan = plan_for(port_cfg(cfg), 1, hbm_frac_for_weights=launch.HBM_FRAC,
                    hbm_bytes=HBM)
    scfg = SchedulerConfig(kv_budget_tokens=88, kv_policy="paged",
                           page_size=PAGE, preempt="spill")
    eng = _engine(cfg, plan, 0)
    with pytest.raises(RuntimeError, match="must be preempted .* resumes a "
                       "request from its prompt alone"):
        _serve(cfg, pp, prompts, eng, scfg)
    eng.close()
    eng = _engine(cfg, plan, 1)
    done, stats, be, _ = _serve(cfg, pp, prompts, eng, scfg)
    eng.close()
    adapt = summarize(done, stats=stats)
    assert all(r.done and not r.rejected for r in done)
    assert adapt.n_preempted == 0
    assert adapt.retier_events == 1 and adapt.retier_reclaimed_pages > 0
    assert adapt.hbm_returned_bytes > 0
    assert be._grants == [(0, adapt.retier_reclaimed_pages)]
    _check_tokens(model, done, plain_outputs[0])


@pytest.mark.parametrize("hbm,n_seg,stage,resident", [
    (HBM, 2, (2, 0, 0, 1), [0, 2]),   # MHA resident, MLP streamed: a split layer
    (3e6, 3, (1, 1, 0, 0), [0])])     # 1 resident over 3 segments
def test_alg1_plan_serve(hbm, n_seg, stage, resident, model, plain_outputs):
    """The launcher's hetero path plans the 4 layers with Alg. 1 (n_emp =
    max_len); the engine lays out exactly the plan's resident layers and
    serves the tokens of plan_for's engine."""
    cfg, _, pp, prompts, _ = model
    r, env, scale = launch.hetero_plan(port_cfg(cfg), hbm, width=4,
                                       prompt_len=8, n_emp=MAX_LEN)
    plan = r.plan
    assert scale == 1.0 and r.feasible and r.reason == ""
    assert (plan.n_seg, dataclasses.astuple(plan.stages[0])) == (n_seg, stage)
    assert plan.k_off == 1 and plan.t_total > 0
    eng = _engine(cfg, plan, 0)
    assert eng.resident_layer_ids() == resident
    done, _, _, _ = _serve(cfg, pp, prompts, eng, SchedulerConfig())
    _check_tokens(model, done, plain_outputs[0])
    eng.close()


LAYOUTS = [   # (n_seg, resident_total, streamed a segment, headroom, live)
    (41, 39, 1, 0, None),     # Alg. 1's 80-layer plan on one H100
    (3, 1, 1, 0, None),       # the 4-layer plan above
    (3, 4, 1, 1, None),       # 2 resident slots, the last segments hold 1
    (3, 4, 1, 1, [1])]        # ... with slot 1 demoted


@pytest.mark.parametrize("n_seg,res,off,headroom,live", LAYOUTS)
def test_plan_layout_holds_the_plans_resident_count(n_seg, res, off,
                                                    headroom, live):
    """A resident count that does not divide the segments: every layer
    sits in exactly one slot, in layer order, and the build layout holds
    exactly resident_total of them resident (the first segments one more
    than the last); a demotion moves only the real layers of its slot."""
    plan = ExecutionPlan(n_seg, [StageAlloc(res, off)])
    L = plan.layers_total()
    r, o = plan_layout(plan, headroom, live)
    real_r, real_o = r[r < L], o[o < L]
    assert sorted(np.concatenate([real_r, real_o]).tolist()) == list(range(L))
    per_seg = (r[:, 0] < L).sum(-1) + (o[:, 0] < L).sum(-1)
    order = np.concatenate([np.concatenate([r[s, 0][r[s, 0] < L],
                                            o[s, 0][o[s, 0] < L]])
                            for s in range(n_seg)])
    assert order.tolist() == list(range(L))
    n_res = (r[:, 0] < L).sum(-1)
    if live is None:
        assert n_res.sum() == res
        k = -(-res // n_seg)
        assert n_res.tolist() == [k] * (res - n_seg * (k - 1)) \
            + [k - 1] * (n_seg - res + n_seg * (k - 1))
    else:
        assert (r[:, 0, live[0]:] >= L).all()
    assert per_seg.sum() == L


def test_slot_hbm_bytes_counts_the_slots_layers(model):
    """3 segments, 4 resident layers: slot 0 holds a layer in every
    segment, slot 1 only in the first; a demotion of slot 1 returns one
    layer's HBM, not Eq. 7's (#Seg - 1) of a full slot."""
    cfg = port_cfg(dataclasses.replace(model[0], n_layers=7))
    eng = InterleavedEngine(cfg, ExecutionPlan(3, [StageAlloc(4, 1)]), mb=1,
                            max_len=MAX_LEN, retier_headroom=2, device="cpu")
    layer = cfg.layer_params() * 2.0
    assert eng.resident_layer_ids() == [0, 1, 3, 5]
    assert eng.slot_hbm_bytes(0, 0) == 2 * layer
    assert eng.slot_hbm_bytes(0, 1) == layer
    assert eng.retier(None, 0, +1)[1] == layer            # slot 1 first
    assert eng.resident_layer_ids() == [0, 3, 5]
    assert eng.retier(None, 0, +1)[1] == 2 * layer
    assert eng.resident_layer_ids() == []
    assert eng.retier(None, 0, -2)[1] == -3 * layer


LAUNCH = ["--arch", "llama3.3-70b", "--smoke", "--layers", "4", "--device",
          "cpu", "--pattern", "bursty", "--requests", "4", "--max-new", "12",
          "--max-len", "32", "--prompt-len", "8", "--page-size", "8"]


@pytest.mark.parametrize("extra,want", [
    (["--hbm-bytes", "3.2e6", "--adapt", "--retier-headroom", "1",
      "--pattern", "sporadic"], "adapt"),
    (["--hbm-bytes", "4.6e6", "--plan", "hetero"], "hetero"),
    (["--hbm-bytes", "3e6", "--plan", "hetero", "--adapt"], "hetero-adapt")])
def test_launcher_plan_and_adapt_on_cpu(extra, want, capsys):
    assert launch.main(LAUNCH + extra) == 0
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{"):])
    assert rep["backend"] == "engine" and rep["n_requests"] == 4
    assert rep["total_tokens"] == 4 * 12 and rep["n_rejected"] == 0
    assert "predicted T_total" in out
    if "hetero" in want:
        assert "Alg. 1:" in out
    if want == "adapt":
        # one sequence at a time: one layer holds 576 tokens of its KV,
        # over the default rung of 256; the reference's memory formula
        # puts the first rung at 0 tokens (as at full size on one H100)
        assert "planner ladder (tokens, alpha, beta): [(0, 0, 1), (92, 1, 1)]" \
            in out
        assert rep["retier_events"] == 1 and rep["hbm_returned_bytes"] > 0
        assert rep["n_preempted"] == 0 and rep["peak_kv_pages"] == 3


@pytest.mark.parametrize("extra,match", [
    (["--adapt"], "--adapt retiers"),
    # Alg. 1 relaxed the memory x3.84: its 1 resident layer (1.18 MB) is
    # more than 1.1 MB x 0.92 holds
    (["--hbm-bytes", "1.1e6", "--plan", "hetero", "--max-len", "128"],
     "holds 1 resident layers")])
def test_launcher_refuses(extra, match):
    with pytest.raises(SystemExit, match=match):
        launch.main(LAUNCH + extra)

