"""The port's simulator substrate against the JAX package's, on the CPU.

`core/pipeline_sim.py` (InterleavedPipelineSim, simulate_lime),
`core/baselines.py` (PP, PP+offload, EdgeShard, Galaxy, TPI-LLM and its
offload variant), `core/kv_transfer.py`, `tune/refit.py` and the paper's
device profiles (Tab. II's Jetsons, E1-E3, the low-memory settings of
§V-C) are framework-free copies: both packages run the same Python float
arithmetic on the same CostEnv, so every StepTrace field, every
SimResult flag, every flight-recorder event (ts included) and every
refit decision must be equal, `==`, not within a tolerance. The paper's
settings: E1, E2, E3 and env_lowmem(1..3); 100 and 200 Mbps; LLaMA-3.3-70B,
Qwen3-32B and LLaMA-2-13B; with and without the planner and the KV
transfer; a bandwidth schedule; a true_env drift folded back by the
online re-fit. critical_path.analyze reads the same rounds on both
packages' traces."""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core import cost_model as JCM  # noqa: E402
from repro.core import kv_transfer as JKV  # noqa: E402
from repro.core import pipeline_sim as JS  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.core.offline_scheduler import allocate as jax_allocate  # noqa: E402
from repro.kvcache import PagedKVConfig as JPoolCfg  # noqa: E402
from repro.kvcache import PagePool as JPool  # noqa: E402
from repro.obs import critical_path as jcp  # noqa: E402
from repro.obs import trace as jtr  # noqa: E402
from repro.serving import SimBackend as JBackend  # noqa: E402
from repro.tune import refit as JR  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import baselines as PB  # noqa: E402
from repro_torch.core import cost_model as PCM  # noqa: E402
from repro_torch.core import kv_transfer as PKV  # noqa: E402
from repro_torch.core import pipeline_sim as PS  # noqa: E402
from repro_torch.core import profiles as PP  # noqa: E402
from repro_torch.core.offline_scheduler import allocate as port_allocate  # noqa: E402
from repro_torch.kvcache import PagedKVConfig as PPoolCfg  # noqa: E402
from repro_torch.kvcache import PagePool as PPool  # noqa: E402
from repro_torch.obs import critical_path as pcp  # noqa: E402
from repro_torch.obs import trace as ptr  # noqa: E402
from repro_torch.serving import SimBackend as PBackend  # noqa: E402
from repro_torch.tune import refit as PR  # noqa: E402

ARCHS = ("llama3.3-70b", "qwen3-32b", "llama2-13b")
ENVS = ("E1", "E2", "E3", "lowmem1", "lowmem2", "lowmem3")

# one package's modules, so each case builds its inputs twice, once per
# package, from the same description
JAX = dict(S=JS, B=JB, CM=JCM, P=JP, KV=JKV, R=JR, tr=jtr, cp=jcp,
           cfg=jax_config, alloc=jax_allocate, Pool=JPool, PoolCfg=JPoolCfg,
           Backend=JBackend)
PORT = dict(S=PS, B=PB, CM=PCM, P=PP, KV=PKV, R=PR, tr=ptr, cp=pcp,
            cfg=port_config, alloc=port_allocate, Pool=PPool,
            PoolCfg=PPoolCfg, Backend=PBackend)


def _devices(m, env):
    if env.startswith("lowmem"):
        return m["P"].env_lowmem(int(env[-1]))
    return getattr(m["P"], f"env_{env}")()


def _env(m, arch, env, mbps, n_micro=1, ctx=64):
    cm = m["CM"]
    return cm.CostEnv(_devices(m, env), m["P"].mbps(mbps),
                      cm.Workload(m["cfg"](arch), mb=1, ctx=ctx,
                                  n_micro=n_micro))


def _result(r):
    return ([dataclasses.astuple(t) for t in r.per_token],
            r.oom, r.oot, r.reason)


def _traced(m, fn):
    with m["tr"].tracing() as tr:
        out = fn()
    return out, tr.events(), tr.dropped


def test_paper_profiles_equal():
    for name in ("XAVIER_NX_16", "AGX_ORIN_32", "AGX_ORIN_64"):
        assert getattr(PP, name) == getattr(JP, name) or \
            dataclasses.asdict(getattr(PP, name)) \
            == dataclasses.asdict(getattr(JP, name))
    for env in ENVS:
        assert [dataclasses.asdict(d) for d in _devices(PORT, env)] \
            == [dataclasses.asdict(d) for d in _devices(JAX, env)]
    assert PP.mbps(100) == JP.mbps(100)
    assert not hasattr(PP, "TPU_V5E")          # a TPU's figures stay there


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("arch", ARCHS)
def test_simulate_lime_equal(arch, env):
    """Alg. 1's plan and the interleaved timeline, sporadic at 100 Mbps and
    bursty (|D| micro-batches) at 200 Mbps: StepTraces, flags and the
    traced stage / weight / hop spans equal."""
    for mbps, bursty in ((100, False), (200, True)):
        got = []
        for m in (JAX, PORT):
            n_micro = len(_devices(m, env)) if bursty else 1
            env_ = _env(m, arch, env, mbps, n_micro)
            got.append(_traced(m, lambda: _result(m["S"].simulate_lime(
                env_, m["cfg"](arch).n_layers, 12, n_micro=n_micro,
                oot_s_per_token=600.0))))
        assert got[1] == got[0], (arch, env, mbps)
        assert got[0][0][0] or got[0][0][1]        # tokens, or an OOM


@pytest.mark.parametrize("arch", ARCHS)
def test_baselines_equal(arch):
    """The five baselines (and TPI-LLM's offload variant) on every
    environment and both bandwidths: equal traces, equal OOM / OOT."""
    n_layers = JAX["cfg"](arch).n_layers
    assert list(PB.BASELINES) == list(JB.BASELINES)
    for env in ENVS:
        for mbps in (100, 200):
            for n_micro in (1, 4):
                for name in JB.BASELINES:
                    a = JB.BASELINES[name](_env(JAX, arch, env, mbps, n_micro),
                                           n_layers, 6, n_micro=n_micro,
                                           oot_s_per_token=120.0)
                    b = PB.BASELINES[name](_env(PORT, arch, env, mbps, n_micro),
                                           n_layers, 6, n_micro=n_micro,
                                           oot_s_per_token=120.0)
                    assert _result(b) == _result(a), (env, mbps, name)


def _bw_schedule(tok):
    # 200 Mbps, a drop to 50 Mbps at token 6, back up at token 12
    return JP.mbps(50.0) if 6 <= tok < 12 else JP.mbps(200.0)


@pytest.mark.parametrize("switches", [
    dict(use_planner=True, use_kv_transfer=True),
    dict(use_planner=True, use_kv_transfer=False),
    dict(use_planner=False, use_kv_transfer=False),
    dict(use_planner=False, use_kv_transfer=False,
         planner_full_layer_fallback=True),
], ids=["planner+kv", "planner", "neither", "full-layer-fallback"])
@pytest.mark.parametrize("arch,env,prompt", [
    ("llama3.3-70b", "lowmem3", 2090), ("llama2-13b", "E1", 5810)])
def test_planner_and_kv_transfer_switches(arch, env, prompt, switches):
    """The planner and the KV-transfer protocol on and off, at a prompt
    just under a device's first TS threshold (the ladder fires within the
    run), under a bandwidth drop and rise (Alg. 2's reaction): equal
    traces and events. On LLaMA-3.3-70B the delegated KV delays that
    threshold past the run (Fig. 10's point); without the protocol it
    fires."""
    got = []
    for m in (JAX, PORT):
        e = _env(m, arch, env, 200, n_micro=2, ctx=prompt)
        got.append(_traced(m, lambda: _result(m["S"].simulate_lime(
            e, m["cfg"](arch).n_layers, 18, n_micro=2, prompt=prompt,
            bandwidth_schedule=_bw_schedule, **switches))))
    assert got[1] == got[0]
    fired = sum(t[4] for t in got[0][0][0])
    planner = switches["use_planner"] \
        or switches.get("planner_full_layer_fallback", False)
    delayed = switches["use_kv_transfer"] and arch == "llama3.3-70b"
    assert fired == (1 if planner and not delayed else 0)


def _drift_run(m, arch, env, refit):
    """An InterleavedPipelineSim on Alg. 1's plan: 10 steps as planned, then
    the loaders slowed to 40% and compute to 70% (set_true_env), 20 more;
    with `refit` an OnlineRefit folds the drift into the planned env and
    rebuilds the planner's ladders."""
    e = _env(m, arch, env, 200, n_micro=2)
    plan = m["alloc"](e, m["cfg"](arch).n_layers, n_emp=512).plan
    sim = m["S"].InterleavedPipelineSim(e, plan, prompt_tokens=64)
    r = None
    if refit:
        r = m["R"].OnlineRefit(e, config=m["R"].RefitConfig(
            half_life_s=1.0, min_samples=3, cooldown_s=0.5))
        sim.attach_refit(r)
    traces = [sim.step_once(n_micro=2) for _ in range(10)]
    slow = m["CM"].CostEnv(
        [dataclasses.replace(d, load_bw=d.load_bw * 0.4, flops=d.flops * 0.7)
         for d in e.devices], e.bw_net, e.work)
    sim.set_true_env(slow)
    traces += [sim.step_once(n_micro=2, q_len=1 + (i % 3))
               for i in range(20)]
    out = [dataclasses.astuple(t) for t in traces]
    planner = [[dataclasses.astuple(s) for s in lad]
               for lad in sim.planner.ladders]
    states = [dataclasses.astuple(s) for s in sim.planner.states]
    devs = [dataclasses.asdict(d) for d in e.devices]
    events = [dataclasses.astuple(ev) for ev in r.events] if r else []
    drift = [r.drift(i) for i in range(len(e.devices))] if r else []
    return out, planner, states, devs, events, drift


@pytest.mark.parametrize("refit", [False, True], ids=["drift", "refit"])
def test_true_env_drift_and_refit_equal(refit):
    got = [_traced(m, lambda: _drift_run(m, "llama3.3-70b", "E2", refit))
           for m in (JAX, PORT)]
    assert got[1] == got[0]
    events = got[0][0][4]
    if refit:
        # decode is memory-bound on the Jetsons: the slower loaders are
        # what the re-fit sees, the slower compute hides under mem_bw
        assert events and {e[2] for e in events} == {"load_bw"}
        assert any(e[0] == jtr.TUNE_REFIT for e in got[0][1])
    # the planned env moved only under the re-fit
    assert (got[0][0][3] != [dataclasses.asdict(d)
                             for d in JP.env_E2()]) == refit


def test_refit_consume_events_equal():
    """OnlineRefit replaying an exported trace's weight.fetch spans."""
    (_, evs, _) = _traced(JAX, lambda: _drift_run(JAX, "llama3.3-70b", "E2",
                                                  False))
    out = []
    for m in (JAX, PORT):
        e = _env(m, "llama3.3-70b", "E2", 200, n_micro=2)
        r = m["R"].OnlineRefit(e, config=m["R"].RefitConfig(min_samples=2))
        n = r.consume_events(evs)
        out.append((n, [r.drift(i) for i in range(len(e.devices))],
                    [dataclasses.astuple(x) for x in r.maybe_refit(1e9)]))
    assert out[1] == out[0] and out[0][0] > 0


def _mixed_run(m):
    """step_once driven as the serving layer drives it: mixed rounds of
    per-micro-batch q_lens, explicit ctx and kv_tokens, a PagePool the
    Eq. 8 volumes migrate on, and priced forced swaps."""
    e = _env(m, "llama3.3-70b", "lowmem1", 100, n_micro=3, ctx=256)
    plan = m["alloc"](e, 80, n_emp=1024).plan
    sim = m["S"].InterleavedPipelineSim(
        e, plan, prompt_tokens=256, bandwidth_schedule=_bw_schedule)
    pool = m["Pool"](m["PoolCfg"](page_size=16, device_pages=400,
                                  host_pages=400, page_bytes=4096.0))
    pool.alloc_pages(150)                  # the admitted streams' pages
    sim.attach_page_pool(pool)
    # the pool's instants take the tracer's clock: bind it to the
    # simulator's, as the scheduler binds it to its backend's
    m["tr"].get_tracer().clock = lambda: sim.now
    out = []
    for i in range(16):
        if i % 5 == 4:
            out.append(sim.charge_transfer(2.0e6 * i))
        sim.advance_to(sim.now + (0.5 if i == 7 else 0.0))
        q_lens = [64, 1, 1] if i < 4 else [1, 5, 1]
        t = sim.step_once(ctx=256 + 40 * i, n_micro=3, kv_tokens=300 + 90 * i,
                          q_lens=q_lens)
        out.append(dataclasses.astuple(t))
    out.append((sim.now, sim.kv_moved_bytes, sim._tok_count,
                [s.n_trans for s in sim.kv.states],
                pool.pages_in_use("device"), pool.pages_in_use("host"),
                pool.migrated_bytes))
    sim.reset_clock()
    out.append(dataclasses.astuple(sim.step_once()))
    return out


def test_step_once_mixed_rounds_and_pool_equal():
    got = [_traced(m, lambda: _mixed_run(m)) for m in (JAX, PORT)]
    assert got[1] == got[0]


@pytest.mark.parametrize("env", ["E3", "lowmem3"])
def test_kv_transfer_protocol_equal(env):
    """Fig. 10's pairing, Eq. 8's volumes and Alg. 2's bandwidth reaction
    (drop: immediate; rise: lazy near the next threshold; below n_ts:
    ignored), step by step, and the volumes as page movement."""
    out = []
    for m in (JAX, PORT):
        e = _env(m, "llama3.3-70b", env, 200, n_micro=2, ctx=512)
        plan = m["alloc"](e, 80, n_emp=1024).plan
        kv = m["KV"].KVTransferProtocol(
            e, plan, m["KV"].OnlinePlanner(e, plan, horizon_tokens=1 << 16))
        rec = [[dataclasses.astuple(s) for s in kv.states]]
        kv.init_transfers(ctx_tokens=512)
        for bw, tot in ((50, 600), (80, 700), (300, 900), (200, 4000),
                        (25, 5000)):
            rec.append(kv.on_bandwidth(JP.mbps(bw), tot))
            kv.refresh(tot)
            rec.append([(kv.eq8_tokens(i), kv.transferred_tokens(i),
                         kv.load_reduction_bytes_seg(i),
                         kv.transfer_time_seg(i),
                         kv.effective_kv_tokens(i, tot))
                        for i in range(len(plan.stages))])
        rec.append(kv.delegated_pages(16))
        out.append(rec)
    assert out[1] == out[0]


def _rounds(m, arch, env):
    """A bursty batch of 4 on each package's SimBackend, no scheduler: the
    prefill pass and 8 decode rounds (the backend wraps each simulator
    step in the step span critical_path reads as a round)."""
    e = _env(m, arch, env, 200, n_micro=4)
    be = m["Backend"](e, n_slots=4, prompt_tokens=64)
    reqs = [types.SimpleNamespace(prompt_len=64 + 16 * i, cached_tokens=0)
            for i in range(4)]
    be.start_batch(reqs)
    for _ in range(8):
        be.decode_active([0, 1, 2, 3])
    return be.now()


@pytest.mark.parametrize("arch,env", [("llama3.3-70b", "E3"),
                                      ("qwen3-32b", "lowmem1")])
def test_critical_path_rounds_equal_on_both_traces(arch, env):
    """critical_path.analyze over each package's own simulator trace: the
    same events, the same rounds and attribution, and the port's module
    reading JAX's trace as JAX's does."""
    got = [_traced(m, lambda: _rounds(m, arch, env)) for m in (JAX, PORT)]
    assert got[1] == got[0]
    evs = got[0][1]
    ref = jcp.analyze(evs).to_dict()
    assert pcp.analyze(got[1][1]).to_dict() == ref
    assert pcp.analyze(evs).to_dict() == ref
    assert ref["n_rounds"] == 9
