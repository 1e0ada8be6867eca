"""The port's SimBackend and continuous-batching scheduler against the JAX
package's on the same arrival streams, on the CPU.

Both packages run the discrete-event simulator on the same CostEnv (the
serving tests' rig: LLaMA-2-13B on E3 at 200 Mbps) through the same
scheduler logic, so every number is Python float arithmetic done alike:
per request the same admitted_s, ttft_s, finish_s, generated,
preempted, cached_tokens and rejection; the same stats; the same
summarize JSON; and the same flight-recorder events, ts included. The
streams: bursty, sporadic, poisson, shared_prefix and multiturn. The
admission modes: reserve, paged (spill and recompute under pressure),
paged with the radix prefix cache over the admission pool, and chunked
prefill through mixed rounds (with and without the cache). Speculation
with n-gram (flat acceptance) and resident drafts (acceptance and depth
following the live tier), the online adaptation under pool pressure,
an SLO engine's pressure fed to the planner, the online re-fit, and the
reference's spill-resume fault under speculation, which both packages
reach alike."""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import cost_model as JCM  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.obs import critical_path as jcp  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import trace as jtr  # noqa: E402
from repro import serving as JSV  # noqa: E402
from repro.specdec import SpecConfig as JSpec  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import cost_model as PCM  # noqa: E402
from repro_torch.core import profiles as PP  # noqa: E402
from repro_torch.obs import critical_path as pcp  # noqa: E402
from repro_torch.obs import slo as pslo  # noqa: E402
from repro_torch.obs import trace as ptr  # noqa: E402
from repro_torch import serving as PSV  # noqa: E402
from repro_torch.specdec import SpecConfig as PSpec  # noqa: E402

JAX = dict(cfg=jax_config, CM=JCM, P=JP, tr=jtr, sv=JSV, Spec=JSpec,
           slo=jslo, cp=jcp)
PORT = dict(cfg=port_config, CM=PCM, P=PP, tr=ptr, sv=PSV, Spec=PSpec,
            slo=pslo, cp=pcp)


def _backend(m, slots, *, prompt=64, spec=None, arch="llama2-13b",
             env="E3", **kw):
    """SimBackend over the E3 fleet (the JAX serving tests' rig)."""
    cm = m["CM"]
    w = cm.Workload(m["cfg"](arch), mb=1, ctx=prompt, n_micro=slots)
    devs = getattr(m["P"], f"env_{env}")()
    return m["sv"].SimBackend(cm.CostEnv(devs, m["P"].mbps(200), w),
                              n_slots=slots, prompt_tokens=prompt,
                              spec=None if spec is None else m["Spec"](**spec),
                              **kw)


def _serve(m, *, pattern, n, slots, arrivals, sched=None, backend=None,
           slo=False):
    """One traced serve on package `m`; everything the comparison reads."""
    sv = m["sv"]
    arr = sv.make_arrivals(pattern, n, **arrivals)
    with m["tr"].tracing() as tr:
        be = _backend(m, slots, **(backend or {}))
        s = sv.ContinuousBatchingScheduler(be, sv.SchedulerConfig(
            **(sched or {})))
        eng = None
        if slo:
            eng = m["slo"].SLOEngine(m["slo"].default_targets(
                ttft_p99_s=0.5, tpot_p50_s=0.05, fast_window_s=2.0,
                slow_window_s=6.0), seed=0)
            s.attach_slo(eng)
        done = s.serve(sv.requests_from_arrivals(arr, vocab_size=4096))
    reqs = sorted((r.rid, r.arrival_s, r.admitted_s, r.first_token_s,
                   r.finish_s, r.ttft_s, r.generated, r.preempted,
                   r.cached_tokens, r.rejected, r.done) for r in done)
    rep = sv.summarize(done, pattern=pattern, backend="sim", stats=s.stats)
    out = dict(reqs=reqs, order=[r.rid for r in done], stats=s.stats,
               report=json.dumps(rep.to_dict()), events=tr.events(),
               dropped=tr.dropped, now=be.now(),
               adapt=be.adapt_stats, spec=be.spec_stats)
    if eng is not None:
        out["slo"] = json.dumps(eng.snapshot(be.now()))
    if s.prefix is not None:
        out["tree"] = (s.prefix.n_pages, s.prefix.evicted_pages,
                       s.mgr.pool.alloc.used_pages)
    return out, rep


def _equal(**kw):
    ref, jrep = _serve(JAX, **kw)
    got, prep = _serve(PORT, **kw)
    for key in ref:
        assert got[key] == ref[key], key
    assert got.keys() == ref.keys()
    return ref, jrep


STREAMS = {
    "bursty": dict(seed=0, burst_size=4, gap_s=4.0, prompt_len=64,
                   max_new_tokens=12),
    "sporadic": dict(seed=1, gap_s=1.5, prompt_len=(32, 96),
                     max_new_tokens=(4, 12)),
    "poisson": dict(seed=2, rate_rps=3.0, prompt_len=(32, 128),
                    max_new_tokens=(4, 16)),
    "shared_prefix": dict(seed=0, n_templates=2, prefix_len=96,
                          prompt_len=128, max_new_tokens=8, rate_rps=4.0),
    "multiturn": dict(seed=1, turns=3, prompt_len=64, max_new_tokens=8,
                      rate_rps=1.0),
}


@pytest.mark.parametrize("pattern", list(STREAMS))
def test_reserve_serves_equal(pattern):
    """The reserve policy (worst-case KV reservation), continuous batching
    over 4 slots, a queue cap that sheds."""
    ref, rep = _equal(pattern=pattern, n=10, slots=4,
                      arrivals=STREAMS[pattern],
                      sched=dict(max_queue=6))
    assert rep.n_requests == 10 and ref["events"]


@pytest.mark.parametrize("preempt", ["spill", "recompute"])
@pytest.mark.parametrize("pattern", ["bursty", "poisson"])
def test_paged_serves_under_pressure_equal(pattern, preempt):
    """Paged admission with a pool of about two worst-case requests: the
    same admissions, preemptions (spill or recompute), resumes and priced
    transfers."""
    arrivals = dict(STREAMS[pattern], max_new_tokens=48)
    ref, rep = _equal(pattern=pattern, n=10, slots=4, arrivals=arrivals,
                      sched=dict(kv_policy="paged", page_size=16,
                                 kv_budget_tokens=300, preempt=preempt))
    assert rep.n_preempted > 0


@pytest.mark.parametrize("chunk", [None, 32], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("pattern", ["shared_prefix", "multiturn"])
def test_prefix_cache_serves_equal(pattern, chunk):
    """The radix prefix cache over the admission pool (hits fork COW, only
    the uncached suffix is priced; finished requests donate), and chunked
    prefill through mixed rounds."""
    ref, rep = _equal(pattern=pattern, n=12, slots=4,
                      arrivals=STREAMS[pattern],
                      sched=dict(kv_policy="paged", page_size=16,
                                 prefix_cache=True,
                                 prefill_chunk_tokens=chunk))
    assert rep.prefix_hit_rate > 0 and rep.prefill_tokens_saved > 0
    n_pages, _, used = ref["tree"]
    assert used == n_pages                 # only the tree holds pages


def test_prefix_cache_evicts_before_preempting_equal():
    """A pool the tree fills: cached leaves are evicted before a live
    request is preempted."""
    ref, rep = _equal(pattern="shared_prefix", n=12, slots=4,
                      arrivals=dict(STREAMS["shared_prefix"], n_templates=3),
                      sched=dict(kv_policy="paged", page_size=16,
                                 prefix_cache=True, kv_budget_tokens=640))
    assert ref["tree"][1] > 0              # evicted pages


@pytest.mark.parametrize("pattern", ["bursty", "poisson"])
def test_chunked_prefill_serves_equal(pattern):
    ref, rep = _equal(pattern=pattern, n=8, slots=4,
                      arrivals=dict(STREAMS[pattern], prompt_len=160),
                      sched=dict(kv_policy="paged", page_size=16,
                                 prefill_chunk_tokens=48),
                      backend=dict(prompt=160))
    names = {e[0] for e in ref["events"]}
    assert jtr.STEP in names and rep.n_requests == 8


@pytest.mark.parametrize("draft", [
    dict(k=4, acceptance=0.6, seed=0),
    dict(k=6, draft="resident", acceptance=0.9, seed=3),
], ids=["ngram", "resident"])
@pytest.mark.parametrize("sched", [
    {}, dict(kv_policy="paged", page_size=16, prefix_cache=True,
             prefill_chunk_tokens=32)], ids=["reserve", "prefix-chunked"])
def test_spec_serves_equal(draft, sched):
    """The acceptance model: a (k+1)-query verify round priced per decode
    round, per-slot commits drawn from the seeded rng; for the resident
    draft the acceptance follows the live resident share and the
    DepthController adapts k."""
    ref, rep = _equal(pattern="shared_prefix", n=8, slots=4,
                      arrivals=dict(STREAMS["shared_prefix"],
                                    max_new_tokens=19),
                      sched=sched, backend=dict(spec=draft))
    assert rep.spec_rounds > 0 and 0 < ref["spec"]["spec_accepted"]


def test_resident_spec_follows_demotions_equal():
    """The resident draft on a plan the planner demotes under adaptation:
    a thinner resident tier, lower acceptance, smaller k; equal rounds."""
    ref, rep = _equal(pattern="bursty", n=12, slots=4,
                      arrivals=dict(STREAMS["bursty"], max_new_tokens=40),
                      sched=dict(kv_policy="paged", page_size=16,
                                 kv_budget_tokens=420, preempt="recompute"),
                      backend=dict(spec=dict(k=6, draft="resident",
                                             acceptance=0.9, seed=1),
                                   adapt=True))
    assert ref["adapt"]["retier_events"] > 0 and rep.spec_rounds > 0


@pytest.mark.parametrize("adapt", [False, True], ids=["static", "adapt"])
def test_adaptation_under_pool_pressure_equal(adapt):
    """The JAX serving test's adaptation rig (16 bursty requests, 8 slots,
    a pool of two worst cases, recompute): with adapt the scheduler
    reclaims retier headroom (the TS ladder force-advanced, the pool
    grown) before it preempts."""
    ref, rep = _equal(pattern="bursty", n=16, slots=8,
                      arrivals=dict(seed=0, prompt_len=64,
                                    max_new_tokens=96, gap_s=8.0,
                                    burst_size=8),
                      sched=dict(kv_budget_tokens=int(2.0 * (64 + 96)),
                                 kv_policy="paged", page_size=16,
                                 preempt="recompute"),
                      backend=dict(adapt=adapt))
    assert rep.n_preempted > 0 or adapt
    assert (rep.retier_events > 0) == adapt


def test_slo_pressure_and_refit_equal():
    """An SLO engine attached (its pressure reaches the sim's planner) and
    the online re-fit on a drifted true_env (LLaMA-3.3-70B on E1, whose
    plan streams: the loaders run at 30% of the planned rate)."""
    drift = {}
    for m, key in ((JAX, "jax"), (PORT, "port")):
        cm = m["CM"]
        devs = [d.__class__(**{**d.__dict__, "load_bw": d.load_bw * 0.3})
                for d in m["P"].env_E1()]
        w = cm.Workload(m["cfg"]("llama3.3-70b"), mb=1, ctx=64, n_micro=4)
        drift[key] = cm.CostEnv(devs, m["P"].mbps(200), w)
    out = []
    for m, key in ((JAX, "jax"), (PORT, "port")):
        got, rep = _serve(m, pattern="poisson", n=6, slots=4,
                          arrivals=dict(STREAMS["poisson"], rate_rps=8.0),
                          sched=dict(kv_policy="paged", page_size=16),
                          backend=dict(arch="llama3.3-70b", env="E1",
                                       refit=True,
                                       true_env=drift[key]),
                          slo=True)
        out.append(got)
    for key in out[0]:
        assert out[1][key] == out[0][key], key
    assert any(e[0] == jtr.TUNE_REFIT for e in out[0]["events"])


def test_critical_path_on_served_traces_equal():
    """critical_path.analyze on each package's own serve trace: equal
    reports with rounds and per-request waterfalls."""
    ref, _ = _serve(JAX, pattern="bursty", n=8, slots=4,
                    arrivals=STREAMS["bursty"],
                    sched=dict(kv_policy="paged", page_size=16))
    got, _ = _serve(PORT, pattern="bursty", n=8, slots=4,
                    arrivals=STREAMS["bursty"],
                    sched=dict(kv_policy="paged", page_size=16))
    a = jcp.analyze(ref["events"]).to_dict()
    b = pcp.analyze(got["events"]).to_dict()
    assert b == a and a["n_rounds"] > 0 and len(a["requests"]) == 8


def test_spec_spill_resume_fault_matches_jax():
    """A reference fault the simulator's speculative rounds reach (ROADMAP
    §C.2): a live table grown by a whole round (k + 1 tokens) commits
    fewer; spilled and resumed, the re-entry extend asks for fewer tokens
    than the table holds and the block table refuses to shrink. The port's
    scheduler copies the reference, so both raise alike, on the same
    step."""
    errs = []
    for m in (JAX, PORT):
        sv = m["sv"]
        arr = sv.make_arrivals("bursty", 12, seed=0, burst_size=4,
                               gap_s=0.5, prompt_len=64,
                               max_new_tokens=40)
        be = _backend(m, 4, spec=dict(k=4, acceptance=0.3, seed=0))
        s = sv.ContinuousBatchingScheduler(be, sv.SchedulerConfig(
            kv_policy="paged", page_size=16, kv_budget_tokens=200))
        with pytest.raises(ValueError, match="cannot shrink table") as e:
            s.serve(sv.requests_from_arrivals(arr))
        errs.append((str(e.value), be.now(), be.spec_stats))
    assert errs[1] == errs[0]
