"""The port's fleet (repro_torch.fleet: router, replica, report, executor)
against the JAX package's, on the CPU.

Sim replicas (SimBackend over E3, the JAX fleet tests' rig) run on
virtual clocks, so placement and timings are reproducible: for each of
the four policies and several seeds, the same stream gives the same
placement, the same per-request timings, the same router stats, the same
FleetReport (to_dict, JSON) and the same namespaced event stream in both
packages. Then drain / join with membership in the report, the resumable
scheduler surface (stepwise serving equal to serve, submit mid-run, the
load signals), the router-side digest against the radix tree, the Chrome
export's replica process groups, and real replicas at smoke size: the
port's EngineBackend(engine=None, device="cpu") replicas over one
converted parameter set against JAX's EngineBackend(engine=None) replicas
over the JAX parameters, the same placement of a burst under the prefix
policy and JAX's tokens for every request (or a near tie), and the
launcher's --replicas report, whose keys are the JAX FleetReport's."""
import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import (assert_same_or_near_tie, jax_params,  # noqa: E402
                           port_cfg)
from _torch_threads import one_thread  # noqa: E402,F401
from repro import fleet as JF  # noqa: E402
from repro import serving as JSV  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.core import cost_model as JCM  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.obs import exporters as jexp  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import trace as jtr  # noqa: E402
from repro.prefixcache import RadixPrefixCache as JRadix  # noqa: E402
from repro_torch import fleet as PF  # noqa: E402
from repro_torch import serving as PSV  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import cost_model as PCM  # noqa: E402
from repro_torch.core import profiles as PP  # noqa: E402
from repro_torch.kvcache import BlockTable, PagedKVConfig, PagePool  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.obs import exporters as pexp  # noqa: E402
from repro_torch.obs import slo as pslo  # noqa: E402
from repro_torch.obs import trace as ptr  # noqa: E402
from repro_torch.prefixcache import PrefixDigest  # noqa: E402
from repro_torch.prefixcache import RadixPrefixCache  # noqa: E402

JAX = dict(F=JF, sv=JSV, cfg=jax_config, CM=JCM, P=JP, tr=jtr, exp=jexp,
           slo=jslo)
PORT = dict(F=PF, sv=PSV, cfg=port_config, CM=PCM, P=PP, tr=ptr, exp=pexp,
            slo=pslo)


# ----------------------------------------------------------------------------
# the rig: sim replicas over E3, as the JAX fleet tests build them
# ----------------------------------------------------------------------------
def _backend(m, slots=2, prompt=64):
    cm = m["CM"]
    w = cm.Workload(m["cfg"]("llama2-13b"), mb=1, ctx=prompt, n_micro=slots)
    return m["sv"].SimBackend(cm.CostEnv(m["P"].env_E3(), m["P"].mbps(200), w),
                              n_slots=slots, prompt_tokens=prompt)


def _replica(m, i, *, slots=2, prefix=False, page=16, slo=False):
    scfg = m["sv"].SchedulerConfig(kv_policy="paged", page_size=page,
                                   prefix_cache=True) if prefix \
        else m["sv"].SchedulerConfig()
    rep = m["F"].Replica(i, _backend(m, slots), scfg)
    if slo:
        rep.sched.attach_slo(m["slo"].SLOEngine(m["slo"].default_targets(
            ttft_p99_s=2.0, tpot_p50_s=0.2, fast_window_s=5.0,
            slow_window_s=15.0), seed=i))
    return rep


def _fleet(m, n, policy, *, seed=0, slots=2, prefix=None, slo=False):
    if prefix is None:
        prefix = policy == "prefix"
    reps = [_replica(m, i, slots=slots, prefix=prefix, slo=slo)
            for i in range(n)]
    return m["F"].Fleet(reps, config=m["F"].RouterConfig(policy=policy,
                                                         seed=seed))


def _reqs(m, pattern, n, *, seed=0, **kw):
    return m["sv"].requests_from_arrivals(
        m["sv"].make_arrivals(pattern, n, seed=seed, **kw), vocab_size=4096)


def _outcome(fleet, res, pattern, events):
    """Everything two fleets must agree on."""
    part = {name: sorted(r.rid for r in recs)
            for name, recs in res.per_replica.items()}
    timing = sorted((r.rid, r.arrival_s, r.admitted_s, r.ttft_s, r.finish_s,
                     r.generated, r.preempted, r.cached_tokens, r.rejected)
                    for r in res.requests)
    rep = res.report(pattern=pattern, backend="sim")
    return dict(part=part, timing=timing, router=dict(fleet.router.stats),
                report=rep.to_json(), shed=[r.rid for r in res.shed],
                events=events)


def _run(m, n_rep, policy, pattern, n, *, seed=0, drain=None, join=None,
         slo=False, **kw):
    """One traced fleet run on package `m`. `drain` (name, index of the
    arrival it lands on), `join` (index of the arrival)."""
    reqs = _reqs(m, pattern, n, seed=seed, **kw)
    times = sorted(r.arrival_s for r in reqs)
    fleet = _fleet(m, n_rep, policy, seed=seed, slo=slo)
    if drain is not None:
        fleet.drain(drain[0], at_s=times[drain[1]])
    if join is not None:
        fleet.join(_replica(m, n_rep, prefix=policy == "prefix", slo=slo),
                   at_s=times[join])
    with m["tr"].tracing() as tr:
        res = fleet.run(reqs)
    return _outcome(fleet, res, pattern, tr.events()), fleet, res


def _both(*a, **kw):
    ref, jf, jres = _run(JAX, *a, **kw)
    got, pf, pres = _run(PORT, *a, **kw)
    for key in ref:
        assert got[key] == ref[key], key
    return ref, (jf, jres), (pf, pres)


SHARED = dict(prompt_len=64, prefix_len=48, n_templates=2, max_new_tokens=4,
              rate_rps=2.0)


# ----------------------------------------------------------------------------
# placement, timings, router stats, report, events: equal per policy
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("policy", list(JF.POLICIES))
def test_fleet_equal_per_policy(policy, seed):
    assert PF.POLICIES == JF.POLICIES
    ref, _, (pf, pres) = _both(3, policy, "shared_prefix", 10, seed=seed,
                               **SHARED)
    assert ref["router"]["routed"] == 10
    names = {e[0] for e in ref["events"]}
    assert ptr.FLEET_ROUTE in names
    # placement is a pure function of the stream: a second run agrees
    again, _, _ = _run(PORT, 3, policy, "shared_prefix", 10, seed=seed,
                       **SHARED)
    assert again["part"] == ref["part"] and again["timing"] == ref["timing"]


@pytest.mark.parametrize("policy", ["sticky", "prefix"])
def test_fleet_equal_under_load_and_sessions(policy):
    """Multiturn sessions (stickiness, hysteresis) and poisson load
    (queue terms, spillover at a low saturation threshold), with an SLO
    engine per replica feeding health into the score."""
    ref, _, _ = _both(2, policy, "multiturn", 9, prompt_len=32,
                      max_new_tokens=4, turns=3, rate_rps=0.3, slo=True)
    assert ref["router"]["sticky_kept"] > 0
    ref, _, _ = _both(3, policy, "poisson", 14, prompt_len=64,
                      max_new_tokens=16, rate_rps=4.0, slo=True)
    assert all(ref["part"].values())


def test_spillover_equal():
    """A saturated favourite spills to the least-loaded replica (the queue
    term off, so affinity alone would keep the template on one replica)."""
    out = []
    for m in (JAX, PORT):
        reqs = _reqs(m, "shared_prefix", 16, prompt_len=64, prefix_len=48,
                     n_templates=1, max_new_tokens=8, rate_rps=50.0)
        reps = [_replica(m, i, slots=1, prefix=True) for i in range(2)]
        fleet = m["F"].Fleet(reps, config=m["F"].RouterConfig(
            policy="prefix", saturation_queue=2, w_queue=0.0))
        res = fleet.run(reqs)
        out.append(_outcome(fleet, res, "shared_prefix", []))
    assert out[1] == out[0] and out[0]["router"]["spillover"] > 0


# ----------------------------------------------------------------------------
# elastic membership
# ----------------------------------------------------------------------------
def test_drain_and_join_equal_with_membership():
    ref, _, (pf, pres) = _both(2, "sticky", "poisson", 12, prompt_len=64,
                               max_new_tokens=16, rate_rps=2.0,
                               drain=("r1", 6), join=6)
    rep = json.loads(ref["report"])
    assert rep["n_replicas"] == 3
    m = rep["membership"]
    assert m["r1"]["retired_s"] is not None and not m["r1"]["live"]
    assert m["r2"]["routed"] >= 1
    assert sum(v["routed"] for v in m.values()) == 12
    names = {e[0] for e in ref["events"]}
    assert {ptr.FLEET_DRAIN, ptr.FLEET_DRAINED, ptr.FLEET_JOIN} <= names
    assert "r1" not in pf.router._optimistic
    assert "r1" not in pf.router._home.values()


@pytest.mark.parametrize("seed", [0, 5])
def test_drain_mid_stream_equal(seed):
    ref, _, (pf, pres) = _both(3, "roundrobin", "poisson", 12, seed=seed,
                               prompt_len=64, max_new_tokens=4, rate_rps=2.0,
                               drain=("r2", 6))
    t_drain = sorted(r.arrival_s for r in pres.requests)[6]
    assert all(r.arrival_s < t_drain for r in pres.per_replica["r2"])
    assert not pres.shed and all(r.done for r in pres.requests)


def test_router_error_paths_equal():
    for m in (JAX, PORT):
        with pytest.raises(ValueError):
            m["F"].RouterConfig(policy="bogus")
        with pytest.raises(ValueError):
            m["F"].Fleet([_replica(m, 0),
                          m["F"].Replica(1, _backend(m), name="r0")])
        fleet = _fleet(m, 2, "roundrobin")
        with pytest.raises(KeyError):
            fleet.drain("nope")
        with pytest.raises(ValueError):
            fleet.join(_replica(m, 0), at_s=1.0)
        fleet.drain("r0")
        fleet.drain("r1")
        res = fleet.run(_reqs(m, "poisson", 3, prompt_len=32,
                              max_new_tokens=2, rate_rps=1.0))
        assert len(res.shed) == 3 and all(r.rejected for r in res.shed)
        assert fleet.router.stats["no_replica"] == 3


# ----------------------------------------------------------------------------
# the resumable scheduler surface the fleet co-steps on
# ----------------------------------------------------------------------------
def test_stepwise_serving_equals_serve():
    kw = dict(prompt_len=64, max_new_tokens=4, rate_rps=2.0)
    a = PSV.ContinuousBatchingScheduler(_backend(PORT), PSV.SchedulerConfig())
    done_a = a.serve(_reqs(PORT, "poisson", 8, **kw))
    b = PSV.ContinuousBatchingScheduler(_backend(PORT), PSV.SchedulerConfig())
    b.begin(_reqs(PORT, "poisson", 8, **kw))
    steps = 0
    while b.step():
        steps += 1
        assert steps < 10_000
    done_b = b.finish_run()
    j = JSV.ContinuousBatchingScheduler(_backend(JAX), JSV.SchedulerConfig())
    done_j = j.serve(_reqs(JAX, "poisson", 8, **kw))

    def key(rs):
        return sorted((r.rid, r.ttft_s, r.finish_s) for r in rs)
    assert key(done_a) == key(done_b) == key(done_j)


def _signals(m):
    sched = m["sv"].ContinuousBatchingScheduler(
        _backend(m, slots=2), m["sv"].SchedulerConfig(kv_policy="paged",
                                                      page_size=16))
    reqs = _reqs(m, "poisson", 8, prompt_len=64, max_new_tokens=4,
                 rate_rps=4.0)
    sched.begin(reqs[:4])
    out = [(sched.outstanding, sched.next_pending_s, sched.has_live_work)]
    for _ in range(3):
        sched.step()
        out.append((sched.queue_depth, sched.in_flight, sched.outstanding,
                    sched.free_kv_pages(), sched.has_live_work,
                    sched.next_pending_s))
    for r in reversed(reqs[4:]):        # late, out of order: kept sorted
        sched.submit(r)
    out.append([r.rid for r in sched._pending])
    while sched.step():
        out.append((sched.queue_depth, sched.in_flight,
                    sched.free_kv_pages()))
    done = sched.finish_run()
    out.append(sorted((r.rid, r.ttft_s, r.finish_s) for r in done))
    out.append((sched.has_live_work, sched.next_pending_s,
                sched.queue_depth, sched.in_flight))
    return out


def test_submit_mid_run_and_load_signals_equal():
    got, ref = _signals(PORT), _signals(JAX)
    assert got == ref
    assert got[-1] == (False, None, 0, 0) and len(got[-2]) == 8


# ----------------------------------------------------------------------------
# the router-side digest is the radix tree's match
# ----------------------------------------------------------------------------
def _insert(pool, tree, toks):
    t = BlockTable(pool.page_size)
    pool.extend_table(t, len(toks))
    tree.insert(toks, t.pages)


def test_digest_matches_tree_and_jax():
    rng = np.random.default_rng(0)
    pool = PagePool(PagedKVConfig(page_size=4, device_pages=64,
                                  host_pages=8, page_bytes=8.0))
    tree = RadixPrefixCache(pool)
    from repro.kvcache import PagedKVConfig as JCfg, PagePool as JPool
    jpool = JPool(JCfg(page_size=4, device_pages=64, host_pages=8,
                       page_bytes=8.0))
    jtree = JRadix(jpool)
    bases = [list(rng.integers(0, 30, size=n)) for n in (16, 12, 21)]
    for b in bases:
        _insert(pool, tree, b)
        _insert(jpool, jtree, b)
    d, jd = tree.digest(), jtree.digest()
    for b in bases:
        for cut in (0, 3, 4, 9, len(b)):
            probe = b[:cut] + [99, 98]
            assert d.match_tokens(probe) == tree.match(probe)[1] \
                == jd.match_tokens(probe)
    opt = PrefixDigest(page_size=4)
    opt.add_prompt(bases[0], max_pages=2)
    assert opt.match_tokens(bases[0]) == 8
    tree.release_all()
    assert len(tree.digest()) == 0


# ----------------------------------------------------------------------------
# observability: per-replica namespaces -> Perfetto process groups
# ----------------------------------------------------------------------------
def test_chrome_export_groups_replicas_equal():
    ref, (jf, jres), (pf, pres) = _both(2, "roundrobin", "poisson", 6,
                                        prompt_len=32, max_new_tokens=2,
                                        rate_rps=2.0, drain=("r1", 3))
    evs = ref["events"]
    tracks = {e[ptr.EVT_TRACK] for e in evs}
    assert any(t.startswith("r0:") for t in tracks) and "router" in tracks
    assert {ptr.FLEET_ROUTE, ptr.FLEET_DRAIN, ptr.FLEET_DRAINED} \
        <= {e[0] for e in evs}
    tr, jtrc = ptr.Tracer(), jtr.Tracer()
    for e in evs:
        tr._push(e)
        jtrc._push(e)
    doc = pexp.to_chrome(tr)
    assert doc == jexp.to_chrome(jtrc) and pexp.validate_chrome(doc) == []
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"replica r0", "replica r1", "router"} <= names
    assert ptr.get_tracer() is None


def test_router_digest_page_size_fault_pinned():
    """A reference fault the port's launcher does not copy (ROADMAP §C.2):
    the JAX launcher's fleet builds each replica's scheduler as
    SchedulerConfig(), page size 64, whatever --page-size gives the
    backends, and the router keys its optimistic digests on that page
    size, so on prompts of 64 tokens or fewer the prefix policy matches
    nothing. make_fleet gives the scheduler the backends' page size. Both
    packages' routers behave alike on either config."""
    out = []
    for m in (JAX, PORT):
        for scfg in (m["sv"].SchedulerConfig(),
                     m["sv"].SchedulerConfig(page_size=8)):
            reps = [m["F"].Replica(i, _backend(m), scfg) for i in range(2)]
            fleet = m["F"].Fleet(reps, config=m["F"].RouterConfig())
            fleet.run(_reqs(m, "shared_prefix", 8, prompt_len=32,
                            prefix_len=24, n_templates=2, max_new_tokens=2,
                            rate_rps=4.0))
            out.append(fleet.router.stats["prefix_matched"])
    assert out[:2] == out[2:] and out[0] == 0 < out[1]


def test_router_load_term_misses_pending_pinned():
    """A reference behaviour the port copies (ROADMAP §C.2): the router's
    load term reads each replica's queue_depth, which counts requests a
    replica has taken in, not those submitted to it since its last step.
    A replica whose step outlasts the gaps between arrivals takes in
    nothing between them, so its queue reads empty: under the reserve
    scheduler the launcher builds (no KV-occupancy term) the prefix
    policy sends a two-template stream at 100 rps whole to r0 while r0's
    outstanding work grows. Both packages route alike."""
    out = []
    for m in (JAX, PORT):
        reqs = _reqs(m, "shared_prefix", 8, prompt_len=64, prefix_len=48,
                     n_templates=2, max_new_tokens=4, rate_rps=100.0)
        reps = [m["F"].Replica(i, _backend(m),
                               m["sv"].SchedulerConfig(page_size=16))
                for i in range(2)]
        fleet = m["F"].Fleet(reps, config=m["F"].RouterConfig())
        seen, route = [], fleet.router.route

        def spy(req, cands, _route=route, _seen=seen):
            _seen.append([(r.queue_depth, r.outstanding) for r in cands])
            return _route(req, cands)
        fleet.router.route = spy
        res = fleet.run(reqs)
        out.append(({n: [r.rid for r in v]
                     for n, v in res.per_replica.items()}, seen,
                    dict(fleet.router.stats)))
    assert out[1] == out[0]
    part, seen, _ = out[0]
    assert len({int(r.prompt[0]) for r in reqs}) == 2   # two templates
    assert part["r1"] == [] and len(part["r0"]) == 8
    assert all(q == 0 for step in seen for q, _ in step)
    assert seen[-1][0][1] == 7                  # r0's pending, unseen


# ----------------------------------------------------------------------------
# real replicas at smoke size: the port's EngineBackends over one set of
# weights against JAX's
# ----------------------------------------------------------------------------
PS, MAX_NEW, MAX_LEN = 8, 6, 64


def _burst(m, cfg, fleet):
    """8 shared-prefix requests (2 templates, 32-token prompts, 24 shared)
    all arriving at one instant, re-based as the launcher re-bases them
    (launch.serve.rebase_arrivals, 1 s ahead of the replicas' clocks): each
    replica's first step jumps its clock there and takes in what was
    routed to it so far, so the router sees r0's queue when it places the
    first request of the other template (a burst at t 0, behind the wall
    clocks, would place every request on r0)."""
    arr = m["sv"].make_arrivals("shared_prefix", 8, seed=3, n_templates=2,
                                prefix_len=24, prompt_len=32,
                                max_new_tokens=MAX_NEW, rate_rps=1.0)
    reqs = m["sv"].requests_from_arrivals(arr, vocab_size=cfg.vocab_size)
    for r in reqs:
        r.arrival_s = 0.0
    launch.rebase_arrivals(fleet, reqs)
    return reqs


@pytest.fixture(scope="module")
def real_fleets():
    cfg = get_smoke_config("llama3.3-70b")
    jp, _, pp = jax_params(cfg)
    pcfg = port_cfg(cfg)
    out = {}
    for key, m in (("jax", JAX), ("port", PORT)):
        if key == "port":
            fleet = launch.make_fleet(
                pcfg, pp, replicas=2, n_slots=4, max_len=MAX_LEN,
                prefix_cache=True, page_size=PS, router="prefix",
                device="cpu")
            assert all(r.backend.params is pp for r in fleet.replicas)
            # the default scheduler keys the router on the backends' pages
            assert all(r.page_size == PS for r in fleet.replicas)
        else:
            reps = [JF.Replica(i, JSV.EngineBackend(
                cfg, jp, engine=None, n_slots=4, max_len=MAX_LEN,
                prefix_cache=True, page_size=PS),
                JSV.SchedulerConfig(page_size=PS)) for i in range(2)]
            fleet = JF.Fleet(reps, config=JF.RouterConfig(policy="prefix"))
        reqs = _burst(m, cfg, fleet)
        res = fleet.run(reqs)
        out[key] = (fleet, res, reqs)
    return cfg, jp, pp, out


def test_real_replicas_place_and_serve_as_jax(real_fleets):
    cfg, jp, pp, out = real_fleets
    (jf, jres, jreqs), (pf, pres, preqs) = out["jax"], out["port"]

    def part(res):
        return {n: sorted(r.rid for r in recs)
                for n, recs in res.per_replica.items()}
    assert part(pres) == part(jres)
    assert all(part(pres).values())             # both replicas served
    assert pf.router.stats == jf.router.stats
    assert pf.router.stats["prefix_matched"] > 0
    jtok = {r.rid: r.output for r in jres.requests}
    ptok = {r.rid: r.output for r in pres.requests}
    prompts = {r.rid: r.prompt for r in preqs}
    assert all(len(ptok[i]) == MAX_NEW for i in ptok)
    rids = sorted(ptok)
    assert_same_or_near_tie(cfg, jp, pp, [prompts[i] for i in rids],
                            [ptok[i] for i in rids], [jtok[i] for i in rids],
                            MAX_LEN)
    # each replica's own radix tree served the second epoch's prefixes
    hits = [r.sched.metrics.to_stats_dict().get("prefix_hits", 0)
            for r in pf.replicas]
    jhits = [r.sched.metrics.to_stats_dict().get("prefix_hits", 0)
             for r in jf.replicas]
    assert hits == jhits


def test_launcher_fleet_report_keys_are_jax(real_fleets):
    _, _, _, out = real_fleets
    jf, jres, _ = out["jax"]
    ref = json.loads(jres.report(pattern="shared_prefix",
                                 backend="fleet2").to_json())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launch.main([
            "--arch", "llama3.3-70b", "--smoke", "--device", "cpu",
            "--replicas", "2", "--router", "prefix", "--prefix-cache",
            "--page-size", "8", "--pattern", "shared_prefix",
            "--n-templates", "2", "--prefix-len", "24", "--prompt-len", "32",
            "--requests", "8", "--max-new", "4", "--slo"]) == 0
    text = buf.getvalue()
    doc = json.loads(text[text.index("\n{") + 1:])

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) and k != "router"
                else None for k, v in d.items()}
    ref_keys, got_keys = keys(ref), keys(doc)
    # --slo adds each replica's snapshot to its membership entry
    for name in got_keys["membership"]:
        assert "slo" in got_keys["membership"][name]
        got_keys["membership"][name].pop("slo")
    assert got_keys == ref_keys
    assert set(doc["router"]) == set(ref["router"])
    assert doc["backend"] == "fleet2" and doc["n_replicas"] == 2
    assert doc["aggregate"]["n_requests"] == 8
