"""The port's flight recorder on its serving path, on the CPU.

The same requests are served by the JAX package's single-device
EngineBackend(engine=None) and the port's, each under its own tracer, on
the same converted LLaMA-3.3-70B smoke weights: dense (uneven prompts, two
bursts), paged with the radix prefix cache (shared-prefix traffic, two
epochs, paged admission) and n-gram speculation. Their event streams are
equal in name, phase, track and args, in order (ts and dur are each
package's own wall clock). Then the port alone: the engine path's
engine.* instants per pass (prefill rounds, resident drafts, verify
passes, decode passes), the launcher with --trace --slo --dash-interval
in-process on the adaptive engine (an engine.retier while requests are
live, kv.grow), LimeServer's trace option, and a serve with no tracer,
which records nothing and emits the traced serve's tokens. And the
schedulers alone, on test_torch_admission.py's stub backend (a virtual
clock) under every admission case and a shedding queue, each with an SLO
engine attached: the same events, timestamps included (the preempt,
resume, reclaim and reject instants the real backends never reach), the
same SLO snapshots and the same pressure handed to the backend."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import (assert_same_or_near_tie,  # noqa: E402
                           jax_params, port_cfg)
from _torch_threads import one_thread  # noqa: E402,F401
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import trace as jtr  # noqa: E402
from repro.serving import ContinuousBatchingScheduler as JSched  # noqa: E402
from repro.serving import EngineBackend as JBackend  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SchedulerConfig as JSchedCfg  # noqa: E402
from repro.serving.scheduler import Request as JSchedRequest  # noqa: E402
from repro.specdec import SpecConfig as JSpec  # noqa: E402
from repro_torch.core.engine import InterleavedEngine, plan_for  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.obs import exporters as pexp  # noqa: E402
from repro_torch.obs import slo as pslo  # noqa: E402
from repro_torch.obs import trace as ptr  # noqa: E402
from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 EngineBackend, LimeServer, Request,
                                 SchedulerConfig, make_arrivals,
                                 requests_from_arrivals)
from repro_torch.specdec import SpecConfig  # noqa: E402
from test_torch_admission import CASES, StubBackend  # noqa: E402
from test_torch_admission import _stream as arrivals  # noqa: E402

MAX_NEW = 6
PS = 8


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("llama3.3-70b")
    jp, _, pp = jax_params(cfg)
    return cfg, jp, pp


def _dense_reqs(cfg):
    """Uneven prompts (left padding) in two bursts: 4 at t = 0, 2 at
    t = 100 s (the backend's clock skips the idle gap)."""
    rng = np.random.default_rng(4)
    lens, times = (8, 5, 8, 3, 6, 6), (0, 0, 0, 0, 100, 100)
    return [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), t)
            for n, t in zip(lens, times)]


def _prefix_reqs(cfg):
    """8 shared-prefix prompts of one template (32 tokens, 24 shared), all
    at t = 0: two epochs of 4, the second hitting the first's pages."""
    arr = make_arrivals("shared_prefix", 8, n_templates=1, prefix_len=24,
                        prompt_len=32, max_new_tokens=MAX_NEW, seed=0)
    arr = [dataclasses.replace(a, time_s=0.0) for a in arr]
    return [(r.prompt, 0.0) for r in requests_from_arrivals(
        arr, vocab_size=cfg.vocab_size, seed=0)]


def _ngram_reqs(cfg):
    """Prompts that repeat a phrase, so the n-gram lookup drafts."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(4):
        phrase = rng.integers(1, cfg.vocab_size, 4).astype(np.int32)
        out.append((np.tile(phrase, 3), 0.0))
    return out


SERVES = {
    # name: (requests, backend kwargs, paged admission)
    "dense": (_dense_reqs, dict(max_len=32), False),
    "paged-prefix": (_prefix_reqs, dict(max_len=64, prefix_cache=True,
                                        prefill_chunk_tokens=8,
                                        page_size=PS), True),
    "ngram": (_ngram_reqs, dict(max_len=48), False),
}


def _serve(pkg, name, model):
    """One package's serve of SERVES[name] under a fresh tracer of its own;
    returns (tokens by rid, events, requests by rid, backend)."""
    cfg, jp, pp = model
    make, kw, paged = SERVES[name]
    reqs = make(cfg)
    if pkg == "jax":
        tr_mod, Sched, SCfg, Req = jtr, JSched, JSchedCfg, JRequest
        spec = JSpec(k=3, draft="ngram") if name == "ngram" else None
        be = JBackend(cfg, jp, n_slots=4, spec=spec, **kw)
    else:
        tr_mod, Sched, SCfg, Req = ptr, ContinuousBatchingScheduler, \
            SchedulerConfig, Request
        spec = SpecConfig(k=3, draft="ngram") if name == "ngram" else None
        be = EngineBackend(port_cfg(cfg), pp, n_slots=4, spec=spec,
                           device="cpu", **kw)
    scfg = SCfg(kv_policy="paged", page_size=PS) if paged else SCfg()
    with tr_mod.tracing() as tr:
        sched = Sched(be, scfg)
        done = sched.serve([Req(i, p, MAX_NEW, arrival_s=t)
                            for i, (p, t) in enumerate(reqs)])
    done = sorted(done, key=lambda r: r.rid)
    return [r.output for r in done], tr.events(), done, be


@pytest.fixture(scope="module")
def served(model):
    return {(pkg, name): _serve(pkg, name, model)
            for name in SERVES for pkg in ("jax", "port")}


def _stream(events):
    return [(e[ptr.EVT_NAME], e[ptr.EVT_PH], e[ptr.EVT_TRACK], e[ptr.EVT_ARGS])
            for e in events]


def _lane(events, rid):
    return {e[ptr.EVT_NAME]: e for e in events
            if e[ptr.EVT_TRACK] == ptr.req_track(rid)}


@pytest.mark.parametrize("name", list(SERVES))
def test_event_stream_equals_jax(name, served, model):
    jtoks, jevs, _, _ = served["jax", name]
    ptoks, pevs, done, be = served["port", name]
    # tokens: equal, or a first divergence at a near tie (_torch_parity)
    cfg, jp, pp = model
    reqs = SERVES[name][0](cfg)
    for (p, t), a, b in zip(reqs, ptoks, jtoks):
        width = max(len(q) for q, s in reqs if s == t)
        assert_same_or_near_tie(cfg, jp, pp, [p], [a], [b],
                                SERVES[name][1]["max_len"], width)
    assert _stream(pevs) == _stream(jevs)
    names = {e[ptr.EVT_NAME] for e in pevs}
    want = {ptr.REQ_ARRIVE, ptr.REQ_ADMIT, ptr.REQ_QUEUE, ptr.REQ_PREFILL,
            ptr.REQ_DECODE, ptr.REQ_SPAN, ptr.REQ_FINISH, ptr.ENGINE_PREFILL,
            "active_requests"}
    want |= {"paged-prefix": {ptr.PREFIX_HIT, ptr.PREFIX_INSERT, "kv_pages"},
             "ngram": {ptr.ENGINE_VERIFY},
             "dense": {ptr.ENGINE_DECODE}}[name]
    assert want <= names
    # the lifecycle in order on the backend's clock, the span = latency
    for r in done:
        lane = _lane(pevs, r.rid)
        ts = [lane[n][ptr.EVT_TS] for n in (ptr.REQ_ARRIVE, ptr.REQ_ADMIT)] \
            + [lane[ptr.REQ_PREFILL][ptr.EVT_TS]
               + lane[ptr.REQ_PREFILL][ptr.EVT_DUR],
               lane[ptr.REQ_DECODE][ptr.EVT_TS], lane[ptr.REQ_FINISH][ptr.EVT_TS]]
        assert ts == sorted(ts), (r.rid, ts)
        assert lane[ptr.REQ_SPAN][ptr.EVT_DUR] == pytest.approx(r.latency_s)
    # one pipeline span per backend round (and one per prefill)
    spans = [e for e in pevs if e[ptr.EVT_TRACK] == ptr.TRACK_PIPELINE]
    assert all(e[ptr.EVT_PH] == "X" and e[ptr.EVT_DUR] >= 0 for e in spans)
    assert sum(e[ptr.EVT_NAME] in (ptr.ENGINE_DECODE, ptr.ENGINE_VERIFY)
               for e in spans) == len(be.rounds)
    epochs = 1 if name == "ngram" else 2         # batches of 4 slots
    assert sum(e[ptr.EVT_NAME] == ptr.ENGINE_PREFILL for e in spans) == epochs
    assert pexp.validate_chrome(pexp.to_chrome(_tracer(pevs))) == []


def _tracer(events):
    tr = ptr.Tracer()
    for e in events:
        tr._push(e)
    return tr


def test_untraced_serve_records_nothing(model, served, monkeypatch):
    """No tracer installed: no site records (a push anywhere would raise),
    the scheduler holds None, and the tokens are the traced serve's."""
    def boom(self, evt):
        raise AssertionError(f"recorded {evt} with tracing off")
    monkeypatch.setattr(ptr.Tracer, "_push", boom)
    assert ptr.get_tracer() is None
    for name in ("dense", "paged-prefix"):
        cfg, _, pp = model
        make, kw, paged = SERVES[name]
        be = EngineBackend(port_cfg(cfg), pp, n_slots=4, device="cpu", **kw)
        sched = ContinuousBatchingScheduler(
            be, SchedulerConfig(kv_policy="paged", page_size=PS) if paged
            else SchedulerConfig())
        assert sched._tr is None
        done = sched.serve([Request(i, p, MAX_NEW, arrival_s=t)
                            for i, (p, t) in enumerate(make(cfg))])
        assert [r.output for r in sorted(done, key=lambda r: r.rid)] \
            == served["port", name][0]


def test_lime_server_trace_option(model, tmp_path):
    cfg, _, pp = model
    path = tmp_path / "serve.jsonl"
    srv = LimeServer(port_cfg(cfg), pp, max_len=32, pattern="bursty",
                     device="cpu", trace=str(path))
    for p, _ in _dense_reqs(cfg)[:4]:
        srv.queue.submit(p, 3)
    done = srv.serve_all()
    assert ptr.get_tracer() is None              # uninstalled after
    header, evs = pexp.read_jsonl(str(path))
    assert header["schema"] == pexp.JSONL_SCHEMA
    spans = [e for e in evs if e[ptr.EVT_NAME] == ptr.REQ_SPAN]
    assert sorted(e[ptr.EVT_TRACK] for e in spans) \
        == sorted(ptr.req_track(r.rid) for r in done)
    # a tracer the caller installed wins: nothing is exported then
    other = tmp_path / "other.jsonl"
    srv.trace = str(other)
    srv.queue.submit(_dense_reqs(cfg)[0][0], 2)
    with ptr.tracing() as tr:
        srv.serve_all()
    assert not other.exists() and len(tr) > 0


def test_engine_path_instants_per_pass(model):
    """The engine with resident self-speculation and chunked prefill
    rounds: one engine.prefill instant per round, k engine.draft instants
    and one engine.verify instant per speculative round, one
    engine.decode instant per plain round; each round one pipeline span
    (the drafts' span inside the verify span)."""
    cfg, _, pp = model
    pcfg = dataclasses.replace(port_cfg(cfg), n_layers=4)
    from repro_torch.models import model as M
    params = M.init_params(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    plan = plan_for(pcfg, 1, hbm_frac_for_weights=launch.HBM_FRAC,
                    hbm_bytes=4.6e6)
    eng = InterleavedEngine(pcfg, plan, mb=4, max_len=32, device="cpu")
    assert plan.k_off > 0 and eng.k_res_cap > 0
    k, chunk, prompt = 3, 4, 8
    be = EngineBackend(pcfg, params, engine=eng, max_len=32,
                       spec=SpecConfig(k=k, draft="resident", adapt_k=False),
                       prefill_chunk_tokens=chunk, device="cpu")
    rng = np.random.default_rng(1)
    with ptr.tracing() as tr:
        sched = ContinuousBatchingScheduler(be, SchedulerConfig())
        done = sched.serve([Request(i, rng.integers(1, pcfg.vocab_size,
                                                    prompt), 12)
                            for i in range(4)])
    eng.close()
    assert all(r.done for r in done)
    evs = tr.events()

    def count(name, track):
        return sum(e[ptr.EVT_NAME] == name and e[ptr.EVT_TRACK] == track
                   for e in evs)
    spec_rounds = [kk for kk, _ in be.rounds if kk]
    plain_rounds = len(be.rounds) - len(spec_rounds)
    assert spec_rounds and all(kk == k for kk in spec_rounds)
    assert count(ptr.ENGINE_PREFILL, ptr.TRACK_ENGINE) == prompt // chunk
    assert count(ptr.ENGINE_VERIFY, ptr.TRACK_ENGINE) == len(spec_rounds)
    assert count(ptr.ENGINE_DRAFT, ptr.TRACK_ENGINE) == k * len(spec_rounds)
    assert count(ptr.ENGINE_DECODE, ptr.TRACK_ENGINE) == plain_rounds
    assert [e[ptr.EVT_ARGS] for e in evs
            if e[ptr.EVT_NAME] == ptr.ENGINE_DECODE
            and e[ptr.EVT_TRACK] == ptr.TRACK_ENGINE] \
        == [{"live": 4}] * plain_rounds
    assert count(ptr.ENGINE_PREFILL, ptr.TRACK_PIPELINE) == 1
    assert count(ptr.ENGINE_VERIFY, ptr.TRACK_PIPELINE) == len(spec_rounds)
    assert count(ptr.ENGINE_DRAFT, ptr.TRACK_PIPELINE) == len(spec_rounds)
    assert count(ptr.ENGINE_DECODE, ptr.TRACK_PIPELINE) == plain_rounds
    verify = [e for e in evs if e[ptr.EVT_NAME] == ptr.ENGINE_VERIFY
              and e[ptr.EVT_TRACK] == ptr.TRACK_PIPELINE]
    drafts = [e for e in evs if e[ptr.EVT_NAME] == ptr.ENGINE_DRAFT
              and e[ptr.EVT_TRACK] == ptr.TRACK_PIPELINE]
    for v, d in zip(verify, drafts):
        assert v[ptr.EVT_TS] <= d[ptr.EVT_TS] \
            and d[ptr.EVT_TS] + d[ptr.EVT_DUR] <= v[ptr.EVT_TS] + v[ptr.EVT_DUR]
        assert v[ptr.EVT_ARGS]["k"] == k and d[ptr.EVT_ARGS] == {"k": k}


def test_launcher_traced_with_slo_and_dashboard(tmp_path, capsys):
    """launch.serve --trace --slo --dash-interval in-process on the
    adaptive engine (test_torch_adapt.py's sporadic serve, whose ladder
    retiers once): dashboard frames on stdout, the report's "slo" section,
    a Chrome trace that validates, with an engine.retier while a request
    is live and the pool's kv.grow."""
    path = tmp_path / "trace.json"
    assert launch.main([
        "--arch", "llama3.3-70b", "--smoke", "--layers", "4", "--device",
        "cpu", "--requests", "4", "--max-new", "12", "--max-len", "32",
        "--prompt-len", "8", "--page-size", "8", "--hbm-bytes", "3.2e6",
        "--adapt", "--retier-headroom", "1", "--pattern", "sporadic",
        "--trace", str(path), "--slo", "--dash-interval", "0.05"]) == 0
    out = capsys.readouterr().out
    assert out.count("== slo dashboard @ t=") >= 2
    assert "load: queue" in out and "ttft_p99" in out
    rep = json.loads(out[out.index("{"):])
    assert rep["retier_events"] == 1
    slo = rep["slo"]
    assert set(slo["targets"]) == {"ttft_p99", "tpot_p50", "goodput_p95",
                                   "reject_rate"}
    assert slo["targets"]["ttft_p99"]["observed"] == 4
    assert pexp.validate_chrome_file(str(path)) == []
    doc = json.load(open(path))
    names = {}
    for e in doc["traceEvents"]:
        names.setdefault(e["name"], []).append(e)
    assert {ptr.ENGINE_RETIER, ptr.KV_GROW, ptr.ENGINE_PREFILL,
            ptr.ENGINE_DECODE} <= set(names)
    retier = names[ptr.ENGINE_RETIER][0]
    assert retier["args"]["direction"] == "demote"
    live = [(a["ts"], f["ts"]) for a, f in zip(
        sorted(names[ptr.REQ_ADMIT], key=lambda e: e["tid"]),
        sorted(names[ptr.REQ_FINISH], key=lambda e: e["tid"]))]
    assert any(a <= retier["ts"] <= f for a, f in live)


HOST_READS = (("Tensor", "item"), ("Tensor", "tolist"), ("Tensor", "cpu"),
              ("Tensor", "numpy"), ("cuda", "synchronize"))


def _counted(monkeypatch):
    """Count every device read a serve makes: Tensor.item / tolist / cpu /
    numpy and torch.cuda.synchronize."""
    counts = dict.fromkeys(HOST_READS, 0)
    for owner, name in HOST_READS:
        obj = torch.Tensor if owner == "Tensor" else torch.cuda
        fn = getattr(obj, name)

        def wrapped(*a, _fn=fn, _key=(owner, name), **kw):
            counts[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(obj, name, wrapped)
    return counts


@pytest.mark.parametrize("path", ["dense", "engine"])
def test_tracing_adds_no_host_read(path, model, monkeypatch):
    """The same serve untraced and traced makes the same device reads
    (item, tolist, cpu, numpy, synchronize): a span closes on the step's
    own host copy, an instant's args are host values."""
    cfg, _, pp = model
    pcfg = port_cfg(cfg)
    if path == "engine":
        pcfg = dataclasses.replace(pcfg, n_layers=4)
        from repro_torch.models import model as M
        pp = M.init_params(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
        plan = plan_for(pcfg, 1, hbm_frac_for_weights=launch.HBM_FRAC,
                        hbm_bytes=4.6e6)
    reqs = _dense_reqs(cfg)[:4]
    runs = []
    for traced in (False, True):
        eng = InterleavedEngine(pcfg, plan, mb=4, max_len=32,
                                device="cpu") if path == "engine" else None
        be = EngineBackend(pcfg, pp, engine=eng, n_slots=4, max_len=32,
                           prefill_chunk_tokens=4, device="cpu",
                           spec=SpecConfig(k=3, draft="resident",
                                           adapt_k=False) if eng else None)
        with monkeypatch.context() as m:
            counts = _counted(m)
            prev = ptr.set_tracer(ptr.Tracer() if traced else None)
            try:
                sched = ContinuousBatchingScheduler(be, SchedulerConfig())
                done = sched.serve([Request(i, p, MAX_NEW) for i, (p, _)
                                    in enumerate(reqs)])
            finally:
                tr = ptr.set_tracer(prev)
        if eng is not None:
            eng.close()
        runs.append((counts, sorted((r.rid, r.output) for r in done),
                     len(tr) if tr is not None else 0))
    assert runs[0][:2] == runs[1][:2]
    assert runs[0][0][("Tensor", "tolist")] > 0 and runs[1][2] > 0


class _SLOStub(StubBackend):
    """The admission tests' stub, recording the SLO pressure it is handed."""

    def note_slo_pressure(self, pressure):
        self.calls.append(("slo", pressure))


@pytest.mark.parametrize("case", CASES + [
    ("reserve", "spill", False, 0, (0, 0), 160, None, 2)],
    ids=[f"{c[0]}-{c[1]}-{'join' if c[2] else 'epoch'}-k{c[3]}"
         f"-grant{c[4][0]}-b{c[5]}-h{c[6]}" for c in CASES] + ["queue-2"])
def test_scheduler_events_and_slo_equal_jax(case):
    policy, mode, join, k, reclaim, budget, host = case[:7]
    max_queue = case[7] if len(case) > 7 else 4096
    stream = arrivals(0, 14)
    runs = []
    for tr_mod, slo_mod, Sched, SCfg, Req in (
            (jtr, jslo, JSched, JSchedCfg, JSchedRequest),
            (ptr, pslo, ContinuousBatchingScheduler, SchedulerConfig,
             Request)):
        be = _SLOStub(n_slots=4, join=join, budget=budget, spec_k=k,
                      headroom=reclaim[0], grant=reclaim[1], max_len=96)
        slo = slo_mod.SLOEngine(slo_mod.default_targets(
            ttft_p99_s=0.2, tpot_p50_s=0.02, latency_p95_s=0.6,
            fast_window_s=0.3, slow_window_s=1.0, burn_threshold=2.0))
        with tr_mod.tracing() as tr:
            sched = Sched(be, SCfg(kv_policy=policy, page_size=8,
                                   preempt=mode, host_kv_budget_tokens=host,
                                   max_queue=max_queue, hist_capacity=16))
            sched.attach_slo(slo)
            loads = []
            sched.begin([Req(i, None, new, arrival_s=t, prompt_len=p)
                         for i, (t, p, new) in enumerate(stream)])
            while sched.step():
                loads.append((sched.queue_depth, sched.in_flight,
                              sched.outstanding))
            done = sched.finish_run()
        runs.append((tr.events(), slo.snapshot(be.now()), be.calls, loads,
                     sched.metrics.hist_capacity,
                     sorted((r.rid, r.rejected) for r in done)))
    assert runs[1] == runs[0]
    evs = runs[1][0]
    names = {e[ptr.EVT_NAME] for e in evs}
    assert ptr.REQ_SPAN in names
    assert sum(c[0] == "slo" for c in runs[1][2]) == len(stream)
    if max_queue == 2:
        assert ptr.REQ_REJECT in names
    if policy == "paged" and not k and not reclaim[0]:
        assert ptr.REQ_PREEMPT in names and ptr.REQ_RESUME in names
    if reclaim[0]:
        assert ptr.RETIER_RECLAIM in names and ptr.KV_GROW in names


def test_traced_entry_points_raise_without_a_card(model, monkeypatch,
                                                  tmp_path):
    """No fallback: with no card visible the launcher's tracing flags and
    LimeServer(trace=) raise as the untraced entry points do, before any
    trace is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "t.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "gemma3-1b", "--smoke", "--trace", str(path),
                     "--slo", "--dash-interval", "0.5"])
    cfg, _, pp = model
    with pytest.raises(RuntimeError, match="CUDA"):
        LimeServer(port_cfg(cfg), pp, trace=str(path))
    assert not path.exists() and ptr.get_tracer() is None
