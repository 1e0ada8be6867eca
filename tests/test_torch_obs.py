"""The port's observability modules (repro_torch.obs: trace, exporters, log,
slo, critical_path, dashboard) against the JAX package's on identical
inputs: the events of a seeded JAX simulator serve (paged admission, the
sizes of test_obs.py) and synthetic request streams for the SLO engine
(the windows of test_slo.py); then the same serve on the port's own
SimBackend and scheduler, whose events equal the JAX-sourced stream and
read alike through the exporters, critical path and dashboard. Every output is compared for equality: the
modules are framework-free copies, so nothing may drift."""
import dataclasses
import json
import math
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core.cost_model import CostEnv, Workload  # noqa: E402
from repro.core.profiles import env_E3, mbps  # noqa: E402
from repro.obs import critical_path as jcp  # noqa: E402
from repro.obs import dashboard as jdash  # noqa: E402
from repro.obs import exporters as jexp  # noqa: E402
from repro.obs import log as jlog  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import trace as jtr  # noqa: E402
from repro.serving import (ContinuousBatchingScheduler,  # noqa: E402
                           SchedulerConfig, SimBackend, cli_arrivals,
                           requests_from_arrivals)
from repro.serving import metrics as jmetrics  # noqa: E402
from repro_torch.obs import critical_path as pcp  # noqa: E402
from repro_torch.obs import dashboard as pdash  # noqa: E402
from repro_torch.obs import exporters as pexp  # noqa: E402
from repro_torch.obs import log as plog  # noqa: E402
from repro_torch.obs import slo as pslo  # noqa: E402
from repro_torch.obs import trace as ptr  # noqa: E402
from repro_torch.serving import metrics as pmetrics  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def sim_events():
    """A seeded simulator serve under JAX's tracer: bursty arrivals, paged
    admission (steps, stage spans, weight stalls, kv counters, the
    request lifecycle), as test_obs.py serves it."""
    cfg = get_config("llama2-13b")
    env = CostEnv(env_E3(), mbps(200), Workload(cfg, mb=1, ctx=64, n_micro=4))
    arrivals = cli_arrivals("bursty", 6, seed=0, prompt_len=64,
                            max_new_tokens=8, gap_s=4.0, burst_size=4)
    with jtr.tracing() as tr:
        sched = ContinuousBatchingScheduler(
            SimBackend(env, n_slots=4, prompt_tokens=64),
            SchedulerConfig(kv_policy="paged", page_size=16))
        sched.serve(requests_from_arrivals(arrivals))
    evs = tr.events()
    assert any(e[jtr.EVT_NAME] == jtr.STEP for e in evs)
    return evs, tr.dropped


@pytest.fixture(scope="module")
def port_sim_events():
    """The same serve on the port's own SimBackend and scheduler under the
    port's tracer (the simulator substrate is ported): its events must be
    the JAX-sourced stream, ts included."""
    from repro_torch.configs import get_config as port_config
    from repro_torch.core.cost_model import CostEnv as PEnv
    from repro_torch.core.cost_model import Workload as PWork
    from repro_torch.core.profiles import env_E3 as p_env_E3
    from repro_torch.core.profiles import mbps as p_mbps
    from repro_torch import serving as psv
    cfg = port_config("llama2-13b")
    env = PEnv(p_env_E3(), p_mbps(200), PWork(cfg, mb=1, ctx=64, n_micro=4))
    arrivals = psv.cli_arrivals("bursty", 6, seed=0, prompt_len=64,
                                max_new_tokens=8, gap_s=4.0, burst_size=4)
    with ptr.tracing() as tr:
        sched = psv.ContinuousBatchingScheduler(
            psv.SimBackend(env, n_slots=4, prompt_tokens=64),
            psv.SchedulerConfig(kv_policy="paged", page_size=16))
        sched.serve(psv.requests_from_arrivals(arrivals))
    return tr.events(), tr.dropped


def _port_tracer(events, dropped=0):
    tr = ptr.Tracer()
    for e in events:
        tr._push(e)
    tr.dropped = dropped
    return tr


def _jax_tracer(events, dropped=0):
    tr = jtr.Tracer()
    for e in events:
        tr._push(e)
    tr.dropped = dropped
    return tr


def _same(a, b):
    """Equality that reads NaN == NaN (reports and snapshots carry it)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


# -- trace -------------------------------------------------------------------
def test_vocabulary_and_tracks_equal():
    names = [n for n in dir(jtr) if n.isupper()]
    assert names == [n for n in dir(ptr) if n.isupper()]
    assert {n: getattr(jtr, n) for n in names} \
        == {n: getattr(ptr, n) for n in names}
    for fn in ("req_track", "dev_track", "loader_track"):
        assert getattr(jtr, fn)(7) == getattr(ptr, fn)(7)


def _record(mod):
    """The same calls on one package's Tracer: every phase, ring wrap,
    a namespace, the span context manager on a fake clock."""
    t = iter(range(100))
    tr = mod.Tracer(capacity=6, clock=lambda: float(next(t)))
    tr.instant("a", args={"x": 1})
    tr.complete("b", ts=0.5, dur=-1.0, track="kv")
    tr.begin("c", track="dev:0")
    tr.end("c", track="dev:0")
    tr.counter("kv_pages", track="kv", device=3)
    tr.namespace = "r1"
    with tr.span("d", track="sched", args={"k": 2}):
        pass
    tr.instant("e", ts=9.0)
    return tr.events(), tr.dropped, tr.emitted, len(tr)


def test_tracer_semantics_equal():
    assert _record(jtr) == _record(ptr)
    with jtr.tracing() as a, ptr.tracing() as b:
        assert jtr.get_tracer() is a and ptr.get_tracer() is b
    assert jtr.get_tracer() is None and ptr.get_tracer() is None
    with pytest.raises(ValueError):
        ptr.Tracer(capacity=0)


# -- exporters ---------------------------------------------------------------
def test_to_chrome_equal(sim_events):
    evs, dropped = sim_events
    doc = pexp.to_chrome(_port_tracer(evs, dropped))
    assert doc == jexp.to_chrome(_jax_tracer(evs, dropped))
    assert pexp.validate_chrome(doc) == [] == jexp.validate_chrome(doc)
    # namespaced (fleet-style) tracks map to the same replica processes
    ns = [e[:4] + ("r2:" + e[4], e[5]) for e in evs[:50]]
    assert pexp.to_chrome(_port_tracer(ns)) == jexp.to_chrome(_jax_tracer(ns))


@pytest.mark.parametrize("doc", [
    [],
    {"traceEvents": 3},
    {"traceEvents": [{"ph": "Q"}, {"name": "x", "ph": "X", "pid": 0,
                                   "tid": 0, "ts": 1.0, "dur": -1},
                     {"name": "y", "ph": "E", "pid": 0, "tid": 1, "ts": 0},
                     {"name": "z", "ph": "B", "pid": 0, "tid": 2,
                      "ts": "late"}, 7]},
], ids=["not-a-dict", "not-a-list", "broken-events"])
def test_validate_chrome_problems_equal(doc):
    assert pexp.validate_chrome(doc) == jexp.validate_chrome(doc)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jsonl_read_by_the_other_package(sim_events, tmp_path, writer):
    evs, _ = sim_events
    path = str(tmp_path / "t.jsonl")
    if writer == "jax":
        n = jexp.export_jsonl(_jax_tracer(evs), path)
        header, got = pexp.read_jsonl(path)
    else:
        n = pexp.export_jsonl(_port_tracer(evs), path)
        header, got = jexp.read_jsonl(path)
    assert n == len(evs)
    assert header == {"schema": pexp.JSONL_SCHEMA,
                      "version": pexp.JSONL_VERSION}
    assert got == [tuple(json.loads(json.dumps(list(e)))) for e in evs]
    # Tracer.export picks the format by suffix, as JAX's does
    chrome = str(tmp_path / "t.json")
    _port_tracer(evs).export(chrome)
    assert pexp.validate_chrome_file(chrome) == []
    assert json.load(open(chrome)) == jexp.to_chrome(_jax_tracer(evs))


# -- critical path -----------------------------------------------------------
def test_critical_path_reports_equal(sim_events, tmp_path):
    evs, _ = sim_events
    # two namespaces: the serve as it is and as replica r1
    both = list(evs) + [e[:4] + ("r1:" + e[4], e[5]) for e in evs]
    jall, pall = jcp.analyze_all(both), pcp.analyze_all(both)
    assert list(jall) == list(pall) == [None, "r1"]
    for ns in jall:
        j, p = jall[ns].to_dict(), pall[ns].to_dict()
        assert p == j
        assert p["n_rounds"] > 0 and len(p["requests"]) == 6
        assert pall[ns].conservation_error() < 1e-9
        assert pall[ns].render(max_requests=4) \
            == jall[ns].render(max_requests=4)
    path = str(tmp_path / "t.jsonl")
    pexp.export_jsonl(_port_tracer(evs), path)
    assert pcp.analyze_jsonl(path).to_dict() \
        == jcp.analyze_jsonl(path).to_dict()
    assert pcp.split_track("r2:dev:3") == jcp.split_track("r2:dev:3")


# -- SLO engine --------------------------------------------------------------
def _stream(seed):
    """Synthetic finished requests and rejections on a 1 s grid: a calm
    minute, a minute of slow requests and rejections (breach), then calm
    again (recovery)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(180):
        t = float(i)
        bad = 60 <= i < 120
        if bad and rng.random() < 0.3:
            out.append(("reject", t, None))
            continue
        ttft = float(rng.uniform(2.0, 12.0) if bad else rng.uniform(0.1, 1))
        gen = int(rng.integers(1, 6))
        tpot = float(rng.uniform(0.5, 3.0) if bad else rng.uniform(0.01, 0.2))
        req = types.SimpleNamespace(arrival_s=t - ttft - gen * tpot,
                                    first_token_s=t - gen * tpot,
                                    finish_s=t, generated=gen)
        out.append(("finish", t, req))
    return out


def _judge(mod, trmod, stream, targets):
    eng = mod.SLOEngine(targets(mod), sketch_capacity=64, seed=3)
    snaps = []
    with trmod.tracing() as tr:
        for i, (kind, t, req) in enumerate(stream):
            if kind == "reject":
                eng.observe_reject(types.SimpleNamespace(), t)
            else:
                eng.observe_request(req, t)
            if i % 15 == 0:
                snaps.append(eng.snapshot(t))
                snaps.append(eng.burn_rates(eng.targets[0].name, t))
    return snaps, tr.events(), eng.health, eng.pressure(), eng.breaching


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("targets", [
    lambda mod: mod.default_targets(ttft_p99_s=4.0, tpot_p50_s=0.5,
                                    latency_p95_s=6.0, fast_window_s=10.0,
                                    slow_window_s=30.0, burn_threshold=2.0),
    lambda mod: [mod.SLOTarget("lat_p50", "latency", threshold_s=1.0,
                               target=0.5, fast_window_s=10.0,
                               slow_window_s=30.0, burn_threshold=1.5,
                               recovery_frac=0.5)],
], ids=["defaults", "latency-p50"])
def test_slo_engine_equal(seed, targets):
    stream = _stream(seed)
    got = _judge(pslo, ptr, stream, targets)
    ref = _judge(jslo, jtr, stream, targets)
    assert _same(got, ref)
    names = [e[0] for e in got[1]]
    assert ptr.SLO_BREACH in names and ptr.SLO_RECOVER in names
    assert names.index(ptr.SLO_BREACH) < names.index(ptr.SLO_RECOVER)


def test_slo_target_checks_equal():
    for kw in (dict(metric="nope"), dict(metric="ttft", target=1.0),
               dict(metric="ttft", fast_window_s=9.0, slow_window_s=1.0)):
        with pytest.raises(ValueError) as a:
            jslo.SLOTarget("x", **kw)
        with pytest.raises(ValueError) as b:
            pslo.SLOTarget("x", **kw)
        assert str(a.value) == str(b.value)


# -- dashboard ---------------------------------------------------------------
def _dash(mod, slomod, trmod, events, stream):
    slo = slomod.SLOEngine(slomod.default_targets(
        ttft_p99_s=4.0, fast_window_s=10.0, slow_window_s=30.0), seed=1)
    for kind, t, req in stream[:90]:
        if kind == "finish":
            slo.observe_request(req, t)
        else:
            slo.observe_reject(types.SimpleNamespace(), t)
    sched = types.SimpleNamespace(queue_depth=2, in_flight=4, outstanding=9)
    tr = trmod.Tracer()
    for e in events:
        tr._push(e)
    d = mod.Dashboard(slo=slo, sched=sched, tracer=tr, interval_s=5.0)
    ticks = [d.tick(t) for t in (90.0, 92.0, 95.0, 95.5)]
    return ticks, d.snapshot(96.0), d.render(97.0), d.renders


def test_dashboard_equal(sim_events, tmp_path, capsys):
    evs, _ = sim_events
    stream = _stream(0)
    got = _dash(pdash, pslo, ptr, evs, stream)
    assert _same(got, _dash(jdash, jslo, jtr, evs, stream))
    assert got[0][0] is not None and got[0][1] is None and got[3] == 2
    assert "critical path" in got[2] and "load: queue 2" in got[2]
    assert pdash.Dashboard().render(1.0) == jdash.Dashboard().render(1.0)
    path = str(tmp_path / "t.jsonl")
    pexp.export_jsonl(_port_tracer(evs), path)
    assert pdash.render_offline(path, max_requests=3) \
        == jdash.render_offline(path, max_requests=3)
    empty = str(tmp_path / "empty.jsonl")
    pexp.export_jsonl(ptr.Tracer(), empty)
    assert pdash.render_offline(empty) == jdash.render_offline(empty)
    outs = []
    for main in (pdash.main, jdash.main):
        for argv in ([path, "--json"], [path, "--max-requests", "2"]):
            assert main(argv) == 0
            outs.append(capsys.readouterr().out)
    assert outs[:2] == outs[2:]


# -- log and report_from_dict ------------------------------------------------
def test_structured_log_format_equal():
    for msg, kw in (("admitted", {"rid": 3, "pages": 7}), ("plain", {})):
        assert plog.StructuredLogger._fmt(msg, kw) \
            == jlog.StructuredLogger._fmt(msg, kw)
    lg = plog.get_logger("repro_torch.test")
    assert lg is plog.get_logger("repro_torch.test")
    assert not lg.is_enabled_for("info")     # quiet under pytest


def _report_dict():
    r = pmetrics.summarize([], pattern="bursty", backend="engine")
    return r.to_dict()


@pytest.mark.parametrize("edit", [
    lambda d: d,
    lambda d: {**d, "schema_version": 1, "retired_field": 5},
    lambda d: {k: v for k, v in d.items()
               if k not in ("ttft_p99_s", "span_s", "schema_version")},
    lambda d: {"pattern": "old", "n_requests": 3, "ms_per_token": None},
], ids=["current", "old-schema-unknown-field", "missing-fields", "sparse"])
def test_report_from_dict_equal(edit):
    d = edit(_report_dict())
    warned = {"jax": [], "port": []}
    ref = jmetrics.report_from_dict(
        dict(d), source="base.json",
        warn=lambda msg, **kw: warned["jax"].append((msg, kw)))
    got = pmetrics.report_from_dict(
        dict(d), source="base.json",
        warn=lambda msg, **kw: warned["port"].append((msg, kw)))
    assert _same(dataclasses.asdict(got), dataclasses.asdict(ref))
    assert warned["port"] == warned["jax"]
    assert bool(warned["port"]) == (d != _report_dict())


# -- the same modules on the port's own simulator serve ----------------------
def test_port_sim_serve_events_equal_jax_sourced(sim_events, port_sim_events):
    assert port_sim_events == sim_events
    names = {e[ptr.EVT_NAME] for e in port_sim_events[0]}
    assert {ptr.STEP, ptr.STAGE_COMPUTE, ptr.ACT_HOP, ptr.REQ_SPAN} <= names


def test_to_chrome_equal_on_port_sim_events(port_sim_events):
    evs, dropped = port_sim_events
    doc = pexp.to_chrome(_port_tracer(evs, dropped))
    assert doc == jexp.to_chrome(_jax_tracer(evs, dropped))
    assert pexp.validate_chrome(doc) == []


def test_critical_path_equal_on_port_sim_events(port_sim_events):
    evs, _ = port_sim_events
    p, j = pcp.analyze(evs), jcp.analyze(evs)
    assert p.to_dict() == j.to_dict()
    assert p.to_dict()["n_rounds"] > 0 and len(p.to_dict()["requests"]) == 6
    assert p.render(max_requests=4) == j.render(max_requests=4)


def test_dashboard_equal_on_port_sim_events(port_sim_events):
    evs, _ = port_sim_events
    stream = _stream(1)
    assert _same(_dash(pdash, pslo, ptr, evs, stream),
                 _dash(jdash, jslo, jtr, evs, stream))
