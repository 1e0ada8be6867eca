"""The port's measured-profile autotuner against the JAX package's, on the
CPU.

`repro_torch.kernels.tuning` (the registry the split-count wrappers
consult), `repro_torch.tune.profiles` / `cache` (the JSON formats, which
must load across the packages), `measure` (the clocks), `sweep` (at the
JAX package's small shapes: on the CPU the wrappers take their plain
versions, so this is the sweep's control flow, not a measurement), the
engine backend's online re-fit (`note_load_timing`) and the launcher's
`--measure` / `--profile-cache` / `--refit`. Card cases (every legal
split of kernels 1, 3, 4 and 5 against the plain versions, a table
installed before capture) are the `*tuned*` tests of test_torch_gpu.py,
which imports no JAX."""
import dataclasses
import json
import math
import types

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.core import cost_model as JCM  # noqa: E402
from repro.core import profiles as JP  # noqa: E402
from repro.core.offline_scheduler import allocate as jax_allocate  # noqa: E402
from repro.core.online_planner import OnlinePlanner as JPlanner  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro.tune import cache as jcache  # noqa: E402
from repro.tune import profiles as jprof  # noqa: E402
from repro.tune import refit as JR  # noqa: E402
from repro.tune import sweep as jsweep  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import cost_model as PCM  # noqa: E402
from repro_torch.core import profiles as PP  # noqa: E402
from repro_torch.core.offline_scheduler import allocate as port_allocate  # noqa: E402
from repro_torch.core.online_planner import OnlinePlanner as PPlanner  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels.decode_attention import multiquery as mq  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import EngineBackend, LimeServer  # noqa: E402
from repro_torch.serving import backend as backend_mod  # noqa: E402
from repro_torch.tune import cache as pcache  # noqa: E402
from repro_torch.tune import measure as pmeasure  # noqa: E402
from repro_torch.tune import profiles as pprof  # noqa: E402
from repro_torch.tune import sweep as psweep  # noqa: E402

H100_SMS = 132


@pytest.fixture(autouse=True)
def _clean_tables():
    """resolve() consults process-wide state in both packages; never leak
    it across tests."""
    saved = tuning.get_tuning_table(), jtuning.get_tuning_table()
    yield
    tuning.set_tuning_table(saved[0])
    jtuning.set_tuning_table(saved[1])


def _same(a, b):
    """Equal as JSON (NaN -> null on both sides, as the files hold it)."""
    return json.dumps(a, sort_keys=True, allow_nan=True) \
        == json.dumps(b, sort_keys=True, allow_nan=True)


# ----------------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 96, 128, 160, 192, 256, 300])
def test_shape_bucket_equals_jax(dh):
    for span in (0, 1, 7, 8, 9, 100, 511, 512, 513, 1019, 1024, 1025, 2048,
                 4097, 131072):
        assert tuning.shape_bucket(span, dh) == jtuning.shape_bucket(span, dh)


def test_rules_give_legal_splits():
    """Every split the wrappers' rules choose is one split_legal admits,
    so a table holding the rule's value is never refused."""
    for B in (1, 2, 4, 8, 16):
        for KV in (1, 5, 8, 16, 40):
            for S in (64, 100, 512, 1000, 1019, 1024, 2048, 4096):
                n = da.split_count(B, KV, S, H100_SMS)
                assert tuning.split_legal(n, S), (B, KV, S, n)
                n = mq.verify_split_count(B, KV, S, H100_SMS)
                assert tuning.split_legal(n, S, 2), (B, KV, S, n)
                for Q in (5, 64, 512):
                    n = mq.split_count(B, Q, 8 * KV, KV, S, H100_SMS)
                    assert tuning.split_legal(n, S), (B, Q, KV, S, n)


def test_split_legal_edges():
    assert [n for n in range(0, 10) if tuning.split_legal(n, 1024)] \
        == [1, 2, 3, 4, 6, 8]
    assert [n for n in range(0, 10) if tuning.split_legal(n, 1024, 2)] \
        == [1, 2, 3, 4, 6, 8]
    # 256 slots: 4 tiles, at most 2 splits of two tiles each
    assert [n for n in range(0, 10) if tuning.split_legal(n, 256, 2)] \
        == [1, 2]
    assert not tuning.split_legal(9, 1 << 16)


def test_resolve_precedence_and_refusal():
    tuning.set_tuning_table(None)
    legal = lambda n: tuning.split_legal(n, 1024)  # noqa: E731
    # no table: the rule's answer, nothing else consulted
    assert tuning.resolve("decode_attention", 1024, 128, "n_split",
                          default=4, legal=legal) == 4
    assert tuning.last_lookup("decode_attention")[2:] == (4, "rule")
    c = pcache.TuneCache()
    c.put_kernel("cpu", "decode_attention", "s1024_d128", {"n_split": 8},
                 speedup=1.2)
    c.put_kernel("cpu", "paged_decode_attention", "s1024_d128",
                 {"page_size": 32, "n_split": 5})
    assert c.install("cpu") == 2
    # the table wins over the rule, in its bucket only
    assert tuning.resolve("decode_attention", 1024, 128, "n_split",
                          default=4, legal=legal) == 8
    assert tuning.last_lookup("decode_attention") == ("s1024_d128", "n_split",
                                                   8, "table")
    assert tuning.resolve("decode_attention", 900, 100, "n_split",
                          default=4, legal=legal) == 8
    assert tuning.resolve("decode_attention", 2048, 128, "n_split",
                          default=4, legal=legal) == 4
    # an explicit override wins over both
    assert tuning.resolve("decode_attention", 1024, 128, "n_split", 2,
                          default=4, legal=legal) == 2
    assert tuning.last_lookup("decode_attention")[3] == "override"
    # a tuned split the kernel cannot take: the rule's stands
    assert tuning.resolve("paged_decode_attention", 1024, 128, "n_split",
                          default=4, legal=legal) == 4
    assert tuning.last_lookup("paged_decode_attention")[3] == "rule"
    # page_size winners are recorded, and DEFAULTS answers without a rule
    assert tuning.resolve("paged_decode_attention", 1024, 128,
                          "page_size") == 32
    assert tuning.resolve("mq_paged_decode_attention", 1024, 128,
                          "page_size") == 64
    # an override the kernel cannot take raises
    with pytest.raises(ValueError, match="n_split=5"):
        tuning.resolve("decode_attention", 1024, 128, "n_split", 5,
                       default=4, legal=legal)
    # an empty cache installs nothing (the table stays as it was)
    tuning.set_tuning_table(None)
    assert pcache.TuneCache().install("cpu") == 0
    assert tuning.get_tuning_table() is None


def test_tuned_split_by_body():
    """The multi-query wrappers' lookup: the mainloop has no knob, the
    verify body takes splits of two tiles, the mma.sync body of one."""
    tuning.set_tuning_table({"mq_decode_attention":
                             {"s1024_d128": {"n_split": 8}},
                             "mq_paged_decode_attention":
                             {"s256_d128": {"n_split": 4}}})
    assert mq.tuned_split("mq_decode_attention", "mainloop", 1024, 128,
                          None, 1) == 1
    with pytest.raises(ValueError):
        mq.tuned_split("mq_decode_attention", "mainloop", 1024, 128, 2, 1)
    assert mq.tuned_split("mq_decode_attention", "verify", 1024, 128,
                          None, 4) == 8
    assert mq.tuned_split("mq_decode_attention", "mma", 1024, 128,
                          None, 4) == 8
    # 4 splits of 256 slots is 4 one-tile splits: the mma body takes them,
    # the verify body does not (the rule's 2 stands)
    assert mq.tuned_split("mq_paged_decode_attention", "mma", 256, 128,
                          None, 2) == 4
    assert mq.tuned_split("mq_paged_decode_attention", "verify", 256, 128,
                          None, 2) == 2


def test_resolve_applies_a_row_only_at_its_geometry():
    """A split swept at B 4 x KV 8 (32 blocks) answers only calls of 32
    blocks (and, paged, of its page size); any other call, or a row that
    records no geometry, keeps the rule's split."""
    tuning.set_tuning_table({
        "decode_attention": {"s1024_d128": {"n_split": 2, "blocks": 32}},
        "paged_decode_attention": {"s1024_d128": {"page_size": 32,
                                                  "n_split": 2,
                                                  "blocks": 32}},
        "mq_decode_attention": {"s1024_d128": {"n_split": 2}}})
    legal = lambda n: tuning.split_legal(n, 1024)  # noqa: E731
    tuning.reset_lookups()
    for blocks, rule, want, source in ((32, 4, 2, "table"),
                                       (8, 8, 8, "rule"),
                                       (136, 1, 1, "rule")):
        assert tuning.resolve("decode_attention", 1024, 128, "n_split",
                              default=rule, legal=legal,
                              at={"blocks": blocks}) == want
        assert tuning.last_lookup("decode_attention") == (
            "s1024_d128", "n_split", want, source)
    assert tuning.lookup_counts() == {
        ("decode_attention", "table", 2, 1024, (("blocks", 32),)): 1,
        ("decode_attention", "rule", 8, 1024, (("blocks", 8),)): 1,
        ("decode_attention", "rule", 1, 1024, (("blocks", 136),)): 1}
    # paged: the row's page size is part of its geometry
    for ps, want in ((32, 2), (64, 4)):
        assert tuning.resolve("paged_decode_attention", 1024, 128,
                              "n_split", default=4, legal=legal,
                              at={"blocks": 32, "page_size": ps}) == want
    # a row without geometry answers no call that states one
    assert tuning.resolve("mq_decode_attention", 1024, 128, "n_split",
                          default=4, legal=legal,
                          at={"blocks": 32}) == 4
    assert mq.tuned_split("mq_decode_attention", "verify", 1024, 128, None,
                          4, {"blocks": 32}) == 4
    tuning.reset_lookups()
    assert tuning.lookup_counts() == {} \
        and tuning.last_lookup("decode_attention") is None


def _fake_times(monkeypatch, times):
    """sweep_kernel's device clock replaced by fixed (median, cov) per
    n_split (the runner's call only records which split it was asked)."""
    seen = []
    runner = psweep.runner

    def spy(kernel, shape=None, device=None):
        return dataclasses.replace(runner(kernel, shape, device),
                                   run=lambda c: seen.append(c["n_split"]))

    def fake(fn, **kw):
        fn()
        return times[seen[-1]]
    monkeypatch.setattr(psweep, "runner", spy)
    monkeypatch.setattr(psweep, "time_device", fake)


@pytest.mark.parametrize("gain,cov,wins", [(1.005, 0.01, False),
                                           (1.05, 0.01, True),
                                           (1.05, 0.08, False)])
def test_sweep_keeps_the_rule_within_the_spread(monkeypatch, gain, cov,
                                                wins):
    """A candidate wins only by more than the larger CoV of its calls and
    the rule's; otherwise the rule's config is the winner."""
    base = 20e-6
    _fake_times(monkeypatch, {1: (base * 2, cov), 2: (base / gain, cov),
                              4: (base, 0.001), 8: (base * 1.2, cov)})
    r = psweep.sweep_kernel("decode_attention", device="cpu")
    assert r.default_cfg == {"n_split": 4}
    assert r.spread == cov
    assert r.best_cfg == ({"n_split": 2} if wins else {"n_split": 4})
    assert r.speedup == (pytest.approx(gain) if wins else 1.0)
    assert r.at == {"blocks": 32}


# ----------------------------------------------------------------------------
# MeasuredProfile
# ----------------------------------------------------------------------------
def _profiles(**kw):
    """The same MeasuredProfile built by both packages."""
    return [m.from_analytic(getattr(P, "AGX_ORIN_32"), **kw)
            for m, P in ((jprof, JP), (pprof, PP))]


def test_measured_profile_json_equals_jax():
    kw = dict(device_kind="NVIDIA H100 80GB HBM3", source="measured",
              flops=7.8e14, load_bw=4.1e10)
    j, p = _profiles(**kw)
    assert _same(p.to_dict(), j.to_dict())
    assert p.to_json() == j.to_json()
    # NaN confidences serialize as null and come back as NaN
    assert math.isnan(p.confidence["mem_bw"])
    assert json.loads(p.to_json())["confidence"]["mem_bw"] is None
    back = pprof.MeasuredProfile.from_dict(json.loads(j.to_json()))
    assert _same(back.to_dict(), j.to_dict())
    jback = jprof.MeasuredProfile.from_dict(json.loads(p.to_json()))
    assert _same(jback.to_dict(), p.to_dict())
    # extras' NaN and measured_at / n_trials survive
    d = dict(p.to_dict(), extras={"decode_tok_s": float("nan"), "x": 1.5},
             measured_at="2026-01-01T00:00:00+00:00", n_trials=7)
    r = pprof.MeasuredProfile.from_dict(
        json.loads(json.dumps(pprof.MeasuredProfile.from_dict(d).to_dict())))
    assert math.isnan(r.extras["decode_tok_s"]) and r.extras["x"] == 1.5
    assert r.n_trials == 7 and r.measured_at == d["measured_at"]
    assert pprof.MEASURED_FIELDS == jprof.MEASURED_FIELDS
    assert pprof.SANITY_FACTOR == jprof.SANITY_FACTOR == 3.0


def test_from_analytic_equals_jax():
    j, p = _profiles(device_kind="cpu")
    assert _same(p.to_dict(), j.to_dict())
    assert p.source == "synthetic"
    assert all(math.isnan(v) for v in p.confidence.values())
    j, p = _profiles(device_kind="cpu", source="cache", mem_bw=1e11)
    assert _same(p.to_dict(), j.to_dict()) and p.confidence["mem_bw"] == 0.0


@pytest.mark.parametrize("ratios", [
    {"flops": 0.2, "mem_bw": 1.0, "load_bw": 3.5},
    {"flops": 2.99, "mem_bw": 0.34, "load_bw": 1.0},
    {"flops": 1 / 3.0, "mem_bw": 3.0, "load_bw": 0.3},
    {"flops": 1e-4, "mem_bw": 1e4, "load_bw": 0.0},
])
def test_check_sane_flags_as_jax(ratios):
    base = PP.AGX_ORIN_32
    over = {f: getattr(base, f) * r for f, r in ratios.items()}
    j, p = _profiles(device_kind="cpu", **over)
    got, want = p.check_sane(PP.AGX_ORIN_32), j.check_sane(JP.AGX_ORIN_32)
    assert got == want
    assert set(got) == {f for f, r in ratios.items()
                        if r > 0 and (r > 3.0 or r < 1 / 3.0)}
    assert p.deviation(PP.AGX_ORIN_32) == j.deviation(JP.AGX_ORIN_32)


# ----------------------------------------------------------------------------
# TuneCache: one file format for both packages
# ----------------------------------------------------------------------------
def _fill(c, m, P):
    c.put_profile(m.from_analytic(P.AGX_ORIN_64, device_kind="cpu",
                                  source="measured", flops=1.25e12))
    c.put_kernel("NVIDIA H100 80GB HBM3", "decode_attention", "s1024_d128",
                 {"n_split": 4}, speedup=1.0, us=14.7)
    c.put_kernel("NVIDIA H100 80GB HBM3", "flash_attention", "s512_d128",
                 {}, speedup=1.0, us=65.2)
    c.put_kernel("NVIDIA H100 80GB HBM3", "paged_decode_attention",
                 "s1024_d128", {"page_size": 32, "n_split": 8},
                 speedup=1.04, us=15.1)
    return c


def _view(c):
    return ({k: p.to_dict() for k, p in c.profiles.items()}, c.kernels,
            c.kernel_table("NVIDIA H100 80GB HBM3"), c.to_dict())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tune_cache_loads_across_packages(tmp_path, writer):
    path = str(tmp_path / "sub" / "tune.json")
    if writer == "jax":
        _fill(jcache.TuneCache(), jprof, JP).save(path)
    else:
        _fill(pcache.TuneCache(), pprof, PP).save(path)
    j, p = jcache.TuneCache.load(path), pcache.TuneCache.load(path)
    assert _same(_view(p), _view(j))
    assert p.kernel_table("NVIDIA H100 80GB HBM3") == {
        "decode_attention": {"s1024_d128": {"n_split": 4}},
        "paged_decode_attention": {"s1024_d128": {"page_size": 32,
                                                  "n_split": 8}}}
    assert p.get_profile("cpu").flops == 1.25e12
    # saved again by the other package: the same bytes
    p.save(str(tmp_path / "p.json"))
    j.save(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert p.install("NVIDIA H100 80GB HBM3") == 2
    assert tuning.get_tuning_table() == p.kernel_table("NVIDIA H100 80GB HBM3")
    assert pcache.VERSION == jcache.VERSION == 1


@pytest.mark.parametrize("content", [None, "{not json", "[]",
                                     '{"version": 0, "kernels": {"cpu": {}}}',
                                     '{"version": 2}'],
                         ids=["missing", "corrupt", "list", "v0", "v2"])
def test_tune_cache_bad_file_is_empty(tmp_path, content):
    path = tmp_path / "tune.json"
    if content is not None:
        path.write_text(content)
    # a JSON list is no cache either (JAX's load raises AttributeError
    # on it; the port's starts empty, as for any unreadable file)
    for m in (pcache,) if content == "[]" else (pcache, jcache):
        c = m.TuneCache.load(str(path))
        assert c.profiles == {} and c.kernels == {}


def test_default_cache_path():
    assert pcache.default_cache_path().endswith(
        "/.cache/repro_torch/tune_cache.json")


def test_put_profile_needs_device_kind():
    with pytest.raises(ValueError):
        pcache.TuneCache().put_profile(
            pprof.from_analytic(PP.AGX_ORIN_32, device_kind=""))


# ----------------------------------------------------------------------------
# the clocks
# ----------------------------------------------------------------------------
def test_timeit_median_counts_and_shape():
    calls = []
    med, cov = pmeasure.timeit_median(lambda: calls.append(1), reps=4,
                                      warmup=2)
    assert len(calls) == 6          # warmup runs execute but aren't timed
    assert med >= 0.0 and cov >= 0.0
    calls.clear()
    pmeasure.time_device(lambda: calls.append(1), reps=3, warmup=1,
                         device="cpu")
    assert len(calls) == 4


def test_measure_stream_bw_on_the_cpu_copies():
    bw = pmeasure.measure_stream_bw(mb=1, reps=2, device="cpu")
    for d in ("h2d", "d2h"):
        v, cov = bw[d]
        assert v > 0 and math.isfinite(v)
        # a CPU "copy" that aliased the buffer would report PB/s
        assert v < 1e15, f"{d} bandwidth {v:.3g} B/s is not a real copy"
    src = torch.arange(3 * 4096, dtype=torch.int32).reshape(3, 4096)
    bw = pmeasure.measure_stream_bw(mb=1, reps=2, device="cpu", src=src)
    assert 0 < bw["h2d"][0] < 1e15


def test_measure_profile_on_the_cpu():
    p = pmeasure.measure_profile("cpu", PP.H100_SXM, reps=2, mb=2, n=128,
                                 device="cpu")
    assert p.device_kind == "cpu" == pmeasure.device_kind("cpu")
    assert p.source == "measured" and p.n_trials == 2
    assert p.mem_bytes == PP.H100_SXM.mem_bytes
    assert p.host_bw == p.load_bw
    for f in pprof.MEASURED_FIELDS:
        assert getattr(p, f) > 0 and f in p.confidence
    vals, conf = pmeasure.measure_fields(PP.H100_SXM, device="cpu")
    assert set(vals) == set(pprof.MEASURED_FIELDS) == set(conf)


def test_measure_decode_loop_on_the_cpu():
    out = pmeasure.measure_decode_loop("gemma3-1b", reps=1, gen=2,
                                       prompt=8, device="cpu")
    assert out["prefill_s"] > 0 and out["insert_bytes"] > 0
    assert out["decode_tok_s"] > 0 and out["gen"] == 2.0


# ----------------------------------------------------------------------------
# the sweep, at the JAX package's small shapes
# ----------------------------------------------------------------------------
def _jax_bucket(kernel, shape):
    return jtuning.shape_bucket(shape["span"], shape["dh"])


def test_sweep_at_jax_shapes(tmp_path):
    assert set(psweep.KERNELS) == set(jsweep.KERNELS)
    assert set(tuning.DEFAULTS) == set(jtuning.DEFAULTS)
    c = pcache.TuneCache()
    res = psweep.run_sweep(cache=c, device_kind="cpu",
                           shapes=jsweep.DEFAULT_SHAPES, reps=1,
                           device="cpu")
    assert [r.kernel for r in res] == list(psweep.KERNELS)
    for r in res:
        shape = jsweep.DEFAULT_SHAPES[r.kernel]
        assert r.bucket == _jax_bucket(r.kernel, shape)
        assert r.default_s > 0 and r.best_s > 0 and r.speedup >= 1.0
        run = psweep.runner(r.kernel, shape, "cpu")
        cands = psweep.legal_candidates(r.kernel, run)
        assert r.default_cfg == run.default in cands
        assert r.best_cfg in cands
        assert set(r.to_dict()) >= {"kernel", "bucket", "speedup"}
        row = c.get_kernel("cpu", r.kernel, r.bucket)
        assert row["_us"] > 0 and {k: v for k, v in row.items()
                                   if not k.startswith("_")} \
            == dict(r.best_cfg, **r.at)
        # a split row records the geometry it was timed at
        full = dict(psweep.DEFAULT_SHAPES[r.kernel], **shape)
        assert r.at == ({"blocks": full["B"] * full["KV"]}
                        if "n_split" in r.default_cfg else {})
    by = {r.kernel: r for r in res}
    # the rule at the H100's SM count: 8 splits of B 2 x KV 2
    assert by["decode_attention"].default_cfg == {"n_split": 8}
    assert by["paged_decode_attention"].default_cfg == {"page_size": 64,
                                                        "n_split": 8}
    for k in ("flash_attention", "rwkv6_scan", "ssm_scan"):
        assert by[k].default_cfg == by[k].best_cfg == {}
    # knob-less rows are recorded but install nothing
    table = c.kernel_table("cpu")
    assert not {"flash_attention", "rwkv6_scan", "ssm_scan"} & set(table)
    path = str(tmp_path / "t.json")
    c.save(path)
    assert jcache.TuneCache.load(path).kernels == c.kernels


def test_sweep_candidates_at_the_main_shapes():
    """The splits each kernel takes at the main path's shapes; the rule's
    (4 at B 4 x KV 8 on 132 SMs) among them."""
    want = [{"n_split": n} for n in (1, 2, 4, 8)]
    for k in ("decode_attention", "mq_decode_attention"):
        r = psweep.runner(k, device="cpu")
        assert r.default == {"n_split": 4}
        assert psweep.legal_candidates(k, r) == want
    for k in ("paged_decode_attention", "mq_paged_decode_attention"):
        r = psweep.runner(k, device="cpu")
        assert r.default == {"page_size": 64, "n_split": 4}
        cands = psweep.legal_candidates(k, r)
        assert len(cands) == 16 and r.default in cands
    # a prefill-sized q_len takes the mainloop: no knob
    r = psweep.runner("mq_decode_attention", {"Q": 128}, "cpu")
    assert r.default == {} and psweep.legal_candidates(
        "mq_decode_attention", r) == [{}]
    # splits the kernel cannot take are filtered out: 256 slots are 4
    # tiles, so 3 or 8 splits would leave one empty
    r = psweep.runner("decode_attention", {"span": 256}, "cpu")
    assert r.default == {"n_split": 4}
    assert psweep.legal_candidates(
        "decode_attention", r, [{"n_split": n} for n in (1, 3, 4, 8)]) \
        == [{"n_split": 1}, {"n_split": 4}]


def test_sweep_main_cli(tmp_path, capsys):
    out = tmp_path / "c.json"
    assert psweep.main(["--kernels", "decode_attention,ssm_scan", "--reps",
                        "1", "--device", "cpu", "--out", str(out)]) == 0
    c = pcache.TuneCache.load(str(out))
    assert set(c.kernels["cpu"]) == {"decode_attention", "ssm_scan"}
    assert "wrote" in capsys.readouterr().out


# ----------------------------------------------------------------------------
# the engine backend's online re-fit
# ----------------------------------------------------------------------------
def _offload_env_and_planner(m):
    """A fleet that must stream weights (E3 at 0.45x memory under
    LLaMA-3.3-70B), as the JAX package's refit tests build it."""
    cfg = m["cfg"]("llama3.3-70b")
    devs = [dataclasses.replace(d, mem_bytes=int(d.mem_bytes * 0.45))
            for d in m["P"].env_E3()]
    env = m["CM"].CostEnv(devs, m["P"].mbps(200),
                          m["CM"].Workload(cfg, mb=1, ctx=512))
    r = m["alloc"](env, cfg.n_layers, n_emp=512)
    assert r.feasible, r.reason
    return env, m["Planner"](env, r.plan, horizon_tokens=2 ** 16)


JAX = dict(cfg=jax_config, P=JP, CM=JCM, alloc=jax_allocate,
           Planner=JPlanner)
PORT = dict(cfg=port_config, P=PP, CM=PCM, alloc=port_allocate,
            Planner=PPlanner)

# (now, bandwidth factor of the planned load_bw) per observation round:
# as planned, then every loader at half its knob, then recovered
DRIFT = [(float(t), 1.0) for t in range(4)] \
    + [(4.0 + 0.5 * t, 0.5) for t in range(10)] \
    + [(10.0 + 0.5 * t, 1.0) for t in range(10)]


def _planner_state(env, pl):
    return ([dataclasses.asdict(d) for d in env.devices],
            [[dataclasses.astuple(s) for s in lad] for lad in pl.ladders],
            [dataclasses.astuple(s) for s in pl.states], pl.rebuilds,
            pl.chunk)


def test_note_load_timing_refits_as_jax(monkeypatch):
    jenv, jpl = _offload_env_and_planner(JAX)
    jrf = JR.OnlineRefit(jenv, jpl)
    penv, ppl = _offload_env_and_planner(PORT)
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, device="cpu")
    be = EngineBackend(cfg, params, engine=None, planner=ppl, refit=True,
                       device="cpu")
    assert be.refit is not None and be.refit.env is penv
    assert _planner_state(penv, ppl) == _planner_state(jenv, jpl)
    clock = types.SimpleNamespace(now=0.0)
    monkeypatch.setattr(backend_mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock.now))
    planned = [d.load_bw for d in jenv.devices]
    for now, factor in DRIFT:
        clock.now = now
        for i, bw in enumerate(planned):
            nbytes, seconds = bw * factor * 0.01, 0.01
            be.note_load_timing(i, nbytes, seconds)
            jrf.observe_fetch(i, nbytes, seconds, now=now)
            jrf.maybe_refit(now)
    assert [dataclasses.astuple(e) for e in be.refit.events] \
        == [dataclasses.astuple(e) for e in jrf.events]
    assert jrf.events and {e.field for e in jrf.events} == {"load_bw"}
    assert _planner_state(penv, ppl) == _planner_state(jenv, jpl)
    assert jpl.rebuilds >= 1
    assert [be.refit.drift(i) for i in range(len(penv.devices))] \
        == [jrf.drift(i) for i in range(len(jenv.devices))]


def test_refit_needs_a_planner():
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, device="cpu")
    be = EngineBackend(cfg, params, engine=None, refit=True, device="cpu")
    assert be.refit is None
    be.note_load_timing(0, 1e9, 0.1)          # a no-op without a planner
    _, pl = _offload_env_and_planner(PORT)
    srv = LimeServer(cfg, params, planner=pl, refit=True, device="cpu")
    assert srv.make_backend().refit is not None
    assert LimeServer(cfg, params, planner=pl,
                      device="cpu").make_backend().refit is None


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------
LAUNCH = ["--arch", "llama3.3-70b", "--smoke", "--layers", "4", "--device",
          "cpu", "--hbm-bytes", "3.2e6", "--adapt", "--refit", "--pattern",
          "bursty", "--requests", "4", "--max-new", "4"]


def test_launcher_measures_then_plans_from_the_cache(tmp_path, capsys):
    path = str(tmp_path / "tune.json")
    first = launcher.run(LAUNCH + ["--measure", "--profile-cache", path])
    doc = json.loads(open(path).read())
    assert list(doc["profiles"]) == ["cpu"] and doc["version"] == 1
    prof = first["measured"]
    assert prof.device_kind == "cpu" and prof.source == "measured"
    for f in pprof.MEASURED_FIELDS:
        assert getattr(first["env"].devices[0], f) == getattr(prof, f) > 0
    assert first["backend"].refit is not None and first["installed"] == 0
    first["engine"].close()
    # a swept table in the cache is installed before the backend is built
    c = pcache.TuneCache.load(path)
    c.put_kernel("cpu", "decode_attention", "s128_d128", {"n_split": 2})
    c.save(path)
    tuning.set_tuning_table(None)
    second = launcher.run(LAUNCH + ["--profile-cache", path])
    second["engine"].close()
    assert second["installed"] == 1
    assert tuning.get_tuning_table() == {
        "decode_attention": {"s128_d128": {"n_split": 2}}}
    assert _same(second["measured"].to_dict(), prof.to_dict())
    assert second["env"].devices[0].flops == prof.flops
    assert [r.output for r in second["done"]] \
        == [r.output for r in first["done"]]
    out = capsys.readouterr()
    assert "req 3:" in out.out


def test_launcher_refit_without_planner_is_ignored():
    out = launcher.run(["--arch", "llama3.3-70b", "--smoke", "--device",
                        "cpu", "--refit", "--pattern", "bursty",
                        "--requests", "2", "--max-new", "2"])
    assert out["backend"].refit is None and out["engine"] is None
    assert launcher.main(["--arch", "llama3.3-70b", "--smoke", "--device",
                          "cpu", "--pattern", "sporadic", "--requests", "1",
                          "--max-new", "2"]) == 0
