"""Resident self-speculation of the port on the CPU: LimeServer ->
scheduler -> EngineBackend(engine, spec=resident) emits the tokens of the
JAX package's single-device, non-speculative serve on the same weights and
prompts (the lossless contract; a first divergence must be a near tie of
the reference, by _torch_parity's rule), with consistent spec counters, a
live retier that changes no token, and the numpy pieces (greedy
acceptance, DepthController) equal to the JAX package's."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import assert_same_or_near_tie, jax_params, port_cfg  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.serving.server import LimeServer as JaxServer  # noqa: E402
from repro.specdec import DepthController as JaxDepth  # noqa: E402
from repro.specdec import greedy_verify as jax_greedy_verify  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.kernels.decode_attention import multiquery as mq  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 LimeServer, SchedulerConfig)
from repro_torch.specdec import (DepthController, SpecConfig,  # noqa: E402
                                 greedy_verify)
from _torch_threads import one_thread  # noqa: E402,F401

MAX_NEW = 6
K = 3


def _cfg(arch, tiny_dense_factory):
    if arch == "tiny":
        return tiny_dense_factory(n_layers=4)
    return dataclasses.replace(get_smoke_config("gemma3-1b"), n_layers=4,
                               window_size=6)


def _prompts(cfg, lens):
    rng = np.random.default_rng(4)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _engine_server(cfg, pp, pattern, max_len, spec):
    eng = PE.InterleavedEngine(port_cfg(cfg), PE.UniformPlan(1, 2, 1, 1),
                               mb=4, max_len=max_len, retier_headroom=1,
                               device="cpu")
    return LimeServer(port_cfg(cfg), pp, engine=eng, max_len=max_len,
                      pattern=pattern, spec=spec, prefill_chunk_tokens=4)


def _serve(srv, prompts):
    for p in prompts:
        srv.queue.submit(p, MAX_NEW)
    return sorted(srv.serve_all(), key=lambda r: r.rid)


@pytest.fixture(scope="module")
def memo():
    return {}


@pytest.fixture
def shared(memo, tiny_dense_factory):
    """Made once per module (in `memo`) and read by every case that needs
    them: each arch's converted weights and the JAX package's reference
    serves (the tiny bursty serve is the reference of four cases)."""
    def weights(arch):
        if ("w", arch) not in memo:
            cfg = _cfg(arch, tiny_dense_factory)
            memo["w", arch] = (cfg,) + jax_params(cfg)
        return memo["w", arch]

    def reference(arch, pattern, lens, max_len):
        key = ("ref", arch, pattern, tuple(lens), max_len)
        if key not in memo:
            cfg, jp, _, _ = weights(arch)
            memo[key] = _serve(JaxServer(cfg, jp, max_len=max_len,
                                         pattern=pattern),
                               _prompts(cfg, lens))
        return memo[key]
    return weights, reference


# arch, pattern, prompt lengths, max_len, spec: gemma's 16 positions end
# the cache, so its last rounds shrink k; without spec the engine decodes
# one token per pass
CASES = [("tiny", "bursty", [8, 5, 8, 3], 32, True),
         ("tiny", "sporadic", [8, 8], 32, True),
         ("gemma-window6", "bursty", [10, 10, 7, 10], 16, True),
         ("tiny", "bursty", [8, 5, 8, 3], 32, False)]


@pytest.mark.parametrize("arch,pattern,lens,max_len,spec", CASES,
                         ids=[f"{c[0]}-{c[1]}{'' if c[4] else '-nospec'}"
                              for c in CASES])
def test_spec_engine_serve_matches_jax_greedy(arch, pattern, lens, max_len,
                                              spec, shared):
    cfg, jp, _, pp = shared[0](arch)
    prompts = _prompts(cfg, lens)
    ref = shared[1](arch, pattern, lens, max_len)
    srv = _engine_server(cfg, pp, pattern, max_len,
                         SpecConfig(k=K, draft="resident", adapt_k=False)
                         if spec else None)
    m0, d0 = mq.launches, da.launches
    got = _serve(srv, prompts)
    assert (mq.launches, da.launches) == (m0, d0), "CPU tensors never launch"
    for a in got:
        assert not a.rejected and len(a.output) == MAX_NEW
    width = max(lens) if pattern == "bursty" else None
    assert_same_or_near_tie(cfg, jp, pp, prompts, [r.output for r in got],
                            [r.output for r in ref], max_len, width)
    # counters: every live slot of a round drafts k (fewer near the cache
    # end) and keeps at most what it drafted
    be = srv.make_backend()
    stats = be.spec_stats
    if not spec:
        assert stats is None and set(be.rounds) == {(0, 1)}
        return
    n_batches = 1 if pattern == "bursty" else len(lens)
    live = len(lens) // n_batches
    ks = [k for k, _ in be.rounds if k]
    assert all(1 <= c <= k + 1 for k, c in be.rounds if k)
    assert stats["spec_rounds"] == live * len(ks)
    assert stats["spec_drafted"] == live * sum(ks)
    assert 0 <= stats["spec_accepted"] <= stats["spec_drafted"]
    if max_len == 32:
        assert {k for k, _ in be.rounds} == {K}
    else:                             # the cache end: shorter k
        assert min(ks) < K


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_spec_engine_host_drafts_match_jax_greedy(draft, shared):
    """The engine verifying host-proposed drafts (engine.verify_requests,
    rollback, note_committed): the JAX package's single-device greedy
    tokens, and the engine's own non-speculative serve's."""
    cfg, jp, _, pp = shared[0]("tiny")
    prompts = _prompts(cfg, [8, 5, 8, 3])
    ref = shared[1]("tiny", "bursty", [8, 5, 8, 3], 32)
    plain = _serve(_engine_server(cfg, pp, "bursty", 32, None), prompts)
    srv = _engine_server(cfg, pp, "bursty", 32, SpecConfig(k=K, draft=draft))
    got = _serve(srv, prompts)
    assert [r.output for r in got] == [r.output for r in plain]
    assert_same_or_near_tie(cfg, jp, pp, prompts, [r.output for r in got],
                            [r.output for r in ref], 32, 8)
    be = srv.make_backend()
    assert be._ctl.drafts is not None and be._depth is None
    assert be.spec_stats["spec_rounds"] == 4 * sum(1 for k, _ in be.rounds if k)
    assert {k for k, _ in be.rounds} == {K}


def test_retier_during_spec_serve_token_identical(shared):
    """retier(+1) after the first round and retier(-1) two rounds later,
    on the live serve: the tokens of the serve without retier, and the
    drafts shrink to the live resident tier in between (mirrors
    test_engine_retier_during_spec_token_identical)."""
    cfg, _, _, pp = shared[0]("tiny")
    prompts = _prompts(cfg, [8, 8, 8, 8])
    outs = []
    for retier in (False, True):
        srv = _engine_server(cfg, pp, "bursty", 32,
                             SpecConfig(k=K, draft="resident"))
        be = srv.make_backend()
        for p in prompts:
            srv.queue.submit(p, MAX_NEW)
        sched = ContinuousBatchingScheduler(be, SchedulerConfig())
        sched.begin(srv.queue.drain())
        rounds = 0
        while sched.step():
            rounds = len(be.rounds)
            if retier and rounds == 1 and be.engine.demoted(0) == 0:
                assert be.retier(0, +1) > 0
                assert srv.engine.resident_layer_ids() == []
            if retier and rounds == 3 and be.engine.demoted(0) == 1:
                assert be.retier(0, -1) < 0
                assert srv.engine.resident_layer_ids() == [0, 2]
        done = sorted(sched.finish_run(), key=lambda r: r.rid)
        assert rounds >= 4
        outs.append([r.output for r in done])
        if retier:
            st = sched.stats
            assert (st["retier_events"], st["layers_demoted"],
                    st["layers_promoted"]) == (2, 1, 1)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("draft,am", [
    ([3, 4, 5], [3, 4, 5, 9]),        # all accepted + bonus
    ([3, 7, 5], [3, 4, 5, 9]),        # mismatch at 1: correction
    ([8, 4, 5], [3, 4, 5, 9]),        # mismatch at 0
])
def test_greedy_verify_matches_jax(draft, am):
    lg = np.full((4, 12), -1.0, np.float32)
    lg[np.arange(4), am] = 1.0
    lg[:, 11] = 5.0                   # padded vocab column: never picked
    assert greedy_verify(lg, np.array(draft), 10) \
        == jax_greedy_verify(lg, np.array(draft), 10)


def test_depth_controller_matches_jax():
    a, b = DepthController(4, prior=0.8), JaxDepth(4, prior=0.8)
    for rung, prior, rounds in [(0, 0.4, [(4, 0), (4, 4)]),
                                (1, 0.3, [(2, 2), (1, 0)]),
                                (0, None, [(3, 3)])]:
        for c in (a, b):
            c.note_rung(rung, prior=prior)
        for drafted, acc in rounds:
            for c in (a, b):
                c.note_round(drafted, acc)
            assert (a.k(), a.acceptance, a.rung) == (b.k(), b.acceptance, b.rung)


def test_spec_config_refuses_what_the_port_lacks(tiny_dense_factory):
    """The refusals left are the JAX package's own: an unknown draft
    name, a recurrent family, a resident draft on an engine whose plan
    streams every layer. A dense model without an engine speculates."""
    import types

    from repro.serving.backend import EngineBackend as JaxBackend
    from repro.specdec import SpecConfig as JaxSpec
    from repro.specdec import make_draft_provider as jax_make_draft
    with pytest.raises(KeyError):
        SpecConfig(draft="medusa")
    with pytest.raises(KeyError):
        jax_make_draft(JaxSpec(draft="medusa"), tiny_dense_factory())
    ssm = get_smoke_config("rwkv6-3b")
    with pytest.raises(ValueError, match="pure-KV"):
        JaxBackend(ssm, {}, spec=JaxSpec())
    with pytest.raises(ValueError, match="pure-KV"):
        LimeServer(port_cfg(ssm), {}, spec=SpecConfig(),
                   device="cpu").make_backend()
    cfg = port_cfg(tiny_dense_factory(n_layers=4))
    eng = PE.InterleavedEngine(cfg, PE.UniformPlan(1, 2, 0, 2), mb=4,
                               max_len=32, device="cpu")
    assert eng.k_res_cap == 0
    with pytest.raises(ValueError, match="resident tier"):
        LimeServer(cfg, {}, engine=eng, max_len=32,
                   spec=SpecConfig(draft="resident")).make_backend()
    # the JAX engine refuses the same plan at the same check
    fake = types.SimpleNamespace(k_res_cap=0, n_mb=1, mb=4, S_c=32)
    with pytest.raises(ValueError, match="resident tier"):
        JaxBackend(tiny_dense_factory(n_layers=4), {}, engine=fake,
                   max_len=32, spec=JaxSpec(draft="resident"))
    eng.close()
    for draft in ("ngram", "model", "resident"):
        be = LimeServer(cfg, {}, spec=SpecConfig(draft=draft),
                        device="cpu").make_backend()
        assert be.spec.draft == draft and be.engine is None


def test_launcher_engine_spec_prints_report(capsys):
    """The launcher plans for a forced weight budget: 2 of 4 layers fit,
    so the engine streams the rest and drafts on the resident tier."""
    rc = launch_serve.main(["--arch", "llama3.3-70b", "--smoke", "--layers",
                            "4", "--device", "cpu", "--hbm-bytes", "3e6", "--spec",
                            "--spec-draft", "resident", "--spec-k", "3",
                            "--pattern", "bursty", "--requests", "4",
                            "--max-new", "4", "--prompt-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "engine: n_seg 2, k_res 1, k_off 1" in out
    report = json.loads(out[out.index("{"):])
    assert report["backend"] == "engine" and report["total_tokens"] == 16
    assert report["spec_rounds"] > 0 and report["spec_drafted"] > 0
