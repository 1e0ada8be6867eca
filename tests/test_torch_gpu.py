"""The port's CUDA kernels and main path on the card.

Marked `gpu`: each test decides inside a fixture whether a CUDA device is
visible and skips without one (the kernels are CUDA C++ with no CPU
mode). Imports no JAX, so it runs on the card's machine, where
tests/conftest.py (which imports JAX) is skipped:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_cases import (BF16_REL, DECODE_CASES, DECODE_SM90_CASES, F32_REL,
                          FLASH_CASES, FLASH_HOPPER_CASES, MQ_CASES,
                          MQ_HOPPER_CASES, MQ_PAGED_CASES,
                          MQ_PAGED_HOPPER_CASES, MQ_PAGED_VERIFY_CASES,
                          PAGED_CASES, PAGED_SM90_CASES, SCAN_REL, SSM_CASES,
                          VERIFY_SM90_CASES, WKV_CASES, decode_inputs,
                          flash_inputs, gathered_ids, mq_inputs,
                          mq_paged_case_inputs, np_rand, paged_case_inputs,
                          paged_inputs, rel_err, ssm_inputs, to_torch,
                          wkv_inputs)
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import InterleavedEngine, UniformPlan
from repro_torch.kernels.decode_attention import multiquery as mq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import model as M
from repro_torch.serving import (ContinuousBatchingScheduler, LimeServer,
                                 SchedulerConfig)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}kv{c[4]}d{c[5]}")
def test_flash_kernel_vs_plain(case, cuda_device):
    B, Sq, Skv, H, KV, dh, causal, window, dt = case
    q, k, v = (to_torch(a, dt, cuda_device) for a in flash_inputs(case))
    n0 = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert rel_err(out, ref) <= (BF16_REL if dt == "bf16" else F32_REL)


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_decode_kernel_vs_plain(case, cuda_device):
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = da.launches
    out = da.decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert da.launches == n0 + 1
    ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_CASES,
                         ids=lambda c: f"q{c[1]}S{c[2]}H{c[3]}kv{c[4]}d{c[5]}p{c[6]}-{c[8]}")
def test_mq_kernel_vs_plain(case, cuda_device):
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    q, k, v, ids = mq_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = mq.launches
    out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert mq.launches == n0 + 1
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL
    if kind == "masked":
        assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("q_len,pos", [(5, 1019), (512, 0)],
                         ids=["verify", "prefill"])
def test_mq_kernel_main_shapes(q_len, pos, cuda_device):
    """The main path's shapes: verify (k = 4) at the end of a full cache,
    and a 512-position prefill round into an empty one."""
    case = (4, q_len, 1024, 64, 8, 128, pos, None, "linear")
    q, k, v, ids = mq_inputs(case, seed=1)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    out = mq.mq_decode_attention(q, k, v, ids, pos)
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_mq_kernel_at_qlen1_is_decode_kernel(case, cuda_device):
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    a = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    b = da.decode_attention(q, k, v, ids, pos, window=window)
    assert rel_err(a, b) <= BF16_REL


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 1, 4, 64), dtype=torch.float16, device=cuda_device)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda_device)
    ids = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, k, ids, 7)
    q = torch.zeros((1, 16, 4, 512), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., ::2], q[..., ::2], q[..., ::2])
    qf = torch.zeros((1, 2, 4, 64), dtype=torch.float32, device=cuda_device)
    kf = torch.zeros((1, 8, 2, 64), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):          # the mq kernel is bf16 only
        mq.mq_decode_attention(qf, kf, kf, ids, 7)
    with pytest.raises(ValueError):
        mq.mq_decode_attention(qf.bfloat16(), kf.bfloat16(), kf.bfloat16(),
                               ids[:4], 7)


def test_model_kernel_path_vs_reference(cuda_device):
    """gemma3 smoke (sliding windows, a ring that wraps) on the card:
    the kernel path launches both kernels and its logits stay within
    bf16 noise of the reference math."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), window_size=6)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    out, fed = {}, []
    for impl in ("ref", "kernel"):        # kernel path fed the ref's picks
        f0, d0 = fa.launches, da.launches
        cache = M.init_cache(cfg, 2, 16)
        lg, cache = M.prefill(cfg, params, toks.to(cuda_device), cache,
                              impl=impl)
        steps = [lg[:, -1].float()]
        for i in range(8):
            if impl == "ref":
                fed.append(lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True))
            lg, cache = M.decode_step(cfg, params, cache, fed[i], impl=impl)
            steps.append(lg[:, -1].float())
        out[impl] = torch.stack(steps)
        launched = (fa.launches - f0, da.launches - d0)
        assert launched == ((cfg.n_layers, 8 * cfg.n_layers)
                            if impl == "kernel" else (0, 0))
    err = (out["kernel"] - out["ref"]).abs().max().item()
    assert err <= 0.05 * out["ref"].abs().max().item()


def test_lime_server_defaults_to_the_card(cuda_device):
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg)           # no device: the card
    assert params["embedding"].device.type == "cuda"
    srv = LimeServer(cfg, params, max_len=64, pattern="bursty")
    rng = np.random.default_rng(0)
    for _ in range(4):
        srv.queue.submit(rng.integers(1, cfg.vocab_size, 12), 5)
    n0 = da.launches
    done = srv.serve_all()
    assert len(done) == 4 and all(len(r.output) == 5 for r in done)
    assert da.launches - n0 == 4 * cfg.n_layers


def test_traced_serve_on_the_card(cuda_device, monkeypatch):
    """The flight recorder on the card: a captured bursty serve (its graphs
    captured by a warm-up serve) untraced, then traced with an SLO engine
    attached: the same tokens, kernel launches and device reads
    (synchronize, item, tolist, cpu); one engine.decode span per round and
    one engine.prefill, each closing after its step's host copy; the
    Chrome export valid."""
    from repro_torch.obs import (SLOEngine, Tracer, set_tracer, to_chrome,
                                 validate_chrome)
    from repro_torch.obs import trace as tr_ev
    from repro_torch.serving import EngineBackend, Request
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    be = EngineBackend(cfg, params, n_slots=4, max_len=64)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, 12) for _ in range(4)]

    def serve():
        return sorted(ContinuousBatchingScheduler(be, SchedulerConfig()).serve(
            [Request(i, p, 6) for i, p in enumerate(prompts)]),
            key=lambda r: r.rid)
    serve()                                      # captures the graphs
    runs = []
    for traced in (False, True):
        reads = {}
        with monkeypatch.context() as m:
            for obj, name in ((torch.Tensor, "item"), (torch.Tensor, "tolist"),
                              (torch.Tensor, "cpu"), (torch.cuda, "synchronize")):
                def counted(*a, _fn=getattr(obj, name), _k=name, **kw):
                    reads[_k] = reads.get(_k, 0) + 1
                    return _fn(*a, **kw)
                m.setattr(obj, name, counted)
            tracer = Tracer() if traced else None
            prev = set_tracer(tracer)
            try:
                n0, r0 = (da.launches, fa.launches), len(be.rounds)
                sched = ContinuousBatchingScheduler(be, SchedulerConfig())
                if traced:
                    sched.attach_slo(SLOEngine())
                done = sorted(sched.serve([Request(i, p, 6) for i, p
                                           in enumerate(prompts)]),
                              key=lambda r: r.rid)
            finally:
                set_tracer(prev)
        runs.append(([r.output for r in done],
                     (da.launches - n0[0], fa.launches - n0[1]), reads,
                     len(be.rounds) - r0, tracer))
    assert runs[0][:3] == runs[1][:3]
    tracer, rounds = runs[1][4], runs[1][3]
    spans = [e for e in tracer.events()
             if e[tr_ev.EVT_TRACK] == tr_ev.TRACK_PIPELINE]
    assert [e[tr_ev.EVT_NAME] for e in spans] \
        == [tr_ev.ENGINE_PREFILL] + [tr_ev.ENGINE_DECODE] * rounds
    assert all(e[tr_ev.EVT_DUR] > 0 for e in spans)
    assert validate_chrome(to_chrome(tracer)) == []


def test_fleet_on_the_card(cuda_device):
    """The launcher's fleet on the card: two make_fleet replicas over one
    set of smoke weights (radix prefix cache, page 8, prefill rounds of 8)
    under the prefix router, 24 shared-prefix requests of two templates at
    one instant (two equal-length epochs, then an unequal one, a template
    a replica): every request served once, by the replica its template
    went to; each replica's own steps launch kernels 2 (the unequal
    epoch's flash prefill), 3 (decode) and 5 (prefill rounds) and nothing
    of kernels 1 and 4, and the replicas' launches sum to the totals; the
    weights are the one set; a second fleet serves the stream identically
    (placement, router stats, tokens)."""
    from repro_torch.launch.serve import make_fleet, rebase_arrivals
    from repro_torch.serving import requests_from_arrivals
    from repro_torch.serving.traffic import ArrivalEvent
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    lens = (32,) * 8 + (32, 30, 28, 26)
    counters = ((fa, "launches"), (pg, "launches"), (mq, "paged_launches"),
                (da, "launches"), (mq, "launches"))

    def counts():
        return [getattr(m, a) for m, a in counters]

    def run():
        fleet = make_fleet(cfg, params, replicas=2, n_slots=4, max_len=64,
                           prefix_cache=True, prefill_chunk_tokens=8,
                           page_size=8, router="prefix")
        assert all(r.backend.params is params for r in fleet.replicas)
        per = {r.name: [0] * len(counters) for r in fleet.replicas}
        for rep in fleet.replicas:
            def wrapped(_step=rep.step, _name=rep.name):
                c0 = counts()
                out = _step()
                per[_name] = [a + c - b for a, b, c
                              in zip(per[_name], c0, counts())]
                return out
            rep.step = wrapped
        arr = [ArrivalEvent(0.0, lens[i // 2], 6, template_id=i % 2,
                            template_len=24) for i in range(24)]
        reqs = requests_from_arrivals(arr, vocab_size=cfg.vocab_size)
        rebase_arrivals(fleet, reqs)
        c0 = counts()
        res = fleet.run(reqs)
        torch.cuda.synchronize()
        total = [c - b for b, c in zip(c0, counts())]
        return fleet, res, per, total

    fleet, res, per, total = run()
    part = {n: sorted(r.rid for r in recs) for n, recs in res.per_replica.items()}
    assert part == {"r0": list(range(0, 24, 2)), "r1": list(range(1, 24, 2))}
    assert not res.shed and all(len(r.output) == 6 for r in res.requests)
    assert fleet.router.stats["prefix_matched"] > 0
    for name, p in per.items():
        assert min(p[:3]) > 0 and p[3] == p[4] == 0, (name, p)
    assert [sum(p[i] for p in per.values()) for i in range(len(counters))] \
        == total
    assert all(r.backend.prefix_stats["prefill_tokens_saved"] > 0
               for r in fleet.replicas)
    again = run()
    assert dict(again[0].router.stats) == dict(fleet.router.stats)
    assert {r.rid: r.output for r in again[1].requests} \
        == {r.rid: r.output for r in res.requests}
    assert again[2] == per


def test_engine_streams_and_matches_model(cuda_device):
    """llama smoke, 4 layers, 2 chunks of 1 resident + 1 streamed layer
    (pinned host store, side-stream copies): decode and verify equal the
    model's kernel path bit for bit, and a retier round trip keeps them
    equal."""
    cfg = dataclasses.replace(get_smoke_config("llama3.3-70b"), n_layers=4)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    eng = InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), mb=2, max_len=32,
                            retier_headroom=1)
    st = eng.init_state(params)
    assert eng._store.registered and eng._store.data.is_pinned()
    mc = M.init_cache(cfg, 2, 32)
    toks = torch.randint(1, cfg.vocab_size, (2, 9), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    m0 = mq.launches
    el, st = eng.verify_step(st, toks)
    ml, mc = M.verify_step(cfg, params, mc, toks, impl="kernel")
    assert mq.launches - m0 == 2 * cfg.n_layers
    assert torch.equal(el, ml)
    tok = el[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for step in range(4):
        if step == 1:
            eng.retier(st, 0, +1)
        if step == 3:
            eng.retier(st, 0, -1)
        el, st = eng.decode_step(st, tok)
        ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel")
        assert torch.equal(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    eng.close()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_recurrent_engine_streams_and_matches_model(arch, cuda_device):
    """The recurrent families through the engine (smoke, 4 layers, 2
    chunks of 1 resident + 1 streamed layer): the prompt pass over the
    tiers (160 tokens: the scans' chunked body; past Hymba's 128-slot
    ring) leaves M.prefill's logits and cache bit for bit, and decode
    steps equal M.decode_step's, both through the kernels with exact
    launch counts; a paged engine's decode is the same."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=4)
    L = cfg.n_layers
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 160), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    scan = wkv_ops if cfg.family.value == "ssm" else ssm_ops
    runs = []
    for paged in (False, True):
        eng = InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), mb=2,
                                max_len=256, paged=paged, page_size=16)
        st = eng.init_state(params)
        n0, c0, f0 = scan.launches, scan.chunked_launches, fa.launches
        el, cache = eng.prefill(toks)
        torch.cuda.synchronize()
        assert (scan.launches - n0, scan.chunked_launches - c0) == (L, L)
        assert fa.launches - f0 == (L if scan is ssm_ops else 0)
        st = eng.seed_cache(st, cache)
        mc = M.init_cache(cfg, 2, 256)
        ml, mc = M.prefill(cfg, params, toks, mc, impl="kernel")
        assert torch.equal(el, ml)
        for key in mc:
            if key != "pos":
                assert torch.equal(st[key], mc[key]), key
        tok = el[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        out = [el[:, -1]]
        for _ in range(3):
            n0, d0 = scan.launches, da.launches
            el, st = eng.decode_requests(st, tok, torch.ones(2, dtype=torch.bool))
            torch.cuda.synchronize()
            assert scan.launches - n0 == L
            assert da.launches - d0 == (L if scan is ssm_ops else 0)
            ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel")
            assert torch.equal(el, ml[:, 0])
            out.append(el)
            tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        if eng.paged:
            assert eng.paged_stats()["slot_tokens"] == [min(163, eng.S_c)] * 2
        runs.append(torch.stack(out))
        eng.close()
    assert torch.equal(runs[0], runs[1])


def test_adaptive_engine_serve_on_the_card(cuda_device):
    """llama smoke, 4 layers (2 resident, plan_for at a 4.6 MB budget), a
    bursty batch of 4 under paged admission (page 8) with an OnlinePlanner
    (rungs of 128 tokens: a smoke layer frees 144 tokens of the batch's
    KV, under the default 256): its rung fires while the batch is live,
    demoting the resident slot; every step runs kernel 1 (decode) and the
    prefill rounds kernel 4; the tokens are those of the same serve
    without the planner."""
    from repro_torch.core.engine import plan_for
    from repro_torch.core.online_planner import OnlinePlanner
    from repro_torch.launch.serve import HBM_FRAC, cost_env
    cfg = dataclasses.replace(get_smoke_config("llama3.3-70b"), n_layers=4)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    plan = plan_for(cfg, 1, hbm_frac_for_weights=HBM_FRAC, hbm_bytes=4.6e6)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(4)]
    outs, fired = [], []
    for adapt in (False, True):
        eng = InterleavedEngine(cfg, plan, mb=4, max_len=32,
                                retier_headroom=int(adapt))
        env = cost_env(cfg, 4.6e6, width=4, prompt_len=8)
        planner = OnlinePlanner(env, plan, horizon_tokens=512,
                                ladder_chunk_tokens=128) if adapt else None
        srv = LimeServer(cfg, params, engine=eng, max_len=32, pattern="bursty",
                         prefill_chunk_tokens=4, planner=planner)
        for p in prompts:
            srv.queue.submit(p, 12)
        be = srv.make_backend()
        sched = ContinuousBatchingScheduler(be, SchedulerConfig(
            kv_policy="paged", page_size=8))
        reqs = srv.queue.drain()
        sched.begin(reqs)
        m0, d0 = mq.launches, da.launches
        while True:
            d1 = da.launches
            if not sched.step():
                break
            if be.rounds and da.launches > d1:
                assert da.launches - d1 == cfg.n_layers
            if be.adapt_stats["retier_events"] and not fired and adapt:
                fired.append((len(be.rounds), sum(not r.done for r in reqs)))
        torch.cuda.synchronize()
        assert mq.launches - m0 == 2 * cfg.n_layers      # 2 prefill rounds
        assert da.launches - d0 == 11 * cfg.n_layers     # 11 decode steps
        outs.append([r.output for r in sorted(sched.finish_run(),
                                              key=lambda r: r.rid)])
        if adapt:
            assert be.adapt_stats["layers_streamed_now"] == 1
            assert eng.resident_layer_ids() == []
        eng.close()
    assert fired and 1 <= fired[0][0] < 11 and fired[0][1] == 4
    assert outs[0] == outs[1]


# ----------------------------------------------------------------------------
# paged kernels (3: paged decode, 5: paged multi-query)
# ----------------------------------------------------------------------------
def _paged_on(device, q, k, v, bt, ctx, dt="bf16"):
    return (*(to_torch(a, dt, device) for a in (q, k, v)),
            torch.from_numpy(bt).to(device), torch.from_numpy(ctx).to(device))


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c[1]}kv{c[2]}d{c[3]}ps{c[4]}w{c[7]}")
def test_paged_kernel_vs_plain(case, cuda_device):
    window = case[-1]
    q, k, v, bt, ctx = _paged_on(cuda_device, *paged_case_inputs(case))
    n0 = pg.launches
    out = pg.paged_decode_attention(q, k, v, bt, ctx, window=window)
    torch.cuda.synchronize()
    assert pg.launches == n0 + 1
    ref = pg.paged_decode_attention_plain(q, k, v, bt, ctx, window=window)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_PAGED_CASES,
                         ids=lambda c: f"q{c[1]}H{c[2]}kv{c[3]}d{c[4]}ps{c[5]}w{c[8]}")
def test_mq_paged_kernel_vs_plain(case, cuda_device):
    window = case[-1]
    q, k, v, bt, ctx = _paged_on(cuda_device, *mq_paged_case_inputs(case))
    n0 = mq.paged_launches
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctx, window=window)
    torch.cuda.synchronize()
    assert mq.paged_launches == n0 + 1
    ref = mq.mq_paged_decode_attention_plain(q, k, v, bt, ctx, window=window)
    assert rel_err(out, ref) <= BF16_REL


def _uniform(case, Q):
    """A case's shapes with every sequence at the largest ctx (the shared
    position the contiguous kernels take)."""
    B, H, KV, dh, ps, maxp, ctx, window = case
    c = max(max(ctx), Q)
    return paged_inputs(B, Q, H, KV, dh, ps, maxp, (c,) * B, seed=3), window


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c[1]}kv{c[2]}d{c[3]}ps{c[4]}w{c[7]}")
def test_paged_kernel_bitwise_vs_decode_kernel(case, dt, cuda_device):
    """The paged kernel over the pool equals the contiguous decode kernel
    on the gathered cache bit for bit: one body, one split, one tile
    order; only the slot addressing differs."""
    (q, k, v, bt, ctx), window = _uniform(case, 1)
    q, k, v, bt, ctx = _paged_on(cuda_device, q, k, v, bt, ctx, dt)
    c = int(ctx[0])
    out = pg.paged_decode_attention(q, k, v, bt, ctx, window=window)
    ids = torch.from_numpy(gathered_ids(bt.shape[1] * k.shape[1], c)) \
        .to(cuda_device)
    ref = da.decode_attention(q, pg.gather_pages(k, bt).contiguous(),
                              pg.gather_pages(v, bt).contiguous(), ids, c - 1,
                              window=window)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", MQ_PAGED_CASES,
                         ids=lambda c: f"q{c[1]}H{c[2]}kv{c[3]}d{c[4]}ps{c[5]}w{c[8]}")
def test_mq_paged_kernel_bitwise_vs_mq_kernel(case, cuda_device):
    B, Q, H, KV, dh, ps, maxp, ctx, window = case
    (q, k, v, bt, ctx), _ = _uniform((B, H, KV, dh, ps, maxp, ctx, window), Q)
    q, k, v, bt, ctx = _paged_on(cuda_device, q, k, v, bt, ctx)
    c = int(ctx[0])
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctx, window=window)
    ids = torch.from_numpy(gathered_ids(maxp * ps, c)).to(cuda_device)
    ref = mq.mq_decode_attention(q, pg.gather_pages(k, bt).contiguous(),
                                 pg.gather_pages(v, bt).contiguous(), ids,
                                 c - Q, window=window)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("q_len", [1, 5, 128])
def test_paged_kernels_read_only_filled_slots(q_len, cuda_device):
    """NaN in every page no table names and in every slot past ctx (the
    tail of each last page): a kernel that read one would return NaN, so
    the output must equal the clean pool's bit for bit. Main-path widths:
    page 64, H 64, KV 8, dh 128; ragged ctx."""
    ctx = (1019, 700, 300, 130)
    q, k, v, bt, ctxn = paged_inputs(4, q_len, 64, 8, 128, 64, 16, ctx,
                                     seed=5)
    q, k, v, bt, ctxn = _paged_on(cuda_device, q, k, v, bt, ctxn)
    dirty = torch.ones(k.shape[:2], dtype=torch.bool, device=cuda_device)
    for b, c in enumerate(ctx):
        t = torch.arange(c, device=cuda_device)
        dirty[bt[b, t // 64].long(), t % 64] = False
    kd, vd = k.clone(), v.clone()
    kd[dirty] = float("nan")
    vd[dirty] = float("nan")
    if q_len == 1:
        fn = pg.paged_decode_attention
    else:
        fn = mq.mq_paged_decode_attention
    clean = fn(q, k, v, bt, ctxn)
    got = fn(q, kd, vd, bt, ctxn)
    assert torch.isfinite(got.float()).all() and torch.equal(got, clean)


def test_paged_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, k, v, bt, ctx = _paged_on(cuda_device,
                                 *paged_case_inputs(PAGED_CASES[0]))
    with pytest.raises(ValueError):           # page size not a multiple of 8
        pg.paged_decode_attention(q, k[:, :6].contiguous(),
                                  v[:, :6].contiguous(), bt, ctx)
    with pytest.raises(ValueError):           # int64 tables
        pg.paged_decode_attention(q, k, v, bt.long(), ctx)
    with pytest.raises(ValueError):           # ctx of another batch
        pg.paged_decode_attention(q, k, v, bt, ctx[:1])
    with pytest.raises(ValueError):           # dh of q and pool differ
        pg.paged_decode_attention(q[..., :32].contiguous(), k, v, bt, ctx)
    with pytest.raises(ValueError):           # two query positions
        pg.paged_decode_attention(torch.cat([q, q], 1), k, v, bt, ctx)
    with pytest.raises(TypeError):            # the mq kernel is bf16 only
        mq.mq_paged_decode_attention(q.float(), k.float(), v.float(), bt, ctx)
    with pytest.raises(ValueError):           # page size 4
        mq.mq_paged_decode_attention(q, k[:, :4].contiguous(),
                                     v[:, :4].contiguous(), bt, ctx)
    with pytest.raises(ValueError):           # tables on the CPU
        mq.mq_paged_decode_attention(q, k, v, bt.cpu(), ctx)


def test_paged_cache_is_contiguous_decode_bit_for_bit(cuda_device):
    """llama smoke on the card: a paged cache seeded from the flash
    prefill, its pages reused out of order, decodes across page boundaries
    bit-equal to the model's contiguous decode_step (kernel 3 against 1,
    max_len a multiple of the page size), and one verify pass is bit-equal
    to verify_step (kernel 5 against 4)."""
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    from repro_torch.kvcache.pool import PagedKVConfig, PagePool
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 13), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    cache = M.init_cache(cfg, 2, 32)
    lg, cache = M.prefill(cfg, params, toks, cache, impl="kernel")
    pool = PagePool(PagedKVConfig(page_size=8, device_pages=12))
    for pid in reversed(pool.alloc_pages(5)):
        pool.decref_page(pid)
    pc = PagedDecodeCache(cfg, 2, 32, page_size=8, pool=pool, impl="kernel")
    pc.seed(cache)
    tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    d0, p0 = da.launches, pg.launches
    for _ in range(6):                        # positions 13..18: page 2 opens
        lm, cache = M.decode_step(cfg, params, cache, tok, impl="kernel")
        assert torch.equal(pc.step(params, tok), lm)
        tok = lm[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    assert (da.launches - d0, pg.launches - p0) == (6 * cfg.n_layers,) * 2
    mat = torch.cat([tok, toks[:, :3]], 1)
    lv, cache = M.verify_step(cfg, params, cache, mat, impl="kernel")
    assert torch.equal(pc.verify(params, mat), lv)


def test_prefix_server_on_card(cuda_device):
    """The prefix cache served on the card: two epochs of one template,
    the warm one prefilling only the uncached suffix through the paged
    multi-query kernel; its tokens are a cold serve's."""
    from repro_torch.serving import make_arrivals, requests_from_arrivals
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    arr = [dataclasses.replace(a, time_s=0.0) for a in make_arrivals(
        "shared_prefix", 8, n_templates=1, prefix_len=24, prompt_len=32,
        max_new_tokens=6, seed=0)]
    prompts = [r.prompt for r in requests_from_arrivals(
        arr, vocab_size=cfg.vocab_size)]

    def serve(ps):
        srv = LimeServer(cfg, params, max_len=64, pattern="bursty",
                         prefix_cache=True, prefill_chunk_tokens=8,
                         page_size=8)
        for p in ps:
            srv.queue.submit(p, 6)
        done = sorted(srv.serve_all(), key=lambda r: r.rid)
        return [r.output for r in done], srv.make_backend()

    n0, p0 = mq.paged_launches, pg.launches
    toks, be = serve(prompts)
    # epoch 1: 4 rounds of 8; epoch 2: one round (24 of 32 cached)
    assert mq.paged_launches - n0 == (4 + 1) * cfg.n_layers
    assert pg.launches - p0 == 2 * 5 * cfg.n_layers
    assert be.prefix_stats["prefill_tokens_saved"] == 4 * 24
    assert toks[4:] == serve(prompts[4:])[0]


# ----------------------------------------------------------------------------
# recurrent scans (6: WKV, 7: selective scan)
# ----------------------------------------------------------------------------
def _on(device, arrays, bf16=()):
    """numpy fp32 arrays to the card; positions in bf16 become bfloat16."""
    return [torch.from_numpy(a).to(device, torch.bfloat16 if i in bf16
                                   else torch.float32)
            for i, a in enumerate(arrays)]


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("case", WKV_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}")
def test_wkv_kernel_vs_plain(case, state, dt, cuda_device):
    """r, k, v, u in bf16 (the model's types) or fp32; w and the state
    fp32; the state updated in place."""
    r, k, v, w, u, s0 = _on(cuda_device, wkv_inputs(case, state=state),
                            bf16=(0, 1, 2, 4) if dt == "bf16" else ())
    ref_o, ref_s = wkv_ops.wkv_plain(r, k, v, w, u, s0)
    s = s0.clone()
    n0 = wkv_ops.launches
    out = wkv_ops.wkv(r, k, v, w, u, s)
    torch.cuda.synchronize()
    assert wkv_ops.launches == n0 + 1
    assert rel_err(out, ref_o) <= SCAN_REL and rel_err(s, ref_s) <= SCAN_REL


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("case", SSM_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}N{c[4]}")
def test_ssm_kernel_vs_plain(case, state, dt, cuda_device):
    """x, B, C in bf16 (the model's types) or fp32; dt, A and the state
    fp32; the state updated in place."""
    x, d, bm, cm, A, s0 = _on(cuda_device, ssm_inputs(case, state=state),
                              bf16=(0, 2, 3) if dt == "bf16" else ())
    ref_y, ref_s = ssm_ops.ssm_scan_plain(x, d, bm, cm, A, s0)
    s = s0.clone()
    n0 = ssm_ops.launches
    y = ssm_ops.ssm_scan(x, d, bm, cm, A, s)
    torch.cuda.synchronize()
    assert ssm_ops.launches == n0 + 1
    assert rel_err(y, ref_y) <= SCAN_REL and rel_err(s, ref_s) <= SCAN_REL


def test_scan_kernels_chain_bit_for_bit(cuda_device):
    """Two calls over the halves of a sequence (the state carried in
    place) equal one call over the whole, bit for bit: every step does the
    same arithmetic wherever a call starts."""
    r, k, v, w, u, s0 = _on(cuda_device, wkv_inputs((2, 100, 3, 64), seed=4),
                            bf16=(0, 1, 2, 4))
    s_full, s = s0.clone(), s0.clone()
    full = wkv_ops.wkv(r, k, v, w, u, s_full)
    parts = [wkv_ops.wkv(r[:, a:b].contiguous(), k[:, a:b].contiguous(),
                         v[:, a:b].contiguous(), w[:, a:b].contiguous(), u, s)
             for a, b in ((0, 37), (37, 100))]
    assert torch.equal(torch.cat(parts, 1), full) and torch.equal(s, s_full)
    x, d, bm, cm, A, h0 = _on(cuda_device, ssm_inputs((2, 100, 5, 64, 16), seed=6),
                              bf16=(0, 2, 3))
    h_full, h = h0.clone(), h0.clone()
    full = ssm_ops.ssm_scan(x, d, bm, cm, A, h_full)
    parts = [ssm_ops.ssm_scan(x[:, a:b].contiguous(), d[:, a:b].contiguous(),
                              bm[:, a:b].contiguous(), cm[:, a:b].contiguous(),
                              A, h) for a, b in ((0, 37), (37, 100))]
    assert torch.equal(torch.cat(parts, 1), full) and torch.equal(h, h_full)


# the chunked bodies (bf16, S >= 128): (B, S, H, dh) and (B, S, H, dh, N).
# S 191 ends in a ragged chunk, S 1000 has more chunks than a cluster (two
# rounds); B 4 / S 512 are phase 3c's prefill shapes at full width.
WKV_CHUNKED_CASES = [(1, 128, 4, 64), (4, 512, 40, 64), (1, 512, 40, 64), (2, 191, 3, 32),
                     (1, 1000, 2, 64), (2, 1000, 3, 128), (4, 512, 4, 128), (1, 191, 2, 128),
                     (2, 512, 3, 32)]
SSM_CHUNKED_CASES = [(1, 128, 5, 64, 16), (4, 512, 25, 64, 16), (1, 512, 25, 64, 16),
                     (2, 191, 3, 32, 8), (1, 1000, 2, 64, 64), (2, 1000, 3, 128, 16),
                     (1, 512, 2, 128, 64), (2, 191, 3, 64, 8)]


def _wkv_f64(r, k, v, w, u, S):
    """The WKV time loop in fp64."""
    r, k, v, w, u, S = (t.double() for t in (r, k, v, w, u, S))
    outs = []
    for t in range(r.shape[1]):
        a = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkd->bhd", r[:, t], S + u[None, :, :, None] * a))
        S = w[:, t, :, :, None] * S + a
    return torch.stack(outs, 1), S


def _ssm_f64(x, dt, bm, cm, A, h):
    """The selective scan's time loop in fp64."""
    x, dt, bm, cm, A, h = (t.double() for t in (x, dt, bm, cm, A, h))
    dec = torch.exp(A[None, None, :, None] * dt[..., None])
    ys = []
    for t in range(x.shape[1]):
        h = dec[:, t, :, :, None] * h \
            + dt[:, t, :, None, None] * bm[:, t, None, :, None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnd->bhd", cm[:, t], h))
    return torch.stack(ys, 1), h


def _scan_call(mod, args):
    """One kernel call on a copy of the state: (out, final state), and the
    launch counters moved by exactly one launch on the chunked body."""
    fn = mod.wkv if mod is wkv_ops else mod.ssm_scan
    s = args[-1].clone()
    n0 = (mod.launches, mod.chunked_launches)
    out = fn(*args[:-1], s)
    torch.cuda.synchronize()
    assert (mod.launches, mod.chunked_launches) == (n0[0] + 1, n0[1] + 1)
    return out, s


@pytest.mark.parametrize("case", WKV_CHUNKED_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}")
def test_wkv_chunked_kernel_vs_plain(case, cuda_device):
    """The chunked body against its model (wkv_chunked_plain) and against
    the sequential plain version, output and in-place state, from a random
    state."""
    args = _on(cuda_device, wkv_inputs(case, seed=11), bf16=(0, 1, 2, 4))
    out, s = _scan_call(wkv_ops, args)
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    for plain in (wkv_ops.wkv_chunked_plain, wkv_ops.wkv_plain):
        ref_o, ref_s = plain(*args)
        assert rel_err(out, ref_o) <= SCAN_REL and rel_err(s, ref_s) <= SCAN_REL


@pytest.mark.parametrize("case", SSM_CHUNKED_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}N{c[4]}")
def test_ssm_chunked_kernel_vs_plain(case, cuda_device):
    args = _on(cuda_device, ssm_inputs(case, seed=11), bf16=(0, 2, 3))
    y, s = _scan_call(ssm_ops, args)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    for plain in (ssm_ops.ssm_scan_chunked_plain, ssm_ops.ssm_scan_plain):
        ref_y, ref_s = plain(*args)
        assert rel_err(y, ref_y) <= SCAN_REL and rel_err(s, ref_s) <= SCAN_REL


# extreme decays (tests/test_torch_scan_chunked.py): the kernel held to an
# fp64 evaluation, where the fp32 sequential scan itself is off by up to
# 5e-4 (an output that is one fresh, nearly cancelling term)
EXTREME_STEPS = [0, 5, 63, 64, 65, 130, 255, 300, 511]


@pytest.mark.parametrize("kind", ["w 0 at chosen steps", "w 1e-30 at chosen steps",
                                  "w 1e-30 everywhere", "w 1 - 1e-6 everywhere",
                                  "w 1e-30 or 1 - 1e-6"])
def test_wkv_chunked_kernel_extreme_decays(kind, cuda_device):
    r, k, v, w, u, s0 = _on(cuda_device, wkv_inputs((2, 512, 4, 64), seed=3),
                            bf16=(0, 1, 2, 4))
    if kind == "w 0 at chosen steps":
        w[:, EXTREME_STEPS] = 0.0
    elif kind == "w 1e-30 at chosen steps":
        w[:, EXTREME_STEPS] = 1e-30
    elif kind == "w 1e-30 everywhere":
        w.fill_(1e-30)
    elif kind == "w 1 - 1e-6 everywhere":
        w.fill_(1 - 1e-6)
    else:
        g = torch.Generator(cuda_device).manual_seed(3)
        w = torch.where(torch.rand(w.shape, generator=g, device=cuda_device) < 0.3,
                        1e-30, 1 - 1e-6).float()
    out, s = _scan_call(wkv_ops, (r, k, v, w, u, s0))
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    ref_o, ref_s = _wkv_f64(r, k, v, w, u, s0)
    assert rel_err(out, ref_o) <= SCAN_REL and rel_err(s, ref_s) <= SCAN_REL


@pytest.mark.parametrize("kind", ["dt 20 at chosen steps", "dt 20 or 1e-3",
                                  "dt 20 everywhere"])
def test_ssm_chunked_kernel_extreme_decays(kind, cuda_device):
    x, dt, bm, cm, A, s0 = _on(cuda_device, ssm_inputs((2, 512, 5, 64, 16), seed=3),
                               bf16=(0, 2, 3))
    if kind == "dt 20 at chosen steps":
        dt[:, EXTREME_STEPS] = 20.0
    elif kind == "dt 20 or 1e-3":
        g = torch.Generator(cuda_device).manual_seed(3)
        dt = torch.where(torch.rand(dt.shape, generator=g, device=cuda_device) < 0.3,
                         20.0, 1e-3).float()
    else:
        dt.fill_(20.0)
    y, s = _scan_call(ssm_ops, (x, dt, bm, cm, A, s0))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ref_y, ref_s = _ssm_f64(x, dt, bm, cm, A, s0)
    assert rel_err(y, ref_y) <= SCAN_REL and rel_err(s, ref_s) <= SCAN_REL


def _chained(fn, args, at):
    s = args[-1].clone()
    parts = [fn(*(t[:, lo:hi].contiguous() for t in args[:4]), *args[4:-1], s)
             for lo, hi in ((0, at), (at, args[0].shape[1]))]
    torch.cuda.synchronize()
    return torch.cat(parts, 1), s


@pytest.mark.parametrize("dh,at,aligned", [(64, 256, True), (64, 128, True), (32, 320, True),
                                           (128, 224, True), (64, 200, False),
                                           (128, 300, False)])
def test_wkv_chunked_kernel_splits(dh, at, aligned, cuda_device):
    """Two chunked calls split at a multiple of the chunk length equal one
    call bit for bit; split elsewhere, within SCAN_REL."""
    assert (at % wkv_ops.chunk_len(dh) == 0) is aligned
    args = _on(cuda_device, wkv_inputs((2, 512, 3, dh), seed=12), bf16=(0, 1, 2, 4))
    full, s = _scan_call(wkv_ops, args)
    got, s2 = _chained(wkv_ops.wkv, args, at)
    if aligned:
        assert torch.equal(got, full) and torch.equal(s2, s)
    else:
        assert rel_err(got, full) <= SCAN_REL and rel_err(s2, s) <= SCAN_REL


@pytest.mark.parametrize("at,aligned", [(256, True), (128, True), (384, True), (200, False),
                                        (300, False)])
def test_ssm_chunked_kernel_splits(at, aligned, cuda_device):
    args = _on(cuda_device, ssm_inputs((2, 512, 5, 64, 16), seed=12), bf16=(0, 2, 3))
    full, s = _scan_call(ssm_ops, args)
    got, s2 = _chained(ssm_ops.ssm_scan, args, at)
    if aligned:
        assert torch.equal(got, full) and torch.equal(s2, s)
    else:
        assert rel_err(got, full) <= SCAN_REL and rel_err(s2, s) <= SCAN_REL


@pytest.mark.parametrize("S,dt,chunked", [(127, "bf16", False), (128, "bf16", True),
                                          (1, "bf16", False), (512, "f32", False),
                                          (512, "bf16", True)])
def test_scan_counters_follow_the_chunked_rule(S, dt, chunked, cuda_device):
    """@chunked advances only for bf16 calls of S >= 128; fp32 and short
    calls run the sequential body (and agree with its plain version)."""
    bf = dt == "bf16"
    a = _on(cuda_device, wkv_inputs((2, S, 3, 64), seed=13), bf16=(0, 1, 2, 4) if bf else ())
    x = _on(cuda_device, ssm_inputs((2, S, 3, 64, 16), seed=13), bf16=(0, 2, 3) if bf else ())
    for mod, args in ((wkv_ops, a), (ssm_ops, x)):
        fn = mod.wkv if mod is wkv_ops else mod.ssm_scan
        s = args[-1].clone()
        n0 = (mod.launches, mod.chunked_launches)
        out = fn(*args[:-1], s)
        torch.cuda.synchronize()
        assert (mod.launches, mod.chunked_launches) == (n0[0] + 1, n0[1] + chunked)
        plain = mod.wkv_plain if mod is wkv_ops else mod.ssm_scan_plain
        ref_o, ref_s = plain(*args)
        assert rel_err(out, ref_o) <= SCAN_REL and rel_err(s, ref_s) <= SCAN_REL


def test_scan_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    r, k, v, w, u, s = _on(cuda_device, wkv_inputs((1, 4, 2, 64)))
    with pytest.raises(TypeError):          # fp16 is not a kernel type
        wkv_ops.wkv(r.half(), k.half(), v.half(), w, u.half(), s)
    with pytest.raises(ValueError):         # dh 80 is not compiled
        wkv_ops.wkv(*_on(cuda_device, wkv_inputs((1, 4, 2, 80))))
    with pytest.raises(ValueError):         # the decay must be fp32
        wkv_ops.wkv(r, k, v, w.bfloat16(), u, s)
    with pytest.raises(ValueError):         # the state must be fp32
        wkv_ops.wkv(r, k, v, w, u, s.bfloat16())
    x, d, bm, cm, A, h = _on(cuda_device, ssm_inputs((1, 4, 2, 64, 65)))
    with pytest.raises(ValueError):         # N 65 > 64 registers
        ssm_ops.ssm_scan(x, d, bm, cm, A, h)
    x, d, bm, cm, A, h = _on(cuda_device, ssm_inputs((1, 4, 2, 96, 16)))
    with pytest.raises(ValueError):         # dh 96 is not compiled
        ssm_ops.ssm_scan(x, d, bm, cm, A, h)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_recurrent_model_kernel_path_vs_reference(arch, cuda_device):
    """The smoke configs on the card: the kernel path launches its scan
    once per layer per prefill and per decode step (Hymba also its flash
    and decode kernels), and its logits stay within bf16 noise of the
    reference math (impl="ref"), fed the reference's picks."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    scan = wkv_ops if arch == "rwkv6-3b" else ssm_ops
    L = cfg.n_layers
    out, fed = {}, []
    for impl in ("ref", "kernel"):
        n0 = (scan.launches, fa.launches, da.launches)
        cache = M.init_cache(cfg, 2, 64)
        lg, cache = M.prefill(cfg, params, toks.to(cuda_device), cache,
                              impl=impl)
        steps = [lg[:, -1].float()]
        for i in range(8):
            if impl == "ref":
                fed.append(lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True))
            lg, cache = M.decode_step(cfg, params, cache, fed[i], impl=impl)
            steps.append(lg[:, -1].float())
        out[impl] = torch.stack(steps)
        got = tuple(a - b for a, b in zip(
            (scan.launches, fa.launches, da.launches), n0))
        attn = (L, 8 * L) if arch == "hymba-1.5b" else (0, 0)
        assert got == (((9 * L,) + attn) if impl == "kernel" else (0, 0, 0))
    err = (out["kernel"] - out["ref"]).abs().max().item()
    assert err <= 0.05 * out["ref"].abs().max().item()


# ---------------------------------------------------------------------------
# The Hopper mainloop (csrc/attention_sm90.cuh): flash and the multi-query
# prefill regime. Each call must go through it (the wrappers' hopper
# counters) and agree with the plain version.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", FLASH_HOPPER_CASES,
                         ids=lambda c: f"Sq{c[1]}Skv{c[2]}H{c[3]}kv{c[4]}d{c[5]}"
                                       f"{'c' if c[6] else 'b'}w{c[7]}o{c[8]}")
def test_flash_hopper_mainloop_tile_edges(case, cuda_device):
    B, Sq, Skv, H, KV, dh, causal, window, q_offset = case
    rng = np.random.default_rng(7)
    q, k, v = (to_torch(np_rand(rng, shape, "bf16"), "bf16", cuda_device)
               for shape in ((B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh)))
    n0 = fa.hopper_launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.hopper_launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_HOPPER_CASES,
                         ids=lambda c: f"q{c[1]}S{c[2]}d{c[5]}p{c[6]}w{c[7]}-{c[8]}")
def test_mq_hopper_prefill_regime(case, cuda_device):
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    q, k, v, ids = mq_inputs(case, seed=2)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = mq.hopper_launches
    out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert mq.hopper_launches == n0 + 1
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_PAGED_HOPPER_CASES,
                         ids=lambda c: f"q{c[1]}ps{c[5]}w{c[8]}")
def test_mq_paged_hopper_prefill_regime(case, cuda_device):
    B, Q, H, KV, dh, ps, maxp, ctx, window = case
    q, k, v, bt, ctxn = _paged_on(cuda_device,
                                  *paged_inputs(B, Q, H, KV, dh, ps, maxp, ctx, seed=4))
    n0 = mq.paged_hopper_launches
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctxn, window=window)
    torch.cuda.synchronize()
    assert mq.paged_hopper_launches == n0 + 1
    ref = mq.mq_paged_decode_attention_plain(q, k, v, bt, ctxn, window=window)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_PAGED_HOPPER_CASES,
                         ids=lambda c: f"q{c[1]}ps{c[5]}w{c[8]}")
def test_mq_paged_hopper_bitwise_vs_mq_kernel(case, cuda_device):
    """5 equals 4 bit for bit on the gathered cache in the prefill regime:
    both take the Hopper mainloop, with one tile order and one tile
    content (empty slots' V rows zeroed in both)."""
    B, Q, H, KV, dh, ps, maxp, ctx, window = case
    c = max(ctx)
    q, k, v, bt, ctxn = _paged_on(cuda_device, *paged_inputs(
        B, Q, H, KV, dh, ps, maxp, (c,) * B, seed=5))
    h4, h5 = mq.hopper_launches, mq.paged_hopper_launches
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctxn, window=window)
    ids = torch.from_numpy(gathered_ids(maxp * ps, c)).to(cuda_device)
    ref = mq.mq_decode_attention(q, pg.gather_pages(k, bt).contiguous(),
                                 pg.gather_pages(v, bt).contiguous(), ids,
                                 c - Q, window=window)
    torch.cuda.synchronize()
    assert (mq.hopper_launches - h4, mq.paged_hopper_launches - h5) == (1, 1)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", MQ_PAGED_HOPPER_CASES,
                         ids=lambda c: f"q{c[1]}ps{c[5]}w{c[8]}")
def test_mq_paged_hopper_reads_only_filled_slots(case, cuda_device):
    """NaN in every page no table names and in every slot past ctx: the
    prefill regime must return the clean pool's output bit for bit."""
    B, Q, H, KV, dh, ps, maxp, ctx, window = case
    q, k, v, bt, ctxn = _paged_on(cuda_device,
                                  *paged_inputs(B, Q, H, KV, dh, ps, maxp, ctx, seed=6))
    dirty = torch.ones(k.shape[:2], dtype=torch.bool, device=cuda_device)
    for b, n in enumerate(ctx):
        t = torch.arange(n, device=cuda_device)
        dirty[bt[b, t // ps].long(), t % ps] = False
    kd, vd = k.clone(), v.clone()
    kd[dirty] = float("nan")
    vd[dirty] = float("nan")
    clean = mq.mq_paged_decode_attention(q, k, v, bt, ctxn, window=window)
    got = mq.mq_paged_decode_attention(q, kd, vd, bt, ctxn, window=window)
    assert torch.isfinite(got.float()).all() and torch.equal(got, clean)


# ----------------------------------------------------------------------------
# the Hopper decode body (decode_sm90_kernel: kernels 1 and 3)
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("case", DECODE_SM90_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}kv{c[3]}d{c[4]}p{c[5]}"
                                       f"w{c[6]}{'r' if c[7] else ''}")
def test_decode_sm90_kernel_vs_plain(case, cuda_device):
    """One launch a call, through the Hopper body; within BF16_REL of the
    plain version; two calls bit-equal (the cluster merges in a fixed
    order); a head that sees no slot outputs 0; kernel 4 at q_len 1 within
    BF16_REL of it."""
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case, seed=2)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = (da.launches, da.hopper_launches)
    out = da.decode_attention(q, k, v, ids, pos, window=window)
    again = da.decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert (da.launches, da.hopper_launches) == (n0[0] + 2, n0[1] + 2)
    assert torch.equal(out, again)
    ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL
    if pos < 0:
        assert torch.count_nonzero(out) == 0
    a = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    assert rel_err(a, out) <= BF16_REL


@pytest.mark.parametrize("shape", [(4, 1024, 64, 8, 128, 543, 300),
                                   (4, 1024, 25, 5, 64, 543, 1024),
                                   (1, 100, 16, 2, 80, 60, 32)],
                         ids=["llama", "hymba", "dh80"])
def test_decode_sm90_reads_only_visible_slots(shape, cuda_device):
    """NaN in every slot that is not visible (past pos, before the window,
    never written): the output must equal the clean cache's bit for bit."""
    B, S_c, H, KV, dh, pos, window = shape
    q, k, v, ids = decode_inputs((B, S_c, H, KV, dh, pos, window, False), seed=4)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    hidden = (ids < 0) | (ids > pos) | (pos - ids >= window)
    kd, vd = k.clone(), v.clone()
    kd[:, hidden] = float("nan")
    vd[:, hidden] = float("nan")
    clean = da.decode_attention(q, k, v, ids, pos, window=window)
    got = da.decode_attention(q, kd, vd, ids, pos, window=window)
    assert torch.isfinite(got.float()).all() and torch.equal(got, clean)


@pytest.mark.parametrize("case", PAGED_SM90_CASES,
                         ids=lambda c: f"H{c[1]}kv{c[2]}d{c[3]}ps{c[4]}w{c[7]}")
def test_paged_sm90_kernel(case, cuda_device):
    """Kernel 3 through the Hopper body at page sizes 8, 24 and 64: one
    launch, within BF16_REL of its plain version over ragged ctx; NaN in
    unallocated pages and past ctx changes nothing; and with a uniform ctx
    bit-equal to kernel 1 on the gathered cache."""
    B, H, KV, dh, ps, maxp, ctx, window = case
    q, k, v, bt, ctxn = _paged_on(cuda_device, *paged_case_inputs(case, seed=7))
    n0 = (pg.launches, pg.hopper_launches)
    out = pg.paged_decode_attention(q, k, v, bt, ctxn, window=window)
    torch.cuda.synchronize()
    assert (pg.launches, pg.hopper_launches) == (n0[0] + 1, n0[1] + 1)
    ref = pg.paged_decode_attention_plain(q, k, v, bt, ctxn, window=window)
    assert rel_err(out, ref) <= BF16_REL
    dirty = torch.ones(k.shape[:2], dtype=torch.bool, device=cuda_device)
    for b, n in enumerate(ctx):
        t = torch.arange(n, device=cuda_device)
        dirty[bt[b, t // ps].long(), t % ps] = False
    kd, vd = k.clone(), v.clone()
    kd[dirty] = float("nan")
    vd[dirty] = float("nan")
    got = pg.paged_decode_attention(q, kd, vd, bt, ctxn, window=window)
    assert torch.isfinite(got.float()).all() and torch.equal(got, out)
    (q, k, v, bt, ctxn), _ = _uniform(case, 1)
    q, k, v, bt, ctxn = _paged_on(cuda_device, q, k, v, bt, ctxn)
    c = int(ctxn[0])
    out = pg.paged_decode_attention(q, k, v, bt, ctxn, window=window)
    ids = torch.from_numpy(gathered_ids(maxp * ps, c)).to(cuda_device)
    ref = da.decode_attention(q, pg.gather_pages(k, bt).contiguous(),
                              pg.gather_pages(v, bt).contiguous(), ids, c - 1,
                              window=window)
    assert torch.equal(out, ref)


# ----------------------------------------------------------------------------
# the verify body (verify_sm90_kernel: kernels 4 and 5 at q_len·G <= 128)
# ----------------------------------------------------------------------------
def _verify_counts():
    return (mq.launches, mq.verify_sm90_launches, mq.hopper_launches,
            mq.paged_launches, mq.paged_verify_sm90_launches)


@pytest.mark.parametrize("case", VERIFY_SM90_CASES,
                         ids=lambda c: f"B{c[0]}q{c[1]}S{c[2]}H{c[3]}kv{c[4]}d{c[5]}"
                                       f"p{c[6]}w{c[7]}-{c[8]}")
def test_verify_sm90_kernel_vs_plain(case, cuda_device):
    """One launch a call, through the verify body; within BF16_REL of the
    plain version; two calls bit-equal (the cluster merges in a fixed
    order); rows that see nothing output 0; at q_len 1 within BF16_REL of
    kernel 1."""
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    q, k, v, ids = mq_inputs(case, seed=8)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = _verify_counts()
    out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    again = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert _verify_counts() == (n0[0] + 2, n0[1] + 2, n0[2], n0[3], n0[4])
    assert torch.equal(out, again)
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL
    if kind == "masked":
        assert torch.count_nonzero(out) == 0
    if Q == 1:
        one = da.decode_attention(q, k, v, ids, pos, window=window)
        assert rel_err(out, one) <= BF16_REL


@pytest.mark.parametrize("case", [VERIFY_SM90_CASES[i] for i in (0, 1, 3, 9, 12)],
                         ids=["main", "sporadic", "stale", "q9", "ring-w5"])
def test_verify_sm90_reads_only_visible_slots(case, cuda_device):
    """NaN in every slot no row sees (empty, past the last row's position,
    before the window): the output must equal the clean cache's bit for
    bit."""
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    q, k, v, ids = mq_inputs(case, seed=9)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    w = 2 ** 30 if window is None else window
    hidden = (ids < 0) | (ids > pos + Q - 1) | (pos - ids >= w)
    kd, vd = k.clone(), v.clone()
    kd[:, hidden] = float("nan")
    vd[:, hidden] = float("nan")
    clean = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    got = mq.mq_decode_attention(q, kd, vd, ids, pos, window=window)
    assert torch.isfinite(got.float()).all() and torch.equal(got, clean)


@pytest.mark.parametrize("case", MQ_PAGED_VERIFY_CASES,
                         ids=lambda c: f"B{c[0]}q{c[1]}kv{c[3]}d{c[4]}ps{c[5]}w{c[8]}")
def test_paged_verify_sm90_kernel(case, cuda_device):
    """Kernel 5 through the verify body: one launch, within BF16_REL of its
    plain version over ragged ctx; NaN in unallocated pages and past ctx
    changes nothing; two calls bit-equal; and with a uniform ctx bit-equal
    to kernel 4 on the gathered cache (5 == 4)."""
    B, Q, H, KV, dh, ps, maxp, ctx, window = case
    q, k, v, bt, ctxn = _paged_on(cuda_device, *paged_inputs(
        B, Q, H, KV, dh, ps, maxp, ctx, seed=10))
    n0 = _verify_counts()
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctxn, window=window)
    again = mq.mq_paged_decode_attention(q, k, v, bt, ctxn, window=window)
    torch.cuda.synchronize()
    assert _verify_counts() == (n0[0], n0[1], n0[2], n0[3] + 2, n0[4] + 2)
    assert torch.equal(out, again)
    ref = mq.mq_paged_decode_attention_plain(q, k, v, bt, ctxn, window=window)
    assert rel_err(out, ref) <= BF16_REL
    dirty = torch.ones(k.shape[:2], dtype=torch.bool, device=cuda_device)
    for b, n in enumerate(ctx):
        t = torch.arange(n, device=cuda_device)
        dirty[bt[b, t // ps].long(), t % ps] = False
    kd, vd = k.clone(), v.clone()
    kd[dirty] = float("nan")
    vd[dirty] = float("nan")
    got = mq.mq_paged_decode_attention(q, kd, vd, bt, ctxn, window=window)
    assert torch.isfinite(got.float()).all() and torch.equal(got, out)
    c = max(ctx)
    q, k, v, bt, ctxn = _paged_on(cuda_device, *paged_inputs(
        B, Q, H, KV, dh, ps, maxp, (c,) * B, seed=11))
    n0 = _verify_counts()
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctxn, window=window)
    ids = torch.from_numpy(gathered_ids(maxp * ps, c)).to(cuda_device)
    ref = mq.mq_decode_attention(q, pg.gather_pages(k, bt).contiguous(),
                                 pg.gather_pages(v, bt).contiguous(), ids,
                                 c - Q, window=window)
    torch.cuda.synchronize()
    assert _verify_counts() == (n0[0] + 1, n0[1] + 1, n0[2], n0[3] + 1, n0[4] + 1)
    assert torch.equal(out, ref)


def _misaligned(a, device):
    """A contiguous bf16 copy of numpy array a whose base is 2 bytes past a
    16-byte boundary: rows the kernels cannot read in 16-byte vectors."""
    flat = torch.empty(a.size + 8, dtype=torch.bfloat16, device=device)
    t = flat[1:1 + a.size].view(a.shape)
    t.copy_(to_torch(a, "bf16", device))
    return t


@pytest.mark.parametrize("case,aligned", [
    ((2, 5, 300, 8, 2, 256, 290, None, "stale"), True),     # dh 256, 5 splits
    ((1, 130, 300, 8, 2, 256, 100, 64, "linear"), True),    # dh 256, 9 row tiles
    ((2, 5, 300, 16, 2, 128, 290, 100, "linear"), False),   # unaligned rows
    ((1, 3, 64, 4, 4, 64, 50, None, "masked"), False),      # G 1, nothing seen
], ids=["dh256", "dh256-rows", "unaligned", "unaligned-masked"])
def test_mq_mma_body(case, aligned, cuda_device):
    """The mma.sync body (dh > 128, unaligned rows): one launch merging its
    splits in a cluster, neither the verify body nor the mainloop; within
    BF16_REL of the plain version; two calls bit-equal."""
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    qn, kn, vn, ids = mq_inputs(case, seed=12)
    if aligned:
        q, k, v = (to_torch(a, "bf16", cuda_device) for a in (qn, kn, vn))
    else:
        q, k, v = (_misaligned(a, cuda_device) for a in (qn, kn, vn))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = _verify_counts()
    out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    again = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert _verify_counts() == (n0[0] + 2,) + n0[1:]
    assert torch.equal(out, again)
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL
    if kind == "masked":
        assert torch.count_nonzero(out) == 0


# ----------------------------------------------------------------------------
# the MoE family on the card (models/moe.py has no kernel of its own: its
# router, grouping and batched expert products are torch ops)
# ----------------------------------------------------------------------------
def test_moe_layer_on_card_routes_as_on_cpu(cuda_device):
    """The MoE layer of the smoke DeepSeekMoE config on the card, with TF32
    switched on around it: the router's product stays full fp32 (the
    routes equal the CPU's, which takes no TF32), the capacity drops fall
    on the same slots, each token's output within 2^-6 of its largest
    value, aux equal."""
    from repro_torch.models import moe
    cfg = get_smoke_config("deepseek-moe-16b")
    spec = moe.moe_specs(cfg.d_model, 16, cfg.moe_d_ff, cfg.n_shared_experts)
    cfg = dataclasses.replace(cfg, n_experts=16, top_k=6)
    gen = torch.Generator().manual_seed(3)
    from repro_torch.models import spec as pspec
    p_cpu = pspec.init(spec, gen, torch.device("cpu"))
    p_cpu["router"] = p_cpu["router"] * 20     # spread the router's logits
    x = torch.randn((4, 32, cfg.d_model), generator=gen).to(torch.bfloat16)
    ref, aux_ref = moe.moe_forward(p_cpu, x, cfg=cfg)
    p_gpu = {k: ({n: t.to(cuda_device) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(cuda_device))
             for k, v in p_cpu.items()}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out, aux = moe.moe_forward(p_gpu, x.to(cuda_device), cfg=cfg)
        _, ids, _ = moe._route(p_gpu["router"], x.to(cuda_device).reshape(
            -1, cfg.d_model), cfg.top_k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _, ids_ref, _ = moe._route(p_cpu["router"], x.reshape(-1, cfg.d_model),
                               cfg.top_k)
    assert torch.equal(ids.cpu(), ids_ref)
    cap = moe.capacity(128, 6, 16, 1.25)
    assert not moe._group_tokens(ids_ref, cap, 16)[2].all()     # drops
    out, ref = out.float().cpu().reshape(128, -1), ref.float().reshape(128, -1)
    assert ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max() <= BF16_REL
    assert abs(aux.item() - aux_ref.item()) <= 1e-5 * abs(aux_ref.item())


def test_moe_folded_engine_matches_model_on_card(cuda_device):
    """The folded smoke DeepSeekMoE stack (4 MoE layers, 2 of them
    streamed) through the engine on the card: chunked prefill, decode and
    verify bit-equal to the model on the same weights, the streamed fp32
    routers read back bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"), n_layers=4,
                              first_dense_layers=0)
    params = M.init_params(cfg, device=cuda_device)
    eng = InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), mb=2, max_len=64,
                            device=cuda_device)
    st = eng.init_state(params)
    for l in range(cfg.n_layers):
        views = eng._res_views.get(l)
        if views is None:
            s, h = np.argwhere(eng._off_ids[:, 0] == l)[0]
            views = eng._views(eng._store.data[s, h].to(cuda_device))
        assert views["moe"]["router"].dtype == torch.float32
        assert torch.equal(views["moe"]["router"],
                           params["layers"]["moe"]["router"][l])
    toks = torch.randint(1, cfg.vocab_size, (2, 12), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(0))
    mc = M.init_cache(cfg, 2, 64, device=cuda_device)
    el, st = eng.prefill_partial(st, toks, chunk=6)
    for off in (0, 6):
        ml, mc = M.verify_step(cfg, params, mc, toks[:, off:off + 6], impl="kernel")
    assert torch.equal(el, ml)
    tok = ml[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    el, st = eng.decode_step(st, tok)
    ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel")
    assert torch.equal(el, ml[:, 0])
    mat = torch.cat([tok, toks[:, :3]], 1)
    el, st = eng.verify_step(st, mat)
    ml, mc = M.verify_step(cfg, params, mc, mat, impl="kernel")
    assert torch.equal(el, ml)
    eng.close()


# ----------------------------------------------------------------------------
# the encoder-decoder family (SeamlessM4T-medium) on the card
# ----------------------------------------------------------------------------
def _encdec(n_layers, n_encoder_layers, device):
    """SeamlessM4T-medium at full width, depth cut, its stacked matrices at
    std 1/sqrt(d_model) (at the stacked fan-in quirk's 1/sqrt(L) every
    softmax is one-hot and any two roundings part: chip_smoke.py's
    encdec_params)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("seamless-m4t-medium"), n_layers=n_layers,
                              n_encoder_layers=n_encoder_layers)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
    for stack, n in (("layers", n_layers), ("encoder", n_encoder_layers)):
        for t in M._tensors(params[stack]):
            if t.dim() >= 3:
                t.mul_((n / cfg.d_model) ** 0.5)
    return cfg, params


@pytest.mark.parametrize("kernel", ["flash bidirectional", "decode cross"])
def test_encdec_kernel_shapes_vs_plain(kernel, cuda_device):
    """Phase 3h's shapes (B 4, 512 frames, 16 heads = 16 KV heads x 64):
    kernel 2 with causal=False (the encoder and the cross prefill), and
    kernel 1 through the cross-attention's kernel route (pos 511, every
    frame visible), with a key at frame 0 aligned with the query: within
    BF16_REL of the plain versions; the reference's pos 2^30 in the
    kernel's window arithmetic (frame 0 dropped) is not."""
    from repro_torch.models import attention as A
    g = torch.Generator(cuda_device).manual_seed(5)
    B, S, H, dh = 4, 512, 16, 64

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
    if kernel.startswith("flash"):
        q, k, v = rnd(B, S, H, dh), rnd(B, S, H, dh), rnd(B, S, H, dh)
        h0 = fa.hopper_launches
        out = fa.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        assert fa.hopper_launches == h0 + 1
        ref = fa.flash_attention_plain(q, k, v, causal=False)
        assert rel_err(out, ref) <= BF16_REL
        assert rel_err(fa.flash_attention_plain(q, k, v, causal=True), ref) > BF16_REL
        return
    q, k, v = rnd(B, 1, H, dh), rnd(B, S, H, dh), rnd(B, S, H, dh)
    k[:, 0] = (q[:, 0].float() * 0.75).to(torch.bfloat16)
    ids = A.cross_pos_ids(S, S, q.device)
    h0 = da.hopper_launches
    out = da.decode_attention(q, k, v, ids, S - 1)
    torch.cuda.synchronize()
    assert da.hopper_launches == h0 + 1
    ref = da.decode_attention_plain(q, k, v, ids, A.CROSS_POS)   # the reference's call
    assert rel_err(out, ref) <= BF16_REL
    dropped = da.decode_attention_plain(q, k, v, ids, A.CROSS_POS,
                                        window=da.GLOBAL_WINDOW)
    assert rel_err(dropped, ref) > BF16_REL


def test_encdec_model_kernel_path_vs_reference(cuda_device):
    """SeamlessM4T-medium at full width cut to 2 + 2 layers: encode ->
    seed_cross_kv -> prefill -> 6 decode steps, the kernel path fed the
    reference's picks: exact launches (flash 2 in the encoder, 4 in the
    prompt pass; kernel 1 4 a step, all on the Hopper bodies) and logits
    within 5% of |logit| max."""
    cfg, params = _encdec(2, 2, cuda_device)
    g = torch.Generator(cuda_device).manual_seed(1)
    fe = torch.randn((2, 128, cfg.d_model), generator=g, device=cuda_device)
    toks = torch.randint(1, cfg.vocab_size, (2, 64), generator=g, device=cuda_device)
    out, fed = {}, []
    for impl in ("ref", "kernel"):
        f0, d0, h0 = fa.launches, da.launches, fa.hopper_launches + da.hopper_launches
        enc = M.encode(cfg, params, fe, impl=impl)
        cache = M.seed_cross_kv(cfg, params, M.init_cache(cfg, 2, 128, enc_out=enc), enc)
        lg, cache = M.prefill(cfg, params, toks, cache, impl=impl)
        steps = [lg[:, -1, :cfg.vocab_size].float()]
        for i in range(6):
            if impl == "ref":
                fed.append(steps[-1].argmax(-1, keepdim=True))
            lg, cache = M.decode_step(cfg, params, cache, fed[i], impl=impl,
                                      enc_len=128)
            steps.append(lg[:, -1, :cfg.vocab_size].float())
        torch.cuda.synchronize()
        out[impl] = torch.stack(steps)
        launched = (fa.launches - f0, da.launches - d0,
                    fa.hopper_launches + da.hopper_launches - h0)
        assert launched == ((6, 24, 30) if impl == "kernel" else (0, 0, 0))
    err = (out["kernel"] - out["ref"]).abs().max().item()
    assert err <= 0.05 * out["ref"].abs().max().item()


def test_encdec_engine_matches_model_on_card(cuda_device):
    """SeamlessM4T-medium at full width, 4 decoder layers (2 streamed from
    pinned memory) and 2 encoder layers: the engine's encoder, prompt pass
    over the tiers and decode steps, across a retier round trip, equal
    the model's kernel path bit for bit."""
    cfg, params = _encdec(4, 2, cuda_device)
    g = torch.Generator(cuda_device).manual_seed(2)
    fe = torch.randn((2, 128, cfg.d_model), generator=g, device=cuda_device)
    toks = torch.randint(1, cfg.vocab_size, (2, 64), generator=g, device=cuda_device)
    eng = InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), mb=2, max_len=128,
                            retier_headroom=1, enc_len=128)
    st = eng.init_state(params)
    assert eng._store.registered
    enc = eng.encode(fe)
    assert torch.equal(enc, M.encode(cfg, params, fe, impl="kernel"))
    el, cache = eng.prefill(toks, enc_out=enc)
    mc = M.seed_cross_kv(cfg, params, M.init_cache(cfg, 2, 128, enc_out=enc), enc)
    ml, mc = M.prefill(cfg, params, toks, mc, impl="kernel")
    assert torch.equal(el, ml)
    assert all(torch.equal(cache[k], mc[k]) for k in ("k", "v", "xk", "xv"))
    st = eng.seed_cache(st, cache)
    tok = ml[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for step in range(4):
        if step in (1, 3):
            eng.retier(st, 0, +1 if step == 1 else -1)
        el, st = eng.decode_step(st, tok)
        ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel", enc_len=128)
        assert torch.equal(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    eng.close()


# ----------------------------------------------------------------------------
# captured steps (core/capture.py): CUDA graphs replayed per token
# ----------------------------------------------------------------------------
N_REPLAYED = 64


def _clone(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def _counted(fn):
    """(fn(), the launch counters' advance over it)."""
    from repro_torch.core import capture
    c0 = capture.launch_counts()
    out = fn()
    c1 = capture.launch_counts()
    return out, {k: v - c0[k] for k, v in c1.items() if v != c0[k]}


def _same_step(eager, captured):
    """One step both ways: logits bit-equal, launch counts equal."""
    a, na = _counted(eager)
    b, nb = _counted(captured)
    assert torch.equal(a, b)
    assert na == nb and na, (na, nb)
    return a


def _smoke_model(arch, device, **over):
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    return cfg, params


def _prefilled(cfg, params, device, B=2, S=12, max_len=48):
    g = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (B, S), device=device, generator=g)
    cache = M.init_cache(cfg, B, max_len, device=device)
    kw = {}
    if cfg.family.value == "encdec":
        enc = torch.randn((B, 8, cfg.d_model), device=device,
                          generator=g).bfloat16()
        M.prefill(cfg, params, toks, cache, impl="kernel", enc_out=enc)
        kw["enc_len"] = 8
    else:
        M.prefill(cfg, params, toks, cache, impl="kernel")
    return cache, kw


@pytest.mark.parametrize("arch,over", [
    ("llama3.3-70b", {}), ("gemma3-1b", {"window_size": 6}),
    ("deepseek-moe-16b", {}), ("rwkv6-3b", {}), ("hymba-1.5b", {}),
    ("seamless-m4t-medium", {})], ids=lambda v: v if isinstance(v, str) else "")
def test_captured_decode_step_is_the_eager_step(arch, over, cuda_device):
    """65 decode steps (past the 48-slot ring's wrap) eagerly and through
    one captured graph (64 replays) from the same state: logits, caches
    and launch counts equal bit for bit; the capture ran under sync debug
    mode "error"."""
    from repro_torch.core.capture import CapturedStep
    cfg, params = _smoke_model(arch, cuda_device, **over)
    a, kw = _prefilled(cfg, params, cuda_device)
    b = _clone(a)
    steps = CapturedStep(cuda_device)
    tok = torch.ones((2, 1), dtype=torch.long, device=cuda_device)
    for _ in range(N_REPLAYED + 1):
        lg = _same_step(
            lambda: M.decode_step(cfg, params, a, tok, impl="kernel", **kw)[0],
            lambda: M.decode_step(cfg, params, b, tok, impl="kernel",
                                  steps=steps, **kw)[0])
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    assert (steps.captures, steps.replays) == (1, N_REPLAYED)
    assert steps.pool_bytes() > 0
    for k, v in a.items():
        assert torch.equal(v, b[k]) if isinstance(v, torch.Tensor) \
            else v == b[k], k


@pytest.mark.parametrize("arch", ["llama3.3-70b", "deepseek-moe-16b"])
def test_captured_verify_step_is_the_eager_step(arch, cuda_device):
    """64 verify rounds of q_len 2..5 in turn (one graph each), each
    committing one position: logits and counts equal, four captures."""
    from repro_torch.core.capture import CapturedStep
    cfg, params = _smoke_model(arch, cuda_device)
    a, _ = _prefilled(cfg, params, cuda_device, max_len=128)
    b = _clone(a)
    steps = CapturedStep(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for r in range(N_REPLAYED + 4):
        mat = torch.randint(1, cfg.vocab_size, (2, 2 + r % 4), device=cuda_device,
                            generator=g)
        p0 = a["pos"]
        _same_step(lambda: M.verify_step(cfg, params, a, mat, impl="kernel")[0],
                   lambda: M.verify_step(cfg, params, b, mat, impl="kernel",
                                         steps=steps)[0])
        a["pos"] = b["pos"] = p0 + 1
    assert (steps.captures, steps.replays) == (4, N_REPLAYED)
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["pos_ids"], b["pos_ids"])


def test_captured_paged_steps_are_the_eager_steps(cuda_device):
    """The paged cache's decode step and verify rounds (q_len 2..4, commit
    one) through their graphs, 64 replays, across page boundaries (block
    table refreshed in place): logits and counts equal, tables and pools
    equal."""
    from repro_torch.core.capture import CapturedStep
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    cfg, params = _smoke_model("llama3.3-70b", cuda_device)
    dense, _ = _prefilled(cfg, params, cuda_device, max_len=160)

    def make():
        pc = PagedDecodeCache(cfg, 2, 160, page_size=8, impl="kernel",
                              device=cuda_device)
        pc.seed(dense)
        return pc
    a, b = make(), make()
    steps = CapturedStep(cuda_device)
    tok = torch.ones((2, 1), dtype=torch.long, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for r in range(N_REPLAYED // 2 + 2):        # 4 captures, 64 replays
        lg = _same_step(lambda: a.step(params, tok),
                        lambda: b.step(params, tok, steps=steps))
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        mat = torch.cat([tok, torch.randint(1, cfg.vocab_size, (2, 1 + r % 3),
                                            device=cuda_device, generator=g)], 1)
        _same_step(lambda: a.verify(params, mat),
                   lambda: b.verify(params, mat, steps=steps))
        a.commit(1)
        b.commit(1)
    assert (steps.captures, steps.replays) == (4, N_REPLAYED)
    assert [t.pages for t in a.tables] == [t.pages for t in b.tables]
    assert torch.equal(a.k_pool, b.k_pool)


def test_captured_engine_draft_is_the_eager_draft(cuda_device):
    """The engine's resident-only draft step, 64 replays in rounds of 4
    drafts and a rollback, across a retier (a new layout: captured again),
    against an engine that drafts eagerly on the same weights."""
    from repro_torch.core.capture import CapturedStep
    cfg, params = _smoke_model("llama3.3-70b", cuda_device, n_layers=4)
    engs = [InterleavedEngine(cfg, UniformPlan(1, 2, 2, 1), mb=2, max_len=128,
                              retier_headroom=1, device=cuda_device)
            for _ in range(2)]
    ds = CapturedStep(cuda_device)
    sts = [e.init_state(params) for e in engs]
    toks = torch.randint(1, cfg.vocab_size, (2, 10), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(0))
    for e, s in zip(engs, sts):
        e.prefill_partial(s, toks, chunk=5)
    tok = torch.ones((2, 1), dtype=torch.long, device=cuda_device)
    for r in range(N_REPLAYED // 4 + 2):
        if r == 6:
            for e, s in zip(engs, sts):
                e.retier(s, 0, +1)
        p0 = sts[0]["pos"]
        for _ in range(4):
            lg = _same_step(lambda: engs[0].draft_step(sts[0], tok)[0],
                            lambda: engs[1].draft_step(sts[1], tok,
                                                       steps=ds)[0])
            tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        for e, s in zip(engs, sts):
            e.rollback(s, p0 + 1)
    assert ds.captures == 2 and ds.replays >= N_REPLAYED
    for e in engs:
        e.close()


def test_captured_spec_serves_are_the_eager_serves(cuda_device):
    """Speculative serves whose k changes (the cap at the cache's end) with
    n-gram, small-model and host resident drafts (the model drafts' steps
    captured too), dense and paged, captured and eager: tokens, rounds
    and launch counts equal."""
    from repro_torch.serving import cli_arrivals
    from repro_torch.specdec import SpecConfig
    cfg, params = _smoke_model("llama3.3-70b", cuda_device)
    prompts = [np.random.default_rng(i).integers(1, cfg.vocab_size, 20)
               .astype(np.int32) for i in range(2)]
    for draft, paged in (("ngram", False), ("model", False),
                         ("resident", False), ("ngram", True)):
        spec = SpecConfig(k=4, draft=draft, resident_layers=1)
        got = []
        for capture in (False, True):
            srv = LimeServer(cfg, params, max_len=64, pattern="bursty",
                             spec=spec, prefix_cache=paged, page_size=8,
                             capture=capture, device=cuda_device)
            for ev, p in zip(cli_arrivals("bursty", 2, prompt_len=20,
                                          max_new_tokens=44,
                                          burst_size=srv.slots), prompts):
                srv.queue.submit(p, ev.max_new_tokens, now=ev.time_s)
            done, n = _counted(srv.serve_all)
            be = srv.make_backend()
            got.append(([r.output for r in sorted(done, key=lambda r: r.rid)],
                        list(be.rounds), n))
            if capture:
                assert be.graph_stats["replays"] > 0, draft
        assert got[0] == got[1], draft
        assert len({k for k, _ in got[1][1] if k}) > 1, got[1][1]   # k changed


def test_a_stale_position_buffer_breaks_bit_equality(cuda_device):
    """A planted fault: replays whose position buffer keeps the captured
    position. The comparison with the eager step rejects them."""
    from repro_torch.core.capture import CapturedStep

    class StaleSteps(CapturedStep):
        @staticmethod
        def _feed(e, tokens, pos):
            e.tokens.copy_(tokens)
            if e.graph is None:
                e.pos.fill_(pos)
    cfg, params = _smoke_model("llama3.3-70b", cuda_device)
    a, _ = _prefilled(cfg, params, cuda_device)
    b = _clone(a)
    steps = StaleSteps(cuda_device)
    tok = torch.ones((2, 1), dtype=torch.long, device=cuda_device)
    same = []
    for _ in range(4):
        la = M.decode_step(cfg, params, a, tok, impl="kernel")[0]
        lb = M.decode_step(cfg, params, b, tok, impl="kernel", steps=steps)[0]
        same.append(torch.equal(la, lb))
    assert same[0] and not any(same[1:]), same


def test_int_positions_are_refused_under_capture(cuda_device):
    """A host int position would be frozen into a graph: kernels 1 and 4
    refuse one while the stream captures; kernel 4's prefill-round
    mainloop given a device position captures (its TMA descriptors are
    kernel parameters, kept by value) and its replay equals the eager
    call bit for bit."""
    q = torch.randn((1, 1, 8, 64), device=cuda_device).bfloat16()
    k = torch.randn((1, 256, 2, 64), device=cuda_device).bfloat16()
    ids = torch.arange(256, dtype=torch.int32, device=cuda_device)
    pos = torch.full((), 100, dtype=torch.int32, device=cuda_device)
    q_pf = torch.randn((1, 64, 8, 64), device=cuda_device).bfloat16()
    da.decode_attention(q, k, k, ids, pos)
    mq.mq_decode_attention(q_pf, k, k, ids, pos)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    for call in (lambda: da.decode_attention(q, k, k, ids, 100),
                 lambda: mq.mq_decode_attention(q_pf, k, k, ids, 100)):
        g = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="captur"):
            with torch.cuda.graph(g, stream=s):
                call()
    n0 = mq.hopper_launches
    g, out = _graph_of(lambda: mq.mq_decode_attention(q_pf, k, k, ids, pos))
    assert mq.hopper_launches == n0 + 2          # warm-up and capture
    pos.fill_(150)
    g.replay()
    assert torch.equal(out, mq.mq_decode_attention(q_pf, k, k, ids, pos))


# ----------------------------------------------------------------------------
# captured prefills and streamed passes (the Hopper mainloop of kernels 2,
# 4 and 5 and the chunked scans 6 and 7 inside a graph)
# ----------------------------------------------------------------------------
def _graph_of(fn):
    """(graph, static output) of fn() captured after an eager warm-up on
    the capture stream, as core/capture.py captures a step."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out = fn()
    torch.cuda.synchronize()
    return g, out


def _refill(static, fresh):
    """New values into the graph's inputs, at the same addresses."""
    for t, v in zip(static, fresh):
        t.copy_(v)


@pytest.mark.parametrize("kernel", ["flash", "mq", "mq_paged"])
def test_captured_hopper_mainloop_is_the_eager_call(kernel, cuda_device):
    """Kernels 2, 4 and 5 at prefill shapes (the Hopper mainloop, as the
    counters say) inside one CUDA graph each: replayed after the inputs'
    contents change at the same addresses (new q, a cache holding other
    K/V), and for 4 and 5 at a second position (ctx), each replay
    bit-equal to an eager call on the same inputs."""
    rng = np.random.default_rng(31)
    if kernel == "flash":
        shapes = ((4, 512, 64, 128), (4, 512, 8, 128), (4, 512, 8, 128))

        def call(q, k, v):
            return fa.flash_attention(q, k, v, causal=True)
        feeds = [[to_torch(np_rand(rng, sh, "bf16"), "bf16", cuda_device)
                  for sh in shapes] for _ in range(3)]
        counter = (fa, "hopper_launches")
    elif kernel == "mq":
        cases = [(4, 128, 1024, 64, 8, 128, 891, None, "linear"),
                 (4, 128, 1024, 64, 8, 128, 300, None, "stale"),
                 (4, 128, 1024, 64, 8, 128, 600, None, "linear")]
        feeds = []
        for i, c in enumerate(cases):
            q, k, v, ids = mq_inputs(c, seed=i)
            feeds.append([to_torch(a, "bf16", cuda_device) for a in (q, k, v)]
                         + [torch.from_numpy(ids).to(cuda_device),
                            torch.full((), c[6], dtype=torch.int32,
                                       device=cuda_device)])

        def call(q, k, v, ids, pos):
            return mq.mq_decode_attention(q, k, v, ids, pos)
        counter = (mq, "hopper_launches")
    else:
        B, Q, H, KV, dh, ps, maxp = 4, 128, 64, 8, 128, 64, 16
        ctx0 = (1019, 700, 300, 130)
        q, k, v, bt, ctx = _paged_on(cuda_device, *paged_inputs(
            B, Q, H, KV, dh, ps, maxp, ctx0, seed=4))
        feeds = [[q, k, v, bt, ctx]]
        for i, c in enumerate(((1000, 650, 290, 129), (1019, 700, 300, 130))):
            feeds.append([to_torch(np_rand(rng, t.shape, "bf16"), "bf16",
                                   cuda_device) for t in (q, k, v)]
                         + [bt, torch.tensor(c, dtype=torch.int32,
                                             device=cuda_device)])

        def call(q, k, v, bt, ctx):
            return mq.mq_paged_decode_attention(q, k, v, bt, ctx)
        counter = (mq, "paged_hopper_launches")
    static = [t.clone() for t in feeds[0]]
    n0 = getattr(*counter)
    g, out = _graph_of(lambda: call(*static))
    assert getattr(*counter) == n0 + 2
    for fresh in feeds[1:] + feeds[:1]:
        _refill(static, fresh)
        g.replay()
        assert torch.equal(out, call(*static)), kernel


@pytest.mark.parametrize("kind,S", [("wkv", 512), ("wkv", 1), ("ssm", 512),
                                    ("ssm", 1)])
def test_captured_scans_are_the_eager_calls(kind, S, cuda_device):
    """Kernels 6 and 7 inside a CUDA graph at the prefill shape (S 512:
    the chunked body, its exchange buffer from the graph's pool) and the
    decode shape (S 1: the sequential body): three replays on new inputs
    and states at the same addresses, outputs and final states bit-equal
    to eager calls on copies."""
    mod = wkv_ops if kind == "wkv" else ssm_ops
    fn = mod.wkv if kind == "wkv" else mod.ssm_scan
    bf16_at = (0, 1, 2, 4) if kind == "wkv" else (0, 2, 3)

    def inputs(seed):
        a = (wkv_inputs((4, S, 40, 64), seed=seed) if kind == "wkv"
             else ssm_inputs((4, S, 25, 64, 16), seed=seed))
        return [to_torch(x, "bf16" if i in bf16_at else "f32", cuda_device)
                for i, x in enumerate(a)]
    static = inputs(0)
    n0 = mod.chunked_launches
    g, out = _graph_of(lambda: fn(*static))
    assert mod.chunked_launches - n0 == (2 if S >= 128 else 0)
    for seed in (1, 2, 3):
        _refill(static, inputs(seed))
        eager_args = [t.clone() for t in static]
        g.replay()
        want = fn(*eager_args)
        assert torch.equal(out, want) and torch.equal(static[-1], eager_args[-1])


@pytest.mark.parametrize("arch", ["llama3.3-70b", "deepseek-moe-16b",
                                  "rwkv6-3b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_captured_prefill_is_the_eager_prefill(arch, cuda_device):
    """M.prefill of 128-token prompts (flash on the Hopper mainloop, the
    scans on their chunked bodies) through one captured graph, three
    prompts (three encoder outputs) into a cache cleared in place,
    against eager prefills on a twin: logits, caches and launch counts
    bit for bit; one capture, two replays."""
    from repro_torch.core.capture import CapturedStep
    cfg, params = _smoke_model(arch, cuda_device)
    a = M.init_cache(cfg, 2, 256, device=cuda_device)
    b = M.init_cache(cfg, 2, 256, device=cuda_device)
    steps = CapturedStep(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for _ in range(3):
        toks = torch.randint(1, cfg.vocab_size, (2, 128), device=cuda_device,
                             generator=g)
        kw = {}
        if cfg.family.value == "encdec":
            kw["enc_out"] = torch.randn((2, 64, cfg.d_model), device=cuda_device,
                                        generator=g).bfloat16()
        M.clear_cache(a)
        M.clear_cache(b)
        _same_step(lambda: M.prefill(cfg, params, toks, a, impl="kernel", **kw)[0],
                   lambda: M.prefill(cfg, params, toks, b, impl="kernel",
                                     steps=steps, **kw)[0])
        for k, v in a.items():
            assert torch.equal(v, b[k]) if isinstance(v, torch.Tensor) \
                else v == b[k], k
    assert (steps.captures, steps.replays) == (1, 2)


@pytest.mark.parametrize("arch", ["llama3.3-70b", "hymba-1.5b"])
def test_captured_engine_streamed_passes_are_the_eager_passes(arch, cuda_device):
    """A tiny engine (4 layers, 2 streamed from pinned memory on the copy
    stream) captured against an eager twin: the prompt pass into the
    state (flash on the mainloop, Hymba's chunked scan), for the dense
    family prefill_partial's 128-token rounds (kernel 4's mainloop) and
    verify passes too, then 64 replayed decode passes; logits, state and
    launch counts bit for bit."""
    from repro_torch.core.capture import CapturedStep
    cfg, params = _smoke_model(arch, cuda_device, n_layers=4)
    engs = [InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), mb=2, max_len=512,
                              device=cuda_device) for _ in range(2)]
    sts = [e.init_state(params) for e in engs]
    assert engs[1].store.pinned
    steps, pre = CapturedStep(cuda_device), CapturedStep(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    toks = torch.randint(1, cfg.vocab_size, (2, 256), device=cuda_device,
                         generator=g)
    for _ in range(2):
        _same_step(lambda: engs[0].prefill(toks, cache=sts[0])[0],
                   lambda: engs[1].prefill(toks, cache=sts[1], steps=pre)[0])
    if cfg.family.value == "dense":
        for e, s in zip(engs, sts):
            e.init_state(params, reuse=s)
        h0 = mq.hopper_launches
        _same_step(lambda: engs[0].prefill_partial(sts[0], toks, chunk=128)[0],
                   lambda: engs[1].prefill_partial(sts[1], toks, chunk=128,
                                                   steps=pre)[0])
        assert mq.hopper_launches - h0 == 2 * 2 * 4   # 2 rounds x 4 layers, both
        for _ in range(3):
            mat = torch.randint(1, cfg.vocab_size, (2, 5), device=cuda_device,
                                generator=g)
            p0 = sts[0]["pos"]
            _same_step(lambda: engs[0].verify_step(sts[0], mat)[0],
                       lambda: engs[1].verify_step(sts[1], mat, steps=steps)[0])
            for e, s in zip(engs, sts):
                e.rollback(s, p0 + 1)
    tok = torch.ones((2, 1), dtype=torch.long, device=cuda_device)
    for _ in range(N_REPLAYED + 1):
        lg = _same_step(lambda: engs[0].decode_step(sts[0], tok)[0],
                        lambda: engs[1].decode_step(sts[1], tok, steps=steps)[0])
        tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    for k, v in sts[0].items():
        assert torch.equal(v, sts[1][k]) if isinstance(v, torch.Tensor) \
            else v == sts[1][k], k
    assert steps.replays >= N_REPLAYED and pre.replays >= 1
    for e in engs:
        e.close()


@pytest.mark.parametrize("arch,kw", [
    ("llama3.3-70b", {}), ("llama3.3-70b", {"prefix_cache": True}),
    ("rwkv6-3b", {})], ids=["dense", "prefix", "rwkv6"])
def test_captured_serves_replay_their_prefills(arch, kw, cuda_device):
    """Sporadic serves (one epoch a request, one prompt length) captured
    and eager: tokens and launch counts equal; the captured serve's
    prefill graphs replayed."""
    cfg, params = _smoke_model(arch, cuda_device)
    prompts = [np.random.default_rng(i).integers(1, cfg.vocab_size, 128)
               .astype(np.int32) for i in range(3)]
    got = []
    for capture in (False, True):
        srv = LimeServer(cfg, params, max_len=256, pattern="sporadic",
                         page_size=64, prefill_chunk_tokens=64,
                         capture=capture, device=cuda_device, **kw)
        for p in prompts:
            srv.queue.submit(p, 8)
        done, n = _counted(srv.serve_all)
        got.append(([r.output for r in sorted(done, key=lambda r: r.rid)], n))
        stats = srv.make_backend().graph_stats
    assert got[0] == got[1]
    assert stats["prefill_replays"] > 0 and stats["replays"] > 0
