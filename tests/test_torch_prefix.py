"""The port's radix prefix cache over real KV pages, served through
LimeServer -> ContinuousBatchingScheduler -> EngineBackend on the CPU
(plain versions of the paged kernels), against the JAX package.

Shared-prefix traffic: one template, two epochs of 4 requests arriving
together, prompt 32, template 24, page size 8, prefill rounds of 8. The
match is capped at (32 - 1) // 8 = 3 pages, which the template fills, so
every epoch-2 request matches 24 tokens.

Within the port the contracts are exact: a warm epoch emits the tokens a
cold serve of the same prompts emits, chunked prefill equals monolithic
bit for bit (the JAX contract of test_prefixcache.py:476 holds in the
port's plain path), a warm epoch leaves the shared pages' bytes as they
were, and no page leaks. Against the JAX backend the radix counters are
equal and the tokens equal up to a near tie (_torch_parity's rule).
"""
import dataclasses
import json
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_parity import (assert_same_or_near_tie, jax_params,  # noqa: E402
                           port_cfg)
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.serving import LimeServer as JLimeServer  # noqa: E402
from repro_torch.kvcache.paged_decode import PagedDecodeCache  # noqa: E402
from repro_torch.serving import backend as serving_backend  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 EngineBackend, LimeServer, SchedulerConfig,
                                 make_arrivals, requests_from_arrivals)

PROMPT, TEMPLATE, PS, CHUNK, MAX_NEW, MAX_LEN = 32, 24, 8, 8, 6, 64


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("llama3.3-70b")
    jp, _, pp = jax_params(cfg)
    return cfg, port_cfg(cfg), jp, pp


def _prompts(cfg, n=8, seed=0):
    """n shared-prefix prompts of one template, all arriving at t = 0."""
    arr = make_arrivals("shared_prefix", n, n_templates=1,
                        prefix_len=TEMPLATE, prompt_len=PROMPT,
                        max_new_tokens=MAX_NEW, seed=seed)
    arr = [dataclasses.replace(a, time_s=0.0) for a in arr]
    return [r.prompt for r in requests_from_arrivals(
        arr, vocab_size=cfg.vocab_size, seed=seed)]


def _server(pcfg, pp, max_len=MAX_LEN):
    return LimeServer(pcfg, pp, max_len=max_len, pattern="bursty",
                      device="cpu", prefix_cache=True,
                      prefill_chunk_tokens=CHUNK, page_size=PS)


def _serve(srv, prompts):
    for p in prompts:
        srv.queue.submit(p, MAX_NEW)
    return [r.output for r in sorted(srv.serve_all(), key=lambda r: r.rid)]


def _serve_epochs(pcfg, pp, prompts):
    """Both epochs through one server and one scheduler run; returns
    (tokens per request, backend, scheduler stats)."""
    srv = _server(pcfg, pp)
    be = srv.make_backend()
    sched = ContinuousBatchingScheduler(be, SchedulerConfig())
    for p in prompts:
        srv.queue.submit(p, MAX_NEW)
    done = sched.serve(srv.queue.drain())
    return [r.output for r in sorted(done, key=lambda r: r.rid)], be, \
        sched.stats


def test_warm_epoch_equals_cold_and_counts_the_hit(model):
    cfg, pcfg, jp, pp = model
    prompts = _prompts(cfg)
    toks, be, stats = _serve_epochs(pcfg, pp, prompts)
    assert all(len(t) == MAX_NEW for t in toks)
    # epoch 1 finds an empty tree; each epoch-2 request matches the template
    assert be.prefix_stats == {
        "prefix_lookups": 8, "prefix_hits": 4,
        # epoch 1 donates the template's 3 pages once plus each request's
        # fourth page (32 + 5 committed tokens: 4 full pages); epoch 2 adds
        # its own fourth pages
        "cached_tokens": (3 + 4 + 4) * PS, "prefix_pages": 11,
        "prefill_tokens_saved": 4 * TEMPLATE}
    assert stats["prefill_tokens_saved"] == 4 * TEMPLATE
    # a cold serve of the epoch-2 prompts on a fresh cache
    cold = _serve(_server(pcfg, pp), prompts[4:])
    assert toks[4:] == cold


def test_prefix_serve_vs_jax_backend(model):
    """The JAX backend's radix cache on the same traffic: equal counters,
    tokens equal up to a near tie of the dense reference."""
    cfg, pcfg, jp, pp = model
    prompts = _prompts(cfg)
    toks, be, _ = _serve_epochs(pcfg, pp, prompts)
    jsrv = JLimeServer(cfg, jp, max_len=MAX_LEN, pattern="bursty",
                       prefix_cache=True, prefill_chunk_tokens=CHUNK,
                       page_size=PS)
    for p in prompts:
        jsrv.queue.submit(p, MAX_NEW)
    jdone = sorted(jsrv.serve_all(), key=lambda r: r.rid)
    assert be.prefix_stats == jsrv.make_backend().prefix_stats
    assert_same_or_near_tie(cfg, jp, pp, prompts, toks,
                            [r.output for r in jdone], MAX_LEN)


def test_warm_epoch_leaves_shared_pages_unchanged(model):
    """Writes land in place, so a write on a shared page would corrupt the
    cache for every later hit: the tree's pages keep their bytes through a
    warm epoch (every write lands past the matched, page-aligned prefix)."""
    cfg, pcfg, jp, pp = model
    prompts = _prompts(cfg)
    srv = _server(pcfg, pp)
    _serve(srv, prompts[:4])
    be = srv.make_backend()
    pc, radix = be._prefix_structures()
    shared = torch.tensor(sorted(n.page for n in radix._iter_nodes()))
    before = (pc.k_pool[:, shared].clone(), pc.v_pool[:, shared].clone())
    _serve(srv, prompts[4:])
    assert be.prefix_stats["prefix_hits"] == 4
    assert torch.equal(pc.k_pool[:, shared], before[0])
    assert torch.equal(pc.v_pool[:, shared], before[1])


def test_no_page_leaks(model):
    cfg, pcfg, jp, pp = model
    toks, be, _ = _serve_epochs(pcfg, pp, _prompts(cfg))
    pc, radix = be._prefix_structures()
    live = {p for t in pc.tables for p in t.pages}
    tree = {n.page for n in radix._iter_nodes()}
    assert pc.pool.alloc.used_pages == len(live | tree)
    pc.reset_tables()
    assert pc.pool.alloc.used_pages == radix.n_pages
    radix.release_all()
    assert pc.pool.alloc.used_pages == 0 and pc.pool.pages_in_use() == 0


def test_unequal_lengths_run_cold_through_the_paged_seed(model):
    """An epoch of unequal prompt lengths runs the dense (flash) prefill
    and scatters it into pages: no lookup, no donation, and the tokens of
    a paged backend without the cache."""
    cfg, pcfg, jp, pp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 27, 32, 9)]
    srv = _server(pcfg, pp)
    toks = _serve(srv, prompts)
    st = srv.make_backend().prefix_stats
    assert st["prefix_lookups"] == 0 and st["prefix_pages"] == 0
    be = EngineBackend(pcfg, pp, n_slots=4, max_len=MAX_LEN, paged=True,
                       page_size=PS, device="cpu")
    sched = ContinuousBatchingScheduler(be, SchedulerConfig())
    srv2 = LimeServer(pcfg, pp, max_len=MAX_LEN, pattern="bursty",
                      device="cpu")
    for p in prompts:
        srv2.queue.submit(p, MAX_NEW)
    done = sched.serve(srv2.queue.drain())
    assert toks == [r.output for r in sorted(done, key=lambda r: r.rid)]


@pytest.mark.parametrize("chunk", [5, 8, 16])
def test_chunked_prefill_bitwise_equals_monolithic(model, chunk):
    cfg, pcfg, jp, pp = model
    toks = torch.from_numpy(np.stack(_prompts(cfg, 2))).long()
    last = []
    for c in (0, chunk):
        pc = PagedDecodeCache(pcfg, 2, MAX_LEN, page_size=PS, impl="kernel",
                              device="cpu")
        last.append(pc.prefill(pp, toks, chunk=c))
        pc.release()
        assert pc.pool.alloc.used_pages == 0
    assert torch.equal(last[0], last[1])


def test_small_pool_evicts_cached_pages_and_stays_lossless(model):
    """One spare page beyond the live batch (4 x 5 pages at max_len 40):
    the tree grows by 4 pages an epoch, so by the fourth epoch its
    unpinned pages are evicted to make room, and the tokens are the roomy
    pool's."""
    cfg, pcfg, jp, pp = model
    prompts = _prompts(cfg, 16)
    be = EngineBackend(pcfg, pp, n_slots=4, max_len=40, prefix_cache=True,
                       prefill_chunk_tokens=CHUNK, page_size=PS,
                       cache_pages=1, device="cpu")
    queue = LimeServer(pcfg, pp, device="cpu").queue
    for p in prompts:
        queue.submit(p, MAX_NEW)
    done = ContinuousBatchingScheduler(be, SchedulerConfig()).serve(
        queue.drain())
    got = [r.output for r in sorted(done, key=lambda r: r.rid)]
    st = be.prefix_stats
    pc, radix = be._prefix_structures()
    assert pc.pool.alloc.n_pages == 4 * 5 + 1
    assert radix.evicted_pages > 0
    assert st["prefix_lookups"] == 16 and st["prefix_hits"] == 12
    assert got == _serve(_server(pcfg, pp, max_len=40), prompts)


@pytest.mark.parametrize("pattern", ["shared_prefix", "multiturn"])
def test_launcher_prefix_cache_on_cpu(pattern, capsys, monkeypatch):
    # serve on a clock that only the scheduler advances: the backend's
    # monotonic clock stands still, so now() moves only by advance_to's
    # skew, and a multiturn follow-up never arrives before its turn ends,
    # however slow the host is
    monkeypatch.setattr(serving_backend, "time",
                        types.SimpleNamespace(monotonic=lambda: 0.0))
    argv = ["--arch", "llama3.3-70b", "--smoke", "--device", "cpu",
            "--prefix-cache", "--page-size", "8", "--prefill-chunk", "8",
            "--pattern", pattern, "--n-templates", "1", "--prefix-len", "24",
            "--prompt-len", "32", "--requests", "6", "--max-new", "4",
            "--max-len", "96"]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    rep = json.loads(out[out.index("{"):])
    assert rep["backend"] == "paged-prefix" and rep["n_requests"] == 6
    assert rep["prefix_hit_rate"] > 0
