"""The port's continuous-batching scheduler against the JAX package's on
the same streams, through one framework-free stub backend (a virtual
clock, deterministic tokens, recorded calls), under the reserve policy and
the paged policy with spill and with recompute preemption: the same
admissions, preemptions, resumes and reclaims. Per request the same
first_token_s, finish_s, generated, preempted and output; the same
kv_pages_spilled, peak_kv_pages and retier_reclaimed_pages; the same
sequence of calls on the stub (admit, join, decode, release, reclaim,
note_kv_pages, charge). Also the port's PagedKVManager on the cases of
the JAX package's manager tests."""
import dataclasses

import numpy as np
import pytest

from repro.kvcache import PagedKVConfig as JaxPoolConfig
from repro.kvcache import PagedKVManager as JaxManager
from repro.kvcache import PagePool as JaxPool
from repro.kvcache.pool import HOST as JAX_HOST
from repro.serving.scheduler import ContinuousBatchingScheduler as JaxScheduler
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import SchedulerConfig as JaxConfig
from repro_torch.kvcache import HOST, PagedKVConfig, PagedKVManager, PagePool
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serving.scheduler import SchedulerConfig
from _torch_threads import one_thread  # noqa: F401


class StubBackend:
    """A serving backend with no model: the clock moves by a fixed cost a
    step (plus a prefill cost per uncached token and a transfer cost per
    byte moved); tokens are a function of (rid, tokens emitted so far);
    a speculative backend commits 1..k+1 tokens a round; reclaim grants
    up to `grant` pages a call out of a finite headroom."""

    def __init__(self, *, n_slots, join, budget, spec_k=0, headroom=0,
                 grant=0, max_len=None):
        self.n_slots = n_slots
        self.can_join_running = join
        self.budget = budget
        self.spec = type("Spec", (), {"k": spec_k})() if spec_k else None
        self.k = spec_k
        self.headroom, self.grant = headroom, grant
        self.max_len = max_len
        self.t = 0.0
        self.calls = []
        self.slots = {}                  # slot -> [rid, tokens emitted]
        self.rounds = 0
        self.pool = None

    # -- clock and capacity --
    def now(self):
        return self.t

    def advance_to(self, t):
        self.t = max(self.t, t)

    def kv_budget_tokens(self):
        return self.budget

    def kv_bytes_per_token(self):
        return 1024.0

    def max_request_tokens(self):
        return self.max_len

    # -- steps --
    def _tok(self, slot):
        rid, n = self.slots[slot]
        self.slots[slot][1] += 1
        return (rid * 31 + n * 7) % 1000

    def _enter(self, slot, r):
        self.slots[slot] = [r.rid, r.generated]
        self.t += 0.02 + 1e-4 * max(r.prefill_tokens - r.cached_tokens, 0)

    def start_batch(self, reqs):
        self.calls.append(("admit", [(r.rid, r.prefill_tokens, r.cached_tokens,
                                      r.preempted) for r in reqs]))
        for slot, r in enumerate(reqs):
            self._enter(slot, r)
        return [self._tok(slot) for slot in range(len(reqs))]

    def join(self, slot, r):
        self.calls.append(("join", slot, r.rid, r.prefill_tokens,
                           r.cached_tokens, r.preempted))
        self._enter(slot, r)
        return self._tok(slot)

    def decode_active(self, slots):
        self.calls.append(("decode", list(slots)))
        self.rounds += 1
        self.t += 0.01 * (1 + self.k)
        out = {}
        for s in slots:
            if self.k:
                c = 1 + (self.slots[s][0] + self.rounds) % (self.k + 1)
                out[s] = [self._tok(s) for _ in range(c)]
            else:
                out[s] = self._tok(s)
        return out

    def release(self, slot):
        self.calls.append(("release", slot))
        self.slots.pop(slot, None)

    # -- paged hooks --
    def attach_page_pool(self, pool):
        self.pool = pool
        self.calls.append(("attach", pool.cfg.device_pages, pool.cfg.host_pages,
                           pool.cfg.page_bytes))

    def reclaim_kv_pages(self, n):
        got = min(n, self.grant, self.headroom)
        if got > 0:
            self.headroom -= got
            self.pool.grow(got)
        self.calls.append(("reclaim", n, got))
        return got

    def note_kv_pages(self, pages, page_size):
        self.calls.append(("note", pages, page_size))

    def charge_transfer(self, nbytes):
        self.calls.append(("charge", nbytes))
        self.t += nbytes * 1e-9


def _stream(seed, n):
    """Bursts of 4 with jitter; prompts 4-40 tokens, 4-40 new tokens."""
    rng = np.random.default_rng(seed)
    return [((i // 4) * 0.15 + float(rng.uniform(0, 0.02)),
             int(rng.integers(4, 41)), int(rng.integers(4, 41)))
            for i in range(n)]


# policy, preempt mode, join, spec k, reclaim (headroom, grant), budget,
# host budget
CASES = [("reserve", "spill", False, 0, (0, 0), 160, None),
         ("reserve", "spill", True, 0, (0, 0), 112, None),
         ("paged", "spill", False, 0, (0, 0), 112, None),
         ("paged", "spill", True, 0, (0, 0), 112, None),
         ("paged", "recompute", True, 0, (0, 0), 112, None),
         ("paged", "recompute", False, 0, (0, 0), 96, None),
         ("paged", "spill", True, 3, (0, 0), 200, None),
         ("paged", "spill", True, 0, (0, 0), 112, 24),       # spill falls back
         ("paged", "spill", True, 0, (12, 4), 160, None),    # reclaim first
         ("paged", "recompute", False, 3, (30, 8), 128, None),
         ("paged", "recompute", True, 0, (6, 6), 128, None)]


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("policy,mode,join,k,reclaim,budget,host", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'join' if c[2] else 'epoch'}"
                              f"-k{c[3]}-grant{c[4][0]}-b{c[5]}-h{c[6]}"
                              for c in CASES])
def test_scheduler_decisions_match_jax(policy, mode, join, k, reclaim, budget,
                                       host, seed):
    stream = _stream(seed, 14)
    runs = []
    for sched_cls, cfg_cls, req_cls in (
            (JaxScheduler, JaxConfig, JaxRequest),
            (ContinuousBatchingScheduler, SchedulerConfig, Request)):
        be = StubBackend(n_slots=4, join=join, budget=budget, spec_k=k,
                         headroom=reclaim[0], grant=reclaim[1], max_len=96)
        sched = sched_cls(be, cfg_cls(kv_policy=policy, page_size=8,
                                      preempt=mode,
                                      host_kv_budget_tokens=host))
        reqs = [req_cls(i, None, new, arrival_s=t, prompt_len=p)
                for i, (t, p, new) in enumerate(stream)]
        done = sched.serve(reqs)
        runs.append((done, sched.stats, be))
    (jd, js, jb), (pd, ps, pb) = runs

    def view(done):
        return [(r.rid, r.first_token_s, r.finish_s, r.generated, r.preempted,
                 r.output, r.rejected, r.done, r.admitted_s) for r in done]
    assert view(pd) == view(jd)
    assert pb.calls == jb.calls
    for key in ("kv_pages_spilled", "kv_pages_fetched", "kv_migrated_bytes",
                "peak_kv_pages", "peak_active", "retier_reclaimed_pages"):
        assert ps.get(key, 0) == js.get(key, 0), key
    assert all(r.done for r in pd)
    # the stream exercises what the case is about: preemption, reclaim,
    # and a spill that found the host tier full (the resumed request
    # re-enters with no cached tokens: recompute)
    if policy == "paged" and not k and not reclaim[0]:
        assert sum(r.preempted for r in pd) > 0
    if reclaim[0]:
        assert ps["retier_reclaimed_pages"] > 0
    entries = [x for c in pb.calls if c[0] == "admit" for x in c[1]]
    entries += [c[2:] for c in pb.calls if c[0] == "join"]
    resumed = [x for x in entries if x[3] > 0]
    if host is not None:
        assert any(x[2] == 0 for x in resumed)
    if policy == "paged" and mode == "spill" and host is None and resumed:
        assert all(x[2] == x[1] > 0 for x in resumed)   # KV kept


def test_spec_spill_resume_fault_matches_jax():
    """A reference fault the port reproduces (ROADMAP §C): under a
    speculative backend a live table is grown by a whole round (k + 1
    tokens) before it commits fewer; spilled and resumed, the re-entry
    extend asks for kv_tokens_now + 1 < the table's tokens, and the
    block table refuses to shrink. Both schedulers fail alike."""
    errs = []
    for sched_cls, cfg_cls, req_cls in (
            (JaxScheduler, JaxConfig, JaxRequest),
            (ContinuousBatchingScheduler, SchedulerConfig, Request)):
        be = StubBackend(n_slots=4, join=True, budget=128, spec_k=3, max_len=96)
        sched = sched_cls(be, cfg_cls(kv_policy="paged", page_size=8))
        with pytest.raises(ValueError, match="cannot shrink table") as e:
            sched.serve([req_cls(i, None, new, arrival_s=t, prompt_len=p)
                         for i, (t, p, new) in enumerate(_stream(0, 14))])
        errs.append((str(e.value), be.calls))
    assert errs[0] == errs[1]


# ----------------------------------------------------------------------------
# the manager (the cases of the JAX package's tests/test_kvcache.py)
# ----------------------------------------------------------------------------
IMPLS = {"port": (PagedKVManager, PagePool, PagedKVConfig, HOST),
         "jax": (JaxManager, JaxPool, JaxPoolConfig, JAX_HOST)}


def _mgr(impl, dev=6, host=6, ps=4, page_bytes=8.0):
    mgr, pool, cfg, _ = IMPLS[impl]
    return mgr(pool(cfg(page_size=ps, device_pages=dev, host_pages=host,
                        page_bytes=page_bytes)))


@pytest.mark.parametrize("impl", IMPLS)
def test_manager_admit_extend_release(impl):
    m = _mgr(impl)
    assert m.admit(1, 5)                # 2 pages
    assert m.admit(2, 9)                # 3 pages
    assert not m.admit(3, 9)            # would need 3, only 1 free
    assert m.device_pages_in_use() == 5
    assert m.extend(1, 8)               # still 2 pages
    assert not m.extend(1, 13)          # needs 2 more, only 1 free
    assert m.pages_of(1) == 2           # failed extend left no residue
    m.release(2)
    assert m.extend(1, 13)
    m.release(1)
    assert m.device_pages_in_use() == 0
    with pytest.raises(ValueError):
        m.admit(4, 1) and m.admit(4, 1)


@pytest.mark.parametrize("impl", IMPLS)
def test_manager_headroom_watermark(impl):
    m = _mgr(impl, dev=4)
    assert m.can_admit(4, headroom_pages=3)
    assert not m.can_admit(4, headroom_pages=4)


@pytest.mark.parametrize("impl", IMPLS)
def test_manager_spill_preempt_and_resume(impl):
    m = _mgr(impl, dev=4, host=4)
    host = IMPLS[impl][3]
    m.admit(1, 8)                       # 2 pages
    m.admit(2, 8)                       # 2 pages, device full
    moved = m.preempt(2, "spill")
    assert moved == 16.0 and m.is_suspended(2)
    assert m.pool.pages_in_use(host) == 2
    assert m.extend(1, 16)              # freed device room
    assert not m.can_resume(2)          # device full again
    m.release(1)
    assert m.resume(2) == 16.0          # fetched back, priced
    assert not m.is_suspended(2) and m.tokens_of(2) == 8
    assert m.active_requests() == [2]


@pytest.mark.parametrize("impl", IMPLS)
def test_manager_recompute_preempt_and_resume(impl):
    m = _mgr(impl, dev=4, host=0)
    m.admit(1, 8)
    m.admit(2, 8)
    assert m.preempt(2, "recompute") == 0.0
    assert m.pages_of(2) == 0 and m.tokens_of(2) == 8   # span remembered
    m.release(1)
    assert m.resume(2) == 0.0
    assert m.pages_of(2) == 2 and m.tokens_of(2) == 8
    with pytest.raises(ValueError):
        m.preempt(2, "swap")            # checked after the suspend flag


@pytest.mark.parametrize("impl", IMPLS)
def test_manager_spill_falls_back_to_recompute_when_host_full(impl):
    m = _mgr(impl, dev=4, host=1)
    host = IMPLS[impl][3]
    m.admit(1, 8)                       # 2 pages > 1 host page
    assert m.preempt(1, "spill") == 0.0
    assert m.pages_of(1) == 0           # dropped, not leaked
    assert m.pool.pages_in_use(host) == 0
    assert m.resume(1) == 0.0 and m.pages_of(1) == 2


@pytest.mark.parametrize("impl", IMPLS)
def test_manager_delegate_tail_and_truncate(impl):
    m = _mgr(impl, dev=6, host=6, ps=4)
    m.admit(1, 10)                      # 3 pages, last holds 2 tokens
    assert m.delegate_tail(1, 3) == 0.0           # < 1 page: nothing moves
    assert m.delegate_tail(1, 5) == 8.0           # one whole page
    assert m.resident_tokens(1) == 8
    assert m.truncate(1, 4) == 2 and m.pages_of(1) == 1
    assert m.resident_tokens(1) == 4


def test_manager_matches_jax_on_a_random_walk():
    """Both managers through the same seeded sequence of admits, extends,
    preemptions (both modes), resumes, delegations and releases: the same
    answers and the same pool state after every call."""
    rng = np.random.default_rng(3)
    ms = {k: _mgr(k, dev=12, host=6, ps=4) for k in IMPLS}
    live = set()
    for step in range(400):
        op = rng.integers(0, 6)
        rid = int(rng.integers(0, 8))
        n = int(rng.integers(1, 30))
        out = {}
        for k, m in ms.items():
            if op == 0 and rid not in live:
                out[k] = m.admit(rid, n)
            elif rid not in live:
                out[k] = None
            elif op == 1:
                out[k] = m.extend(rid, m.tokens_of(rid) + n % 6)
            elif op == 2 and not m.is_suspended(rid):
                out[k] = m.preempt(rid, "spill" if n % 2 else "recompute")
            elif op == 3 and m.is_suspended(rid):
                out[k] = m.resume(rid)
            elif op == 4 and not m.is_suspended(rid):
                try:
                    out[k] = m.delegate_tail(rid, n)
                except Exception as e:  # the host tier is full
                    out[k] = type(e).__name__
            elif op == 5:
                m.release(rid)
                out[k] = "released"
            else:
                out[k] = "skip"
        assert out["port"] == out["jax"], (step, op, out)
        if op == 0 and out["port"]:
            live.add(rid)
        if out["port"] == "released":
            live.discard(rid)
        pj, pp = ms["jax"].pool, ms["port"].pool
        assert dataclasses.astuple(pp.cfg) == dataclasses.astuple(pj.cfg)
        assert (pp._count, pp.spilled_pages, pp.fetched_pages, pp.migrated_bytes) \
            == (pj._count, pj.spilled_pages, pj.fetched_pages, pj.migrated_bytes)
