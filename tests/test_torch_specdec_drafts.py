"""The port's speculative decoding against the JAX package on the CPU:
rejection sampling (target_probs, rejection_verify), the n-gram,
small-model and resident drafts (their proposals, snapshots past the
cache's end, truncate_stack, retier), the draft-provider contract of
tests/test_draft_conformance.py over the port's providers, and the
single-device backend's speculation over the radix prefix cache. The
single-device backend's other speculative serves (dense through
verify_step, paged through PagedDecodeCache.verify / commit, greedy and
rejection-sampled) and the launcher's are in test_torch_specdec_serve.py.
Greedy proposals and served tokens are held to the JAX package's on the
same converted weights: equal, or a first divergence at a near tie of the
reference (_torch_parity's rule)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (LOGIT_TOL, assert_same_or_near_tie,  # noqa: E402
                           f32, jax_params, margin, port_cfg)
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.serving.sampling import SamplerConfig as JaxSampler  # noqa: E402
from repro.specdec import NgramDraft as JaxNgram  # noqa: E402
from repro.specdec import ResidentDraft as JaxResident  # noqa: E402
from repro.specdec import SmallModelDraft as JaxSmall  # noqa: E402
from repro.specdec import default_resident_ids as jax_default_ids  # noqa: E402
from repro.specdec import rejection_verify as jax_rejection  # noqa: E402
from repro.specdec import target_probs as jax_target_probs  # noqa: E402
from repro.specdec.resident_draft import truncate_stack as jax_truncate  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kvcache.paged_decode import PagedDecodeCache  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serving import LimeServer, SamplerConfig  # noqa: E402
from repro_torch.specdec import (NgramDraft, ResidentDraft,  # noqa: E402
                                 SmallModelDraft, SpecConfig,
                                 default_resident_ids, greedy_verify,
                                 make_draft_provider, rejection_verify,
                                 target_probs, truncate_stack)
from _torch_threads import one_thread  # noqa: E402,F401

HIST = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
KINDS = ("ngram", "model", "resident")


@pytest.fixture(scope="module")
def smoke(smoke_model):
    """(JAX cfg, JAX params, the port's cfg, the port's params on the
    CPU): the reduced gemma3-1b of the JAX package's tests, converted."""
    cfg, jp = smoke_model
    return cfg, jp, port_cfg(cfg), params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


# ----------------------------------------------------------------------------
# rejection sampling
# ----------------------------------------------------------------------------
SAMPLERS = [dict(temperature=1.0), dict(temperature=0.7),
            dict(temperature=1.0, top_k=5), dict(temperature=0.8, top_p=0.9),
            dict(temperature=1.3, top_k=20, top_p=0.5)]


@pytest.mark.parametrize("kw", SAMPLERS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_target_probs_matches_jax(kw):
    """The serving sampler's distribution through the port's filter_logits
    equals the JAX package's within 1e-6, padded vocabulary cut."""
    lg = np.random.default_rng(3).normal(0, 3, (4, 3, 70)).astype(np.float32)
    lg[..., 64:] = 50.0                   # padding columns must be cut
    got = target_probs(lg, SamplerConfig(**kw), 64)
    want = jax_target_probs(lg, JaxSampler(**kw), 64)
    assert got.dtype == np.float64 and got.shape == (4, 3, 64)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-9)
    if kw.get("top_k"):
        assert ((got > 0).sum(-1) <= kw["top_k"]).all()


@pytest.mark.parametrize("point_mass", [True, False], ids=["point-mass", "q"])
def test_rejection_verify_commits_match_jax(point_mass):
    """Shared seed, p, draft and q: the same committed tokens, the same
    generator state afterwards (the walk draws in the same order)."""
    for seed in range(60):
        r = np.random.default_rng(seed)
        k, V = int(r.integers(1, 6)), int(r.integers(2, 24))
        p = r.random((k + 1, V)) ** 3 + 1e-4
        p /= p.sum(-1, keepdims=True)
        q = None
        if point_mass:
            draft = p[:k].argmax(-1) if seed % 2 else r.integers(0, V, k)
        else:
            q = r.random((k, V)) + 1e-3
            q /= q.sum(-1, keepdims=True)
            draft = np.array([r.choice(V, p=qi) for qi in q])
        a, b = np.random.default_rng(seed + 7), np.random.default_rng(seed + 7)
        assert rejection_verify(a, p, draft, q) == jax_rejection(b, p, draft, q)
        assert a.random() == b.random()


def _hist(tokens, V):
    h = np.zeros(V)
    for t in tokens:
        h[t] += 1
    return h / len(tokens)


@pytest.mark.parametrize("point_mass", [True, False], ids=["point-mass", "q"])
def test_rejection_verify_matches_target_distribution(point_mass):
    """The first committed token of a 1-draft round is p-distributed,
    whatever the proposal (JAX's
    test_rejection_verify_matches_target_distribution, on the port)."""
    rng = np.random.default_rng(0)
    V = 6
    p = np.array([[0.35, 0.05, 0.2, 0.1, 0.25, 0.05], [1 / V] * V])
    q = np.array([[0.1, 0.4, 0.1, 0.2, 0.1, 0.1]])
    out = []
    for _ in range(40_000):
        d = rng.choice(V, p=q[0])
        committed = rejection_verify(
            rng, p, [d] if not point_mass else [int(np.argmax(q[0]))],
            None if point_mass else q)
        out.append(committed[0])
    emp = _hist(out, V)
    assert np.abs(emp - p[0]).max() < 0.01, (emp, p[0])


def test_rejection_verify_full_acceptance_bonus_distribution():
    rng = np.random.default_rng(1)
    V = 4
    p = np.array([[0.25, 0.25, 0.25, 0.25], [0.7, 0.1, 0.1, 0.1]])
    out = []
    for _ in range(20_000):
        d = rng.choice(V, p=p[0])
        committed = rejection_verify(rng, p, [d], p[:1])
        assert committed[0] == d and len(committed) == 2
        out.append(committed[1])
    assert np.abs(_hist(out, V) - p[1]).max() < 0.015


# ----------------------------------------------------------------------------
# the n-gram draft
# ----------------------------------------------------------------------------
def test_ngram_draft_matches_jax():
    """Seeded histories over a small vocabulary (so n-grams repeat), grown
    by observe(): every proposal equals the JAX package's."""
    for seed in range(40):
        r = np.random.default_rng(seed)
        V, n = int(r.integers(2, 9)), int(r.integers(1, 30))
        hist = r.integers(0, V, n).tolist()
        ng = int(r.integers(1, 5))
        a, b = NgramDraft(max_ngram=ng), JaxNgram(max_ngram=ng)
        a.reset(hist)
        b.reset(hist)
        for _ in range(4):
            for k in (1, 3, 5):
                ta, qa = a.propose(k)
                tb, qb = b.propose(k)
                assert qa is None and qb is None
                assert ta.dtype == np.int32 and ta.tolist() == tb.tolist()
            more = r.integers(0, V, int(r.integers(1, 4))).tolist()
            a.observe(more)
            b.observe(more)
    d = NgramDraft(max_ngram=3)
    d.reset([1, 2, 3, 4, 9, 9, 1, 2, 3])
    assert d.propose(3)[0][:2].tolist() == [4, 9]
    d.reset([7])
    assert d.propose(4)[0].tolist() == [7, 7, 7, 7]


# ----------------------------------------------------------------------------
# the small-model and resident drafts
# ----------------------------------------------------------------------------
def _jax_step_logits(jd, hist, prefix):
    """The JAX draft's logits for the token after hist + prefix (its own
    reset / observe / decode path), (V,) fp32."""
    import jax.numpy as jnp
    jd.reset(hist)
    jd.observe(prefix)
    lg, _ = jd._decode(jd.params, jd._cache,
                       jnp.asarray([[jd._pending]], jnp.int32))
    return f32(lg).reshape(-1)[:jd.cfg.vocab_size]


def assert_same_proposal(got, want, jd, hist):
    """Greedy proposals equal, or the first divergence is a near tie of
    the JAX draft's logits (top-2 margin below LOGIT_TOL)."""
    got, want = list(got), list(want)
    if got == want:
        return
    t = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
    la = _jax_step_logits(jd, hist, want[:t])
    assert margin(la[None])[0] < LOGIT_TOL, \
        f"proposal token {t} diverges outside a near tie"


def _cache_copy(d):
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in d._cache.items()}


def _assert_cache_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_small_model_draft_matches_jax(smoke):
    """Greedy proposals of the reduced gemma3-1b equal the JAX package's
    on the same weights; propose() is a snapshot (the committed cache is
    left bit for bit as it was) and observe() moves it."""
    cfg, jp, pcfg, pp = smoke
    a = SmallModelDraft(pcfg, pp, max_len=32, device="cpu")
    b = JaxSmall(cfg, jp, max_len=32)
    a.reset(HIST)
    b.reset(HIST)
    before = _cache_copy(a)
    pa, qa = a.propose(4)
    assert qa is None and pa.dtype == np.int32
    _assert_cache_equal(before, a._cache)
    assert a.propose(4)[0].tolist() == pa.tolist()
    pb, _ = b.propose(4)
    assert_same_proposal(pa, pb, JaxSmall(cfg, jp, max_len=32), HIST)
    a.observe([int(pa[0])])
    assert a.propose(3)[0][:2].tolist() == pa[1:3].tolist()


def test_small_model_draft_past_max_len_matches_jax(tiny_dense_factory):
    """A global-attention draft with a 16-slot cache, driven 30 positions:
    past its end each decode overwrites a slot whose older position is
    still in view, so a propose() that only rolled pos back would change
    what the draft sees. Every proposal equals the JAX draft's (fed the
    same commits, near-tie rule) and a twin that never proposes; the
    cache after propose() is bit-equal to the cache before."""
    cfg = tiny_dense_factory(n_layers=2, vocab_size=48)
    jp, _, pp = jax_params(cfg, seed=1)
    pcfg = port_cfg(cfg)
    hist = np.random.default_rng(2).integers(0, 48, 12).tolist()
    a = SmallModelDraft(pcfg, pp, max_len=16, device="cpu")
    twin = SmallModelDraft(pcfg, pp, max_len=16, device="cpu")
    b = JaxSmall(cfg, jp, max_len=16)
    ref = JaxSmall(cfg, jp, max_len=16)
    for d in (a, twin, b):
        d.reset(hist)
    seen = list(hist)
    commits = np.random.default_rng(3).integers(0, 48, 30).tolist()
    wrapped = 0
    for i in range(0, 30, 3):
        before = _cache_copy(a)
        pa, _ = a.propose(4)
        _assert_cache_equal(before, a._cache)
        wrapped += a._cache["pos"] + 4 > 16
        pb, _ = b.propose(4)
        assert_same_proposal(pa, pb, ref, seen)
        step = commits[i:i + 3]
        for d in (a, twin, b):
            d.observe(step)
        seen += step
        assert a.propose(4)[0].tolist() == twin.propose(4)[0].tolist()
    assert a._cache["pos"] > 2 * 16 and wrapped >= 5


def test_recurrent_model_draft_matches_jax():
    """A model draft of another family (the reduced RWKV6-3B: its state
    is a recurrence, not slots) proposes what the JAX package's does and
    propose() leaves its states as it found them."""
    cfg = get_smoke_config("rwkv6-3b")
    jp, _, pp = jax_params(cfg)
    a = SmallModelDraft(port_cfg(cfg), pp, max_len=32, device="cpu")
    b = JaxSmall(cfg, jp, max_len=32)
    a.reset(HIST)
    b.reset(HIST)
    before = _cache_copy(a)
    pa, _ = a.propose(4)
    _assert_cache_equal(before, a._cache)
    assert_same_proposal(pa, b.propose(4)[0], JaxSmall(cfg, jp, max_len=32),
                         HIST)
    a.observe([5, 7])
    b.observe([5, 7])
    assert_same_proposal(a.propose(3)[0], b.propose(3)[0],
                         JaxSmall(cfg, jp, max_len=32), HIST + [5, 7])


def test_stochastic_draft_probs_and_seeded_draws(smoke):
    """A sampled model draft returns q rows that are distributions over the
    vocabulary, each drawn token possible under its row; the same seed
    draws the same tokens."""
    _, _, pcfg, pp = smoke
    draws = []
    for _ in range(2):
        d = SmallModelDraft(pcfg, pp, max_len=32, temperature=0.8, seed=5,
                            device="cpu")
        d.reset(HIST)
        toks, probs = d.propose(4)
        assert probs.shape == (4, pcfg.vocab_size) and probs.dtype == np.float64
        assert (probs >= 0).all() and np.allclose(probs.sum(-1), 1.0)
        assert all(probs[i, int(t)] > 0 for i, t in enumerate(toks))
        draws.append(toks.tolist())
    assert draws[0] == draws[1]


def test_truncate_stack_and_default_ids_match_jax(smoke):
    cfg, jp, pcfg, pp = smoke
    for n in (None, 1, 2, 10 ** 6):
        assert default_resident_ids(pcfg, n) == jax_default_ids(cfg, n)
    with pytest.raises(ValueError):
        truncate_stack(pcfg, pp, [])
    with pytest.raises(ValueError):
        truncate_stack(pcfg, pp, [pcfg.n_layers])
    four = dataclasses.replace(pcfg, n_layers=4)
    jfour = dataclasses.replace(cfg, n_layers=4)
    jp4 = __import__("repro.models.model", fromlist=["x"]).init_params(
        jfour, jax.random.PRNGKey(2))
    pp4 = params_from_numpy(jax.tree.map(np.asarray, jp4), "cpu")
    for ids in ([1, 2], [0, 3], [2]):
        sub_cfg, sub = truncate_stack(four, pp4, ids)
        jcfg, jsub = jax_truncate(jfour, jp4, ids)
        assert sub_cfg.n_layers == jcfg.n_layers == len(ids)
        for k, v in pp4.items():
            if k != "layers":
                assert sub[k] is v, k        # early-exit head shared
        got = jax.tree.leaves(jax.tree.map(f32, sub["layers"]))
        want = jax.tree.leaves(jax.tree.map(f32, jsub["layers"]))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        if ids == [1, 2]:                    # contiguous: views, no copy
            q = sub["layers"]["attn"]["wq"]
            assert q.untyped_storage().data_ptr() == \
                pp4["layers"]["attn"]["wq"].untyped_storage().data_ptr()


def test_resident_draft_matches_jax_and_retier_replays(smoke):
    """The resident draft over the bottom layer proposes what the JAX
    package's does; a retier to the whole stack mid-sequence leaves it
    indistinguishable from one built on the whole stack."""
    cfg, jp, pcfg, pp = smoke
    a = ResidentDraft(pcfg, pp, [0], max_len=64, device="cpu")
    b = JaxResident(cfg, jp, [0], max_len=64)
    a.reset(HIST)
    b.reset(HIST)
    assert_same_proposal(a.propose(4)[0], b.propose(4)[0],
                         JaxResident(cfg, jp, [0], max_len=64), HIST)
    a.observe([7, 7])
    a.propose(3)
    a.retier(range(pcfg.n_layers))
    fresh = ResidentDraft(pcfg, pp, range(pcfg.n_layers), max_len=64,
                          device="cpu")
    fresh.reset(HIST + [7, 7])
    assert a.propose(4)[0].tolist() == fresh.propose(4)[0].tolist()
    assert a.cfg.n_layers == pcfg.n_layers
    params = a.params
    a.retier(range(pcfg.n_layers))            # no-op: nothing rebuilt
    assert a.params is params


# ----------------------------------------------------------------------------
# the draft-provider contract (tests/test_draft_conformance.py, on the port)
# ----------------------------------------------------------------------------
@pytest.fixture(params=KINDS)
def provider_factory(request, smoke):
    _, _, pcfg, pp = smoke
    kind = request.param

    def make(temperature=0.0):
        if kind == "ngram":
            return NgramDraft(max_ngram=3)
        if kind == "model":
            return SmallModelDraft(pcfg, pp, max_len=64,
                                   temperature=temperature, device="cpu")
        return ResidentDraft(pcfg, pp, default_resident_ids(pcfg),
                             max_len=64, temperature=temperature,
                             device="cpu")

    make.kind = kind
    make.vocab = pcfg.vocab_size
    return make


def test_propose_exact_length_and_vocab(provider_factory):
    d = provider_factory()
    d.reset(HIST)
    for k in (1, 3, 5):
        toks, probs = d.propose(k)
        assert toks.shape == (k,) and toks.dtype == np.int32
        assert ((toks >= 0) & (toks < provider_factory.vocab)).all()
        assert probs is None


def test_stochastic_propose_probs_are_distributions(provider_factory):
    d = provider_factory(temperature=0.8)
    d.reset(HIST)
    toks, probs = d.propose(4)
    if provider_factory.kind == "ngram":
        assert probs is None                 # always a point mass
        return
    assert probs.shape == (4, provider_factory.vocab)
    assert (probs >= 0).all() and np.allclose(probs.sum(-1), 1.0, atol=1e-6)
    assert all(probs[i, int(t)] > 0 for i, t in enumerate(toks))


def test_propose_is_snapshot(provider_factory):
    d = provider_factory()
    d.reset(HIST)
    assert d.propose(4)[0].tolist() == d.propose(4)[0].tolist()


def test_rejected_proposal_never_pollutes(provider_factory):
    a, b = provider_factory(), provider_factory()
    a.reset(HIST)
    b.reset(HIST)
    drafted, _ = a.propose(4)
    V = provider_factory.vocab
    committed = [(int(drafted[0]) + 1) % V, (int(drafted[0]) + 2) % V]
    a.observe(committed)
    b.observe(committed)
    assert a.propose(4)[0].tolist() == b.propose(4)[0].tolist()


def test_reset_equals_reset_plus_observe(provider_factory):
    a, b = provider_factory(), provider_factory()
    a.reset(HIST)
    b.reset(HIST[:5])
    b.observe(HIST[5:])
    assert a.propose(4)[0].tolist() == b.propose(4)[0].tolist()


def test_resident_spec_paged_rollback_no_page_leak(smoke):
    """Greedy speculation with resident-draft proposals over the port's
    paged KV: the committed stream is the plain decode's, and after every
    partial commit the cache holds exactly the pages of a twin that
    decoded the same committed tokens one at a time."""
    _, _, pcfg, pp = smoke
    V = pcfg.vocab_size
    toks = torch.tensor([HIST])
    cache = PM.init_cache(pcfg, 1, 64, device="cpu")
    logits, cache = PM.prefill(pcfg, pp, toks, cache)
    first = int(logits[0, -1, :V].argmax())
    c1 = PM.init_cache(pcfg, 1, 64, device="cpu")
    PM.prefill(pcfg, pp, toks, c1)
    cur, want = first, [first]
    for _ in range(8):
        lg, c1 = PM.decode_step(pcfg, pp, c1, torch.tensor([[cur]]))
        cur = int(lg[0, 0, :V].argmax())
        want.append(cur)
    draft = ResidentDraft(pcfg, pp, [0], max_len=64, device="cpu")
    draft.reset(HIST + [first])
    spec_pc = PagedDecodeCache(pcfg, 1, 64, page_size=4, device="cpu")
    spec_pc.seed(cache)
    twin_pc = PagedDecodeCache(pcfg, 1, 64, page_size=4, device="cpu")
    twin_pc.seed(cache)
    got, cur = [first], first
    while len(got) < 9:
        d, _ = draft.propose(3)
        mat = np.concatenate([[[cur]], d[None]], 1)
        lg = f32(spec_pc.verify(pp, mat))
        committed = greedy_verify(lg[0], d, V)
        spec_pc.commit(len(committed))
        tcur = cur
        for t in committed:
            twin_pc.step(pp, np.array([[tcur]]))
            tcur = t
        assert spec_pc.pages_in_use == twin_pc.pages_in_use
        draft.observe(committed)
        got.extend(committed)
        cur = committed[-1]
    assert got[:9] == want
    spec_pc.release()
    twin_pc.release()
    assert spec_pc.pool.alloc.used_pages == twin_pc.pool.alloc.used_pages == 0


# ----------------------------------------------------------------------------
# the backend: speculation over the radix prefix cache (the single-device
# serves are in test_torch_specdec_serve.py)
# ----------------------------------------------------------------------------
def _prefix_server(smoke, spec):
    return LimeServer(smoke[2], smoke[3], max_len=48, pattern="bursty",
                      prefix_cache=True, page_size=8, prefill_chunk_tokens=8,
                      spec=spec, device="cpu")


def _epoch(srv, ps):
    for p in ps:
        srv.queue.submit(p, 6)
    return [r.output for r in sorted(srv.serve_all(), key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def prefix_refs(smoke):
    """The prompts of the prefix-cache spec serves (two epochs of 4 sharing
    a 16-token template), the port's non-speculative warm epoch and the
    JAX package's serve of the warm prompts: what every draft's warm epoch
    is held to."""
    cfg, jp, _, _ = smoke
    rng = np.random.default_rng(9)
    tmpl = rng.integers(1, cfg.vocab_size, 16)
    prompts = [np.concatenate([tmpl, rng.integers(1, cfg.vocab_size, 8)])
               .astype(np.int32) for _ in range(8)]
    plain = _prefix_server(smoke, None)
    _epoch(plain, prompts[:4])
    plain_warm = _epoch(plain, prompts[4:])
    from repro.serving.server import LimeServer as JaxServer
    ref = _epoch(JaxServer(cfg, jp, max_len=48, pattern="bursty"),
                 prompts[4:])
    return prompts, plain_warm, ref


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_spec_prefix_cache_warm_equals_cold(draft, smoke, prefix_refs):
    """Speculation over the radix prefix cache: two epochs of 4 requests
    sharing a 16-token template (page 8, prefill rounds of 8); the warm
    epoch matches 2 pages a request, grows its tables through verify and
    commit and donates at each commit, and its tokens equal a cold serve
    of the same prompts, a non-speculative warm serve's and the JAX
    package's (near-tie rule)."""
    cfg, jp, pcfg, pp = smoke
    prompts, plain_warm, ref = prefix_refs
    spec = SpecConfig(k=3, draft=draft)
    srv = _prefix_server(smoke, spec)
    _epoch(srv, prompts[:4])
    warm = _epoch(srv, prompts[4:])
    be = srv.make_backend()
    assert be.prefix_stats["prefill_tokens_saved"] == 4 * 16
    assert be.spec_stats["spec_rounds"] > 0
    assert _epoch(_prefix_server(smoke, spec), prompts[4:]) == warm
    assert plain_warm == warm
    assert_same_or_near_tie(cfg, jp, pp, prompts[4:], warm, ref, 48,
                            width=24)


def test_make_draft_provider_kinds(smoke):
    _, _, pcfg, pp = smoke
    spec = SpecConfig(draft="ngram", max_ngram=2)
    assert isinstance(make_draft_provider(spec, pcfg), NgramDraft)
    d = make_draft_provider(SpecConfig(draft="resident", resident_layers=1),
                            pcfg, target_params=pp, device="cpu")
    assert isinstance(d, ResidentDraft) and d.resident_ids == (0,)
    with pytest.raises(ValueError):
        make_draft_provider(SpecConfig(draft="resident"), pcfg)
    big = dataclasses.replace(pcfg, vocab_size=2048)
    m = make_draft_provider(SpecConfig(draft="model"), big, device="cpu")
    assert isinstance(m, SmallModelDraft)
    assert m.cfg.name == "gemma3-1b" and m.cfg.vocab_size == 2048
    assert m.params["embedding"].shape[0] == 2048


@pytest.mark.parametrize("module", ["repro_torch.specdec", "repro_torch.specdec.draft",
                                    "repro_torch.specdec.controller",
                                    "repro_torch.serving.backend"])
def test_specdec_imports_first(module):
    """Each module imports in a fresh interpreter before anything else of
    the port (specdec imports serving.sampling, whose package imports the
    backend, which takes specdec's classes only where it uses them)."""
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    r = subprocess.run([sys.executable, "-c", f"import {module}"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
