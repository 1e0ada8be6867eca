"""The prefills and the engine's streamed passes captured (core/capture.py,
the counterpart of the JAX package's jax.jit of M.prefill and of its
engine's pass), on the CPU.

There is no CUDA graph here: the graph machinery is a fake injected into
CapturedStep (``SnapGraphs``, test_torch_capture's FakeGraphs that puts
back, after its capture, the state the capture's run advanced: a real
capture records and runs nothing). Its capture and every replay run the
body under NoHostReads, and a replay re-runs the body built at the first
call with the new call's inputs in its static buffers. What a CPU run can
show, on tiny configs of every family (d_model 32, 2 or 4 layers):

(a) no prefill body and no pass body reads the host: the model's prefill
    (dense, MoE, SSM, hybrid, encoder-decoder with a static enc_out or
    frame embeddings), the paged cache's suffix rounds, the drafts' reset,
    the engine's decode, verify, prefill_partial rounds and prompt pass
    with streamed layers (SSM and hybrid too);
(b) nothing is frozen: the second and later calls of a key (other
    prompts, another encoder output, a cache holding another state, the
    engine's passes at later positions) equal an eager twin bit for bit,
    logits and every cache tensor, with the launch counters equal;
(c) the captured prefills and passes against the JAX package on the same
    seeded weights (M.prefill, M.decode_step, M.verify_step, jit-compiled
    with impl "ref"; the port's kernels run their plain versions):
    logits within LOGIT_TOL (_torch_parity), greedy picks equal where the
    reference's top-2 margin exceeds it;
(d) a retier, a weight load, or a cache at a new address captures again;
    a second epoch of the same prompt shape replays;
(e) the engine's prompt pass writes into the cache its caller allocated
    (the serving backend passes its state), never one of its own.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import LOGIT_TOL, f32, margin, port_cfg  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.capture import CapturedStep  # noqa: E402
from repro_torch.kvcache.paged_decode import PagedDecodeCache  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from test_torch_capture import FakeGraphs  # noqa: E402

B, S, MAX_LEN, ENC = 2, 12, 32, 6
TINY = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
            vocab_size=64)
# family: (arch, overrides beyond TINY)
FAMILIES = {
    "dense": ("llama3.3-70b", {}),
    "moe": ("deepseek-moe-16b", {"moe_d_ff": 16}),
    "ssm": ("rwkv6-3b", {"n_kv_heads": 0}),
    "hybrid": ("hymba-1.5b", {"window_size": 8}),
    "encdec": ("seamless-m4t-medium", {}),
}


class SnapGraphs(FakeGraphs):
    """FakeGraphs whose capture puts back every tensor of the trees
    (caches, engine states) that `trees()` names, as the capture found
    them: its run of a body that advances a recurrent state would
    otherwise advance it twice."""

    def __init__(self, trees=lambda: ()):
        super().__init__()
        self.trees = trees

    def capture(self, fn):
        snaps = [(t, {k: v.clone() for k, v in t.items()
                      if isinstance(v, torch.Tensor)}) for t in self.trees()]
        try:
            return super().capture(fn)
        finally:
            for t, snap in snaps:
                for k, v in snap.items():
                    t[k].copy_(v)


def snap_steps(trees=lambda: ()):
    return CapturedStep("cpu", graphs=SnapGraphs(trees))


@functools.lru_cache(maxsize=None)
def jcfg(family, n_layers=2):
    arch, over = FAMILIES[family]
    return dataclasses.replace(get_smoke_config(arch), n_layers=n_layers,
                               **dict(TINY, **over))


def to_jax(t):
    """The port's parameter tree (the JAX layout) as JAX arrays of the
    same dtypes."""
    if isinstance(t, dict):
        return {k: to_jax(v) for k, v in t.items()}
    dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy(), dtype=dt)


@functools.lru_cache(maxsize=None)
def weights(family, n_layers=2, seed=0):
    """(JAX config, port config, port params) drawn from a seed."""
    cfg = jcfg(family, n_layers)
    pcfg = port_cfg(cfg)
    pp = PM.init_params(pcfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    return cfg, pcfg, pp


def prompts(cfg, n, seed, length=S):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, length)))
            .long() for _ in range(n)]


def enc_outs(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (B, ENC, cfg.d_model)).astype(np.float32)).bfloat16()
        for _ in range(n)]


def clone(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def assert_same(got, want):
    """Two caches (or states) bit for bit, host pos included."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def counted(fn):
    """(fn's result, the launch counters' advance)."""
    c0 = capture.launch_counts()
    out = fn()
    return out, {k: v - c0[k] for k, v in capture.launch_counts().items()
                 if v != c0[k]}


# ----------------------------------------------------------------------------
# the model's prefill, every family: (a), (b), (d)
# ----------------------------------------------------------------------------
def _prefill_kw(family, cfg, i, how="enc_out"):
    """prefill's keywords of call i: the encoder-decoder family's static
    input (its encoder output, or frame embeddings for "frames")."""
    if family != "encdec":
        return {}
    src = enc_outs(cfg, 3)[i]
    return {"frontend_embeds": src} if how == "frames" else {"enc_out": src}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_prefill_captured_equals_eager(family):
    """Three prompts (three encoder outputs) through one captured prefill
    into one cache cleared in place between them, against an eager twin:
    logits, cache and launch counts bit for bit at every call; one
    capture, two replays. The SSM family continues from the cache's
    state, so its twin starts each prompt where the last left off."""
    cfg, pcfg, pp = weights(family)
    cache = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")
    twin = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")
    steps = snap_steps(lambda: (cache,))
    for i, tok in enumerate(prompts(pcfg, 3, seed=1)):
        if family != "ssm":
            PM.clear_cache(cache)
            PM.clear_cache(twin)
        kw = _prefill_kw(family, pcfg, i)
        (want, _), n_eager = counted(lambda: PM.prefill(
            pcfg, pp, tok, twin, impl="kernel", **kw))
        (got, _), n_capt = counted(lambda: PM.prefill(
            pcfg, pp, tok, cache, impl="kernel", steps=steps, **kw))
        assert torch.equal(got, want)
        assert_same(cache, twin)
        assert n_capt == n_eager
    assert (steps.captures, steps.replays) == (1, 2)


def test_encdec_prefill_from_frames_captured():
    """The encoder-decoder prefill fed frame embeddings: the encoder, the
    cross K/V and the decoder in one graph, its frames a static input."""
    cfg, pcfg, pp = weights("encdec")
    cache = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")
    twin = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")
    steps = snap_steps(lambda: (cache,))
    for i, tok in enumerate(prompts(pcfg, 2, seed=2)):
        kw = _prefill_kw("encdec", pcfg, i, how="frames")
        want, _ = PM.prefill(pcfg, pp, tok, PM.clear_cache(twin),
                             impl="kernel", **kw)
        got, _ = PM.prefill(pcfg, pp, tok, PM.clear_cache(cache),
                            impl="kernel", steps=steps, **kw)
        assert torch.equal(got, want)
        assert_same(cache, twin)
    assert (steps.captures, steps.replays) == (1, 1)


def test_model_prefill_recaptures_on_shape_and_cache():
    """One graph per prompt shape (as jax.jit compiles one per shape), and
    a cache at new addresses drops the old graphs."""
    cfg, pcfg, pp = weights("dense")
    cache = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")
    steps = snap_steps()
    (a,), (b,) = prompts(pcfg, 1, 4), prompts(pcfg, 1, 5, length=S - 3)
    for tok in (a, b, a, b):
        PM.prefill(pcfg, pp, tok, PM.clear_cache(cache), impl="kernel",
                   steps=steps)
    assert (steps.captures, steps.replays) == (2, 2)
    other = clone(cache)
    PM.prefill(pcfg, pp, a, PM.clear_cache(other), impl="kernel", steps=steps)
    assert (steps.captures, steps.stats()["graphs"]) == (3, 1)


# ----------------------------------------------------------------------------
# the paged cache's suffix rounds and the drafts' reset
# ----------------------------------------------------------------------------
def test_paged_suffix_rounds_captured_equal_eager():
    """A prefix of 8 tokens seeded into pages, then the 12-token suffix in
    chunks of 4 (three rounds of one shape: one capture, two replays per
    prefill), twice over; tables, pools and logits bit for bit."""
    cfg, pcfg, pp = weights("dense")
    toks = prompts(pcfg, 2, seed=6, length=20)

    def fresh():
        pc = PagedDecodeCache(pcfg, B, MAX_LEN, page_size=4, impl="kernel",
                              device="cpu")
        return pc
    pc, twin = fresh(), fresh()
    steps = snap_steps()
    for t in toks:
        for c in (pc, twin):
            c.reset_tables()
            dense = PM.prefill(pcfg, pp, t[:, :8],
                               PM.init_cache(pcfg, B, MAX_LEN, device="cpu"),
                               impl="kernel")[1]
            c.seed(dense)
        want, n_eager = counted(lambda: twin.prefill(pp, t[:, 8:], chunk=4))
        got, n_capt = counted(lambda: pc.prefill(pp, t[:, 8:], chunk=4,
                                                 steps=steps))
        assert torch.equal(got, want) and n_capt == n_eager
        assert torch.equal(pc.k_pool, twin.k_pool)
        assert torch.equal(pc.v_pool, twin.v_pool)
        assert [x.pages for x in pc.tables] == [x.pages for x in twin.tables]
    assert (steps.captures, steps.replays) == (1, 5)


@pytest.mark.parametrize("kind", ["model", "resident"])
def test_draft_reset_captured_equals_eager(kind):
    """A draft's reset (the prefill of a prompt into its own cache) in the
    backend's pool: two prompts of one length replay one graph; the
    draft's cache and its next proposals equal an eager draft's."""
    from repro_torch.specdec.draft import SmallModelDraft
    from repro_torch.specdec.resident_draft import ResidentDraft
    cfg, pcfg, pp = weights("dense", n_layers=4)

    def make(pool):
        if kind == "model":
            return SmallModelDraft(pcfg, pp, max_len=MAX_LEN, device="cpu",
                                   graph_pool=pool)
        return ResidentDraft(pcfg, pp, [0, 1], max_len=MAX_LEN, device="cpu",
                             graph_pool=pool)
    d, twin = make("fake"), make(None)
    d._prefill_steps = snap_steps()
    rng = np.random.default_rng(7)
    for _ in range(2):
        toks = rng.integers(1, pcfg.vocab_size, 9).tolist()
        twin.reset(toks)
        d.reset(toks)
        assert_same(d._cache, twin._cache)
        assert np.array_equal(d.propose(3)[0], twin.propose(3)[0])
    assert (d._prefill_steps.captures, d._prefill_steps.replays) == (1, 1)


# ----------------------------------------------------------------------------
# the engine's streamed passes: (a), (b), (d), (e)
# ----------------------------------------------------------------------------
PLAN = PE.UniformPlan(1, 2, 1, 1)           # layers 1 and 3 streamed


def _engine(family, mb=B, enc_len=0, headroom=1):
    cfg, pcfg, pp = weights(family, n_layers=4)
    eng = PE.InterleavedEngine(pcfg, PLAN, mb=mb, max_len=MAX_LEN,
                               retier_headroom=headroom, enc_len=enc_len,
                               device="cpu")
    return pcfg, pp, eng


@pytest.mark.parametrize("family", ["dense", "moe-folded", "ssm", "hybrid",
                                    "encdec"])
def test_engine_passes_captured_equal_eager(family):
    """The prompt pass over the tiers (into the state the caller holds)
    and 5 streamed decode passes, captured, against an eager twin engine on
    the same weights: logits, state and launch counts bit for bit at every
    call (the passes replay at later positions); the prompt pass writes
    the caller's cache in place and allocates none."""
    fam = "moe" if family == "moe-folded" else family
    _, pcfg, pp = weights(fam, n_layers=4)
    if family == "moe-folded":
        pcfg = dataclasses.replace(pcfg, first_dense_layers=0)
        pp = PM.init_params(pcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    enc_len = ENC if fam == "encdec" else 0
    engs = [PE.InterleavedEngine(pcfg, PLAN, mb=B, max_len=MAX_LEN,
                                 enc_len=enc_len, device="cpu")
            for _ in range(2)]
    st, twin = (e.init_state(pp) for e in engs)
    steps = snap_steps(lambda: (st,))
    kw = {"enc_out": enc_outs(pcfg, 1)[0]} if enc_len else {}
    (tok,) = prompts(pcfg, 1, seed=8)
    scope = capture.tensor_scope(st)
    (want, wc), n_eager = counted(lambda: engs[1].prefill(tok, **kw))
    (got, gc), n_capt = counted(lambda: engs[0].prefill(
        tok, cache=st, steps=steps, **kw))
    assert gc is st and capture.tensor_scope(st) == scope
    assert torch.equal(got, want) and n_capt == n_eager
    engs[1].seed_cache(twin, wc)
    assert_same(st, twin)
    rng = np.random.default_rng(9)
    for _ in range(5):
        t = torch.from_numpy(rng.integers(1, pcfg.vocab_size, (B, 1))).long()
        (want, _), n_eager = counted(lambda: engs[1].decode_step(twin, t))
        (got, _), n_capt = counted(lambda: engs[0].decode_step(
            st, t, steps=steps))
        assert torch.equal(got, want) and n_capt == n_eager
        assert_same(st, twin)
    assert (steps.captures, steps.replays) == (2, 4)


def test_engine_chunked_rounds_and_verify_captured_equal_eager():
    """prefill_partial's rounds (a 10-token prompt in rounds of 4 and 2:
    two shapes), decode passes, and verify passes of q_len 3 with a
    rollback, captured against an eager twin, bit for bit; a retier drops
    the pass graphs and the next pass captures again, still bit-equal."""
    pcfg, pp, eng = _engine("dense")
    _, _, twin_eng = _engine("dense")
    st, twin = eng.init_state(pp), twin_eng.init_state(pp)
    steps = snap_steps(lambda: (st,))
    pre = snap_steps(lambda: (st,))
    (tok,) = prompts(pcfg, 1, seed=10, length=10)
    want, _ = twin_eng.prefill_partial(twin, tok, chunk=4)
    got, _ = eng.prefill_partial(st, tok, chunk=4, steps=pre)
    assert torch.equal(got, want)
    assert_same(st, twin)
    assert (pre.captures, pre.replays) == (2, 1)
    rng = np.random.default_rng(11)

    def both(fn):
        (w, _), ne = counted(lambda: fn(twin_eng, twin, None))
        (g, _), nc = counted(lambda: fn(eng, st, steps))
        assert torch.equal(g, w) and nc == ne
        assert_same(st, twin)
        return w
    for r in range(4):
        if r == 2:                        # a live retier between passes
            v0 = eng.layout_version
            eng.retier(st, 0, +1)
            twin_eng.retier(twin, 0, +1)
            assert eng.layout_version > v0
        t = torch.from_numpy(rng.integers(1, pcfg.vocab_size, (B, 1))).long()
        lg = both(lambda e, s, x: e.decode_step(s, t, steps=x))
        p0 = st["pos"]
        mat = torch.cat([lg[:, :pcfg.vocab_size].argmax(-1, keepdim=True),
                         torch.from_numpy(rng.integers(1, pcfg.vocab_size,
                                                       (B, 2)))], 1)
        both(lambda e, s, x: e.verify_step(s, mat, steps=x))
        for e, s in ((eng, st), (twin_eng, twin)):
            e.rollback(s, p0 + 1)
    # decode and verify captured before the retier and again after it
    assert steps.captures == 4 and steps.replays == 4


def test_engine_prompt_pass_writes_the_callers_cache():
    """(e): the prompt pass clears and fills the cache given to it, in
    place, inside its body; the body allocates no cache (a new cache
    would live in the graph pool, where other graphs' temporaries
    overwrite it). A cache of other shapes is refused."""
    pcfg, pp, eng = _engine("hybrid")
    st = eng.init_state(pp)
    for v in st.values():                 # stale contents to clear
        if isinstance(v, torch.Tensor):
            v.fill_(3)
    ptrs = capture.tensor_scope(st)
    (tok,) = prompts(pcfg, 1, seed=12)
    made = []

    class Spy(SnapGraphs):
        """Fails the capture where the body makes a cache."""

        def capture(self, fn):
            orig = PM.init_cache

            def init_cache(*a, **k):
                made.append(a)
                return orig(*a, **k)
            PM.init_cache = init_cache
            try:
                return super().capture(fn)
            finally:
                PM.init_cache = orig
    steps = CapturedStep("cpu", graphs=Spy(lambda: (st,)))
    got, cache = eng.prefill(tok, cache=st, steps=steps)
    assert cache is st and capture.tensor_scope(st) == ptrs
    assert steps.captures == 1 and made == []
    want, fresh = eng.prefill(tok)
    assert torch.equal(got, want)
    assert_same(st, fresh)
    bad = PM.init_cache(pcfg, B + 1, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="cache entry"):
        eng.prefill(tok, cache=bad)


def test_engine_pass_recaptures_after_a_weight_load():
    """A new weight load moves the tiers (layout_version): the pass
    graphs are dropped and captured again."""
    pcfg, pp, eng = _engine("dense")
    st = eng.init_state(pp)
    steps = snap_steps(lambda: (st,))
    (tok,) = prompts(pcfg, 1, seed=13, length=1)
    eng.decode_step(st, tok, steps=steps)
    eng.decode_step(st, tok, steps=steps)
    pp2 = dict(pp)
    st = eng.init_state(pp2, reuse=st)
    eng.decode_step(st, tok, steps=steps)
    assert (steps.captures, steps.replays) == (2, 1)


# ----------------------------------------------------------------------------
# (c) against the JAX package
# ----------------------------------------------------------------------------
def _compare(jl, pl, V):
    a, b = f32(jl)[..., :V], f32(pl)[..., :V]
    np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
    clear = margin(a) > LOGIT_TOL
    np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
    return a.argmax(-1)


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "encdec"])
def test_captured_prefill_vs_jax(family):
    """Two prompts through one captured prefill (a capture, then a replay)
    against JAX's jit-compiled M.prefill on the same weights; tolerance
    LOGIT_TOL. The encoder-decoder family takes a static enc_out; the MoE
    family's routes agree at this size (test_torch_moe holds them apart
    where bf16 flips one)."""
    cfg, pcfg, pp = weights(family)
    jp = to_jax(pp)
    cache = PM.init_cache(pcfg, B, MAX_LEN, device="cpu")
    steps = snap_steps(lambda: (cache,))
    jpre = jax.jit(functools.partial(JM.prefill, cfg))
    for i, tok in enumerate(prompts(pcfg, 2, seed=14)):
        kw = _prefill_kw(family, pcfg, i)
        jkw = {k: jnp.asarray(f32(v), jnp.bfloat16) for k, v in kw.items()}
        jc = JM.init_cache(cfg, B, MAX_LEN, **jkw)
        if family == "ssm":
            PM.clear_cache(cache)
        jl, _ = jpre(jp, jnp.asarray(tok.numpy(), jnp.int32), jc, **jkw)
        pl, _ = PM.prefill(pcfg, pp, tok, PM.clear_cache(cache),
                           impl="kernel", steps=steps, **kw)
        _compare(jl[:, -1], pl[:, -1], cfg.vocab_size)
    assert (steps.captures, steps.replays) == (1, 1)


def test_captured_engine_vs_jax():
    """The engine (4 layers, 2 streamed) through captured passes: its
    prompt pass against JAX's M.prefill, then prefill_partial's rounds on
    a fresh state, 4 decode passes and a verify pass of q_len 3 against
    JAX's M.prefill, M.decode_step and M.verify_step on the same weights;
    tolerance LOGIT_TOL."""
    cfg, pcfg, pp = weights("dense", n_layers=4)
    jp = to_jax(pp)
    V = cfg.vocab_size
    eng = PE.InterleavedEngine(pcfg, PLAN, mb=B, max_len=MAX_LEN,
                               device="cpu")
    st = eng.init_state(pp)
    steps, pre = snap_steps(lambda: (st,)), snap_steps(lambda: (st,))
    (tok,) = prompts(pcfg, 1, seed=15)
    jt = jnp.asarray(tok.numpy(), jnp.int32)
    jpre, jdec, jver = (jax.jit(functools.partial(f, cfg)) for f in (
        JM.prefill, JM.decode_step, JM.verify_step))
    jl, jc = jpre(jp, jt, JM.init_cache(cfg, B, MAX_LEN))
    pl, _ = eng.prefill(tok, cache=st, steps=pre)
    _compare(jl[:, -1], pl[:, -1], V)
    st = eng.init_state(pp, reuse=st)
    pl, st = eng.prefill_partial(st, tok, chunk=4, steps=pre)
    nxt = _compare(jl[:, -1], pl[:, -1], V)
    for _ in range(4):
        jl, jc = jdec(jp, jc, jnp.asarray(nxt[:, None], jnp.int32))
        pl, st = eng.decode_step(st, torch.from_numpy(nxt[:, None]).long(),
                                 steps=steps)
        nxt = _compare(jl[:, -1], pl, V)
    mat = np.concatenate([nxt[:, None], np.random.default_rng(16).integers(
        1, V, (B, 2))], 1).astype(np.int32)
    jl, jc = jver(jp, jc, jnp.asarray(mat))
    pl, st = eng.verify_step(st, torch.from_numpy(mat).long(), steps=steps)
    _compare(jl, pl, V)
    assert steps.captures == 2 and steps.replays == 3
    assert pre.captures == 2 and pre.replays == 2


# ----------------------------------------------------------------------------
# the serving backend: every prefill route replays, capture=False none
# ----------------------------------------------------------------------------
def _fake_backend(be):
    """Fake graphs in each of the backend's CapturedSteps; the snapshot
    holds the engine's state (a recurrent pass advances it)."""
    def trees():
        return (be._state,) if isinstance(be._state, dict) else ()
    for name in ("steps", "prefill_steps", "suffix_steps"):
        setattr(be, name, snap_steps(trees))


# route: (family, EngineBackend keywords, through an engine)
ROUTES = {
    "dense": ("dense", {}, False),
    "paged": ("dense", dict(paged=True, page_size=4), False),
    "prefix": ("dense", dict(prefix_cache=True, page_size=4,
                             prefill_chunk_tokens=4), False),
    "engine-chunked": ("dense", dict(prefill_chunk_tokens=4), True),
    "engine-prompt-pass": ("hybrid", {}, True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_backend_prefill_routes_replay_across_epochs(route):
    """Two requests of one prompt length through one slot (two epochs) on
    each route of start_batch with fake graphs: the prefill captured in the
    first epoch and replayed in the second (the prefix cache's second
    epoch replays a suffix round of its first), decode steps replayed, the
    tokens an eager serve's."""
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     EngineBackend, Request, SchedulerConfig)
    family, kw, through_engine = ROUTES[route]
    _, pcfg, pp = weights(family, n_layers=4)
    rng = np.random.default_rng(17)
    shared = rng.integers(1, pcfg.vocab_size, 8)
    reqs = [np.concatenate([shared, rng.integers(1, pcfg.vocab_size, 4)])
            .astype(np.int32) for _ in range(2)]
    outs, stats = {}, None
    for fake in (False, True):
        eng = PE.InterleavedEngine(pcfg, PLAN, mb=1, max_len=MAX_LEN,
                                   device="cpu") if through_engine else None
        be = EngineBackend(pcfg, pp, engine=eng, n_slots=1, max_len=MAX_LEN,
                           device="cpu", **kw)
        if fake:
            _fake_backend(be)
        done = ContinuousBatchingScheduler(be, SchedulerConfig()).serve(
            [Request(i, p, 4) for i, p in enumerate(reqs)])
        outs[fake] = [r.output for r in sorted(done, key=lambda r: r.rid)]
        stats = be.graph_stats
    assert outs[True] == outs[False]
    assert stats["prefill_captures"] >= 1
    assert stats["prefill_replays"] >= 1
    assert stats["replays"] > 0
