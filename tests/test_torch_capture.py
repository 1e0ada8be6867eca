"""The port's captured serving steps (core/capture.py, the counterpart of
the JAX package's jax.jit of its steps), on the CPU.

There is no CUDA graph here, so the graph machinery is a fake injected
into CapturedStep: its capture runs the body under NoHostReads and its
replay re-runs the body captured at the first call (the counters taken
back, as a real replay launches without Python). What a CPU run can show:

(a) the device bodies of every step kind read nothing from the host: no
    ``aten._local_scalar_dense`` (``.item()``, ``int(t)``, ``bool(t)``)
    and no tensor made from host data (``aten.lift_fresh``);
(b) nothing is frozen when a body is built: a body built and run at p0,
    then called at p1 (past a ring wrap for gemma3's windowed layers)
    with the cache's tensors at p1 but its host mirror left at p0, equals
    a fresh eager step at p1 bit for bit (a body that read the host
    position, or any host value of p0, would not);
(c) every step kind through the captured path (fake graphs) against the
    JAX package within the tolerances the parity tests use (LOGIT_TOL,
    greedy equal outside near ties);
(d) the plain versions of kernels 1 and 4 with a 0-d int32 tensor
    position equal their int form bit for bit;
(e) CapturedStep's bookkeeping: one capture per key, again on a new batch
    width, q_len, enc_len, cache or engine layout, but not in a new epoch
    (the engine's state is cleared in place), launch counts added per
    replay, a failed capture raised (never the eager step in its place),
    and a replay with a stale position buffer caught by the comparison.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_parity import LOGIT_TOL, f32, jax_params, margin, port_cfg  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.kvcache.paged_decode import PagedDecodeCache as JPDC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.capture import CapturedStep  # noqa: E402
from repro_torch.kernels.decode_attention import multiquery as mq  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kvcache.paged_decode import PagedDecodeCache  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


class NoHostReads(TorchDispatchMode):
    """Fails on a device-to-host read and on a tensor made from host data."""
    BANNED = ("_local_scalar_dense", "lift_fresh", "lift_fresh_copy")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.BANNED:
            raise AssertionError(f"host read in a step body: {func}")
        return func(*args, **(kwargs or {}))


class FakeGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out


class FakeGraphs:
    """CapturedStep's graph machinery on the CPU: capture runs the body
    once under NoHostReads (the steps it is used with are pure-KV, so a
    second run at the same position writes what the first wrote); replay
    re-runs the body built at the first call into the static output, and
    takes back the counts its Python wrappers add."""
    pool = "fake-pool"

    def __init__(self):
        self.captured = 0
        self.replayed = 0

    @staticmethod
    def warm(fn):
        return fn()

    def capture(self, fn):
        with NoHostReads():
            out = fn()
        self.captured += 1
        return FakeGraph(fn, out), out

    def replay(self, g):
        snap = capture.launch_counts()
        with NoHostReads():
            g.out.copy_(g.fn())
        capture._add_counts({k: snap[k] - v
                             for k, v in capture.launch_counts().items()})
        self.replayed += 1

    @staticmethod
    def pool_bytes():
        return 0


def fake_steps():
    return CapturedStep("cpu", graphs=FakeGraphs())


def pos_t(p):
    return torch.full((), p, dtype=torch.int32)


def clone(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def copy_into(dst, src):
    """src's tensors into dst's in place; dst's host pos left as it was."""
    for k, v in src.items():
        if isinstance(v, torch.Tensor):
            dst[k].copy_(v)


# ----------------------------------------------------------------------------
# the model's step kinds (port configs, port weights: no JAX needed for
# (a) and (b))
# ----------------------------------------------------------------------------
B, S, MAX_LEN = 2, 12, 16
# kind: (arch, config overrides, multi)
MODEL_KINDS = {
    "dense-decode": ("llama3.3-70b", {}, False),
    "dense-verify": ("llama3.3-70b", {}, True),
    "gemma-ring-decode": ("gemma3-1b", {"window_size": 6}, False),
    "gemma-ring-verify": ("gemma3-1b", {"window_size": 6}, True),
    "moe-decode": ("deepseek-moe-16b", {}, False),
    "moe-verify": ("deepseek-moe-16b", {}, True),
    "rwkv6-decode": ("rwkv6-3b", {}, False),
    "hymba-decode": ("hymba-1.5b", {}, False),
    "encdec-decode": ("seamless-m4t-medium", {}, False),
}
ENC_LEN = 8


@functools.lru_cache(maxsize=None)
def _model(arch, overrides):
    from repro_torch.configs import get_smoke_config as port_smoke
    cfg = dataclasses.replace(port_smoke(arch), **dict(overrides))
    params = PM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def model_state(kind, impl="kernel"):
    """(cfg, params, cache after an S-token prompt, step kwargs)."""
    arch, over, multi = MODEL_KINDS[kind]
    cfg, params = _model(arch, tuple(sorted(over.items())))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))).long()
    kw = {}
    cache = PM.init_cache(cfg, B, MAX_LEN, device="cpu")
    if cfg.family.value == "encdec":
        enc = torch.from_numpy(rng.standard_normal(
            (B, ENC_LEN, cfg.d_model)).astype(np.float32)).bfloat16()
        PM.prefill(cfg, params, toks, cache, impl=impl, enc_out=enc)
        kw["enc_len"] = ENC_LEN
    else:
        PM.prefill(cfg, params, toks, cache, impl=impl)
    return cfg, params, cache, dict(kw, impl=impl, multi=multi)


def feed(cfg, n, q_len, seed=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, q_len))).long()
            for _ in range(n)]


def eager_step(cfg, params, cache, tok, kw):
    step = PM.verify_step if kw["multi"] else PM.decode_step
    extra = {"enc_len": kw["enc_len"]} if "enc_len" in kw else {}
    return step(cfg, params, cache, tok, impl=kw["impl"], **extra)[0]


@pytest.mark.parametrize("kind", sorted(MODEL_KINDS))
def test_model_body_reads_nothing_from_the_host(kind):
    cfg, params, cache, kw = model_state(kind)
    q_len = 3 if kw["multi"] else 1
    (tok,) = feed(cfg, 1, q_len)
    PM.step_prelude(cfg, cache, q_len, impl=kw["impl"], multi=kw["multi"],
                    enc_len=kw.get("enc_len", 0))
    p = pos_t(cache["pos"])
    with NoHostReads():
        out = PM.step_body(cfg, params, cache, tok, p, **kw)
    assert out.shape[:2] == (B, q_len) and torch.isfinite(out.float()).all()


# p1 per kind: decode past the 16-slot ring's wrap; a verify window that
# starts past it and does not wrap (slot 1)
P1 = {False: 19, True: 17}


@pytest.mark.parametrize("kind", sorted(MODEL_KINDS))
def test_model_body_freezes_nothing(kind):
    """Tolerance: none, bit for bit (the same ops on the same values)."""
    cfg, params, cache, kw = model_state(kind)
    q_len = 3 if kw["multi"] else 1
    twin = clone(cache)
    body = functools.partial(PM.step_body, cfg, params, cache, **kw)
    p0 = cache["pos"]
    tok0, tok1 = feed(cfg, 2, q_len)
    out0 = body(tok0, pos_t(p0))
    assert torch.equal(out0, eager_step(cfg, params, twin, tok0, kw))
    if kw["multi"]:
        twin["pos"] = p0 + 1             # commit one, as a verify round may
    p1 = P1[kw["multi"]]
    for t in feed(cfg, p1 - twin["pos"], 1, seed=3):
        eager_step(cfg, params, twin, t, dict(kw, multi=False))
    assert twin["pos"] == p1
    copy_into(cache, twin)               # the device state at p1; the host
    assert cache["pos"] == p0            # mirror still says p0
    got = body(tok1, pos_t(p1))
    want = eager_step(cfg, params, twin, tok1, kw)
    assert torch.equal(got, want)
    for k, v in twin.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(cache[k], v), k


# ----------------------------------------------------------------------------
# the paged cache's step and verify
# ----------------------------------------------------------------------------
def paged_state(impl="kernel"):
    cfg, params = _model("llama3.3-70b", ())
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (B, 11))).long()
    dense = PM.init_cache(cfg, B, 32, device="cpu")
    PM.prefill(cfg, params, toks, dense, impl=impl)

    def make():
        pc = PagedDecodeCache(cfg, B, 32, page_size=8, impl=impl,
                              device="cpu")
        pc.seed(dense)
        return pc
    return cfg, params, make


@pytest.mark.parametrize("multi", [False, True], ids=["step", "verify"])
def test_paged_body_reads_nothing_and_freezes_nothing(multi):
    """(a) and (b) for PagedDecodeCache._run, bit for bit: built at
    position 11, called at 17 (a page boundary crossed, tables refreshed)
    with the cache's host pos still 11."""
    cfg, params, make = paged_state()
    pc, twin = make(), make()
    q_len = 3 if multi else 1
    tok0, tok1 = feed(cfg, 2, q_len)
    p0 = pc.pos
    pc._extend_all(p0 + q_len)
    pc._device_tables()

    def body(tok, pos):
        return pc._run(params, tok, pos, multi)
    with NoHostReads():
        out0 = body(tok0, pos_t(p0))
    want0 = twin.verify(params, tok0) if multi else twin.step(params, tok0)
    assert torch.equal(out0, want0)
    if multi:
        twin.commit(1)
    for t in feed(cfg, 17 - twin.pos, 1, seed=3):
        twin.step(params, t)
    pc.k_pool.copy_(twin.k_pool)
    pc.v_pool.copy_(twin.v_pool)
    pc._extend_all(17 + q_len)           # the host prelude of the step at 17
    pc._device_tables()
    assert pc.pos == p0
    with NoHostReads():
        got = body(tok1, pos_t(17))
    want = twin.verify(params, tok1) if multi else twin.step(params, tok1)
    assert [t.pages for t in pc.tables] == [t.pages for t in twin.tables]
    assert torch.equal(got, want)
    assert torch.equal(pc.k_pool, twin.k_pool)


# ----------------------------------------------------------------------------
# the engine's resident-only draft step
# ----------------------------------------------------------------------------
def _engine(cfg, pp, mb=B, max_len=32, k_res=1):
    eng = PE.InterleavedEngine(port_cfg(cfg), PE.UniformPlan(1, 2, k_res, 1),
                               mb=mb, max_len=max_len, retier_headroom=1,
                               device="cpu")
    return eng, eng.init_state(pp)


def port_params(cfg):
    return PM.init_params(port_cfg(cfg), torch.Generator().manual_seed(0),
                          device="cpu")


def test_engine_draft_body_reads_nothing_and_freezes_nothing(
        tiny_dense_factory):
    cfg = tiny_dense_factory(n_layers=4)
    pp = port_params(cfg)
    eng, st = _engine(cfg, pp)
    twin = eng.init_state(pp)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (B, 10))).long()
    eng.prefill_partial(st, toks, chunk=4)
    eng.prefill_partial(twin, toks, chunk=4)
    pcfg = port_cfg(cfg)
    tok0, tok1 = feed(pcfg, 2, 1)

    def body(tok, pos):
        return eng._pass_body(st, tok, pos, multi=False, resident_only=True)
    p0 = st["pos"]
    with NoHostReads():
        out0 = body(tok0, pos_t(p0))
    assert torch.equal(out0[:, 0], eng.draft_step(twin, tok0)[0])
    for t in feed(pcfg, 19 - twin["pos"], 1, seed=3):
        eng.decode_step(twin, t)
    copy_into(st, twin)
    assert st["pos"] == p0
    with NoHostReads():
        got = body(tok1, pos_t(19))
    assert torch.equal(got[:, 0], eng.draft_step(twin, tok1)[0])


# ----------------------------------------------------------------------------
# (c) the captured path against the JAX package
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jitted(cfg):
    """JAX's prefill, decode_step and verify_step for cfg, compiled once
    per process."""
    return tuple(jax.jit(functools.partial(f, cfg))
                 for f in (JM.prefill, JM.decode_step, JM.verify_step))


def _compare(jl, pl, V):
    a, b = f32(jl)[..., :V], f32(pl)[..., :V]
    np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
    clear = margin(a) > LOGIT_TOL
    np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
    return a.argmax(-1)


@pytest.mark.parametrize("name,max_len", [("llama", 32), ("gemma-window6", 16)])
def test_captured_model_steps_vs_jax(name, max_len):
    """10 decode steps (gemma: across the 16-slot ring's wrap), then
    verify passes of q_len 3 and 2 at a rolled-back position, each
    through one graph per shape, against JAX's decode_step and
    verify_step; tolerance LOGIT_TOL (_torch_parity)."""
    g = get_smoke_config("gemma3-1b")
    cfg = {"llama": get_smoke_config("llama3.3-70b"),
           "gemma-window6": dataclasses.replace(g, window_size=6)}[name]
    pcfg, V = port_cfg(cfg), cfg.vocab_size
    jp, _, pp = jax_params(cfg)
    toks = np.random.default_rng(1).integers(1, V, (B, 10)).astype(np.int32)
    jpre, jdec, jver = jitted(cfg)
    jl, jc = jpre(jp, jnp.asarray(toks), JM.init_cache(cfg, B, max_len))
    pc = PM.init_cache(pcfg, B, max_len, device="cpu")
    pl, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(), pc,
                        impl="kernel")
    tok = _compare(jl[:, -1], pl[:, -1], V)
    steps = fake_steps()
    for _ in range(10):
        jl, jc = jdec(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
        pl, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(tok[:, None]),
                                impl="kernel", steps=steps)
        tok = _compare(jl[:, -1], pl[:, -1], V)
    assert (steps.captures, steps.replays) == (1, 9)
    rng = np.random.default_rng(2)
    for q_len in (3, 2, 3):
        p0 = pc["pos"]
        mat = np.concatenate([tok[:, None], rng.integers(1, V, (B, q_len - 1))],
                             1).astype(np.int32)
        jl, jc = jver(jp, jc, jnp.asarray(mat))
        pl, pc = PM.verify_step(pcfg, pp, pc, torch.from_numpy(mat).long(),
                                impl="kernel", steps=steps)
        am = _compare(jl, pl, V)
        np.testing.assert_array_equal(pc["pos_ids"].numpy(),
                                      np.asarray(jc["pos_ids"]))
        jc = dict(jc, pos=jnp.int32(p0 + 1))      # commit one
        pc["pos"] = p0 + 1
        tok = am[:, 0]
    assert (steps.captures, steps.replays) == (3, 10)


@pytest.mark.parametrize("page_size", [8])
def test_captured_paged_steps_vs_jax(page_size):
    """The paged cache's step and verify through their graphs, against
    the JAX PagedDecodeCache (_paged_decode_step / _paged_verify_step)
    and JAX's dense decode_step and verify_step on the same tokens
    (LOGIT_TOL): 7 decode steps across a page boundary, a verify of q_len
    4, commit 2, 2 more steps."""
    cfg = get_smoke_config("llama3.3-70b")
    pcfg, V = port_cfg(cfg), cfg.vocab_size
    jp, _, pp = jax_params(cfg)
    toks = np.random.default_rng(7).integers(1, V, (B, 11)).astype(np.int32)
    jpre, jdec, jver = jitted(cfg)
    jl, jc = jpre(jp, jnp.asarray(toks), JM.init_cache(cfg, B, 32))
    _, dense = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                          PM.init_cache(pcfg, B, 32, device="cpu"))
    ppc = PagedDecodeCache(pcfg, B, 32, page_size=page_size, impl="kernel",
                           device="cpu")
    ppc.seed(dense)
    jpc = JPDC(cfg, B, 32, page_size=page_size)
    jpc.seed(jc)
    steps = fake_steps()
    tok = np.array(jnp.argmax(jl[:, -1, :V], -1), np.int32)

    def step(tok):
        nonlocal jc
        jl, jc = jdec(jp, jc, jnp.asarray(tok[:, None]))
        got = ppc.step(pp, torch.from_numpy(tok[:, None]), steps=steps)[:, -1]
        _compare(jpc.step(jp, jnp.asarray(tok[:, None]))[:, -1], got, V)
        return _compare(jl[:, -1], got, V)
    for _ in range(7):
        tok = step(tok)
    draft = np.concatenate([tok[:, None], np.random.default_rng(8).integers(
        1, V, (B, 3))], 1).astype(np.int32)
    p0 = ppc.pos
    jl, jc = jver(jp, jc, jnp.asarray(draft))
    got = ppc.verify(pp, torch.from_numpy(draft), steps=steps)
    _compare(jpc.verify(jp, jnp.asarray(draft)), got, V)
    _compare(jl, got, V)
    ppc.commit(2)
    jpc.commit(2)
    jc = dict(jc, pos=jnp.int32(p0 + 2))
    tok = draft[:, 2]
    for _ in range(2):
        tok = step(tok)
    assert [t.pages for t in ppc.tables] == [t.pages for t in jpc.tables]
    assert (steps.captures, steps.replays) == (2, 8)


def test_captured_engine_draft_vs_jax(tiny_dense_factory):
    """The engine's resident-only draft step through its graph against
    JAX's decode_step over the resident layers (the draft model: the
    stack cut to them, on the engine's cache rows of those layers), 4
    steps then a rollback and 3 more, across a retier that moves the tier
    boundary (a new layout: captured again); LOGIT_TOL."""
    cfg = tiny_dense_factory(n_layers=4)
    V = cfg.vocab_size
    jp, _, pp = jax_params(cfg)
    eng, st = _engine(cfg, pp, k_res=2)
    steps = fake_steps()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, V, (B, 10))).long()
    pl, st = eng.prefill_partial(st, toks, chunk=4)
    tok = pl[:, -1, :V].argmax(-1).numpy()

    def jax_draft(tok):
        res = eng.resident_layer_ids()
        tcfg = dataclasses.replace(cfg, n_layers=len(res))
        tjp = dict(jp, layers=jax.tree.map(lambda a: a[np.asarray(res)],
                                           jp["layers"]))
        jc = {"pos": jnp.int32(st["pos"]),
              "pos_ids": jnp.asarray(st["pos_ids"].numpy()),
              "k": jnp.asarray(f32(st["k"][res])).astype(jnp.bfloat16),
              "v": jnp.asarray(f32(st["v"][res])).astype(jnp.bfloat16)}
        return jitted(tcfg)[1](tjp, jc, jnp.asarray(tok[:, None],
                                                    jnp.int32))[0][:, 0]

    p0 = st["pos"]
    for _ in range(4):
        want = jax_draft(tok)
        lg, st = eng.draft_step(st, torch.from_numpy(tok[:, None]).long(),
                                steps=steps)
        tok = _compare(want, lg, V)
    st = eng.rollback(st, p0)
    st, _ = eng.retier(st, 0, +1)
    for _ in range(3):
        want = jax_draft(tok)
        lg, st = eng.draft_step(st, torch.from_numpy(tok[:, None]).long(),
                                steps=steps)
        tok = _compare(want, lg, V)
    assert (steps.captures, steps.replays) == (2, 5)


# ----------------------------------------------------------------------------
# (d) the plain versions of kernels 1 and 4 take a tensor position
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", [9, 21])
def test_plain_kernels_take_a_tensor_position(pos, window):
    """Bit for bit: the same comparisons on the same values."""
    rng = np.random.default_rng(0)
    S_c = 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()
    k, v = t(2, S_c, 2, 64), t(2, S_c, 2, 64)
    ids = pos - (pos - np.arange(S_c)) % S_c     # the ring at pos
    ids = torch.from_numpy(np.where(ids < 0, -1, ids).astype(np.int32))
    q1, q4 = t(2, 1, 8, 64), t(2, 3, 8, 64)
    p = pos_t(pos)
    assert torch.equal(da.decode_attention_plain(q1, k, v, ids, p, window=window),
                       da.decode_attention_plain(q1, k, v, ids, pos, window=window))
    assert torch.equal(da.decode_attention(q1, k, v, ids, p, window=window),
                       da.decode_attention(q1, k, v, ids, pos, window=window))
    assert torch.equal(
        mq.mq_decode_attention_plain(q4, k, v, ids, p - 2, window=window),
        mq.mq_decode_attention_plain(q4, k, v, ids, pos - 2, window=window))
    assert torch.equal(mq.mq_decode_attention(q4, k, v, ids, p - 2, window=window),
                       mq.mq_decode_attention(q4, k, v, ids, pos - 2,
                                              window=window))


# ----------------------------------------------------------------------------
# (e) CapturedStep's bookkeeping
# ----------------------------------------------------------------------------
def counted_body(calls):
    """A body that launches "one kernel" (bumps kernel 1's counters) and
    reads its position from the device."""
    def body(tok, pos):
        calls.append(1)
        da.launches += 1
        da.hopper_launches += 2
        return tok.float() * 2 + pos
    return body


def test_captures_once_per_key_and_counts_every_replay():
    steps = fake_steps()
    calls = []
    body = counted_body(calls)
    n0 = (da.launches, da.hopper_launches)

    def run(b, q, p, scope=("cache", 1), key=("k",)):
        tok = torch.arange(b * q).reshape(b, q)
        out = steps.run(key, body, tok, p, scope=lambda: scope)
        assert torch.equal(out, tok.float() * 2 + p)      # the position read
        return out                                        # at this call
    run(2, 1, 5)
    assert (steps.captures, steps.replays) == (1, 0)
    assert (da.launches - n0[0], da.hopper_launches - n0[1]) == (1, 2)
    run(2, 1, 6)
    run(2, 1, 40)
    assert (steps.captures, steps.replays) == (1, 2)
    assert (da.launches - n0[0], da.hopper_launches - n0[1]) == (3, 6)
    run(3, 1, 7)                         # batch width
    run(2, 4, 8)                         # q_len
    run(2, 1, 9)                         # back: replayed
    assert (steps.captures, steps.replays) == (3, 3)
    run(2, 1, 9, key=("k", 6))           # a caller's key (enc_len)
    assert steps.captures == 4
    run(2, 1, 10, scope=("cache", 2))    # another cache: every graph dropped
    run(3, 1, 11, scope=("cache", 2))
    assert (steps.captures, steps.replays) == (6, 3)
    assert (da.launches - n0[0], da.hopper_launches - n0[1]) == (9, 18)
    assert steps.stats()["graphs"] == 2


def test_model_step_recaptures_on_enc_len_and_cache():
    cfg, params, cache, kw = model_state("encdec-decode")
    steps = fake_steps()
    tok = feed(cfg, 1, 1)[0]
    for enc_len in (ENC_LEN, ENC_LEN, ENC_LEN - 2, ENC_LEN):
        PM.decode_step(cfg, params, cache, tok, impl="kernel", enc_len=enc_len,
                       steps=steps)
    assert (steps.captures, steps.replays) == (2, 2)
    other = clone(cache)                 # a cache at other addresses
    PM.decode_step(cfg, params, other, tok, impl="kernel", enc_len=ENC_LEN,
                   steps=steps)
    PM.decode_step(cfg, params, other, tok, impl="kernel", enc_len=ENC_LEN,
                   steps=steps)
    assert (steps.captures, steps.replays) == (3, 3)


def test_engine_draft_recaptures_after_a_retier(tiny_dense_factory):
    cfg = tiny_dense_factory(n_layers=4)
    pp = port_params(cfg)
    eng, st = _engine(cfg, pp, k_res=2)
    steps = fake_steps()
    eng.prefill_partial(st, torch.ones((B, 6), dtype=torch.long), chunk=0)
    tok = torch.ones((B, 1), dtype=torch.long)
    v0 = eng.layout_version
    for _ in range(3):
        eng.draft_step(st, tok, steps=steps)
    assert steps.captures == 1
    st, _ = eng.retier(st, 0, +1)
    assert eng.layout_version > v0
    eng.draft_step(st, tok, steps=steps)
    eng.draft_step(st, tok, steps=steps)
    assert (steps.captures, steps.replays) == (2, 3)
    eng.decode_step(st, tok)             # no CapturedStep: eager
    assert steps.stats()["graphs"] == 1
    eng.decode_step(st, tok, steps=steps)   # a streamed pass: captured
    assert (steps.captures, steps.stats()["graphs"]) == (3, 2)


def test_engine_state_keeps_its_addresses_across_epochs(tiny_dense_factory):
    """init_state(reuse=) clears the state in place and seed_cache writes
    the prompt pass's cache into it, so a draft graph over the state stays
    valid for the next epoch: its scope does not move, and the reused
    state equals a fresh one bit for bit."""
    cfg = tiny_dense_factory(n_layers=4)
    pp = port_params(cfg)
    eng, st = _engine(cfg, pp)
    scope = capture.tensor_scope(st)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (B, 10))).long()
    for _ in range(2):
        st = eng.seed_cache(eng.init_state(pp, reuse=st), eng.prefill(toks)[1])
        assert capture.tensor_scope(st) == scope
        eng.decode_step(st, toks[:, :1])
    fresh = eng.seed_cache(eng.init_state(pp), eng.prefill(toks)[1])
    eng.decode_step(fresh, toks[:, :1])
    for key, v in fresh.items():
        assert (torch.equal(st[key], v) if isinstance(v, torch.Tensor)
                else st[key] == v), key


def test_backend_captures_the_engine_draft_once_across_epochs(
        tiny_dense_factory):
    """A sporadic serve of two requests (two epochs) with the engine's
    resident draft, the backend's draft steps on fake graphs: the engine's
    state is cleared in place between epochs, so its draft step is
    captured once and replayed in both; tokens equal an eager serve's."""
    from repro_torch.serving import LimeServer
    from repro_torch.specdec import SpecConfig
    cfg = tiny_dense_factory(n_layers=4)
    pp = port_params(cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(2)]
    outs = {}
    for fake in (False, True):
        eng, _ = _engine(cfg, pp, mb=4)
        srv = LimeServer(port_cfg(cfg), pp, engine=eng, max_len=32,
                         pattern="sporadic", prefill_chunk_tokens=4,
                         spec=SpecConfig(k=3, draft="resident",
                                         adapt_k=False))
        be = srv.make_backend()
        if fake:
            be.draft_steps = fake_steps()
        for p in prompts:
            srv.queue.submit(p, 6)
        outs[fake] = [r.output for r in sorted(srv.serve_all(),
                                               key=lambda r: r.rid)]
    assert outs[True] == outs[False]
    g = be.graph_stats
    assert (g["draft_captures"], g["draft_graphs"]) == (1, 1)
    assert g["draft_replays"] > 0


class FailingGraphs(FakeGraphs):
    def capture(self, fn):
        raise RuntimeError("capture failed")


def test_a_failed_capture_raises_and_runs_no_eager_step():
    """The warm-up is the one eager run of the body; the failed capture
    raises instead of handing back an eager step in its place."""
    steps = CapturedStep("cpu", graphs=FailingGraphs())
    calls = []
    n0 = da.launches
    with pytest.raises(RuntimeError, match="capture failed"):
        steps.run(("k",), counted_body(calls), torch.zeros((2, 1)), 3)
    assert len(calls) == 1 and da.launches - n0 == 1
    assert steps.captures == 0


def test_capture_is_off_on_the_cpu_and_when_asked():
    assert not CapturedStep("cpu").enabled
    assert not CapturedStep("cpu", enabled=False, graphs=None).enabled
    assert not CapturedStep.sharing(None, "cpu").enabled     # capture off
    calls = []
    out = CapturedStep("cpu").run(("k",), counted_body(calls),
                                  torch.ones((1, 1)), 4)
    assert out.item() == 6 and len(calls) == 1


class StaleSteps(CapturedStep):
    """A planted fault: the replay's position buffer is not refreshed."""

    @staticmethod
    def _feed(e, tokens, pos):
        e.tokens.copy_(tokens)
        if e.graph is None:               # written once, at capture
            e.pos.fill_(pos)


def test_a_stale_position_buffer_is_caught():
    """The bit-equality check against the eager step rejects a replay
    whose position buffer kept the captured position."""
    cfg, params, cache, kw = model_state("dense-decode")
    twin = clone(cache)
    steps = StaleSteps("cpu", graphs=FakeGraphs())
    same = []
    for tok in feed(cfg, 3, 1):
        got, _ = PM.decode_step(cfg, params, cache, tok, impl="kernel",
                                steps=steps)
        want, _ = PM.decode_step(cfg, params, twin, tok, impl="kernel")
        same.append(torch.equal(got, want))
    assert same[0] and not any(same[1:])
