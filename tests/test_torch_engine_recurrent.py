"""The port's interleaved engine on the recurrent families (RWKV6: SSM,
Hymba: hybrid), long_mode and the engine's page accounting, against the
JAX package and the port's own model, on the CPU (the streamed tier is
plain host memory there, the copies synchronous; the kernels run their
plain versions).

- The engine (smoke configs cut to 4 layers, 2 segments of 1 resident + 1
  streamed layer; weights from JAX's init_params through convert.py):
  its prompt pass over the tiers, seed_cache, then 6 decode steps fed the
  reference's picks, against JAX's M.prefill + M.decode_step (RWKV6) or
  JAX's token-by-token M.decode_step (Hymba: JAX's hybrid prefill leaves
  the cache empty, ROADMAP reference faults), impl "ref". Logits within
  LOGIT_TOL, greedy equal outside near ties (test_torch_engine._compare);
  Hymba's prefilled cache within STATE_TOL of the token-by-token one.
- The engine against the port's model bit for bit: the prompt pass leaves
  M.prefill's cache and logits on the same stacked weights, and decode
  steps equal M.decode_step's; a streamed layer run from the other load
  buffer (a planted fault) does not.
- A retier mid-stream changes no logit; the refusals are JAX's words.
- long_mode on gemma3's smoke config (window 6, a 10-token prompt in a
  6-slot ring) against JAX's single-device decode_step(long_mode=True).
- Page accounting: pages_in_use and the slot tables after seed, decode
  steps, free, note_committed and prefill_partial equal the JAX engine's
  own accounting replayed on the same sequence; the paged round trip is an
  identity on shuffled tables; a paged Hymba serve equals the unpaged one.
- The launcher serves a recurrent model through the engine when
  --hbm-bytes streams some of its layers.
"""
import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (STATE_TOL, f32, jax_params, jax_stepwise,  # noqa: E402
                           margin, port_cfg)
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serving import LimeServer  # noqa: E402
from repro_torch.specdec import SpecConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

# The engine equals the port's model bit for bit (below), so it drifts from
# jit-compiled JAX exactly as the model does (test_torch_engine.LOGIT_TOL:
# XLA fuses across ops and skips bf16 roundings eager PyTorch takes; the
# drift grows with depth). On these 4-layer recurrent configs the port's
# model and the engine read up to 0.06 (RWKV6) and 0.08 (Hymba) at
# |logit| ~1-3 over a prefill and 6 decode steps.
LOGIT_TOL = 0.25
RECURRENT = ["rwkv6-3b", "hymba-1.5b"]
PLAN = PE.UniformPlan(1, 2, 1, 1)          # layers 1 and 3 streamed
B, P, MAX_LEN = 2, 10, 32


def _cfg(arch, n_layers=4, **kw):
    return dataclasses.replace(get_smoke_config(arch), n_layers=n_layers, **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(scope="module")
def memo():
    """Made once per module, read by every case that needs it: a config's
    converted weights, and the single-device serves the engine's serves
    are held to."""
    return {}


def _weights(memo, cfg):
    """jax_params(cfg), converted once per module (configs key by repr)."""
    key = ("w", repr(cfg))
    if key not in memo:
        memo[key] = jax_params(cfg)
    return memo[key]


def _engine(cfg, pp, mb=B, max_len=MAX_LEN, plan=PLAN, **kw):
    eng = PE.InterleavedEngine(port_cfg(cfg), plan, mb=mb, max_len=max_len,
                               device="cpu", **kw)
    return eng, eng.init_state(pp)


def _compare(jl, pl, V):
    """Logits within LOGIT_TOL, greedy equal outside near ties; returns the
    reference's argmax."""
    a, b = f32(jl)[..., :V], f32(pl)[..., :V]
    np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
    clear = margin(a) > LOGIT_TOL
    np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
    return a.argmax(-1)


def _prompts(cfg, seed=5, n=B, length=P):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (n, length)).astype(np.int32)


# ----------------------------------------------------------------------------
# the recurrent families against JAX and the port's model
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_recurrent_vs_jax(arch, memo):
    """The prompt pass over the tiers + seed_cache + 6 decode steps,
    teacher-forced on the reference's picks."""
    cfg = _cfg(arch)
    V = cfg.vocab_size
    jp, _, pp = _weights(memo, cfg)
    toks = _prompts(cfg)
    eng, st = _engine(cfg, pp)
    assert eng.resident_layer_ids() == [0, 2]
    jdecode = jax.jit(functools.partial(JM.decode_step, cfg))
    if arch == "hymba-1.5b":
        # JAX's hybrid prefill leaves the cache empty: its token-by-token
        # run is the reference (the logits of its last prompt step are the
        # prefill's)
        jl, jc = jax_stepwise(cfg, jp, toks, toks[:, :0], MAX_LEN)
        jl = jl[0]
    else:
        jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
            jp, jnp.asarray(toks), JM.init_cache(cfg, B, MAX_LEN))
        jl = jl[:, -1]
    pl, cache = eng.prefill(_t(toks))
    st = eng.seed_cache(st, cache)
    assert st["pos"] == int(jc["pos"]) == P
    for key, val in st.items():
        if key == "pos":
            continue
        ref = f32(jc[key])
        if key == "pos_ids":
            np.testing.assert_array_equal(val.numpy(), ref)
        else:
            np.testing.assert_allclose(f32(val), ref,
                                       atol=STATE_TOL * np.abs(ref).max(),
                                       err_msg=key)
    tok = _compare(jl, pl[:, -1], V)
    for _ in range(6):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
        pl, st = eng.decode_step(st, _t(tok[:, None]))
        tok = _compare(jl[:, -1], pl, V)
    assert st["pos"] == int(jc["pos"]) == P + 6


@pytest.mark.parametrize("arch", RECURRENT + ["llama3.3-70b"])
def test_engine_prefill_and_decode_match_port_model_bitwise(arch, memo):
    """The engine's prompt pass leaves M.prefill's cache and logits on the
    same stacked weights, bit for bit (resident layers from their flat HBM
    tensors, streamed ones through the load buffers), and its decode steps
    equal M.decode_step's, both at the engine's impl "kernel" (the kernels'
    plain versions on the CPU). Running a streamed layer from the other load
    buffer (a planted fault) breaks the equality."""
    cfg = _cfg(arch)
    pcfg = port_cfg(cfg)
    _, _, pp = _weights(memo, cfg)
    toks = _t(_prompts(cfg, seed=6))
    eng, st = _engine(cfg, pp)
    el, cache = eng.prefill(toks)
    ml, mc = PM.prefill(pcfg, pp, toks, PM.init_cache(pcfg, B, MAX_LEN,
                                                      device="cpu"),
                        impl="kernel")
    assert torch.equal(el, ml)
    assert cache.keys() == mc.keys()
    for key in mc:
        if key != "pos":
            assert torch.equal(cache[key], mc[key]), key
    assert cache["pos"] == mc["pos"] == P
    st = eng.seed_cache(st, cache)
    tok = ml[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(3):
        el, st = eng.decode_step(st, tok)
        ml, mc = PM.decode_step(pcfg, pp, mc, tok, impl="kernel")
        assert torch.equal(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    for key in mc:
        if key != "pos":
            assert torch.equal(st[key], mc[key]), key
    # planted fault: every streamed layer reads the other buffer (the next
    # streamed layer's weights, prefetched, or a stale copy)
    eng._buf_views.reverse()
    bad, _ = eng.prefill(toks)
    good, _ = PM.prefill(pcfg, pp, toks, PM.init_cache(pcfg, B, MAX_LEN,
                                                       device="cpu"),
                         impl="kernel")
    assert (bad.float() - good.float()).abs().max() > 0.1


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_retier_mid_stream_changes_no_logit(arch, memo):
    """Greedy decode with retier(+1) after step 1 and retier(-1) after step
    3 gives the logits of the run without retier, bit for bit: 6 layers in
    2 chunks of 2 resident + 1 streamed, a demotion streams layers 1 and 4
    ahead of the streamed tails 2 and 5 (the recurrent states, like the
    K/V, stay indexed by layer id)."""
    cfg = _cfg(arch, n_layers=6)
    _, _, pp = _weights(memo, cfg)
    toks = _t(_prompts(cfg, seed=7))
    runs = []
    for retier in (False, True):
        eng, st = _engine(cfg, pp, plan=PE.UniformPlan(1, 2, 2, 1),
                          retier_headroom=1)
        lg, cache = eng.prefill(toks)
        st = eng.seed_cache(st, cache)
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        out = [lg[:, -1]]
        for step in range(5):
            if retier and step == 1:
                st, freed = eng.retier(st, 0, +1)
                assert freed > 0 and eng.resident_layer_ids() == [0, 3]
            if retier and step == 3:
                st, _ = eng.retier(st, 0, -1)
                assert eng.resident_layer_ids() == [0, 1, 3, 4]
            lg, st = eng.decode_step(st, tok)
            out.append(lg)
            tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        runs.append(torch.stack(out))
    assert torch.equal(runs[0], runs[1])


def test_refusals_are_jax_words():
    """Verification, the resident self-draft and chunked prefill need
    pure-KV per-layer state: the port's engine refuses the recurrent
    families with the JAX engine's own messages (its engine built on one
    CPU device, nothing run). The VLM is refused at construction (the
    MoE family's refusal of a dense first layer: test_torch_moe.py)."""
    mesh = jax.make_mesh((1,), ("data",))
    for arch in RECURRENT:
        cfg = _cfg(arch)
        je = JE.InterleavedEngine(cfg, mesh, JE.UniformPlan(1, 2, 1, 1),
                                  mb=B, max_len=MAX_LEN, fetch_mode="slot")
        pe = PE.InterleavedEngine(port_cfg(cfg), PLAN, mb=B, max_len=MAX_LEN,
                                  device="cpu")
        toks = np.zeros((B, 3), np.int32)
        for name in ("verify_step", "draft_step", "prefill_partial"):
            with pytest.raises(NotImplementedError) as jerr:
                getattr(je, name)(None, toks)
            with pytest.raises(NotImplementedError) as perr:
                getattr(pe, name)(None, _t(toks))
            assert str(perr.value) == str(jerr.value), name
    for arch in ("pixtral-12b",):
        with pytest.raises(NotImplementedError, match="not Family.VLM"):
            PE.InterleavedEngine(port_cfg(_cfg(arch)), PLAN, device="cpu")


# ----------------------------------------------------------------------------
# long_mode
# ----------------------------------------------------------------------------
def test_long_mode_vs_jax_decode_step(memo):
    """gemma3's smoke config (local:global) with window 6 in long_mode:
    every layer windowed, a 6-slot ring. A 10-token prompt outruns the
    ring: the engine's prompt pass (windowed flash, K/V ring-rolled)
    seeded by seed_cache, and the same prompt fed token by token through
    the engine's decode_step (what the JAX engine's long_mode test drives),
    then 6 decode steps each, against JAX's single-device
    decode_step(long_mode=True) run token by token from an empty cache."""
    cfg = _cfg("gemma3-1b", window_size=6)
    V = cfg.vocab_size
    jp, _, pp = _weights(memo, cfg)
    toks = _prompts(cfg, seed=8)
    jdecode = jax.jit(functools.partial(JM.decode_step, cfg, long_mode=True))
    jc = JM.init_cache(cfg, B, 16, long_mode=True)
    assert jc["k"].shape[2] == 6
    ref = []
    for t in range(P):
        jl, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        ref.append(jl[:, -1])
    for mode in ("prefill", "stepwise"):
        eng, st = _engine(cfg, pp, max_len=16, long_mode=True)
        assert eng.S_c == 6 and eng.windows == [6] * 4
        assert st["k"].shape[2] == 6
        if mode == "prefill":
            pl, cache = eng.prefill(_t(toks))
            st = eng.seed_cache(st, cache)
            pl = pl[:, -1]
        else:
            for t in range(P):
                pl, st = eng.decode_step(st, _t(toks[:, t:t + 1]))
                _compare(ref[t], pl, V)
        tok = _compare(ref[-1], pl, V)
        kc = dict(jc)
        for _ in range(6):
            jl, kc = jdecode(jp, kc, jnp.asarray(tok[:, None], jnp.int32))
            pl, st = eng.decode_step(st, _t(tok[:, None]))
            tok = _compare(jl[:, -1], pl, V)
        np.testing.assert_array_equal(st["pos_ids"].numpy(),
                                      np.asarray(kc["pos_ids"]))


# ----------------------------------------------------------------------------
# the engine's page accounting
# ----------------------------------------------------------------------------
def _shuffle_free_list(eng, rng):
    """Churn the engine's pool so its free list hands out pages out of
    order: tables grown in a random interleave, then released."""
    for slot in rng.permutation(eng.mb):
        eng.extend_slot(int(slot), int(rng.integers(1, eng.S_c)))
    for slot in rng.permutation(eng.mb):
        eng.free_slot(int(slot))
    assert eng.paged_stats()["pages_in_use"] == 0


def test_paged_accounting_matches_jax_engine(memo):
    """seed_cache, decode_requests (some slots idle), free_slot,
    note_committed and prefill_partial's release-then-extend move the
    port's tables as the JAX engine's own accounting moves on the same
    sequence (its host-side methods, replayed); drafts never extend."""
    cfg = _cfg("llama3.3-70b")
    mb, ps = 4, 4
    _, _, pp = _weights(memo, cfg)
    eng, st = _engine(cfg, pp, mb=mb, paged=True, page_size=ps)
    je = JE.InterleavedEngine(cfg, jax.make_mesh((1,), ("data",)),
                              JE.UniformPlan(1, 2, 1, 1), mb=mb,
                              max_len=MAX_LEN, fetch_mode="slot", paged=True,
                              page_size=ps)

    def same():
        a, b = eng.paged_stats(), je.paged_stats()
        assert a == b, (a, b)
        assert [t.pages for t in eng.slot_tables] \
            == [t.pages for t in je.slot_tables]
    toks = _t(_prompts(cfg, seed=9, n=mb))
    lg, cache = eng.prefill(toks)
    st = eng.seed_cache(st, cache)
    je._paged_pos = P
    je._paged_seed_slots(P)                 # what the JAX seed_cache does
    same()
    assert eng.paged_stats()["pages_in_use"] == mb * 3      # ceil(10 / 4)
    active = np.array([1, 1, 0, 1], bool)
    tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(3):
        lg, st = eng.decode_requests(st, tok, torch.from_numpy(active))
        je._paged_pos += 1                  # what the JAX decode_requests does
        for slot in np.flatnonzero(active):
            je.extend_slot(int(slot), je._paged_pos)
        same()
        tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    assert eng.paged_stats()["slot_tokens"] == [13, 13, 10, 13]
    eng.free_slot(1)
    je.free_slot(1)
    same()
    pos = st["pos"]
    eng.draft_step(st, tok)                 # drafts never extend
    eng.rollback(st, pos)
    same()
    for commit in (pos + 3, pos + 7):
        eng.note_committed(commit, active)
        je.note_committed(commit, active)
        same()
    assert eng.paged_stats()["pages_in_use"] == 3 * 5 + 3   # 20 tokens, 10
    st = eng.init_state(pp)
    _, st = eng.prefill_partial(st, toks[:, :6], chunk=4)
    je._paged_pos = 6
    je._paged_seed_slots(6)                 # JAX prefill_partial's rebuild
    same()
    assert eng.paged_stats()["slot_tokens"] == [6] * mb


@pytest.mark.parametrize("arch", ["llama3.3-70b", "hymba-1.5b"])
def test_paged_round_trip_is_identity_on_shuffled_tables(arch, memo):
    """seed_cache on a churned pool: the tables hold pages out of order,
    the K/V that come back through them equal the cache bit for bit, and
    the decode steps that follow equal an unpaged engine's."""
    cfg = _cfg(arch)
    _, _, pp = _weights(memo, cfg)
    toks = _t(_prompts(cfg, seed=10))
    eng, st = _engine(cfg, pp, paged=True, page_size=4)
    ref, rst = _engine(cfg, pp)
    _shuffle_free_list(eng, np.random.default_rng(0))
    lg, cache = eng.prefill(toks)
    k, v = cache["k"].clone(), cache["v"].clone()
    st = eng.seed_cache(st, cache)
    pages = [t.pages for t in eng.slot_tables]
    assert any(p != sorted(p) or p != list(range(p[0], p[0] + len(p)))
               for p in pages), pages
    assert torch.equal(st["k"], k) and torch.equal(st["v"], v)
    # the round trip alone, on a random stack: an identity
    x = torch.randn(k.shape).to(k.dtype)
    assert torch.equal(eng._through_pages(x, P), x)
    rl, rc = ref.prefill(toks)
    rst = ref.seed_cache(rst, rc)
    assert torch.equal(lg, rl)
    tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(3):
        lg, st = eng.decode_requests(st, tok, torch.ones(B, dtype=torch.bool))
        rl, rst = ref.decode_step(rst, tok)
        assert torch.equal(lg, rl)
        tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)


# ----------------------------------------------------------------------------
# serving and the launcher
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch,length,paged", [
    ("rwkv6-3b", 9, False), ("hymba-1.5b", 9, False),
    # 140 prompt tokens outrun the smoke window's 128-slot ring
    ("hymba-1.5b", 140, False), ("hymba-1.5b", 140, True)])
def test_engine_serve_equals_single_device_serve(arch, length, paged, memo):
    """LimeServer through the engine (the prompt pass over the tiers and
    seed_cache) emits the single-device path's tokens on the same weights,
    an uneven bursty batch; a paged engine's pages are freed as requests
    finish."""
    cfg = _cfg(arch)
    _, _, pp = _weights(memo, cfg)
    max_len = 256
    rng = np.random.default_rng(11)
    lens = [length, length - 4, length, length - 6]
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    def serve(eng):
        srv = LimeServer(port_cfg(cfg), pp, engine=eng, max_len=max_len,
                         pattern="bursty", device="cpu")
        for i, p in enumerate(prompts):
            srv.queue.submit(p, 4 + i)
        return [r.output for r in sorted(srv.serve_all(),
                                         key=lambda r: r.rid)]
    key = ("single-device", arch, length)      # the paged cases share it
    if key not in memo:
        memo[key] = serve(None)
    eng = PE.InterleavedEngine(port_cfg(cfg), PLAN, mb=4, max_len=max_len,
                               paged=paged, page_size=16, device="cpu")
    got = serve(eng)
    if eng.paged:
        assert eng.paged_stats()["pages_in_use"] == 0
    assert memo[key] == got


@pytest.mark.parametrize("arch,layers,hbm,plan", [
    ("rwkv6-3b", "4", "4e6", "n_seg 2, k_res 1, k_off 1, resident layers 2"),
    ("hymba-1.5b", "4", "4e6", "n_seg 2, k_res 1, k_off 1, resident layers 2"),
    # at 6 layers and this budget plan_for would keep 4 Hymba layers by
    # the config's count (1.44 MB each, a 5.98 MB share), which hold 4 x
    # 1.60 MB packed; planned by the packed size it keeps 2
    ("hymba-1.5b", "6", "6.5e6", "n_seg 2, k_res 1, k_off 2, resident layers 2")])
def test_launcher_serves_recurrent_through_the_engine(arch, layers, hbm, plan,
                                                      capsys):
    rc = launch.main(["--arch", arch, "--smoke", "--layers", layers,
                      "--device", "cpu", "--hbm-bytes", hbm, "--pattern",
                      "bursty", "--requests", "4", "--max-new", "3",
                      "--prompt-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    family = "ssm" if arch == "rwkv6-3b" else "hybrid"
    assert f"engine: {plan}, family {family}, packed layer" in out
    report = json.loads(out[out.index("{"):])
    assert report["backend"] == "engine" and report["total_tokens"] == 12


@pytest.mark.parametrize("extra,exc,match", [
    (["--spec"], ValueError, "pure-KV"),
    (["--prefix-cache"], SystemExit, "runs through the engine")])
def test_launcher_refuses_for_recurrent_engine(extra, exc, match):
    argv = ["--arch", "hymba-1.5b", "--smoke", "--layers", "4", "--device",
            "cpu", "--hbm-bytes", "4e6", "--pattern", "bursty",
            "--requests", "2", "--max-new", "2", "--prompt-len", "6"]
    with pytest.raises(exc, match=match):
        launch.main(argv + extra)


def test_spec_refused_on_recurrent_engine_backend():
    cfg = port_cfg(_cfg("rwkv6-3b"))
    eng = PE.InterleavedEngine(cfg, PLAN, mb=4, device="cpu")
    with pytest.raises(ValueError, match="pure-KV"):
        LimeServer(cfg, PM.init_params_by_layer(cfg, device="cpu"),
                   engine=eng, spec=SpecConfig(k=2, draft="resident"),
                   pattern="bursty").make_backend()
