"""The port's hybrid family (Hymba: sliding-window attention beside Mamba
heads in each block) against the JAX package, on the same weights and
inputs.

* The selective scan's plain version (kernel 7's, the model's reference
  scan) against ``repro.models.ssm.ssm_scan_ref`` over
  tests/test_kernels.py's SSM_CASES and the decode shape, from a zero and a
  random state, within SCAN_REL of each output vector's largest |ref|;
  state chaining bit for bit. Never against the Pallas kernel, which fails
  on this tree (ROADMAP, reference faults).
* ``_causal_conv`` and ``mamba_forward`` against JAX.
* The smoke config end to end. The reference's hybrid prefill returns the
  right logits but leaves the cache empty (ROADMAP, reference faults), so
  the port is held to JAX's token-by-token ``M.decode_step``: prefill
  logits against JAX ``M.prefill`` and the token-by-token run, the cache
  against the token-by-token run's within STATE_TOL (with a prompt longer
  than the smoke window of 128, so the ring roll is tested), 10 decode
  steps (greedy equal outside near ties, logits within LOGIT_TOL), and a
  LimeServer serve whose tokens equal the token-by-token greedy decode.
"""
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_cases import SCAN_REL, SSM_CASES, rel_err, ssm_inputs  # noqa: E402
from _torch_parity import (LOGIT_TOL, assert_cache_close,  # noqa: E402
                           assert_converts_leaf_for_leaf,
                           assert_greedy_vs_stepwise, f32, jax_params,
                           jax_stepwise, margin, port_cfg)
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.serving import LimeServer  # noqa: E402
from repro_torch.specdec import SpecConfig  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

ARCH = "hymba-1.5b"
BF16_ULP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("case", SSM_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}N{c[4]}")
def test_ssm_scan_plain_vs_jax(case, state):
    args = ssm_inputs(case, state=state)
    ref_y, ref_s = JS.ssm_scan_ref(*map(jnp.asarray, args))
    y, new = ssm_ops.ssm_scan_plain(*map(_t, args))
    assert rel_err(y, _t(ref_y)) <= SCAN_REL
    assert rel_err(new, _t(ref_s)) <= SCAN_REL
    # the wrapper on CPU tensors: the plain version, state updated in place
    s = _t(args[5])
    n0 = ssm_ops.launches
    got = ssm_ops.ssm_scan(*map(_t, args[:5]), s)
    assert torch.equal(got, y) and torch.equal(s, new)
    assert ssm_ops.launches == n0          # no kernel launched on the CPU


def test_ssm_scan_state_chaining():
    """Two calls over the halves of a sequence, the state carried in place,
    equal one call over the whole, bit for bit, and the JAX scan."""
    x, dt, bm, cm, A, s0 = map(_t, ssm_inputs((1, 32, 2, 64, 8), seed=6))
    s_full = s0.clone()
    full = ssm_ops.ssm_scan(x, dt, bm, cm, A, s_full)
    s = s0.clone()
    h1 = ssm_ops.ssm_scan(x[:, :16], dt[:, :16], bm[:, :16], cm[:, :16], A, s)
    h2 = ssm_ops.ssm_scan(x[:, 16:], dt[:, 16:], bm[:, 16:], cm[:, 16:], A, s)
    assert torch.equal(torch.cat([h1, h2], 1), full) and torch.equal(s, s_full)
    ref_y, ref_s = JS.ssm_scan_ref(*(jnp.asarray(t.numpy())
                                     for t in (x, dt, bm, cm, A, s0)))
    assert rel_err(full, _t(ref_y)) <= SCAN_REL
    assert rel_err(s, _t(ref_s)) <= SCAN_REL


def _mamba(jp, pp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]),
            {k: v[0] for k, v in pp["layers"]["mamba"].items()})


def test_causal_conv_vs_jax():
    """bf16 products and sums in the reference's order: bit for bit."""
    cfg = get_smoke_config(ARCH)
    jp, _, pp = jax_params(cfg)
    jm, pm = _mamba(jp, pp)
    C = cfg.ssm_heads * cfg.head_dim
    rng = np.random.default_rng(2)
    for S in (1, 9):
        x = rng.standard_normal((2, S, C)).astype(np.float32) * 4
        st = rng.standard_normal((2, 3, C)).astype(np.float32) * 4
        jo, js = JS._causal_conv(jnp.asarray(x).astype(jnp.bfloat16),
                                 jm["conv"],
                                 jnp.asarray(st).astype(jnp.bfloat16))
        po, ps = PS._causal_conv(_t(x).bfloat16(), pm["conv"],
                                 _t(st).bfloat16())
        np.testing.assert_array_equal(f32(po), f32(jo))
        np.testing.assert_array_equal(f32(ps), f32(js))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("S", [1, 12])
def test_mamba_forward_vs_jax(S, impl):
    """Output within one bf16 ulp of its largest |value|; the conv rows
    exact; the scan state within SCAN_REL (only the recurrence is fp32)."""
    cfg = get_smoke_config(ARCH)
    jp, _, pp = jax_params(cfg)
    jm, pm = _mamba(jp, pp)
    H, dh, N, D = cfg.ssm_heads, cfg.head_dim, cfg.ssm_state_size, cfg.d_model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    conv = rng.standard_normal((2, 3, H * dh)).astype(np.float32)
    st = rng.standard_normal((2, H, N, dh)).astype(np.float32)
    kw = dict(n_heads=H, head_dim=dh, ssm_size=N, norm_eps=cfg.norm_eps)
    jo, jc, js = jax.jit(functools.partial(JS.mamba_forward, **kw))(
        jm, jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(conv).astype(jnp.bfloat16), jnp.asarray(st))
    pc, ps = _t(conv).bfloat16(), _t(st)
    po, pc2, ps2 = PS.mamba_forward(pm, _t(x).bfloat16(), pc, ps, impl=impl,
                                    **kw)
    ref = f32(jo)
    np.testing.assert_allclose(f32(po), ref, atol=BF16_ULP * np.abs(ref).max())
    assert pc2 is pc and ps2 is ps
    np.testing.assert_array_equal(f32(pc), f32(jc))
    assert rel_err(ps, _t(f32(js))) <= SCAN_REL


def test_params_convert_leaf_for_leaf():
    """A JAX init_params tree of the hybrid family converts leaf for leaf
    into the tree the port declares."""
    assert_converts_leaf_for_leaf(get_smoke_config(ARCH))


def test_jax_hybrid_prefill_leaves_the_cache_empty():
    """The reference fault the port routes around (ROADMAP): JAX's hybrid
    prefill claims S filled slots but leaves K/V and the recurrent states
    zero, where its token-by-token run fills them. The port's prefill
    fills them."""
    cfg = get_smoke_config(ARCH)
    jp, _, pp = jax_params(cfg)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 12))
    _, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks, jnp.int32), JM.init_cache(cfg, 2, 32))
    _, sc = jax_stepwise(cfg, jp, toks, toks[:, :0], 32)
    _, pc = PM.prefill(port_cfg(cfg), pp, _t(toks),
                       PM.init_cache(port_cfg(cfg), 2, 32, device="cpu"))
    assert int(jc["pos"]) == 12
    for key in ("k", "v", "conv_state", "ssm_state"):
        assert not np.any(f32(jc[key])), key
        assert np.any(f32(sc[key])) and torch.count_nonzero(pc[key]), key


# B, prompt length, max_len: the smoke window is 128, so a 140-token
# prompt outruns the 128-slot cache and is ring-rolled into it
PREFILL_CASES = [(2, 12, 32), (2, 140, 256)]


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("B,S,max_len", PREFILL_CASES,
                         ids=[f"S{c[1]}" for c in PREFILL_CASES])
def test_prefill_cache_vs_token_by_token(B, S, max_len, impl):
    """The port's one-pass prefill (flash attention with the window, one
    scan over the prompt) leaves the cache of JAX's token-by-token decode,
    within STATE_TOL, and its logits match both JAX's prefill and its
    token-by-token run."""
    cfg = get_smoke_config(ARCH)
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg, seed=1)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S))
    ls, jc = jax_stepwise(cfg, jp, toks, toks[:, :0], max_len)
    jl, _ = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks, jnp.int32), JM.init_cache(cfg, B, max_len))
    pl, pc = PM.prefill(pcfg, pp, _t(toks),
                        PM.init_cache(pcfg, B, max_len, device="cpu"),
                        impl=impl)
    got = f32(pl)[:, -1, :cfg.vocab_size]
    np.testing.assert_allclose(got, f32(jl)[:, -1, :cfg.vocab_size],
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(got, ls[0], atol=LOGIT_TOL)
    assert pc["pos"] == int(jc["pos"]) == S
    assert (S > pc["k"].shape[2]) == (S == 140)
    assert_cache_close(pc, jc)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_decode_vs_token_by_token(impl):
    """Prefill, then 10 decode steps fed the reference's greedy picks,
    against JAX's token-by-token run of the same tokens: logits within
    LOGIT_TOL, greedy equal wherever the reference's top-2 margin exceeds
    it, the cache within STATE_TOL after the last step."""
    cfg = get_smoke_config(ARCH)
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg)
    B, S, max_len = 2, 12, 32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    jd = jax.jit(functools.partial(JM.decode_step, cfg))
    _, jc = jax_stepwise(cfg, jp, toks[:, :-1], toks[:, :0], max_len)
    pl, pc = PM.prefill(pcfg, pp, _t(toks),
                        PM.init_cache(pcfg, B, max_len, device="cpu"),
                        impl=impl)
    tok = toks[:, -1:]
    for step in range(11):
        jl, jc = jd(jp, jc, jnp.asarray(tok, jnp.int32))
        a = f32(jl)[:, -1, :cfg.vocab_size]
        b = f32(pl)[:, -1, :cfg.vocab_size]
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
        clear = margin(a) > LOGIT_TOL
        np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
        assert pc["pos"] == int(jc["pos"]) == S + step
        if step == 10:
            break
        tok = a.argmax(-1)[:, None]
        pl, pc = PM.decode_step(pcfg, pp, pc, _t(tok), impl=impl)
    assert_cache_close(pc, jc)


@pytest.mark.parametrize("pattern,lens", [
    ("sporadic", [9, 9]),
    ("bursty", [9, 5, 9, 3]),        # uneven: left pads with token 0
])
def test_lime_server_vs_token_by_token(pattern, lens):
    """LimeServer -> scheduler -> single-device backend on the CPU emits
    the tokens of JAX's token-by-token greedy decode of the same batch
    (left-padded with token 0), outside near ties."""
    cfg = get_smoke_config(ARCH)
    jp, _, pp = jax_params(cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    srv = LimeServer(port_cfg(cfg), pp, max_len=32, pattern=pattern,
                     device="cpu")
    for p in prompts:
        srv.queue.submit(p, 6)
    got = sorted(srv.serve_all(), key=lambda r: r.rid)
    assert all(not r.rejected and len(r.output) == 6 for r in got)
    batches = [prompts] if pattern == "bursty" else [[p] for p in prompts]
    outs = [r.output for r in got]
    i = 0
    for batch in batches:
        width = max(len(p) for p in batch)
        toks = np.stack([np.pad(p, (width - len(p), 0)) for p in batch])
        assert_greedy_vs_stepwise(cfg, jp, pp, toks, outs[i:i + len(batch)],
                                  32)
        i += len(batch)


def test_launcher_serves_hymba(capsys):
    rc = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--pattern", "bursty", "--requests", "4",
                            "--max-new", "3", "--prompt-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["n_requests"] == 4 and report["total_tokens"] == 12


def test_hybrid_refuses_what_needs_rollback_or_pages():
    """Hymba keeps K/V beside a recurrent state: speculation (rollback by
    masking), paged KV, the prefix cache and the engine are refused."""
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    cfg = port_cfg(get_smoke_config(ARCH))
    params = PM.init_params(cfg, device="cpu")
    cache = PM.init_cache(cfg, 1, 16, device="cpu")
    assert cache.keys() == {"pos", "k", "v", "pos_ids", "conv_state",
                            "ssm_state"}
    with pytest.raises(NotImplementedError, match="dense family"):
        PM.verify_step(cfg, params, cache, torch.zeros((1, 3), dtype=torch.long))
    with pytest.raises(ValueError, match="dense family"):
        LimeServer(cfg, params, spec=SpecConfig(), device="cpu").make_backend()
    srv = LimeServer(cfg, params, prefix_cache=True, device="cpu")
    srv.queue.submit(np.arange(1, 9), 2)
    with pytest.raises(NotImplementedError, match="dense family"):
        srv.serve_all()             # refused by the pages, before any prefill
    with pytest.raises(NotImplementedError, match="dense family"):
        PagedDecodeCache(cfg, 1, 16, page_size=8, device="cpu")
