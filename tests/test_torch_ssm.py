"""The port's SSM family (RWKV6) against the JAX package, on the same
weights and inputs.

* The WKV scan's plain version (kernel 6's, the model's reference scan)
  against ``repro.models.ssm.wkv_scan_ref`` over tests/test_kernels.py's
  WKV_CASES and the decode shape, from a zero and a random state, within
  SCAN_REL of each output vector's largest |ref| (fp32 summation order
  only); state chaining bit for bit. Never against the Pallas kernel,
  which fails on this tree (ROADMAP, reference faults).
* The time-mix and channel-mix blocks against JAX, one bf16 ulp of the
  largest |out| (the recurrence in fp32, everything else rounded where XLA
  rounds).
* The smoke config end to end: prefill logits against JAX ``M.prefill``,
  10 decode steps against JAX ``M.decode_step`` (greedy equal outside near
  ties, logits within LOGIT_TOL), the prefill's cache against the cache of
  JAX's token-by-token run within STATE_TOL, and a LimeServer serve whose
  tokens equal JAX's token-by-token greedy decode.
"""
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_cases import SCAN_REL, WKV_CASES, rel_err, wkv_inputs  # noqa: E402
from _torch_parity import (LOGIT_TOL, assert_cache_close,  # noqa: E402
                           assert_converts_leaf_for_leaf,
                           assert_greedy_vs_stepwise, f32, jax_params,
                           jax_stepwise, margin, port_cfg)
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.serving import LimeServer  # noqa: E402
from repro_torch.specdec import SpecConfig  # noqa: E402

ARCH = "rwkv6-3b"
BF16_ULP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("state", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("case", WKV_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}d{c[3]}")
def test_wkv_plain_vs_jax(case, state):
    args = wkv_inputs(case, state=state)
    ref_o, ref_s = JS.wkv_scan_ref(*map(jnp.asarray, args))
    out, new = wkv_ops.wkv_plain(*map(_t, args))
    assert rel_err(out, _t(ref_o)) <= SCAN_REL
    assert rel_err(new, _t(ref_s)) <= SCAN_REL
    # the wrapper on CPU tensors: the plain version, state updated in place
    s = _t(args[5])
    n0 = wkv_ops.launches
    got = wkv_ops.wkv(*map(_t, args[:5]), s)
    assert torch.equal(got, out) and torch.equal(s, new)
    assert wkv_ops.launches == n0          # no kernel launched on the CPU


def test_wkv_state_chaining():
    """Two calls over the halves of a sequence, the state carried in place,
    equal one call over the whole, bit for bit, and the JAX scan."""
    r, k, v, w, u, s0 = map(_t, wkv_inputs((2, 32, 3, 64), seed=4))
    s_full = s0.clone()
    full = wkv_ops.wkv(r, k, v, w, u, s_full)
    s = s0.clone()
    h1 = wkv_ops.wkv(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u, s)
    h2 = wkv_ops.wkv(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u, s)
    assert torch.equal(torch.cat([h1, h2], 1), full) and torch.equal(s, s_full)
    ref_o, ref_s = JS.wkv_scan_ref(*(jnp.asarray(t.numpy())
                                     for t in (r, k, v, w, u, s0)))
    assert rel_err(full, _t(ref_o)) <= SCAN_REL
    assert rel_err(s, _t(ref_s)) <= SCAN_REL


def _layer(tree, l=0):
    return jax.tree.map(lambda a: a[l], tree)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_rwkv_blocks_vs_jax(impl):
    cfg = get_smoke_config(ARCH)
    jp, _, pp = jax_params(cfg)
    H, dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    last = rng.standard_normal((2, D)).astype(np.float32)
    st = rng.standard_normal((2, H, dh, dh)).astype(np.float32) * 4
    jx, jlast = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, last))
    px, plast = _t(x).bfloat16(), _t(last).bfloat16()

    jtm = _layer(jp["layers"]["tm"])
    ptm = {k: v[0] for k, v in pp["layers"]["tm"].items()}
    jo, jl, js = jax.jit(functools.partial(
        JS.rwkv_timemix, n_heads=H, head_dim=dh, norm_eps=cfg.norm_eps))(
        jtm, jx, jlast, jnp.asarray(st))
    ps = _t(st)
    po, pl, ps2 = PS.rwkv_timemix(ptm, px, plast.clone(), ps, n_heads=H,
                                  head_dim=dh, norm_eps=cfg.norm_eps,
                                  impl=impl)
    ref = f32(jo)
    np.testing.assert_allclose(f32(po), ref, atol=BF16_ULP * np.abs(ref).max())
    np.testing.assert_array_equal(f32(pl), f32(jl))
    assert ps2 is ps and rel_err(ps, _t(f32(js))) <= SCAN_REL

    jcm = _layer(jp["layers"]["cm"])
    pcm = {k: v[0] for k, v in pp["layers"]["cm"].items()}
    jo, jl = jax.jit(JS.rwkv_channelmix)(jcm, jx, jlast)
    pcl = plast.clone()
    po, pl = PS.rwkv_channelmix(pcm, px, pcl)
    ref = f32(jo)
    np.testing.assert_allclose(f32(po), ref, atol=BF16_ULP * np.abs(ref).max())
    assert pl is pcl
    np.testing.assert_array_equal(f32(pl), f32(jl))


def test_params_convert_leaf_for_leaf():
    """A JAX init_params tree of the SSM family converts leaf for leaf
    into the tree the port declares."""
    assert_converts_leaf_for_leaf(get_smoke_config(ARCH))


def test_init_params_small_leaves():
    """The port's own init draws the reference's "small" leaves as
    0.01 * N(0, 1) and the norm scales as zeros."""
    cfg = port_cfg(get_smoke_config(ARCH))
    p = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tm = p["layers"]["tm"]
    for key in ("mu_r", "w0", "wA", "u"):
        assert abs(tm[key].float().std().item() - 0.01) < 0.002, key
    assert torch.count_nonzero(tm["ln_out"]) == 0
    assert abs(tm["wr"].float().std().item() - cfg.n_layers ** -0.5) < 0.02


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_prefill_and_decode_vs_jax(impl):
    """Prefill logits against JAX M.prefill (exact against JAX's own
    token-by-token run for this family), then 10 decode steps fed the
    reference's greedy picks: logits within LOGIT_TOL, greedy equal
    wherever the reference's top-2 margin exceeds it, states within
    STATE_TOL."""
    cfg = get_smoke_config(ARCH)
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg)
    B, S, max_len = 2, 12, 32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks, jnp.int32), JM.init_cache(cfg, B, max_len))
    pl, pc = PM.prefill(pcfg, pp, _t(toks),
                        PM.init_cache(pcfg, B, max_len, device="cpu"),
                        impl=impl)
    jdecode = jax.jit(functools.partial(JM.decode_step, cfg))
    for step in range(11):
        a = f32(jl)[:, -1, :cfg.vocab_size]
        b = f32(pl)[:, -1, :cfg.vocab_size]
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL)
        clear = margin(a) > LOGIT_TOL
        np.testing.assert_array_equal(b.argmax(-1)[clear], a.argmax(-1)[clear])
        assert pc["pos"] == int(jc["pos"]) == S + step
        assert_cache_close(pc, jc)
        if step == 10:
            break
        tok = a.argmax(-1)[:, None]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok, jnp.int32))
        pl, pc = PM.decode_step(pcfg, pp, pc, _t(tok), impl=impl)


def test_prefill_cache_vs_token_by_token():
    """The port's one-pass prefill leaves the cache that JAX's token-by-token
    decode leaves (the reference's decode contract), within STATE_TOL."""
    cfg = get_smoke_config(ARCH)
    jp, _, pp = jax_params(cfg, seed=1)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 20))
    la, jc = jax_stepwise(cfg, jp, toks, toks[:, :0], 32)
    pl, pc = PM.prefill(port_cfg(cfg), pp, _t(toks),
                        PM.init_cache(port_cfg(cfg), 2, 32, device="cpu"),
                        impl="kernel")
    np.testing.assert_allclose(f32(pl)[:, -1, :cfg.vocab_size], la[0],
                               atol=LOGIT_TOL)
    assert pc["pos"] == int(jc["pos"]) == 20
    assert_cache_close(pc, jc)


@pytest.mark.parametrize("pattern,lens", [
    ("sporadic", [9, 9]),
    ("bursty", [9, 5, 9, 3]),        # uneven: left pads run the recurrence
])
def test_lime_server_vs_token_by_token(pattern, lens):
    """LimeServer -> scheduler -> single-device backend on the CPU emits
    the tokens of JAX's token-by-token greedy decode of the same batch
    (left-padded with token 0, whose pads run through the recurrence
    exactly as in the reference), outside near ties."""
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


def test_launcher_serves_rwkv(capsys):
    rc = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--pattern", "bursty", "--requests", "4",
                            "--max-new", "3", "--prompt-len", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["n_requests"] == 4 and report["total_tokens"] == 12


def test_recurrent_state_refuses_what_needs_rollback_or_pages():
    """Speculation, paged KV and the prefix cache need pure-KV per-layer
    state: the SSM family is refused with a clear message (the reference
    refuses speculation and verify_step for it too). The interleaved engine
    streams the family (and its layer source draws it) but refuses
    verification and chunked prefill, as the reference's engine does."""
    from repro_torch.core.engine import InterleavedEngine, UniformPlan
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    cfg = port_cfg(get_smoke_config(ARCH))
    params = PM.init_params(cfg, device="cpu")
    cache = PM.init_cache(cfg, 1, 16, device="cpu")
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
    eng = InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), device="cpu")
    with pytest.raises(NotImplementedError, match="pure-KV"):
        eng.verify_step(None, torch.zeros((1, 3), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="pure-KV"):
        eng.prefill_partial(None, torch.zeros((1, 3), dtype=torch.long))
    assert callable(PM.init_params_by_layer(cfg, device="cpu")["layers"])
    assert cache.keys() == {"pos", "rwkv_state", "last_tm", "last_cm"}
