"""The encoder-decoder family (SeamlessM4T-medium) in the port's model,
against the JAX package on the CPU (the kernels run their plain versions
there). The engine's tests: test_torch_encdec_engine.py.

- Config and parameters: the port's config equals JAX's field for field,
  full and smoke; a JAX init_params tree (the "encoder" stack and
  "enc_final_norm" among its leaves) converts leaf for leaf through
  convert.py into the tree build_param_specs declares;
  init_params_by_layer draws the encoder with the shared weights.
- The model (smoke config; weights from JAX's init_params through
  convert.py, frame embeddings and prompts from numpy seeds): encode,
  seed_cross_kv, cross_attn_decode (enc_len below S_enc too),
  prefill(enc_out=) and six decode_step(enc_len=) calls against JAX's,
  impl "ref" against JAX's "ref" and "kernel" against JAX's "pallas"
  (interpret mode), the JAX side jit-compiled (_torch_encdec.jax_flow).
  Tolerances: _torch_encdec's ENC_TOL and CROSS_TOL, _torch_parity's
  LOGIT_TOL and STATE_TOL.
- The cross-attention kernel route: kernel 1 at pos S_enc - 1, never at
  pos >= GLOBAL_WINDOW, where its window arithmetic drops frame 0 (a
  planted call at the reference's pos 2^30 does).
- Refusals and the reference's quirks: decode_step with enc_len 0 raises
  in the port (JAX averages every frame's V alike there); verify_step is
  refused by both packages; JAX's serving route (M.prefill without
  enc_out) raises KeyError 'xk', and the port's backend, server and
  launcher refuse the family before drawing a weight.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_encdec import (ARCH, B, CROSS_TOL, ENC_TOL, IMPLS, MAX_LEN,  # noqa: E402
                           N_STEPS, P, S_ENC, cfg_of, close, compare, frames,
                           jax_flow, prompts, tokens, weights)
from _torch_parity import (LOGIT_TOL, assert_cache_close,  # noqa: E402
                           assert_converts_leaf_for_leaf, f32, port_cfg)
from repro.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.serving import EngineBackend, LimeServer  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


def _port_prefill(pcfg, pp, flow, impl):
    """The port's prefill(enc_out=) of the flow's prompts on the flow's
    encoder output."""
    enc = torch.from_numpy(f32(flow["enc"])).bfloat16()
    return PM.prefill(pcfg, pp, tokens(prompts(pcfg)),
                      PM.init_cache(pcfg, B, MAX_LEN, device="cpu"),
                      enc_out=enc, impl=impl)


# ----------------------------------------------------------------------------
# config and parameters
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_matches_reference(size):
    ref = get_config(ARCH) if size == "full" else get_smoke_config(ARCH)
    got = PR.get_config(ARCH) if size == "full" else PR.get_smoke_config(ARCH)
    assert ARCH in PR.ARCHS
    assert got == port_cfg(ref)
    assert got.family.value == "encdec" and got.n_encoder_layers == \
        ref.n_encoder_layers


def test_param_tree_converts_leaf_for_leaf():
    """Shapes, dtypes and values of every leaf, the encoder stack's
    included: build_param_specs declares JAX's tree and params_from_numpy
    carries it."""
    cfg = cfg_of()
    assert_converts_leaf_for_leaf(cfg)
    specs = PM.build_param_specs(port_cfg(cfg))
    assert specs["encoder"]["attn"]["wq"].shape[0] == cfg.n_encoder_layers
    assert set(specs["layers"]) == {"ln1", "attn", "ln_x", "xattn", "ln2",
                                    "mlp"}


def test_init_params_by_layer_draws_the_encoder_with_shared_weights():
    """The encoder (with its final norm) is drawn with the shared weights
    at its own stack's fan-in scale; the layer source draws decoder
    layers by the decoder's specs, at the decoder stack's scale."""
    cfg = port_cfg(dataclasses.replace(cfg_of(), n_layers=4, n_encoder_layers=9))
    params = PM.init_params_by_layer(cfg, device="cpu")
    specs = PM.build_param_specs(cfg)
    for key in ("encoder", "enc_final_norm", "embedding", "final_norm"):
        assert key in params
    wq = params["encoder"]["attn"]["wq"]
    assert tuple(wq.shape) == specs["encoder"]["attn"]["wq"].shape
    assert abs(wq.float().std().item() - 9 ** -0.5) < 0.02

    def walk(s, p):
        assert set(s) == set(p)
        for k in s:
            if isinstance(s[k], dict):
                walk(s[k], p[k])
            else:
                assert tuple(p[k].shape) == s[k].shape and p[k].dtype == s[k].dtype
    layer = params["layers"](1)
    walk(PM._encdec_decoder_layer_specs(cfg), layer)
    assert abs(layer["xattn"]["wk"].float().std().item() - 4 ** -0.5) < 0.02


# ----------------------------------------------------------------------------
# the model against JAX
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_encode_vs_jax(impl, jimpl):
    """The encoder's output within ENC_TOL of JAX's encode; bf16, (B,
    S_enc, D)."""
    cfg = cfg_of()
    pe = PM.encode(port_cfg(cfg), weights()[2], torch.from_numpy(frames(cfg)),
                   impl=impl)
    assert tuple(pe.shape) == (B, S_ENC, cfg.d_model) and pe.dtype == torch.bfloat16
    close(pe, jax_flow(None, jimpl, S_ENC)["enc"], ENC_TOL, f"encode {impl}")


def test_seed_cross_kv_vs_jax():
    """Every decoder layer's cross K/V of the same encoder output within
    CROSS_TOL of JAX's; init_cache(enc_out=) allocates them as JAX's
    cache_specs, zeros, and seed_cross_kv allocates them where the cache
    holds none."""
    cfg = cfg_of()
    jp, _, pp = weights()
    enc = jax_flow(None, "ref", S_ENC)["enc"]
    jc = JM.seed_cross_kv(cfg, jp, JM.init_cache(cfg, B, MAX_LEN, enc_out=enc),
                          enc)
    pcfg = port_cfg(cfg)
    pe = torch.from_numpy(f32(enc)).bfloat16()
    pc = PM.init_cache(pcfg, B, MAX_LEN, device="cpu", enc_out=pe)
    assert set(pc) == set(JM.init_cache(cfg, B, MAX_LEN, enc_out=enc))
    assert not pc["xk"].any() and pc["xk"].dtype == torch.bfloat16
    pc = PM.seed_cross_kv(pcfg, pp, pc, pe)
    for key in ("xk", "xv"):
        assert tuple(pc[key].shape) == jc[key].shape
        close(pc[key], jc[key], CROSS_TOL, key)
    bare = PM.seed_cross_kv(pcfg, pp, PM.init_cache(pcfg, B, MAX_LEN, device="cpu"),
                            pe)
    assert torch.equal(bare["xk"], pc["xk"]) and torch.equal(bare["xv"], pc["xv"])


@pytest.mark.parametrize("enc_len", [S_ENC, 7])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_cross_attn_decode_vs_jax(impl, enc_len):
    """One decode-time cross-attention within CROSS_TOL of JAX's (which
    ignores impl: its jnp decode_attention_ref at pos 2^30) on the same
    inputs, with every frame visible and with the frames past enc_len
    masked (which moves the output)."""
    cfg = cfg_of()
    jp, _, pp = weights()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kv = (B, S_ENC, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (rng.standard_normal(kv).astype(np.float32) for _ in range(2))
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x, ck, cv)]
    jxa = jax.tree.map(lambda a: a[0], jp["layers"]["xattn"])
    ref = JA.cross_attn_decode(jxa, *bf, enc_len)
    pxa = {k: v[0] for k, v in pp["layers"]["xattn"].items()}
    got = PA.cross_attn_decode(pxa, *(torch.from_numpy(f32(a)).bfloat16()
                                      for a in bf), enc_len, impl=impl)
    close(got, ref, CROSS_TOL, f"cross_attn_decode {impl} enc_len {enc_len}")
    if enc_len < S_ENC:
        full = JA.cross_attn_decode(jxa, *bf, S_ENC)
        assert np.abs(f32(full) - f32(ref)).max() > 10 * CROSS_TOL * np.abs(
            f32(ref)).max()


def test_cross_attn_kernel_route_stays_below_the_global_window(monkeypatch):
    """The kernel route calls kernel 1 at pos S_enc - 1 with the frames
    below enc_len as pos_ids, never at pos >= GLOBAL_WINDOW: the kernel
    keeps a slot only if pos - pos_id < window (GLOBAL_WINDOW for None),
    so at the reference's pos 2^30 it would drop frame 0. A key at frame 0
    aligned with the query makes that frame carry about a third of the
    weight: the planted call (the plain version with the kernel's window
    arithmetic at pos 2^30) then differs from the right output, which
    the kernel route's call equals within CROSS_TOL."""
    cfg = port_cfg(cfg_of())
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    calls = []
    real = da_ops.decode_attention

    def record(q, k, v, pos_ids, pos, *, window=None):
        calls.append((int(pos), window, pos_ids.clone()))
        return real(q, k, v, pos_ids, pos, window=window)
    monkeypatch.setattr(da_ops, "decode_attention", record)
    g = torch.Generator().manual_seed(0)
    xa = {"wq": torch.eye(cfg.d_model)[:, :H * dh].reshape(cfg.d_model, H, dh)
          .bfloat16(),
          "wo": torch.eye(H * dh, cfg.d_model).reshape(H, dh, cfg.d_model)
          .bfloat16()}
    x = torch.randn((1, 1, cfg.d_model), generator=g).bfloat16()
    ck = torch.randn((1, S_ENC, KV, dh), generator=g).bfloat16()
    cv = torch.randn((1, S_ENC, KV, dh), generator=g).bfloat16()
    q = PA._proj(x, xa["wq"])                              # (1, 1, H, dh)
    ck[:, 0] = (q[0, 0].reshape(KV, H // KV, dh).float().mean(1) * 0.5).bfloat16()
    out = PA.cross_attn_decode(xa, x, ck, cv, S_ENC, impl="kernel")
    assert [(p, w) for p, w, _ in calls] == [(S_ENC - 1, None)]
    assert calls[0][0] < da_ops.GLOBAL_WINDOW
    np.testing.assert_array_equal(calls[0][2].numpy(), np.arange(S_ENC))
    ref = PA.cross_attn_decode(xa, x, ck, cv, S_ENC, impl="ref")
    close(out, ref, CROSS_TOL, "kernel route")
    ids = PA.cross_pos_ids(S_ENC, S_ENC, ck.device)
    planted = da_ops.decode_attention_plain(q, ck, cv, ids, PA.CROSS_POS,
                                            window=da_ops.GLOBAL_WINDOW)
    right = da_ops.decode_attention_plain(q, ck, cv, ids, S_ENC - 1)
    d = (planted.float() - right.float()).abs().max().item()
    assert d > 0.1 * right.float().abs().max().item()


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_prefill_vs_jax(impl, jimpl):
    """prefill(enc_out=): last-token logits within LOGIT_TOL (greedy equal
    outside near ties), the cache (k, v, xk, xv within STATE_TOL; pos_ids
    equal; pos) against JAX's seed_cross_kv + prefill on the same encoder
    output. frontend_embeds feed the encoder: prefill(frontend_embeds=)
    equals encode then prefill(enc_out=) bit for bit."""
    cfg = cfg_of()
    pcfg = port_cfg(cfg)
    pp = weights()[2]
    flow = jax_flow(None, jimpl, S_ENC)
    pl, pc = _port_prefill(pcfg, pp, flow, impl)
    assert pc["pos"] == int(flow["cache"]["pos"]) == P
    assert_cache_close(pc, flow["cache"])
    compare(flow["logits"][0][:, -1], pl[:, -1], cfg.vocab_size)
    fe, toks = torch.from_numpy(frames(cfg)), tokens(prompts(cfg))

    def empty():
        return PM.init_cache(pcfg, B, MAX_LEN, device="cpu")
    a, ca = PM.prefill(pcfg, pp, toks, empty(), frontend_embeds=fe, impl=impl)
    b, cb = PM.prefill(pcfg, pp, toks, empty(), impl=impl,
                       enc_out=PM.encode(pcfg, pp, fe, impl=impl))
    assert torch.equal(a, b) and ca["pos"] == cb["pos"] == P
    assert all(torch.equal(ca[k], cb[k]) for k in ("k", "v", "xk", "xv"))
    with pytest.raises(ValueError, match="not both"):
        PM.prefill(pcfg, pp, toks, empty(), frontend_embeds=fe, enc_out=b)


@pytest.mark.parametrize("impl,jimpl,enc_len",
                         [("ref", "ref", S_ENC), ("kernel", "pallas", S_ENC),
                          ("kernel", "pallas", 9)])
def test_decode_vs_jax(impl, jimpl, enc_len):
    """encode -> seed_cross_kv -> prefill -> six decode_step(enc_len=),
    each fed the reference's pick (the flow of the reference's dryrun and
    arch smoke test): logits within LOGIT_TOL at every position, greedy
    equal outside near ties."""
    cfg = cfg_of()
    pcfg = port_cfg(cfg)
    pp = weights()[2]
    flow = jax_flow(None, jimpl, enc_len)
    pe = PM.encode(pcfg, pp, torch.from_numpy(frames(cfg)), impl=impl)
    pc = PM.seed_cross_kv(pcfg, pp, PM.init_cache(pcfg, B, MAX_LEN, device="cpu",
                                                  enc_out=pe), pe)
    pl, pc = PM.prefill(pcfg, pp, tokens(prompts(cfg)), pc, impl=impl)
    V = cfg.vocab_size
    n_clear = compare(flow["logits"][0][:, -1], pl[:, -1], V)
    for t in range(N_STEPS):
        pl, pc = PM.decode_step(pcfg, pp, pc, tokens(flow["feed"][:, t:t + 1]),
                                impl=impl, enc_len=enc_len)
        n_clear += compare(flow["logits"][t + 1][:, -1], pl[:, -1], V)
    assert pc["pos"] == P + N_STEPS
    assert n_clear >= (N_STEPS + 1) * B // 3       # the greedy check has teeth


# ----------------------------------------------------------------------------
# refusals and the reference's quirks
# ----------------------------------------------------------------------------
def test_decode_enc_len_zero_refused_and_the_reference_quirk():
    """At enc_len 0 the reference masks every frame, and its softmax over
    all-masked scores averages every frame's V alike (its logits move far
    from enc_len = S_enc); the port's kernels output 0 for a row that sees
    no slot, so the port refuses the call."""
    cfg = cfg_of()
    pcfg = port_cfg(cfg)
    jp, _, pp = weights()
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((B, 1, cfg.d_model)), jnp.bfloat16)
    kv = (B, S_ENC, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (jnp.asarray(rng.standard_normal(kv), jnp.bfloat16) for _ in range(2))
    jxa = jax.tree.map(lambda a: a[0], jp["layers"]["xattn"])
    got = JA.cross_attn_decode(jxa, x, ck, cv, 0)
    G = cfg.n_heads // cfg.n_kv_heads
    p = jnp.asarray(1.0 / S_ENC, jnp.bfloat16).astype(jnp.float32)
    avg = jnp.repeat(p * cv.astype(jnp.float32).sum(1), G, axis=1)   # (B, H, dh)
    want = jnp.einsum("bhk,hkd->bd", avg.astype(jnp.bfloat16), jxa["wo"])
    close(got[:, 0], want, CROSS_TOL, "the reference's uniform average")
    flow = jax_flow(None, "ref", S_ENC)
    tok = jnp.ones((B, 1), jnp.int32)
    step = jax.jit(functools.partial(JM.decode_step, cfg),
                   static_argnames="enc_len")
    a, _ = step(jp, flow["cache"], tok, enc_len=0)
    b, _ = step(jp, flow["cache"], tok, enc_len=S_ENC)
    assert np.abs(f32(a) - f32(b)).max() > 10 * LOGIT_TOL
    _, pc = _port_prefill(pcfg, pp, flow, "ref")
    for impl in ("ref", "kernel"):
        with pytest.raises(ValueError, match="enc_len > 0"):
            PM.decode_step(pcfg, pp, pc, torch.ones((B, 1), dtype=torch.long),
                           impl=impl)
    assert pc["pos"] == P                       # refused before any write


def test_verify_refused_by_both_packages():
    cfg = cfg_of()
    pcfg = port_cfg(cfg)
    jp, _, pp = weights()
    enc = jnp.zeros((B, S_ENC, cfg.d_model), jnp.bfloat16)
    with pytest.raises(NotImplementedError, match="pure-KV"):
        JM.verify_step(cfg, jp, JM.init_cache(cfg, B, MAX_LEN, enc_out=enc),
                       jnp.zeros((B, 3), jnp.int32))
    with pytest.raises(NotImplementedError, match="pure-KV"):
        PM.verify_step(pcfg, pp, PM.init_cache(pcfg, B, MAX_LEN, device="cpu",
                                               enc_len=S_ENC),
                       torch.zeros((B, 3), dtype=torch.long))


def test_serving_route_refused(monkeypatch):
    """JAX's serving route prefills an encoder-decoder config through
    jax.jit(partial(M.prefill, cfg)) on an init_cache without enc_out:
    KeyError 'xk'. The port's prefill says so without one; its backend,
    server and launcher refuse the family before a weight is drawn."""
    cfg = cfg_of()
    pcfg = port_cfg(cfg)
    jp, _, pp = weights()
    toks = prompts(cfg)
    with pytest.raises(KeyError, match="xk"):
        jax.jit(functools.partial(JM.prefill, cfg))(
            jp, jnp.asarray(toks), JM.init_cache(cfg, B, MAX_LEN))
    with pytest.raises(ValueError, match="KeyError 'xk'"):
        PM.prefill(pcfg, pp, tokens(toks),
                   PM.init_cache(pcfg, B, MAX_LEN, device="cpu"))
    with pytest.raises(NotImplementedError, match="KeyError: 'xk'"):
        EngineBackend(pcfg, None, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        LimeServer(pcfg, pp, device="cpu").make_backend()

    def drawn(*a, **k):
        raise AssertionError("a weight was drawn")
    monkeypatch.setattr(PM, "init_params", drawn)
    monkeypatch.setattr(PM, "init_params_by_layer", drawn)
    for extra in ([], ["--hbm-bytes", "1e6"]):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--requests", "1"] + extra)
