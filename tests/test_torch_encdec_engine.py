"""The port's interleaved engine on the encoder-decoder family
(SeamlessM4T-medium's smoke config cut to 4 decoder layers, 2 segments of
1 resident + 1 streamed layer), on the CPU: the streamed tier is plain
host memory there, the copies synchronous, the kernels their plain
versions.

- Against the port's model bit for bit: the engine's encoder and its
  prompt pass over the tiers (each layer's cross K/V from that layer's
  own weights) leave M.seed_cross_kv + M.prefill's cache and logits;
  seed_cache adopts that cache; decode steps equal M.decode_step's across
  a retier +1 and -1; a streamed layer reading another layer's cross K/V
  (a planted fault) does not.
- Against the JAX package, impl "ref" (weights from JAX's init_params
  through convert.py, _torch_encdec.jax_flow): encode within ENC_TOL,
  the prefilled cache within STATE_TOL, logits within LOGIT_TOL at every
  position of six decode steps, greedy equal outside near ties.
- Paged (page 8): greedy tokens equal the unpaged engine's, pages in use
  as reckoned; the cross K/V stay contiguous.
- Verification, the resident self-draft and chunked prefill are refused
  in the JAX engine's words; the engine needs enc_len and, in the prompt
  pass, the encoder's output.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_encdec import (B, ENC_TOL, MAX_LEN, N_STEPS, P,  # noqa: E402
                           S_ENC, cfg_of, close, compare, frames, jax_flow,
                           prompts, tokens, weights)
from _torch_parity import assert_cache_close, port_cfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

N_LAYERS = 4
PLAN = PE.UniformPlan(1, 2, 1, 1)          # decoder layers 1 and 3 streamed


def _engine(impl="ref", **kw):
    cfg = port_cfg(cfg_of(N_LAYERS))
    eng = PE.InterleavedEngine(cfg, PLAN, mb=B, max_len=MAX_LEN, enc_len=S_ENC,
                               impl=impl, device="cpu", **kw)
    return eng, eng.init_state(weights(N_LAYERS)[2])


def _model_prefill(cfg, pp, toks, enc, impl):
    cache = PM.seed_cross_kv(cfg, pp, PM.init_cache(cfg, B, MAX_LEN, device="cpu",
                                                    enc_out=enc), enc)
    return PM.prefill(cfg, pp, toks, cache, impl=impl)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_engine_bitwise_to_the_model(impl):
    """Prompt pass, seed_cache and five decode steps across a retier +1
    (every resident slot demoted) and -1: bit for bit the model's; the
    cross K/V are state and stay. The planted fault breaks it."""
    cfg = port_cfg(cfg_of(N_LAYERS))
    pp = weights(N_LAYERS)[2]
    eng, st = _engine(impl, retier_headroom=1)
    assert eng.resident_layer_ids() == [0, 2]
    fe, toks = torch.from_numpy(frames(cfg)), tokens(prompts(cfg))
    enc = eng.encode(fe)
    assert torch.equal(enc, PM.encode(cfg, pp, fe, impl=impl))
    el, ec = eng.prefill(toks, enc_out=enc)
    ml, mc = _model_prefill(cfg, pp, toks, enc, impl)
    assert torch.equal(el, ml) and ec.keys() == mc.keys() and ec["pos"] == P
    assert all(torch.equal(ec[k], mc[k]) for k in mc if k != "pos")
    st = eng.seed_cache(st, {k: (v.clone() if k != "pos" else v)
                             for k, v in mc.items()})
    V = cfg.vocab_size
    tok = ml[:, -1, :V].argmax(-1, keepdim=True)
    for t in range(5):
        a, st = eng.decode_step(st, tok)
        b, mc = PM.decode_step(cfg, pp, mc, tok, impl=impl, enc_len=S_ENC)
        assert torch.equal(a, b[:, 0]), t
        if t in (1, 3):
            eng.retier(st, 0, 1 if t == 1 else -1)
            assert eng.resident_layer_ids() == ([] if t == 1 else [0, 2])
        tok = a[:, :V].argmax(-1, keepdim=True)
    assert torch.equal(st["xk"], mc["xk"]) and torch.equal(st["xv"], mc["xv"])
    # planted: the first streamed layer reads the next layer's cross K/V
    _, bad = eng.prefill(toks, enc_out=enc)
    bad["xk"][1], bad["xv"][1] = bad["xk"][2].clone(), bad["xv"][2].clone()
    tok = ml[:, -1, :V].argmax(-1, keepdim=True)
    a, _ = eng.decode_step(eng.seed_cache(eng.init_state(pp), bad), tok)
    b, _ = PM.decode_step(cfg, pp, _model_prefill(cfg, pp, toks, enc, impl)[1],
                          tok, impl=impl, enc_len=S_ENC)
    assert not torch.equal(a, b[:, 0])


def test_engine_vs_jax():
    """impl "ref" (the model's kernel route is held to JAX's "pallas" in
    test_torch_encdec.py, and the engine to the model bit for bit
    above)."""
    cfg = cfg_of(N_LAYERS)
    eng, st = _engine("ref")
    flow = jax_flow(N_LAYERS, "ref", S_ENC)
    pe = eng.encode(torch.from_numpy(frames(cfg)))
    close(pe, flow["enc"], ENC_TOL, "engine encode")
    pl, cache = eng.prefill(tokens(prompts(cfg)), enc_out=pe)
    st = eng.seed_cache(st, cache)
    assert_cache_close(st, flow["cache"])
    V = cfg.vocab_size
    n_clear = compare(flow["logits"][0][:, -1], pl[:, -1], V)
    for t in range(N_STEPS):
        pl, st = eng.decode_step(st, tokens(flow["feed"][:, t:t + 1]))
        n_clear += compare(flow["logits"][t + 1][:, -1], pl, V)
    assert st["pos"] == P + N_STEPS
    assert n_clear >= (N_STEPS + 1) * B // 3       # the greedy check has teeth


def test_engine_paged_tokens_and_pages():
    """Paged (page 8): K/V through the block tables, the cross K/V
    contiguous; greedy tokens equal the unpaged engine's, pages in use as
    reckoned after the seed, every decode step and the release."""
    cfg = port_cfg(cfg_of(N_LAYERS))
    fe, toks = torch.from_numpy(frames(cfg)), tokens(prompts(cfg))
    runs, pages = [], []
    for paged in (False, True):
        eng, st = _engine(paged=paged, page_size=8)
        lg, cache = eng.prefill(toks, enc_out=eng.encode(fe))
        st = eng.seed_cache(st, cache)
        if paged:
            pages.append(eng.paged_stats()["pages_in_use"])
        tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        out = [tok]
        for _ in range(8):
            lg, st = eng.decode_requests(st, tok, [True] * B)
            tok = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            out.append(tok)
            if paged:
                pages.append(eng.paged_stats()["pages_in_use"])
        if paged:
            assert st["xk"].shape == (N_LAYERS, B, S_ENC, cfg.n_kv_heads,
                                      cfg.head_dim)
            for s in range(B):
                eng.free_slot(s)
            pages.append(eng.paged_stats()["pages_in_use"])
        runs.append(torch.cat(out, 1))
    assert torch.equal(runs[0], runs[1])
    assert pages == [B * -(-(P + t) // 8) for t in range(9)] + [0]


def test_engine_refusals_are_jax_words():
    """Verification, the resident self-draft and chunked prefill need
    pure-KV per-layer state: refused in the JAX engine's words (its engine
    built on one CPU device with enc_len, nothing run). The port's engine
    also needs enc_len and, in the prompt pass, the encoder's output."""
    cfg = cfg_of(N_LAYERS)
    je = JE.InterleavedEngine(cfg, jax.make_mesh((1,), ("data",)),
                              JE.UniformPlan(1, 2, 1, 1), mb=B, max_len=MAX_LEN,
                              enc_len=S_ENC, fetch_mode="slot")
    pe, _ = _engine()
    toks = np.zeros((B, 3), np.int32)
    for name in ("verify_step", "draft_step", "prefill_partial"):
        with pytest.raises(NotImplementedError) as jerr:
            getattr(je, name)(None, toks)
        with pytest.raises(NotImplementedError) as perr:
            getattr(pe, name)(None, tokens(toks))
        assert str(perr.value) == str(jerr.value), name
    with pytest.raises(ValueError, match="enc_len"):
        PE.InterleavedEngine(port_cfg(cfg), PLAN, device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        pe.prefill(tokens(toks))
