"""The port's CUDA kernels and main path on the card.

Marked `gpu`: each test decides inside a fixture whether a CUDA device is
visible and skips without one (the kernels are CUDA C++ with no CPU
mode). Imports no JAX, so it runs on the card's machine, where
tests/conftest.py (which imports JAX) is skipped:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_cases import (BF16_REL, DECODE_CASES, F32_REL, FLASH_CASES,
                          MQ_CASES, MQ_PAGED_CASES, PAGED_CASES, decode_inputs,
                          flash_inputs, gathered_ids, mq_inputs,
                          mq_paged_case_inputs, paged_case_inputs,
                          paged_inputs, rel_err, to_torch)
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import InterleavedEngine, UniformPlan
from repro_torch.kernels.decode_attention import multiquery as mq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import model as M
from repro_torch.serving import LimeServer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}kv{c[4]}d{c[5]}")
def test_flash_kernel_vs_plain(case, cuda_device):
    B, Sq, Skv, H, KV, dh, causal, window, dt = case
    q, k, v = (to_torch(a, dt, cuda_device) for a in flash_inputs(case))
    n0 = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert rel_err(out, ref) <= (BF16_REL if dt == "bf16" else F32_REL)


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_decode_kernel_vs_plain(case, cuda_device):
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = da.launches
    out = da.decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert da.launches == n0 + 1
    ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_CASES,
                         ids=lambda c: f"q{c[1]}S{c[2]}H{c[3]}kv{c[4]}d{c[5]}p{c[6]}-{c[8]}")
def test_mq_kernel_vs_plain(case, cuda_device):
    B, Q, S_c, H, KV, dh, pos, window, kind = case
    q, k, v, ids = mq_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    n0 = mq.launches
    out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    torch.cuda.synchronize()
    assert mq.launches == n0 + 1
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
    assert rel_err(out, ref) <= BF16_REL
    if kind == "masked":
        assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("q_len,pos", [(5, 1019), (512, 0)],
                         ids=["verify", "prefill"])
def test_mq_kernel_main_shapes(q_len, pos, cuda_device):
    """The main path's shapes: verify (k = 4) at the end of a full cache,
    and a 512-position prefill round into an empty one."""
    case = (4, q_len, 1024, 64, 8, 128, pos, None, "linear")
    q, k, v, ids = mq_inputs(case, seed=1)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    out = mq.mq_decode_attention(q, k, v, ids, pos)
    ref = mq.mq_decode_attention_plain(q, k, v, ids, pos)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"S{c[1]}H{c[2]}kv{c[3]}p{c[5]}{'r' if c[7] else ''}")
def test_mq_kernel_at_qlen1_is_decode_kernel(case, cuda_device):
    B, S_c, H, KV, dh, pos, window, ring = case
    q, k, v, ids = decode_inputs(case)
    q, k, v = (to_torch(a, "bf16", cuda_device) for a in (q, k, v))
    ids = torch.from_numpy(ids).to(cuda_device)
    a = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
    b = da.decode_attention(q, k, v, ids, pos, window=window)
    assert rel_err(a, b) <= BF16_REL


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 1, 4, 64), dtype=torch.float16, device=cuda_device)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda_device)
    ids = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, k, ids, 7)
    q = torch.zeros((1, 16, 4, 512), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., ::2], q[..., ::2], q[..., ::2])
    qf = torch.zeros((1, 2, 4, 64), dtype=torch.float32, device=cuda_device)
    kf = torch.zeros((1, 8, 2, 64), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):          # the mq kernel is bf16 only
        mq.mq_decode_attention(qf, kf, kf, ids, 7)
    with pytest.raises(ValueError):
        mq.mq_decode_attention(qf.bfloat16(), kf.bfloat16(), kf.bfloat16(),
                               ids[:4], 7)


def test_model_kernel_path_vs_reference(cuda_device):
    """gemma3 smoke (sliding windows, a ring that wraps) on the card:
    the kernel path launches both kernels and its logits stay within
    bf16 noise of the reference math."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), window_size=6)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    out, fed = {}, []
    for impl in ("ref", "kernel"):        # kernel path fed the ref's picks
        f0, d0 = fa.launches, da.launches
        cache = M.init_cache(cfg, 2, 16)
        lg, cache = M.prefill(cfg, params, toks.to(cuda_device), cache,
                              impl=impl)
        steps = [lg[:, -1].float()]
        for i in range(8):
            if impl == "ref":
                fed.append(lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True))
            lg, cache = M.decode_step(cfg, params, cache, fed[i], impl=impl)
            steps.append(lg[:, -1].float())
        out[impl] = torch.stack(steps)
        launched = (fa.launches - f0, da.launches - d0)
        assert launched == ((cfg.n_layers, 8 * cfg.n_layers)
                            if impl == "kernel" else (0, 0))
    err = (out["kernel"] - out["ref"]).abs().max().item()
    assert err <= 0.05 * out["ref"].abs().max().item()


def test_lime_server_defaults_to_the_card(cuda_device):
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg)           # no device: the card
    assert params["embedding"].device.type == "cuda"
    srv = LimeServer(cfg, params, max_len=64, pattern="bursty")
    rng = np.random.default_rng(0)
    for _ in range(4):
        srv.queue.submit(rng.integers(1, cfg.vocab_size, 12), 5)
    n0 = da.launches
    done = srv.serve_all()
    assert len(done) == 4 and all(len(r.output) == 5 for r in done)
    assert da.launches - n0 == 4 * cfg.n_layers


def test_engine_streams_and_matches_model(cuda_device):
    """llama smoke, 4 layers, 2 chunks of 1 resident + 1 streamed layer
    (pinned host store, side-stream copies): decode and verify equal the
    model's kernel path bit for bit, and a retier round trip keeps them
    equal."""
    cfg = dataclasses.replace(get_smoke_config("llama3.3-70b"), n_layers=4)
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    eng = InterleavedEngine(cfg, UniformPlan(1, 2, 1, 1), mb=2, max_len=32,
                            retier_headroom=1)
    st = eng.init_state(params)
    assert eng._store.registered and eng._store.data.is_pinned()
    mc = M.init_cache(cfg, 2, 32)
    toks = torch.randint(1, cfg.vocab_size, (2, 9), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    m0 = mq.launches
    el, st = eng.verify_step(st, toks)
    ml, mc = M.verify_step(cfg, params, mc, toks, impl="kernel")
    assert mq.launches - m0 == 2 * cfg.n_layers
    assert torch.equal(el, ml)
    tok = el[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for step in range(4):
        if step == 1:
            eng.retier(st, 0, +1)
        if step == 3:
            eng.retier(st, 0, -1)
        el, st = eng.decode_step(st, tok)
        ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel")
        assert torch.equal(el, ml[:, 0])
        tok = el[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    eng.close()


# ----------------------------------------------------------------------------
# paged kernels (3: paged decode, 5: paged multi-query)
# ----------------------------------------------------------------------------
def _paged_on(device, q, k, v, bt, ctx, dt="bf16"):
    return (*(to_torch(a, dt, device) for a in (q, k, v)),
            torch.from_numpy(bt).to(device), torch.from_numpy(ctx).to(device))


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c[1]}kv{c[2]}d{c[3]}ps{c[4]}w{c[7]}")
def test_paged_kernel_vs_plain(case, cuda_device):
    window = case[-1]
    q, k, v, bt, ctx = _paged_on(cuda_device, *paged_case_inputs(case))
    n0 = pg.launches
    out = pg.paged_decode_attention(q, k, v, bt, ctx, window=window)
    torch.cuda.synchronize()
    assert pg.launches == n0 + 1
    ref = pg.paged_decode_attention_plain(q, k, v, bt, ctx, window=window)
    assert rel_err(out, ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_PAGED_CASES,
                         ids=lambda c: f"q{c[1]}H{c[2]}kv{c[3]}d{c[4]}ps{c[5]}w{c[8]}")
def test_mq_paged_kernel_vs_plain(case, cuda_device):
    window = case[-1]
    q, k, v, bt, ctx = _paged_on(cuda_device, *mq_paged_case_inputs(case))
    n0 = mq.paged_launches
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctx, window=window)
    torch.cuda.synchronize()
    assert mq.paged_launches == n0 + 1
    ref = mq.mq_paged_decode_attention_plain(q, k, v, bt, ctx, window=window)
    assert rel_err(out, ref) <= BF16_REL


def _uniform(case, Q):
    """A case's shapes with every sequence at the largest ctx (the shared
    position the contiguous kernels take)."""
    B, H, KV, dh, ps, maxp, ctx, window = case
    c = max(max(ctx), Q)
    return paged_inputs(B, Q, H, KV, dh, ps, maxp, (c,) * B, seed=3), window


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c[1]}kv{c[2]}d{c[3]}ps{c[4]}w{c[7]}")
def test_paged_kernel_bitwise_vs_decode_kernel(case, dt, cuda_device):
    """The paged kernel over the pool equals the contiguous decode kernel
    on the gathered cache bit for bit: one body, one split, one tile
    order; only the slot addressing differs."""
    (q, k, v, bt, ctx), window = _uniform(case, 1)
    q, k, v, bt, ctx = _paged_on(cuda_device, q, k, v, bt, ctx, dt)
    c = int(ctx[0])
    out = pg.paged_decode_attention(q, k, v, bt, ctx, window=window)
    ids = torch.from_numpy(gathered_ids(bt.shape[1] * k.shape[1], c)) \
        .to(cuda_device)
    ref = da.decode_attention(q, pg.gather_pages(k, bt).contiguous(),
                              pg.gather_pages(v, bt).contiguous(), ids, c - 1,
                              window=window)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", MQ_PAGED_CASES,
                         ids=lambda c: f"q{c[1]}H{c[2]}kv{c[3]}d{c[4]}ps{c[5]}w{c[8]}")
def test_mq_paged_kernel_bitwise_vs_mq_kernel(case, cuda_device):
    B, Q, H, KV, dh, ps, maxp, ctx, window = case
    (q, k, v, bt, ctx), _ = _uniform((B, H, KV, dh, ps, maxp, ctx, window), Q)
    q, k, v, bt, ctx = _paged_on(cuda_device, q, k, v, bt, ctx)
    c = int(ctx[0])
    out = mq.mq_paged_decode_attention(q, k, v, bt, ctx, window=window)
    ids = torch.from_numpy(gathered_ids(maxp * ps, c)).to(cuda_device)
    ref = mq.mq_decode_attention(q, pg.gather_pages(k, bt).contiguous(),
                                 pg.gather_pages(v, bt).contiguous(), ids,
                                 c - Q, window=window)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("q_len", [1, 5, 128])
def test_paged_kernels_read_only_filled_slots(q_len, cuda_device):
    """NaN in every page no table names and in every slot past ctx (the
    tail of each last page): a kernel that read one would return NaN, so
    the output must equal the clean pool's bit for bit. Main-path widths:
    page 64, H 64, KV 8, dh 128; ragged ctx."""
    ctx = (1019, 700, 300, 130)
    q, k, v, bt, ctxn = paged_inputs(4, q_len, 64, 8, 128, 64, 16, ctx,
                                     seed=5)
    q, k, v, bt, ctxn = _paged_on(cuda_device, q, k, v, bt, ctxn)
    dirty = torch.ones(k.shape[:2], dtype=torch.bool, device=cuda_device)
    for b, c in enumerate(ctx):
        t = torch.arange(c, device=cuda_device)
        dirty[bt[b, t // 64].long(), t % 64] = False
    kd, vd = k.clone(), v.clone()
    kd[dirty] = float("nan")
    vd[dirty] = float("nan")
    if q_len == 1:
        fn = pg.paged_decode_attention
    else:
        fn = mq.mq_paged_decode_attention
    clean = fn(q, k, v, bt, ctxn)
    got = fn(q, kd, vd, bt, ctxn)
    assert torch.isfinite(got.float()).all() and torch.equal(got, clean)


def test_paged_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, k, v, bt, ctx = _paged_on(cuda_device,
                                 *paged_case_inputs(PAGED_CASES[0]))
    with pytest.raises(ValueError):           # page size not a multiple of 8
        pg.paged_decode_attention(q, k[:, :6].contiguous(),
                                  v[:, :6].contiguous(), bt, ctx)
    with pytest.raises(ValueError):           # int64 tables
        pg.paged_decode_attention(q, k, v, bt.long(), ctx)
    with pytest.raises(ValueError):           # ctx of another batch
        pg.paged_decode_attention(q, k, v, bt, ctx[:1])
    with pytest.raises(ValueError):           # dh of q and pool differ
        pg.paged_decode_attention(q[..., :32].contiguous(), k, v, bt, ctx)
    with pytest.raises(ValueError):           # two query positions
        pg.paged_decode_attention(torch.cat([q, q], 1), k, v, bt, ctx)
    with pytest.raises(TypeError):            # the mq kernel is bf16 only
        mq.mq_paged_decode_attention(q.float(), k.float(), v.float(), bt, ctx)
    with pytest.raises(ValueError):           # page size 4
        mq.mq_paged_decode_attention(q, k[:, :4].contiguous(),
                                     v[:, :4].contiguous(), bt, ctx)
    with pytest.raises(ValueError):           # tables on the CPU
        mq.mq_paged_decode_attention(q, k, v, bt.cpu(), ctx)


def test_paged_cache_is_contiguous_decode_bit_for_bit(cuda_device):
    """llama smoke on the card: a paged cache seeded from the flash
    prefill, its pages reused out of order, decodes across page boundaries
    bit-equal to the model's contiguous decode_step (kernel 3 against 1,
    max_len a multiple of the page size), and one verify pass is bit-equal
    to verify_step (kernel 5 against 4)."""
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    from repro_torch.kvcache.pool import PagedKVConfig, PagePool
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (2, 13), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    cache = M.init_cache(cfg, 2, 32)
    lg, cache = M.prefill(cfg, params, toks, cache, impl="kernel")
    pool = PagePool(PagedKVConfig(page_size=8, device_pages=12))
    for pid in reversed(pool.alloc_pages(5)):
        pool.decref_page(pid)
    pc = PagedDecodeCache(cfg, 2, 32, page_size=8, pool=pool, impl="kernel")
    pc.seed(cache)
    tok = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    d0, p0 = da.launches, pg.launches
    for _ in range(6):                        # positions 13..18: page 2 opens
        lm, cache = M.decode_step(cfg, params, cache, tok, impl="kernel")
        assert torch.equal(pc.step(params, tok), lm)
        tok = lm[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    assert (da.launches - d0, pg.launches - p0) == (6 * cfg.n_layers,) * 2
    mat = torch.cat([tok, toks[:, :3]], 1)
    lv, cache = M.verify_step(cfg, params, cache, mat, impl="kernel")
    assert torch.equal(pc.verify(params, mat), lv)


def test_prefix_server_on_card(cuda_device):
    """The prefix cache served on the card: two epochs of one template,
    the warm one prefilling only the uncached suffix through the paged
    multi-query kernel; its tokens are a cold serve's."""
    from repro_torch.serving import make_arrivals, requests_from_arrivals
    cfg = get_smoke_config("llama3.3-70b")
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0))
    arr = [dataclasses.replace(a, time_s=0.0) for a in make_arrivals(
        "shared_prefix", 8, n_templates=1, prefix_len=24, prompt_len=32,
        max_new_tokens=6, seed=0)]
    prompts = [r.prompt for r in requests_from_arrivals(
        arr, vocab_size=cfg.vocab_size)]

    def serve(ps):
        srv = LimeServer(cfg, params, max_len=64, pattern="bursty",
                         prefix_cache=True, prefill_chunk_tokens=8,
                         page_size=8)
        for p in ps:
            srv.queue.submit(p, 6)
        done = sorted(srv.serve_all(), key=lambda r: r.rid)
        return [r.output for r in done], srv.make_backend()

    n0, p0 = mq.paged_launches, pg.launches
    toks, be = serve(prompts)
    # epoch 1: 4 rounds of 8; epoch 2: one round (24 of 32 cached)
    assert mq.paged_launches - n0 == (4 + 1) * cfg.n_layers
    assert pg.launches - p0 == 2 * 5 * cfg.n_layers
    assert be.prefix_stats["prefill_tokens_saved"] == 4 * 24
    assert toks[4:] == serve(prompts[4:])[0]
