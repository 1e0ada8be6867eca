"""The port's paged KV path against the JAX package: the paged attention
functions, the allocator / pool / radix copies, the dense <-> paged
layout, and PagedDecodeCache.

The paged plain versions mirror the JAX page-walking references (fp32
probabilities, not rounded) and are held to BF16_REL of each output head
vector's largest |ref| against both the jnp reference and the
interpret-mode Pallas kernel, as tests/test_kvcache.py runs them; every
row of these cases sees its own slot (the JAX versions give the uniform
average of V on a row that sees none, the port 0). Against the port's
contiguous plain versions on the gathered cache the limit is the same:
those round the probabilities to bf16 before PV, the paged ones do not.

Whole model passes are held to _torch_parity's LOGIT_TOL (XLA fuses
across ops and skips bf16 roundings that op-by-op PyTorch takes); the
bookkeeping copies must agree exactly: the same page ids, refcounts,
matches and evictions for one seeded sequence of operations.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_cases import (BF16_REL, MQ_PAGED_CASES, PAGED_CASES,  # noqa: E402
                          f32, gathered_ids, mq_paged_case_inputs,
                          paged_case_inputs, rel_err, to_torch)
from _torch_parity import LOGIT_TOL, jax_params, port_cfg  # noqa: E402
from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.kernels.decode_attention import multiquery as jax_mq  # noqa: E402
from repro.kernels.decode_attention import paged as jax_pg  # noqa: E402
from repro.kvcache import allocator as JA  # noqa: E402
from repro.kvcache import layout as JL  # noqa: E402
from repro.kvcache import pool as JP  # noqa: E402
from repro.kvcache.paged_decode import PagedDecodeCache as JPDC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.prefixcache import radix as JR  # noqa: E402
from repro_torch.configs.base import Family  # noqa: E402
from repro_torch.kernels.decode_attention import multiquery as mq  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels.decode_attention import paged as pg  # noqa: E402
from repro_torch.kvcache import allocator as PA  # noqa: E402
from repro_torch.kvcache import layout as PL  # noqa: E402
from repro_torch.kvcache import pool as PP  # noqa: E402
from repro_torch.kvcache.paged_decode import PagedDecodeCache  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.prefixcache import radix as PR  # noqa: E402


def _torch_args(q, k, v, bt, ctx):
    return (*(to_torch(a, "bf16") for a in (q, k, v)), torch.from_numpy(bt),
            torch.from_numpy(ctx))


# ----------------------------------------------------------------------------
# paged attention functions
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c[1]}kv{c[2]}d{c[3]}ps{c[4]}w{c[7]}")
def test_paged_plain_vs_jax(case):
    window = case[-1]
    arrays = paged_case_inputs(case)
    n0 = pg.launches
    out = pg.paged_decode_attention(*_torch_args(*arrays), window=window)
    assert pg.launches == n0, "a CPU tensor must never launch the kernel"
    assert out.dtype == torch.bfloat16 and out.shape == arrays[0].shape
    ja = [jnp.asarray(a) for a in arrays]
    ref = jax_pg.paged_decode_attention_ref(*ja, window=window)
    pal = jax_pg.paged_decode_attention(*ja, window=window, interpret=True)
    for other in (ref, pal):
        assert rel_err(out, torch.from_numpy(f32(other))) <= BF16_REL


@pytest.mark.parametrize("case", MQ_PAGED_CASES,
                         ids=lambda c: f"q{c[1]}H{c[2]}kv{c[3]}d{c[4]}ps{c[5]}w{c[8]}")
def test_mq_paged_plain_vs_jax(case):
    window = case[-1]
    arrays = mq_paged_case_inputs(case)
    n0 = mq.paged_launches
    out = mq.mq_paged_decode_attention(*_torch_args(*arrays), window=window)
    assert mq.paged_launches == n0, "a CPU tensor must never launch the kernel"
    assert out.dtype == torch.bfloat16 and out.shape == arrays[0].shape
    ja = [jnp.asarray(a) for a in arrays]
    ref = jax_mq.mq_paged_decode_attention_ref(*ja, window=window)
    pal = jax_mq.mq_paged_decode_attention(*ja, window=window, interpret=True)
    for other in (ref, pal):
        assert rel_err(out, torch.from_numpy(f32(other))) <= BF16_REL


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c[1]}kv{c[2]}d{c[3]}ps{c[4]}w{c[7]}")
def test_paged_plain_vs_contiguous_plain(case):
    """Each sequence's cache gathered from its pages, through the
    contiguous decode's plain version at pos = ctx - 1."""
    window = case[-1]
    q, k, v, bt, ctx = _torch_args(*paged_case_inputs(case))
    out = pg.paged_decode_attention_plain(q, k, v, bt, ctx, window=window)
    n = bt.shape[1] * k.shape[1]
    for b, c in enumerate(ctx.tolist()):
        ids = torch.from_numpy(gathered_ids(n, c))
        ref = da.decode_attention_plain(
            q[b:b + 1], pg.gather_pages(k, bt[b:b + 1]),
            pg.gather_pages(v, bt[b:b + 1]), ids, c - 1, window=window)
        assert rel_err(out[b:b + 1], ref) <= BF16_REL


@pytest.mark.parametrize("case", MQ_PAGED_CASES,
                         ids=lambda c: f"q{c[1]}H{c[2]}kv{c[3]}d{c[4]}ps{c[5]}w{c[8]}")
def test_mq_paged_plain_vs_contiguous_plain(case):
    Q, window = case[1], case[-1]
    q, k, v, bt, ctx = _torch_args(*mq_paged_case_inputs(case))
    out = mq.mq_paged_decode_attention_plain(q, k, v, bt, ctx, window=window)
    n = bt.shape[1] * k.shape[1]
    for b, c in enumerate(ctx.tolist()):
        ids = torch.from_numpy(gathered_ids(n, c))
        ref = mq.mq_decode_attention_plain(
            q[b:b + 1], pg.gather_pages(k, bt[b:b + 1]),
            pg.gather_pages(v, bt[b:b + 1]), ids, c - Q, window=window)
        assert rel_err(out[b:b + 1], ref) <= BF16_REL


def test_gather_pages_is_jax_gather_page_row():
    q, k, v, bt, ctx = paged_case_inputs(PAGED_CASES[0])
    got = pg.gather_pages(to_torch(k, "bf16"), torch.from_numpy(bt))
    for b in range(bt.shape[0]):
        want = jax_pg.gather_page_row(jnp.asarray(k), jnp.asarray(bt[b]))
        np.testing.assert_array_equal(f32(got[b]), f32(want))


# ----------------------------------------------------------------------------
# bookkeeping copies: one seeded operation sequence through both packages
# ----------------------------------------------------------------------------
def _pool_state(pool):
    return (list(pool.alloc._free), list(pool.alloc._ref), dict(pool._tier),
            dict(pool._count), dict(pool._cap), pool.spilled_pages,
            pool.fetched_pages, pool.migrated_bytes, pool._spare)


def _drive(pool_mod, alloc_mod, radix_mod, seed=0):
    """A seeded mix of table growth, forks, truncation, release, radix
    insert / match / evict, tier migration and capacity changes; returns
    every operation's result and the full state after it."""
    rng = np.random.default_rng(seed)
    pool = pool_mod.PagePool(pool_mod.PagedKVConfig(
        page_size=4, device_pages=24, host_pages=8, page_bytes=64.0))
    tree = radix_mod.RadixPrefixCache(pool)
    tables, prompts, log = {}, {}, []
    template = [int(t) for t in rng.integers(1, 50, 12)]
    for step in range(160):
        op = int(rng.integers(0, 8))
        try:
            if op == 0 and len(tables) < 5:            # admit with prefix
                rid = step
                p = template[:int(rng.integers(0, 12))] \
                    + [int(t) for t in rng.integers(1, 50,
                                                    int(rng.integers(1, 9)))]
                pages, n = tree.match(p, max_pages=(len(p) - 1) // 4)
                t = alloc_mod.BlockTable(4)
                for pid in pages:
                    pool.incref_page(pid)
                t.pages, t.tokens = list(pages), n
                pool.extend_table(t, len(p))
                tables[rid], prompts[rid] = t, p
                res = (pages, n)
            elif op == 1 and tables:                   # grow a table
                rid = sorted(tables)[int(rng.integers(0, len(tables)))]
                res = pool.extend_table(tables[rid],
                                        tables[rid].tokens
                                        + int(rng.integers(1, 6)))
            elif op == 2 and tables:                   # spec rollback
                rid = sorted(tables)[int(rng.integers(0, len(tables)))]
                t = tables[rid]
                res = pool.truncate_table(
                    t, max(len(prompts[rid]),
                           t.tokens - int(rng.integers(0, 5))))
            elif op == 3 and tables:                   # finish: donate
                rid = sorted(tables)[int(rng.integers(0, len(tables)))]
                t = tables.pop(rid)
                toks = prompts.pop(rid) + [1000 + i for i in range(t.tokens)]
                res = tree.insert(toks, t.pages, n_tokens=t.tokens)
                pool.release_table(t)
            elif op == 4:
                res = tree.evict(int(rng.integers(1, 4)))
            elif op == 5 and tables:                   # spill / fetch
                rid = sorted(tables)[int(rng.integers(0, len(tables)))]
                res = pool.spill_table(tables[rid]) if rng.random() < 0.5 \
                    else pool.fetch_table(tables[rid])
            elif op == 6:
                res = pool.grow(int(rng.integers(1, 3))) if rng.random() < 0.5 \
                    else pool.shrink(int(rng.integers(1, 3)))
            elif op == 7 and tables:                   # a fork shares pages
                rid = sorted(tables)[int(rng.integers(0, len(tables)))]
                f = tables[rid].fork(pool.alloc)
                res = list(f.pages)
                f.release(pool.alloc)
            else:
                res = None
        except (JA.OutOfPages, PA.OutOfPages) as e:
            res = ("OutOfPages", type(e).__name__ == "OutOfPages")
        log.append((op, res, _pool_state(pool), tree.n_pages,
                    sorted(tree.digest()._hashes), tree.lookups, tree.hits,
                    tree.evicted_pages,
                    {r: (list(t.pages), t.tokens) for r, t in tables.items()}))
    return log


def test_allocator_pool_radix_copies_agree_with_jax():
    want = _drive(JP, JA, JR)
    got = _drive(PP, PA, PR)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"operation {i} ({a[0]}) diverges"
    ops = {e[0] for e in want if e[1] is not None}
    assert ops == set(range(8)), f"sequence misses operations: {ops}"


# ----------------------------------------------------------------------------
# layout: dense <-> paged, bit for bit
# ----------------------------------------------------------------------------
def test_layout_scatter_gather_equal_jax():
    rng = np.random.default_rng(4)
    L, B, S, KV, dh, ps, ctx = 2, 3, 20, 2, 8, 8, 17
    alloc = PA.PageAllocator(12, ps)
    alloc.alloc_many(5)
    for pid in (3, 0, 4):
        alloc.decref(pid)
    tables = [PA.BlockTable(ps) for _ in range(B)]
    for t in tables:
        t.extend_to(ctx, alloc)
    dense = rng.standard_normal((L, B, S, KV, dh)).astype(np.float32)
    pool = rng.standard_normal((L, 12, ps, KV, dh)).astype(np.float32)
    jt = [JA.BlockTable(ps, list(t.pages), t.tokens) for t in tables]
    want = JL.scatter_to_pages(pool.copy(), dense, jt, ctx)
    got = PL.scatter_to_pages(torch.from_numpy(pool.copy()),
                              torch.from_numpy(dense), tables, ctx)
    np.testing.assert_array_equal(got.numpy(), want)
    back = PL.gather_from_pages(torch.zeros(L, B, S, KV, dh), got, tables, ctx)
    np.testing.assert_array_equal(
        back.numpy(), JL.gather_from_pages(np.zeros_like(dense), want, jt, ctx))
    np.testing.assert_array_equal(back.numpy()[:, :, :ctx], dense[:, :, :ctx])


# ----------------------------------------------------------------------------
# PagedDecodeCache against the JAX package
# ----------------------------------------------------------------------------
def _cfgs():
    g = get_smoke_config("gemma3-1b")
    return {"llama-smoke": get_smoke_config("llama3.3-70b"),
            "gemma-window6": dataclasses.replace(g, window_size=6)}


@pytest.mark.parametrize("name", ["llama-smoke", "gemma-window6"])
def test_paged_cache_vs_jax(name):
    """Seed from a dense prefill, decode across page boundaries, verify 4
    and commit 2 (rollback), decode again; the port's PagedDecodeCache
    (plain page walks on the CPU) against the JAX PagedDecodeCache and the
    JAX dense decode_step on the same weights and tokens, logits within
    LOGIT_TOL; page counts equal and no page left after release."""
    cfg = _cfgs()[name]
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg)
    B, S, max_len, ps = 2, 11, 32, 8
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    jl, jc = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks), JM.init_cache(cfg, B, max_len))
    jpc = JPDC(cfg, B, max_len, page_size=ps)
    jpc.seed(jc)
    pl, pc_dense = PM.prefill(pcfg, pp, torch.from_numpy(toks).long(),
                              PM.init_cache(pcfg, B, max_len, device="cpu"))
    ppc = PagedDecodeCache(pcfg, B, max_len, page_size=ps, impl="kernel",
                           device="cpu")
    ppc.seed(pc_dense)
    assert ppc.pages_in_use == jpc.pages_in_use == B * 2
    jdec = jax.jit(functools.partial(JM.decode_step, cfg))
    V = cfg.vocab_size
    tok = np.array(jnp.argmax(jl[:, -1, :V], -1), np.int32)[:, None]

    def both(j, p):
        j, p = f32(j)[..., :V], f32(p)[..., :V]
        np.testing.assert_allclose(p, j, atol=LOGIT_TOL)
        return j

    for _ in range(7):                        # positions 11..17: page 2 opens
        jd, jc = jdec(jp, jc, jnp.asarray(tok))
        want = both(jpc.step(jp, jnp.asarray(tok)),
                    ppc.step(pp, torch.from_numpy(tok)))
        np.testing.assert_allclose(f32(jd)[..., :V], want, atol=LOGIT_TOL)
        tok = want[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert ppc.pages_in_use == jpc.pages_in_use == B * 3
    draft = np.concatenate([tok, np.random.default_rng(8).integers(
        1, V, (B, 3)).astype(np.int32)], 1)
    both(jpc.verify(jp, draft), ppc.verify(pp, torch.from_numpy(draft)))
    jpc.commit(2)
    ppc.commit(2)
    assert ppc.pos == jpc.pos == 20 and ppc.pages_in_use == jpc.pages_in_use
    tok = draft[:, 2:3]
    for _ in range(2):
        want = both(jpc.step(jp, jnp.asarray(tok)),
                    ppc.step(pp, torch.from_numpy(tok)))
        tok = want[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert [t.pages for t in ppc.tables] == [t.pages for t in jpc.tables]
    ppc.release()
    assert ppc.pool.pages_in_use() == 0 and ppc.pool.alloc.used_pages == 0


@pytest.mark.parametrize("chunk", [0, 5])
def test_paged_cache_prefill_vs_jax(chunk):
    """Chunked (and monolithic) prefill through the paged multi-query
    rounds against the JAX PagedDecodeCache and the JAX dense prefill."""
    cfg = get_smoke_config("llama3.3-70b")
    pcfg = port_cfg(cfg)
    jp, _, pp = jax_params(cfg)
    toks = np.random.default_rng(9).integers(1, cfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    jpc = JPDC(cfg, 2, 32, page_size=8)
    ppc = PagedDecodeCache(pcfg, 2, 32, page_size=8, impl="kernel",
                           device="cpu")
    want = f32(jpc.prefill(jp, toks, chunk=chunk))[:, :cfg.vocab_size]
    got = f32(ppc.prefill(pp, torch.from_numpy(toks), chunk=chunk))
    np.testing.assert_allclose(got[:, :cfg.vocab_size], want, atol=LOGIT_TOL)
    jd, _ = jax.jit(functools.partial(JM.prefill, cfg))(
        jp, jnp.asarray(toks), JM.init_cache(cfg, 2, 32))
    np.testing.assert_allclose(got[:, :cfg.vocab_size],
                               f32(jd)[:, -1, :cfg.vocab_size], atol=LOGIT_TOL)
    assert ppc.pos == 13 and ppc.pages_in_use == 4
    ppc.release()
    assert ppc.pool.alloc.used_pages == 0


def test_block_table_uploads_only_on_change():
    """The device table is rebuilt only when a table grows or shrinks:
    once per page boundary crossed, not once per step."""
    cfg = port_cfg(get_smoke_config("llama3.3-70b"))
    _, _, pp = jax_params(get_smoke_config("llama3.3-70b"))
    pc = PagedDecodeCache(cfg, 2, 32, page_size=8, impl="kernel",
                          device="cpu")
    pc.prefill(pp, torch.ones((2, 6), dtype=torch.long), chunk=0)
    assert pc.bt_uploads == 1
    tok = torch.ones((2, 1), dtype=torch.long)
    for _ in range(12):                       # positions 6..17: pages 1, 2
        pc.step(pp, tok)
    assert pc.bt_uploads == 3
    pc.verify(pp, torch.ones((2, 4), dtype=torch.long))   # 18..21: no page
    pc.commit(1)
    assert pc.bt_uploads == 3


def test_paged_entry_points_raise_without_a_card(monkeypatch):
    """Like every entry point of the port: the card unless the caller asks
    for the CPU, and no quiet fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(get_smoke_config("llama3.3-70b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeCache(cfg, 1, 16, page_size=8)
    from repro_torch.serving import LimeServer
    params = PM.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LimeServer(cfg, params, prefix_cache=True)


def test_prefix_cache_refuses_an_engine():
    """The radix cache forks pages of the single-device paged pool; the
    engine keeps a dense cache per slot (as in the JAX backend)."""
    import types
    from repro_torch.serving import EngineBackend
    cfg = port_cfg(get_smoke_config("llama3.3-70b"))
    eng = types.SimpleNamespace(device=torch.device("cpu"), mb=1)
    with pytest.raises(NotImplementedError):
        EngineBackend(cfg, {}, engine=eng, prefix_cache=True)
    # the paged path serves the dense family only (parallel blocks
    # included), as the JAX package's does: the VLM's prefill takes patch
    # embeddings that no page holds
    with pytest.raises(NotImplementedError):
        PagedDecodeCache(dataclasses.replace(cfg, family=Family.VLM), 1, 16,
                         page_size=8, device="cpu")
    with pytest.raises(ValueError):
        PagedDecodeCache(cfg, 1, 16, page_size=8, impl="pallas", device="cpu")
