#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one CUDA card

Phases; any failure exits non-zero without the final ``ok`` line:

0. card and build: the card's name and power limit (nvidia-smi), the
   kernels built from ``src/repro_torch/csrc`` (nvcc, sm_90a), TF32 off
   for every fp32 reference product.
1. kernels against their plain PyTorch versions on the card, at the main
   path's shapes and at ring-buffer / window / unaligned / offset cases,
   within a tolerance relative to the reference's size that is shown to
   reject planted off-by-one faults;
   at the main path's shapes the kernel's median device time (CUDA
   events, L2 flushed and host enqueue hidden before each call), its
   bound, the plain version's time and one PyTorch library call's time as
   a yardstick. The paged kernels (3: decode, 5: multi-query) run at phase
   2b's shapes (page 64, 16 pages, ctx 1019; q_len 128 and 5) with
   shuffled non-contiguous block tables, ragged ctx, windows and dh 80 /
   page 16, reject planted faults (page index +-1, ctx - 1, row // G off
   by one, window - 1), and equal kernels 1 and 4 bit for bit on the
   gathered cache.
2. the single-device path: LLaMA-3.3-70B at full width, depth cut to 8
   of 80 layers, random weights from a seed, served through LimeServer ->
   ContinuousBatchingScheduler -> EngineBackend under bursty and sporadic
   traffic; both kernels' launch counters must advance by the expected
   counts; a re-serve on the reference math (impl="ref") gives the
   reference tokens, which are fed through both impls at the served batch
   shape, and at every position the kernel path's greedy pick must be the
   reference's (or a near tie) with its logits within the limit; a
   profiler breakdown of one bursty serve gives device time by kernel
   class and the device's idle share.
2b. paged KV and the radix prefix cache on phase 2's weights, through
   LimeServer(prefix_cache=True, prefill_chunk_tokens=128, page_size=64):
   two epochs of 4 shared-prefix requests (one template, 384 of 512 prompt
   tokens) and one epoch of unequal lengths. Every step launches exactly
   what it implies (8 paged multi-query kernels per prefill round of the
   uncached suffix, 8 paged decode kernels per decode step, 8 flash for the
   unequal epoch's dense prefill, nothing of kernels 1 and 4), the warm
   epoch saves 4 x 384 prompt tokens, the block table is uploaded only
   when a table changed, warm tokens equal a cold serve's (or differ at a
   near tie), and decode on a paged cache seeded from the dense prefill is
   bit-equal to the contiguous decode_step (kernel 1) at every step.
   Printed: pool pages and bytes, peak HBM, cold vs warm prefill time, the
   paged kernels' µs per call in a profiled serve.
3a. the interleaved engine against the model on phase 2's weights, in a
   plan forced to stream (2 chunks of 2 resident + 2 streamed layers):
   decode and verify logits bit-equal to the model's kernel path, the
   engine's chunked prefill (multi-query rounds) within the logit limit of
   the model's flash prefill.
3b. the main path: all 80 layers of LLaMA-3.3-70B at full width (or the
   deepest cut, >= 40 layers, whose streamed tier the host's memory holds,
   printed as a cut), random weights from seed 0, through the
   InterleavedEngine: resident layers in HBM, the rest streamed from
   pinned host memory on a side stream. Bursty (4 requests together) and
   sporadic (2, 4 s apart) traffic through LimeServer with resident
   self-speculation (k = 4 drafts on the resident tier, verified by the
   multi-query kernel) and a live retier(+1) / retier(-1) in the bursty
   serve; the mq and decode launch counters advance by exactly what each
   round implies; every served token equals the same engine's greedy
   decode through (k+1)-wide verify passes, and matches its plain greedy
   decode (decode kernel) up to a first divergence that must be a near
   tie (judged on the logits of one verify pass over the continuation).
   Printed: plan, memory, H2D rate, TTFT, ms/token,
   acceptance, committed tokens per round, pass and draft times against
   the copy time of the streamed bytes, and a profiler breakdown of one
   pass.
4. a JSON line of per-kernel numbers, then the ``ok`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the 80-layer phase fills HBM to ~92% with 1.7 GB layers while layer
# sources allocate and free large temporaries: growable segments keep the
# caching allocator from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
FP32_SIMT_FLOPS = 67e12            # fp32 outside the tensor cores
# Kernel tolerances are relative to the reference's own size: each output
# element must lie within REL x the largest |ref| of its vector (one head
# of one row, dh values). At the main decode shape |out| is ~0.04 and a
# vector's largest ~0.15, so a fixed atol would hide real faults.
# bf16: 2^-6 is 2-4 ulps of the vector's largest element. The kernels round
# the probabilities where their plain versions do not (or the reverse);
# that costs at most 2^-7 at the main shapes. A planted off-by-one (a
# dropped current slot, diagonal or last kv tile) costs >= 0.3 there, and
# each main-shape check proves its tolerance sees such a fault.
BF16_REL = 2.0 ** -6
F32_REL = 2e-5    # fp32 paths: summation order and exp() implementation only
# logits are bf16 (ulp 0.03 at |logit| ~ 4.5): the kernels keep fp32
# probabilities where the reference rounds them to bf16, and 8 layers of
# 8192-wide bf16 GEMMs carry that on; 5% of the largest |logit| is ~7 ulps
LOGIT_REL_TOL = 0.05
N_LAYERS = 8      # depth cut: 8 of LLaMA-3.3-70B's 80 layers fit one H100
PROMPT_LEN, MAX_NEW, MAX_LEN = 512, 32, 1024
SPIN_CYCLES = 5_000_000   # ~3 ms at the H100's clock: longer than any timed
                          # call takes to enqueue
# phase 3b (the 80-layer engine)
MIN_LAYERS = 40           # the deepest cut host memory may force
HOST_RESERVE = 8e9        # host memory left beside the pinned store
PREFILL_CHUNK = 512
SPEC_K = 4
MAX_NEW_80 = 12           # tokens per request in phase 3b: >= 5 rounds at
                          # k = 4 only if drafts are mostly rejected
RETIER_AT = ((2, +1), (4, -1))   # (after decode round, delta), bursty serve


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------------
def time_ms(fn, reps=30, warmup=3):
    """Median device ms of one fn() call over reps calls, each timed with
    CUDA events. Before each call the 50 MB L2 is flushed (the real caller
    finds K/V cold: an MLP's weights pass between two attention calls),
    then a spin kernel keeps the device busy while the host enqueues the
    call, so the wrapper's host time does not show up as device time."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del flush
    return statistics.median(times)


def library_time_ms(fn):
    """Time of the PyTorch library yardstick, or None where this torch
    has no such call (enable_gqa came with torch 2.5)."""
    try:
        fn()
    except TypeError as e:
        log(f"  library call unavailable: {e}")
        return None
    return time_ms(fn)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------------------
# phase 1: kernels against plain versions
# ----------------------------------------------------------------------------
def randn(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def ring_ids(S_c, pos):
    import torch
    base = pos - S_c + 1
    ar = torch.arange(S_c, device="cuda")
    return ((ar - (base % S_c)) % S_c + base).to(torch.int32)


def linear_ids(S_c, pos):
    import torch
    ar = torch.arange(S_c, device="cuda", dtype=torch.int32)
    return torch.where(ar <= pos, ar, torch.full_like(ar, -1))


def rel_err(out, ref):
    """max over output vectors (last dim) of max |out - ref| / max |ref|:
    the error in units of the reference's own size. A vector whose
    reference is 0 (no visible key) must be exactly 0."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1)).nan_to_num(nan=0.0).max().item()


def check(name, out, ref, rel, faults=()):
    """Kernel output against its plain version within rel (see BF16_REL);
    each (label, output) in faults is the plain version run with a planted
    fault, which the same limit must reject. Returns max |out - ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    r = rel_err(out, ref)
    ok = r <= rel and bool(out.float().isfinite().all())
    log(f"  {name}: max_abs_err {err:.3e}, rel_err {r:.3e} (tol {rel:.3g} of "
        f"each vector's max |ref|, mean |ref| {ref.float().abs().mean().item():.3g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    for label, bad in faults:
        rb = rel_err(bad, ref)
        log(f"    planted fault '{label}': rel_err {rb:.3e} "
            f"{'rejected' if rb > rel else 'NOT REJECTED'}")
        if rb <= rel:
            raise AssertionError(f"{name}: tolerance {rel:g} cannot see '{label}'")
    return err


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    log("phase 1: decode_attention kernel vs plain version")
    # B, S_c, H, KV, dh, pos, window, ring, dtype, planted faults (label,
    # arguments of the plain version that replace the right ones)
    dec_cases = [
        ("main B4 S1024 H64 KV8 dh128", 4, 1024, 64, 8, 128, 1023, None, False, bf16,
         [("current slot dropped: pos - 1", dict(pos=1022))]),
        ("ring+window pos1500 w700", 4, 1024, 64, 8, 128, 1500, 700, True, bf16,
         [("window - 1", dict(window=699))]),
        ("unaligned S100 dh80 w32", 2, 100, 4, 4, 80, 60, 32, False, bf16, []),
        ("gemma-like G4 dh256 ring", 2, 256, 4, 1, 256, 400, 128, True, bf16, []),
        ("fp32 S96 dh64 mostly-empty", 3, 96, 6, 2, 64, 10, None, False, f32, []),
    ]
    for name, B, S_c, H, KV, dh, pos, window, ring, dt, planted in dec_cases:
        q = randn((B, 1, H, dh), dt, gen)
        k = randn((B, S_c, KV, dh), dt, gen)
        v = randn((B, S_c, KV, dh), dt, gen)
        ids = ring_ids(S_c, pos) if ring else linear_ids(S_c, pos)
        out = da.decode_attention(q, k, v, ids, pos, window=window)
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
        faults = [(label, da.decode_attention_plain(
            q, k, v, ids, **{"pos": pos, "window": window, **kw}))
            for label, kw in planted]
        err = check(name, out, ref, BF16_REL if dt == bf16 else F32_REL, faults)
        if name.startswith("main"):
            ms = time_ms(lambda: da.decode_attention(q, k, v, ids, pos))
            plain = time_ms(lambda: da.decode_attention_plain(q, k, v, ids, pos))
            lib = library_time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                enable_gqa=True))
            n_valid = int(((ids >= 0) & (ids <= pos)).sum())
            byts = 2 * B * n_valid * KV * dh * k.element_size() \
                + nbytes(q, ids) + nbytes(q)            # K, V rows; q, ids; out
            flops = 2 * 2 * B * H * n_valid * dh        # QK^T and PV (fp32 SIMT)
            rows["decode_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bytes=byts, flops=flops, bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
                ops_bound_ms=flops / FP32_SIMT_FLOPS * 1e3)

    log("phase 1: flash_attention kernel vs plain version")
    # B, Sq, Skv, H, KV, dh, causal, window, q_offset, dtype, planted faults
    # (label, arguments of the plain version that replace the right ones;
    # "kv_keep" keeps only the first kv rows)
    fl_cases = [
        ("main B4 S512 H64 KV8 dh128 causal", 4, 512, 512, 64, 8, 128, True, None, 0, bf16,
         [("diagonal dropped: q_offset - 1", dict(q_offset=-1)),
          ("last 64-row kv tile dropped", dict(kv_keep=448))]),
        ("window 100 S512", 1, 512, 512, 8, 2, 128, True, 100, 0, bf16,
         [("window - 1", dict(window=99))]),
        ("Sq96 Skv192 q_offset96", 1, 96, 192, 6, 2, 64, True, None, 96, bf16,
         [("q_offset - 1", dict(q_offset=95))]),
        ("bidirectional S200 dh256", 1, 200, 200, 4, 1, 256, False, None, 0, bf16, []),
        ("fp32 unaligned S100 dh80", 1, 100, 100, 4, 2, 80, True, None, 0, f32, []),
    ]
    for name, B, Sq, Skv, H, KV, dh, causal, window, q_off, dt, planted in fl_cases:
        q = randn((B, Sq, H, dh), dt, gen)
        k = randn((B, Skv, KV, dh), dt, gen)
        v = randn((B, Skv, KV, dh), dt, gen)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        faults = []
        for label, bad in planted:
            bad = {**kw, **bad}
            n_kv = bad.pop("kv_keep", Skv)
            faults.append((label, fa.flash_attention_plain(
                q, k[:, :n_kv], v[:, :n_kv], **bad)))
        err = check(name, out, ref, BF16_REL if dt == bf16 else F32_REL, faults)
        if name.startswith("main"):
            ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
            plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                            reps=10)
            lib = library_time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True))
            pairs = Sq * (Sq + 1) // 2                  # visible (i, j) pairs
            flops = 2 * 2 * B * H * pairs * dh
            byts = nbytes(q, k, v) + nbytes(q)
            rows["flash_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bytes=byts, flops=flops, bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
                ops_bound_ms=flops / BF16_TENSOR_FLOPS * 1e3)
    mq_phase(gen, rows)
    paged_phase(gen, rows)
    for name, r in rows.items():
        bound = max(r["bytes_bound_ms"], r["ops_bound_ms"])
        r["bound_ms"] = bound
        r["bound_by"] = "bytes" if r["bytes_bound_ms"] >= r["ops_bound_ms"] else "operations"
        log(f"  {name} @ main shape: kernel {r['ms']:.4f} ms, bound {bound:.4f} ms "
            f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} GFLOP), "
            f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']} ms, "
            f"roofline share {bound / r['ms']:.3f}")
    return rows


def mq_ids(S_c, pos, Q, kind):
    """pos_ids of a cache holding the q_len new positions pos .. pos+Q-1:
    "linear" (slots up to pos+Q-1 filled), "ring" (a ring buffer after
    pos+Q-1), "stale" (the next 6 slots hold positions of a rejected
    round, pos_ids > every query's)."""
    import torch
    last = pos + Q - 1
    if kind == "ring":
        return ring_ids(S_c, last)
    ar = torch.arange(S_c, device="cuda", dtype=torch.int32)
    keep = last + (6 if kind == "stale" else 0)
    return torch.where(ar <= keep, ar, torch.full_like(ar, -1))


def mq_visible(ids, pos, Q, window):
    """(Q, S_c) bool: slot s visible to the query at position pos + qi."""
    import torch
    qpos = pos + torch.arange(Q, device=ids.device)[:, None]
    vis = (ids[None, :] >= 0) & (ids[None, :] <= qpos)
    if window is not None:
        vis &= (qpos - ids[None, :]) < window
    return vis


def mq_phase(gen, rows):
    """The multi-query kernel against its plain version at the main path's
    verify (k = 4) and prefill-round shapes and at ring / window / stale
    / unaligned cases, with planted faults; at q_len 1 against the decode
    kernel; device times at both main shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da

    bf16 = torch.bfloat16
    log("phase 1: mq_decode_attention kernel vs plain version")
    # name, B, q_len, S_c, H, KV, dh, pos, window, cache kind, planted
    # faults (label, arguments of the plain version that replace the right
    # ones): pos - 1 drops each query's own slot (<= became <), pos + 1
    # gives row r the position of row r + G (row // G off by one)
    cases = [
        ("verify B4 q5 S1024 H64 KV8 dh128", 4, 5, 1024, 64, 8, 128, 1019, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=1018)),
                    ("row // G off by one", dict(pos=1020))]),
        ("prefill B4 q512 S1024 H64 KV8 dh128", 4, 512, 1024, 64, 8, 128, 0, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=-1)),
                    ("row // G off by one", dict(pos=1))]),
        ("ring+window dh80 pos1500 w700", 2, 5, 1024, 16, 2, 80, 1500, 700, "ring",
         [("window - 1", dict(window=699))]),
        ("stale pos_ids > pos, pos 300", 2, 5, 1024, 64, 8, 128, 300, None, "stale",
         [("diagonal dropped: <= -> <", dict(pos=299))]),
        ("q9 G8 S100 dh64 w32 unaligned", 1, 9, 100, 16, 2, 64, 50, 32, "linear", []),
    ]
    for name, B, Q, S_c, H, KV, dh, pos, window, kind, planted in cases:
        q = randn((B, Q, H, dh), bf16, gen)
        k = randn((B, S_c, KV, dh), bf16, gen)
        v = randn((B, S_c, KV, dh), bf16, gen)
        ids = mq_ids(S_c, pos, Q, kind)
        out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
        torch.cuda.synchronize()
        ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
        faults = [(label, mq.mq_decode_attention_plain(
            q, k, v, ids, **{"pos": pos, "window": window, **kw}))
            for label, kw in planted]
        err = check(name, out, ref, BF16_REL, faults)
        if not name.startswith(("verify", "prefill")):
            continue
        vis = mq_visible(ids, pos, Q, window)
        mask = vis.clone()
        ms = time_ms(lambda: mq.mq_decode_attention(q, k, v, ids, pos))
        plain = time_ms(lambda: mq.mq_decode_attention_plain(q, k, v, ids, pos),
                        reps=10)
        lib = library_time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True))
        n_read = int(vis.any(0).sum())                  # slots some row sees
        pairs = int(vis.sum())                          # visible (row, slot)
        byts = 2 * B * n_read * KV * dh * k.element_size() \
            + nbytes(q, ids) + nbytes(q)                # K, V rows; q, ids; out
        flops = 2 * 2 * B * H * pairs * dh              # QK^T and PV (tensor cores)
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                 bytes=byts, flops=flops,
                 bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
                 ops_bound_ms=flops / BF16_TENSOR_FLOPS * 1e3)
        # the verify shape is the per-round call of the served path: its
        # numbers go into the kernels line; the prefill round's into the log
        rows["mq_decode_attention" if name.startswith("verify")
             else "mq_decode_attention@prefill"] = r

    # q_len 1: the multi-query kernel is the one-token decode
    B, S_c, H, KV, dh, pos = 4, 1024, 64, 8, 128, 1023
    q = randn((B, 1, H, dh), bf16, gen)
    k = randn((B, S_c, KV, dh), bf16, gen)
    v = randn((B, S_c, KV, dh), bf16, gen)
    ids = linear_ids(S_c, pos)
    a = mq.mq_decode_attention(q, k, v, ids, pos)
    b = da.decode_attention(q, k, v, ids, pos)
    torch.cuda.synchronize()
    check("q_len 1 against the decode kernel", a, b, BF16_REL)


# ----------------------------------------------------------------------------
# phase 1: the paged kernels (3: paged decode, 5: paged multi-query)
# ----------------------------------------------------------------------------
PAGE, MAX_PAGES = 64, 16          # phase 2b's pool geometry: max_len 1024


def shuffled_tables(ctx, ps, max_pages, gen):
    """(block_tables (B, max_pages) int32 on the card, pool pages): each
    sequence's pages drawn from a shuffled pool (non-contiguous), -1 past
    the pages its ctx needs."""
    import torch
    need = [-(-c // ps) for c in ctx]
    P = sum(need) + 8
    perm = torch.randperm(P, generator=gen, device="cuda").cpu()
    bt = torch.full((len(ctx), max_pages), -1, dtype=torch.int32)
    i = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[i:i + n].to(torch.int32)
        i += n
    return bt.cuda(), P


def gathered(pool, bt, ctx):
    """Each sequence's pages laid out contiguously, and the pos_ids of one
    sequence at ctx (slot t holds position t below ctx)."""
    import torch
    from repro_torch.kernels.decode_attention import paged as pg
    S = bt.shape[1] * pool.shape[1]
    ar = torch.arange(S, device="cuda", dtype=torch.int32)
    return (pg.gather_pages(pool, bt).contiguous(),
            torch.where(ar < ctx, ar, torch.full_like(ar, -1)))


def paged_bitwise(name, q, k, v, bt, ctx, window, Q):
    """The paged kernel against the contiguous one (kernel 1 at q_len 1,
    kernel 4 otherwise) on the gathered cache, bit for bit: per sequence
    (B = 1 calls, so any ctx), and as one batch when ctx is uniform."""
    import torch
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg

    def both(qb, btb, ctxb):
        c = int(ctxb[0])
        kc, ids = gathered(k, btb, c)
        vc, _ = gathered(v, btb, c)
        if Q == 1:
            return (pg.paged_decode_attention(qb, k, v, btb, ctxb, window=window),
                    da.decode_attention(qb, kc, vc, ids, c - 1, window=window))
        return (mq.mq_paged_decode_attention(qb, k, v, btb, ctxb, window=window),
                mq.mq_decode_attention(qb, kc, vc, ids, c - Q, window=window))
    pairs = [both(q[b:b + 1], bt[b:b + 1], ctx[b:b + 1]) for b in range(q.shape[0])]
    if bool((ctx == ctx[0]).all()):
        pairs.append(both(q, bt, ctx))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in pairs)
    log(f"    bit-equal to kernel {1 if Q == 1 else 4} on the gathered cache "
        f"({len(pairs)} calls): {same}")
    if not same:
        raise AssertionError(f"{name}: the paged kernel differs from the "
                             "contiguous one on the gathered cache")


def paged_phase(gen, rows):
    """Kernels 3 and 5 against their plain versions at the main path's
    shapes (B 4, page 64, max_pages 16, H 64, KV 8, dh 128, ctx 1019; q_len
    128 and 5 for kernel 5) with shuffled non-contiguous tables, and at
    ragged-ctx, window and dh 80 / page 16 cases; planted faults in the
    plain version; bit-equality against kernels 1 and 4 on the gathered
    cache; device times at the main shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import paged as pg

    bf16 = torch.bfloat16
    main = (1019,) * 4
    ragged = (1019, 700, 300, 130)
    # name, q_len, H, KV, dh, ps, max_pages, ctx, window, planted faults
    # (label, changes to the plain version's arguments: "page" shifts every
    # allocated page id by +-1, "ctx" adds to every ctx, "window")
    cases = [
        ("paged decode main B4 ps64 P16 H64 KV8 dh128 ctx1019", 1, 64, 8, 128, PAGE,
         MAX_PAGES, main, None, [("page index + 1", dict(page=1)),
                                 ("page index - 1", dict(page=-1)),
                                 ("ctx - 1", dict(ctx=-1))]),
        ("paged decode ragged ctx", 1, 64, 8, 128, PAGE, MAX_PAGES, ragged, None,
         [("ctx - 1", dict(ctx=-1))]),
        ("paged decode window 700", 1, 64, 8, 128, PAGE, MAX_PAGES, main, 700,
         [("window - 1", dict(window=699))]),
        ("paged decode dh80 ps16", 1, 16, 2, 80, 16, 64, (1000, 517), 300,
         [("page index + 1", dict(page=1))]),
        ("mq paged prefill round q128 ctx1019", 128, 64, 8, 128, PAGE, MAX_PAGES, main,
         None, [("page index + 1", dict(page=1)), ("ctx - 1", dict(ctx=-1)),
                ("row // G off by one", dict(ctx=1))]),
        ("mq paged verify q5 ctx1019", 5, 64, 8, 128, PAGE, MAX_PAGES, main, None,
         [("page index - 1", dict(page=-1)), ("ctx - 1", dict(ctx=-1)),
          ("row // G off by one", dict(ctx=1))]),
        ("mq paged q128 ragged ctx", 128, 64, 8, 128, PAGE, MAX_PAGES, ragged, None,
         [("ctx - 1", dict(ctx=-1))]),
        ("mq paged q5 window 700", 5, 64, 8, 128, PAGE, MAX_PAGES, main, 700,
         [("window - 1", dict(window=699))]),
        ("mq paged q9 dh80 ps16", 9, 16, 2, 80, 16, 64, (1000, 517), 300,
         [("page index + 1", dict(page=1))]),
    ]
    for name, Q, H, KV, dh, ps, maxp, ctx_t, window, planted in cases:
        log(f"phase 1: {name}")
        bt, P = shuffled_tables(ctx_t, ps, maxp, gen)
        B = len(ctx_t)
        ctx = torch.tensor(ctx_t, dtype=torch.int32, device="cuda")
        q = randn((B, Q, H, dh), bf16, gen)
        k = randn((P, ps, KV, dh), bf16, gen)
        v = randn((P, ps, KV, dh), bf16, gen)
        kern = pg.paged_decode_attention if Q == 1 else mq.mq_paged_decode_attention
        plain = pg.paged_decode_attention_plain if Q == 1 \
            else mq.mq_paged_decode_attention_plain
        out = kern(q, k, v, bt, ctx, window=window)
        torch.cuda.synchronize()
        ref = plain(q, k, v, bt, ctx, window=window)
        faults = []
        for label, kw in planted:
            bad_bt = torch.where(bt >= 0, (bt + kw.get("page", 0)) % P, bt)
            faults.append((label, plain(q, k, v, bad_bt, ctx + kw.get("ctx", 0),
                                        window=kw.get("window", window))))
        err = check(name, out, ref, BF16_REL, faults)
        paged_bitwise(name, q, k, v, bt, ctx, window, Q)
        if not name.endswith("ctx1019"):
            continue
        # device times at the main shapes; the library yardstick is SDPA on
        # the gathered cache (the gather itself not counted)
        kc, _ = gathered(k, bt, ctx_t[0])
        vc, _ = gathered(v, bt, ctx_t[0])
        S = maxp * ps
        qpos = ctx[:, None] - Q + torch.arange(Q, device="cuda")[None, :]   # (B, Q)
        vis = torch.arange(S, device="cuda")[None, None, :] <= qpos[:, :, None]
        ms = time_ms(lambda: kern(q, k, v, bt, ctx))
        plain_ms = time_ms(lambda: plain(q, k, v, bt, ctx), reps=10)
        lib = library_time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=vis[:, None], enable_gqa=True))
        n_read = int(vis.any(1).sum())                  # (b, slot) some row sees
        pairs = int(vis.sum())                          # visible (b, qi, slot)
        byts = 2 * n_read * KV * dh * k.element_size() \
            + nbytes(q, bt, ctx) + nbytes(q)            # K, V rows; q, tables; out
        flops = 2 * 2 * pairs * H * dh
        key = "paged_decode_attention" if Q == 1 else (
            "mq_paged_decode_attention" if Q == 128 else "mq_paged_decode_attention@verify")
        rows[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
            bytes=byts, flops=flops, bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
            ops_bound_ms=flops / (FP32_SIMT_FLOPS if Q == 1 else BF16_TENSOR_FLOPS) * 1e3)
        log(f"    sdpa yardstick on the cache gathered beforehand (gather not "
            f"counted): {lib} ms")


# ----------------------------------------------------------------------------
# phase 2: the single-device path
# ----------------------------------------------------------------------------
def make_prompts(n, vocab, seed):
    import numpy as np
    return [np.random.default_rng(seed + i).integers(1, vocab, size=PROMPT_LEN)
            .astype(np.int32) for i in range(n)]


def serve(cfg, params, pattern, prompts, impl, max_new=MAX_NEW):
    from repro_torch.serving import LimeServer, cli_arrivals
    srv = LimeServer(cfg, params, max_len=MAX_LEN, pattern=pattern, impl=impl)
    arrivals = cli_arrivals(pattern, len(prompts), prompt_len=PROMPT_LEN,
                            max_new_tokens=max_new, burst_size=srv.slots)
    for ev, p in zip(arrivals, prompts):
        srv.queue.submit(p, ev.max_new_tokens, now=ev.time_s)
    done = srv.serve_all()
    return sorted(done, key=lambda r: r.rid)


def served_batches(pattern, n_req):
    """Request indices of each batch the server formed: the bursty burst
    rides one batch of 4 slots, sporadic serves one request at a time."""
    return [list(range(n_req))] if pattern == "bursty" else [[i] for i in range(n_req)]


def forced_logits(cfg, params, prompts, feed, width, impl):
    """Logits (T, n, vocab) fp32 of one served batch of n requests, built as
    EngineBackend builds it (prompts left-padded with token 0, the batch
    padded to `width` rows with replicas of the last prompt): prefill, then
    T - 1 decode steps fed the (n, T) tokens `feed`. Replica rows replay
    their first token, as the backend's inactive slots do."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.backend import EngineBackend
    toks = EngineBackend._pad_prompts(prompts)
    n, T = feed.shape
    toks = np.concatenate([toks, np.tile(toks[-1:], (width - n, 1))], 0)
    feed = np.concatenate([feed, np.full((width - n, T), feed[-1, 0])], 0)
    cache = M.init_cache(cfg, width, MAX_LEN)
    lg, cache = M.prefill(cfg, params, torch.from_numpy(toks).long().cuda(),
                          cache, impl=impl)
    out = [lg[:n, -1, :cfg.vocab_size].float()]
    for t in range(T - 1):
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.from_numpy(feed[:, t:t + 1]).long().cuda(),
                                  impl=impl)
        out.append(lg[:n, -1, :cfg.vocab_size].float())
    return torch.stack(out)


def compare_greedy(cfg, params, pattern, prompts, got, ref, width):
    """Every decoded position of every request. The reference serve's tokens
    are fed through both impls at the served batch shape. At each position:
    the reference's argmax is its served token (the forced run reproduces
    the serve); the kernel path's logits lie within LOGIT_REL_TOL of the
    largest |logit|; the kernel path's argmax is the reference's or a near
    tie (the reference logit of its pick within the measured logit error of
    the reference's top). The kernel serve's tokens up to its first
    divergence from the reference serve are the kernel path's argmaxes.
    Returns (positions compared, near-tie positions, worst error / |logit|)."""
    import numpy as np
    n_pos = n_tie = 0
    worst = 0.0
    for idx in served_batches(pattern, len(prompts)):
        for i in idx:
            assert len(got[i].output) == len(ref[i].output) == MAX_NEW, \
                (len(got[i].output), len(ref[i].output))
        feed = np.array([ref[i].output for i in idx], np.int64)
        ps = [prompts[i] for i in idx]
        lk = forced_logits(cfg, params, ps, feed, width, "kernel")
        lr = forced_logits(cfg, params, ps, feed, width, "ref")
        ak, ar = lk.argmax(-1), lr.argmax(-1)                 # (T, n)
        if not (ar.cpu().numpy().T == feed).all():
            raise AssertionError(f"{pattern}: the forced reference run does not "
                                 "reproduce the reference serve")
        err = (lk - lr).abs().amax(-1)                        # (T, n)
        scale = lr.abs().amax(-1)
        gap = (lr.gather(-1, ar[..., None]) - lr.gather(-1, ak[..., None]))[..., 0]
        far = err > LOGIT_REL_TOL * scale
        not_tie = (ak != ar) & (gap > err)
        worst = max(worst, (err / scale).max().item())
        for j, i in enumerate(idx):
            a, b = got[i].output, ref[i].output
            t_div = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), MAX_NEW)
            ties = [t for t in range(MAX_NEW) if ak[t, j] != ar[t, j]]
            log(f"  {pattern} req {ref[i].rid}: {MAX_NEW} positions, kernel argmax "
                f"differs at {ties or 'none'} (ref gap there "
                f"{[round(gap[t, j].item(), 4) for t in ties]}, logit err "
                f"{[round(err[t, j].item(), 4) for t in ties]}); max logit err "
                f"{err[:, j].max().item():.4f} at |logit| max {scale[:, j].max().item():.2f}; "
                f"served tokens agree up to {t_div}")
            if far[:, j].any() or not_tie[:, j].any():
                raise AssertionError(f"req {ref[i].rid}: kernel logits off the "
                                     "reference outside the near-tie rule")
            upto = min(t_div + 1, MAX_NEW)
            if a[:upto] != ak[:upto, j].tolist():
                raise AssertionError(f"req {ref[i].rid}: the kernel serve's tokens "
                                     "are not the kernel path's argmaxes")
            n_pos += MAX_NEW
            n_tie += len(ties)
    return n_pos, n_tie, worst


def main_path_phase(card):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import model as M
    from repro_torch.serving import LimeServer, summarize

    cfg = dataclasses.replace(get_config("llama3.3-70b"), n_layers=N_LAYERS)
    log(f"phase 2: single-device path, {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), depth cut to {cfg.n_layers} of 80 layers")
    t0 = time.monotonic()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"  params: {n_par / 1e9:.2f} B in {time.monotonic() - t0:.1f} s")

    # warm-up at both batch widths (cuBLAS handles and heuristics, the
    # allocator): not part of the measured runs
    serve(cfg, params, "bursty", make_prompts(4, cfg.vocab_size, 99), "kernel",
          max_new=2)
    serve(cfg, params, "sporadic", make_prompts(1, cfg.vocab_size, 99), "kernel",
          max_new=2)
    torch.cuda.synchronize()

    launches = {"flash_attention": 0, "decode_attention": 0}
    outs = {}
    torch.cuda.reset_peak_memory_stats()
    for pattern, n_req in (("bursty", 4), ("sporadic", 2)):
        prompts = make_prompts(n_req, cfg.vocab_size, 0)
        n_batches = 1 if pattern == "bursty" else n_req
        fa.launches = 0
        da.launches = 0
        done = serve(cfg, params, pattern, prompts, "kernel")
        torch.cuda.synchronize()
        got = {"flash_attention": fa.launches, "decode_attention": da.launches}
        want = {"flash_attention": cfg.n_layers * n_batches,
                "decode_attention": cfg.n_layers * (MAX_NEW - 1) * n_batches}
        log(f"  {pattern}: launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{pattern}: kernel launch counts {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        rep = summarize(done, pattern=pattern, backend="single-device")
        log(f"  {pattern}: {rep.n_requests} requests x {MAX_NEW} tokens, prompt "
            f"{PROMPT_LEN}: TTFT p50 {rep.ttft_p50_s * 1e3:.2f} ms, p99 "
            f"{rep.ttft_p99_s * 1e3:.2f} ms, decode {rep.decode_tok_s_p50:.2f} tok/s "
            f"per request (p50) = {1e3 / rep.decode_tok_s_p50:.3f} ms/token, "
            f"span ms/token {rep.ms_per_token:.3f} [{card}; {cfg.n_layers} of 80 layers]")
        outs[pattern] = (prompts, done)
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 2**30:.2f} GiB [{card}]")
    breakdown(cfg, params, card)

    log("phase 2: re-serve on the reference math (impl='ref'), then both impls "
        "fed the reference's tokens at the served batch shape")
    for pattern, (prompts, done) in outs.items():
        ref = serve(cfg, params, pattern, prompts, "ref")
        width = LimeServer(cfg, params, pattern=pattern).slots
        n_pos, n_tie, worst = compare_greedy(cfg, params, pattern, prompts, done,
                                             ref, width)
        n_same = sum(a.output == b.output for a, b in zip(done, ref))
        log(f"  {pattern}: {n_same}/{len(done)} requests token-identical; "
            f"{n_pos} positions compared, {n_tie} near ties, worst logit err "
            f"{worst:.4f} of |logit| max (tol {LOGIT_REL_TOL})")
    return launches, cfg, params


def breakdown(cfg, params, card):
    """Device time by kernel class over one bursty serve (torch.profiler,
    kernels' own time), and the device's idle share of the serve's wall
    time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompts = make_prompts(4, cfg.vocab_size, 7)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        serve(cfg, params, "bursty", prompts, "kernel")
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by = {"decode_attention": 0.0, "flash_attention": 0.0, "gemm": 0.0,
          "other": 0.0}
    seen = {"decode_attention": {}, "flash_attention": {}}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        # every kernel of csrc/ lives in namespace repro and is named after
        # its file: decode_*kernel in decode_attention.cu, flash_*kernel in
        # flash_attention.cu (both show in mangled and demangled names)
        m = re.search(r"(decode|flash)_[a-z0-9_]*?kernel", name) \
            if "repro" in name else None
        if m is not None:
            cls = m.group(1) + "_attention"
            seen[cls][m.group(0)] = seen[cls].get(m.group(0), 0) + e.count
        elif any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "other"
        by[cls] += us
    busy = sum(by.values())
    n_dec, n_fl = cfg.n_layers * (MAX_NEW - 1), cfg.n_layers
    log(f"  profiled kernels of csrc/ (name: launches): {seen}")
    for cls in seen:
        if by[cls] <= 0:
            raise AssertionError(f"breakdown: the profiler shows no device time "
                                 f"for {cls}, whose kernels ran")
    log(f"  in the serve: decode_attention {by['decode_attention'] / n_dec:.2f} us "
        f"per call ({n_dec} calls), flash_attention "
        f"{by['flash_attention'] / n_fl:.2f} us per call ({n_fl} calls)")
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by.items())
    log(f"  bursty serve device time by class: {parts}; busy {busy / 1e3:.2f} ms of "
        f"{wall_us / 1e3:.2f} ms wall, idle share {1 - busy / wall_us:.1%} "
        f"[{card}; {cfg.n_layers} of 80 layers]")


# ----------------------------------------------------------------------------
# phase 2b: paged KV and the radix prefix cache, 8 layers
# ----------------------------------------------------------------------------
PREFIX_PROMPT, PREFIX_LEN, PREFIX_NEW, PREFIX_CHUNK = 512, 384, 16, 128
UNEQUAL_LENS = (512, 480, 400, 300)


def prefix_requests(cfg):
    """Two epochs of 4 shared-prefix requests (one template: 384 of 512
    prompt tokens, 16 new tokens each), all arriving at t = 0 so each epoch
    fills the 4 slots, then one epoch of unequal prompt lengths."""
    import numpy as np
    from repro_torch.serving import (Request, make_arrivals,
                                     requests_from_arrivals)
    arr = make_arrivals("shared_prefix", 8, n_templates=1, prefix_len=PREFIX_LEN,
                        prompt_len=PREFIX_PROMPT, max_new_tokens=PREFIX_NEW,
                        seed=0)
    arr = [dataclasses.replace(a, time_s=0.0) for a in arr]
    reqs = requests_from_arrivals(arr, vocab_size=cfg.vocab_size, seed=0)
    rng = np.random.default_rng(11)
    reqs += [Request(8 + i, rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                     PREFIX_NEW) for i, n in enumerate(UNEQUAL_LENS)]
    return reqs


def prefix_server(cfg, params):
    from repro_torch.serving import LimeServer
    return LimeServer(cfg, params, max_len=MAX_LEN, pattern="bursty",
                      prefix_cache=True, prefill_chunk_tokens=PREFIX_CHUNK,
                      page_size=PAGE)


def kernel_counters():
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg
    from repro_torch.kernels.flash_attention import ops as fa
    return {"decode_attention": (da, "launches"), "flash_attention": (fa, "launches"),
            "mq_decode_attention": (mq, "launches"),
            "paged_decode_attention": (pg, "launches"),
            "mq_paged_decode_attention": (mq, "paged_launches")}


def read_counts():
    return {k: getattr(m, a) for k, (m, a) in kernel_counters().items()}


def zero_counts():
    for m, a in kernel_counters().values():
        setattr(m, a, 0)


def drive_prefix(srv, reqs, n_layers):
    """Serve reqs one scheduler step at a time. Each step launches exactly
    what it implies: an equal-length epoch's prefill n_layers paged
    multi-query kernels per 128-position round (the uncached suffix only),
    an unequal one n_layers flash kernels (dense prefill, scattered into
    pages), a decode step n_layers paged decode kernels, and nothing of the
    contiguous kernels. The device block table is uploaded only when a
    table changed. Returns (requests, stats, per-epoch records)."""
    import torch
    from repro_torch.serving import ContinuousBatchingScheduler, SchedulerConfig
    be = srv.make_backend()
    sched = ContinuousBatchingScheduler(be, SchedulerConfig())
    sched.begin(reqs)
    epochs = []
    while True:
        n_rounds = len(be.rounds)
        c0 = read_counts()
        up0 = be._paged_cache.bt_uploads if be._paged_cache is not None else 0
        saved0 = be._saved_tokens
        if not sched.step():
            break
        torch.cuda.synchronize()
        got = {k: v - c0[k] for k, v in read_counts().items()}
        want = dict.fromkeys(got, 0)
        pc = be._paged_cache
        if len(be.rounds) > n_rounds:                  # a decode step
            want["paged_decode_attention"] = n_layers
            ep = epochs[-1]
            ep["decode_steps"] += 1
            ep["uploads"] += pc.bt_uploads - up0
            if pc.pos - 1 > ep["pos0"] and (pc.pos - 1) % PAGE == 0:
                ep["crossings"] += 1                   # a new page
        else:                                          # an epoch's prefill
            seen = {r.rid for e in epochs for r in e["reqs"]}
            batch = [r for r in reqs
                     if r.admitted_s is not None and r.rid not in seen]
            equal = len({r.prompt_len for r in batch}) == 1
            saved = be._saved_tokens - saved0
            rounds = math.ceil((pc.pos - saved // len(batch)) / PREFIX_CHUNK) \
                if equal else 0
            if equal:
                want["mq_paged_decode_attention"] = n_layers * rounds
            else:
                want["flash_attention"] = n_layers
            epochs.append(dict(reqs=batch, equal=equal, rounds=rounds, saved=saved,
                               decode_steps=0, uploads=pc.bt_uploads - up0,
                               pos0=pc.pos, crossings=0))
        if got != want:
            raise AssertionError(f"prefix serve step: launches {got}, expected {want}")
    done = sched.finish_run()
    for ep in epochs:
        # one upload per prefill round (each round grows every table), one
        # for an unequal epoch's first step (seed rebuilt the tables), one
        # per page boundary a decode step crosses after that
        want = (ep["rounds"] if ep["equal"] else 1) + ep["crossings"] \
            + (1 if ep["equal"] and ep["pos0"] % PAGE == 0 else 0)
        if ep["uploads"] != want:
            raise AssertionError(f"block-table uploads {ep['uploads']}, expected {want}")
    return done, sched.stats, epochs


def prefix_forced_logits(cfg, params, donor_prompts, prompts, feed):
    """Logits (T, 4, V) of `prompts` fed `feed` (4, T) through two paged
    caches, built as the backend builds them: cold (the whole prompt in
    128-position rounds) and warm (the template's pages computed for row 0
    of a donor batch, forked into every row, then the 128-token suffix)."""
    import numpy as np
    import torch
    from repro_torch.kvcache.allocator import BlockTable
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    from repro_torch.kvcache.pool import PagedKVConfig, PagePool
    V = cfg.vocab_size
    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    cold = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, impl="kernel")
    pool = PagePool(PagedKVConfig(page_size=PAGE, device_pages=8 * MAX_PAGES))
    donor = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, pool=pool, impl="kernel")
    donor.prefill(params, torch.from_numpy(np.stack(donor_prompts)).long().cuda(),
                  chunk=PREFIX_CHUNK)
    warm = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, pool=pool, impl="kernel")
    del warm.k_pool, warm.v_pool
    warm.k_pool, warm.v_pool = donor.k_pool, donor.v_pool   # one pool, as served
    shared = donor.tables[0].pages[:PREFIX_LEN // PAGE]
    tables = []
    for _ in range(4):
        for pid in shared:
            pool.incref_page(pid)
        tables.append(BlockTable(PAGE, list(shared), PREFIX_LEN))
    warm.adopt_tables(tables, PREFIX_LEN)
    lc = [cold.prefill(params, toks, chunk=PREFIX_CHUNK)[:, :V].float()]
    lw = [warm.prefill(params, toks[:, PREFIX_LEN:], chunk=PREFIX_CHUNK)[:, :V].float()]
    feed = torch.from_numpy(np.asarray(feed)).long().cuda()
    for t in range(feed.shape[1] - 1):
        lc.append(cold.step(params, feed[:, t:t + 1])[:, 0, :V].float())
        lw.append(warm.step(params, feed[:, t:t + 1])[:, 0, :V].float())
    return torch.stack(lc), torch.stack(lw)


def seeded_bitwise(cfg, params, prompts, card, steps=8):
    """Decode on a paged cache seeded from the dense (flash) prefill, its
    tables non-contiguous, against the contiguous decode_step through
    kernel 1 on the same cache: bit-equal logits at every step (max_len is
    a multiple of the page size, so both walk the same 1024 slots in the
    same splits and tiles); then one 5-position verify (kernel 5 against
    kernel 4), bit-equal too."""
    import numpy as np
    import torch
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    from repro_torch.kvcache.pool import PagedKVConfig, PagePool
    from repro_torch.models import model as M
    V = cfg.vocab_size
    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    cache = M.init_cache(cfg, 4, MAX_LEN)
    lg, cache = M.prefill(cfg, params, toks, cache, impl="kernel")
    pool = PagePool(PagedKVConfig(page_size=PAGE, device_pages=4 * MAX_PAGES + 16))
    churn = pool.alloc_pages(40)
    for pid in np.random.default_rng(5).permutation(churn):
        pool.decref_page(int(pid))                    # LIFO: shuffled reuse
    pc = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, pool=pool, impl="kernel")
    pc.seed(cache)
    contiguous = all(np.all(np.diff(t.pages) == 1) for t in pc.tables)
    tok = lg[:, -1, :V].argmax(-1, keepdim=True)
    same = []
    for _ in range(steps):
        lm, cache = M.decode_step(cfg, params, cache, tok, impl="kernel")
        lp = pc.step(params, tok)
        same.append(torch.equal(lm, lp))
        tok = lm[:, -1, :V].argmax(-1, keepdim=True)
    mat = torch.cat([tok, toks[:, :SPEC_K]], 1)
    lv, cache = M.verify_step(cfg, params, cache, mat, impl="kernel")
    same_v = torch.equal(lv, pc.verify(params, mat))
    log(f"  seeded paged decode (tables non-contiguous: {not contiguous}) vs "
        f"contiguous decode_step through kernel 1: bit-equal at "
        f"{sum(same)}/{steps} steps; 5-position verify (kernel 5 vs kernel 4) "
        f"bit-equal {same_v} [{card}; {cfg.n_layers} layers]")
    if contiguous or not all(same) or not same_v:
        raise AssertionError("paged decode on a seeded cache is not the "
                             "contiguous decode bit for bit")
    pc.release()


def prefix_profile(cfg, params, reqs, card):
    """Device time by class over one cold shared-prefix epoch on a fresh
    server (4 prefill rounds, 15 decode steps), and the device's idle
    share: the paged kernels' µs per call in the serve."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    srv = prefix_server(cfg, params)
    for r in reqs:
        srv.queue.submit(r.prompt, r.max_new_tokens)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        srv.serve_all()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    by = {"paged_decode": 0.0, "mq_paged": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        # only the paged kernels of csrc/ run in this serve: decode_* is
        # kernel 3 (and its combine pass), mq_* kernel 5
        m = re.search(r"(decode|mq)_[a-z0-9_]*?kernel", name) if "repro" in name else None
        if m is not None:
            cls = "paged_decode" if m.group(1) == "decode" else "mq_paged"
        elif any(x in name for x in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "other"
        by[cls] += us
    for cls in ("paged_decode", "mq_paged"):
        if by[cls] <= 0:
            raise AssertionError(f"prefix profile: no device time for {cls}")
    busy = sum(by.values())
    n_dec = cfg.n_layers * (PREFIX_NEW - 1)
    n_mq = cfg.n_layers * PREFIX_PROMPT // PREFIX_CHUNK
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by.items())
    log(f"  profiled cold epoch: paged decode {by['paged_decode'] / n_dec:.2f} us per "
        f"call ({n_dec} calls), paged mq {by['mq_paged'] / n_mq:.2f} us per call "
        f"({n_mq} calls); device time {parts}; busy {busy / 1e3:.2f} ms of "
        f"{wall_us / 1e3:.2f} ms wall, idle share {1 - busy / wall_us:.1%} [{card}]")
    return {"paged_decode_attention": by["paged_decode"] / n_dec,
            "mq_paged_decode_attention": by["mq_paged"] / n_mq}


def prefix_phase(cfg, params, card):
    """The paged KV path with the radix prefix cache through LimeServer ->
    ContinuousBatchingScheduler -> EngineBackend on phase 2's 8 layers:
    two shared-prefix epochs (cold, then warm: each request matches the
    template's 6 pages, 384 tokens) and one unequal-length epoch."""
    import numpy as np
    import torch
    from repro_torch.serving import summarize
    log(f"phase 2b: paged KV + radix prefix cache, {cfg.name} full width, "
        f"{cfg.n_layers} layers: page {PAGE}, prefill rounds of {PREFIX_CHUNK}, "
        f"prompt {PREFIX_PROMPT} (template {PREFIX_LEN}), {PREFIX_NEW} new tokens")
    # warm-up (allocator, cuBLAS heuristics at these shapes), not measured
    warm_srv = prefix_server(cfg, params)
    for r in prefix_requests(cfg)[:4]:
        warm_srv.queue.submit(r.prompt, 2)
    warm_srv.serve_all()
    del warm_srv
    torch.cuda.synchronize()

    reqs = prefix_requests(cfg)
    srv = prefix_server(cfg, params)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    done, stats, epochs = drive_prefix(srv, reqs, cfg.n_layers)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    be = srv.make_backend()
    pc = be._paged_cache
    st = be.prefix_stats
    want_saved = 4 * PREFIX_LEN
    for i, ep in enumerate(epochs):
        pre = [r.first_token_s - r.admitted_s for r in ep["reqs"]]
        ttft = [r.ttft_s for r in ep["reqs"]]
        log(f"  epoch {i + 1} ({'equal' if ep['equal'] else 'unequal'} lengths): "
            f"{len(ep['reqs'])} requests, {ep['saved']} prompt tokens from the "
            f"cache, {ep['rounds']} prefill rounds; TTFT p50 "
            f"{statistics.median(ttft) * 1e3:.1f} ms (all arrived at 0), of it "
            f"prefill {statistics.median(pre) * 1e3:.1f} ms; {ep['decode_steps']} "
            f"decode steps; {ep['uploads']} block-table uploads [{card}]")
    log(f"  launches {launches}; prefix_stats {st}")
    log(f"  pool: {pc.pool.alloc.n_pages} pages of {PAGE} slots, {pc.pool_bytes / 1e9:.3f} "
        f"GB of K/V ({cfg.n_layers} layers), {pc.pool.alloc.used_pages} pages in use at "
        f"the end ({st['prefix_pages']} held by the radix tree); peak HBM "
        f"{peak / 1e9:.2f} GB [{card}]")
    if [ep["equal"] for ep in epochs] != [True, True, False] \
            or [ep["saved"] for ep in epochs] != [0, want_saved, 0]:
        raise AssertionError(f"epochs {[(e['equal'], e['saved']) for e in epochs]}")
    if st["prefill_tokens_saved"] != want_saved or st["prefix_hits"] != 4:
        raise AssertionError(f"prefix stats {st}: expected 4 hits saving {want_saved}")
    rep = summarize(done, pattern="shared_prefix", backend="paged-prefix", stats=stats)
    if rep.prefill_tokens_saved != want_saved:
        raise AssertionError("the report misses the saved prefill tokens")
    cold_ttft = statistics.median(r.first_token_s - r.admitted_s for r in epochs[0]["reqs"])
    warm_ttft = statistics.median(r.first_token_s - r.admitted_s for r in epochs[1]["reqs"])
    log(f"  prefill of an epoch: cold {cold_ttft * 1e3:.1f} ms, warm {warm_ttft * 1e3:.1f} "
        f"ms ({cold_ttft / warm_ttft:.2f}x); report prefix_hit_rate "
        f"{rep.prefix_hit_rate:.3f}, prefill_tokens_saved {rep.prefill_tokens_saved} [{card}]")

    # warm against cold: the epoch-2 prompts on a fresh cache
    by_rid = {r.rid: r for r in done}
    warm_reqs = [by_rid[i] for i in range(4, 8)]
    cold_srv = prefix_server(cfg, params)
    for r in warm_reqs:
        cold_srv.queue.submit(r.prompt, r.max_new_tokens)
    cold = sorted(cold_srv.serve_all(), key=lambda r: r.rid)
    feed = np.array([r.output for r in cold])
    lc, lw = prefix_forced_logits(cfg, params, [by_rid[i].prompt for i in range(4)],
                                  [r.prompt for r in warm_reqs], feed)
    if not (lc.argmax(-1).T.cpu().numpy() == feed).all():
        raise AssertionError("the forced cold run does not reproduce the cold serve")
    err = (lw - lc).abs().amax(-1)                        # (T, 4)
    n_same = 0
    for j, r in enumerate(warm_reqs):
        a, b = r.output, cold[j].output
        if a == b:
            n_same += 1
            continue
        t = next(t for t in range(len(a)) if a[t] != b[t])
        gap = (lc[t, j, b[t]] - lc[t, j, a[t]]).item()
        log(f"  warm req {r.rid}: diverges from cold at {t}: gap {gap:.4f}, err "
            f"{err[t, j].item():.4f}")
        if gap > err[t, j].item():
            raise AssertionError(f"warm req {r.rid} diverges outside a near tie")
    log(f"  warm vs cold: {n_same}/4 requests token-identical; max |warm - cold| "
        f"logit {err.max().item():.4g} over {feed.shape[1]} positions [{card}]")
    seeded_bitwise(cfg, params, [by_rid[i].prompt for i in range(4)], card)
    us = prefix_profile(cfg, params, reqs[:4], card)
    return launches, us

# ----------------------------------------------------------------------------
# phase 3a: the engine against the model, 8 layers
# ----------------------------------------------------------------------------
def argmax_or_tie(name, got, ref, err):
    """got, ref: (n, V) fp32 logits of the same positions by two paths.
    Each row's pick under `got` must be the pick under `ref` or a near tie
    of it (ref's gap between the two picks within the rows' logit error
    err). Returns the number of near ties."""
    ag, ar = got.argmax(-1), ref.argmax(-1)
    gap = (ref.gather(-1, ar[:, None]) - ref.gather(-1, ag[:, None]))[:, 0]
    bad = (ag != ar) & (gap > err)
    if bad.any():
        raise AssertionError(f"{name}: greedy picks differ outside a near "
                             f"tie (gaps {gap[bad].tolist()}, err {err})")
    return int((ag != ar).sum())


def engine_check_phase(cfg, params, card):
    """Phase 2's weights in a plan forced to stream: the engine's decode
    and verify run models.model.decode_layer on the same inputs as the
    model's kernel path, so their logits must be bit-equal; its chunked
    prefill (multi-query rounds) against the model's flash prefill stays
    within LOGIT_REL_TOL, greedy equal outside near ties."""
    import numpy as np
    import torch

    from repro_torch.core.engine import InterleavedEngine, UniformPlan
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.models import model as M

    V = cfg.vocab_size
    plan = UniformPlan(1, 2, 2, 2)
    eng = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN,
                            retier_headroom=1)
    st = eng.init_state(params)
    log(f"phase 3a: engine vs model, {cfg.n_layers} layers, plan n_seg "
        f"{plan.n_seg} k_res {plan.k_res} k_off {plan.k_off} headroom 1: "
        f"resident {eng.resident_layer_ids()}, pinned store "
        f"{eng.store.nbytes / 1e9:.2f} GB (registered {eng.store.registered})")
    toks = torch.from_numpy(np.stack(make_prompts(4, V, 21))).long().cuda()
    mc = M.init_cache(cfg, 4, MAX_LEN)
    ml, mc = M.prefill(cfg, params, toks, mc, impl="kernel")
    m0 = mq.launches
    el, st = eng.prefill_partial(st, toks, chunk=PREFILL_CHUNK)
    torch.cuda.synchronize()
    if mq.launches - m0 != cfg.n_layers:
        raise AssertionError("engine prefill: one mq launch per layer expected")
    a, b = el[:, -1, :V].float(), ml[:, -1, :V].float()
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    ties = argmax_or_tie("engine prefill vs flash prefill", a, b, err)
    log(f"  prefill_partial (mq rounds) vs M.prefill (flash): max logit err "
        f"{err:.4f} at |logit| max {scale:.2f} (tol {LOGIT_REL_TOL} of it), "
        f"{ties} near ties of 4 picks")
    if err > LOGIT_REL_TOL * scale:
        raise AssertionError("engine prefill logits off the model's")
    # the same cache on both sides from here on
    mc = {"pos": st["pos"], "pos_ids": st["pos_ids"].clone(),
          "k": st["k"].clone(), "v": st["v"].clone()}
    tok = a.argmax(-1, keepdim=True)
    steps = []
    for i in range(4):
        if i == 1:
            eng.retier(st, 0, +1)
        if i == 3:
            eng.retier(st, 0, -1)
        el, st = eng.decode_step(st, tok)
        ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel")
        steps.append(("decode" + (" after retier(+1)" if i in (1, 2) else ""),
                      el, ml[:, 0]))
        tok = el[:, :V].argmax(-1, keepdim=True)
    mat = torch.cat([tok, toks[:, 1:5]], 1)
    el, st = eng.verify_step(st, mat)
    ml, mc = M.verify_step(cfg, params, mc, mat, impl="kernel")
    steps.append(("verify q_len 5", el, ml))
    for name, e, m in steps:
        same = torch.equal(e, m)
        log(f"  {name}: engine logits {'bit-equal to' if same else 'DIFFER from'} "
            f"the model's (max |diff| {(e.float() - m.float()).abs().max().item():.3g})")
        if not same:
            raise AssertionError(f"engine {name} differs from the model")
    for key in ("k", "v", "pos_ids"):
        if not torch.equal(st[key], mc[key]):
            raise AssertionError(f"engine cache {key} differs from the model's")
    # the same positions by the two paths a spec serve mixes: decode steps
    # (decode kernel, M = 4 GEMMs) and one verify pass (mq kernel)
    P = st["pos"]
    seq = [tok]
    ld = []
    for _ in range(8):
        el, st = eng.decode_step(st, seq[-1])
        ld.append(el[:, :V].float())
        seq.append(el[:, :V].argmax(-1, keepdim=True))
    eng.rollback(st, P)
    lv, st = eng.verify_step(st, torch.cat(seq[:8], 1))
    d = (torch.stack(ld, 1) - lv[..., :V].float()).abs().amax(-1)
    rel = d / torch.stack(ld, 1).abs().amax(-1)
    log(f"  decode steps vs one verify pass over the same 8 positions: logit "
        f"err / |logit| max by position {[round(x, 4) for x in rel.max(0).values.tolist()]} "
        f"[{card}; {cfg.n_layers} layers]")
    eng.close()


# ----------------------------------------------------------------------------
# phase 3b: the main path, 80 layers through the engine
# ----------------------------------------------------------------------------
def meminfo():
    out = {}
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024
    return out


def h2d_rate(store, reps=6):
    """GB/s of one-layer copies from the pinned store into HBM on a side
    stream (what the engine's streamer issues)."""
    import torch
    buf = torch.empty_like(store[0], device="cuda")
    side = torch.cuda.Stream()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        buf.copy_(store[0], non_blocking=True)
        a.record(side)
        for i in range(reps):
            buf.copy_(store[i % store.shape[0]], non_blocking=True)
        b.record(side)
    b.synchronize()
    return reps * nbytes(buf) / (a.elapsed_time(b) * 1e-3) / 1e9


def drive(srv, prompts, pattern, n_layers, retier_at=()):
    """Serve `prompts` under `pattern` through srv's scheduler one step at
    a time: each step's mq and decode launches must be what the step
    implies (a prefill round: n_layers mq; a speculative round of k drafts:
    k x live resident layers decode + n_layers mq; a plain step: n_layers
    decode), and retier_at's (round, delta) moves apply between rounds
    while requests are live. Returns (finished requests, stats, launches,
    retiers applied as (round, delta, live))."""
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.serving import (ContinuousBatchingScheduler, Request,
                                     SchedulerConfig, cli_arrivals)
    be = srv.make_backend()
    eng = srv.engine
    arrivals = cli_arrivals(pattern, len(prompts), prompt_len=PROMPT_LEN,
                            max_new_tokens=MAX_NEW_80, burst_size=srv.slots)
    base = be.now()
    reqs = [Request(i, p, ev.max_new_tokens, arrival_s=base + ev.time_s)
            for i, (ev, p) in enumerate(zip(arrivals, prompts))]
    sched = ContinuousBatchingScheduler(be, SchedulerConfig())
    sched.begin(reqs)
    n_pf = math.ceil(PROMPT_LEN / PREFILL_CHUNK)
    prefills, applied = 0, []
    mq.launches = da.launches = 0
    while True:
        n_rounds, res = len(be.rounds), len(eng.resident_layer_ids())
        m0, d0 = mq.launches, da.launches
        if not sched.step():
            break
        got = (mq.launches - m0, da.launches - d0)
        if len(be.rounds) > n_rounds:
            k = be.rounds[-1][0]
            want = (n_layers, k * res) if k else (0, n_layers)
        else:                            # a prefill or an idle jump
            want = got if got in ((0, 0), (n_pf * n_layers, 0)) else None
            prefills += got[0] > 0
        if got != want:
            raise AssertionError(f"{pattern} round {len(be.rounds)}: launches "
                                 f"(mq, decode) {got}, expected {want}")
        live = any(not r.done for r in reqs)
        for at, delta in retier_at:
            if len(be.rounds) == at and (at, delta) not in [x[:2] for x in applied]:
                be.retier(0, delta)
                applied.append((at, delta, live))
    done = sorted(sched.finish_run(), key=lambda r: r.rid)
    if prefills != (1 if pattern == "bursty" else len(prompts)):
        raise AssertionError(f"{pattern}: {prefills} prefill steps")
    return done, sched.stats, (mq.launches, da.launches), applied


def reference_check(eng, params, cfg, prompts, got, pattern):
    """Every served position of each served batch (built as the backend
    builds it: left-pad 0, replica rows inactive) against two greedy
    references on the same engine, without spec and without retier:

    * the plain greedy decode (decode steps, the decode kernel). One verify
      pass over its continuation gives the multi-query path's logits at
      every position and so the two paths' logit error; up to the first
      divergence the served tokens must be this reference's, and a
      divergence must be a near tie (the decode path's gap between the two
      picks within that position's error).
    * the greedy decode through verify passes of the serve's width (k + 1
      positions, the drafts a dummy token), committing column 0 and
      rolling back: each committed token then goes through the arithmetic
      the spec serve used for it (a row's result depends on no other row
      of the pass), so every served token must equal this one exactly.

    Returns (positions, near ties, worst err / |logit|)."""
    import numpy as np
    import torch

    from repro_torch.serving.backend import EngineBackend
    V = cfg.vocab_size
    T = MAX_NEW_80
    batches = [list(range(len(prompts)))] if pattern == "bursty" \
        else [[i] for i in range(len(prompts))]
    n_pos = n_tie = 0
    worst = 0.0
    for idx in batches:
        n = len(idx)
        toks = EngineBackend._pad_prompts([prompts[i] for i in idx])
        toks = np.concatenate([toks, np.tile(toks[-1:], (eng.mb - n, 1))], 0)
        active = torch.zeros(eng.mb, dtype=torch.bool, device="cuda")
        active[:n] = True
        st = eng.init_state(params)
        lg, st = eng.prefill_partial(st, torch.from_numpy(toks).long().cuda(),
                                     chunk=PREFILL_CHUNK)
        P = st["pos"]
        ld = [lg[:, -1, :V].float()]
        cur = ld[0].argmax(-1, keepdim=True)
        first = cur
        for _ in range(T - 1):
            lg, st = eng.decode_requests(st, cur, active)
            ld.append(lg[:, :V].float())
            cur = torch.where(active[:, None], ld[-1].argmax(-1, keepdim=True), cur)
        ld = torch.stack(ld, 1)                            # (mb, T, V)
        ref = ld.argmax(-1)                                # (mb, T)
        eng.rollback(st, P)
        lv, st = eng.verify_requests(st, ref, active)
        lv = torch.cat([ld[:, :1], lv[:, :T - 1, :V].float()], 1)
        err = (ld - lv).abs().amax(-1)                     # (mb, T)
        rel = err[:n] / ld[:n].abs().amax(-1)
        top2 = ld[:n].topk(2, -1).values
        clear = int(((top2[..., 0] - top2[..., 1]) > err[:n]).sum())
        log(f"  {pattern}: verify pass vs decode path over the reference "
            f"continuation: logit err / |logit| max median "
            f"{rel.median().item():.4f}, max {rel.max().item():.4f}; {clear} of "
            f"{n * T} positions have a decode-path top-2 margin above their err")
        worst = max(worst, rel.max().item())
        # the greedy decode through (k + 1)-wide verify passes
        eng.rollback(st, P)
        cur, vref = first, [first]
        for t in range(T - 1):
            mat = cur.repeat(1, 1 + SPEC_K)
            lg, st = eng.verify_requests(st, mat, active)
            eng.rollback(st, P + t + 1)
            cur = torch.where(active[:, None],
                              lg[:, 0, :V].argmax(-1, keepdim=True), cur)
            vref.append(cur)
        vref = torch.cat(vref, 1)                          # (mb, T)
        for j, i in enumerate(idx):
            a, b = got[i].output, ref[j].tolist()
            if a != vref[j].tolist():
                t = next(t for t in range(T) if a[t] != vref[j, t].item())
                raise AssertionError(f"{pattern} req {i}: served token {t} is not "
                                     "the (k+1)-wide verify-pass greedy's")
            t_div = next((t for t in range(T) if a[t] != b[t]), T)
            msg = "identical to the decode-path greedy"
            if t_div < T:
                row = ld[j, t_div]
                gap = (row[b[t_div]] - row[a[t_div]]).item()
                if gap > err[j, t_div].item():
                    raise AssertionError(f"{pattern} req {i}: served token {t_div} "
                                         f"diverges from the decode-path greedy "
                                         f"outside a near tie (gap {gap:.4f}, err "
                                         f"{err[j, t_div]:.4f})")
                n_tie += 1
                msg = (f"decode-path greedy up to a near tie at {t_div} (gap "
                       f"{gap:.4f} <= err {err[j, t_div]:.4f})")
            log(f"  {pattern} req {i}: {T} positions equal the verify-pass "
                f"greedy; {msg}")
            n_pos += T
    return n_pos, n_tie, worst


def timed_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def pass_profile(eng, st, P, fn, card, label):
    """Device time by class over one engine pass under torch.profiler:
    GEMMs, the port's attention kernels, H2D copies (the copy engine,
    concurrent with compute), other kernels; and the compute stream's idle
    share of the pass's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    by = {"gemm": 0.0, "attention": 0.0, "memcpy_h2d": 0.0, "other": 0.0}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed_s(fn)
    eng.rollback(st, P)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        if "memcpy" in name and "htod" in name:
            cls = "memcpy_h2d"
        elif "repro" in name and re.search(r"(decode|mq|flash)_[a-z0-9_]*?kernel", name):
            cls = "attention"
        elif any(x in name for x in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "other"
        by[cls] += us
    compute = by["gemm"] + by["attention"] + by["other"]
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in by.items())
    log(f"  profile of one {label} pass: {parts}; compute busy "
        f"{compute / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall, compute idle "
        f"{1 - compute / (wall * 1e6):.1%} [{card}]")
    return by, wall


def full_model_phase(card):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import (InterleavedEngine, plan_for,
                                         weight_budget)
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.launch.serve import HBM_FRAC
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.models import model as M
    from repro_torch.serving import LimeServer, summarize
    from repro_torch.specdec import SpecConfig

    t_phase = time.monotonic()
    base = get_config("llama3.3-70b")
    free, total = torch.cuda.mem_get_info()
    mem = meminfo()
    log(f"phase 3b: free HBM {free / 1e9:.2f} of {total / 1e9:.2f} GB; host "
        f"MemTotal {mem['MemTotal'] / 1e9:.2f} GB, MemAvailable "
        f"{mem['MemAvailable'] / 1e9:.2f} GB [{card}]")
    for depth in range(base.n_layers, MIN_LAYERS - 1, -1):
        cfg = dataclasses.replace(base, n_layers=depth)
        budget = weight_budget(cfg, batch=4, max_len=MAX_LEN, free_bytes=free)
        plan = plan_for(cfg, 1, hbm_frac_for_weights=HBM_FRAC, hbm_bytes=budget)
        eng = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN,
                                retier_headroom=1)
        if eng.streamed_store_bytes + HOST_RESERVE <= mem["MemAvailable"]:
            break
    else:
        raise AssertionError(f"host memory holds the streamed tier of no depth "
                             f">= {MIN_LAYERS}")
    if depth < base.n_layers:
        log(f"DEPTH CUT: {depth} of {base.n_layers} layers (host MemAvailable "
            f"{mem['MemAvailable'] / 1e9:.2f} GB holds no deeper streamed tier)")
    L = cfg.n_layers
    l_bytes = cfg.layer_params() * 2
    n_res = len(eng.resident_layer_ids())
    log(f"  {cfg.name}: {L} layers, full width; weight budget "
        f"{budget / 1e9:.2f} GB x {HBM_FRAC}; plan n_seg {plan.n_seg}, k_res "
        f"{plan.k_res}, k_off {plan.k_off}, retier headroom 1: {n_res} resident "
        f"({n_res * l_bytes / 1e9:.2f} GB), {L - n_res} streamed "
        f"({(L - n_res) * l_bytes / 1e9:.2f} GB), pinned store "
        f"{eng.streamed_store_bytes / 1e9:.2f} GB")
    # the block PyTorch's own pinned allocator takes for one layer (it
    # rounds blocks up; the engine registers plain host memory instead)
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        log(f"  PyTorch's pinned allocator: not measured (torch "
            f"{torch.__version__} has no host_memory_stats)")
    else:
        before = stats().get("allocated_bytes.current", 0)
        probe = torch.empty(eng.layer_numel, dtype=torch.bfloat16,
                            pin_memory=True)
        block = stats().get("allocated_bytes.current", 0) - before
        del probe
        getattr(torch._C, "_host_emptyCache", lambda: None)()
        log(f"  PyTorch's pinned allocator: one {l_bytes / 1e9:.3f} GB layer "
            f"holds a {block / 1e9:.3f} GB block (host_memory_stats)")
    params = M.init_params_by_layer(cfg, seed=0)
    t0 = time.monotonic()
    eng.init_state(params)
    torch.cuda.synchronize()
    store = eng.store
    log(f"  tiers built from the layer source in {time.monotonic() - t0:.1f} s: "
        f"pinned {store.nbytes / 1e9:.2f} GB allocated (cudaHostRegister "
        f"{store.registered}, is_pinned {store.data.is_pinned()}), host "
        f"MemAvailable now {meminfo()['MemAvailable'] / 1e9:.2f} GB, HBM "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rate = h2d_rate(store.data.flatten(0, 1))
    log(f"  pinned H2D on a side stream: {rate:.2f} GB/s (one-layer copies of "
        f"{l_bytes / 1e9:.3f} GB) [{card}]")

    prompts = make_prompts(4, cfg.vocab_size, 0)
    spec = SpecConfig(k=SPEC_K, adapt_k=False)
    launches = {"mq_decode_attention": 0, "decode_attention": 0}
    torch.cuda.reset_peak_memory_stats()
    served = {}
    for pattern, n_req, retier_at in (("bursty", 4, RETIER_AT),
                                      ("sporadic", 2, ())):
        srv = LimeServer(cfg, params, engine=eng, max_len=MAX_LEN,
                         pattern=pattern, spec=spec,
                         prefill_chunk_tokens=PREFILL_CHUNK)
        t0 = time.monotonic()
        done, stats, (m, d), applied = drive(srv, prompts[:n_req], pattern, L,
                                             retier_at)
        wall = time.monotonic() - t0
        launches["mq_decode_attention"] += m
        launches["decode_attention"] += d
        be = srv.make_backend()
        rep = summarize(done, pattern=pattern, backend="engine", stats=stats)
        spec_rounds = [c for k, c in be.rounds if k]
        log(f"  {pattern}: {rep.n_requests} requests x {MAX_NEW_80} tokens, "
            f"prompt {PROMPT_LEN}: TTFT p50 {rep.ttft_p50_s * 1e3:.1f} ms, p99 "
            f"{rep.ttft_p99_s * 1e3:.1f} ms; decode {1e3 / rep.decode_tok_s_p50:.1f} "
            f"ms/token per request (p50); acceptance {rep.spec_acceptance_rate:.3f} "
            f"({rep.spec_accepted}/{rep.spec_drafted} drafts); "
            f"{len(be.rounds)} rounds, committed per round mean "
            f"{np.mean(spec_rounds):.2f}; launches mq {m}, decode {d}; retier "
            f"{applied}; {wall:.1f} s wall [{card}; {L} layers]")
        if pattern == "bursty" and not (applied and applied[0][2]):
            raise AssertionError("bursty: the retier(+1) did not land mid-serve")
        if eng.demoted(0):               # the serve ended before round 4
            srv.make_backend().retier(0, -eng.demoted(0))
            log("  retier(-1) applied after the serve")
        served[pattern] = done
    log(f"  peak HBM during the serves {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"[{card}]")

    # pass and draft times against the copy time of the streamed bytes
    st = eng.init_state(params)
    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    lg, st = eng.prefill_partial(st, toks, chunk=PREFILL_CHUNK)
    P = st["pos"]
    cur = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    mat = torch.cat([cur, toks[:, :SPEC_K]], 1)
    times = {}
    for label, fn in (("draft", lambda: eng.draft_step(st, cur)),
                      ("verify q_len 5", lambda: eng.verify_step(st, mat)),
                      ("decode", lambda: eng.decode_step(st, cur))):
        times[label] = []
        for _ in range(2):
            times[label].append(timed_s(fn))
            eng.rollback(st, P)
    streamed = (L - n_res) * l_bytes
    copy_s = streamed / (rate * 1e9)
    for label, ts in times.items():
        share = "" if label == "draft" else (
            f"; streamed {streamed / 1e9:.1f} GB / {rate:.1f} GB/s = "
            f"{copy_s * 1e3:.0f} ms of copy, {copy_s / min(ts):.1%} of the pass")
        log(f"  one {label} pass: {', '.join(f'{t * 1e3:.1f}' for t in ts)} ms{share} "
            f"[{card}; {L} layers, B 4]")
    pass_profile(eng, st, P, lambda: eng.decode_step(st, cur), card, "decode")
    pass_profile(eng, st, P, lambda: eng.verify_step(st, mat), card, "verify q_len 5")

    log("phase 3b: every served position against the engine's plain greedy decode")
    for pattern, done in served.items():
        n_req = len(done)
        n_pos, n_tie, worst = reference_check(eng, params, cfg, prompts[:n_req],
                                              done, pattern)
        log(f"  {pattern}: {n_pos} positions compared, {n_tie} near ties, worst "
            f"verify-vs-decode logit err {worst:.4f} of |logit| max")
    eng.close()
    log(f"phase 3b done in {time.monotonic() - t_phase:.1f} s")
    return launches, L


def _leaves(t):
    for v in t.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ----------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()
        card = smi[0] if smi else "unknown card"
        log(f"phase 0: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}; card and power limit (nvidia-smi):")
        log(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("phase 0: TF32 off for matmul and cuDNN (fp32 references in full fp32)")
        t0 = time.monotonic()
        lib_path = build.build()
        build.load()
        log(f"phase 0: kernels built in {time.monotonic() - t0:.1f} s -> {lib_path}")
        ptxas = lib_path.parent / "ptxas.log"
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

        rows = kernel_phase()
        launches, cfg8, params8 = main_path_phase(card)
        prefix_launches, serve_us = prefix_phase(cfg8, params8, card)
        for k, n in prefix_launches.items():
            launches[k] = launches.get(k, 0) + n
        engine_check_phase(cfg8, params8, card)
        del params8
        gc.collect()
        torch.cuda.empty_cache()
        engine_launches, depth = full_model_phase(card)
        for k, n in engine_launches.items():
            launches[k] = launches.get(k, 0) + n

        kernels = []
        for name, src, tpu in (
                ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:88"),
                ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:104"),
                ("mq_decode_attention", "src/repro_torch/csrc/mq_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:107"),
                ("paged_decode_attention", "src/repro_torch/csrc/paged_decode_attention.cu",
                 "src/repro/kernels/decode_attention/paged.py:119"),
                ("mq_paged_decode_attention",
                 "src/repro_torch/csrc/mq_paged_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:248")):
            r = rows[name]
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the main path")
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        line = {"kernels": kernels}
        if depth < 80:                   # a host-memory-forced depth cut
            line["engine_layers"] = {"served": depth, "of": 80}
        log(json.dumps(line))
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
