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
   a yardstick.
2. the main path: LLaMA-3.3-70B at full width, depth cut to 8 of 80
   layers, random weights from a seed, served through LimeServer ->
   ContinuousBatchingScheduler -> EngineBackend under bursty and sporadic
   traffic; both kernels' launch counters must advance by the expected
   counts; a re-serve on the reference math (impl="ref") gives the
   reference tokens, which are fed through both impls at the served batch
   shape, and at every position the kernel path's greedy pick must be the
   reference's (or a near tie) with its logits within the limit; a
   profiler breakdown of one bursty serve gives device time by kernel
   class and the device's idle share.
3. a JSON line of per-kernel numbers, then the ``ok`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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
    for name, r in rows.items():
        bound = max(r["bytes_bound_ms"], r["ops_bound_ms"])
        r["bound_ms"] = bound
        r["bound_by"] = "bytes" if r["bytes_bound_ms"] >= r["ops_bound_ms"] else "operations"
        log(f"  {name} @ main shape: kernel {r['ms']:.4f} ms, bound {bound:.4f} ms "
            f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} GFLOP), "
            f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']} ms, "
            f"roofline share {bound / r['ms']:.3f}")
    return rows


# ----------------------------------------------------------------------------
# phase 2: the main path
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
    log(f"phase 2: main path, {cfg.name} at full width (d_model {cfg.d_model}, "
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
    return launches


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
        launches = main_path_phase(card)

        kernels = []
        for name, src, tpu in (
                ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:88"),
                ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:104")):
            r = rows[name]
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the main path")
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        log(json.dumps({"kernels": kernels}))
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
