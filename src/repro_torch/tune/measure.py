"""Microbenchmark harness: time the device, emit a MeasuredProfile
(counterpart of ``repro.tune.measure``).

The profiles in `repro_torch.core.profiles` are typed; this module
replaces them with clocks. Four primitive measurements map one-to-one
onto the fields the cost model prices:

  - ``measure_flops``      -> DeviceProfile.flops    (bf16 matmul)
  - ``measure_mem_bw``     -> DeviceProfile.mem_bw   (scale: read+write)
  - ``measure_stream_bw``  -> load_bw / host_bw (H2D) and
                              load_write_bw (D2H): copies between pinned
                              host memory and the card on a side stream,
                              the copies the engine's streamer issues
  - ``measure_decode_loop``-> extras: a timed prefill / insert / generate
                              loop on a smoke model (an end-to-end
                              cross-check of the primitives above)

``measure_profile`` assembles them into a MeasuredProfile carrying
per-field confidence (coefficient of variation across trials). Memory
capacity (`mem_bytes`) is deliberately *not* measured: it is an enforced
budget, not a throughput, so the analytic base's value is kept.

Two clocks. ``timeit_median`` is the host clock with JAX's contract (the
function must wait for its own work), for end-to-end loops and for the
CPU. ``time_device`` times device work with CUDA events, each call
behind a spin kernel that hides the host's enqueue (and, if asked, an L2
flush), for the primitives and the kernel sweep on the card. A
measurement asked of a CUDA device runs there or raises: it never falls
back to the CPU. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import datetime
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.profiles import DeviceProfile
from repro_torch.device import resolve_device
from repro_torch.tune.profiles import MEASURED_FIELDS, MeasuredProfile

SPIN_CYCLES = 2_000_000   # ~1 ms at the H100's clock: longer than a timed
                          # call takes to enqueue
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def _stats(ts) -> Tuple[float, float]:
    """(median, coefficient-of-variation) of a list of seconds."""
    a = np.asarray(ts, dtype=np.float64)
    med = float(np.median(a))
    cov = float(a.std() / a.mean()) if a.mean() > 0 else float("nan")
    return med, cov


def timeit_median(fn: Callable[[], object], *, reps: int = 5,
                  warmup: int = 2) -> Tuple[float, float]:
    """Time ``fn()`` on the host clock (fn must wait until its work is
    done: ``torch.cuda.synchronize`` inside) and return (median_s, cov)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return _stats(ts)


def time_device(fn: Callable[[], object], *, reps: int = 5,
                warmup: int = 2, device=None, stream=None,
                flush_l2: bool = False) -> Tuple[float, float]:
    """(median_s, cov) of one ``fn()`` call's device time on `device`.
    On the card each call is bracketed by CUDA events on `stream` (the
    current one by default) behind a spin kernel, so the host's enqueue
    does not count, and with ``flush_l2`` after an L2 flush (the real
    caller finds its inputs cold). On the CPU: ``timeit_median``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return timeit_median(fn, reps=reps, warmup=warmup)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev) \
        if flush_l2 else None
    s = stream if stream is not None else torch.cuda.current_stream(dev)
    with torch.cuda.device(dev), torch.cuda.stream(s):
        for _ in range(warmup):
            fn()
        marks: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(s)
            fn()
            b.record(s)
            marks.append((a, b))
        marks[-1][1].synchronize()
    return _stats([a.elapsed_time(b) * 1e-3 for a, b in marks])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- primitives ----------------------------------------------------------------

def measure_flops(*, n: int = 1024, reps: int = 5,
                  device=None) -> Tuple[float, float]:
    """Dense-compute throughput: timed (n x n) bf16 matmul; returns
    (flops_per_s, cov). JAX's n = 1024 lasts a few µs on an H100, well
    under its peak: the card's callers pass a larger n."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, n), generator=g, device=dev).to(torch.bfloat16)
    med, cov = time_device(lambda: x @ x, reps=reps, device=dev)
    return 2.0 * n * n * n / med, cov


def measure_mem_bw(*, mb: int = 64, reps: int = 5,
                   device=None) -> Tuple[float, float]:
    """On-device memory bandwidth: a timed scale ``y = a*x`` over an
    ``mb``-MiB fp32 buffer into another (one kernel: one read + one write
    stream, what JAX's jitted triad ``a*x + b`` fuses to; eager PyTorch
    would run ``a*x + b`` as two kernels, four streams); returns
    (bytes_per_s, cov)."""
    dev = resolve_device(device)
    n = mb * (1 << 20) // 4
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    med, cov = time_device(lambda: torch.mul(x, 1.0001, out=y), reps=reps,
                           device=dev)
    return 2.0 * n * 4 / med, cov


def measure_stream_bw(*, mb: int = 32, reps: int = 5, device=None,
                      src: Optional[torch.Tensor] = None
                      ) -> Dict[str, Tuple[float, float]]:
    """Weight-streaming bandwidth both ways, the quantity the LIME
    pipeline lives or dies on. ``h2d``: pinned host rows -> device, one
    row a copy on a side stream (the engine's streamer's copy), prices
    `load_bw`/`host_bw`; ``d2h``: device -> pinned host, prices
    `load_write_bw`. Returns {dir: (bytes_per_s, cov)}. `src`, rows of a
    pinned host tensor (one streamed layer each, e.g. the engine's store)
    copied in turn, replaces the ``mb``-MiB buffer for h2d; d2h copies
    ``mb`` MiB (at most a row). On the CPU both are forced copies between
    host buffers (a plain ``.to`` aliases and would read petabytes)."""
    dev = resolve_device(device)
    nbytes = mb * (1 << 20)
    if src is None:
        src = torch.ones((1, nbytes), dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    row_bytes = src[0].numel() * src[0].element_size()
    buf = torch.empty_like(src[0], device=dev)
    flat = buf.reshape(-1).view(torch.uint8)
    back_bytes = min(nbytes, row_bytes)
    back = torch.empty(back_bytes, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    turn = [0]

    def h2d():
        buf.copy_(src[turn[0] % src.shape[0]], non_blocking=True)
        turn[0] += 1

    def d2h():
        back.copy_(flat[:back_bytes], non_blocking=True)

    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t_h2d = time_device(h2d, reps=reps, warmup=1, device=dev,
                            stream=side)
        t_d2h = time_device(d2h, reps=reps, warmup=1, device=dev,
                            stream=side)
        torch.cuda.current_stream(dev).wait_stream(side)
    else:
        t_h2d = timeit_median(h2d, reps=reps, warmup=1)
        t_d2h = timeit_median(d2h, reps=reps, warmup=1)
    return {"h2d": (row_bytes / t_h2d[0], t_h2d[1]),
            "d2h": (back_bytes / t_d2h[0], t_d2h[1])}


# -- end-to-end decode loop ----------------------------------------------------

def _clone_tensors(t):
    if isinstance(t, torch.Tensor):
        return t.clone()
    if isinstance(t, dict):
        return {k: _clone_tensors(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_clone_tensors(v) for v in t)
    return t


def _tensor_bytes(t) -> float:
    if isinstance(t, torch.Tensor):
        return float(t.numel() * t.element_size())
    if isinstance(t, dict):
        return sum(_tensor_bytes(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return sum(_tensor_bytes(v) for v in t)
    return 0.0


def measure_decode_loop(arch: str = "gemma3-1b", *, batch: int = 1,
                        prompt: int = 32, gen: int = 8, reps: int = 3,
                        device=None) -> Dict[str, float]:
    """MaxText-style decode microbenchmark on a smoke-sized model through
    the hand-written kernels: timed prefill (prompt pass), insert (the
    prefilled cache copied on the device, the per-slot KV adoption copy),
    and generate (autoregressive ``decode_step`` loop). Returns raw
    observations for MeasuredProfile.extras, an end-to-end cross-check on
    the primitive measurements, not a pricing input."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    dev = resolve_device(device)
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    max_len = prompt + gen + 8
    tokens = torch.ones((batch, prompt), dtype=torch.long, device=dev)

    def do_prefill():
        cache = M.init_cache(cfg, batch, max_len, device=dev)
        logits, cache = M.prefill(cfg, params, tokens, cache, impl="kernel")
        _sync(dev)
        return logits, cache

    prefill_s, prefill_cov = timeit_median(do_prefill, reps=reps, warmup=1)
    _, cache = do_prefill()
    cache_bytes = _tensor_bytes(cache)

    def do_insert():
        c = _clone_tensors(cache)
        _sync(dev)
        return c

    insert_s, _ = timeit_median(do_insert, reps=reps, warmup=1)
    tok = torch.ones((batch, 1), dtype=torch.long, device=dev)

    def do_generate():
        c, t = _clone_tensors(cache), tok
        for _ in range(gen):
            logits, c = M.decode_step(cfg, params, c, t, impl="kernel")
            t = logits[:, -1:].argmax(-1)
        _sync(dev)
        return logits

    gen_s, gen_cov = timeit_median(do_generate, reps=reps, warmup=1)
    per_tok = gen_s / gen
    return {
        "prefill_s": prefill_s,
        "prefill_cov": prefill_cov,
        "insert_s": insert_s,
        "insert_bytes": cache_bytes,
        "insert_bw": cache_bytes / insert_s if insert_s > 0 else float("nan"),
        "decode_tok_s": batch / per_tok if per_tok > 0 else float("nan"),
        "decode_cov": gen_cov,
        "prompt": float(prompt),
        "gen": float(gen),
    }


# -- assembly ------------------------------------------------------------------

def device_kind(device=None) -> str:
    """The cache key of a measurement: the card's name
    (``torch.cuda.get_device_name``), or "cpu"."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def measure_profile(name: str, base: DeviceProfile, *,
                    reps: int = 5, mb: int = 32, n: int = 1024,
                    decode_arch: Optional[str] = None,
                    device=None) -> MeasuredProfile:
    """Run the harness and assemble a MeasuredProfile. `base` supplies
    the non-throughput knobs (mem_bytes stays an enforced budget) and
    the analytic comparison for `check_sane`; `n` is the matmul's size
    and `mb` the copies' and the scale's MiB (the card's callers pass
    sizes that fill it). ``decode_arch`` optionally adds the end-to-end
    decode-loop observations to extras (slower, so off by default)."""
    dev = resolve_device(device)
    flops, flops_cov = measure_flops(n=n, reps=reps, device=dev)
    mem_bw, mem_cov = measure_mem_bw(mb=max(mb, 16), reps=reps, device=dev)
    stream = measure_stream_bw(mb=mb, reps=reps, device=dev)
    (h2d, h2d_cov), (d2h, d2h_cov) = stream["h2d"], stream["d2h"]

    extras: Dict[str, float] = {}
    if decode_arch:
        extras.update(measure_decode_loop(decode_arch, device=dev))

    vals = dict(name=name, mem_bytes=base.mem_bytes, flops=flops,
                mem_bw=mem_bw, load_bw=h2d, load_write_bw=d2h, host_bw=h2d)
    conf = {"flops": flops_cov, "mem_bw": mem_cov, "load_bw": h2d_cov,
            "load_write_bw": d2h_cov, "host_bw": h2d_cov}
    prof = MeasuredProfile(
        device_kind=device_kind(dev), source="measured",
        measured_at=datetime.datetime.now(datetime.timezone.utc).isoformat(),
        n_trials=reps, confidence=conf, extras=extras, **vals)
    prof.check_sane(base)
    return prof


def measure_fields(base: DeviceProfile, *, device=None
                   ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Primitive measurements only, as ({field: value}, {field: cov})
    over MEASURED_FIELDS: the pieces `measure_profile` assembles."""
    prof = measure_profile(base.name, base, reps=3, mb=16, device=device)
    return ({f: getattr(prof, f) for f in MEASURED_FIELDS},
            dict(prof.confidence))
