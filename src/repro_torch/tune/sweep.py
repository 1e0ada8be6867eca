"""Launch-knob autotuner for the hand-written CUDA kernels (counterpart of
``repro.tune.sweep``).

For each kernel entry point this times a candidate list of launch
configs on representative shapes and records the winner in a TuneCache,
keyed by (device_kind, kernel, shape-bucket). `repro_torch.kernels.
tuning` then answers the wrappers' lookups with the winner, so a sweep
run once per device kind changes every later launch of a bucketed shape,
and no sweep at all leaves every launch on the wrappers' rules.

The knob is the split count (``n_split``) of the kernels that split a
(b, kv head)'s cache slots over the blocks of one cluster: decode (1),
paged decode (3), and the verify / mma.sync bodies of the multi-query
kernels (4, 5). The flash kernel (2) and the scans (6, 7) have no launch
knob (their tiles are compile-time): each is timed at its one config and
its row recorded. The paged kernels also sweep the pool's ``page_size``
(the pool is rebuilt per candidate: the page size is the layout); its
winner is recorded, never consulted, as in the JAX package.

Candidates are filtered to the splits the kernel takes at the shape
(``tuning.split_legal``) and always include the wrapper's own rule. A
candidate wins only by more than the timer's spread (the larger CoV of
its calls and the rule's): a closer one leaves the rule's config as the
winner, so ``speedup`` (the rule's time over the winner's) is 1.0 or a
gain the clock can tell. Each row records the launch geometry it was
timed at beside its knobs (``blocks``: the grid's blocks a split
multiplies; the paged rows' ``page_size``), and the wrappers apply it
only at that geometry (``tuning.resolve``'s ``at``). On the card each
candidate is timed on the device clock (``measure.time_device``: CUDA
events, L2 flushed, host enqueue hidden);
on the CPU the wrappers take their plain versions, whatever the knob, and
the host clock times them (the sweep's control flow, not a measurement).

    python -m repro_torch.tune.sweep --reps 5 --out cache.json
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import tuning
from repro_torch.obs.log import get_logger
from repro_torch.tune.measure import time_device

KERNELS = ("decode_attention", "mq_decode_attention", "flash_attention",
           "rwkv6_scan", "ssm_scan", "paged_decode_attention",
           "mq_paged_decode_attention")

SPLITS = (1, 2, 4, 8)
PAGE_SIZES = (16, 32, 64, 128)
H100_SMS = 132            # the rule's SM count where no card is asked

# candidate launch configs per kernel; the rule's config joins them
CANDIDATES: Dict[str, List[Dict[str, int]]] = {
    "decode_attention": [{"n_split": n} for n in SPLITS],
    "mq_decode_attention": [{"n_split": n} for n in SPLITS],
    "flash_attention": [{}],
    "rwkv6_scan": [{}],
    "ssm_scan": [{}],
    "paged_decode_attention": [{"page_size": p, "n_split": n}
                               for p in PAGE_SIZES for n in SPLITS],
    "mq_paged_decode_attention": [{"page_size": p, "n_split": n}
                                  for p in PAGE_SIZES for n in SPLITS],
}

# the main path's shapes (LLaMA-3.3-70B's attention, RWKV6-3B's WKV,
# Hymba-1.5B's SSM): a bursty decode step at the end of a 1024-slot cache,
# a verify pass of q_len 5 at position 1019, a 512-token prefill, pages of
# a 1019-token context; `span` is the axis the knob splits (JAX's keys,
# so JAX's DEFAULT_SHAPES plug in through ``shapes=``)
DEFAULT_SHAPES: Dict[str, Dict[str, int]] = {
    "decode_attention": dict(B=4, H=64, KV=8, dh=128, span=1024),
    "mq_decode_attention": dict(B=4, H=64, KV=8, dh=128, span=1024, Q=5),
    "flash_attention": dict(B=4, H=64, KV=8, dh=128, Sq=512, span=512),
    "rwkv6_scan": dict(B=4, H=40, dh=64, span=512),
    "ssm_scan": dict(B=4, H=25, dh=64, span=512, N=16),
    "paged_decode_attention": dict(B=4, H=64, KV=8, dh=128, span=1019),
    "mq_paged_decode_attention": dict(B=4, H=64, KV=8, dh=128, span=1019,
                                      Q=5),
}


@dataclasses.dataclass(frozen=True)
class SweepResult:
    kernel: str
    bucket: str
    default_cfg: Dict[str, int]
    default_s: float
    best_cfg: Dict[str, int]
    best_s: float
    spread: float = 0.0     # the relative margin a candidate had to beat
    at: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def speedup(self) -> float:
        return self.default_s / self.best_s if self.best_s > 0 else 1.0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["speedup"] = self.speedup
        return d


@dataclasses.dataclass
class Runner:
    """One kernel at one shape: `run(cfg)` calls the wrapper with cfg's
    knobs passed explicitly, `plain(cfg)` its plain version on the same
    inputs; `default` is the wrapper's own rule at this shape, `legal(cfg)`
    whether the kernel takes cfg there; `at` the launch geometry a row
    records beside the winner (``tuning.resolve``'s)."""
    bucket: str
    run: Callable[[Mapping[str, int]], torch.Tensor]
    plain: Callable[[Mapping[str, int]], torch.Tensor]
    default: Dict[str, int]
    legal: Callable[[Mapping[str, int]], bool]
    at: Dict[str, int] = dataclasses.field(default_factory=dict)


# -- per-kernel runners --------------------------------------------------------
# Inputs are drawn once per shape from a seeded generator in the main
# path's types (attention bf16; the scans' r, k, v, x, B, C bf16, decays
# and states fp32), the decode position a device scalar as the serving
# steps pass it; the paged runners build one pool per page size.

def _sms(dev: torch.device) -> int:
    if dev.type != "cuda":
        return H100_SMS
    from repro_torch.kernels.decode_attention.ops import _sm_count
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def _randn(shape, gen, dev, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _run_decode(shape, dev):
    from repro_torch.kernels.decode_attention import ops as da
    B, H, KV, dh, S = (shape[k] for k in ("B", "H", "KV", "dh", "span"))
    g = torch.Generator(device=dev).manual_seed(0)
    q = _randn((B, 1, H, dh), g, dev)
    k, v = _randn((B, S, KV, dh), g, dev), _randn((B, S, KV, dh), g, dev)
    ids = torch.arange(S, dtype=torch.int32, device=dev)
    pos = torch.tensor(S - 1, dtype=torch.int32, device=dev)
    return Runner(
        tuning.shape_bucket(S, dh),
        lambda c: da.decode_attention(q, k, v, ids, pos,
                                      n_split=c.get("n_split")),
        lambda c: da.decode_attention_plain(q, k, v, ids, pos),
        {"n_split": da.split_count(B, KV, S, _sms(dev))},
        lambda c: tuning.split_legal(c["n_split"], S), {"blocks": B * KV})


def _mq_default(B, Q, H, KV, dh, S, dev):
    """(the rule's config, the body's least tiles a split, the geometry)
    at a shape; the mainloop (more than VERIFY_ROWS rows) has no knob."""
    from repro_torch.kernels.decode_attention import multiquery as mq
    body = mq.mq_body(Q, H // KV, dh, 1)
    if body == "mainloop":
        return {}, 0, {}
    return ({"n_split": mq.n_splits(body, B, Q, H, KV, S, _sms(dev))},
            2 if body == "verify" else 1,
            {"blocks": mq.split_blocks(body, B, Q, H, KV)})


def _run_mq_decode(shape, dev):
    from repro_torch.kernels.decode_attention import multiquery as mq
    B, H, KV, dh, S, Q = (shape[k] for k in ("B", "H", "KV", "dh", "span",
                                             "Q"))
    g = torch.Generator(device=dev).manual_seed(0)
    q = _randn((B, Q, H, dh), g, dev)
    k, v = _randn((B, S, KV, dh), g, dev), _randn((B, S, KV, dh), g, dev)
    ids = torch.arange(S, dtype=torch.int32, device=dev)
    pos = torch.tensor(S - Q, dtype=torch.int32, device=dev)
    default, tiles, at = _mq_default(B, Q, H, KV, dh, S, dev)
    return Runner(
        tuning.shape_bucket(S, dh),
        lambda c: mq.mq_decode_attention(q, k, v, ids, pos,
                                         n_split=c.get("n_split")),
        lambda c: mq.mq_decode_attention_plain(q, k, v, ids, pos),
        default,
        lambda c: c == default if not tiles
        else tuning.split_legal(c["n_split"], S, tiles), at)


def _run_flash(shape, dev):
    from repro_torch.kernels.flash_attention import ops as fa
    B, H, KV, dh, Sq, Skv = (shape[k] for k in ("B", "H", "KV", "dh", "Sq",
                                                "span"))
    g = torch.Generator(device=dev).manual_seed(0)
    q = _randn((B, Sq, H, dh), g, dev)
    k, v = _randn((B, Skv, KV, dh), g, dev), _randn((B, Skv, KV, dh), g, dev)
    kw = dict(causal=True, q_offset=Skv - Sq)
    return Runner(tuning.shape_bucket(Skv, dh),
                  lambda c: fa.flash_attention(q, k, v, **kw),
                  lambda c: fa.flash_attention_plain(q, k, v, **kw),
                  {}, lambda c: c == {})


def _run_rwkv6(shape, dev):
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    B, H, dh, S = (shape[k] for k in ("B", "H", "dh", "span"))
    g = torch.Generator(device=dev).manual_seed(0)
    r, k, v = (_randn((B, S, H, dh), g, dev, scale=0.5) for _ in range(3))
    w = torch.sigmoid(_randn((B, S, H, dh), g, dev, torch.float32)) * 0.9 \
        + 0.05
    u = _randn((H, dh), g, dev, scale=0.1)
    state = _randn((B, H, dh, dh), g, dev, torch.float32)

    def run(c):
        s = state.clone()
        return wkv.wkv(r, k, v, w, u, s), s

    def plain(c):
        return wkv.wkv_plain(r, k, v, w, u, state)

    return Runner(tuning.shape_bucket(S, dh), run, plain, {},
                  lambda c: c == {})


def _run_ssm(shape, dev):
    from repro_torch.kernels.ssm_scan import ops as ssm
    B, H, dh, S, N = (shape[k] for k in ("B", "H", "dh", "span", "N"))
    g = torch.Generator(device=dev).manual_seed(0)
    x = _randn((B, S, H, dh), g, dev, scale=0.5)
    dt = torch.nn.functional.softplus(
        _randn((B, S, H), g, dev, torch.float32))
    bm, cm = (_randn((B, S, N), g, dev, scale=0.5) for _ in range(2))
    A = -torch.exp(_randn((H,), g, dev, torch.float32, scale=0.3))
    state = _randn((B, H, N, dh), g, dev, torch.float32)

    def run(c):
        s = state.clone()
        return ssm.ssm_scan(x, dt, bm, cm, A, s), s

    def plain(c):
        return ssm.ssm_scan_plain(x, dt, bm, cm, A, state)

    return Runner(tuning.shape_bucket(S, dh), run, plain, {},
                  lambda c: c == {})


def _paged_runner(shape, dev, multi_query: bool):
    """Paged runners build one pool per page size: the page size IS the
    layout, so each candidate reads a differently paged pool holding the
    same `span` context tokens per request."""
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg
    B, H, KV, dh, ctx = (shape[k] for k in ("B", "H", "KV", "dh", "span"))
    Q = shape.get("Q", 1) if multi_query else 1
    g = torch.Generator(device=dev).manual_seed(0)
    q = _randn((B, Q, H, dh), g, dev)
    pools: Dict[int, tuple] = {}

    def pool(ps):
        if ps not in pools:
            per = -(-ctx // ps)
            k_pool = _randn((B * per, ps, KV, dh), g, dev)
            tables = torch.arange(B * per, dtype=torch.int32,
                                  device=dev).reshape(B, per)
            pools[ps] = (k_pool, k_pool * 0.5, tables,
                         torch.full((B,), ctx, dtype=torch.int32, device=dev))
        return pools[ps]

    if multi_query:
        fn, plain_fn = mq.mq_paged_decode_attention, \
            mq.mq_paged_decode_attention_plain
    else:
        fn, plain_fn = pg.paged_decode_attention, \
            pg.paged_decode_attention_plain
    ps0 = tuning.DEFAULTS["paged_decode_attention"]["page_size"]
    S0 = -(-ctx // ps0) * ps0
    if multi_query:
        split, tiles, at = _mq_default(B, Q, H, KV, dh, S0, dev)
    else:
        split, tiles, at = {"n_split": da.split_count(B, KV, S0, _sms(dev))}, \
            1, {"blocks": B * KV}

    def legal(c):
        S = -(-ctx // c["page_size"]) * c["page_size"]
        if c["page_size"] % pg.PAGE_MULTIPLE:
            return False
        if not tiles:
            return "n_split" not in c
        return tuning.split_legal(c["n_split"], S, tiles)

    return Runner(
        tuning.shape_bucket(ctx, dh),
        lambda c: fn(q, *pool(c["page_size"]), n_split=c.get("n_split")),
        lambda c: plain_fn(q, *pool(c["page_size"])),
        dict({"page_size": ps0}, **split), legal, at)


_RUNNERS: Dict[str, Callable] = {
    "decode_attention": _run_decode,
    "mq_decode_attention": _run_mq_decode,
    "flash_attention": _run_flash,
    "rwkv6_scan": _run_rwkv6,
    "ssm_scan": _run_ssm,
    "paged_decode_attention":
        lambda s, d: _paged_runner(s, d, multi_query=False),
    "mq_paged_decode_attention":
        lambda s, d: _paged_runner(s, d, multi_query=True),
}


def runner(kernel: str, shape: Optional[Mapping[str, int]] = None,
           device=None) -> Runner:
    """The Runner of `kernel` at `shape` (DEFAULT_SHAPES' entry updated
    by it) on `device` (the card by default)."""
    return _RUNNERS[kernel](dict(DEFAULT_SHAPES[kernel], **(shape or {})),
                            resolve_device(device))


def legal_candidates(kernel: str, r: Runner,
                     cands: Optional[Sequence[Mapping[str, int]]] = None
                     ) -> List[Dict[str, int]]:
    """The configs the sweep times: `cands` (CANDIDATES by default) that
    the kernel takes at the runner's shape, and the rule's."""
    out = [dict(c) for c in (cands or CANDIDATES[kernel])
           if r.legal(dict(c))]
    if r.default not in out:
        out.append(dict(r.default))
    return out


# -- sweeps --------------------------------------------------------------------

def sweep_kernel(kernel: str, *, shape: Optional[Mapping[str, int]] = None,
                 candidates: Optional[Sequence[Mapping[str, int]]] = None,
                 reps: int = 3, device=None) -> SweepResult:
    """Time every candidate config for one kernel on one shape; returns
    the winner vs the rule's config: the fastest, where it beats the
    rule's by more than the larger CoV of the two, else the rule's.
    Explicit knob values are always passed, so the sweep never reads (or
    needs) the installed tuning table."""
    dev = resolve_device(device)
    r = runner(kernel, shape, dev)
    timed = []
    for cfg in legal_candidates(kernel, r, candidates):
        med, cov = time_device(lambda c=cfg: r.run(c), reps=reps, warmup=1,
                               device=dev, flush_l2=True)
        timed.append((cfg, med, cov if cov == cov else 0.0))
    _, default_s, default_cov = next(t for t in timed if t[0] == r.default)
    best_cfg, best_s, best_cov = min(timed, key=lambda t: t[1])
    spread = max(default_cov, best_cov)
    if best_s * (1.0 + spread) >= default_s:
        best_cfg, best_s = r.default, default_s
    return SweepResult(kernel=kernel, bucket=r.bucket,
                       default_cfg=dict(r.default), default_s=default_s,
                       best_cfg=dict(best_cfg), best_s=best_s, spread=spread,
                       at=dict(r.at))


def run_sweep(kernels: Optional[Sequence[str]] = None, *,
              cache=None, device_kind: Optional[str] = None,
              shapes: Optional[Mapping[str, Mapping[str, int]]] = None,
              candidates: Optional[Mapping[str, Sequence[Mapping]]] = None,
              reps: int = 3, device=None) -> List[SweepResult]:
    """Sweep a set of kernels (default: all) and record winners into
    `cache` (a TuneCache) under `device_kind`. Returns every
    SweepResult so callers can report speedups."""
    log = get_logger("repro_torch.tune")
    dev = resolve_device(device)
    if device_kind is None:
        from repro_torch.tune.measure import device_kind as dk
        device_kind = dk(dev)
    results = []
    for kernel in (kernels or KERNELS):
        r = sweep_kernel(
            kernel, shape=(shapes or {}).get(kernel),
            candidates=(candidates or {}).get(kernel), reps=reps,
            device=dev)
        results.append(r)
        log.info("kernel sweep", kernel=kernel, bucket=r.bucket,
                 best=r.best_cfg, default_us=f"{r.default_s * 1e6:.2f}",
                 best_us=f"{r.best_s * 1e6:.2f}",
                 speedup=f"{r.speedup:.3f}x")
        if cache is not None:
            # with the geometry it was timed at: no other one takes it
            cache.put_kernel(device_kind, kernel, r.bucket,
                             dict(r.best_cfg, **r.at),
                             speedup=round(r.speedup, 4),
                             us=round(r.best_s * 1e6, 2))
    return results


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.tune.sweep --reps 5 --out cache.json``
    (on the card; ``--device cpu`` runs the control flow on the plain
    versions)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=None,
                    help="comma-separated subset (default: all seven)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--device-kind", default=None,
                    help="cache key override (default: the device's name)")
    ap.add_argument("--out", default=None,
                    help="TuneCache JSON to load + update with winners")
    args = ap.parse_args(argv)
    from repro_torch.tune.cache import TuneCache
    cache = TuneCache.load(args.out) if args.out else TuneCache()
    results = run_sweep(args.kernels.split(",") if args.kernels else None,
                        cache=cache, device_kind=args.device_kind,
                        reps=args.reps, device=args.device)
    for r in results:
        print(f"{r.kernel:28s} {r.bucket:12s} "
              f"default {r.default_s * 1e6:9.2f}us  "
              f"best {r.best_s * 1e6:9.2f}us  "
              f"{r.speedup:6.3f}x  {r.best_cfg} (rule {r.default_cfg})")
    if args.out:
        cache.save(args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
