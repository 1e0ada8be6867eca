"""The paper's six baselines (§V-A), on the same cost substrate as LIME
(counterpart of ``repro.core.baselines``, the JAX package's code
unchanged).

Every baseline consumes the same `CostEnv` (device profiles, network
bandwidth, workload) so comparisons isolate the *scheduling* differences —
exactly what the paper varies. Memory-infeasible configurations return
OOM, mirroring Figs 15-17; callers apply the paper's OOT thresholds.

  PP              GPipe-style pipeline, layers allocated by memory; OOM if
                  the model + KV doesn't fit in aggregate.
  PP+offload      traditional pipeline with in-stage offloading (Fig 3a/4a):
                  loads overlap only the *owning* device's resident compute,
                  and bursty steps reload per micro-batch group (the
                  "multiple loading delay" failure).
  EdgeShard       compute-balanced DP layer partition, no offloading.
  Galaxy          TP + SP hybrid; per-layer allreduce traffic; no offloading
                  (OOM when a proportional shard doesn't fit).
  TPI-LLM         TP with sliding-window weight streaming: never OOM, but
                  every step re-streams the out-of-window weights and pays
                  TP allreduce latency on edge links.
  TPI-LLM+offload TPI-LLM with a window large enough to also hold KV spill
                  (paper: "larger sliding window instead of re-computation").

KV-cache pressure: baselines without native memory-constrained support
(PP, EdgeShard, Galaxy) recompute evicted K/V on demand (paper §V-A), which
adds a growing per-step compute term once the cache no longer fits.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.cost_model import CostEnv
from repro_torch.core.pipeline_sim import SimResult, StepTrace

INF = float("inf")


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------
def _balanced_partition(env: CostEnv, n_layers: int,
                        by_compute: bool) -> Optional[List[int]]:
    """Contiguous layer counts per device. by_compute: EdgeShard DP;
    else memory-greedy (classic PP). None -> OOM."""
    w = env.work
    caps = [int(d.mem_bytes // (w.l_size
                                + 512 * w.kv_bytes_per_token_layer()))
            for d in env.devices]
    if sum(caps) < n_layers:
        return None
    if not by_compute:
        alloc, left = [], n_layers
        for c in caps:
            take = min(c, left)
            alloc.append(take)
            left -= take
        return None if left else alloc
    # EdgeShard: minimize max stage time subject to memory caps
    speeds = [1.0 / w.comp_layer(d) for d in env.devices]
    total_speed = sum(speeds)
    ideal = [n_layers * s / total_speed for s in speeds]
    alloc = [min(int(round(x)), c) for x, c in zip(ideal, caps)]
    # fix rounding to sum exactly, respecting caps
    diff = n_layers - sum(alloc)
    order = sorted(range(len(alloc)), key=lambda i: ideal[i] - alloc[i],
                   reverse=(diff > 0))
    k = 0
    while diff != 0 and k < 10 * len(alloc):
        i = order[k % len(alloc)]
        step = 1 if diff > 0 else -1
        if 0 <= alloc[i] + step <= caps[i]:
            alloc[i] += step
            diff -= step
        k += 1
    return alloc if diff == 0 else None


def _kv_overflow_recompute(env: CostEnv, layers_i: float, ctx: int,
                           dev_idx: int, mem_free: float) -> float:
    """Extra seconds to recompute evicted K/V (paper §V-A baseline patch)."""
    w = env.work
    kv_need = layers_i * ctx * w.kv_bytes_per_token_layer()
    if kv_need <= mem_free:
        return 0.0
    evicted_frac = (kv_need - mem_free) / kv_need
    # recompute = rerun the evicted tokens' K/V projections for these layers
    c = w.cfg
    kv_flops = 2 * 2 * c.d_model * c.n_kv_heads * (c.head_dim or 0)
    flops = evicted_frac * ctx * w.mb * w.n_micro * layers_i * kv_flops
    return flops / env.devices[dev_idx].flops


def _pipeline_timeline(env: CostEnv, alloc: Sequence[int], ctx: int,
                       n_micro: int, *, off_layers: Sequence[int] = (),
                       loads_per_mb_group: int = 1,
                       overlap_own_compute_only: bool = True,
                       recompute: bool = True) -> float:
    """One token step of a (possibly offloading) traditional pipeline."""
    w = env.work
    D = len(env.devices)
    hop = w.h_size / env.bw_net + env.net_latency
    off = list(off_layers) if off_layers else [0] * D
    t = 0.0
    dev_free = [0.0] * D
    ready = [0.0] * n_micro
    for i in range(D):
        comp1 = w.comp_layer(env.devices[i])
        res_t = alloc[i] * comp1
        load_t = off[i] * w.l_size / env.devices[i].load_bw \
            + off[i] * w.l_size / max(env.devices[i].load_write_bw,
                                      env.devices[i].load_bw) * 0.0
        mem_free = env.devices[i].mem_bytes - alloc[i] * w.l_size
        rec = _kv_overflow_recompute(env, alloc[i] + off[i], ctx, i,
                                     max(mem_free, 0.0)) if recompute else 0.0
        for m in range(n_micro):
            start = max(ready[m], dev_free[i])
            stage = res_t + off[i] * comp1 + rec
            # in-stage offloading: load hides only behind own resident compute
            if off[i]:
                reload_here = (m % max(n_micro // loads_per_mb_group, 1) == 0) \
                    if loads_per_mb_group > 1 else (m == 0)
                if loads_per_mb_group >= n_micro:
                    reload_here = True     # reload for every micro-batch
                if reload_here:
                    uncovered = max(load_t - (res_t if overlap_own_compute_only
                                              else 0.0), 0.0)
                    stage += uncovered
            end = start + stage
            dev_free[i] = end
            ready[m] = end + hop
    return max(ready)


# ----------------------------------------------------------------------------
# PP / PP+offload / EdgeShard
# ----------------------------------------------------------------------------
def simulate_pp(env: CostEnv, n_layers: int, n_tokens: int, *,
                n_micro: int = 1, by_compute: bool = False,
                prompt: int = 64,
                oot_s_per_token: Optional[float] = None) -> SimResult:
    alloc = _balanced_partition(env, n_layers, by_compute)
    if alloc is None:
        return SimResult([], oom=True, reason="model+KV exceeds memory")
    traces = []
    for tok in range(n_tokens):
        ctx = prompt + tok
        lat = _pipeline_timeline(env, alloc, ctx, n_micro)
        traces.append(StepTrace(tok, lat, 0.0, 0.0))
        if oot_s_per_token and lat > oot_s_per_token:
            return SimResult(traces, oot=True, reason=f"{lat:.1f}s/token")
    return SimResult(traces)


def simulate_pp_offload(env: CostEnv, n_layers: int, n_tokens: int, *,
                        n_micro: int = 1, prompt: int = 64,
                        oot_s_per_token: Optional[float] = None) -> SimResult:
    """Traditional pipeline + in-stage offloading (paper Figs 3a/4a)."""
    w = env.work
    kv512 = 512 * w.kv_bytes_per_token_layer()
    caps = [int(d.mem_bytes // (w.l_size + kv512)) for d in env.devices]
    total_cap = sum(caps)
    res = []
    left = n_layers
    for c in caps:
        take = min(max(c - 1, 0), left)   # keep a buffer layer for swapping
        res.append(take)
        left -= take
    if left > 0 and total_cap == 0:
        return SimResult([], oom=True, reason="no device can hold one layer")
    # leftover layers offloaded, spread by load bandwidth
    bw_tot = sum(d.load_bw for d in env.devices)
    off = [int(round(left * d.load_bw / bw_tot)) for d in env.devices]
    off[-1] += left - sum(off)
    traces = []
    for tok in range(n_tokens):
        ctx = prompt + tok
        # Fig 4a: each full forward needs 2 offload operations per mb group
        lat = _pipeline_timeline(env, res, ctx, n_micro, off_layers=off,
                                 loads_per_mb_group=n_micro,
                                 overlap_own_compute_only=True)
        traces.append(StepTrace(tok, lat, 0.0, 0.0))
        if oot_s_per_token and lat > oot_s_per_token:
            return SimResult(traces, oot=True, reason=f"{lat:.1f}s/token")
    return SimResult(traces)


def simulate_edgeshard(env: CostEnv, n_layers: int, n_tokens: int, *,
                       n_micro: int = 1, prompt: int = 64,
                       oot_s_per_token: Optional[float] = None) -> SimResult:
    return simulate_pp(env, n_layers, n_tokens, n_micro=n_micro,
                       by_compute=True, prompt=prompt,
                       oot_s_per_token=oot_s_per_token)


# ----------------------------------------------------------------------------
# TP family: Galaxy / TPI-LLM / TPI-LLM+offload
# ----------------------------------------------------------------------------
def _tp_step(env: CostEnv, n_layers: int, ctx: int, n_micro: int, *,
             stream_bytes_per_dev: float = 0.0, window_overlap: float = 1.0,
             recompute: bool = True, seq_parallel: bool = False,
             shards: Optional[Sequence[float]] = None) -> float:
    """One token step of tensor-parallel decoding across all devices."""
    w = env.work
    D = len(env.devices)
    # compute: every layer split over devices; slowest shard gates the layer
    shard = max(w.comp_layer(d) for d in env.devices) / D
    comp = n_layers * shard * n_micro
    # comms: 2 allreduce per layer; ring allreduce moves 2(D-1)/D x h_size
    # across 2(D-1) sequential messages (the latency term is what kills TP
    # on edge LANs — the paper's motivation, Fig. 2a)
    ar = 2 * (D - 1) / D * (w.h_size * n_micro) / env.bw_net \
        + 2 * (D - 1) * env.net_latency
    n_ar = 1 if seq_parallel else 2     # Galaxy's SP halves sync points
    comm = n_layers * n_ar * ar
    # sliding-window weight streaming (TPI-LLM stages from host RAM)
    stream = 0.0
    if stream_bytes_per_dev > 0:
        per_dev = [stream_bytes_per_dev / (d.host_bw or d.load_bw)
                   for d in env.devices]
        stream = max(per_dev)
        stream = max(stream - window_overlap * (comp + comm), 0.0)
    rec = 0.0
    if recompute:
        total = w.cfg.total_params() * 2
        for i, d in enumerate(env.devices):
            sh = shards[i] if shards is not None else total / D
            mem_free = d.mem_bytes - sh
            rec = max(rec, _kv_overflow_recompute(env, n_layers / D, ctx, i,
                                                  max(mem_free, 0.0)))
    return comp + comm + stream + rec


def simulate_galaxy(env: CostEnv, n_layers: int, n_tokens: int, *,
                    n_micro: int = 1, prompt: int = 64,
                    oot_s_per_token: Optional[float] = None) -> SimResult:
    w = env.work
    total = w.cfg.total_params() * 2
    D = len(env.devices)
    kv_reserve = 512 * w.kv_bytes_per_token_layer() * n_layers / D
    # Galaxy's workload partitioner: shards proportional to compute, capped
    # by memory, overflow waterfalled to devices with headroom.
    speeds = [d.flops for d in env.devices]
    tot_speed = sum(speeds)
    shards = [total * s / tot_speed for s in speeds]
    caps = [max(d.mem_bytes - kv_reserve, 0.0) for d in env.devices]
    for _ in range(D):
        over = sum(max(sh - c, 0.0) for sh, c in zip(shards, caps))
        if over <= 1e-6:
            break
        head = [(c - sh) for sh, c in zip(shards, caps)]
        room = sum(max(h, 0.0) for h in head)
        if room < over:
            return SimResult([], oom=True,
                             reason="aggregate memory below model size")
        shards = [min(sh, c) for sh, c in zip(shards, caps)]
        for i in range(D):
            if head[i] > 0:
                shards[i] += over * max(head[i], 0.0) / room
    if any(sh > c + 1e-6 for sh, c in zip(shards, caps)):
        return SimResult([], oom=True, reason="TP shard exceeds device memory")
    traces = []
    for tok in range(n_tokens):
        lat = _tp_step(env, n_layers, prompt + tok, n_micro,
                       seq_parallel=True, shards=shards)
        traces.append(StepTrace(tok, lat, 0.0, 0.0))
        if oot_s_per_token and lat > oot_s_per_token:
            return SimResult(traces, oot=True, reason=f"{lat:.1f}s/token")
    return SimResult(traces)


def simulate_tpi_llm(env: CostEnv, n_layers: int, n_tokens: int, *,
                     n_micro: int = 1, offload_variant: bool = False,
                     prompt: int = 64,
                     oot_s_per_token: Optional[float] = None) -> SimResult:
    w = env.work
    total = w.cfg.total_params() * 2
    traces = []
    for tok in range(n_tokens):
        ctx = prompt + tok
        lat = 0.0
        for i, d in enumerate(env.devices):
            shard = total / len(env.devices)
            kv = ctx * w.kv_bytes_per_token_layer() * n_layers \
                / len(env.devices)
            window = max(d.mem_bytes - (kv if offload_variant else 0.0), 0.0)
            window = min(window, shard)
            lat = max(lat, max(shard - window, 0.0)
                      / (d.host_bw or d.load_bw))
        step = _tp_step(env, n_layers, ctx, n_micro,
                        recompute=not offload_variant)
        # streaming overlaps compute+comm (TPI-LLM's prefetch)
        lat = step + max(lat - step, 0.0)
        traces.append(StepTrace(tok, lat, 0.0, 0.0))
        if oot_s_per_token and lat > oot_s_per_token:
            return SimResult(traces, oot=True, reason=f"{lat:.1f}s/token")
    return SimResult(traces)


# ----------------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------------
BASELINES = {
    "pp": simulate_pp,
    "pp+offload": simulate_pp_offload,
    "edgeshard": simulate_edgeshard,
    "galaxy": simulate_galaxy,
    "tpi-llm": simulate_tpi_llm,
    "tpi-llm+offload": lambda env, L, n, **kw: simulate_tpi_llm(
        env, L, n, offload_variant=True, **kw),
}
