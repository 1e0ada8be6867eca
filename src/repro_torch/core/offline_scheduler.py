"""Fine-grained offline allocation scheduler (counterpart of
``repro.core.offline_scheduler``, paper §IV-C, Alg. 1).

Three phases, as the paper orders them:

  1. Greedy resident fill (Alg. 1 lines 28-31): every device takes as many
     fully-resident layers as its memory allows, after reserving KV room
     for the empirical sequence length `n_emp` and a one-layer load buffer.
  2. For each feasible segment count #Seg (line 32): a per-segment DP
     (SegmentAllocation, lines 1-11) assigns the remaining layers' loads
     to devices minimising accumulated uncovered delay:
         F_allo(l, i) = min_k max(0, F_allo(l-k, i-1) + load_i(k) - T_i^idle)
     with backtracking through P_pre.
  3. Block refinement (lines 12-27): while the bottleneck device has
     leftover memory for an MHA or MLP block, pin that block resident so
     only the complement is re-loaded each segment; pinning costs
     (#Seg - 1) extra copies of the block (Eq. 7's factor).

The best (#Seg, allocation) under T_comp + T_comm + T_uncover wins (lines
33-39). The JAX package's code, unchanged: the same CostEnv gives the
same plan and the same candidates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.core.cost_model import CostEnv, ExecutionPlan, StageAlloc

INF = float("inf")


@dataclasses.dataclass
class ScheduleResult:
    plan: Optional[ExecutionPlan]
    feasible: bool
    reason: str = ""
    candidates: Tuple = ()      # (n_seg, t_total) for every evaluated #Seg


# ----------------------------------------------------------------------------
# Phase 1: greedy resident fill
# ----------------------------------------------------------------------------
def _greedy_fill(env: CostEnv, n_layers: int, n_emp: int,
                 reserve_buffer: bool) -> Tuple[List[int], int]:
    """Resident layer counts per device (Alg. 1 line 28), filling the
    fastest devices first so leftover layers land where the most idle
    time exists; returns (res, left)."""
    w = env.work
    kv_per_layer = n_emp * w.kv_bytes_per_token_layer()
    order = sorted(range(len(env.devices)),
                   key=lambda i: w.comp_layer(env.devices[i]))
    res = [0] * len(env.devices)
    left = n_layers
    for i in order:
        mem = env.devices[i].mem_bytes
        if reserve_buffer:
            mem -= w.l_size          # one-layer load buffer for offloading
        cap = int(mem // (w.l_size + kv_per_layer))
        take = max(min(cap, left), 0)
        res[i] = take
        left -= take
    return res, left


def _balance_residents(env: CostEnv, n_layers: int, n_emp: int
                       ) -> Optional[List[int]]:
    """No-offload path: compute-balanced layer counts under memory caps
    (a refinement beyond the paper; allocate(..., balance=False) keeps
    the literal memory-greedy fill)."""
    w = env.work
    kv_per_layer = n_emp * w.kv_bytes_per_token_layer()
    caps = [int(d.mem_bytes // (w.l_size + kv_per_layer))
            for d in env.devices]
    if sum(caps) < n_layers:
        return None
    speeds = [1.0 / w.comp_layer(d) for d in env.devices]
    tot = sum(speeds)
    alloc = [min(int(round(n_layers * s / tot)), c)
             for s, c in zip(speeds, caps)]
    diff = n_layers - sum(alloc)
    k = 0
    order = sorted(range(len(alloc)), key=lambda i: speeds[i], reverse=True)
    while diff != 0 and k < 8 * len(alloc):
        i = order[k % len(alloc)]
        step = 1 if diff > 0 else -1
        if 0 <= alloc[i] + step <= caps[i]:
            alloc[i] += step
            diff -= step
        k += 1
    return alloc if diff == 0 else None


# ----------------------------------------------------------------------------
# Phase 2: per-segment DP (Alg. 1 SegmentAllocation, lines 1-11)
# ----------------------------------------------------------------------------
def _offload_cap(env: CostEnv, plan: ExecutionPlan, i: int,
                 n_emp: int) -> int:
    """Max offloaded layers (per segment) device i can take: each costs a
    load-buffer slot (1 copy of weights) plus n_seg segments' worth of KV."""
    w = env.work
    d = plan.stages[i]
    kv_layer = n_emp * w.kv_bytes_per_token_layer()
    used = (d.resident_total * (w.l_size + kv_layer))
    free = env.devices[i].mem_bytes - used
    per_off = w.l_size + plan.n_seg * kv_layer
    return max(int(free // per_off), 0)


def _segment_dp(env: CostEnv, plan: ExecutionPlan, n_left_seg: int,
                n_emp: int) -> Optional[List[int]]:
    """Assign `n_left_seg` offloaded layers (one segment's worth) to devices.
    Returns per-device counts k_i (sum = n_left_seg) minimising accumulated
    uncovered delay, or None if memory-infeasible everywhere."""
    D = len(env.devices)
    w = env.work
    idle = [env.idle_seg(plan, i) for i in range(D)]
    load1 = [env.load_time(i, w.l_size) for i in range(D)]
    caps = [_offload_cap(env, plan, i, n_emp) for i in range(D)]

    # F[l][i]: min accumulated uncovered delay, first l layers on first i+1 devs
    F = [[INF] * D for _ in range(n_left_seg + 1)]
    P = [[0] * D for _ in range(n_left_seg + 1)]
    for l in range(n_left_seg + 1):                       # device 0 (Eq. 3)
        if l <= caps[0]:
            F[l][0] = max(0.0, l * load1[0] - idle[0])
            P[l][0] = l
    for i in range(1, D):                                 # Eq. 4
        for l in range(n_left_seg + 1):
            for k in range(min(l, caps[i]) + 1):
                prev = F[l - k][i - 1]
                if prev == INF:
                    continue
                t_cur = max(0.0, prev + k * load1[i] - idle[i])
                if t_cur <= F[l][i]:
                    F[l][i] = t_cur
                    P[l][i] = k
    if F[n_left_seg][D - 1] == INF:
        return None
    counts = [0] * D
    l = n_left_seg
    for i in range(D - 1, -1, -1):
        counts[i] = P[l][i]
        l -= counts[i]
    return counts


# ----------------------------------------------------------------------------
# Phase 3: fine-grained block refinement (Alg. 1 lines 12-27)
# ----------------------------------------------------------------------------
def _refine_blocks(env: CostEnv, plan: ExecutionPlan, n_emp: int) -> None:
    """Pin MHA/MLP blocks of offloaded layers resident on the bottleneck
    device while memory allows, shaving its per-segment load time."""
    w = env.work
    n_seg = plan.n_seg

    def free_mem(i: int) -> float:
        d = plan.stages[i]
        used = (d.resident_bytes(w, n_seg)
                + env.kv_reserve_bytes(d.layers_total(n_seg), n_emp))
        return env.devices[i].mem_bytes - used

    def uncovered(i: int) -> float:
        d = plan.stages[i]
        return max(env.load_time(i, d.load_bytes_seg(w))
                   - env.idle_seg(plan, i), 0.0)

    while True:
        # bottleneck device = max uncovered load (the term T_uncover tracks)
        order = sorted(range(len(plan.stages)), key=uncovered, reverse=True)
        i = order[0]
        if uncovered(i) <= 0.0:
            break
        d = plan.stages[i]
        mem = free_mem(i)
        extra = n_seg - 1          # pinned block copies beyond the load buffer
        if d.off_full_seg >= 1 and mem >= extra * w.mlp_block_bytes \
                and w.p_M >= w.p_A:
            d.off_full_seg -= 1
            d.off_attn_only_seg += 1        # MLP pinned, MHA still loaded
        elif d.off_full_seg >= 1 and mem >= extra * w.attn_block_bytes:
            d.off_full_seg -= 1
            d.off_mlp_only_seg += 1         # MHA pinned, MLP still loaded
        elif d.off_full_seg >= 1 and mem >= extra * w.mlp_block_bytes:
            d.off_full_seg -= 1
            d.off_attn_only_seg += 1
        elif d.off_attn_only_seg >= 1 and mem >= extra * w.attn_block_bytes:
            # complete the layer: pin the remaining MHA -> fully resident
            d.off_attn_only_seg -= 1
            d.resident_total += n_seg       # one layer per segment now resident
        elif d.off_mlp_only_seg >= 1 and mem >= extra * w.mlp_block_bytes:
            d.off_mlp_only_seg -= 1
            d.resident_total += n_seg
        else:
            break                  # bottleneck can't improve: optimal bound


# ----------------------------------------------------------------------------
# Entry point (Alg. 1 main, lines 28-39)
# ----------------------------------------------------------------------------
def allocate(env: CostEnv, n_layers: int, *, n_emp: int = 512,
             max_seg: Optional[int] = None,
             balance: bool = True) -> ScheduleResult:
    """Run Alg. 1 for `n_layers` decoder layers on `env.devices`."""
    D = len(env.devices)
    # No-offload path first: if the model + KV reserve fits outright, a
    # resident pipeline strictly dominates any offloading plan (zero load).
    res2 = _balance_residents(env, n_layers, n_emp) if balance else None
    if res2 is None:
        res2, left2 = _greedy_fill(env, n_layers, n_emp, reserve_buffer=False)
        if left2:
            res2 = None
    if res2 is not None:
        plan = ExecutionPlan(n_seg=1, stages=[StageAlloc(r) for r in res2])
        env.evaluate(plan)
        if env.mem_ok(plan, n_emp):
            return ScheduleResult(plan, True, "fits without offloading",
                                  ((1, plan.t_total),))
    res, left = _greedy_fill(env, n_layers, n_emp, reserve_buffer=True)

    if left > 0 and all(r == 0 for r in res) and left > n_layers:
        return ScheduleResult(None, False, "devices cannot hold any layer")

    # Offloading path: evaluate every feasible segment count (line 32).
    hi = max_seg or max(2, min(left, math.ceil(n_layers / max(D, 1))))
    hi = max(hi, 2)
    best: Optional[ExecutionPlan] = None
    cands = []
    for n_seg in range(2, hi + 1):
        per_seg = math.ceil(left / n_seg)   # even split; short last segment
        plan = ExecutionPlan(n_seg=n_seg,
                             stages=[StageAlloc(r) for r in res],
                             off_trim=per_seg * n_seg - left)
        counts = _segment_dp(env, plan, per_seg, n_emp)
        if counts is None:
            continue
        for i, k in enumerate(counts):
            plan.stages[i].off_full_seg = k
        # memory feasibility: load buffer sized by the DP result
        if not env.mem_ok(plan, n_emp):
            continue
        _refine_blocks(env, plan, n_emp)
        env.evaluate(plan)
        cands.append((n_seg, plan.t_total))
        if best is None or plan.t_total < best.t_total:
            best = plan
    if best is None:
        return ScheduleResult(None, False,
                              "no feasible (#Seg, allocation) found",
                              tuple(cands))
    return ScheduleResult(best, True, "", tuple(cands))


def allocate_with_retry(mk_env, n_layers: int, *, n_emp: int = 512,
                        max_seg: Optional[int] = None, balance: bool = True,
                        factor: float = 1.4, max_scale: float = 16.0
                        ) -> Tuple[ScheduleResult, CostEnv, float]:
    """allocate() under a feasibility-relaxation ladder: `mk_env(scale)`
    builds the CostEnv at a memory relaxation `scale`, starting at 1.0 and
    multiplying by `factor` until allocate() finds a feasible plan or
    `scale` exceeds `max_scale`. Returns (result, env, scale);
    `result.feasible` is False only if even max_scale failed."""
    scale = 1.0
    env = mk_env(scale)
    r = allocate(env, n_layers, n_emp=n_emp, max_seg=max_seg,
                 balance=balance)
    while not r.feasible and scale < max_scale:
        scale *= factor
        env = mk_env(scale)
        r = allocate(env, n_layers, n_emp=n_emp, max_seg=max_seg,
                     balance=balance)
    return r, env, scale
