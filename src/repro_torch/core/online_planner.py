"""Online memory-aware planner (counterpart of
``repro.core.online_planner``, paper §IV-D, Eq. 5-7, Fig. 9).

As the KV cache grows during decoding, each device eventually cannot hold
its resident weights *and* the cache. The planner pre-computes, per
device, a ladder of thresholds TS_i^j (total generated-token counts) with
an offload plan (α MHA blocks, β MLP blocks evicted from residency)
attached to each. Plans are absolute states, re-solved per threshold with
objective Eq. 6 (minimise the per-segment load the plan adds) under Eq. 7
(the freed (#Seg-1) block copies must cover the KV growth to the next
threshold). The same plan applies to every segment.

The JAX package's code, unchanged. The serving backend maps a fired
(α, β) onto the engine's whole-layer tier boundary: max(α, β) resident
slots demoted (``EngineBackend._retier_to``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.core.cost_model import CostEnv, ExecutionPlan


@dataclasses.dataclass(frozen=True)
class OffloadPlanStep:
    threshold_tokens: int      # TS_i^j: trigger when total tokens reach this
    alpha: int                 # MHA blocks offloaded (absolute, per segment)
    beta: int                  # MLP blocks offloaded (absolute, per segment)
    extra_load_bytes: float    # added per-segment load this plan causes


@dataclasses.dataclass
class DevicePlannerState:
    dev_idx: int
    plan_idx: int = 0          # next threshold to trigger
    alpha: int = 0             # currently offloaded MHA blocks
    beta: int = 0              # currently offloaded MLP blocks
    last_eff: int = 0          # last effective token count seen (rebuild
                               # re-anchors plan_idx to this occupancy)


def _min_load_plan(need_bytes: float, attn_b: float, mlp_b: float,
                   a_max: int, b_max: int, n_seg: int
                   ) -> Optional[Tuple[int, int]]:
    """Smallest extra per-segment load (Eq. 6) with freed >= need (Eq. 7)."""
    factor = max(n_seg - 1, 1)
    best = None
    best_load = float("inf")
    for a in range(a_max + 1):
        freed_a = a * attn_b * factor
        rem = max(need_bytes - freed_a, 0.0)
        b = min(int(math.ceil(rem / (mlp_b * factor))) if rem > 0 else 0,
                b_max)
        if freed_a + b * mlp_b * factor + 1e-9 < need_bytes:
            continue
        load = a * attn_b + b * mlp_b
        if load < best_load:
            best_load, best = load, (a, b)
    return best


class OnlinePlanner:
    """Builds and walks the TS-ladder for every device of a plan."""

    def __init__(self, env: CostEnv, plan: ExecutionPlan, *, horizon_tokens: int,
                 ladder_chunk_tokens: int = 256):
        self.env = env
        self.plan = plan
        self.work = env.work
        self.chunk = ladder_chunk_tokens
        self.base_chunk = ladder_chunk_tokens
        self.horizon = horizon_tokens
        self.rebuilds = 0
        self.states = [DevicePlannerState(i)
                       for i in range(len(plan.stages))]
        self.ladders: List[List[OffloadPlanStep]] = [
            self._build_ladder(i, horizon_tokens)
            for i in range(len(plan.stages))]
        # SLO pressure: 0 when healthy; a breaching SLO engine pushes
        # (1 - health) here, which scales the effective token count so
        # thresholds fire early
        self.slo_pressure = 0.0

    def note_slo_pressure(self, pressure: float) -> None:
        """Adopt the serving layer's SLO pressure in [0, 1] (clamped)."""
        self.slo_pressure = min(max(pressure, 0.0), 1.0)

    # -- memory bookkeeping ---------------------------------------------------
    def _free_bytes(self, i: int, alpha: int, beta: int) -> float:
        d = self.plan.stages[i]
        w = self.work
        base = d.resident_bytes(w, self.plan.n_seg)
        freed = (alpha * w.attn_block_bytes + beta * w.mlp_block_bytes) \
            * max(self.plan.n_seg - 1, 1)
        return self.env.devices[i].mem_bytes - (base - freed)

    def _kv_per_token(self, i: int) -> float:
        d = self.plan.stages[i]
        return (d.layers_total(self.plan.n_seg)
                * self.work.kv_bytes_per_token_layer())

    def _block_budget(self, i: int) -> Tuple[int, int]:
        """How many MHA/MLP blocks device i can still evict (per segment):
        its resident layers contribute both blocks; already-split layers
        contribute their pinned half."""
        d = self.plan.stages[i]
        res_seg = d.resident_total // max(self.plan.n_seg, 1)
        a_max = res_seg + d.off_mlp_only_seg      # resident MHA halves
        b_max = res_seg + d.off_attn_only_seg     # resident MLP halves
        return a_max, b_max

    # -- Eq. 5 + ladder construction -------------------------------------------
    def _build_ladder(self, i: int, horizon: int) -> List[OffloadPlanStep]:
        w = self.work
        kv_tok = self._kv_per_token(i)
        if kv_tok <= 0:
            return []
        a_max, b_max = self._block_budget(i)
        ladder: List[OffloadPlanStep] = []
        free0 = self._free_bytes(i, 0, 0)                  # no eviction yet
        alpha = beta = 0
        while True:
            free = self._free_bytes(i, alpha, beta)
            ts = int(free // kv_tok)                       # Eq. 5 (TS^1) / next
            if ts >= horizon:
                break
            # new absolute plan must hold KV through the next chunk (Eq. 7)
            target = min(ts + self.chunk, horizon)
            need = target * kv_tok - free0
            nxt = _min_load_plan(need, w.attn_block_bytes, w.mlp_block_bytes,
                                 a_max, b_max, self.plan.n_seg)
            if nxt is None or nxt == (alpha, beta):
                break                                       # out of blocks
            alpha, beta = nxt
            ladder.append(OffloadPlanStep(
                threshold_tokens=max(ts, 0), alpha=alpha, beta=beta,
                extra_load_bytes=(alpha * w.attn_block_bytes
                                  + beta * w.mlp_block_bytes)))
        return ladder

    # -- runtime ---------------------------------------------------------------
    def on_token(self, total_tokens: int,
                 transferred: Optional[List[int]] = None
                 ) -> List[Tuple[int, OffloadPlanStep]]:
        """Returns [(dev_idx, plan_step)] for plans triggered at this count.
        `transferred[i]` = KV tokens device i has delegated away (Alg. 2):
        they delay *its* thresholds."""
        fired = []
        for st in self.states:
            lad = self.ladders[st.dev_idx]
            eff = total_tokens - (transferred[st.dev_idx]
                                  if transferred else 0)
            if self.slo_pressure > 0.0:
                # under SLO stress act as if occupancy were up to 2x
                eff = int(eff * (1.0 + self.slo_pressure))
            st.last_eff = max(st.last_eff, int(eff))
            while st.plan_idx < len(lad) \
                    and eff >= lad[st.plan_idx].threshold_tokens:
                step = lad[st.plan_idx]
                st.alpha, st.beta = step.alpha, step.beta
                st.plan_idx += 1
                fired.append((st.dev_idx, step))
        return fired

    def rebuild(self, env: Optional[CostEnv] = None, *,
                chunk_scale: float = 1.0) -> None:
        """Recompute every TS ladder against an updated CostEnv (the online
        re-fit's hook). `chunk_scale` = measured / planned load bandwidth
        scales the ladder chunk. Physical state is preserved: alpha/beta
        never decrease across a rebuild, and plan_idx re-anchors to each
        device's last effective occupancy so passed thresholds do not
        re-fire."""
        if env is not None:
            self.env = env
            self.work = env.work
        self.chunk = max(32, int(round(self.base_chunk
                                       * min(max(chunk_scale, 0.1), 10.0))))
        self.ladders = [self._build_ladder(i, self.horizon)
                        for i in range(len(self.plan.stages))]
        for st in self.states:
            lad = self.ladders[st.dev_idx]
            idx = 0
            while idx < len(lad) and st.last_eff >= lad[idx].threshold_tokens:
                idx += 1
            st.plan_idx = idx
            if idx > 0:
                st.alpha = max(st.alpha, lad[idx - 1].alpha)
                st.beta = max(st.beta, lad[idx - 1].beta)
        self.rebuilds += 1

    def on_pages(self, pages_in_use: int, page_size: int,
                 transferred: Optional[List[int]] = None
                 ) -> List[Tuple[int, OffloadPlanStep]]:
        """Page-granular entry: walk the TS ladder on allocated KV
        occupancy, pages_in_use × page_size tokens (page-rounding slack
        included)."""
        return self.on_token(pages_in_use * page_size, transferred)

    def extra_load_bytes_seg(self, i: int) -> float:
        st = self.states[i]
        w = self.work
        return st.alpha * w.attn_block_bytes + st.beta * w.mlp_block_bytes

    def next_threshold(self, i: int) -> Optional[int]:
        lad = self.ladders[i]
        st = self.states[i]
        return lad[st.plan_idx].threshold_tokens \
            if st.plan_idx < len(lad) else None
