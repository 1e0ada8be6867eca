"""Offload-oriented cost model for the interleaved pipeline (counterpart of
``repro.core.cost_model``, paper §IV-B).

All quantities are *per autoregressive step* unless suffixed ``_seg`` (per
segment). The paper's Eq. 1/2 terms with the per-segment reading that
makes them internally consistent:

    T_total  = T_comp + T_comm + T_uncover
    T_comp   = Σ_i comp(L_i)                      (all segments)
    T_comm   = #Seg · |D| · h_size / bw_net
    T_uncover= #Seg · max_i max(load_seg(L̃_i) − T_i^idle_seg, 0)
    T_i^idle = comp_seg(L_i − L̃_i) + Σ_{i'≠i} comp_seg(L_i') + |D|·h/bw  (Eq.2)

A layer's step time on a device is max(FLOPs / flops, bytes / mem_bw).
One ``ExecutionPlan`` serves the cost model, Alg. 1, the online planner
and the engine: a plan cuts the L layers into C = n_seg · n_stage
contiguous chunks; chunk c runs on stage c mod n_stage and holds that
stage's resident layers (k_res, one fewer in the last segments where
resident_total does not divide them) followed by its k_off streamed
ones. The
block-split fields (a layer whose MLP or attention block stays resident)
are priced here; the engine streams such a layer whole, as the JAX engine
does. The formulas are the JAX package's, unchanged, so both packages
price a plan alike: ``StageAlloc.resident_bytes`` counts one segment's
whole streamed set as the load buffer, where the port's engine holds two
one-layer buffers (``engine.weight_budget``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.profiles import DeviceProfile

DTYPE_BYTES = 2  # fp16/bf16 weights + KV


# ============================================================================
# Workload: what one decoder layer costs for a given micro-batch / context
# ============================================================================
@dataclasses.dataclass(frozen=True)
class Workload:
    """One auto-regressive step for `mb` sequences at context length `ctx`."""
    cfg: ModelConfig
    mb: int                     # micro-batch size (tokens per step per stage)
    ctx: int                    # current context length (KV read span)
    n_micro: int = 1            # micro-batches in flight (bursty: |D|)

    # ---- model-side sizes (paper Tab. I symbols) ----
    @property
    def l_size(self) -> float:
        """Bytes of one decoder layer (average over depth)."""
        n = self.cfg.n_layers
        tot = sum(self.cfg.layer_params(i) for i in range(n))
        return tot / n * DTYPE_BYTES

    @property
    def attn_block_bytes(self) -> float:
        return self.cfg.attn_params_per_layer() * DTYPE_BYTES

    @property
    def mlp_block_bytes(self) -> float:
        return self.cfg.mlp_params_per_layer() * DTYPE_BYTES

    @property
    def p_A(self) -> float:
        return self.cfg.p_A()

    @property
    def p_M(self) -> float:
        return self.cfg.p_M()

    @property
    def h_size(self) -> float:
        """Intermediate activation bytes handed between devices (per mb)."""
        return self.mb * self.cfg.d_model * DTYPE_BYTES

    def kv_bytes_per_token_layer(self) -> float:
        """KV-cache bytes one token adds on one layer (whole micro-batch set)."""
        c = self.cfg
        if c.is_attention_free:
            return 0.0
        per_seq = 2 * c.n_kv_heads * (c.head_dim or 0) * DTYPE_BYTES
        return per_seq * self.mb * self.n_micro

    # ---- per-layer step cost on a device ----
    def layer_flops(self) -> float:
        """FLOPs of one layer for one step of `mb` tokens (active params)."""
        c = self.cfg
        if c.is_moe:
            dff = c.moe_d_ff or c.d_ff
            mlp = (c.top_k + c.n_shared_experts) * 3 * c.d_model * dff
        else:
            mlp = 3 * c.d_model * c.d_ff
        dense = c.attn_params_per_layer() + mlp
        flops = 2.0 * dense * self.mb
        if not c.is_attention_free:
            # attention reads: q·K^T and P·V over the live context
            span = min(self.ctx, c.window_size) \
                if c.attn_kind.value in ("sliding",) else self.ctx
            flops += 4.0 * self.mb * span * c.n_heads * (c.head_dim or 0)
        return flops

    def layer_bytes_touched(self, resident_bytes: Optional[float] = None) -> float:
        """HBM traffic of one layer step: active weights + KV read."""
        c = self.cfg
        if c.is_moe:
            dff = c.moe_d_ff or c.d_ff
            active = (c.attn_params_per_layer()
                      + min(self.mb * c.top_k, c.n_experts) * 3 * c.d_model * dff
                      + c.n_shared_experts * 3 * c.d_model * dff) * DTYPE_BYTES
        else:
            active = self.l_size if resident_bytes is None else resident_bytes
        kv = self.kv_bytes_per_token_layer() / max(self.n_micro, 1) * self.ctx \
            / max(self.mb, 1) * self.mb  # read whole per-mb KV span
        return active + kv

    def comp_layer(self, dev: DeviceProfile) -> float:
        """Seconds for one layer's step on `dev` (roofline max of terms)."""
        return max(self.layer_flops() / dev.flops,
                   self.layer_bytes_touched() / dev.mem_bw)


# ============================================================================
# ExecutionPlan (output of the offline scheduler, input to the engine)
# ============================================================================
@dataclasses.dataclass
class StageAlloc:
    """Per-stage allocation. Counts are *per segment* for offloaded layers
    (the interleave repeats the same shape every segment, paper Fig. 6).
    The cost model prices the block-granular fields; the engine reads the
    whole-layer view (`k_res` / `k_off`)."""
    resident_total: int          # fully-resident layers (across all segments)
    off_full_seg: int = 0        # layers fully (re)loaded, per segment
    off_attn_only_seg: int = 0   # MLP resident, MHA loaded, per segment
    off_mlp_only_seg: int = 0    # MHA resident, MLP loaded, per segment

    def off_layers_seg(self) -> int:
        return self.off_full_seg + self.off_attn_only_seg + self.off_mlp_only_seg

    def layers_total(self, n_seg: int) -> int:
        return self.resident_total + n_seg * self.off_layers_seg()

    def load_bytes_seg(self, w: Workload) -> float:
        return (self.off_full_seg * w.l_size
                + self.off_attn_only_seg * w.attn_block_bytes
                + self.off_mlp_only_seg * w.mlp_block_bytes)

    def resident_bytes(self, w: Workload, n_seg: int) -> float:
        """Weight bytes held simultaneously: fully-resident layers + one
        segment's offload buffer + the resident halves of split layers."""
        split_res = (self.off_attn_only_seg * w.mlp_block_bytes
                     + self.off_mlp_only_seg * w.attn_block_bytes) * n_seg
        return (self.resident_total * w.l_size
                + self.load_bytes_seg(w)        # double-buffer: one segment live
                + split_res)

    # -- engine-facing whole-layer view ---------------------------------------
    def k_res(self, n_seg: int) -> int:
        """Resident slots per chunk (ceil: where resident_total does not
        divide the segments, the engine's layout leaves one slot of the
        last segments' chunks empty, so it still holds resident_total)."""
        return -(-self.resident_total // max(n_seg, 1))

    @property
    def k_off(self) -> int:
        """Streamed layers per chunk (block-split layers stream whole)."""
        return self.off_layers_seg()


@dataclasses.dataclass
class ExecutionPlan:
    """The plan: emitted by Alg. 1 (or plan_for's budget rule), priced by
    CostEnv, executed by the InterleavedEngine."""
    n_seg: int
    stages: List[StageAlloc]
    t_comp: float = 0.0
    t_comm: float = 0.0
    t_uncover: float = 0.0
    off_trim: int = 0           # padding overshoot when #Seg ∤ |L_left|

    # -- cost view -------------------------------------------------------------
    @property
    def devices(self) -> List[StageAlloc]:
        """Historical alias (device == pipeline stage)."""
        return self.stages

    @property
    def t_total(self) -> float:
        return self.t_comp + self.t_comm + self.t_uncover

    def layers_total(self) -> int:
        return sum(st.layers_total(self.n_seg)
                   for st in self.stages) - self.off_trim

    # -- engine-facing geometry -------------------------------------------------
    @property
    def n_stage(self) -> int:
        return len(self.stages)

    @property
    def n_chunks(self) -> int:
        return self.n_seg * self.n_stage

    @property
    def k_res_list(self):
        return tuple(st.k_res(self.n_seg) for st in self.stages)

    @property
    def k_off_list(self):
        return tuple(st.k_off for st in self.stages)

    @property
    def k_max(self) -> int:
        return max(r + o for r, o in zip(self.k_res_list, self.k_off_list))

    @property
    def n_layers(self) -> int:
        """Grid capacity (>= layers_total when resident counts do not
        divide the segments; the overhang is identity padding)."""
        return self.n_seg * sum(r + o for r, o in
                                zip(self.k_res_list, self.k_off_list))

    @property
    def is_uniform(self) -> bool:
        return len({(st.resident_total, st.off_full_seg,
                     st.off_attn_only_seg, st.off_mlp_only_seg)
                    for st in self.stages}) <= 1

    @property
    def k_res(self) -> int:
        assert self.is_uniform, "k_res is per-stage on heterogeneous plans"
        return self.stages[0].k_res(self.n_seg)

    @property
    def k_off(self) -> int:
        assert self.is_uniform, "k_off is per-stage on heterogeneous plans"
        return self.stages[0].k_off

    @property
    def k(self) -> int:
        return self.k_res + self.k_off

    @classmethod
    def uniform(cls, n_stage: int, n_seg: int, k_res: int,
                k_off: int) -> "ExecutionPlan":
        return cls(n_seg=n_seg,
                   stages=[StageAlloc(resident_total=k_res * n_seg,
                                      off_full_seg=k_off)
                           for _ in range(n_stage)])


# ============================================================================
# Cost environment: devices + network + workload  ->  Eq. 1 terms
# ============================================================================
@dataclasses.dataclass
class CostEnv:
    devices: Sequence[DeviceProfile]
    bw_net: float                      # bytes/s between any two devices
    work: Workload
    net_latency: float = 1e-3          # per-message latency

    # -- building blocks -----------------------------------------------------
    def replace_device(self, dev_idx: int, dev: DeviceProfile) -> "CostEnv":
        """A copy of this env with one device swapped (a measured drift
        folded into the planning model without mutating shared state)."""
        devs = list(self.devices)
        devs[dev_idx] = dev
        return dataclasses.replace(self, devices=devs)

    def comp_layers(self, dev_idx: int, n_layers: float) -> float:
        return n_layers * self.work.comp_layer(self.devices[dev_idx])

    def load_time(self, dev_idx: int, nbytes: float) -> float:
        return nbytes / self.devices[dev_idx].load_bw

    def comm_seg(self) -> float:
        """One segment's activation ring: |D| hops of h_size (Eq. 1)."""
        return len(self.devices) * (self.work.h_size / self.bw_net
                                    + self.net_latency)

    # -- Eq. 2: per-device overlap budget within one segment ------------------
    def idle_seg(self, plan: ExecutionPlan, i: int) -> float:
        d = plan.stages[i]
        own_nonoff = self.comp_layers(i, d.resident_total / plan.n_seg)
        others = sum(
            self.comp_layers(j, plan.stages[j].layers_total(plan.n_seg)
                             / plan.n_seg)
            for j in range(len(plan.stages)) if j != i)
        return own_nonoff + others + self.comm_seg()

    # -- Eq. 1: total latency of a plan ---------------------------------------
    def evaluate(self, plan: ExecutionPlan) -> ExecutionPlan:
        w = self.work
        plan.t_comp = sum(
            self.comp_layers(i, plan.stages[i].layers_total(plan.n_seg))
            for i in range(len(plan.stages)))
        plan.t_comm = plan.n_seg * self.comm_seg()
        unc = 0.0
        for i, d in enumerate(plan.stages):
            load = self.load_time(i, d.load_bytes_seg(w))
            unc = max(unc, max(load - self.idle_seg(plan, i), 0.0))
        plan.t_uncover = plan.n_seg * unc
        return plan

    # -- memory audit ----------------------------------------------------------
    def kv_reserve_bytes(self, layers_on_dev: int, n_tokens: int) -> float:
        return layers_on_dev * n_tokens * self.work.kv_bytes_per_token_layer()

    def mem_ok(self, plan: ExecutionPlan, n_tokens: int) -> bool:
        for i, d in enumerate(plan.stages):
            used = (d.resident_bytes(self.work, plan.n_seg)
                    + self.kv_reserve_bytes(d.layers_total(plan.n_seg),
                                            n_tokens))
            if used > self.devices[i].mem_bytes + 1e-6:
                return False
        return True
