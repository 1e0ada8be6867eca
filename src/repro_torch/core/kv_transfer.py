"""Network bandwidth-sensitive KV cache transfer protocol (counterpart of
``repro.core.kv_transfer``; paper §IV-D, Alg. 2, Eq. 8, Fig. 10).

Devices whose weight-loading can't be covered by the pipeline's idle time
("low-threshold" devices) ship the KV cache of their trailing tokens to a
designated high-threshold device `d_target`, segment by segment: the block
for segment s+1 is fetched back asynchronously while segment s computes, so
a transfer only helps if it rides otherwise-idle network time. Eq. 8 sizes
the transfer to exactly the uncovered load window:

    mem(n_i^trans) = (load(L̃_i) − (T_comm + Σ_{i'≠i} comp + comp(L_i−L̃_i))) · bw

Bandwidth dynamics (Alg. 2 lines 8-18): on a bandwidth *drop* the volume is
recomputed immediately (stale volumes would stall the pipeline); on a *rise*
the volume only grows if the device is about to hit its next offload
threshold TS^{j+1} (lazy, avoids thrashing); changes below the fluctuation
threshold `n_ts` tokens are ignored.

The JAX package's code, unchanged: it touches no array, and the same
CostEnv and plan give the same volumes in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.cost_model import CostEnv, ExecutionPlan
from repro_torch.core.online_planner import OnlinePlanner


@dataclasses.dataclass
class TransferState:
    dev_idx: int
    target: Optional[int]          # d_target (None: this device IS a target)
    n_trans: int = 0               # tokens of KV currently delegated
    pending_recompute: bool = False


class KVTransferProtocol:
    def __init__(self, env: CostEnv, plan: ExecutionPlan, planner: OnlinePlanner,
                 *, n_ts: int = 16):
        self.env = env
        self.plan = plan
        self.planner = planner
        self.n_ts = n_ts
        self.bw = env.bw_net
        self.states = self._assign_targets()

    # -- Fig. 10: pair low-threshold devices with high-threshold targets ------
    def _assign_targets(self) -> List[TransferState]:
        D = len(self.plan.stages)
        thresholds = []
        for i in range(D):
            t = self.planner.next_threshold(i)
            thresholds.append(float("inf") if t is None else t)
        order = sorted(range(D), key=lambda i: thresholds[i])
        median = thresholds[order[D // 2]] if D else 0
        states = []
        # high-threshold half serve as targets, round-robin for the low half
        highs = [i for i in order if thresholds[i] >= median] or order[-1:]
        h = 0
        for i in range(D):
            if thresholds[i] >= median and i in highs:
                states.append(TransferState(i, None))
            else:
                states.append(TransferState(i, highs[h % len(highs)]))
                h += 1
        return states

    # -- Eq. 8 -----------------------------------------------------------------
    def eq8_tokens(self, i: int, bw: Optional[float] = None,
                   ctx_tokens: int = 0) -> int:
        bw = self.bw if bw is None else bw
        st = self.states[i]
        if st.target is None:
            return 0
        d = self.plan.stages[i]
        w = self.env.work
        load = self.env.load_time(
            i, d.load_bytes_seg(w) + self.planner.extra_load_bytes_seg(i))
        idle = self.env.idle_seg(self.plan, i)
        uncovered = max(load - idle, 0.0)
        kv_tok = self.planner._kv_per_token(i)
        if kv_tok <= 0:
            return 0
        n = int(uncovered * bw // kv_tok)
        if ctx_tokens:
            n = min(n, int(0.8 * ctx_tokens))   # can't ship KV we don't have
        return n

    # -- Alg. 2 lines 8-18: bandwidth reaction ----------------------------------
    def on_bandwidth(self, new_bw: float, total_tokens: int) -> Dict[int, int]:
        """Returns {dev: new n_trans} for devices whose volume changed."""
        changed = {}
        for st in self.states:
            if st.target is None:
                continue
            n_new = self.eq8_tokens(st.dev_idx, new_bw)
            if abs(n_new - st.n_trans) < self.n_ts:
                continue                                   # line 14: ignore
            if new_bw < self.bw:                           # drop: immediate
                st.n_trans = n_new
                changed[st.dev_idx] = n_new
            else:                                          # rise: lazy
                ts_next = self.planner.next_threshold(st.dev_idx)
                near = ts_next is not None and \
                    total_tokens + st.n_trans >= ts_next - 1
                if near:                                   # lines 15-17
                    st.n_trans = n_new
                    changed[st.dev_idx] = n_new
        self.bw = new_bw
        return changed

    # -- per-step effects used by the simulator ---------------------------------
    def init_transfers(self, ctx_tokens: int = 0) -> None:
        for st in self.states:
            st.n_trans = self.eq8_tokens(st.dev_idx, ctx_tokens=ctx_tokens)

    def refresh(self, ctx_tokens: int) -> None:
        """Re-solve Eq. 8 as KV pressure (and hence planner-added load)
        grows — the paper's feedback loop: more uncovered load -> more KV
        delegated -> bottleneck thresholds delayed. Volumes only grow here
        (shrinking is the bandwidth-drop path, `on_bandwidth`)."""
        for st in self.states:
            if st.target is None:
                continue
            n = self.eq8_tokens(st.dev_idx, ctx_tokens=ctx_tokens)
            if n > st.n_trans + self.n_ts:
                st.n_trans = n

    def load_reduction_bytes_seg(self, i: int) -> float:
        """Weight-load bytes per segment the delegated KV frees on device i:
        the vacated memory pins offloaded blocks resident ((#Seg-1) copies
        per pinned block — Eq. 7's factor)."""
        st = self.states[i]
        if st.target is None or st.n_trans == 0:
            return 0.0
        # the slab is away during exactly the segments whose weights must
        # stream in, so the vacated bytes pin weight blocks 1:1
        return st.n_trans * self.planner._kv_per_token(i)

    def transferred_tokens(self, i: int) -> int:
        return self.states[i].n_trans

    def transfer_time_seg(self, i: int) -> float:
        """Per-segment wire time of the delegated KV slab (ride-along; the
        simulator overlaps it with compute like the weight loads)."""
        st = self.states[i]
        if st.target is None or st.n_trans == 0:
            return 0.0
        kv_tok = self.planner._kv_per_token(i)
        return (st.n_trans * kv_tok / max(self.plan.n_seg, 1)) / self.bw

    def effective_kv_tokens(self, i: int, total_tokens: int) -> int:
        """KV tokens resident on device i after delegation (n - n_i^trans)."""
        return max(total_tokens - self.states[i].n_trans, 0)

    # -- Eq. 8 volumes as page movement (DESIGN.md §10) --------------------------
    def delegated_pages(self, page_size: int) -> int:
        """Fleet-wide delegated volume in whole pages (floor — a page only
        moves when every slot in it is delegated)."""
        total = sum(st.n_trans for st in self.states if st.target is not None)
        return total // max(page_size, 1)

    def sync_pool(self, pool) -> float:
        """Reconcile an attached PagePool's host tier with the current
        Eq. 8 volumes: delegated tokens -> pages resident on the host
        ("delegated") tier. Called by the simulator every step after
        refresh()/on_bandwidth(); returns bytes moved so the caller can
        price the wire (the volume is sized to ride idle network time, so
        it adds traffic, not latency). Best-effort: clamped to the pages
        actually in use and the host tier's capacity."""
        from repro_torch.kvcache.pool import HOST, DEVICE
        target = self.delegated_pages(pool.page_size)
        # can't delegate KV that doesn't exist: Eq. 8 sums per-device
        # volumes over the fleet, the pool holds the admitted streams
        total = pool.pages_in_use(HOST) + pool.pages_in_use(DEVICE)
        target = min(target, total)
        cur = pool.pages_in_use(HOST)
        if target > cur:
            return pool.migrate_any(target - cur, HOST)
        if target < cur:                    # bandwidth drop shrank Eq. 8
            return pool.migrate_any(cur - target, DEVICE)
        return 0.0
