"""Discrete-event simulator for the interleaved pipeline (counterpart of
``repro.core.pipeline_sim``; paper §IV, Figs 3-8).

The cost model (Eq. 1) predicts steady-state latency; this simulator *executes*
a Plan on a timeline with explicit resources — per-device compute, per-device
weight loader (SSD/ICI channel), and the activation ring — so pipeline fill,
load/compute overlap, online-planner triggers and KV-transfer effects emerge
rather than being assumed. It is the artifact behind EXPERIMENTS.md §Repro
(Figs 12-18, Tab. V) and the golden-trace tests.

Execution order per auto-regressive step (paper Fig. 6): for each segment
s = 1..#Seg, each device computes all in-flight micro-batches for its stage
of s, hands activations to the next device (h_size/bw per hop), and — after
the *last* micro-batch of s — its loader evicts the segment-s offloaded
blocks and begins fetching segment s+1's (the interleave). A stage may not
start until its activation arrives AND its weights are resident.

Request patterns (paper §V-A): sporadic = 1 micro-batch in flight;
bursty = |D| micro-batches.

The JAX package's code, unchanged (it runs no array code): on the same
CostEnv and plan both packages give equal StepTraces and equal
flight-recorder events, float for float.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.core.cost_model import CostEnv, ExecutionPlan
from repro_torch.core.online_planner import OnlinePlanner
from repro_torch.core.kv_transfer import KVTransferProtocol
from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import dev_track, get_tracer, loader_track


@dataclasses.dataclass
class StepTrace:
    token: int
    latency: float
    load_stall: float          # time any stage waited on weights
    comm_time: float
    planner_fired: bool = False
    kv_moved_bytes: float = 0.0  # Eq. 8 page migrations this step (wire
                                 # volume; rides idle network, not latency)


@dataclasses.dataclass
class SimResult:
    per_token: List[StepTrace]
    oom: bool = False
    oot: bool = False
    reason: str = ""

    @property
    def ms_per_token(self) -> float:
        if not self.per_token:
            return float("inf")
        return 1e3 * sum(t.latency for t in self.per_token) / len(self.per_token)

    @property
    def total_s(self) -> float:
        return sum(t.latency for t in self.per_token)


# ----------------------------------------------------------------------------
# Core timeline
# ----------------------------------------------------------------------------
class InterleavedPipelineSim:
    """Simulates LIME decoding `n_tokens` with an allocation Plan."""

    def __init__(self, env: CostEnv, plan: ExecutionPlan, *,
                 use_planner: bool = True, use_kv_transfer: bool = True,
                 planner_full_layer_fallback: bool = False,
                 horizon_tokens: Optional[int] = None,
                 bandwidth_schedule: Optional[Callable[[int], float]] = None,
                 prompt_tokens: int = 64,
                 true_env: Optional[CostEnv] = None):
        self.env = env
        # planned-vs-true split (DESIGN.md §18): `env` is the *model* the
        # planner/scheduler reason with; `true_env` is what the hardware
        # actually does — the sim prices compute and loader time from it.
        # They are the same object unless a drift experiment separates
        # them (set_true_env mid-run injects a throttle/contention event).
        self.true_env = true_env if true_env is not None else env
        self.refit = None
        self.plan = plan
        self.w = env.work
        self.D = len(plan.stages)
        self.n_seg = max(plan.n_seg, 1)
        self.bw_schedule = bandwidth_schedule
        self.prompt = prompt_tokens
        if horizon_tokens is None:
            # cover the largest context any device could conceivably reach
            horizon_tokens = int(2 ** 20)
        self.planner = OnlinePlanner(env, plan, horizon_tokens=horizon_tokens) \
            if use_planner or planner_full_layer_fallback else None
        self.full_layer_fallback = planner_full_layer_fallback
        self.kv = KVTransferProtocol(env, plan, self.planner) \
            if (use_kv_transfer and self.planner) else None
        if self.kv:
            self.kv.init_transfers(ctx_tokens=prompt_tokens)
        # per-device rolling loader state: when next segment's weights land
        self._loader_free = [0.0] * self.D
        self._load_done = [[0.0] * (self.n_seg + 1) for _ in range(self.D)]
        # arrival-driven stepping state (LIME-Serve, DESIGN.md §9): the
        # virtual clock, the autoregressive step counter, and the current
        # network bandwidth. run() and step_once() share these.
        self.now = 0.0
        self._tok_count = 0
        self._bw = env.bw_net
        # paged KV accounting (DESIGN.md §10): when a PagePool is attached
        # the KV-transfer protocol's Eq. 8 volumes are reconciled against
        # it every step (delegated tokens -> host-tier pages) and
        # scheduler-driven spill/fetch traffic is priced via
        # charge_transfer().
        self.page_pool = None
        self.kv_moved_bytes = 0.0

    def attach_page_pool(self, pool) -> None:
        self.page_pool = pool

    def set_true_env(self, true_env: CostEnv) -> None:
        """Inject a ground-truth drift mid-run (thermal throttle, SSD
        contention): subsequent steps *execute* at true_env's rates while
        the planner keeps reasoning with `self.env` until a re-fit folds
        the observed drift back in."""
        self.true_env = true_env

    def attach_refit(self, refit) -> None:
        """Wire an OnlineRefit: the sim feeds it per-segment fetch and
        compute observations and gives it a shot at rebuilding after
        every step. The refit must share `self.env` (the planned model)."""
        if not isinstance(self.env.devices, list):
            self.env.devices = list(self.env.devices)
        refit.env = self.env
        refit.planner = self.planner
        self.refit = refit

    def charge_transfer(self, nbytes: float) -> float:
        """Price scheduler-driven page movement (preemption spill/fetch)
        at the current network bandwidth; advances the virtual clock —
        unlike Eq. 8 delegation, a forced swap is on the critical path."""
        dt = nbytes / max(self._bw, 1e-9)
        self.now += dt
        self.kv_moved_bytes += nbytes
        return dt

    # -- per-device per-segment quantities -------------------------------------
    def _layers_seg(self, i: int) -> float:
        d = self.plan.stages[i]
        return d.resident_total / self.n_seg + d.off_layers_seg()

    def _comp_seg_mb(self, i: int, ctx: int, q_len: int = 1,
                     env: Optional[CostEnv] = None) -> float:
        """One micro-batch's compute for device i's slice of one segment.
        q_len > 1 prices a speculative verify round (DESIGN.md §11): the
        round scores q_len query positions, so FLOPs and KV reads scale
        with q_len (mb -> mb*q_len in the roofline) while weight bytes —
        the term that dominates offloaded decode — are read once.
        Prices from true_env (what the hardware does); pass env=self.env
        to price the planned model instead (re-fit drift observation)."""
        env = self.true_env if env is None else env
        w = dataclasses.replace(self.w, ctx=max(ctx, 1),
                                mb=self.w.mb * max(q_len, 1))
        return self._layers_seg(i) * w.comp_layer(env.devices[i])

    def _load_bytes_seg(self, i: int) -> float:
        d = self.plan.stages[i]
        extra = self.planner.extra_load_bytes_seg(i) if self.planner else 0.0
        if self.full_layer_fallback and self.planner:
            st = self.planner.states[i]
            if st.alpha or st.beta:    # ablation: whole layers, not blocks
                extra = max(st.alpha, st.beta) * self.w.l_size
        total = d.load_bytes_seg(self.w) + extra
        if self.kv:
            # delegated KV frees memory that pins blocks resident (Eq. 8 win)
            total = max(total - self.kv.load_reduction_bytes_seg(i), 0.0)
        return total

    def _hop_time(self, bw: float, q_len: int = 1) -> float:
        """q_len positions hop together in a verify round — the ring
        hands q_len activations per micro-batch."""
        return max(q_len, 1) * self.w.h_size / bw + self.env.net_latency

    # -- one auto-regressive step ----------------------------------------------
    def _step(self, t0: float, ctx: int, bw: float, n_micro: int,
              q_len: int = 1,
              q_lens: Optional[List[int]] = None) -> Tuple[float, float, float]:
        """Returns (t_end, load_stall, comm_time). `q_lens` gives each
        micro-batch its own query count (a *mixed* round: decode streams at
        q=1 riding the same weight-stream as a chunked-prefill stream at
        q=chunk — DESIGN.md §12); `q_len` is the uniform shorthand."""
        D, S = self.D, self.n_seg
        qs = list(q_lens) if q_lens is not None else [q_len] * n_micro
        assert len(qs) == n_micro, (len(qs), n_micro)
        dev_free = [t0] * D
        stall = 0.0
        comm = 0.0
        # flight recorder (DESIGN.md §15): one stage.compute span per
        # (device, segment) on "dev:<i>", one weight.fetch span per
        # interleave fetch on "dev:<i>:loader" — the Perfetto view where
        # load/compute overlap (the paper's whole argument) is *visible*
        tr = get_tracer()
        # activation readiness per micro-batch (enters device 0, segment 0)
        ready = [t0] * n_micro
        for s in range(S):
            for i in range(D):
                w_ready = self._load_done[i][s % S]
                last_end = dev_free[i]
                seg_start = None
                seg_stall = 0.0
                hop = 0.0
                for m in range(n_micro):
                    hop = self._hop_time(bw, qs[m])
                    start = max(ready[m], dev_free[i], w_ready)
                    if seg_start is None:
                        seg_start = start
                    mb_stall = max(w_ready - max(ready[m], dev_free[i]), 0.0)
                    stall += mb_stall
                    seg_stall += mb_stall
                    end = start + self._comp_seg_mb(i, ctx, qs[m])
                    dev_free[i] = end
                    ready[m] = end + hop
                    comm += hop
                    last_end = end
                if tr is not None and seg_start is not None:
                    tr.complete(tr_ev.STAGE_COMPUTE, ts=seg_start,
                                dur=last_end - seg_start, track=dev_track(i),
                                args={"segment": s, "n_micro": n_micro,
                                      "stall_s": seg_stall})
                    if seg_stall > 0:
                        # the stall is always the FIRST micro-batch waiting
                        # on w_ready (later ones inherit dev_free >= w_ready)
                        # so it is one contiguous interval ending at
                        # seg_start — emit it as a span so critical-path
                        # attribution can classify the wall-clock it covers
                        tr.complete(tr_ev.WEIGHT_STALL,
                                    ts=seg_start - seg_stall, dur=seg_stall,
                                    track=dev_track(i),
                                    args={"stall_s": seg_stall,
                                          "segment": s})
                    # last micro-batch's hand-off to the next device
                    tr.complete(tr_ev.ACT_HOP, ts=last_end, dur=hop,
                                track=dev_track(i), args={"segment": s})
                if self.refit is not None and seg_start is not None:
                    actual = sum(self._comp_seg_mb(i, ctx, qm) for qm in qs)
                    planned = sum(self._comp_seg_mb(i, ctx, qm, env=self.env)
                                  for qm in qs)
                    self.refit.observe_compute(i, actual, planned,
                                               now=last_end)
                # interleave: evict seg-s blocks, fetch seg-(s+1) blocks
                lb = self._load_bytes_seg(i)
                if lb > 0:
                    ld_start = max(last_end, self._loader_free[i])
                    ld_end = ld_start + lb / self.true_env.devices[i].load_bw
                    # KV-transfer wire time rides the otherwise-idle network
                    # inside the uncovered window (Eq. 8 sizes it to fit), so
                    # it adds no loader-channel latency by construction.
                    self._loader_free[i] = ld_end
                    self._load_done[i][(s + 1) % S] = ld_end
                    if self.refit is not None:
                        self.refit.observe_fetch(i, lb, ld_end - ld_start,
                                                 now=ld_end)
                    if tr is not None:
                        tr.complete(tr_ev.WEIGHT_FETCH, ts=ld_start,
                                    dur=ld_end - ld_start,
                                    track=loader_track(i),
                                    args={"segment": (s + 1) % S,
                                          "bytes": lb})
        return max(max(dev_free), max(ready)), stall, comm

    # -- arrival-driven stepping (LIME-Serve) ------------------------------------
    def reset_clock(self) -> None:
        """Restore the t=0 state run() historically assumed. The clock,
        token counter, bandwidth, and loader timeline persist across
        run()/step_once() calls (arrival-driven serving needs that); call
        this before reusing one sim instance for an independent run."""
        self.now = 0.0
        self._tok_count = 0
        self._bw = self.env.bw_net
        self.kv_moved_bytes = 0.0
        self._loader_free = [0.0] * self.D
        self._load_done = [[0.0] * (self.n_seg + 1) for _ in range(self.D)]

    def advance_to(self, t: float) -> None:
        """Idle the fleet until virtual time `t` (waiting for an arrival)."""
        self.now = max(self.now, t)

    def step_once(self, *, ctx: Optional[int] = None, n_micro: int = 1,
                  kv_tokens: Optional[int] = None,
                  q_len: int = 1,
                  q_lens: Optional[List[int]] = None) -> StepTrace:
        """One autoregressive step at the current virtual clock.

        ctx: KV read span this step (default: prompt + steps taken, the
        fixed-loop behaviour). n_micro: micro-batches in flight *this step*
        — the serving layer passes the live slot count, so a half-full
        pipeline is priced as one. kv_tokens: effective per-stream token
        count for the OnlinePlanner's TS thresholds (default ctx); the
        serving layer passes Σ_active ctx_i / n_micro_env so admission-level
        KV accounting is what walks the ladder (paper Eq. 5). q_len: query
        positions scored this round (speculative verify, DESIGN.md §11) —
        compute and activation hops scale with q_len, weight streaming
        does not, which is exactly why the verify round amortizes the
        per-round load bytes over every accepted token. q_lens:
        per-micro-batch query counts for mixed rounds (chunked prefill
        riding alongside live decode streams, DESIGN.md §12); overrides
        q_len when given.
        """
        tok = self._tok_count
        if ctx is None:
            ctx = self.prompt + tok
        if self.bw_schedule:
            new_bw = self.bw_schedule(tok)
            if new_bw != self._bw:
                if self.kv:
                    self.kv.on_bandwidth(new_bw, ctx * n_micro)
                self._bw = new_bw
        fired = False
        moved = 0.0
        if self.planner:
            if self.kv:
                self.kv.refresh(ctx)
                if self.page_pool is not None:
                    # Eq. 8 volumes become page migrations on the attached
                    # pool; sized to ride idle network, so wire volume is
                    # recorded but adds no step latency
                    moved = self.kv.sync_pool(self.page_pool)
                    self.kv_moved_bytes += moved
                    if moved > 0:
                        tr = get_tracer()
                        if tr is not None:
                            tr.instant(tr_ev.KV_MIGRATE, ts=self.now,
                                       track=tr_ev.TRACK_KV,
                                       args={"bytes": moved})
            offsets = [self.kv.transferred_tokens(i)
                       for i in range(self.D)] if self.kv else None
            eff = ctx if kv_tokens is None else kv_tokens
            fired = bool(self.planner.on_token(eff, offsets))
        t_end, stall, comm = self._step(self.now, ctx, self._bw, n_micro,
                                        q_len, q_lens)
        trace = StepTrace(tok, t_end - self.now, stall, comm, fired,
                          kv_moved_bytes=moved)
        self.now = t_end
        self._tok_count += 1
        if self.refit is not None:
            self.refit.maybe_refit(self.now)
        return trace

    # -- main loop ---------------------------------------------------------------
    def run(self, n_tokens: int, *, n_micro: int = 1,
            oot_s_per_token: Optional[float] = None) -> SimResult:
        """Fixed token loop from t=0 (resets the clock — the historical
        contract; arrival-driven serving drives step_once() directly and
        never calls this)."""
        self.reset_clock()
        traces: List[StepTrace] = []
        for _ in range(n_tokens):
            traces.append(self.step_once(n_micro=n_micro))
            if oot_s_per_token and traces[-1].latency > oot_s_per_token:
                return SimResult(traces, oot=True,
                                 reason=f"{traces[-1].latency:.1f}s/token")
        return SimResult(traces)


# ----------------------------------------------------------------------------
# Convenience wrapper: schedule + simulate LIME
# ----------------------------------------------------------------------------
def simulate_lime(env: CostEnv, n_layers: int, n_tokens: int, *,
                  n_micro: int = 1, n_emp: int = 512, prompt: int = 64,
                  use_planner: bool = True, use_kv_transfer: bool = True,
                  planner_full_layer_fallback: bool = False,
                  bandwidth_schedule=None,
                  oot_s_per_token: Optional[float] = None) -> SimResult:
    from repro_torch.core.offline_scheduler import allocate
    r = allocate(env, n_layers, n_emp=n_emp)
    if not r.feasible:
        return SimResult([], oom=True, reason=r.reason)
    sim = InterleavedPipelineSim(
        env, r.plan, use_planner=use_planner,
        use_kv_transfer=use_kv_transfer,
        planner_full_layer_fallback=planner_full_layer_fallback,
        bandwidth_schedule=bandwidth_schedule, prompt_tokens=prompt)
    return sim.run(n_tokens, n_micro=n_micro, oot_s_per_token=oot_s_per_token)
