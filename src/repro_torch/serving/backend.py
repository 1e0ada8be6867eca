"""Execution backends of the port (counterpart of
``repro.serving.backend``).

One protocol, two substrates, as in the JAX package:

  EngineBackend  the real thing on the card: the model's single-device
                 path or the InterleavedEngine, real sampled tokens,
                 wall-clock time, epoch batching (can_join_running False)
  SimBackend     the discrete-event InterleavedPipelineSim on a CostEnv:
                 virtual time, per-step micro-batch occupancy, the
                 planner's and the KV-transfer protocol's effects, chunked
                 mixed rounds, the spec acceptance model; continuous
                 batching (can_join_running True). The JAX package's code,
                 unchanged: it runs no array code, so on the same CostEnv
                 and arrival stream both packages give equal timings and
                 equal flight-recorder events. Fleet tests run their
                 replicas on it (their clocks are virtual, so placement is
                 reproducible run to run).

The protocol the scheduler drives (duck-typed, as in the JAX package):

  n_slots            batch slots the backend co-schedules
  can_join_running   may the scheduler refill freed slots mid-flight?
  now()              current time (seconds)
  advance_to(t)      idle until t (arrival wait)
  kv_budget_tokens() KV capacity in tokens, or None (unbounded)
  start_batch(reqs)  admit an idle-state batch; returns first token per
                     request
  decode_active(slots) one decode step; {slot: token} per live slot
  join(slot, req)    mid-flight admission (only if can_join_running)
  release(slot)      slot freed by the scheduler
  resumes_preempted  may the scheduler preempt a request and resume it
                     later? (absent: yes)

Without an engine the backend runs the model's own prefill and
decode_step on one device. With an InterleavedEngine (weights larger than
HBM) it prefills through the engine's chunked multi-query rounds
(prefill_partial) where the family is dense or MoE and the prompt fits
the cache ring, else through the engine's prompt pass over its tiers
(prefill) adopted by seed_cache (the recurrent families; a prompt longer
than a window-sized ring), and decodes through its interleaved passes.
A paged engine (InterleavedEngine(paged=True)) keeps its own page
accounting; release frees a slot's pages.

With a SpecConfig each decode round drafts k tokens per live slot and
verifies them in one multi-query pass: the engine's verify_requests, the
model's verify_step (kernel 4) or the paged cache's verify (kernel 5).
The drafts come from host providers (n-gram lookup, a small model, the
target's own bottom layers) or, for draft="resident" on an engine, from
the engine's live resident tier. Greedy sampling accepts the argmax
prefix; temperature > 0 runs rejection sampling over the providers' q.

Online memory adaptation (engine only): the scheduler's paged admission
attaches its PagePool (attach_page_pool) and reports page occupancy
after every change (note_kv_pages). An OnlinePlanner (planner=) walks its
TS ladder on that occupancy; a fired plan demotes resident layers into
the engine's retier headroom between steps, and their HBM grows the pool.
Before preempting a request the scheduler asks for headroom
(reclaim_kv_pages); such grants are promoted back once the pool has room
again. Past that the scheduler would preempt, which this backend refuses
(resumes_preempted). retier() moves the boundary by hand (scripted serves).

Without an engine, `paged` routes the single-device path through a paged
KV cache (kvcache/paged_decode: one pool, block tables, the paged decode
and multi-query kernels), and `prefix_cache` adds a radix prefix cache
over that pool, persistent across epochs: an epoch of equal-length
prompts forks its matched page-aligned prefix into fresh block tables and
prefills only the uncached suffix (in chunks of prefill_chunk_tokens),
and a finished request donates its pages to the tree. The JAX backend
builds its paged cache with the reference math; this one passes its own
`impl` through, so the default runs the paged kernels.

On the card every step replays a CUDA graph (core/capture.py: the
counterpart of the JAX backend's jax.jit of prefill, decode_step and
verify_step), one per shape: the decode and verify steps of the
single-device path (plain, paged, prefix cache) and every prefill route
of start_batch (the dense prefill, which the paged path then seeds into
pages; the prefix cache's suffix rounds; an engine's prefill_partial
rounds or its prompt pass, one graph per prompt shape), an engine's
decode, verify and resident draft passes (streamed layers included), and
the model and resident drafts' steps and prefill. Speculation keeps one
graph per q_len it meets. The caches they write (the dense and paged
caches, the engine's state, which the engine's prompt pass writes
directly, the drafts' caches) are allocated once and cleared in place
between epochs, so the graphs live as long as the backend (an engine's
retier drops its pass graphs: the next pass captures again).
`capture=False` runs every one of these steps eagerly (for comparisons);
the launcher does not expose it.

With a tracer installed (obs/trace) each step is one complete span on the
"pipeline" track, as in the JAX backend: engine.prefill (start_batch),
engine.decode (a plain decode round), engine.verify (a speculative round,
an engine.draft span inside it for the engine's resident draft), and a
retier of the live engine one engine.retier instant on "kv". A span
closes after the step's host copy of its tokens, the sync the step makes
anyway, so its duration holds the device's work (a replayed graph is one
span); tracing adds no sync of its own.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import Family
from repro_torch.core.capture import CapturedStep
from repro_torch.core.cost_model import CostEnv
from repro_torch.core.pipeline_sim import InterleavedPipelineSim
from repro_torch.device import resolve_device
from repro_torch.kvcache.allocator import BlockTable
from repro_torch.kvcache.paged_decode import PagedDecodeCache
from repro_torch.kvcache.pool import PagedKVConfig, PagePool
from repro_torch.models import model as M
from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import get_tracer
from repro_torch.prefixcache import RadixPrefixCache
from repro_torch.serving.sampling import SamplerConfig, sample


# the JAX package's serving route on the encoder-decoder family:
# jax.jit(partial(M.prefill, cfg)) on M.init_cache(...) with no enc_out
ENCDEC_REFUSAL = (
    "the serving route does not run the encoder-decoder family: the JAX "
    "package's own route fails on it (its M.prefill without enc_out raises "
    "KeyError: 'xk'). Drive it through the model (encode, seed_cross_kv, "
    "prefill(enc_out=), decode_step(enc_len=)) or "
    "InterleavedEngine(enc_len=)")


def refuse_encdec(cfg) -> None:
    """Raise NotImplementedError for an encoder-decoder config (before any
    weight is drawn, where the caller checks first)."""
    if cfg.family == Family.ENCDEC:
        raise NotImplementedError(ENCDEC_REFUSAL)


# ============================================================================
# Simulator backend
# ============================================================================
class SimBackend:
    """Discrete-event substrate: prices each decode step by live occupancy.

    Per-request KV accounting feeds the OnlinePlanner: every step passes
    kv_tokens = ceil(Σ_active ctx_i / n_micro_env), the effective
    per-stream token count under the Workload's n_micro scaling — so the
    TS thresholds (paper Eq. 5) fire exactly when the *admitted* KV load
    says they should, not on a fixed token loop.
    """

    can_join_running = True

    def __init__(self, env: CostEnv, plan=None, *, n_slots: int = 0,
                 use_planner: bool = True, use_kv_transfer: bool = True,
                 prompt_tokens: int = 64, spec=None, adapt: bool = False,
                 refit: bool = False, true_env: Optional[CostEnv] = None):
        if plan is None:
            from repro_torch.core.offline_scheduler import allocate
            r = allocate(env, env.work.cfg.n_layers,
                         n_emp=max(prompt_tokens, 1))
            if not r.feasible:
                raise ValueError(f"infeasible allocation: {r.reason}")
            plan = r.plan
        self.env = env
        self.plan = plan
        self.n_slots = n_slots or max(env.work.n_micro, 1)
        self.sim = InterleavedPipelineSim(
            env, plan, use_planner=use_planner,
            use_kv_transfer=use_kv_transfer, prompt_tokens=prompt_tokens,
            true_env=true_env)
        # online re-fit (DESIGN.md §18): observe the sim's fetch/compute
        # telemetry and fold measured drift back into the planned env
        self.refit = None
        if refit:
            from repro_torch.tune.refit import OnlineRefit
            self.refit = OnlineRefit(env)
            self.sim.attach_refit(self.refit)
        self._ctx: Dict[int, int] = {}        # slot -> prompt + generated
        self._kv_pages = None                 # (pages_in_use, page_size)
        # adaptation telemetry (DESIGN.md §13): planner (α, β) moves are
        # reported in whole-layer equivalents; scheduler-driven reclaims
        # (reclaim_kv_pages) force-advance the TS ladder and credit the
        # freed bytes to the admission page pool. `adapt` gates the
        # reclaim hook — with it off (default) admission pressure behaves
        # exactly as the static plan (preempt, never retier).
        self.adapt = adapt
        self._pool = None
        self._adapt = {"retier_events": 0, "layers_demoted": 0,
                       "layers_promoted": 0, "hbm_returned_bytes": 0.0}
        # speculative decoding (DESIGN.md §11): the simulator has no real
        # tokens to verify, so a spec config prices each decode round as a
        # (k+1)-query verify pass and draws per-slot accepted counts from
        # the acceptance-rate model (each draft token independently
        # accepted with prob spec.acceptance, stopping at the first
        # rejection — the geometric shape real rejection sampling has).
        # draft="resident" (DESIGN.md §14) scales that acceptance by the
        # LIVE resident fraction — the plan's resident share minus
        # whatever the TS ladder has demoted — and adapts draft depth per
        # rung through a DepthController, so planner demotions visibly
        # thin the self-draft exactly as they do on the real engine.
        self.spec = spec
        self._depth = None
        if spec is not None:
            from repro_torch.specdec import SpecStats
            self._spec_rng = np.random.default_rng(spec.seed)
            self._spec_stats = SpecStats()
            if spec.draft == "resident":
                total = max(plan.layers_total(), 1)
                self._res_frac0 = min(
                    sum(st.resident_total for st in plan.stages) / total,
                    1.0)
                if spec.adapt_k:
                    from repro_torch.specdec import DepthController
                    self._depth = DepthController(
                        k_max=spec.k, prior=self._spec_acceptance())

    # -- clock -------------------------------------------------------------------
    def now(self) -> float:
        return self.sim.now

    def advance_to(self, t: float) -> None:
        self.sim.advance_to(t)

    # -- capacity ----------------------------------------------------------------
    def kv_budget_tokens(self) -> Optional[int]:
        """Fleet KV capacity in per-request tokens: aggregate memory left
        after weights, divided by the per-token-per-sequence KV rate
        (kv_bytes_per_token_layer covers the whole mb × n_micro set)."""
        cfg = self.env.work.cfg
        w = self.env.work
        per_seq = w.kv_bytes_per_token_layer() \
            / (max(w.mb, 1) * max(w.n_micro, 1))
        rate = cfg.n_layers * per_seq
        if rate <= 0:
            return None                       # attention-free: KV is not a budget
        agg = sum(d.mem_bytes for d in self.env.devices)
        budget = max(agg - cfg.total_params() * 2, agg * 0.03)
        return int(budget // rate)

    def kv_bytes_per_token(self) -> float:
        """Fleet KV bytes one context token costs one sequence (page
        pricing for the paged scheduler's spill/fetch accounting)."""
        cfg = self.env.work.cfg
        w = self.env.work
        return cfg.n_layers * w.kv_bytes_per_token_layer() \
            / (max(w.mb, 1) * max(w.n_micro, 1))

    # -- paged-KV hooks (DESIGN.md §10) ------------------------------------------
    def note_kv_pages(self, pages_in_use: int, page_size: int) -> None:
        """Scheduler callback: current page-granular occupancy. Attaches
        the planner/KV-transfer accounting to *allocated* pages, so the TS
        ladder (paper Eq. 5) fires on what admission actually holds."""
        self._kv_pages = (pages_in_use, page_size)

    def note_slo_pressure(self, pressure: float) -> None:
        """Scheduler callback (DESIGN.md §17): forward SLO pressure
        (1 - health) to the sim's OnlinePlanner so its TS thresholds
        fire early while the serving layer is breaching."""
        if self.sim.planner is not None:
            self.sim.planner.note_slo_pressure(pressure)

    def attach_page_pool(self, pool) -> None:
        """Expose a PagePool to the simulator so Eq. 8 volumes move real
        pages (core/kv_transfer.sync_pool) every step, and to the
        adaptation path so retiered weight bytes grow its device tier."""
        self.sim.attach_page_pool(pool)
        self._pool = pool

    # -- online memory adaptation (DESIGN.md §13) --------------------------------
    def _planner_snapshot(self):
        pl = self.sim.planner
        return [(st.alpha, st.beta) for st in pl.states] if pl else None

    def _note_planner_delta(self, before) -> None:
        """Fold planner (α, β) moves since `before` into the adaptation
        telemetry (whole-layer equivalents: a layer = 1 MHA + 1 MLP).
        Gated on `adapt`: a static run's report keeps the documented
        'zero when --adapt is off' contract even on workloads where the
        sim's own TS ladder fires."""
        pl = self.sim.planner
        if not self.adapt or pl is None or before is None:
            return
        w = self.env.work
        tr = get_tracer()
        factor = max(self.plan.n_seg - 1, 1)
        for dev, ((a0, b0), st) in enumerate(zip(before, pl.states)):
            da, db = st.alpha - a0, st.beta - b0
            if not (da or db):
                continue
            self._adapt["retier_events"] += 1
            self._adapt["layers_demoted"] += max(max(da, db), 0)
            self._adapt["layers_promoted"] += max(-min(da, db), 0)
            self._adapt["hbm_returned_bytes"] += max(
                (da * w.attn_block_bytes + db * w.mlp_block_bytes) * factor,
                0.0)
            if tr is not None:
                tr.instant(tr_ev.RETIER, track=tr_ev.TRACK_KV,
                           args={"dev": dev,
                                 "demoted": max(max(da, db), 0),
                                 "promoted": max(-min(da, db), 0)})

    def _sim_step(self, **kw):
        before = self._planner_snapshot()
        trace = self.sim.step_once(**kw)
        self._note_planner_delta(before)
        tr = get_tracer()
        if tr is not None:
            # StepTrace -> trace events: sim and engine render identically
            # (one "step" span per pipeline round on the "pipeline" track)
            t1 = self.sim.now
            tr.complete(tr_ev.STEP, ts=t1 - trace.latency,
                        dur=trace.latency, track=tr_ev.TRACK_PIPELINE,
                        args={"load_stall": trace.load_stall,
                              "comm_time": trace.comm_time,
                              "kv_moved_bytes": trace.kv_moved_bytes})
            if trace.planner_fired:
                tr.instant(tr_ev.PLANNER_FIRED, ts=t1,
                           track=tr_ev.TRACK_PIPELINE)
        return trace

    def reclaim_kv_pages(self, n_pages: int) -> int:
        """Scheduler pressure hook: force-advance the TS ladder (demote
        blocks ahead of their occupancy thresholds) and return the freed
        bytes as device KV pages. The simulator prices the added
        per-segment load on every subsequent step — adaptation trades
        steady-state load for preemption churn. Returns pages granted."""
        pl = self.sim.planner
        if not self.adapt or pl is None or self._pool is None:
            return 0
        pb = self._pool.cfg.page_bytes
        if pb <= 0:
            return 0
        w = self.env.work
        factor = max(self.plan.n_seg - 1, 1)
        snap = [(st.alpha, st.beta, st.plan_idx) for st in pl.states]
        adapt_snap = dict(self._adapt)
        freed = 0.0
        need = n_pages * pb
        advanced = True
        while freed < need and advanced:
            advanced = False
            for st in pl.states:
                lad = pl.ladders[st.dev_idx]
                if st.plan_idx >= len(lad):
                    continue
                step = lad[st.plan_idx]
                da, db = step.alpha - st.alpha, step.beta - st.beta
                gain = (da * w.attn_block_bytes
                        + db * w.mlp_block_bytes) * factor
                st.alpha, st.beta = step.alpha, step.beta
                st.plan_idx += 1
                advanced = True
                if gain > 0:
                    freed += gain
                    self._adapt["retier_events"] += 1
                    self._adapt["layers_demoted"] += max(max(da, db), 0)
                    self._adapt["hbm_returned_bytes"] += gain
                if freed >= need:
                    break
        pages = int(freed // pb)
        if pages <= 0:
            # nothing granted: roll the ladder (and its telemetry) back —
            # the preemption happens anyway; paying extra per-segment
            # load for zero pages would be pure loss
            for st, (a, b, i) in zip(pl.states, snap):
                st.alpha, st.beta, st.plan_idx = a, b, i
            self._adapt = adapt_snap
            return 0
        self._pool.grow(pages)
        tr = get_tracer()
        if tr is not None:
            tr.instant(tr_ev.RETIER, track=tr_ev.TRACK_KV,
                       args={"forced": True, "pages": pages})
        return pages

    @property
    def adapt_stats(self):
        return dict(self._adapt)

    def charge_transfer(self, nbytes: float) -> None:
        """Preemption spill/fetch traffic: advances the virtual clock."""
        self.sim.charge_transfer(nbytes)

    # -- serving hooks -----------------------------------------------------------
    @staticmethod
    def _prefill_span(req) -> int:
        # a recompute-resumed request re-prefills prompt + generated
        return getattr(req, "prefill_tokens", None) or req.prompt_len

    @staticmethod
    def _prefill_q(req) -> int:
        """Query positions the prefill pass actually computes: the span
        minus whatever the radix prefix cache (or a spill that kept the
        KV) already holds — Eq. 5-8 bytes and hops are priced for the
        uncached suffix only (DESIGN.md §12)."""
        span = SimBackend._prefill_span(req)
        cached = getattr(req, "cached_tokens", 0)
        return max(span - cached, 1)

    def start_batch(self, reqs: Sequence) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for slot, r in enumerate(reqs):
            self._ctx[slot] = self._prefill_span(r)
        # prefill: one pipeline pass; each micro-batch carries its own
        # uncached-suffix query count (attention still reads the full
        # span, hence ctx = the longest context in the batch)
        self._sim_step(ctx=max((self._prefill_span(r) for r in reqs),
                                   default=1),
                           n_micro=max(len(reqs), 1),
                           kv_tokens=self._planner_tokens(),
                           q_lens=[self._prefill_q(r) for r in reqs] or [1])
        for slot, r in enumerate(reqs):
            self._ctx[slot] += 1
            out.append(None)                  # sim has no real token ids
        return out

    def join(self, slot: int, req) -> Optional[int]:
        # mid-flight admission: the joiner's prefill rides one step at its
        # own prompt span before it starts decoding with the others
        span = self._prefill_span(req)
        self._ctx[slot] = span
        self._sim_step(ctx=max(span, 1), n_micro=1,
                           kv_tokens=self._planner_tokens(),
                           q_len=self._prefill_q(req))
        self._ctx[slot] += 1
        return None

    # -- chunked prefill / mixed rounds (DESIGN.md §12) --------------------------
    def attach_slot(self, slot: int, req, ctx0: int) -> None:
        """Register a slot whose prompt will drain through decode_mixed
        chunks; `ctx0` is the context already in KV (radix prefix hit or
        a spill that kept the pages)."""
        self._ctx[slot] = max(ctx0, 0)

    def decode_mixed(self, work: Dict[int, tuple]):
        """One mixed round: {slot: ("prefill", n_tokens, last_chunk) |
        ("decode",)}. Every stream rides the same weight-stream — the
        chunk's compute and hops scale with its q_len, decode streams
        with 1 (or k+1 under speculation) — so a cold prompt no longer
        stalls live decoders for a monolithic pass. Prefill slots emit
        [None] (their first token) when the last chunk lands, [] before;
        decode slots emit their committed round."""
        if not work:
            return {}
        slots = sorted(work)
        q_lens, out = [], {}
        spec_slots = []
        k = self._spec_k() if self.spec is not None else 0
        for s in slots:
            w = work[s]
            if w[0] == "prefill":
                q_lens.append(max(w[1], 1))
            elif self.spec is not None:
                q_lens.append(k + 1)
                spec_slots.append(s)
            else:
                q_lens.append(1)
        ctx = max(self._ctx[s] + (work[s][1] if work[s][0] == "prefill"
                                  else 1) for s in slots)
        self._sim_step(ctx=ctx, n_micro=len(slots),
                           kv_tokens=self._planner_tokens(), q_lens=q_lens)
        for s in slots:
            w = work[s]
            if w[0] == "prefill":
                self._ctx[s] += w[1]
                if w[2]:                      # last chunk: first token
                    self._ctx[s] += 1
                    out[s] = [None]
                else:
                    out[s] = []
            elif s in spec_slots:
                out[s] = [None] * self._spec_commit(s, k)
            else:
                self._ctx[s] += 1
                out[s] = [None]
        return out

    def _demoted_layers(self) -> int:
        """Whole-layer equivalents the TS ladder currently holds demoted
        (the sim's retier rung; max(α, β) per device, the convention
        _note_planner_delta reports in)."""
        pl = self.sim.planner
        if pl is None:
            return 0
        return sum(max(st.alpha, st.beta) for st in pl.states)

    def _resident_frac(self) -> float:
        """Live resident share: the plan's static fraction minus ladder
        demotions."""
        total = max(self.plan.layers_total(), 1)
        return min(max(self._res_frac0 - self._demoted_layers() / total,
                       0.0), 1.0)

    def _spec_acceptance(self) -> float:
        """Per-token acceptance of the model: flat for ngram/model drafts;
        for the resident self-draft it scales with the live resident
        fraction (a thinner draft stack proposes worse tokens)."""
        if self.spec.draft != "resident":
            return self.spec.acceptance
        return min(max(self.spec.acceptance * self._resident_frac(),
                       0.02), 0.98)

    def _spec_k(self) -> int:
        """Round depth: spec.k, or the DepthController's rung-adapted k
        for the resident draft (rung = ladder-demoted layers)."""
        if self._depth is None:
            return self.spec.k
        self._depth.note_rung(self._demoted_layers(),
                              prior=self._spec_acceptance())
        return self._depth.k()

    def _spec_commit(self, s: int, k: Optional[int] = None) -> int:
        """Draw one slot's committed count from the acceptance model and
        advance its context (shared by decode_active and mixed rounds)."""
        k = self.spec.k if k is None else k
        a = self._spec_acceptance()
        acc = 0
        while acc < k and self._spec_rng.random() < a:
            acc += 1
        committed = acc + 1          # accepted prefix + correction/bonus
        self._ctx[s] += committed
        self._spec_stats.rounds += 1
        self._spec_stats.drafted += k
        self._spec_stats.accepted += acc
        if self._depth is not None:
            self._depth.note_round(k, acc)
        return committed

    def decode_active(self, slots: Sequence[int]):
        if not slots:
            return {}
        ctx = max(self._ctx[s] for s in slots)
        if self.spec is not None:
            return self._decode_active_spec(slots, ctx)
        self._sim_step(ctx=ctx, n_micro=len(slots),
                           kv_tokens=self._planner_tokens())
        for s in slots:
            self._ctx[s] += 1
        return {s: None for s in slots}

    def _decode_active_spec(self, slots: Sequence[int], ctx: int):
        """One speculative round: price a (k+1)-query verify pass, then
        commit 1..k+1 tokens per slot from the acceptance model."""
        k = self._spec_k()
        self._sim_step(ctx=ctx, n_micro=len(slots),
                           kv_tokens=self._planner_tokens(), q_len=k + 1)
        return {s: [None] * self._spec_commit(s, k) for s in slots}

    @property
    def spec_stats(self):
        return self._spec_stats.to_dict() if self.spec is not None else None

    def release(self, slot: int) -> None:
        self._ctx.pop(slot, None)

    def _planner_tokens(self) -> int:
        n_micro_env = max(self.env.work.n_micro, 1)
        if self._kv_pages is not None:
            pages, ps = self._kv_pages        # real page occupancy
            return -(-(pages * ps) // n_micro_env)
        total = sum(self._ctx.values())
        return -(-total // n_micro_env)       # ceil-div


# ============================================================================
# Engine backend (real execution)
# ============================================================================
class EngineBackend:
    """Wall-clock backend over the model's single-device decode path, or
    over an InterleavedEngine.

    Epoch batching: prefill fixes batch membership, so freed slots pad the
    batch until the epoch drains (can_join_running = False). Arrival waits
    don't sleep — advance_to() skews the clock, so a trace with long idle
    gaps runs in real compute time while latency math still sees the gaps.

    Speculative decoding (spec): the shared-pos cache layout (prompts
    left-padded, one position per batch) forces lockstep commits: every
    live slot advances by the minimum committed count and the rest is
    verified again next round, which greedy re-derives exactly and
    rejection sampling redraws from the same target conditional.
    """

    can_join_running = False
    # start_batch prefills each request's prompt, never what it generated
    # before a preemption (as the JAX package's backend does): a resumed
    # request would continue from its prompt, so the scheduler refuses to
    # preempt here (reclaiming retier headroom first still works)
    resumes_preempted = False

    def __init__(self, cfg, params, *, engine=None, n_slots: int = 0,
                 max_len: int = 512, sampler: Optional[SamplerConfig] = None,
                 prompt_seed: int = 0, impl: str = "kernel", spec=None,
                 prefill_chunk_tokens: int = 0, paged: bool = False,
                 prefix_cache: bool = False, page_size: int = 64,
                 cache_pages: int = 0, planner=None, refit: bool = False,
                 capture: bool = True, device=None):
        refuse_encdec(cfg)
        self.cfg = cfg
        self.params = params
        self.engine = engine
        # online memory adaptation: the OnlinePlanner's fired plans and the
        # scheduler's reclaims retier the live engine; demoted layers'
        # HBM is credited to the admission pool
        self.planner = planner
        # online re-fit on the real engine: wall-clock weight-load timings
        # go in through note_load_timing and fold drift back into the
        # planner's CostEnv (nothing to re-fit without a planner)
        self.refit = None
        if refit and planner is not None:
            from repro_torch.tune.refit import OnlineRefit
            if not isinstance(planner.env.devices, list):
                planner.env.devices = list(planner.env.devices)
            self.refit = OnlineRefit(planner.env, planner)
        self._pool = None                 # admission PagePool (scheduler's)
        self._grants = []                 # reclaim-driven (stage, pages)
        self._reclaim_dry = False         # retier slots too small to grant
        self.max_len = max_len
        self.impl = impl
        self.device = engine.device if engine is not None \
            else resolve_device(device)
        # the captured decode and verify steps (an engine's passes), the
        # prefills (the dense prefill or the engine's prompt pass and
        # chunked rounds; the prefix cache's suffix rounds apart, another
        # scope) and the engine's draft step, in one graph pool that the
        # host drafts share (None: capture off, or the CPU)
        self.steps = CapturedStep(self.device, enabled=capture)
        self.prefill_steps = CapturedStep.sharing(self.steps.pool, self.device)
        self.suffix_steps = CapturedStep.sharing(self.steps.pool, self.device)
        self.draft_steps = CapturedStep.sharing(self.steps.pool, self.device)
        self._dense_cache = None              # reused across epochs
        self.sampler = sampler if sampler is not None else SamplerConfig()
        self.chunk = max(int(prefill_chunk_tokens), 0)
        # radix prefix cache over the real paged pool: prompts matched
        # against cached pages, only the uncached suffix prefilled,
        # finished requests donate their pages back. It rides the
        # single-device paged path (the engine keeps a dense cache per
        # slot: there is no shared pool to fork from).
        if prefix_cache and engine is not None:
            raise NotImplementedError(
                "prefix_cache shares real KV pages through the "
                "single-device paged pool; the engine's cache layout has "
                "no shared pool to fork from")
        self.prefix_cache = prefix_cache
        self.paged = (paged or prefix_cache) and engine is None
        self.page_size = page_size
        self._cache_pages = cache_pages   # radix headroom (0: one full
                                          # batch's worth of extra pages)
        self._paged_cache = None
        self._radix = None
        self._slot_tokens = None          # per-slot donatable prompt ids
        self._slot_out = None             # per-slot committed output ids
        self._saved_tokens = 0            # prompt tokens seeded from cache
        self.spec = spec
        self._ctl = None
        self._pos = 0                         # host mirror of the cache pos
        # the resident self-draft: with an engine, k tokens are drafted on
        # the engine itself (draft_requests: the resident tier only, no
        # weight stream) and no host providers are built; without one,
        # each slot gets a ResidentDraft over the bottom
        # spec.resident_layers of the target's own stack
        self._resident_engine = (spec is not None
                                 and spec.draft == "resident"
                                 and engine is not None)
        self._depth = None
        if spec is not None:
            if cfg.family not in M.PURE_KV:
                raise ValueError(
                    f"speculative decoding needs pure-KV per-layer state "
                    f"(the dense family or MoE), not {cfg.family}: a "
                    f"recurrent state cannot roll rejected drafts back")
            if self._resident_engine and engine.k_res_cap == 0:
                raise ValueError("draft='resident' needs a resident tier; "
                                 "this plan streams every layer")
            if spec.draft == "resident" and spec.adapt_k:
                # imported here, as the JAX package does: specdec imports
                # serving.sampling, which imports this module
                from repro_torch.specdec import DepthController
                self._depth = DepthController(k_max=spec.k,
                                              prior=spec.acceptance)
            # verify windows must not wrap the cache ring (sliding caches
            # hold S_c = window < max_len slots); past its end the plain
            # ring-aware step takes over (decode_active fallback)
            if self.paged:
                self._spec_cap = max_len      # pool slots, no ring
            elif engine is not None:
                self._spec_cap = min(engine.S_c, max_len)
            else:
                self._spec_cap = min(M.kv_cache_len(cfg, max_len), max_len)
        self._adapt = {"retier_events": 0, "layers_demoted": 0,
                       "layers_promoted": 0, "hbm_returned_bytes": 0.0}
        # batch_width: what a step computes (fixed); n_slots: what the
        # scheduler may co-schedule (sporadic serves 1 through a wide
        # engine, the spare rows ride as padding)
        self.batch_width = engine.mb if engine is not None \
            else max(n_slots or 1, 1)
        self.n_slots = min(n_slots, self.batch_width) if n_slots \
            else self.batch_width
        # (k, tokens committed per live slot) of each decode round; (0, 1)
        # for a plain decode step
        self.rounds: List[Tuple[int, int]] = []
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.sampler.seed)
        self._prompt_rng_seed = prompt_seed
        self._t0 = time.monotonic()
        self._skew = 0.0
        self._state = None
        self._cur = None                      # (batch_width, 1) last tokens

    # -- clock -------------------------------------------------------------------
    def now(self) -> float:
        return (time.monotonic() - self._t0) + self._skew

    def advance_to(self, t: float) -> None:
        cur = self.now()
        if t > cur:
            self._skew += t - cur

    # -- capacity ----------------------------------------------------------------
    def kv_budget_tokens(self) -> Optional[int]:
        # the cache is statically shaped: max_len per slot
        return self.n_slots * self.max_len

    def kv_bytes_per_token(self) -> float:
        return 2.0 * self.cfg.n_layers * self.cfg.n_kv_heads \
            * self.cfg.head_dim * 2.0         # k+v, bf16

    def max_request_tokens(self) -> Optional[int]:
        """Per-slot ceiling: a single request's prompt + max_new must fit
        the statically-shaped cache."""
        return self.max_len

    def fits_batch(self, batch: Sequence, req) -> bool:
        """Prompts are LEFT-padded to the batch max, so every co-scheduled
        request decodes from position max(prompt_len): each one's max
        prompt + own max_new must fit max_len."""
        cand = list(batch) + [req]
        mp = max(r.prompt_len for r in cand)
        return all(mp + r.max_new_tokens <= self.max_len for r in cand)

    # -- helpers -----------------------------------------------------------------
    def _materialize_prompt(self, r) -> np.ndarray:
        if r.prompt is not None:
            return np.asarray(r.prompt, np.int32)
        rng = np.random.default_rng(self._prompt_rng_seed + r.rid)
        n = max(r.prompt_len, 1)
        return rng.integers(1, self.cfg.vocab_size, size=n).astype(np.int32)

    @staticmethod
    def _pad_prompts(prompts: List[np.ndarray]) -> np.ndarray:
        """Left-pad with token 0. There is no pad mask: pads are attended
        causally, exactly as in the JAX reference."""
        S = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), S), np.int32)
        for i, p in enumerate(prompts):
            toks[i, S - len(p):] = p
        return toks

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.sampler, self._gen, self.cfg.vocab_size)

    # -- online memory adaptation --------------------------------------------------
    def attach_page_pool(self, pool) -> None:
        """Scheduler hook: the admission PagePool that retiered weight HBM
        is credited to (grow on demote, shrink on promote)."""
        self._pool = pool

    def _page_bytes(self) -> float:
        pb = self._pool.cfg.page_bytes if self._pool is not None else 0.0
        return pb or self.kv_bytes_per_token() * self.page_size

    def _apply_retier(self, stage: int, delta: int) -> float:
        """Move `delta` resident slots of `stage` across the engine's tier
        boundary on the live state (counters only before weights load).
        Returns HBM bytes freed (< 0 on promote)."""
        eng = self.engine
        before = eng.demoted(stage)
        self._state, freed = eng.retier(self._state, stage, delta)
        moved = abs(eng.demoted(stage) - before)
        if moved:
            self._adapt["retier_events"] += 1
            key = "layers_demoted" if freed > 0 else "layers_promoted"
            self._adapt[key] += moved
            self._adapt["hbm_returned_bytes"] += max(freed, 0.0)
            self._sync_depth_rung()
            tr = get_tracer()
            if tr is not None:
                tr.instant(tr_ev.ENGINE_RETIER, track=tr_ev.TRACK_KV,
                           args={"stage": stage, "moved": moved,
                                 "direction": ("demote" if freed > 0
                                               else "promote"),
                                 "freed_bytes": freed})
        return freed

    def retier(self, stage: int, delta: int) -> float:
        """Move `delta` resident slots of `stage` across the tier boundary
        between steps of the live serve, by hand (positive: demote).
        Returns HBM bytes freed (< 0 on promote); the pool is not
        credited (planner- and reclaim-driven retiers are)."""
        return self._apply_retier(stage, delta)

    def _sync_depth_rung(self) -> None:
        """Tell the DepthController the tier boundary moved: the new rung
        (demoted slots) starts from the acceptance prior scaled by the
        live resident fraction. Without an engine the tier is fixed."""
        if self._depth is None or self.engine is None:
            return
        eng = self.engine
        rung = sum(eng.demoted(d) for d in range(eng.plan.n_stage))
        self._depth.note_rung(
            rung, prior=self.spec.acceptance * eng.resident_fraction())

    def _retier_to(self, stage: int, target_demoted: int) -> None:
        """Planner-driven: demote until `stage` has target_demoted slots
        streamed (whole-layer mapping of the planner's (α, β) blocks),
        capped by the engine's retier headroom."""
        eng = self.engine
        cap = min(eng.k_res_b[stage], eng.H)
        delta = min(target_demoted, cap) - eng.demoted(stage)
        if delta <= 0:
            return
        freed = self._apply_retier(stage, delta)
        if self._pool is not None and freed > 0:
            self._pool.grow(int(freed // self._page_bytes()))

    def note_kv_pages(self, pages_in_use: int, page_size: int) -> None:
        """Scheduler callback with page-granular KV occupancy: walk the
        planner's TS ladder (paper Eq. 5) on what admission holds, retier
        the live engine on fired plans, and promote reclaim-driven
        demotions back when occupancy leaves headroom."""
        if self.engine is None:
            return
        if self.planner is not None:
            for dev, step in self.planner.on_pages(pages_in_use, page_size):
                if dev < self.engine.plan.n_stage:
                    self._retier_to(dev, max(step.alpha, step.beta))
        self._maybe_promote()

    def note_slo_pressure(self, pressure: float) -> None:
        """Scheduler callback with SLO pressure (1 - the SLO engine's
        health): forward to the planner so its TS ladder fires early."""
        if self.planner is not None:
            self.planner.note_slo_pressure(pressure)

    def note_load_timing(self, stage: int, nbytes: float,
                         seconds: float) -> None:
        """Wall-clock weight-load observation from the engine's streaming
        path (a streamed stage's `nbytes` copied in `seconds`): feed the
        online re-fit and let it rebuild the planner's ladders if the
        measured bandwidth has drifted."""
        if self.refit is None:
            return
        now = time.monotonic()
        self.refit.observe_fetch(stage, nbytes, seconds, now=now)
        self.refit.maybe_refit(now)

    def reclaim_kv_pages(self, n_pages: int) -> int:
        """Scheduler pressure hook: before preempting a request, demote
        resident layers and return their HBM as device KV pages. Returns
        pages made available (0 = no retier headroom left)."""
        if self.engine is None or self._pool is None:
            return 0
        pb = self._page_bytes()
        if pb <= 0:
            return 0
        if self._reclaim_dry:
            return 0          # a slot frees < 1 page on this engine: the
        eng = self.engine     # geometry is constant, retrying just churns
        got = 0
        while got < n_pages:
            stage = max(range(eng.plan.n_stage), key=eng.demote_capacity)
            if eng.demote_capacity(stage) <= 0:
                break
            snap = dict(self._adapt)
            pages = int(self._apply_retier(stage, +1) // pb)
            if pages <= 0:
                # one slot frees less than a page: undo the demotion (a
                # grant of nothing would permanently slow the stage) and
                # its telemetry — no HBM was returned
                self._apply_retier(stage, -1)
                self._adapt = snap
                self._reclaim_dry = True
                break
            self._pool.grow(pages)
            self._grants.append((stage, pages))
            got += pages
        return got

    def _planner_demote_target(self, stage: int) -> int:
        """Slots the TS ladder currently demands demoted on `stage`."""
        if self.planner is None or stage >= len(self.planner.states):
            return 0
        st = self.planner.states[stage]
        return max(st.alpha, st.beta)

    def _maybe_promote(self) -> None:
        """Undo reclaim-driven demotions when pressure drops: withdraw the
        granted pages (only free capacity can leave the pool) and promote
        the layers back. Planner-driven demotions stay (the TS ladder is
        monotone in KV growth, paper §IV-D): promotion stops at the
        ladder's current demote target."""
        while self._grants and self._pool is not None:
            stage, pages = self._grants[-1]
            if self.engine.demoted(stage) - 1 \
                    < self._planner_demote_target(stage):
                break                    # would undo a ladder demotion
            if self._pool.free_pages() < pages + 2 * self.n_slots:
                break                    # still too close to the watermark
            self._pool.shrink(pages)
            self._apply_retier(stage, -1)
            self._grants.pop()

    @property
    def adapt_stats(self):
        if self.engine is None:
            return None
        return dict(self._adapt, layers_streamed_now=sum(
            self.engine.demoted(d) for d in range(self.engine.plan.n_stage)))

    @property
    def spec_stats(self):
        return self._ctl.stats.to_dict() if self._ctl is not None else None

    # -- protocol ----------------------------------------------------------------
    def start_batch(self, reqs: Sequence) -> List[Optional[int]]:
        tr = get_tracer()
        t0 = tr.now() if tr is not None else 0.0
        prompts = [self._materialize_prompt(r) for r in reqs]
        toks = self._pad_prompts(prompts)
        if toks.shape[0] < self.batch_width:  # pad batch with replicas
            toks = np.concatenate(
                [toks, np.tile(toks[-1:], (self.batch_width - toks.shape[0],
                                           1))], 0)
        toks_t = torch.from_numpy(toks).long().to(self.device)
        if self.prefix_cache:
            last = self._start_batch_prefix(reqs, prompts, toks_t)
        elif self.engine is not None:
            # through the engine itself: the weights do not fit the card,
            # so there is no prefill over all of them at once. Chunked
            # multi-query rounds where the family and the ring allow them,
            # else the prompt pass over the tiers, adopted by seed_cache
            state = self.engine.init_state(self.params, reuse=self._state)
            if self._engine_can_chunk(toks.shape[1]):
                logits, self._state = self.engine.prefill_partial(
                    state, toks_t, chunk=self.chunk,
                    steps=self.prefill_steps)
            else:                         # the prompt pass writes the state
                logits, cache = self.engine.prefill(
                    toks_t, cache=state, steps=self.prefill_steps)
                self._state = self.engine.seed_cache(state, cache)
            last = logits[:, -1]
        else:
            if self.paged:   # pages first: their constructor refuses a
                             # family they cannot hold before any work
                if self._paged_cache is not None:
                    self._paged_cache.reset_tables()
                else:
                    self._paged_cache = PagedDecodeCache(
                        self.cfg, toks.shape[0], self.max_len,
                        page_size=self.page_size, impl=self.impl,
                        device=self.device)
            cache = self._empty_cache()
            logits, cache = M.prefill(self.cfg, self.params, toks_t, cache,
                                      impl=self.impl, steps=self.prefill_steps)
            last = logits[:, -1]
            self._state = cache
            if self.paged:                # the dense prefill, into pages
                self._paged_cache.seed(cache)
                self._state = None
        tok = self._sample(last)
        self._cur = tok[:, None]
        host = tok.tolist()
        if tr is not None:
            tr.complete(tr_ev.ENGINE_PREFILL, ts=t0, dur=tr.now() - t0,
                        track=tr_ev.TRACK_PIPELINE,
                        args={"batch": len(reqs), "span": int(toks.shape[1])})
        if self.spec is not None:
            if self._ctl is None:
                from repro_torch.specdec import SpecDecodeController
                self._ctl = SpecDecodeController(
                    self.spec, self.sampler, self.cfg, self.batch_width,
                    target_params=self.params,
                    external_drafts=self._resident_engine,
                    device=self.device, impl=self.impl,
                    graph_pool=self.steps.pool)
            self._pos = int(toks.shape[1])    # left-padded prompt span
            for slot, p in enumerate(prompts):
                # drafts see the real (unpadded) prompt + the first token
                self._ctl.begin(slot, [int(t) for t in p] + [host[slot]])
        if self.prefix_cache:
            for slot in range(len(reqs)):
                self._slot_out[slot].append(host[slot])
        return [host[slot] for slot in range(len(reqs))]

    def decode_active(self, slots: Sequence[int]):
        if self.spec is not None:
            # a speculative round when a draft fits before the cache/ring
            # end (the last position is reserved for the committed token)
            if self._depth is not None:
                self._sync_depth_rung()
            k_cap = self.spec.k if self._depth is None else self._depth.k()
            k = min(k_cap, self._spec_cap - self._pos - 1)
            if slots and k >= 1:
                return self._decode_active_spec(slots, k)
        tr = get_tracer()
        t0 = tr.now() if tr is not None else 0.0
        self.rounds.append((0, 1))
        active = torch.zeros(self.batch_width, dtype=torch.bool,
                             device=self.device)
        active[list(slots)] = True
        if self.engine is not None:
            lg, self._state = self.engine.decode_requests(
                self._state, self._cur, active, steps=self.steps,
                live=len(slots))
        elif self.paged:
            if self.prefix_cache:
                self._ensure_room(self._paged_cache, 1)
            lg = self._paged_cache.step(self.params, self._cur,
                                        steps=self.steps)[:, 0]
        else:
            lg, self._state = M.decode_step(self.cfg, self.params,
                                            self._state, self._cur,
                                            impl=self.impl, steps=self.steps)
            lg = lg[:, 0]
        tok = self._sample(lg)
        self._pos += 1
        # freed slots keep replaying their last token as batch padding
        self._cur = torch.where(active[:, None], tok[:, None], self._cur)
        host = tok.tolist()
        if self.prefix_cache:
            for s in slots:
                self._slot_out[s].append(host[s])
        if self.spec is not None:             # keep the drafts in step on
            for s in slots:                   # the plain fallback step
                self._ctl.observe(s, [host[s]])
        if tr is not None:
            tr.complete(tr_ev.ENGINE_DECODE, ts=t0, dur=tr.now() - t0,
                        track=tr_ev.TRACK_PIPELINE,
                        args={"slots": len(slots)})
        return {s: host[s] for s in slots}

    def _decode_active_spec(self, slots: Sequence[int], k: int):
        """One speculative round: k drafts per live slot, verified in ONE
        multi-query pass (one weight stream through an engine); commit the
        lockstep-min accepted prefix, roll the rejected suffix back (pos
        reset or block-table truncation)."""
        tr = get_tracer()
        t0 = tr.now() if tr is not None else 0.0
        cur = self._cur.cpu().numpy()                      # (B, 1)
        mat = np.tile(cur, (1, 1 + k))                     # padding: replicas
        active = np.zeros(self.batch_width, bool)
        active[list(slots)] = True
        proposals = {}
        if self._resident_engine:
            # the self-draft on the engine: k resident-only steps batched
            # across all live slots, rolled back before the verify pass
            draft = self._draft_resident(active, k)
            for s in slots:
                proposals[s] = (draft[s], None)            # greedy point mass
                mat[s, 1:] = draft[s]
        else:
            for s in slots:
                toks, q = self._ctl.propose(s, k)
                proposals[s] = (toks, q)
                mat[s, 1:] = toks
        mat_t = torch.from_numpy(mat).to(self.device)
        if self.engine is not None:
            lg, self._state = self.engine.verify_requests(
                self._state, mat_t, active, steps=self.steps)
        elif self.paged:
            if self.prefix_cache:
                self._ensure_room(self._paged_cache, 1 + k)
            lg = self._paged_cache.verify(self.params, mat_t,
                                          steps=self.steps)
        else:
            lg, self._state = M.verify_step(self.cfg, self.params,
                                            self._state, mat_t,
                                            impl=self.impl, steps=self.steps)
        # acceptance reads each slot's rows where they lie: an argmax, or
        # the filtered softmax of rejection sampling, on the card
        committed = {s: self._ctl.verify(lg[s].float(), *proposals[s])
                     for s in slots}
        c = min(len(v) for v in committed.values())
        for s in slots:
            # accepted AND committed drafts only (truncated tokens are
            # drafted again next round and must not count twice)
            self._ctl.note_round(k, min(c, len(committed[s]) - 1))
        if self._depth is not None:
            self._depth.note_round(
                k * len(slots),
                sum(min(c, len(committed[s]) - 1) for s in slots))
        committed = {s: v[:c] for s, v in committed.items()}
        self.rounds.append((k, c))
        self._pos += c
        if self.engine is not None:
            self._state = self.engine.rollback(self._state, self._pos)
            self.engine.note_committed(self._pos, active)
        elif self.paged:
            self._paged_cache.commit(c)
        else:
            # rejected positions keep pos_ids > pos: invisible to every
            # read until decoding reaches them again
            self._state["pos"] = self._pos
        for s in slots:
            self._ctl.observe(s, committed[s])
            cur[s, 0] = committed[s][-1]
            if self.prefix_cache:
                # several tokens landed at once: donate the pages they
                # completed, so same-prefix traffic hits them mid-flight
                self._slot_out[s].extend(committed[s])
                self._donate_slot(s)
        self._cur = torch.from_numpy(cur).to(self.device)
        if tr is not None:
            tr.complete(tr_ev.ENGINE_VERIFY, ts=t0, dur=tr.now() - t0,
                        track=tr_ev.TRACK_PIPELINE,
                        args={"k": k, "committed": c, "slots": len(slots)})
        return committed

    def _draft_resident(self, active: np.ndarray, k: int) -> np.ndarray:
        """k greedy tokens per slot from the engine's resident-only step
        (the live tier boundary, the real slot caches), then a rollback to
        the committed position so the verify pass overwrites every drafted
        position. Returns (B, k) int64."""
        tr = get_tracer()
        t0 = tr.now() if tr is not None else 0.0
        eng = self.engine
        cur = self._cur
        out = []
        for _ in range(k):
            lg, self._state = eng.draft_requests(self._state, cur, active,
                                                 steps=self.draft_steps)
            cur = torch.argmax(lg[:, :self.cfg.vocab_size], -1)[:, None]
            out.append(cur)
        self._state = eng.rollback(self._state, self._pos)
        draft = torch.cat(out, 1).cpu().numpy()
        if tr is not None:
            tr.complete(tr_ev.ENGINE_DRAFT, ts=t0, dur=tr.now() - t0,
                        track=tr_ev.TRACK_PIPELINE, args={"k": k})
        return draft

    def _empty_cache(self) -> dict:
        """The single-device path's dense cache, empty: allocated once, then
        cleared in place each epoch (the captured steps' graphs read it at
        its address)."""
        if self._dense_cache is None:
            self._dense_cache = M.init_cache(self.cfg, self.batch_width,
                                             self.max_len, device=self.device)
            return self._dense_cache
        return M.clear_cache(self._dense_cache)

    @property
    def graph_stats(self):
        """The captured steps' counts: graphs captured and replayed, capture
        seconds, and the backend's graph pool bytes (the host drafts
        capture into it too), for the decode and verify steps (an
        engine's decode and verify passes); the prefills' (the dense
        prefill, the prefix cache's suffix rounds, an engine's prompt pass
        or prefill_partial rounds) as prefill_*; the drafts' (the
        engine's resident draft step, or the host model drafts' steps and
        their prefill in reset) as draft_*."""
        out = self.steps.stats()
        if self.engine is not None:
            drafts = [self.draft_steps]
        else:
            drafts = [st for d in (self._ctl.drafts or [])
                      for st in (getattr(d, "_steps", None),
                                 getattr(d, "_prefill_steps", None))
                      if st is not None] if self._ctl is not None else []
        for name, group in (("prefill_", (self.prefill_steps,
                                          self.suffix_steps)),
                            ("draft_", drafts)):
            for k in ("graphs", "captures", "replays", "capture_s"):
                out[name + k] = sum(d.stats()[k] for d in group)
        return out

    def join(self, slot: int, req) -> Optional[int]:
        raise NotImplementedError("batches are fixed at prefill time")

    def release(self, slot: int) -> None:
        """The slot keeps padding the fixed batch until the epoch drains.
        With the prefix cache, its committed pages become future prefix
        hits now (the table itself lives until the next epoch's
        reset_tables; the tree's increfs carry the pages on); with a paged
        engine its pages are freed now."""
        if self.prefix_cache:
            self._donate_slot(slot)
        if self.engine is not None and self.engine.paged:
            self.engine.free_slot(slot)

    def _engine_can_chunk(self, T: int) -> bool:
        """Chunked prefill rounds through the engine: the dense and MoE
        families (pure-KV state), rounds shorter than the ring, and a
        prompt that fits it (a round must not wrap the ring)."""
        chunk = min(self.chunk or T, T)
        return self.cfg.family in M.PURE_KV and chunk < self.engine.S_c \
            and T <= self.engine.S_c

    # -- radix prefix cache over the real paged pool ---------------------------
    def _prefix_structures(self):
        """Persistent pool + paged cache + radix tree, built at first use:
        they outlive epochs, which is the whole point of the cache."""
        if self._radix is None:
            B = self.batch_width
            max_pages = -(-self.max_len // self.page_size)
            extra = self._cache_pages or B * max_pages
            pool = PagePool(PagedKVConfig(page_size=self.page_size,
                                          device_pages=B * max_pages + extra))
            self._paged_cache = PagedDecodeCache(
                self.cfg, B, self.max_len, page_size=self.page_size,
                pool=pool, impl=self.impl, device=self.device)
            self._radix = RadixPrefixCache(pool)
        return self._paged_cache, self._radix

    def _ensure_room(self, pc, n_new_tokens: int) -> None:
        """Free device pages for the coming growth: unpinned radix pages
        are evicted first. Cached prefixes are reclaimable, live tables
        are not (the pool is sized so that this always suffices)."""
        need = sum(pc.pool.pages_for(pc.pos + n_new_tokens) - len(t.pages)
                   for t in pc.tables)
        short = need - pc.pool.free_pages()
        if short > 0:
            self._radix.evict(short)

    def _start_batch_prefix(self, reqs, prompts, toks):
        """Seed the epoch from shared pages where the radix tree has them,
        then prefill only the uncached suffix (chunked when configured).
        The shared-pos cache layout forces one matched length for the
        whole batch, so hits need equal-length prompts and align on the
        batch-minimum match; the batch's replica rows ride the last
        request's match. Unequal-length epochs run cold through the dense
        prefill, scattered into pages (their left-padded prefixes would
        key pad tokens, so they never donate). Returns the last
        position's logits (B, PV)."""
        pc, radix = self._prefix_structures()
        B = self.batch_width
        pc.reset_tables()                 # radix increfs keep shared pages
        self._slot_tokens = [None] * B
        self._slot_out = [[] for _ in range(B)]
        ps = self.page_size
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            cache = self._empty_cache()
            logits, cache = M.prefill(self.cfg, self.params, toks, cache,
                                      impl=self.impl, steps=self.prefill_steps)
            self._ensure_room(pc, int(cache["pos"]))
            pc.seed(cache)
            self._state = None
            return logits[:, -1]
        L = lens.pop()
        matches = [radix.match(p, max_pages=(L - 1) // ps) for p in prompts]
        m = min(n for _, n in matches)    # shared pos: batch-min match
        self._saved_tokens += m * len(reqs)
        for r in reqs:                    # visibility in serving reports
            r.cached_tokens = max(r.cached_tokens, m)
        while len(matches) < B:           # padded replicas ride the last
            matches.append(matches[-1])   # request's match
        if m > 0:
            tables = []
            for pages, _ in matches:
                t = BlockTable(ps)
                for pid in pages[:m // ps]:
                    pc.pool.incref_page(pid)
                t.pages = list(pages[:m // ps])
                t.tokens = m
                tables.append(t)
            pc.adopt_tables(tables, m)
        self._ensure_room(pc, L - pc.pos)
        last = pc.prefill(self.params, toks[:, pc.pos:], chunk=self.chunk,
                          steps=self.suffix_steps)
        for slot, p in enumerate(prompts):
            self._slot_tokens[slot] = [int(x) for x in p]
        self._state = None
        return last

    def _donate_slot(self, slot: int) -> None:
        """Insert `slot`'s committed pages (prompt + sampled output so
        far) into the radix tree. Slots whose prompt rode left-padding
        have no donatable tokens: their early positions hold pad KV."""
        if self._radix is None or self._slot_tokens is None \
                or self._slot_tokens[slot] is None:
            return
        toks = self._slot_tokens[slot] + self._slot_out[slot]
        table = self._paged_cache.tables[slot]
        self._radix.insert(toks, table.pages,
                           n_tokens=min(len(toks), table.tokens))

    @property
    def prefix_stats(self):
        if self._radix is None:
            return None
        r = self._radix
        return {"prefix_lookups": r.lookups, "prefix_hits": r.hits,
                "cached_tokens": r.cached_tokens(),
                "prefix_pages": r.n_pages,
                "prefill_tokens_saved": self._saved_tokens}
