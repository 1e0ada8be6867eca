"""Serving launcher of the port: LIME-Serve on one device (counterpart of
``repro.launch.serve``).

When the layer weights exceed the HBM budget, the model runs through the
InterleavedEngine: resident layers in HBM, the rest streamed from pinned
host memory, the layers drawn one at a time from a seeded layer source so
the whole model never sits on the card. Otherwise the single-device path
serves it. The plan comes from plan_for's budget rule (--plan uniform) or
from the paper's Alg. 1 over the H100's CostEnv (--plan hetero);
--adapt adds the online memory adaptation: page-granular admission and
an OnlinePlanner that retiers the live engine as KV pages grow.
The encoder-decoder family (seamless-m4t-medium) is refused before any
weight is drawn: the JAX package's serving route fails on it (its
M.prefill without enc_out raises KeyError 'xk'); it runs through the
model's entry points and the engine.

  # on the card, the smoke-sized model, bursty traffic:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \\
      --smoke --pattern bursty --requests 4 --max-new 16

  # the SSM and hybrid families (RWKV6-3B, Hymba-1.5B) on the
  # single-device path, the smoke-sized configs on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --smoke --device cpu --pattern bursty --requests 4 --max-new 8

  # ... and through the engine: a weight budget that streams 2 of 4 layers
  # (the prompt pass over the tiers, then seed_cache):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --smoke --layers 4 --device cpu --hbm-bytes 4e6 --pattern bursty
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --smoke --layers 4 --device cpu --hbm-bytes 4e6 --pattern bursty

  # the MoE family (DeepSeekMoE-16B; kimi-k2-1t-a32b likewise) on the
  # single-device path, smoke-sized on the CPU, and at full width on the
  # card (32.8 GB: it fits one H100 whole):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --smoke --device cpu --pattern bursty --requests 4 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --pattern bursty --requests 4 --prompt-len 512 --max-len 1024

  # ... and through the engine, which streams a homogeneous stack only:
  # --fold-dense makes the dense first layer an MoE layer (widths kept)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --smoke --layers 4 --fold-dense --device cpu --hbm-bytes 4e6 \\
      --spec --spec-draft resident --spec-k 3 --pattern bursty

  # the engine with resident self-speculation on the CPU: a forced weight
  # budget streams half of the layers (plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \\
      --smoke --layers 4 --device cpu --hbm-bytes 3e6 --spec \\
      --spec-draft resident --spec-k 3 --pattern bursty

  # the paper's planning on the CPU: Alg. 1's plan, and the OnlinePlanner
  # retiering the live engine under paged admission:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \\
      --smoke --layers 4 --device cpu --hbm-bytes 3e6 --plan hetero \\
      --pattern bursty --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \\
      --smoke --layers 4 --device cpu --hbm-bytes 3.2e6 --adapt \\
      --retier-headroom 1 --page-size 8 --pattern sporadic --requests 4

  # speculative decoding on the single-device path: n-gram drafts (or
  # --spec-draft model / resident), rejection sampling at temperature > 0:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \
      --smoke --device cpu --spec --spec-draft ngram --spec-k 3 \
      --pattern bursty --requests 4 --temperature 0.8

  # paged KV with the radix prefix cache (single-device path) on
  # template-sharing traffic:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \\
      --smoke --device cpu --prefix-cache --page-size 8 --prefill-chunk 8 \\
      --pattern shared_prefix --n-templates 1 --prefix-len 24 \\
      --prompt-len 32 --requests 8 --max-new 8

  # traced: the flight recorder's Chrome trace (Perfetto; a .jsonl path
  # writes JSONL), the SLO engine's burn-rate targets and a live dashboard
  # every 0.5 s of the backend's clock:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \
      --smoke --device cpu --pattern bursty --requests 4 --max-new 8 \
      --trace out.json --slo --dash-interval 0.5

  # fleet mode: N single-device replicas over one set of weight tensors
  # behind the prefix-affine router (each replica its own KV pool, radix
  # tree and CUDA graphs); the report is the FleetReport (aggregate, per
  # replica, router stats, membership):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \
      --smoke --device cpu --replicas 2 --router prefix --prefix-cache \
      --page-size 8 --pattern shared_prefix --n-templates 2 \
      --prefix-len 24 --prompt-len 32 --requests 8 --max-new 8

  # the measured-profile autotuner: time the device (matmul, HBM scale, pinned
  # copies both ways), save the profile to a tune cache, and plan Alg. 1
  # and the OnlinePlanner from it; the cache's swept split counts
  # (python -m repro_torch.tune.sweep --out PATH) are installed before
  # any backend captures; a second launch plans from the cache alone:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \
      --smoke --layers 4 --device cpu --hbm-bytes 3.2e6 --adapt --refit \
      --measure --profile-cache tune.json --pattern bursty --requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \
      --smoke --layers 4 --device cpu --hbm-bytes 3.2e6 --adapt --refit \
      --profile-cache tune.json --pattern bursty --requests 4

Prints one line per request, then the JSON ServingReport (with an "slo"
section under --slo), or the FleetReport's JSON with --replicas > 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

# share of the weight budget resident layers may take; the rest holds
# activations (a 512-position prefill round's logits alone are 0.5 GB at
# LLaMA-3.3-70B's vocabulary)
HBM_FRAC = 0.92


def cost_env(cfg, hbm_bytes: float, *, width: int, prompt_len: int,
             load_bw: float = 0.0, measured=None):
    """The one-card CostEnv the launcher plans with: the H100 profile
    with the weight budget's resident share (hbm_bytes · HBM_FRAC, the
    bytes plan_for plans into; activations live in the rest) and the
    card's timed rates from one source, where given: `measured`, a
    MeasuredProfile (the tune cache's: its MEASURED_FIELDS replace the
    typed ones; memory stays the enforced budget), or `load_bw`, an H2D
    rate timed alone (``tune.measure.measure_stream_bw``). One card has no
    network hop: activations pass between segments in HBM, so bw_net is
    the HBM rate and the per-message latency 0 (a segment's handoff costs
    nothing; load time an idle compute stream cannot cover shows up as
    T_uncover)."""
    from repro_torch.core.cost_model import CostEnv, Workload
    from repro_torch.core.profiles import H100_SXM
    from repro_torch.tune.profiles import MEASURED_FIELDS
    if load_bw and measured is not None:
        raise ValueError("cost_env: the timed rates come from one source, "
                         "load_bw or measured")
    timed = {f: getattr(measured, f) for f in MEASURED_FIELDS
             if getattr(measured, f) > 0} if measured is not None \
        else {"load_bw": load_bw} if load_bw else {}
    dev = dataclasses.replace(H100_SXM, **timed,
                              mem_bytes=hbm_bytes * HBM_FRAC)
    return CostEnv([dev], dev.mem_bw,
                   Workload(cfg, mb=width, ctx=prompt_len, n_micro=1),
                   net_latency=0.0)


def hetero_plan(cfg, hbm_bytes: float, *, width: int, prompt_len: int,
                n_emp: int, load_bw: float = 0.0, measured=None):
    """Alg. 1 (allocate_with_retry) over cost_env: returns (result, env,
    scale). A scale above 1 means the plan assumes more memory than the
    budget holds (the JAX launcher's relaxation ladder); the caller logs
    or refuses it."""
    from repro_torch.core.offline_scheduler import allocate_with_retry

    def mk_env(scale):
        return cost_env(cfg, hbm_bytes * scale, width=width,
                        prompt_len=prompt_len, load_bw=load_bw,
                        measured=measured)
    r, env, scale = allocate_with_retry(mk_env, cfg.n_layers, n_emp=n_emp)
    if not r.feasible:
        raise SystemExit(f"hetero allocation infeasible: {r.reason}")
    return r, env, scale


def make_fleet(cfg, params, *, replicas: int, n_slots: int, max_len: int,
               sampler=None, spec=None, prefix_cache: bool = False,
               prefill_chunk_tokens: int = 0, page_size: int = 64,
               router: str = "prefix", seed: int = 0, slo=None,
               device=None):
    """The fleet the launcher serves with --replicas: `replicas`
    single-device EngineBackend(engine=None) replicas over the same
    `params` tensors (the weights are on the card once; each replica
    holds its own KV cache or page pool, radix tree and CUDA graphs),
    each behind its own reserve scheduler at the backends' page size,
    which the router's prefix digests key on (the JAX launcher's
    SchedulerConfig() keeps 64 whatever --page-size says, so its prefix
    policy matches nothing on prompts of 64 tokens or fewer), under a
    FleetRouter of
    policy `router`. `slo`, a zero-argument factory, gives
    each replica its own SLOEngine (health is a per-replica signal: the
    router sheds off the breaching one). Returns the Fleet."""
    from repro_torch.fleet import Fleet, Replica, RouterConfig
    from repro_torch.serving import EngineBackend, SchedulerConfig
    scfg = SchedulerConfig(page_size=page_size)
    reps = [Replica(i, EngineBackend(
                cfg, params, engine=None, n_slots=n_slots, max_len=max_len,
                sampler=sampler, spec=spec, prefix_cache=prefix_cache,
                prefill_chunk_tokens=prefill_chunk_tokens,
                page_size=page_size, device=device), scfg)
            for i in range(replicas)]
    if slo is not None:
        for rep in reps:
            rep.sched.attach_slo(slo())
    return Fleet(reps, config=RouterConfig(policy=router, seed=seed))


# how far past the replicas' latest clock a fleet serve's arrivals start
ARRIVAL_LEAD_S = 1.0


def rebase_arrivals(fleet, reqs) -> None:
    """Move arrival times relative to the serve onto the fleet's replicas'
    wall clocks, ARRIVAL_LEAD_S past the latest of them. In the clocks'
    past every arrival would be routed before any replica took a step, on
    queues that read empty (a burst would land whole on r0); ahead of them,
    each replica's first step jumps its clock to its first arrival and
    takes in what was routed to it by then, so the router sees that queue
    when it places the arrivals after it. The arrival waits skew the
    clocks, not the wall (EngineBackend.advance_to), so the lead costs no
    time."""
    base = max(rep.now() for rep in fleet.replicas) + ARRIVAL_LEAD_S
    for r in reqs:
        r.arrival_s += base


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut (0: the config's own)")
    ap.add_argument("--fold-dense", action="store_true",
                    help="MoE: run the dense first layers as MoE layers "
                         "(first_dense_layers=0, widths kept), the "
                         "homogeneous stack the engine streams")
    ap.add_argument("--pattern", choices=("sporadic", "bursty", "poisson",
                                          "trace", "shared_prefix",
                                          "multiturn"),
                    default="sporadic")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gap-s", type=float, default=2.0)
    ap.add_argument("--rate-rps", type=float, default=1.0)
    ap.add_argument("--arrival-trace", default=None,
                    help="JSON arrival trace for --pattern trace: rows of "
                         "[time_s, prompt_len, max_new_tokens]")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per conversation (--pattern multiturn)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet mode: N single-device replicas over one "
                         "set of weight tensors behind the router, each "
                         "its own backend and scheduler (the engine is "
                         "not used: one engine cannot back N replicas)")
    ap.add_argument("--router", default="prefix",
                    choices=("prefix", "sticky", "random", "roundrobin"),
                    help="fleet placement policy (--replicas > 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--hbm-bytes", type=float, default=None,
                    help="bytes for layer weights to plan for (default on "
                         "the card: free memory less the KV cache, two "
                         "layer buffers and the shared weights)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill positions per round, through the engine "
                         "or the prefix cache's paged pool (0: the whole "
                         "prompt)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over a paged KV pool "
                         "(single-device path)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="KV page size (prefix sharing is page-granular: "
                         "pick <= the prefix length for short prompts)")
    ap.add_argument("--n-templates", type=int, default=4,
                    help="shared prompt templates (--pattern shared_prefix)")
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="template tokens per prompt (--pattern "
                         "shared_prefix)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding: draft k tokens, verify "
                         "them in one pass")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--spec-draft", choices=("ngram", "model", "resident"),
                    default="ngram",
                    help="draft provider: prompt lookup, the registry's "
                         "gemma3-1b smoke model, or the target's own "
                         "resident tier (the engine's live tier, or the "
                         "bottom half of the stack without an engine)")
    ap.add_argument("--plan", choices=("uniform", "hetero"),
                    default="uniform",
                    help="uniform: plan_for's budget rule; hetero: the "
                         "paper's offline allocation scheduler (Alg. 1) "
                         "over the H100's cost model")
    ap.add_argument("--adapt", action="store_true",
                    help="online memory adaptation: paged admission, and "
                         "an OnlinePlanner walking KV page occupancy "
                         "retiers the live engine (resident layers demote "
                         "to the streamed tier, their HBM becomes pages)")
    ap.add_argument("--retier-headroom", type=int, default=1,
                    help="streamed-store slots reserved for runtime "
                         "demotions (--adapt)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="flight-recorder output: Chrome trace-event JSON "
                         "loadable in Perfetto, or JSONL when PATH ends in "
                         ".jsonl")
    ap.add_argument("--slo", action="store_true",
                    help="online SLO engine: burn-rate alerts on TTFT / "
                         "TPOT / goodput / reject targets, its pressure fed "
                         "to the planner; the report gains an 'slo' section")
    ap.add_argument("--slo-ttft", type=float, default=8.0,
                    help="TTFT p99 threshold in seconds (--slo)")
    ap.add_argument("--slo-tpot", type=float, default=1.0,
                    help="TPOT p50 threshold in seconds/token (--slo)")
    ap.add_argument("--dash-interval", type=float, default=0.0,
                    help="seconds between live dashboard snapshots on "
                         "stdout (0 = off; the backend's clock)")
    ap.add_argument("--measure", action="store_true",
                    help="measured-profile autotune: run the "
                         "microbenchmark harness on this device and plan "
                         "from timed FLOP/s, HBM and stream bandwidth "
                         "instead of the typed profile; the profile "
                         "persists to --profile-cache")
    ap.add_argument("--profile-cache", default=None, metavar="PATH",
                    help="tune-cache JSON (measured profiles + swept "
                         "kernel split counts, keyed by device kind); "
                         "loaded at startup (the tuned split counts are "
                         "installed before any backend captures) and "
                         "updated by --measure. Default: ~/.cache/"
                         "repro_torch/tune_cache.json when --measure is set")
    ap.add_argument("--refit", action="store_true",
                    help="online re-fit (engine path with --adapt): build "
                         "an OnlineRefit over the planner, which EWMA-"
                         "tracks weight-load timings given to the backend's "
                         "note_load_timing and rebuilds the planner's TS "
                         "ladders when they drift >20%% from the planned "
                         "model; the engine times none of its own copies, "
                         "so in a plain serve nothing feeds it and it "
                         "changes nothing")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """The launcher's serve: parses `argv`, tunes, plans, serves and
    prints as ``main`` does, and returns what it served: {"done": the
    requests, "report": the report's dict, "backend", "engine" (open:
    the caller closes it), "env" (the CostEnv planned with, or None),
    "measured" (the MeasuredProfile planned from, or None), "installed"
    (tuned kernel configs installed)}; with --replicas {"fleet": the
    FleetResult}."""
    args = _parse(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.engine import (InterleavedEngine,
                                         packed_layer_bytes, plan_for,
                                         weight_budget)
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.obs.log import get_logger
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.serving.backend import refuse_encdec
    from repro_torch.serving import (ContinuousBatchingScheduler, LimeServer,
                                     SamplerConfig, SchedulerConfig,
                                     cli_arrivals, requests_from_arrivals,
                                     summarize)
    from repro_torch.specdec import SpecConfig

    dev = resolve_device(args.device)
    log = get_logger("repro_torch.launch.serve")
    # the tune cache: its split counts are installed before any backend
    # is built (a CUDA graph keeps the split it was captured with);
    # --measure times the device and persists the profile
    measured, installed = None, 0
    if args.measure or args.profile_cache:
        from repro_torch.core.profiles import H100_SXM
        from repro_torch.tune import TuneCache, default_cache_path
        from repro_torch.tune.measure import device_kind, measure_profile
        cache_path = args.profile_cache or default_cache_path()
        tune_cache = TuneCache.load(cache_path)
        dk = device_kind(dev)
        installed = tune_cache.install(dk)
        if installed:
            log.info(f"installed {installed} tuned kernel configs for {dk} "
                     f"from {cache_path}")
        measured = tune_cache.get_profile(dk)
        if args.measure:
            log.info("running microbenchmark harness (--measure)...")
            # the card's sizes: a 8192^3 matmul and 256 MiB copies fill
            # it; JAX's 1024 and 32 MiB on the CPU
            card = dev.type == "cuda"
            measured = measure_profile(dk, H100_SXM, n=8192 if card else 1024,
                                       mb=256 if card else 32, device=dev)
            tune_cache.put_profile(measured)
            tune_cache.save(cache_path)
            log.info(f"measured profile for {dk}: "
                     f"flops={measured.flops:.3g} mem_bw={measured.mem_bw:.3g} "
                     f"load_bw={measured.load_bw:.3g} -> {cache_path}")
        elif measured is not None:
            log.info(f"planning from cached measured profile for {dk} "
                     f"(measured {measured.measured_at})")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.fold_dense:
        cfg = dataclasses.replace(cfg, first_dense_layers=0)
    refuse_encdec(cfg)                  # before any weight is drawn
    width = 1 if args.pattern == "sporadic" else 4
    hbm = args.hbm_bytes
    if hbm is None and dev.type == "cuda":
        hbm = weight_budget(cfg, batch=width, max_len=args.max_len,
                            free_bytes=torch.cuda.mem_get_info(dev)[0])
    fleet_mode = args.replicas > 1
    if fleet_mode:
        if args.adapt or args.plan == "hetero":
            raise SystemExit("--replicas serves the single-device path on "
                             "every replica; --adapt and --plan hetero plan "
                             "the engine")
        hbm = None                      # no engine: the replicas share params
    plan = env = None
    if hbm is not None and (args.plan == "hetero" or args.adapt):
        # the measured profile, else the typed one with the H2D rate of
        # pinned copies timed now
        timed = measured
        if timed is None and dev.type == "cuda":
            from repro_torch.core.profiles import H100_SXM
            from repro_torch.tune.measure import (device_kind,
                                                  measure_stream_bw)
            from repro_torch.tune.profiles import from_analytic
            rate = measure_stream_bw(src=torch.empty(
                (2, 128 << 20), dtype=torch.uint8, pin_memory=True),
                reps=6, device=dev)["h2d"][0]
            timed = from_analytic(H100_SXM, device_kind=device_kind(dev),
                                  source="h2d", load_bw=rate)
        env = cost_env(cfg, hbm, width=width, prompt_len=args.prompt_len,
                       measured=timed)
    if hbm is not None and args.plan == "hetero":
        r, env, scale = hetero_plan(
            cfg, hbm, width=width, prompt_len=args.prompt_len,
            n_emp=args.max_len, measured=timed)
        plan = r.plan
        if scale > 1.0:
            print(f"hetero allocation relaxed memory x{scale:.2f} for "
                  f"feasibility")
        print(f"Alg. 1: {r.reason or 'offloading'}; candidates (n_seg, "
              f"T_total s) {[(n, round(t, 4)) for n, t in r.candidates]}")
    elif hbm is not None:
        # plan_for counts cfg.layer_params(); where a packed layer holds
        # more (Hymba), the budget is given in those units, so the plan's
        # resident layers fit it by the bytes they really take
        packed, counted = packed_layer_bytes(cfg), cfg.layer_params() * 2
        plan = plan_for(cfg, 1, hbm_frac_for_weights=HBM_FRAC,
                        hbm_bytes=hbm * min(counted / packed, 1.0))
    engine = planner = None
    if plan is not None and plan.k_off > 0:
        try:
            engine = InterleavedEngine(
                cfg, plan, mb=width, max_len=args.max_len,
                retier_headroom=args.retier_headroom if args.adapt else 0,
                device=dev)
        except ValueError as e:          # a stack that is not homogeneous
            raise SystemExit(f"the engine refuses {cfg.name}: {e} "
                             f"(--fold-dense)")
        n_res = len(engine.resident_layer_ids())
        # residency by the bytes a resident layer really holds: the
        # engine's packed layer, which cfg.layer_params() (what Alg. 1
        # prices) misjudges for the recurrent families
        if args.plan == "hetero" and n_res * engine.layer_bytes \
                > hbm * HBM_FRAC:
            raise SystemExit(f"Alg. 1's plan holds {n_res} resident layers "
                             f"({n_res * engine.layer_bytes:.4g} B packed), "
                             f"more than the budget's {hbm * HBM_FRAC:.4g} B "
                             f"share holds")
        params = M.init_params_by_layer(cfg, seed=args.seed, device=dev)
        if env is not None:
            env.evaluate(plan)
        print(f"engine: n_seg {plan.n_seg}, k_res {plan.k_res}, k_off "
              f"{plan.k_off}, resident layers {n_res}, family "
              f"{cfg.family.value}, packed layer {engine.layer_bytes} B (the "
              f"config's count "
              f"{cfg.layer_params() * 2} B), streamed a pass "
              f"{(cfg.n_layers - n_res) * engine.layer_bytes} B"
              + (f", predicted T_total {plan.t_total:.4f} s (T_comp "
                 f"{plan.t_comp:.4f}, T_comm {plan.t_comm:.2e}, T_uncover "
                 f"{plan.t_uncover:.4f})" if env is not None else ""))
        if args.adapt:
            from repro_torch.core.online_planner import OnlinePlanner
            planner = OnlinePlanner(env, plan,
                                    horizon_tokens=4 * width * args.max_len)
            print("planner ladder (tokens, alpha, beta): "
                  f"{[(s.threshold_tokens, s.alpha, s.beta) for s in planner.ladders[0]]}")
    else:
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(args.seed), device=dev)
    spec = SpecConfig(k=args.spec_k, draft=args.spec_draft,
                      seed=args.seed) if args.spec else None
    if args.adapt and engine is None:
        raise SystemExit("--adapt retiers the engine's tiers: the weights fit "
                         "the budget, so no engine runs (lower --hbm-bytes)")
    if args.prefix_cache and engine is not None:
        raise SystemExit("--prefix-cache shares pages of the single-device "
                         "paged pool; this model runs through the engine")
    if args.refit and planner is None:
        log.info("--refit needs an OnlinePlanner to rebuild (engine path "
                 "with --adapt); ignoring")
    srv = LimeServer(cfg, params, engine=engine, max_len=args.max_len,
                     pattern="sporadic" if args.pattern == "sporadic"
                     else "bursty",
                     sampler=SamplerConfig(temperature=args.temperature,
                                           seed=args.seed),
                     spec=spec, prefix_cache=args.prefix_cache,
                     prefill_chunk_tokens=args.prefill_chunk,
                     page_size=args.page_size, planner=planner,
                     refit=args.refit, device=dev)
    arrivals = cli_arrivals(args.pattern, args.requests, seed=args.seed,
                            prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new, gap_s=args.gap_s,
                            burst_size=srv.slots, rate_rps=args.rate_rps,
                            n_templates=args.n_templates,
                            prefix_len=args.prefix_len, turns=args.turns,
                            trace=args.arrival_trace)
    # adaptation rides page-granular admission: note_kv_pages feeds the
    # planner, and the scheduler reclaims retier headroom before it preempts
    scfg = SchedulerConfig(kv_policy="paged", page_size=args.page_size) \
        if args.adapt else SchedulerConfig()
    reqs = requests_from_arrivals(arrivals, vocab_size=cfg.vocab_size)

    def mk_slo():
        from repro_torch.obs.slo import SLOEngine, default_targets
        return SLOEngine(default_targets(ttft_p99_s=args.slo_ttft,
                                         tpot_p50_s=args.slo_tpot))
    if fleet_mode:
        return {"fleet": _serve_fleet(args, cfg, params, srv, spec, reqs,
                                      mk_slo if args.slo else None, dev)}
    backend = srv.make_backend()
    # flight recorder: installed before the scheduler is built (it takes
    # the tracer and binds its clock to the backend at construction)
    tracer = None
    if args.trace:
        tracer = Tracer()
        set_tracer(tracer)
    slo = None
    try:
        sched = ContinuousBatchingScheduler(backend, scfg)
        if args.slo:
            slo = mk_slo()
            sched.attach_slo(slo)
        if args.dash_interval > 0:
            from repro_torch.obs.dashboard import Dashboard
            dash = Dashboard(slo=slo, sched=sched, tracer=tracer,
                             interval_s=args.dash_interval)
            sched.begin(reqs)
            while sched.step():
                snap = dash.tick(sched.now())
                if snap is not None:
                    print(snap)
            done = sched.finish_run()
            print(dash.render(sched.now()))
        else:
            done = sched.serve(reqs)
    finally:
        if tracer is not None:
            set_tracer(None)
    if tracer is not None:
        tracer.export(args.trace)
        log.info(f"trace: {args.trace} ({tracer.emitted} events, "
                 f"{tracer.dropped} dropped)")
    _print_requests(done)
    report = summarize(done, pattern=args.pattern,
                       backend="engine" if engine else
                       ("paged-prefix" if args.prefix_cache else "fallback"),
                       stats=sched.stats)
    doc = report.to_dict()
    if slo is not None:
        doc["slo"] = slo.snapshot(sched.now())
    print(json.dumps(doc, indent=2))
    return {"done": done, "report": doc, "backend": backend,
            "engine": engine, "env": env, "measured": measured,
            "installed": installed}


def main(argv=None) -> int:
    out = run(argv)
    if out.get("engine") is not None:
        out["engine"].close()
    return 0


def _print_requests(done):
    for r in sorted(done, key=lambda r: r.rid):
        status = "REJECTED" if r.rejected else \
            f"ttft {r.ttft_s:.2f}s total {r.latency_s:.2f}s " \
            f"out[:8]={r.output[:8]}"
        print(f"req {r.rid}: {status}")


def _serve_fleet(args, cfg, params, srv, spec, reqs, mk_slo, dev):
    """--replicas N: make_fleet's replicas behind the router; prints one
    line per request and the FleetReport's JSON."""
    from repro_torch.obs.log import get_logger
    from repro_torch.obs.trace import Tracer, set_tracer
    # the tracer goes in before the replicas' schedulers take it
    tracer = None
    if args.trace:
        tracer = Tracer()
        set_tracer(tracer)
    try:
        fleet = make_fleet(cfg, params, replicas=args.replicas,
                           n_slots=srv.slots, max_len=args.max_len,
                           sampler=srv.sampler, spec=spec,
                           prefix_cache=args.prefix_cache,
                           prefill_chunk_tokens=args.prefill_chunk,
                           page_size=args.page_size, router=args.router,
                           seed=args.seed, slo=mk_slo, device=dev)
        rebase_arrivals(fleet, reqs)
        result = fleet.run(reqs)
    finally:
        if tracer is not None:
            set_tracer(None)
    if tracer is not None:
        tracer.export(args.trace)
        get_logger("repro_torch.launch.serve").info(
            f"trace: {args.trace} ({tracer.emitted} events, "
            f"{tracer.dropped} dropped)")
    _print_requests(result.requests)
    print(result.report(pattern=args.pattern,
                        backend=f"fleet{args.replicas}").to_json())
    return result


if __name__ == "__main__":
    raise SystemExit(main())
