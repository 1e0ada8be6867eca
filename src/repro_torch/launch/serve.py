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

Prints one line per request, then the JSON ServingReport.
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
             load_bw: float = 0.0):
    """The one-card CostEnv the launcher plans with: the H100 profile
    with the weight budget's resident share (hbm_bytes · HBM_FRAC, the
    bytes plan_for plans into; activations live in the rest) and, where
    given, a measured H2D rate. One card has no network hop: activations
    pass between segments in HBM, so bw_net is the HBM rate and the
    per-message latency 0 (a segment's handoff costs nothing; load time
    an idle compute stream cannot cover shows up as T_uncover)."""
    from repro_torch.core.cost_model import CostEnv, Workload
    from repro_torch.core.profiles import H100_SXM
    dev = dataclasses.replace(H100_SXM, mem_bytes=hbm_bytes * HBM_FRAC,
                              load_bw=load_bw or H100_SXM.load_bw)
    return CostEnv([dev], dev.mem_bw,
                   Workload(cfg, mb=width, ctx=prompt_len, n_micro=1),
                   net_latency=0.0)


def hetero_plan(cfg, hbm_bytes: float, *, width: int, prompt_len: int,
                n_emp: int, load_bw: float = 0.0):
    """Alg. 1 (allocate_with_retry) over cost_env: returns (result, env,
    scale). A scale above 1 means the plan assumes more memory than the
    budget holds (the JAX launcher's relaxation ladder); the caller logs
    or refuses it."""
    from repro_torch.core.offline_scheduler import allocate_with_retry

    def mk_env(scale):
        return cost_env(cfg, hbm_bytes * scale, width=width,
                        prompt_len=prompt_len, load_bw=load_bw)
    r, env, scale = allocate_with_retry(mk_env, cfg.n_layers, n_emp=n_emp)
    if not r.feasible:
        raise SystemExit(f"hetero allocation infeasible: {r.reason}")
    return r, env, scale


def measure_h2d(src, reps: int = 6) -> float:
    """Bytes/s of one-row copies from the pinned host tensor `src` (rows
    of one streamed layer, or any pinned rows) into HBM on a side stream,
    the copies the engine's streamer issues."""
    import torch
    buf = torch.empty_like(src[0], device="cuda")
    side = torch.cuda.Stream()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        buf.copy_(src[0], non_blocking=True)
        a.record(side)
        for i in range(reps):
            buf.copy_(src[i % src.shape[0]], non_blocking=True)
        b.record(side)
    b.synchronize()
    return reps * buf.numel() * buf.element_size() / (a.elapsed_time(b) * 1e-3)


def main(argv=None):
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
                                          "shared_prefix", "multiturn"),
                    default="sporadic")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
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
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.engine import (InterleavedEngine,
                                         packed_layer_bytes, plan_for,
                                         weight_budget)
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serving.backend import refuse_encdec
    from repro_torch.serving import (ContinuousBatchingScheduler, LimeServer,
                                     SamplerConfig, SchedulerConfig,
                                     cli_arrivals, requests_from_arrivals,
                                     summarize)
    from repro_torch.specdec import SpecConfig

    dev = resolve_device(args.device)
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
    plan = env = None
    if hbm is not None and (args.plan == "hetero" or args.adapt):
        rate = measure_h2d(torch.empty((2, 128 << 20), dtype=torch.uint8,
                                       pin_memory=True)) \
            if dev.type == "cuda" else 0.0
        env = cost_env(cfg, hbm, width=width, prompt_len=args.prompt_len,
                       load_bw=rate)
    if hbm is not None and args.plan == "hetero":
        r, env, scale = hetero_plan(
            cfg, hbm, width=width, prompt_len=args.prompt_len,
            n_emp=args.max_len, load_bw=env.devices[0].load_bw)
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
    srv = LimeServer(cfg, params, engine=engine, max_len=args.max_len,
                     pattern="sporadic" if args.pattern == "sporadic"
                     else "bursty",
                     sampler=SamplerConfig(temperature=args.temperature,
                                           seed=args.seed),
                     spec=spec, prefix_cache=args.prefix_cache,
                     prefill_chunk_tokens=args.prefill_chunk,
                     page_size=args.page_size, planner=planner, device=dev)
    arrivals = cli_arrivals(args.pattern, args.requests, seed=args.seed,
                            prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new, gap_s=2.0,
                            burst_size=srv.slots, rate_rps=1.0,
                            n_templates=args.n_templates,
                            prefix_len=args.prefix_len)
    # adaptation rides page-granular admission: note_kv_pages feeds the
    # planner, and the scheduler reclaims retier headroom before it preempts
    scfg = SchedulerConfig(kv_policy="paged", page_size=args.page_size) \
        if args.adapt else SchedulerConfig()
    sched = ContinuousBatchingScheduler(srv.make_backend(), scfg)
    done = sched.serve(requests_from_arrivals(arrivals,
                                              vocab_size=cfg.vocab_size))
    for r in sorted(done, key=lambda r: r.rid):
        status = "REJECTED" if r.rejected else \
            f"ttft {r.ttft_s:.2f}s total {r.latency_s:.2f}s " \
            f"out[:8]={r.output[:8]}"
        print(f"req {r.rid}: {status}")
    report = summarize(done, pattern=args.pattern,
                       backend="engine" if engine else
                       ("paged-prefix" if args.prefix_cache else "fallback"),
                       stats=sched.stats)
    print(json.dumps(report.to_dict(), indent=2))
    if engine is not None:
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
