"""Serving launcher of the port: LIME-Serve on one device (counterpart of
``repro.launch.serve``).

When the layer weights exceed the HBM budget (plan_for with n_stage 1),
the model runs through the InterleavedEngine: resident layers in HBM, the
rest streamed from pinned host memory, the layers drawn one at a time
from a seeded layer source so the whole model never sits on the card.
Otherwise the single-device path serves it.

  # on the card, the smoke-sized model, bursty traffic:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \\
      --smoke --pattern bursty --requests 4 --max-new 16

  # the engine with resident self-speculation on the CPU: a forced weight
  # budget streams half of the layers (plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.3-70b \\
      --smoke --layers 4 --device cpu --hbm-bytes 3e6 --spec \\
      --spec-draft resident --spec-k 3 --pattern bursty

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut (0: the config's own)")
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
    ap.add_argument("--spec-draft", choices=("resident",), default="resident")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.engine import (InterleavedEngine, plan_for,
                                         weight_budget)
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serving import (ContinuousBatchingScheduler, LimeServer,
                                     SamplerConfig, SchedulerConfig,
                                     cli_arrivals, requests_from_arrivals,
                                     summarize)
    from repro_torch.specdec import SpecConfig

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    width = 1 if args.pattern == "sporadic" else 4
    hbm = args.hbm_bytes
    if hbm is None and dev.type == "cuda":
        hbm = weight_budget(cfg, batch=width, max_len=args.max_len,
                            free_bytes=torch.cuda.mem_get_info(dev)[0])
    plan = None if hbm is None else \
        plan_for(cfg, 1, hbm_frac_for_weights=HBM_FRAC, hbm_bytes=hbm)
    engine = None
    if plan is not None and plan.k_off > 0:
        engine = InterleavedEngine(cfg, plan, mb=width, max_len=args.max_len,
                                   device=dev)
        params = M.init_params_by_layer(cfg, seed=args.seed, device=dev)
        print(f"engine: n_seg {plan.n_seg}, k_res {plan.k_res}, k_off "
              f"{plan.k_off}")
    else:
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(args.seed), device=dev)
    spec = SpecConfig(k=args.spec_k, draft=args.spec_draft) \
        if args.spec else None
    if spec is not None and engine is None:
        raise SystemExit("--spec drafts on the engine's resident tier: the "
                         "weights fit the budget, so no engine runs (lower "
                         "--hbm-bytes)")
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
                     page_size=args.page_size, device=dev)
    arrivals = cli_arrivals(args.pattern, args.requests, seed=args.seed,
                            prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new, gap_s=2.0,
                            burst_size=srv.slots, rate_rps=1.0,
                            n_templates=args.n_templates,
                            prefix_len=args.prefix_len)
    sched = ContinuousBatchingScheduler(srv.make_backend(), SchedulerConfig())
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
