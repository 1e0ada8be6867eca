#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one CUDA card

Phases; any failure exits non-zero without the final ``ok`` line:

0. card and build: the card's name and power limit (nvidia-smi), the
   kernels built from ``src/repro_torch/csrc`` (nvcc, sm_90a), TF32 off
   for every fp32 reference product. The SASS of the Hopper mainloop
   (``csrc/attention_sm90.cuh``) in each of its three sources (flash,
   kernels 4 and 5) must hold HGMMA (wgmma) and UTMALDG (TMA), and each of
   the four instantiations of the Hopper decode body (decode_sm90_kernel
   in ``csrc/decode_attention.cuh``) in kernels 1 and 3 and of the verify
   body (verify_sm90_kernel in ``csrc/mq_decode_attention.cuh``) in
   kernels 4 and 5 HMMA (mma.sync) and LDGSTS (cp.async) (cuobjdump), and
   so must each of the 12 instantiations of the scans' chunked bodies
   (wkv_scan_kernel_chunked, ssm_scan_kernel_chunked in
   ``csrc/scan_chunked.cuh``), with no spills; no second pass
   (decode_combine_kernel, mq_combine_kernel) is built; their registers
   and spills from ptxas.
1. kernels against their plain PyTorch versions on the card, at the main
   path's shapes (Hymba's G 5 / dh 64 / window 1024 attention included;
   phase 3e's: kernels 1 and 4 at LLaMA-2-13B's G 1 / 40 KV heads, the
   verify pass and the prefill round; kernels 1, 2 and 4 at StableLM-2-
   12B's head_dim 160, on the bodies that are not the Hopper ones; phase
   3g's: kernels 1, 2 and 4's verify at DeepSeekMoE-16B's G 1 / 16 heads;
   phase 3h's: kernel 2 bidirectional and kernel 1 over 512 encoder
   frames at SeamlessM4T-medium's G 1 / 16 heads / dh 64, with the keys
   at the first and last frames aligned with the query so that the
   kernel's window arithmetic at the reference's pos 2^30, which drops
   frame 0, and a dropped last frame are rejected faults)
   and at ring-buffer / window / unaligned / offset cases,
   within a tolerance relative to the reference's size that is shown to
   reject planted off-by-one faults;
   at the main path's shapes the kernel's median device time (CUDA
   events, L2 flushed and host enqueue hidden before each call), its
   bound, the plain version's time and one PyTorch library call's time as
   a yardstick (flash at LLaMA's, Hymba's and StableLM's shape; kernels 4
   and 5 at their verify and prefill-round shapes, kernel 4 also at phase
   3b's sporadic verify shape, B 1 at pos 516, and at LLaMA-2's and
   StableLM's verify shapes; kernel 1 at its main, B 1, Hymba, LLaMA-2 and
   StableLM shapes, SDPA on the visible prefix), and for kernels 1, 3, 4 and
   5 the time's split over the CUDA kernels one call launches
   (torch.profiler). Each multi-query call must take the body its shapes
   imply (the verify body at q_len·G <= 128 rows: two calls bit-equal;
   the Hopper mainloop above). The paged kernels (3: decode, 5: multi-query) run at phase
   2b's shapes (page 64, 16 pages, ctx 1019; q_len 128 and 5) with
   shuffled non-contiguous block tables, ragged ctx, windows and dh 80 /
   page 16, reject planted faults (page index +-1, ctx - 1, row // G off
   by one, window - 1), and equal kernels 1 and 4 bit for bit on the
   gathered cache. The recurrent scans (6: WKV, 7: selective scan) run at
   phase 3c's prefill shapes (B 4 and B 1, S 512: the chunked bodies, also
   held to their models *_chunked_plain), decode shapes (S 1) and at S 7 /
   50 with dh 32 / 128 (the sequential bodies), from a nonzero state, and
   at the B 4 prefill shape with extreme decays (held to fp64, no NaN);
   output and final state (updated in place) within SCAN_REL; each call on
   the body its shape implies (the @chunked counters); planted faults
   rejected (u dropped, decay on the v index, the state updated before the
   output; B and C swapped, dt left out of the update, decay exp(A) for
   exp(A dt); for both, a chunk's state carried without its decay); two
   calls over the halves of a sequence bit-equal to one.
2. the single-device path: LLaMA-3.3-70B at full width, depth cut to 8
   of 80 layers, random weights from a seed, served through LimeServer ->
   ContinuousBatchingScheduler -> EngineBackend under bursty and sporadic
   traffic; both kernels' launch counters must advance by the expected
   counts; a re-serve on the reference math (impl="ref") gives the
   reference tokens, which are fed through both impls at the served batch
   shape, and at every position the kernel path's greedy pick must be the
   reference's (or a near tie) with its logits within the limit; a
   profiler breakdown of one bursty serve gives device time by kernel
   class and the device's idle share.
2b. paged KV and the radix prefix cache on phase 2's weights, through
   LimeServer(prefix_cache=True, prefill_chunk_tokens=128, page_size=64):
   two epochs of 4 shared-prefix requests (one template, 384 of 512 prompt
   tokens) and one epoch of unequal lengths. Every step launches exactly
   what it implies (8 paged multi-query kernels per prefill round of the
   uncached suffix, 8 paged decode kernels per decode step, 8 flash for the
   unequal epoch's dense prefill, nothing of kernels 1 and 4), the warm
   epoch saves 4 x 384 prompt tokens, the block table is uploaded only
   when a table changed, warm tokens equal a cold serve's (or differ at a
   near tie), and decode on a paged cache seeded from the dense prefill is
   bit-equal to the contiguous decode_step (kernel 1) at every step.
   Printed: pool pages and bytes, peak HBM, cold vs warm prefill time, the
   paged kernels' µs per call in a profiled serve.
2c. speculative decoding on the single-device path, phase 2's weights and
   bursty batch, k = 4, five ways: dense with n-gram drafts; dense with a
   host ResidentDraft over all 8 layers (the draft is the target: the
   accept path); paged (page 64) with n-gram drafts (kernel 5's verify
   body); paged with the radix prefix cache and the gemma3-1b model draft;
   dense at temperature 0.8 / top-p 0.95 (rejection sampling). Every step
   launches exactly what it implies (the verify body of kernel 4 or 5 per
   round, the drafts' own flash and decode launches); every greedy served
   token is phase 2's pick on its prefix or a near tie; the whole-stack
   draft accepts drafts and commits more than one token in a round; a
   planted fault that
   commits one token past a correction is rejected; the sampled serve's
   counts are exact. Printed: acceptance, committed tokens per round, TTFT,
   ms/token, and kernel 5's verify µs per call in a profiled serve.
2d. captured steps: phase 2's serves (bursty and sporadic), 2b's
   paged and prefix-cache paths and 2c's n-gram, model and resident
   drafts on phase 2's weights and prompts, each on an eager backend
   (EngineBackend(capture=False)) and a captured one (the default: every
   prefill, every decode and verify step, and each draft's step and
   prefill, a replayed CUDA graph, one per shape, the counterpart of the
   JAX package's jax.jit), after a short warm-up serve on each (which
   captures): every step's logits (the target's and the drafts')
   bit-equal, tokens identical, the launch counters equal with replays
   counted, the prefill graphs replayed. Printed per serve: TTFT and
   ms/token p50, a profiled serve's device idle share, eager against
   captured; graphs (steps, prefills, drafts), capture time, graph-pool
   bytes. Then PREFILL_PAIRS prefills of the bursty batch and PAIR_STEPS
   decode steps captured against eager (capture_pair, step_pair: logits
   and every cache tensor bit-equal, launch counts equal; both paces, the
   first captured call's time, the pool MiB a capture added). Phases 3c
   (RWKV6, Hymba), 3g (DeepSeekMoE-16B) and 3h (SeamlessM4T-medium, its
   encoder output a static input) check their prefill and decode step
   the same way; 3f's, 3g's and 3h's engines their prompt pass (3f, 3h)
   and streamed decode pass (engine_pass_pair), 3b the 80-layer engine's
   decode pass (two calls) and resident draft step; every serve of every
   phase runs captured, an engine's streamed passes included (3b prints
   the graphs each serve captured: a retier drops the pass graphs).
2e. the flight recorder (obs/trace), the SLO engine and the dashboard on
   the serving path: phase 2's bursty batch on 2d's warm captured backend
   four times in turns (untraced, traced, traced, untraced), the traced
   serves under a Tracer with an SLOEngine attached to the scheduler and a
   Dashboard ticking between its steps: tokens and launch counts equal
   across the four, the Chrome export valid, the JSONL export read back
   as the ring holds it, each request's lifecycle in order with its
   req.span equal to its latency, one engine.decode span per round and
   one engine.prefill, the spans' sum within the serve's wall time.
   Printed: ms/token traced and untraced, the spans' share of the wall
   time, the dashboard's last frame.
2f. the fleet router (repro_torch.fleet) on phase 2's weights, built by
   the launcher's make_fleet: 2 single-device EngineBackend(engine=None)
   replicas over the same weight tensors, each with the radix prefix cache
   (page 64, prefill rounds of 128, 4 slots), under the prefix router; 24
   shared-prefix requests (2 templates of 384 tokens; per template two
   epochs of 512-token prompts, then one of unequal lengths; 8 new tokens)
   arriving at one instant: every request served once, each replica's
   own steps launch kernels 2 (the unequal epoch's flash prefill), 3
   (decode) and 5 (prefill rounds, the warm epoch's from the template's
   cached pages) on the Hopper bodies and nothing of kernels 1 and 4, the
   replicas' launches sum to the fleet's, the router matched prefixes,
   each replica's radix tree served prompt tokens, the second replica adds
   KV and graphs to HBM but no weights, and every request's tokens are
   its prompt's served alone on phase 2b's path (left-padded as its epoch
   padded it) or differ at a near tie. Printed: placement, router stats,
   per-replica launches, the FleetReport's TTFT p50 / p99 and decode
   ms/token (aggregate and per replica), prefix hit tokens per replica,
   HBM with one replica against two.
3a. the interleaved engine against the model on phase 2's weights, in a
   plan forced to stream (2 chunks of 2 resident + 2 streamed layers):
   decode and verify logits bit-equal to the model's kernel path (every
   verify launch through the verify body), the engine's chunked prefill
   (multi-query rounds) within the logit limit of the model's flash
   prefill.
3c. the recurrent families on the single-device path, after phase 2's
   weights are freed: RWKV6-3B, then Hymba-1.5B, each at full width, depth
   cut to RECURRENT_LAYERS (4) of their 32 layers so the script keeps its
   time limit (3f runs all 32 through the engine), random weights from seed 0, served bursty and sporadic
   through LimeServer; every scheduler step launches exactly what it
   implies (RWKV6: a WKV kernel per layer per prefill and decode step; Hymba:
   a flash and a scan kernel per layer per prefill, a decode-attention and
   a scan kernel per layer per decode step; every prefill's scans on the chunked
   body, no decode step's, by the counters and in the profile); the
   reference serve's tokens fed through
   both impls (argmax equal or a near tie, logits within a fixed 8% of
   |logit| max; the reference's own noise floor at this depth read and
   held under 7%; planted prefill faults that lose layer 0's scan state or
   every layer's must read above the 8%); the one-pass prefill's cache,
   last prompt logits and
   next step against a token-by-token decode of the same 512-token
   prompts. Printed: TTFT, ms/token, peak HBM, state bytes per sequence,
   and a profiled serve (device time by class, each kernel's µs per call,
   idle share).
3f. the recurrent families through the interleaved engine, after 3c:
   RWKV6-3B, then Hymba-1.5B, at full width and all 32 layers, random
   weights from seed 0, plan_for's plan at a --hbm-bytes budget that
   streams half the layers (2 x (8 resident + 8 streamed); the resident
   layers' packed bytes within the budget's share). A bursty batch (4 x
   prompt 512, ENGINE_NEW = 8 tokens) through LimeServer with exact launch
   counts every step (the prompt pass over the tiers: a chunked scan and,
   for Hymba, a flash launch per layer; a decode step: a sequential scan
   and, for Hymba, a decode-attention launch per layer); the engine's
   logits on the served tokens bit-equal to the model's kernel path
   (M.prefill + M.decode_step, the weights whole on the card) and, at 32
   layers, within 3c's RECURRENT_LOGIT_REL_TOL of impl="ref" with the
   reference's own noise floor read and held under NOISE_FLOOR_MAX;
   planted faults (every streamed layer run from the other load buffer;
   the first streamed layer's scan state dropped after the prompt pass)
   rejected by that bit-equality; Hymba's batch once more through a paged
   engine (page 64): its tokens equal, its pages in use as reckoned after
   every step. Printed: the plan, packed against counted layer bytes, H2D
   GB/s, the streamed bytes' copy time against the measured decode pass
   and the cost model's T_total, a profiled pass (compute idle share),
   TTFT, ms/token, state bytes per sequence, each step's time.
3b. the main path: all 80 layers of LLaMA-3.3-70B at full width (or the
   deepest cut, >= 40 layers, whose streamed tier the host's memory holds,
   printed as a cut), random weights from seed 0, through the
   InterleavedEngine: resident layers in HBM, the rest streamed from
   pinned host memory on a side stream. Bursty (4 requests together) and
   sporadic (2, 4 s apart) traffic through LimeServer with resident
   self-speculation (k = 4 drafts on the resident tier, verified by the
   multi-query kernel) and a live retier(+1) / retier(-1) in the bursty
   serve; the mq and decode launch counters advance by exactly what each
   round implies; every served token equals the same engine's greedy
   decode through (k+1)-wide verify passes, and matches its plain greedy
   decode (decode kernel) up to a first divergence that must be a near
   tie (judged on the logits of one verify pass over the continuation).
   Then the paper's online memory adaptation on the same engine (retier
   headroom 1): one more bursty serve under
   page-granular admission (page 64) with an OnlinePlanner over the
   card's CostEnv (the H100 profile at the weight budget's resident share
   and the measured H2D rate) and plan_for's plan; its TS ladder must
   retier the live engine while requests are live (every token still
   equal to the verify-pass greedy, kernels 1 and 4 in every round), and
   the tier boundary is restored after it. That serve runs traced: its
   Chrome export valid, an engine.retier instant inside a live request's
   window, the pool's kv.grow instants.
   Printed: plan, memory, H2D rate, the CostEnv, the plan's predicted
   T_total beside the measured pass times, Alg. 1's plan and candidates
   for the same env, TTFT, ms/token, acceptance, committed tokens per
   round, pass and draft times against the copy time of the streamed
   bytes, the adaptive serve's ladder, occupancy notes, retier round and
   pool growth, and profiler breakdowns of a decode, a verify and a
   chunked-prefill pass (kernel 4's µs per call in each regime, the
   GEMMs' rate in the prefill round).
3d. Alg. 1's plan on the engine, after 3b's engine is closed, depth cut
   to ALG1_LAYERS (40) of the 80 layers with the weight budget scaled with
   it (all 80 until PR 28; the cut pays for phase 2f): the launcher's
   hetero path (allocate_with_retry over the same CostEnv,
   n_emp = the prompt length; a relaxed memory scale fails the run), no
   retier headroom, exactly the plan's resident layers laid out; phase
   3b's bursty batch served once (spec k = 4) with exact launch counts,
   every token equal to this engine's verify-pass greedy. Printed: the
   plan, its layout, pinned bytes and predicted
   T_total beside the measured decode and verify pass times.
3e. the paper's other Tab. III models and the rest of the dense configs,
   after 3d's store is closed, random weights from seed 0: LLaMA-2-13B
   (MHA: G 1, 40 KV heads) at full width, depth cut to TAB3_SINGLE (20) of
   its 40 layers, on the single-device path, as phase 2 (exact launch counts, every call on the
   Hopper bodies, a profiled serve, the reference re-serve within
   TAB3_LOGIT_REL_TOL; the reference's own noise floor read and held under
   TAB3_NOISE_FLOOR_MAX, planted prefill faults rejected); LLaMA-2-13B and
   Qwen3-32B (all 64 layers) through Alg. 1's engine as phase 3d, at
   TAB3_BUDGETS (about a third and a half of their layers streamed; every
   verify on the verify body at G 1 and G 8, every prefill round on the
   Hopper mainloop), LLaMA-2-13B's engine serving the batch once more with
   n-gram drafts proposed on the host, held to the same verify-pass
   greedy; StableLM-2-12B
   (parallel blocks, head_dim 160) at 8 of 40 layers on the single-device
   path, as phase 2, every flash and decode launch on the bodies head_dim
   160 takes (flash_mma_kernel, decode_tile_kernel) with their µs per call
   in a profiled serve; Pixtral-12B's backbone at 8 of 40 layers: a
   prefill of 256 patch embeddings and 256 text tokens, then 16 decode
   steps, the kernel path against impl="ref" (argmax equal or a near
   tie). LLaMA-2-13B's hidden state after each of its 40 layers, the
   kernel path against impl="ref" on one prefill and one decode step,
   accumulated and each layer's own (layer_errors).
3g. the MoE family, after 3b's engine is closed (before 3d): (a)
   DeepSeekMoE-16B as published (dense layer 0, then MoE layers of 64
   routed top-6 + 2 shared experts) at full width, depth cut to MOE_SINGLE
   (14) of its 28 layers, on the single-device path, as phase 2 (exact launch counts of kernels 2
   and 1, a profiled serve, the reference re-serve within
   MOE_LOGIT_REL_TOL, its noise floor under MOE_NOISE_FLOOR_MAX), the
   routes that differ from "ref" per MoE layer, every MoE call of the
   served prefill and first decode step held to a plain MoE layer
   (moe_plain) on the same input within MOE_LAYER_REL, planted MoE faults
   (capacity from B in the prefill, top-k weights not renormalised, the
   router product in bf16, the shared experts dropped) that must break
   it, the layer-by-layer errors, and an n-gram speculative serve (k 4,
   kernel 4's verify body at G 1) whose every pick is the reference's on
   the same verify calls or a near tie; (c) Kimi-K2 at full width, depth
   cut to 2 of 61 layers (its dense layer 0 and one MoE layer of 384
   routed top-8 experts), a bursty serve against "ref" and moe_plain; (b)
   DeepSeekMoE-16B folded (first_dense_layers 0) at all 28 layers through
   the engine at MOE_ENGINE_HBM (12 resident, 16 streamed), the bursty
   batch with resident self-speculation and a live retier, every engine
   call replayed through the model's kernel path bit for bit and every
   served token its verify pass's greedy; a decode pass against the copy
   of its streamed bytes, the cost model's T_total and Alg. 1's plan.
3h. the encoder-decoder family, after 3g (before 3d, absorbing part of
   3d's wait for the host to take back 3b's and 3g's pinned stores):
   SeamlessM4T-medium at full width and all 12 encoder + 12 decoder
   layers, random weights from seed 0, frame embeddings (4, 512, 1024)
   and 4 prompts of 512 tokens from numpy seeds, max_len 1024. (a) the
   model path (encode -> seed_cross_kv -> prefill(enc_out=) ->
   decode_step(enc_len=512)) under impl="kernel", 32 greedy positions,
   exact launch counts (12 bidirectional flash launches in the encoder,
   24 in the prompt pass: causal self and non-causal cross-attention; 24
   of kernel 1 a decode step, self and cross; all on the Hopper bodies,
   nothing else); impl="ref"'s greedy tokens fed through the kernel path,
   every pick the reference's or a near tie, logits within
   ENCDEC_LOGIT_REL_TOL of |logit| max, the reference's own noise floor
   under ENCDEC_NOISE_FLOOR_MAX, planted faults (the encoder causal, each
   layer's cross K/V from the next layer's weights, rope on the
   cross-attention's q) above the limit; encode time, TTFT, and profiles
   of the prompt and of 8 decode steps; (b) the interleaved engine at a
   --hbm-bytes budget that streams 6 of the 12 decoder layers
   (half_streamed_plan, retier headroom 1): its encoder, prompt pass over
   the tiers and 31 decode steps on the reference's tokens, across a
   retier +1 and -1, bit-equal to the model's kernel path; a streamed
   layer reading the next layer's cross K/V breaks that; a paged engine
   (page 64) gives the kernel path's greedy tokens, pages as reckoned; a
   decode pass against the copy of its streamed bytes and the cost
   model's T_total; (c) the serving backend refuses the family before a
   weight is drawn (the JAX package's serving route fails on it).
Every flash launch of phases 2, 2b, 2c, 3c and 3f, every prefill round of
kernel 5 (2b, 2c) and of kernel 4 (3a, 3b) must run the Hopper mainloop,
every verify pass of kernels 4 (2c, 3a, 3b) and 5 (2c) the verify body,
and every launch of kernels 1 and 3 in phases 2, 2b, 3b, 3c and 3f the
Hopper decode body (the wrappers' hopper and verify counters); the profiled
serves show no second pass (decode_combine_kernel, mq_combine_kernel), and
phase 3b's pass profiles give each attention kernel's µs per call.
4. a JSON line of per-kernel numbers, then the ``ok`` line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the 80-layer phase fills HBM to ~92% with 1.7 GB layers while layer
# sources allocate and free large temporaries: growable segments keep the
# caching allocator from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
FP32_SIMT_FLOPS = 67e12            # fp32 outside the tensor cores
# Kernel tolerances are relative to the reference's own size: each output
# element must lie within REL x the largest |ref| of its vector (one head
# of one row, dh values). At the main decode shape |out| is ~0.04 and a
# vector's largest ~0.15, so a fixed atol would hide real faults.
# bf16: 2^-6 is 2-4 ulps of the vector's largest element. The kernels round
# the probabilities where their plain versions do not (or the reverse);
# that costs at most 2^-7 at the main shapes. A planted off-by-one (a
# dropped current slot, diagonal or last kv tile) costs >= 0.3 there, and
# each main-shape check proves its tolerance sees such a fault.
BF16_REL = 2.0 ** -6
F32_REL = 2e-5    # fp32 paths: summation order and exp() implementation only
# the recurrent scans run in fp32 and differ from their plain versions by
# summation order over dh (or N) terms that partly cancel, and fused
# multiply-adds: up to 7e-6 of a vector's largest |ref| between the plain
# versions and the JAX scans on the CPU; the tests' SCAN_REL. Every planted
# fault costs more than 1e-2.
SCAN_REL = 1e-4
# logits are bf16 (ulp 0.03 at |logit| ~ 4.5): the kernels keep fp32
# probabilities where the reference rounds them to bf16, and 8 layers of
# 8192-wide bf16 GEMMs carry that on; 5% of the largest |logit| is ~7 ulps
LOGIT_REL_TOL = 0.05
N_LAYERS = 8      # depth cut: 8 of LLaMA-3.3-70B's 80 layers fit one H100
PROMPT_LEN, MAX_NEW, MAX_LEN = 512, 32, 1024
SPIN_CYCLES = 5_000_000   # ~3 ms at the H100's clock: longer than any timed
                          # call takes to enqueue
# phase 3b (the 80-layer engine)
MIN_LAYERS = 40           # the deepest cut host memory may force
HOST_RESERVE = 8e9        # host memory left beside the pinned store
PREFILL_CHUNK = 512
SPEC_K = 4
MAX_NEW_80 = 12           # tokens per request in phase 3b: >= 5 rounds at
                          # k = 4 only if drafts are mostly rejected
RETIER_AT = ((2, +1), (4, -1))   # (after decode round, delta), bursty serve
# phase 3d's depth cut: 40 of LLaMA-3.3-70B's 80 layers, the weight budget
# scaled with it (Alg. 1 keeps 18 resident and streams 22 where it kept 38
# and streamed 42 at 80). At 80 layers 3d took 125.3-158.8 s of PR 27's
# calls, 41.9 s of it building the 71.9 GB pinned store; the cut pays for
# phase 2f
ALG1_LAYERS = 40
PAGE = 64                 # KV page of the adaptive serve's admission
BF16_PEAK = 989.4e12      # H100 SXM dense bf16 tensor FLOP/s (data sheet)


def log(*a):
    print(*a, flush=True)


# ----------------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------------
def time_ms(fn, reps=30, warmup=3):
    """Median device ms of one fn() call over reps calls, each timed with
    CUDA events. Before each call the 50 MB L2 is flushed (the real caller
    finds K/V cold: an MLP's weights pass between two attention calls),
    then a spin kernel keeps the device busy while the host enqueues the
    call, so the wrapper's host time does not show up as device time."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del flush
    return statistics.median(times)


def library_time_ms(fn):
    """Time of the PyTorch library yardstick, or None where this torch
    has no such call (enable_gqa came with torch 2.5)."""
    try:
        fn()
    except TypeError as e:
        log(f"  library call unavailable: {e}")
        return None
    return time_ms(fn)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------------------
# phase 1: kernels against plain versions
# ----------------------------------------------------------------------------
def randn(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def ring_ids(S_c, pos):
    import torch
    base = pos - S_c + 1
    ar = torch.arange(S_c, device="cuda")
    return ((ar - (base % S_c)) % S_c + base).to(torch.int32)


def linear_ids(S_c, pos):
    import torch
    ar = torch.arange(S_c, device="cuda", dtype=torch.int32)
    return torch.where(ar <= pos, ar, torch.full_like(ar, -1))


def rel_err(out, ref):
    """max over output vectors (last dim) of max |out - ref| / max |ref|:
    the error in units of the reference's own size. A vector whose
    reference is 0 (no visible key) must be exactly 0."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1)).nan_to_num(nan=0.0).max().item()


def check(name, out, ref, rel, faults=()):
    """Kernel output against its plain version within rel (see BF16_REL);
    each (label, output) in faults is the plain version run with a planted
    fault, which the same limit must reject. Returns max |out - ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    r = rel_err(out, ref)
    ok = r <= rel and bool(out.float().isfinite().all())
    log(f"  {name}: max_abs_err {err:.3e}, rel_err {r:.3e} (tol {rel:.3g} of "
        f"each vector's max |ref|, mean |ref| {ref.float().abs().mean().item():.3g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    for label, bad in faults:
        rb = rel_err(bad, ref)
        log(f"    planted fault '{label}': rel_err {rb:.3e} "
            f"{'rejected' if rb > rel else 'NOT REJECTED'}")
        if rb <= rel:
            raise AssertionError(f"{name}: tolerance {rel:g} cannot see '{label}'")
    return err


def head_shifted(plain, shift, q, *args, **kw):
    """plain(q, *args, **kw) with query head h reading KV head
    (h + shift) // G in place of h // G (the row // G mapping off by
    `shift`): the heads are rolled through the function and back."""
    return plain(q.roll(shift, 2), *args, **kw).roll(-shift, 2)


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    log("phase 1: decode_attention kernel vs plain version")
    # B, S_c, H, KV, dh, pos, window, ring, dtype, planted faults (label,
    # arguments of the plain version that replace the right ones;
    # "head_shift" shifts the row // G mapping, see head_shifted)
    dec_cases = [
        ("main B4 S1024 H64 KV8 dh128", 4, 1024, 64, 8, 128, 1023, None, False, bf16,
         [("current slot dropped: pos - 1", dict(pos=1022))]),
        ("ring+window pos1500 w700", 4, 1024, 64, 8, 128, 1500, 700, True, bf16,
         [("window - 1", dict(window=699))]),
        ("unaligned S100 dh80 w32", 2, 100, 4, 4, 80, 60, 32, False, bf16, []),
        ("gemma-like G4 dh256 ring", 2, 256, 4, 1, 256, 400, 128, True, bf16, []),
        ("fp32 S96 dh64 mostly-empty", 3, 96, 6, 2, 64, 10, None, False, f32, []),
        # phase 3c's Hymba decode: G 5 in a partly filled tile, the last step
        ("hymba B4 S1024 H25 KV5 dh64 pos543 w1024", 4, 1024, 25, 5, 64, 543, 1024,
         False, bf16, [("current slot dropped: pos - 1", dict(pos=542)),
                       ("row // G off by one", dict(head_shift=1))]),
    ]
    for name, B, S_c, H, KV, dh, pos, window, ring, dt, planted in dec_cases:
        q = randn((B, 1, H, dh), dt, gen)
        k = randn((B, S_c, KV, dh), dt, gen)
        v = randn((B, S_c, KV, dh), dt, gen)
        ids = ring_ids(S_c, pos) if ring else linear_ids(S_c, pos)
        out = da.decode_attention(q, k, v, ids, pos, window=window)
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
        faults = []
        for label, kw in planted:
            kw = {"pos": pos, "window": window, **kw}
            faults.append((label, head_shifted(
                da.decode_attention_plain, kw.pop("head_shift", 0), q, k, v, ids, **kw)))
        check(name, out, ref, BF16_REL if dt == bf16 else F32_REL, faults)
    decode_timed(gen, rows)

    log("phase 1: flash_attention kernel vs plain version")
    # B, Sq, Skv, H, KV, dh, causal, window, q_offset, dtype, planted faults
    # (label, arguments of the plain version that replace the right ones;
    # "kv_keep" keeps only the first kv rows, "head_shift" as above)
    fl_cases = [
        ("main B4 S512 H64 KV8 dh128 causal", 4, 512, 512, 64, 8, 128, True, None, 0, bf16,
         [("diagonal dropped: q_offset - 1", dict(q_offset=-1)),
          ("last 64-row kv tile dropped", dict(kv_keep=448))]),
        ("window 100 S512", 1, 512, 512, 8, 2, 128, True, 100, 0, bf16,
         [("window - 1", dict(window=99))]),
        ("Sq96 Skv192 q_offset96", 1, 96, 192, 6, 2, 64, True, None, 96, bf16,
         [("q_offset - 1", dict(q_offset=95))]),
        ("bidirectional S200 dh256", 1, 200, 200, 4, 1, 256, False, None, 0, bf16, []),
        ("fp32 unaligned S100 dh80", 1, 100, 100, 4, 2, 80, True, None, 0, f32, []),
        # phase 3c's Hymba prefill: G 5 in a partly filled tile
        ("hymba B4 S512 H25 KV5 dh64 causal w1024", 4, 512, 512, 25, 5, 64, True, 1024,
         0, bf16, [("diagonal dropped: q_offset - 1", dict(q_offset=-1)),
                   ("row // G off by one", dict(head_shift=1))]),
        # phase 3e's StableLM-2-12B prefill: head_dim 160, past the Hopper
        # mainloop's 128, on the mma.sync body
        ("stablelm B4 S512 H32 KV8 dh160 causal", 4, 512, 512, 32, 8, 160, True, None, 0,
         bf16, [("diagonal dropped: q_offset - 1", dict(q_offset=-1)),
                ("last 64-row kv tile dropped", dict(kv_keep=448)),
                ("row // G off by one", dict(head_shift=1))]),
        # phase 3g's DeepSeekMoE-16B prefill: G 1, 16 heads
        ("moe B4 S512 H16 KV16 dh128 causal", 4, 512, 512, 16, 16, 128, True, None, 0,
         bf16, [("diagonal dropped: q_offset - 1", dict(q_offset=-1)),
                ("last 64-row kv tile dropped", dict(kv_keep=448)),
                ("row // G off by one", dict(head_shift=1))]),
        # phase 3h's SeamlessM4T-medium encoder (and cross-attention prefill,
        # 512 prompt rows over 512 frames): bidirectional, G 1, dh 64
        ("encdec B4 S512 H16 KV16 dh64 bidirectional", 4, 512, 512, 16, 16, 64, False,
         None, 0, bf16, [("causal mask applied", dict(causal=True)),
                         ("last 64-row kv tile dropped", dict(kv_keep=448))]),
    ]
    for name, B, Sq, Skv, H, KV, dh, causal, window, q_off, dt, planted in fl_cases:
        q = randn((B, Sq, H, dh), dt, gen)
        k = randn((B, Skv, KV, dh), dt, gen)
        v = randn((B, Skv, KV, dh), dt, gen)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        h0 = fa.hopper_launches
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if name.startswith("stablelm") and fa.hopper_launches != h0:
            raise AssertionError(f"{name}: head_dim 160 took the Hopper mainloop")
        ref = fa.flash_attention_plain(q, k, v, **kw)
        faults = []
        for label, bad in planted:
            bad = {**kw, **bad}
            n_kv = bad.pop("kv_keep", Skv)
            faults.append((label, head_shifted(
                fa.flash_attention_plain, bad.pop("head_shift", 0), q,
                k[:, :n_kv], v[:, :n_kv], **bad)))
        err = check(name, out, ref, BF16_REL if dt == bf16 else F32_REL, faults)
        if name.startswith(("main", "hymba", "stablelm", "moe", "encdec")):
            # window 1024 >= S: causal alone decides, as for SDPA's is_causal
            ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
            plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), reps=10)
            lib = library_time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True))
            # visible (i, j) pairs
            pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
            flops = 2 * 2 * B * H * pairs * dh
            byts = nbytes(q, k, v) + nbytes(q)
            rows["flash_attention" if name.startswith("main") else
                 "flash_attention@hymba" if name.startswith("hymba") else
                 "flash_attention@moe" if name.startswith("moe") else
                 "flash_attention@encdec" if name.startswith("encdec")
                 else "flash_attention@dh160"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bytes=byts, flops=flops, bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
                ops_bound_ms=flops / BF16_TENSOR_FLOPS * 1e3)
    mq_phase(gen, rows)
    paged_phase(gen, rows)
    scan_phase(gen, rows)
    for name, r in rows.items():
        bound = max(r["bytes_bound_ms"], r["ops_bound_ms"])
        r["bound_ms"] = bound
        r["bound_by"] = "bytes" if r["bytes_bound_ms"] >= r["ops_bound_ms"] else "operations"
        log(f"  {name} @ main shape: kernel {r['ms']:.4f} ms, bound {bound:.4f} ms "
            f"({r['bound_by']}; {r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} GFLOP), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
            f"roofline share {bound / r['ms']:.3f}")
    return rows


# kernel 1's timed shapes: (row key, B, S_c, H, KV, dh, pos, window,
# planted faults as in kernel_phase's decode cases) of a bursty decode step
# at the end of the cache (the main shape), a sporadic one (B 1), phase
# 3c's Hymba decode, and phase 3e's LLaMA-2-13B (MHA: G 1, 40 KV heads) and
# StableLM-2-12B (head_dim 160: the fp32-FMA body) decodes; linear caches,
# window >= pos + 1
DECODE_FAULTS = [("current slot dropped: pos - 1", dict(pos=1022)),
                 ("row // G off by one", dict(head_shift=1))]
DECODE_TIMED = (
    ("decode_attention", 4, 1024, 64, 8, 128, 1023, None, []),
    ("decode_attention@B1", 1, 1024, 64, 8, 128, 543, None, []),
    ("decode_attention@hymba", 4, 1024, 25, 5, 64, 543, 1024, []),
    ("decode_attention@llama2", 4, 1024, 40, 40, 128, 1023, None, DECODE_FAULTS),
    ("decode_attention@dh160", 4, 1024, 32, 8, 160, 1023, None, DECODE_FAULTS),
    # phase 3g's DeepSeekMoE-16B decode: G 1, 16 KV heads
    ("decode_attention@moe", 4, 1024, 16, 16, 128, 1023, None, DECODE_FAULTS),
    # phase 3h's SeamlessM4T-medium cross-attention decode: 512 frames, all
    # visible at pos 511 (the kernel route's position), the keys at frames 0
    # and 511 aligned with the query (ENCDEC_ALIGNED) so that dropping
    # either shows
    ("decode_attention@encdec", 4, 512, 16, 16, 64, 511, None,
     [("frame 0 dropped: the reference's pos 2^30 in the kernel's window "
       "arithmetic", dict(pos=2 ** 30, window=2 ** 30)),
      ("last frame dropped: pos - 1", dict(pos=510))]),
)
# the keys planted at the first and last frames of the @encdec decode row:
# 0.75 x the query head, a score of ~6 against N(0, 1) for the other 510
# frames (q . k / sqrt(64) with |q|^2 ~ 64): about a quarter of the
# softmax weight each
ENCDEC_ALIGNED = 0.75


def pass_split(fn, reps=10):
    """{kernel: (device µs per call, launches per call)} of the csrc/
    kernels fn() launches: torch.profiler over reps calls, the L2 flushed
    before each, as time_ms times them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        m = csrc_kernel(e.key)
        if e.device_type != torch.autograd.DeviceType.CUDA or m is None:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        split[m[1]] = (round(us / reps, 3), e.count / reps)
    return split


def decode_timed(gen, rows):
    """Kernel 1 at DECODE_TIMED's shapes: checked against its plain version,
    then its device time, the plain version's, SDPA's on the visible prefix
    of the cache, the byte bound, and the time's split over the CUDA
    kernels one call launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    bf16 = torch.bfloat16
    for key, B, S_c, H, KV, dh, pos, window, planted in DECODE_TIMED:
        q = randn((B, 1, H, dh), bf16, gen)
        k = randn((B, S_c, KV, dh), bf16, gen)
        v = randn((B, S_c, KV, dh), bf16, gen)
        if key.endswith("@encdec"):                       # G 1: head h is KV head h
            k[:, 0] = k[:, -1] = (q[:, 0].float() * ENCDEC_ALIGNED).to(bf16)
        ids = linear_ids(S_c, pos)
        pos_t = kernel_pos(pos)

        def fn():
            return da.decode_attention(q, k, v, ids, pos_t, window=window)
        h0 = da.hopper_launches
        out = fn()
        torch.cuda.synchronize()
        hop = da.hopper_launches - h0
        if hop != (dh <= 128):
            raise AssertionError(f"{key}: {hop} Hopper decode launches at head_dim {dh}")
        ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
        faults = []
        for label, bad in planted:
            bad = {"pos": pos, "window": window, **bad}
            faults.append((label, head_shifted(
                da.decode_attention_plain, bad.pop("head_shift", 0), q, k, v, ids, **bad)))
        err = check(f"timed {key} B{B} S{S_c} H{H} KV{KV} dh{dh} pos{pos} w{window} "
                    f"({'Hopper' if hop else 'fp32-FMA'} body)", out, ref, BF16_REL, faults)
        n_vis = pos + 1                                  # linear ids, window >= pos + 1
        kv, vv = k[:, :n_vis].contiguous(), v[:, :n_vis].contiguous()
        ms = time_ms(fn)
        plain = time_ms(lambda: da.decode_attention_plain(q, k, v, ids, pos, window=window))
        lib = library_time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kv.transpose(1, 2), vv.transpose(1, 2), enable_gqa=True))
        split = pass_split(fn)
        byts = 2 * B * n_vis * KV * dh * k.element_size() \
            + nbytes(q, ids) + nbytes(q)                # K, V rows; q, ids; out
        flops = 2 * 2 * B * H * n_vis * dh              # QK^T and PV
        rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         bytes=byts, flops=flops, split=split,
                         bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
                         ops_bound_ms=flops / FP32_SIMT_FLOPS * 1e3)
        log(f"    {key}: {ms:.4f} ms; sdpa on the visible prefix {lib} ms; split over "
            f"kernels (µs per call, launches per call) {split}")


def kernel_pos(pos):
    """The position argument of kernels 1 and 4 as the serving steps pass
    it, for the timed calls: a 0-d int32 tensor on the card (a host int
    would add a fill kernel to every call); a host int where the imported
    wrappers take only that (an older checkout timed by tools/time_*.py)."""
    import torch

    from repro_torch.kernels import _launch
    if not hasattr(_launch, "device_position"):
        return pos
    return torch.full((), pos, dtype=torch.int32, device="cuda")


def mq_ids(S_c, pos, Q, kind):
    """pos_ids of a cache holding the q_len new positions pos .. pos+Q-1:
    "linear" (slots up to pos+Q-1 filled), "ring" (a ring buffer after
    pos+Q-1), "stale" (the next 6 slots hold positions of a rejected
    round, pos_ids > every query's)."""
    import torch
    last = pos + Q - 1
    if kind == "ring":
        return ring_ids(S_c, last)
    ar = torch.arange(S_c, device="cuda", dtype=torch.int32)
    keep = last + (6 if kind == "stale" else 0)
    return torch.where(ar <= keep, ar, torch.full_like(ar, -1))


def mq_visible(ids, pos, Q, window):
    """(Q, S_c) bool: slot s visible to the query at position pos + qi."""
    import torch
    qpos = pos + torch.arange(Q, device=ids.device)[:, None]
    vis = (ids[None, :] >= 0) & (ids[None, :] <= qpos)
    if window is not None:
        vis &= (qpos - ids[None, :]) < window
    return vis


def mq_phase(gen, rows):
    """The multi-query kernel against its plain version at the main path's
    verify (k = 4) and prefill-round shapes and at ring / window / stale
    / unaligned cases, with planted faults; at q_len 1 against the decode
    kernel; device times at both main shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da

    bf16 = torch.bfloat16
    log("phase 1: mq_decode_attention kernel vs plain version")
    # name, B, q_len, S_c, H, KV, dh, pos, window, cache kind, planted
    # faults (label, arguments of the plain version that replace the right
    # ones): pos - 1 drops each query's own slot (<= became <), pos + 1
    # gives row r the position of row r + G (row // G off by one)
    cases = [
        ("verify B4 q5 S1024 H64 KV8 dh128", 4, 5, 1024, 64, 8, 128, 1019, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=1018)),
                    ("row // G off by one", dict(pos=1020))]),
        ("prefill B4 q512 S1024 H64 KV8 dh128", 4, 512, 1024, 64, 8, 128, 0, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=-1)),
                    ("row // G off by one", dict(pos=1))]),
        ("ring+window dh80 pos1500 w700", 2, 5, 1024, 16, 2, 80, 1500, 700, "ring",
         [("window - 1", dict(window=699))]),
        ("stale pos_ids > pos, pos 300", 2, 5, 1024, 64, 8, 128, 300, None, "stale",
         [("diagonal dropped: <= -> <", dict(pos=299))]),
        ("q9 G8 S100 dh64 w32 unaligned", 1, 9, 100, 16, 2, 64, 50, 32, "linear", []),
        # phase 3b's sporadic verify pass: 8 splits, the last four see nothing
        ("sporadic B1 q5 S1024 H64 KV8 dh128 pos516", 1, 5, 1024, 64, 8, 128, 516, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=515)),
                    ("row // G off by one", dict(pos=517))]),
        ("G1 q5 S300 dh64 stale", 2, 5, 300, 8, 8, 64, 290, None, "stale",
         [("diagonal dropped: <= -> <", dict(pos=289))]),
        # phase 3e: LLaMA-2-13B's verify pass and chunked-prefill round (MHA:
        # G 1, 40 KV heads) and StableLM-2-12B's verify (head_dim 160: the
        # mma.sync body)
        ("llama2 verify B4 q5 S1024 H40 KV40 dh128", 4, 5, 1024, 40, 40, 128, 1019, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=1018)),
                    ("row // G off by one", dict(pos=1020))]),
        ("llama2 prefill B4 q512 S1024 H40 KV40 dh128", 4, 512, 1024, 40, 40, 128, 0,
         None, "linear", [("diagonal dropped: <= -> <", dict(pos=-1)),
                          ("row // G off by one", dict(pos=1))]),
        ("stablelm verify B4 q5 S1024 H32 KV8 dh160", 4, 5, 1024, 32, 8, 160, 1019, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=1018)),
                    ("row // G off by one", dict(pos=1020))]),
        # phase 3g's DeepSeekMoE-16B verify pass (G 1, 16 heads)
        ("moe verify B4 q5 S1024 H16 KV16 dh128", 4, 5, 1024, 16, 16, 128, 1019, None,
         "linear", [("diagonal dropped: <= -> <", dict(pos=1018)),
                    ("row // G off by one", dict(pos=1020))]),
    ]
    for name, B, Q, S_c, H, KV, dh, pos, window, kind, planted in cases:
        q = randn((B, Q, H, dh), bf16, gen)
        k = randn((B, S_c, KV, dh), bf16, gen)
        v = randn((B, S_c, KV, dh), bf16, gen)
        ids = mq_ids(S_c, pos, Q, kind)
        n0 = (mq.verify_sm90_launches, mq.hopper_launches)
        out = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
        torch.cuda.synchronize()
        body = mq.mq_body(Q, H // KV, dh, 1)          # torch's allocations are aligned
        if (mq.verify_sm90_launches - n0[0], mq.hopper_launches - n0[1]) \
                != (body == "verify", body == "mainloop"):
            raise AssertionError(f"{name}: the call did not take the {body} body")
        ref = mq.mq_decode_attention_plain(q, k, v, ids, pos, window=window)
        faults = [(label, mq.mq_decode_attention_plain(
            q, k, v, ids, **{"pos": pos, "window": window, **kw}))
            for label, kw in planted]
        err = check(f"{name} ({body} body)", out, ref, BF16_REL, faults)
        if body == "verify":
            again = mq.mq_decode_attention(q, k, v, ids, pos, window=window)
            if not torch.equal(out, again):
                raise AssertionError(f"{name}: two calls differ")
        key = {"verify": "mq_decode_attention", "sporadic": "mq_decode_attention@B1",
               "prefill": "mq_decode_attention@prefill",
               "llama2 verify": "mq_decode_attention@llama2",
               "stablelm verify": "mq_decode_attention@dh160",
               "moe verify": "mq_decode_attention@moe"}.get(
            name.split(" B")[0])
        if key is None:
            continue
        vis = mq_visible(ids, pos, Q, window)
        mask = vis.clone()

        pos_t = kernel_pos(pos)

        def fn():
            return mq.mq_decode_attention(q, k, v, ids, pos_t)
        ms = time_ms(fn)
        plain = time_ms(lambda: mq.mq_decode_attention_plain(q, k, v, ids, pos),
                        reps=10)
        lib = library_time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True))
        split = pass_split(fn)
        n_read = int(vis.any(0).sum())                  # slots some row sees
        pairs = int(vis.sum())                          # visible (row, slot)
        byts = 2 * B * n_read * KV * dh * k.element_size() \
            + nbytes(q, ids) + nbytes(q)                # K, V rows; q, ids; out
        flops = 2 * 2 * B * H * pairs * dh              # QK^T and PV (tensor cores)
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                 bytes=byts, flops=flops, split=split,
                 bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
                 ops_bound_ms=flops / BF16_TENSOR_FLOPS * 1e3)
        log(f"    {ms:.4f} ms; sdpa {lib} ms; split over kernels (µs per call, launches "
            f"per call) {split}")
        rows[key] = r

    # q_len 1: the multi-query kernel is the one-token decode
    B, S_c, H, KV, dh, pos = 4, 1024, 64, 8, 128, 1023
    q = randn((B, 1, H, dh), bf16, gen)
    k = randn((B, S_c, KV, dh), bf16, gen)
    v = randn((B, S_c, KV, dh), bf16, gen)
    ids = linear_ids(S_c, pos)
    a = mq.mq_decode_attention(q, k, v, ids, pos)
    b = da.decode_attention(q, k, v, ids, pos)
    torch.cuda.synchronize()
    check("q_len 1 against the decode kernel", a, b, BF16_REL)


# ----------------------------------------------------------------------------
# phase 1: the paged kernels (3: paged decode, 5: paged multi-query)
# ----------------------------------------------------------------------------
PAGE, MAX_PAGES = 64, 16          # phase 2b's pool geometry: max_len 1024


def shuffled_tables(ctx, ps, max_pages, gen):
    """(block_tables (B, max_pages) int32 on the card, pool pages): each
    sequence's pages drawn from a shuffled pool (non-contiguous), -1 past
    the pages its ctx needs."""
    import torch
    need = [-(-c // ps) for c in ctx]
    P = sum(need) + 8
    perm = torch.randperm(P, generator=gen, device="cuda").cpu()
    bt = torch.full((len(ctx), max_pages), -1, dtype=torch.int32)
    i = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[i:i + n].to(torch.int32)
        i += n
    return bt.cuda(), P


def gathered(pool, bt, ctx):
    """Each sequence's pages laid out contiguously, and the pos_ids of one
    sequence at ctx (slot t holds position t below ctx)."""
    import torch
    from repro_torch.kernels.decode_attention import paged as pg
    S = bt.shape[1] * pool.shape[1]
    ar = torch.arange(S, device="cuda", dtype=torch.int32)
    return (pg.gather_pages(pool, bt).contiguous(),
            torch.where(ar < ctx, ar, torch.full_like(ar, -1)))


def paged_bitwise(name, q, k, v, bt, ctx, window, Q):
    """The paged kernel against the contiguous one (kernel 1 at q_len 1,
    kernel 4 otherwise) on the gathered cache, bit for bit: per sequence
    (B = 1 calls, so any ctx), and as one batch when ctx is uniform."""
    import torch
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg

    def both(qb, btb, ctxb):
        c = int(ctxb[0])
        kc, ids = gathered(k, btb, c)
        vc, _ = gathered(v, btb, c)
        if Q == 1:
            return (pg.paged_decode_attention(qb, k, v, btb, ctxb, window=window),
                    da.decode_attention(qb, kc, vc, ids, c - 1, window=window))
        return (mq.mq_paged_decode_attention(qb, k, v, btb, ctxb, window=window),
                mq.mq_decode_attention(qb, kc, vc, ids, c - Q, window=window))
    pairs = [both(q[b:b + 1], bt[b:b + 1], ctx[b:b + 1]) for b in range(q.shape[0])]
    if bool((ctx == ctx[0]).all()):
        pairs.append(both(q, bt, ctx))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in pairs)
    log(f"    bit-equal to kernel {1 if Q == 1 else 4} on the gathered cache "
        f"({len(pairs)} calls): {same}")
    if not same:
        raise AssertionError(f"{name}: the paged kernel differs from the "
                             "contiguous one on the gathered cache")


def paged_phase(gen, rows):
    """Kernels 3 and 5 against their plain versions at the main path's
    shapes (B 4, page 64, max_pages 16, H 64, KV 8, dh 128, ctx 1019; q_len
    128 and 5 for kernel 5) with shuffled non-contiguous tables, and at
    ragged-ctx, window and dh 80 / page 16 cases; planted faults in the
    plain version; bit-equality against kernels 1 and 4 on the gathered
    cache; device times at the main shapes."""
    import torch

    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import paged as pg

    bf16 = torch.bfloat16
    main = (1019,) * 4
    ragged = (1019, 700, 300, 130)
    # name, q_len, H, KV, dh, ps, max_pages, ctx, window, planted faults
    # (label, changes to the plain version's arguments: "page" shifts every
    # allocated page id by +-1, "ctx" adds to every ctx, "window")
    cases = [
        ("paged decode main B4 ps64 P16 H64 KV8 dh128 ctx1019", 1, 64, 8, 128, PAGE,
         MAX_PAGES, main, None, [("page index + 1", dict(page=1)),
                                 ("page index - 1", dict(page=-1)),
                                 ("ctx - 1", dict(ctx=-1))]),
        ("paged decode ragged ctx", 1, 64, 8, 128, PAGE, MAX_PAGES, ragged, None,
         [("ctx - 1", dict(ctx=-1))]),
        ("paged decode window 700", 1, 64, 8, 128, PAGE, MAX_PAGES, main, 700,
         [("window - 1", dict(window=699))]),
        ("paged decode dh80 ps16", 1, 16, 2, 80, 16, 64, (1000, 517), 300,
         [("page index + 1", dict(page=1))]),
        ("mq paged prefill round q128 ctx1019", 128, 64, 8, 128, PAGE, MAX_PAGES, main,
         None, [("page index + 1", dict(page=1)), ("ctx - 1", dict(ctx=-1)),
                ("row // G off by one", dict(ctx=1))]),
        ("mq paged verify q5 ctx1019", 5, 64, 8, 128, PAGE, MAX_PAGES, main, None,
         [("page index - 1", dict(page=-1)), ("ctx - 1", dict(ctx=-1)),
          ("row // G off by one", dict(ctx=1))]),
        ("mq paged q128 ragged ctx", 128, 64, 8, 128, PAGE, MAX_PAGES, ragged, None,
         [("ctx - 1", dict(ctx=-1))]),
        ("mq paged q5 window 700", 5, 64, 8, 128, PAGE, MAX_PAGES, main, 700,
         [("window - 1", dict(window=699))]),
        ("mq paged q9 dh80 ps16", 9, 16, 2, 80, 16, 64, (1000, 517), 300,
         [("page index + 1", dict(page=1))]),
    ]
    for name, Q, H, KV, dh, ps, maxp, ctx_t, window, planted in cases:
        log(f"phase 1: {name}")
        bt, P = shuffled_tables(ctx_t, ps, maxp, gen)
        B = len(ctx_t)
        ctx = torch.tensor(ctx_t, dtype=torch.int32, device="cuda")
        q = randn((B, Q, H, dh), bf16, gen)
        k = randn((P, ps, KV, dh), bf16, gen)
        v = randn((P, ps, KV, dh), bf16, gen)
        kern = pg.paged_decode_attention if Q == 1 else mq.mq_paged_decode_attention
        plain = pg.paged_decode_attention_plain if Q == 1 \
            else mq.mq_paged_decode_attention_plain
        n0 = (mq.paged_verify_sm90_launches, mq.paged_hopper_launches)
        out = kern(q, k, v, bt, ctx, window=window)
        torch.cuda.synchronize()
        if Q > 1:
            body = mq.mq_body(Q, H // KV, dh, 1)
            if (mq.paged_verify_sm90_launches - n0[0], mq.paged_hopper_launches - n0[1]) \
                    != (body == "verify", body == "mainloop"):
                raise AssertionError(f"{name}: the call did not take the {body} body")
            log(f"  {name}: the {body} body")
        ref = plain(q, k, v, bt, ctx, window=window)
        faults = []
        for label, kw in planted:
            bad_bt = torch.where(bt >= 0, (bt + kw.get("page", 0)) % P, bt)
            faults.append((label, plain(q, k, v, bad_bt, ctx + kw.get("ctx", 0),
                                        window=kw.get("window", window))))
        err = check(name, out, ref, BF16_REL, faults)
        paged_bitwise(name, q, k, v, bt, ctx, window, Q)
        if name.endswith("ctx1019"):
            key = "paged_decode_attention" if Q == 1 else (
                "mq_paged_decode_attention" if Q == 128 else "mq_paged_decode_attention@verify")
            rows[key] = time_paged(kern, plain, q, k, v, bt, ctx, err)


def time_paged(kern, plain, q, k, v, bt, ctx, err):
    """A paged kernel's row at a main shape (uniform ctx): its device time,
    the plain version's, SDPA's on the gathered cache (the gather itself
    not counted), the bound, and the time's split over the CUDA kernels
    one call launches."""
    import torch
    import torch.nn.functional as F
    Q, H, dh = q.shape[1], q.shape[2], q.shape[3]
    ps, KV = k.shape[1], k.shape[2]
    kc, _ = gathered(k, bt, int(ctx[0]))
    vc, _ = gathered(v, bt, int(ctx[0]))
    S = bt.shape[1] * ps
    qpos = ctx[:, None] - Q + torch.arange(Q, device="cuda")[None, :]   # (B, Q)
    vis = torch.arange(S, device="cuda")[None, None, :] <= qpos[:, :, None]
    ms = time_ms(lambda: kern(q, k, v, bt, ctx))
    plain_ms = time_ms(lambda: plain(q, k, v, bt, ctx), reps=10)
    lib = library_time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=vis[:, None], enable_gqa=True))
    split = pass_split(lambda: kern(q, k, v, bt, ctx))
    n_read = int(vis.any(1).sum())                  # (b, slot) some row sees
    pairs = int(vis.sum())                          # visible (b, qi, slot)
    byts = 2 * n_read * KV * dh * k.element_size() \
        + nbytes(q, bt, ctx) + nbytes(q)            # K, V rows; q, tables; out
    flops = 2 * 2 * pairs * H * dh
    log(f"    {ms:.4f} ms; sdpa yardstick on the cache gathered beforehand (gather not "
        f"counted): {lib} ms; split over kernels (µs per call, launches per call) "
        f"{split}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
                bytes=byts, flops=flops, split=split,
                bytes_bound_ms=byts / HBM_BYTES_PER_S * 1e3,
                ops_bound_ms=flops / (FP32_SIMT_FLOPS if Q == 1 else BF16_TENSOR_FLOPS) * 1e3)


def paged_decode_timed(gen, rows):
    """Kernel 3 at its main shape alone (phase 2b's pool: B 4, page 64, 16
    pages, ctx 1019, shuffled tables): its row as paged_phase times it."""
    import torch
    from repro_torch.kernels.decode_attention import paged as pg
    ctx_t = (1019,) * 4
    bt, P = shuffled_tables(ctx_t, PAGE, MAX_PAGES, gen)
    ctx = torch.tensor(ctx_t, dtype=torch.int32, device="cuda")
    q = randn((4, 1, 64, 128), torch.bfloat16, gen)
    k = randn((P, PAGE, 8, 128), torch.bfloat16, gen)
    v = randn((P, PAGE, 8, 128), torch.bfloat16, gen)
    out = pg.paged_decode_attention(q, k, v, bt, ctx)
    torch.cuda.synchronize()
    err = check("timed paged decode main", out,
                pg.paged_decode_attention_plain(q, k, v, bt, ctx), BF16_REL)
    rows["paged_decode_attention"] = time_paged(
        pg.paged_decode_attention, pg.paged_decode_attention_plain, q, k, v, bt, ctx, err)


# ----------------------------------------------------------------------------
# phase 1: the recurrent scans (6: WKV, 7: selective scan)
# ----------------------------------------------------------------------------
def wkv_variant(r, k, v, w, u, S, decay_on_v=False, update_first=False):
    """The WKV time loop with a planted fault: the decay on the v index of
    the state instead of the k index, or the state updated before the
    output reads it. Returns (out, final state)."""
    import torch
    rf, kf, vf = r.float(), k.float(), v.float()
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        wt = w[:, t, :, None, :] if decay_on_v else w[:, t, :, :, None]
        if update_first:
            S = wt * S + a
        outs.append(torch.einsum("bhk,bhkd->bhd", rf[:, t], S + uf * a))
        if not update_first:
            S = wt * S + a
    return torch.stack(outs, 1), S


def ssm_variant(x, dt, bm, cm, A, h, dt_in_update=True, dt_in_decay=True):
    """The selective scan's time loop with a planted fault: dt left out of
    the update, or the decay exp(A) in place of exp(A dt)."""
    import torch
    dec = torch.exp(A[None, None, :, None]
                    * (dt if dt_in_decay else torch.ones_like(dt))[..., None])
    ys = []
    for t in range(x.shape[1]):
        dbx = bm[:, t, None, :, None].float() * x[:, t, :, None, :].float()
        if dt_in_update:
            dbx = dt[:, t, :, None, None] * dbx
        h = dec[:, t, :, :, None] * h + dbx
        ys.append(torch.einsum("bn,bhnd->bhd", cm[:, t].float(), h))
    return torch.stack(ys, 1), h


def chunk_fault(chunked_plain, args, L, n_seq):
    """A chunked scan's model with a planted fault only a chunked scan can
    make: each chunk's state carried to the next without the chunk's decay
    (S_{c+1} = S_c + dS_c, dS_c the chunk's final state from zero). args:
    the scan's inputs, the first n_seq of them per step, the state last.
    Returns (out, final state)."""
    import torch
    seq, rest, s = args[:n_seq], args[n_seq:-1], args[-1]
    outs = []
    for lo in range(0, seq[0].shape[1], L):
        part = [t[:, lo:lo + L].contiguous() for t in seq]
        outs.append(chunked_plain(*part, *rest, s)[0])
        s = s + chunked_plain(*part, *rest, torch.zeros_like(s))[1]
    return torch.cat(outs, 1), s


def scan_inputs(kind, shape, gen):
    """Inputs of kernel 6 ("wkv": B, S, H, dh) or 7 ("ssm": B, S, H, dh, N)
    on the card in the model's types (r, k, v, u; x, B, C bf16), from a
    nonzero state."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    if kind == "wkv":
        B, S, H, dh = shape
        r, k, v = (randn((B, S, H, dh), f32, gen).mul_(0.5).to(bf16) for _ in range(3))
        w = torch.sigmoid(randn((B, S, H, dh), f32, gen)) * 0.9 + 0.05
        u = randn((H, dh), f32, gen).mul_(0.1).to(bf16)
        return [r, k, v, w, u, randn((B, H, dh, dh), f32, gen).mul_(2)]
    B, S, H, dh, N = shape
    x = randn((B, S, H, dh), f32, gen).mul_(0.5).to(bf16)
    dt = torch.nn.functional.softplus(randn((B, S, H), f32, gen))
    bm, cm = (randn((B, S, N), f32, gen).mul_(0.5).to(bf16) for _ in range(2))
    A = -torch.exp(randn((H,), f32, gen) * 0.3)
    return [x, dt, bm, cm, A, randn((B, H, N, dh), f32, gen)]


def extreme_decays(kind, a, gen):
    """The inputs a with extreme decays: WKV's w 0 at every 61st step and
    otherwise 1e-30 or 1 - 1e-6 (3:7); the selective scan's dt 20 at every
    61st step (a decay of e^-20 and less) and 1e-3 at every 7th (a decay of
    about 1). Both reset the state now and then and keep it for stretches
    in between."""
    import torch
    a = list(a)
    if kind == "wkv":
        pick = torch.rand(a[3].shape, generator=gen, device="cuda") < 0.3
        a[3] = torch.where(pick, 1e-30, 1 - 1e-6).float()
        a[3][:, ::61] = 0.0
    else:
        a[1] = a[1].clone()
        a[1][:, ::7] = 1e-3
        a[1][:, ::61] = 20.0
    return a


def scan_f64(kind, a):
    """The scan's time loop in fp64 on the card: the reference of the
    extreme-decay cases, where an output that is one fresh, nearly
    cancelling term can leave the fp32 loop itself more than SCAN_REL off
    (up to 5e-4 in tests/test_torch_scan_chunked.py's cases)."""
    import torch
    if kind == "wkv":
        r, k, v, w, u, S = (t.double() for t in a)
        outs = []
        for t in range(r.shape[1]):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            outs.append(torch.einsum("bhk,bhkd->bhd", r[:, t], S + u[None, :, :, None] * kv))
            S = w[:, t, :, :, None] * S + kv
        return torch.stack(outs, 1), S
    x, dt, bm, cm, A, h = (t.double() for t in a)
    dec = torch.exp(A[None, None, :, None] * dt[..., None])
    ys = []
    for t in range(x.shape[1]):
        h = dec[:, t, :, :, None] * h \
            + dt[:, t, :, None, None] * bm[:, t, None, :, None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnd->bhd", cm[:, t], h))
    return torch.stack(ys, 1), h


def scan_bounds(kind, a, out, chunked):
    """(bytes, flops, bytes bound ms, operations bound ms) of one scan
    call: every input read once, the state read and written, out (fp32)
    written; the sequential body's 5 fp32 operations per state element and
    step at the SIMT peak, the chunked form's matrix products (each counted
    once, the three-term splits not) at the bf16 tensor-core peak."""
    byts = nbytes(*a[:5]) + 2 * nbytes(a[5]) + nbytes(out)
    B, S, H, dh = a[0].shape
    if not chunked:
        flops = 5 * B * S * H * dh * (dh if kind == "wkv" else a[2].shape[-1])
        return byts, flops, byts / HBM_BYTES_PER_S * 1e3, flops / FP32_SIMT_FLOPS * 1e3
    if kind == "wkv":
        from repro_torch.kernels.rwkv6_scan import ops as wkv
        L, sub = wkv.chunk_len(dh), wkv.SUB
        ns = L // sub
        # dS_T (twice: the chunk's dS, the sub-chunk states), o = q·S_T,
        # D·v, per chunk
        per = 2 * dh * dh * sub * (2 * ns - 1) + 2 * sub * dh * dh * ns + 2 * sub * sub * dh * ns
    else:
        from repro_torch.kernels.ssm_scan import ops as ssm
        L, N = ssm.CHUNK, a[2].shape[-1]
        # C·Bᵀ, M·x, C·h, dh
        per = 2 * L * L * N + 2 * L * L * dh + 2 * L * N * dh + 2 * N * L * dh
    flops = per * B * H * -(-S // L)
    return byts, flops, byts / HBM_BYTES_PER_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3


def scan_phase(gen, rows):
    """Kernels 6 and 7 against their plain versions on the card: at the
    serves' prefill shapes (RWKV6-3B: B 4 and B 1, S 512, H 40, dh 64;
    Hymba-1.5B: H 25, N 16), decode shapes (S 1), at S 7 and 50 with dh 32
    and 128 (B 1), every case from a nonzero state, and at the B 4 prefill
    shape with extreme decays (held to fp64, no NaN); the output and the
    final state (updated in place) within SCAN_REL of each vector's largest
    |ref|. A bf16 call of S >= 128 must run the chunked body (its counter)
    and agree with that body's model (*_chunked_plain) as well; planted
    faults rejected, among them one only a chunked scan can make (a
    chunk's state carried without the chunk's decay); two calls over the
    halves of a sequence bit-equal to one. Device times, bounds and the
    profiler's µs per call at the prefill (B 4, B 1) and decode shapes."""
    import torch

    from repro_torch.kernels.rwkv6_scan import ops as wkv
    from repro_torch.kernels.ssm_scan import ops as ssm

    # (name, kind, shape, planted faults, key of the timed shapes or None,
    # extreme decays)
    cases = []
    for shape, key in (((4, 512, 40, 64), "wkv_scan"), ((1, 512, 40, 64), "wkv_scan@B1"),
                       ((4, 1, 40, 64), "wkv_scan@decode"), ((1, 7, 40, 32), None),
                       ((1, 50, 40, 128), None)):
        cases.append(("wkv_scan B%d S%d H%d dh%d" % shape, "wkv", shape, key == "wkv_scan",
                      key, False))
    for shape, key in (((4, 512, 25, 64, 16), "ssm_scan"),
                       ((1, 512, 25, 64, 16), "ssm_scan@B1"),
                       ((4, 1, 25, 64, 16), "ssm_scan@decode"), ((1, 7, 25, 32, 16), None),
                       ((1, 50, 25, 128, 16), None)):
        cases.append(("ssm_scan B%d S%d H%d dh%d N%d" % shape, "ssm", shape,
                      key == "ssm_scan", key, False))
    cases += [("wkv_scan B4 S512 H40 dh64, extreme decays", "wkv", (4, 512, 40, 64), False,
               None, True),
              ("ssm_scan B4 S512 H25 dh64 N16, extreme decays", "ssm", (4, 512, 25, 64, 16),
               False, None, True)]

    for name, kind, shape, planted, key, extreme in cases:
        mod = wkv if kind == "wkv" else ssm
        fn = mod.wkv if kind == "wkv" else mod.ssm_scan
        plain = mod.wkv_plain if kind == "wkv" else mod.ssm_scan_plain
        chunked_plain = mod.wkv_chunked_plain if kind == "wkv" else mod.ssm_scan_chunked_plain
        a = scan_inputs(kind, shape, gen)
        if extreme:
            a = extreme_decays(kind, a, gen)
        S, dh = shape[1], shape[3]
        chunked = wkv.takes_chunked(S, a[0].dtype, dh) if kind == "wkv" \
            else ssm.takes_chunked(S, a[0].dtype, dh, shape[4])
        log(f"phase 1: {name}, nonzero initial state, "
            f"{'chunked' if chunked else 'sequential'} body")
        ref_o, ref_s = scan_f64(kind, a) if extreme else plain(*a)
        if extreme:        # the conditioning: the fp32 time loop against fp64
            log(f"  the fp32 time loop against fp64: output rel_err "
                f"{rel_err(plain(*a)[0], ref_o):.3e}")
        s = a[5].clone()
        n0 = (mod.launches, mod.chunked_launches)
        out = fn(*a[:5], s)
        torch.cuda.synchronize()
        if (mod.launches, mod.chunked_launches) != (n0[0] + 1, n0[1] + chunked):
            raise AssertionError(f"{name}: launched {mod.launches - n0[0]} kernels, "
                                 f"{mod.chunked_launches - n0[1]} on the chunked body")
        faults = []
        if planted:
            # (label, plain outputs with the fault, whether it changes the
            # final state)
            if kind == "wkv":
                faults = [("u dropped",
                           wkv.wkv_plain(*a[:4], torch.zeros_like(a[4]), a[5]), False),
                          ("decay on the v index", wkv_variant(*a, decay_on_v=True), True),
                          ("state updated before the output",
                           wkv_variant(*a, update_first=True), False)]
            else:
                x, dt, bm, cm, A, h0 = a
                faults = [("B and C swapped", ssm.ssm_scan_plain(x, dt, cm, bm, A, h0), True),
                          ("dt left out of the update",
                           ssm_variant(*a, dt_in_update=False), True),
                          ("decay exp(A), not exp(A dt)",
                           ssm_variant(*a, dt_in_decay=False), True)]
            L = wkv.chunk_len(dh) if kind == "wkv" else ssm.CHUNK
            faults.append(("a chunk's state carried without its decay",
                           chunk_fault(chunked_plain, a, L, 4), True))
        err = check(name + " output", out, ref_o, SCAN_REL,
                    [(label, bad[0]) for label, bad, _ in faults])
        check(name + " final state (in place)", s, ref_s, SCAN_REL,
              [(label, bad[1]) for label, bad, touches in faults if touches])
        if chunked:        # and the chunked body's own model
            m_o, m_s = chunked_plain(*a)
            check(name + " output vs the chunked model", out, m_o, SCAN_REL)
            check(name + " final state vs the chunked model", s, m_s, SCAN_REL)
        if S > 1:          # chained: the halves of the sequence, state in place
            h = S // 2
            s2 = a[5].clone()
            parts = [fn(*(t[:, lo:hi].contiguous() for t in a[:4]), a[4], s2)
                     for lo, hi in ((0, h), (h, S))]
            torch.cuda.synchronize()
            same = torch.equal(torch.cat(parts, 1), out) and torch.equal(s2, s)
            log(f"    two calls over steps [0, {h}) and [{h}, {S}) bit-equal to one "
                f"call: {same}")
            if not same:
                raise AssertionError(f"{name}: state chaining differs")
        if key is None:
            continue
        s_t = a[5].clone()
        ms = time_ms(lambda: fn(*a[:5], s_t))
        plain_ms = time_ms(lambda: plain(*a), reps=5 if S > 1 else 30)
        byts, flops, bb, ob = scan_bounds(kind, a, out, chunked)
        split = pass_split(lambda: fn(*a[:5], s_t))
        rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                         bytes=byts, flops=flops, bytes_bound_ms=bb, ops_bound_ms=ob)
        log(f"    device µs and launches per call (profiler): {split}; no single "
            "PyTorch call computes this scan: library time none")


# ----------------------------------------------------------------------------
# phase 2: the single-device path
# ----------------------------------------------------------------------------
def make_prompts(n, vocab, seed):
    import numpy as np
    return [np.random.default_rng(seed + i).integers(1, vocab, size=PROMPT_LEN)
            .astype(np.int32) for i in range(n)]


def serve(cfg, params, pattern, prompts, impl, max_new=MAX_NEW):
    from repro_torch.serving import LimeServer, cli_arrivals
    srv = LimeServer(cfg, params, max_len=MAX_LEN, pattern=pattern, impl=impl)
    arrivals = cli_arrivals(pattern, len(prompts), prompt_len=PROMPT_LEN,
                            max_new_tokens=max_new, burst_size=srv.slots)
    for ev, p in zip(arrivals, prompts):
        srv.queue.submit(p, ev.max_new_tokens, now=ev.time_s)
    done = srv.serve_all()
    return sorted(done, key=lambda r: r.rid)


def served_batches(pattern, n_req):
    """Request indices of each batch the server formed: the bursty burst
    rides one batch of 4 slots, sporadic serves one request at a time."""
    return [list(range(n_req))] if pattern == "bursty" else [[i] for i in range(n_req)]


def forced_logits(cfg, params, prompts, feed, width, impl, after_prefill=None):
    """Logits (T, n, vocab) fp32 of one served batch of n requests, built as
    EngineBackend builds it (prompts left-padded with token 0, the batch
    padded to `width` rows with replicas of the last prompt): prefill, then
    T - 1 decode steps fed the (n, T) tokens `feed`. Replica rows replay
    their first token, as the backend's inactive slots do. after_prefill,
    where given, edits the prefilled cache in place (a planted fault)."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.backend import EngineBackend
    toks = EngineBackend._pad_prompts(prompts)
    n, T = feed.shape
    toks = np.concatenate([toks, np.tile(toks[-1:], (width - n, 1))], 0)
    feed = np.concatenate([feed, np.full((width - n, T), feed[-1, 0])], 0)
    cache = M.init_cache(cfg, width, MAX_LEN)
    lg, cache = M.prefill(cfg, params, torch.from_numpy(toks).long().cuda(),
                          cache, impl=impl)
    if after_prefill is not None:
        after_prefill(cache)
    out = [lg[:n, -1, :cfg.vocab_size].float()]
    for t in range(T - 1):
        lg, cache = M.decode_step(cfg, params, cache,
                                  torch.from_numpy(feed[:, t:t + 1]).long().cuda(),
                                  impl=impl)
        out.append(lg[:n, -1, :cfg.vocab_size].float())
    return torch.stack(out)


def compare_greedy(cfg, params, pattern, prompts, got, ref, width,
                   tol=LOGIT_REL_TOL, keep=None, max_new=MAX_NEW):
    """Every decoded position of every request. The reference serve's tokens
    are fed through both impls at the served batch shape. At each position:
    the reference's argmax is its served token (the forced run reproduces
    the serve); the kernel path's logits lie within tol of the largest
    |logit|; the kernel path's argmax is the reference's or a near
    tie (the reference logit of its pick within the measured logit error of
    the reference's top, or the kernel path's own logits of the two picks
    equal: its argmax broke an exact tie by index). The kernel serve's tokens up to its first
    divergence from the reference serve are the kernel path's argmaxes.
    Each batch's reference logits (T, n, V) are appended to `keep` where
    given. Serves of max_new tokens a request. Returns (positions
    compared, near-tie positions, worst error / |logit|)."""
    import numpy as np
    n_pos = n_tie = 0
    worst = 0.0
    for idx in served_batches(pattern, len(prompts)):
        for i in idx:
            assert len(got[i].output) == len(ref[i].output) == max_new, \
                (len(got[i].output), len(ref[i].output))
        feed = np.array([ref[i].output for i in idx], np.int64)
        ps = [prompts[i] for i in idx]
        lk = forced_logits(cfg, params, ps, feed, width, "kernel")
        lr = forced_logits(cfg, params, ps, feed, width, "ref")
        if keep is not None:
            keep.append(lr)
        ak, ar = lk.argmax(-1), lr.argmax(-1)                 # (T, n)
        if not (ar.cpu().numpy().T == feed).all():
            raise AssertionError(f"{pattern}: the forced reference run does not "
                                 "reproduce the reference serve")
        err = (lk - lr).abs().amax(-1)                        # (T, n)
        scale = lr.abs().amax(-1)
        gap = (lr.gather(-1, ar[..., None]) - lr.gather(-1, ak[..., None]))[..., 0]
        kgap = (lk.gather(-1, ak[..., None]) - lk.gather(-1, ar[..., None]))[..., 0]
        far = err > tol * scale
        not_tie = (ak != ar) & (gap > err) & (kgap > 0)
        worst = max(worst, (err / scale).max().item())
        for j, i in enumerate(idx):
            a, b = got[i].output, ref[i].output
            t_div = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), max_new)
            ties = [t for t in range(max_new) if ak[t, j] != ar[t, j]]
            log(f"  {pattern} req {ref[i].rid}: {max_new} positions, kernel argmax "
                f"differs at {ties or 'none'} (ref gap there "
                f"{[round(gap[t, j].item(), 4) for t in ties]}, kernel gap "
                f"{[round(kgap[t, j].item(), 4) for t in ties]}, logit err "
                f"{[round(err[t, j].item(), 4) for t in ties]}); max logit err "
                f"{err[:, j].max().item():.4f} at |logit| max {scale[:, j].max().item():.2f}; "
                f"served tokens agree up to {t_div}")
            if far[:, j].any() or not_tie[:, j].any():
                raise AssertionError(f"req {ref[i].rid}: kernel logits off the "
                                     "reference outside the near-tie rule")
            upto = min(t_div + 1, max_new)
            if a[:upto] != ak[:upto, j].tolist():
                raise AssertionError(f"req {ref[i].rid}: the kernel serve's tokens "
                                     "are not the kernel path's argmaxes")
            n_pos += max_new
            n_tie += len(ties)
    return n_pos, n_tie, worst


def main_path_phase(card):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("llama3.3-70b"), n_layers=N_LAYERS)
    log(f"phase 2: single-device path, {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), depth cut to {cfg.n_layers} of 80 layers")
    t0 = time.monotonic()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"  params: {n_par / 1e9:.2f} B in {time.monotonic() - t0:.1f} s")
    served = {}
    launches = single_device_checks(cfg, params, card, "2", served=served)
    return launches, cfg, params, served["bursty"]


def single_device_checks(cfg, params, card, phase, hopper=True, tol=LOGIT_REL_TOL,
                         faults=False, served=None):
    """A dense config's single-device path on the card: warm-up serves,
    then bursty and sporadic serves through LimeServer with exact launch
    counts of kernels 1 and 2 (each call on the Hopper bodies, or with
    hopper=False on none of them: head_dim 160), peak memory, a profiled
    bursty serve (breakdown), and the reference re-serve held to the
    kernel path by compare_greedy within `tol` of |logit| max. With
    faults, the reference's own noise floor at this depth, and planted
    prefill faults (planted_faults) that the limit must reject. Returns
    the serves' launches; `served`, where given, receives each pattern's
    (prompts, kernel serve)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import Family
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.serving import LimeServer, summarize

    depth = f"{cfg.n_layers} of {get_full_layers(cfg)} layers"
    # warm-up at both batch widths (cuBLAS handles and heuristics, the
    # allocator): not part of the measured runs
    serve(cfg, params, "bursty", make_prompts(4, cfg.vocab_size, 99), "kernel",
          max_new=2)
    serve(cfg, params, "sporadic", make_prompts(1, cfg.vocab_size, 99), "kernel",
          max_new=2)
    torch.cuda.synchronize()

    launches = {"flash_attention": 0, "decode_attention": 0, "flash_attention@hopper": 0,
                "decode_attention@hopper": 0}
    outs = {}
    torch.cuda.reset_peak_memory_stats()
    for pattern, n_req in (("bursty", 4), ("sporadic", 2)):
        prompts = make_prompts(n_req, cfg.vocab_size, 0)
        n_batches = 1 if pattern == "bursty" else n_req
        fa.launches = fa.hopper_launches = 0
        da.launches = da.hopper_launches = 0
        done = serve(cfg, params, pattern, prompts, "kernel")
        torch.cuda.synchronize()
        got = {"flash_attention": fa.launches, "decode_attention": da.launches,
               "flash_attention@hopper": fa.hopper_launches,
               "decode_attention@hopper": da.hopper_launches}
        want = {"flash_attention": cfg.n_layers * n_batches,
                "decode_attention": cfg.n_layers * (MAX_NEW - 1) * n_batches,
                "flash_attention@hopper": cfg.n_layers * n_batches * hopper,
                "decode_attention@hopper": cfg.n_layers * (MAX_NEW - 1) * n_batches * hopper}
        log(f"  {pattern}: launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{pattern}: kernel launch counts {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        rep = summarize(done, pattern=pattern, backend="single-device")
        log(f"  {pattern}: {rep.n_requests} requests x {MAX_NEW} tokens, prompt "
            f"{PROMPT_LEN}: TTFT p50 {rep.ttft_p50_s * 1e3:.2f} ms, p99 "
            f"{rep.ttft_p99_s * 1e3:.2f} ms, decode {rep.decode_tok_s_p50:.2f} tok/s "
            f"per request (p50) = {1e3 / rep.decode_tok_s_p50:.3f} ms/token, "
            f"span ms/token {rep.ms_per_token:.3f} [{card}; {cfg.name}, {depth}]")
        outs[pattern] = (prompts, done)
    if served is not None:
        served.update(outs)
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 2**30:.2f} GiB [{card}]")
    # an MoE layer launches ~3x a dense layer's ops, and the profiler's
    # own event processing took 83 s over a 32-token MoE serve: 8 tokens
    breakdown(cfg, params, card, hopper,
              max_new=MOE_NEW if cfg.family == Family.MOE else MAX_NEW)

    log(f"phase {phase}: re-serve on the reference math (impl='ref'), then both impls "
        "fed the reference's tokens at the served batch shape")
    ref_logits, refs = [], {}
    moe = cfg.family == Family.MOE
    for pattern, (prompts, done) in outs.items():
        refs[pattern] = ref = serve(cfg, params, pattern, prompts, "ref")
        width = LimeServer(cfg, params, pattern=pattern).slots
        with moe_calls() as calls:
            n_pos, n_tie, worst = compare_greedy(cfg, params, pattern, prompts, done,
                                                 ref, width, tol, ref_logits)
        if moe and pattern == "bursty":
            # the forced kernel run, then the forced reference run
            n_moe = cfg.n_layers - cfg.first_dense_layers
            half = len(calls) // 2
            pre, dec, per_pre, per_dec = route_flips(calls[:half], calls[half:], n_moe)
            log(f"  {pattern}: routes that differ between the kernel path and 'ref' per "
                f"MoE layer (layers {cfg.first_dense_layers}..{cfg.n_layers - 1}): "
                f"prefill {pre} of {per_pre} tokens each, decode {dec} of {per_dec} "
                f"each [{card}]")
        del calls
        n_same = sum(a.output == b.output for a, b in zip(done, ref))
        log(f"  {pattern}: {n_same}/{len(done)} requests token-identical; "
            f"{n_pos} positions compared, {n_tie} near ties, worst logit err "
            f"{worst:.4f} of |logit| max (tol {tol}) [{card}; {cfg.name}, {depth}]")
    if faults:
        prompts = outs["bursty"][0]
        feed = np.array([r.output for r in refs["bursty"]], np.int64)
        floor = noise_floor(cfg, params, prompts, feed, ref_logits[0])
        floor_max = {**TAB3_NOISE_FLOOR_MAX, MOE_ARCH: MOE_NOISE_FLOOR_MAX}[cfg.name]
        log(f"  the reference's own noise floor: each bursty request fed alone against "
            f"the 4-wide batch, logit err up to {floor:.4f} of |logit| max (at most "
            f"{floor_max}) [{card}; {cfg.name}, {depth}]")
        if floor > floor_max:
            raise AssertionError(f"{cfg.name}: the reference's own noise floor "
                                 f"{floor:.4f} is above {floor_max}")
        if moe:
            moe_fault_check(cfg, params, prompts, feed, card)
            return launches
        errs = fault_errors(cfg, params, prompts, feed, ref_logits[0])
        log(f"  planted prefill faults, the kernel path's logit err / |logit| max against "
            f"the reference: {', '.join(f'{k} {v:.4f}' for k, v, _ in errs)} (limit {tol}) "
            f"[{card}]")
        missed = [k for k, v, must in errs if must and v <= tol]
        if missed:
            raise AssertionError(f"{cfg.name}: the logit limit {tol} passes planted "
                                 f"faults {missed}")
    return launches


def get_full_layers(cfg):
    """The depth of cfg's published config (cfg may be a depth cut)."""
    from repro_torch.configs import get_config
    return get_config(cfg.name).n_layers


def csrc_kernel(name):
    """(class, label) of a profiled kernel of csrc/, else None; class is
    decode, flash, mq, wkv or ssm. Every kernel lives in namespace repro:
    the mma.sync and SIMT kernels are named after their file (decode_*kernel
    in decode_attention.cu, flash_*kernel, mq_*kernel, wkv_*, ssm_*); the
    verify body of kernels 4 and 5 is verify_sm90_kernel; the Hopper
    mainloop is sm90::attention_kernel<DHP, Addr>, whose Addr names its
    caller (FlashAddr; ContigMqAddr, PagedMqAddr); the scans' chunked
    bodies are wkv_scan_kernel_chunked and ssm_scan_kernel_chunked
    (labelled with the suffix). Both forms hold for mangled and demangled
    names."""
    name = name.lower()
    if "repro" not in name:
        return None
    if "sm90" in name and "attention_kernel" in name:
        return ("flash" if "flashaddr" in name else "mq"), "sm90_attention_kernel"
    if "verify_sm90_kernel" in name:
        return "mq", "verify_sm90_kernel"
    m = re.search(r"(decode|flash|mq|wkv|ssm)_[a-z0-9_]*?kernel", name)
    if m is None:
        return None
    # the chunked bodies of the scans: wkv_scan_kernel_chunked, ...
    return m.group(1), m.group(0) + ("_chunked" if "scan_kernel_chunked" in name else "")


def one_pass(name):
    """A profiled kernel name must not be a second pass: kernels 1, 3, 4
    and 5 merge their splits inside one launch (no decode_combine_kernel,
    no mq_combine_kernel)."""
    if "combine_kernel" in name:
        raise AssertionError(f"a second pass ran: {name}")


def profiled(fn, kernel):
    """(profiler, wall µs) of fn() under torch.profiler (CPU and CUDA
    activity). The card's profiler now and then returns a session that
    holds not one device event of a kernel that ran (all of them lost, the
    serve itself fine); then fn runs once more under a new session. A count
    that is there but wrong is left to the caller to reject."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        seen = any(e.device_type == torch.autograd.DeviceType.CUDA and "repro" in e.name
                   and kernel in e.name for e in prof.events())
        if seen or attempt == 2:
            return prof, wall_us
        log(f"  the profiler returned no device event of {kernel}, which ran: "
            "profiling the serve once more")


def breakdown(cfg, params, card, hopper=True, max_new=MAX_NEW):
    """Device time by kernel class over one bursty serve of max_new tokens
    a request (torch.profiler, kernels' own time), and the device's idle
    share of the serve's wall time under the profiler. The serve's csrc/
    kernels must be the Hopper bodies (decode_sm90_kernel, the mainloop),
    or with hopper=False the bodies head_dim 160 takes (decode_tile_kernel,
    flash_mma_kernel)."""
    import torch

    prompts = make_prompts(4, cfg.vocab_size, 7)
    want = ({"decode_sm90_kernel", "sm90_attention_kernel"} if hopper
            else {"decode_tile_kernel", "flash_mma_kernel"})
    prof, wall_us = profiled(lambda: serve(cfg, params, "bursty", prompts, "kernel",
                                           max_new=max_new),
                             "decode_sm90_kernel" if hopper else "decode_tile_kernel")
    by = {"decode_attention": 0.0, "flash_attention": 0.0, "gemm": 0.0,
          "other": 0.0}
    seen = {"decode_attention": {}, "flash_attention": {}}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        one_pass(name)
        m = csrc_kernel(name)
        if m is not None:
            cls = m[0] + "_attention"
            seen[cls][m[1]] = seen[cls].get(m[1], 0) + e.count
        elif any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "other"
        by[cls] += us
    busy = sum(by.values())
    n_dec, n_fl = cfg.n_layers * (max_new - 1), cfg.n_layers
    log(f"  profiled kernels of csrc/ (name: launches): {seen}")
    for cls in seen:
        if by[cls] <= 0:
            raise AssertionError(f"breakdown: the profiler shows no device time "
                                 f"for {cls}, whose kernels ran")
    if {k for d in seen.values() for k in d} != want:
        raise AssertionError(f"breakdown: the serve ran {seen}, not the bodies {want}")
    log(f"  in the serve: decode_attention {by['decode_attention'] / n_dec:.2f} us "
        f"per call ({n_dec} calls), flash_attention "
        f"{by['flash_attention'] / n_fl:.2f} us per call ({n_fl} calls)")
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by.items())
    log(f"  bursty serve device time by class: {parts}; busy {busy / 1e3:.2f} ms of "
        f"{wall_us / 1e3:.2f} ms wall, idle share {1 - busy / wall_us:.1%} "
        f"[{card}; {cfg.name}, {cfg.n_layers} of {get_full_layers(cfg)} layers]")


# ----------------------------------------------------------------------------
# phase 2b: paged KV and the radix prefix cache, 8 layers
# ----------------------------------------------------------------------------
PREFIX_PROMPT, PREFIX_LEN, PREFIX_NEW, PREFIX_CHUNK = 512, 384, 16, 128
UNEQUAL_LENS = (512, 480, 400, 300)


def prefix_requests(cfg):
    """Two epochs of 4 shared-prefix requests (one template: 384 of 512
    prompt tokens, 16 new tokens each), all arriving at t = 0 so each epoch
    fills the 4 slots, then one epoch of unequal prompt lengths."""
    import numpy as np
    from repro_torch.serving import (Request, make_arrivals,
                                     requests_from_arrivals)
    arr = make_arrivals("shared_prefix", 8, n_templates=1, prefix_len=PREFIX_LEN,
                        prompt_len=PREFIX_PROMPT, max_new_tokens=PREFIX_NEW,
                        seed=0)
    arr = [dataclasses.replace(a, time_s=0.0) for a in arr]
    reqs = requests_from_arrivals(arr, vocab_size=cfg.vocab_size, seed=0)
    rng = np.random.default_rng(11)
    reqs += [Request(8 + i, rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                     PREFIX_NEW) for i, n in enumerate(UNEQUAL_LENS)]
    return reqs


def prefix_server(cfg, params):
    from repro_torch.serving import LimeServer
    return LimeServer(cfg, params, max_len=MAX_LEN, pattern="bursty",
                      prefix_cache=True, prefill_chunk_tokens=PREFIX_CHUNK,
                      page_size=PAGE)


def kernel_counters():
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    from repro_torch.kernels.ssm_scan import ops as ssm
    return {"decode_attention": (da, "launches"), "flash_attention": (fa, "launches"),
            "mq_decode_attention": (mq, "launches"),
            "paged_decode_attention": (pg, "launches"),
            "mq_paged_decode_attention": (mq, "paged_launches"),
            "wkv_scan": (wkv, "launches"), "ssm_scan": (ssm, "launches"),
            # the launches of the Hopper mainloop and decode body among them
            "flash_attention@hopper": (fa, "hopper_launches"),
            "decode_attention@hopper": (da, "hopper_launches"),
            "paged_decode_attention@hopper": (pg, "hopper_launches"),
            "mq_decode_attention@prefill": (mq, "hopper_launches"),
            "mq_paged_decode_attention@prefill": (mq, "paged_hopper_launches"),
            # and of the verify body
            "mq_decode_attention@verify": (mq, "verify_sm90_launches"),
            "mq_paged_decode_attention@verify": (mq, "paged_verify_sm90_launches"),
            # and of the scans' chunked bodies
            "wkv_scan@chunked": (wkv, "chunked_launches"),
            "ssm_scan@chunked": (ssm, "chunked_launches")}


def read_counts():
    return {k: getattr(m, a) for k, (m, a) in kernel_counters().items()}


def zero_counts():
    for m, a in kernel_counters().values():
        setattr(m, a, 0)


def drive_prefix(srv, reqs, n_layers):
    """Serve reqs one scheduler step at a time. Each step launches exactly
    what it implies: an equal-length epoch's prefill n_layers paged
    multi-query kernels per 128-position round (the uncached suffix only),
    an unequal one n_layers flash kernels (dense prefill, scattered into
    pages), a decode step n_layers paged decode kernels, and nothing of the
    contiguous kernels. The device block table is uploaded only when a
    table changed. Returns (requests, stats, per-epoch records)."""
    import torch
    from repro_torch.serving import ContinuousBatchingScheduler, SchedulerConfig
    be = srv.make_backend()
    sched = ContinuousBatchingScheduler(be, SchedulerConfig())
    sched.begin(reqs)
    epochs = []
    while True:
        n_rounds = len(be.rounds)
        c0 = read_counts()
        up0 = be._paged_cache.bt_uploads if be._paged_cache is not None else 0
        saved0 = be._saved_tokens
        if not sched.step():
            break
        torch.cuda.synchronize()
        got = {k: v - c0[k] for k, v in read_counts().items()}
        want = dict.fromkeys(got, 0)
        pc = be._paged_cache
        if len(be.rounds) > n_rounds:                  # a decode step
            want["paged_decode_attention"] = want["paged_decode_attention@hopper"] = n_layers
            ep = epochs[-1]
            ep["decode_steps"] += 1
            ep["uploads"] += pc.bt_uploads - up0
            if pc.pos - 1 > ep["pos0"] and (pc.pos - 1) % PAGE == 0:
                ep["crossings"] += 1                   # a new page
        else:                                          # an epoch's prefill
            seen = {r.rid for e in epochs for r in e["reqs"]}
            batch = [r for r in reqs
                     if r.admitted_s is not None and r.rid not in seen]
            equal = len({r.prompt_len for r in batch}) == 1
            saved = be._saved_tokens - saved0
            rounds = math.ceil((pc.pos - saved // len(batch)) / PREFIX_CHUNK) \
                if equal else 0
            if equal:
                want["mq_paged_decode_attention"] = n_layers * rounds
                want["mq_paged_decode_attention@prefill"] = n_layers * rounds
            else:
                want["flash_attention"] = want["flash_attention@hopper"] = n_layers
            epochs.append(dict(reqs=batch, equal=equal, rounds=rounds, saved=saved,
                               decode_steps=0, uploads=pc.bt_uploads - up0,
                               pos0=pc.pos, crossings=0))
        if got != want:
            raise AssertionError(f"prefix serve step: launches {got}, expected {want}")
    done = sched.finish_run()
    for ep in epochs:
        # one upload per prefill round (each round grows every table), one
        # for an unequal epoch's first step (seed rebuilt the tables), one
        # per page boundary a decode step crosses after that
        want = (ep["rounds"] if ep["equal"] else 1) + ep["crossings"] \
            + (1 if ep["equal"] and ep["pos0"] % PAGE == 0 else 0)
        if ep["uploads"] != want:
            raise AssertionError(f"block-table uploads {ep['uploads']}, expected {want}")
    return done, sched.stats, epochs


def prefix_forced_logits(cfg, params, donor_prompts, prompts, feed):
    """Logits (T, 4, V) of `prompts` fed `feed` (4, T) through two paged
    caches, built as the backend builds them: cold (the whole prompt in
    128-position rounds) and warm (the template's pages computed for row 0
    of a donor batch, forked into every row, then the 128-token suffix)."""
    import numpy as np
    import torch
    from repro_torch.kvcache.allocator import BlockTable
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    from repro_torch.kvcache.pool import PagedKVConfig, PagePool
    V = cfg.vocab_size
    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    cold = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, impl="kernel")
    pool = PagePool(PagedKVConfig(page_size=PAGE, device_pages=8 * MAX_PAGES))
    donor = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, pool=pool, impl="kernel")
    donor.prefill(params, torch.from_numpy(np.stack(donor_prompts)).long().cuda(),
                  chunk=PREFIX_CHUNK)
    warm = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, pool=pool, impl="kernel")
    del warm.k_pool, warm.v_pool
    warm.k_pool, warm.v_pool = donor.k_pool, donor.v_pool   # one pool, as served
    shared = donor.tables[0].pages[:PREFIX_LEN // PAGE]
    tables = []
    for _ in range(4):
        for pid in shared:
            pool.incref_page(pid)
        tables.append(BlockTable(PAGE, list(shared), PREFIX_LEN))
    warm.adopt_tables(tables, PREFIX_LEN)
    lc = [cold.prefill(params, toks, chunk=PREFIX_CHUNK)[:, :V].float()]
    lw = [warm.prefill(params, toks[:, PREFIX_LEN:], chunk=PREFIX_CHUNK)[:, :V].float()]
    feed = torch.from_numpy(np.asarray(feed)).long().cuda()
    for t in range(feed.shape[1] - 1):
        lc.append(cold.step(params, feed[:, t:t + 1])[:, 0, :V].float())
        lw.append(warm.step(params, feed[:, t:t + 1])[:, 0, :V].float())
    return torch.stack(lc), torch.stack(lw)


def seeded_bitwise(cfg, params, prompts, card, steps=8):
    """Decode on a paged cache seeded from the dense (flash) prefill, its
    tables non-contiguous, against the contiguous decode_step through
    kernel 1 on the same cache: bit-equal logits at every step (max_len is
    a multiple of the page size, so both walk the same 1024 slots in the
    same splits and tiles); then one 5-position verify (kernel 5 against
    kernel 4), bit-equal too."""
    import numpy as np
    import torch
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    from repro_torch.kvcache.pool import PagedKVConfig, PagePool
    from repro_torch.models import model as M
    V = cfg.vocab_size
    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    cache = M.init_cache(cfg, 4, MAX_LEN)
    lg, cache = M.prefill(cfg, params, toks, cache, impl="kernel")
    pool = PagePool(PagedKVConfig(page_size=PAGE, device_pages=4 * MAX_PAGES + 16))
    churn = pool.alloc_pages(40)
    for pid in np.random.default_rng(5).permutation(churn):
        pool.decref_page(int(pid))                    # LIFO: shuffled reuse
    pc = PagedDecodeCache(cfg, 4, MAX_LEN, page_size=PAGE, pool=pool, impl="kernel")
    pc.seed(cache)
    contiguous = all(np.all(np.diff(t.pages) == 1) for t in pc.tables)
    tok = lg[:, -1, :V].argmax(-1, keepdim=True)
    same = []
    for _ in range(steps):
        lm, cache = M.decode_step(cfg, params, cache, tok, impl="kernel")
        lp = pc.step(params, tok)
        same.append(torch.equal(lm, lp))
        tok = lm[:, -1, :V].argmax(-1, keepdim=True)
    mat = torch.cat([tok, toks[:, :SPEC_K]], 1)
    lv, cache = M.verify_step(cfg, params, cache, mat, impl="kernel")
    same_v = torch.equal(lv, pc.verify(params, mat))
    log(f"  seeded paged decode (tables non-contiguous: {not contiguous}) vs "
        f"contiguous decode_step through kernel 1: bit-equal at "
        f"{sum(same)}/{steps} steps; 5-position verify (kernel 5 vs kernel 4) "
        f"bit-equal {same_v} [{card}; {cfg.n_layers} layers]")
    if contiguous or not all(same) or not same_v:
        raise AssertionError("paged decode on a seeded cache is not the "
                             "contiguous decode bit for bit")
    pc.release()


def prefix_profile(cfg, params, reqs, card):
    """Device time by class over one cold shared-prefix epoch on a fresh
    server (4 prefill rounds, 15 decode steps), and the device's idle
    share: the paged kernels' µs per call in the serve."""
    import torch

    def cold_epoch():
        srv = prefix_server(cfg, params)
        for r in reqs:
            srv.queue.submit(r.prompt, r.max_new_tokens)
        srv.serve_all()
    prof, wall_us = profiled(cold_epoch, "decode_sm90_kernel")
    by = {"paged_decode": 0.0, "mq_paged": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        one_pass(name)
        # only the paged kernels of csrc/ run in this serve: decode is
        # kernel 3, mq kernel 5
        m = csrc_kernel(name)
        if m is not None:
            cls = "paged_decode" if m[0] == "decode" else "mq_paged"
        elif any(x in name for x in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "other"
        by[cls] += us
    for cls in ("paged_decode", "mq_paged"):
        if by[cls] <= 0:
            raise AssertionError(f"prefix profile: no device time for {cls}")
    busy = sum(by.values())
    n_dec = cfg.n_layers * (PREFIX_NEW - 1)
    n_mq = cfg.n_layers * PREFIX_PROMPT // PREFIX_CHUNK
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by.items())
    log(f"  profiled cold epoch: paged decode {by['paged_decode'] / n_dec:.2f} us per "
        f"call ({n_dec} calls), paged mq {by['mq_paged'] / n_mq:.2f} us per call "
        f"({n_mq} calls); device time {parts}; busy {busy / 1e3:.2f} ms of "
        f"{wall_us / 1e3:.2f} ms wall, idle share {1 - busy / wall_us:.1%} [{card}]")
    return {"paged_decode_attention": by["paged_decode"] / n_dec,
            "mq_paged_decode_attention": by["mq_paged"] / n_mq}


def prefix_phase(cfg, params, card):
    """The paged KV path with the radix prefix cache through LimeServer ->
    ContinuousBatchingScheduler -> EngineBackend on phase 2's 8 layers:
    two shared-prefix epochs (cold, then warm: each request matches the
    template's 6 pages, 384 tokens) and one unequal-length epoch."""
    import numpy as np
    import torch
    from repro_torch.serving import summarize
    log(f"phase 2b: paged KV + radix prefix cache, {cfg.name} full width, "
        f"{cfg.n_layers} layers: page {PAGE}, prefill rounds of {PREFIX_CHUNK}, "
        f"prompt {PREFIX_PROMPT} (template {PREFIX_LEN}), {PREFIX_NEW} new tokens")
    # warm-up (allocator, cuBLAS heuristics at these shapes), not measured
    warm_srv = prefix_server(cfg, params)
    for r in prefix_requests(cfg)[:4]:
        warm_srv.queue.submit(r.prompt, 2)
    warm_srv.serve_all()
    del warm_srv
    torch.cuda.synchronize()

    reqs = prefix_requests(cfg)
    srv = prefix_server(cfg, params)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    done, stats, epochs = drive_prefix(srv, reqs, cfg.n_layers)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    be = srv.make_backend()
    pc = be._paged_cache
    st = be.prefix_stats
    want_saved = 4 * PREFIX_LEN
    for i, ep in enumerate(epochs):
        pre = [r.first_token_s - r.admitted_s for r in ep["reqs"]]
        ttft = [r.ttft_s for r in ep["reqs"]]
        log(f"  epoch {i + 1} ({'equal' if ep['equal'] else 'unequal'} lengths): "
            f"{len(ep['reqs'])} requests, {ep['saved']} prompt tokens from the "
            f"cache, {ep['rounds']} prefill rounds; TTFT p50 "
            f"{statistics.median(ttft) * 1e3:.1f} ms (all arrived at 0), of it "
            f"prefill {statistics.median(pre) * 1e3:.1f} ms; {ep['decode_steps']} "
            f"decode steps; {ep['uploads']} block-table uploads [{card}]")
    log(f"  launches {launches}; prefix_stats {st}")
    log(f"  pool: {pc.pool.alloc.n_pages} pages of {PAGE} slots, {pc.pool_bytes / 1e9:.3f} "
        f"GB of K/V ({cfg.n_layers} layers), {pc.pool.alloc.used_pages} pages in use at "
        f"the end ({st['prefix_pages']} held by the radix tree); peak HBM "
        f"{peak / 1e9:.2f} GB [{card}]")
    if [ep["equal"] for ep in epochs] != [True, True, False] \
            or [ep["saved"] for ep in epochs] != [0, want_saved, 0]:
        raise AssertionError(f"epochs {[(e['equal'], e['saved']) for e in epochs]}")
    if st["prefill_tokens_saved"] != want_saved or st["prefix_hits"] != 4:
        raise AssertionError(f"prefix stats {st}: expected 4 hits saving {want_saved}")
    rep = summarize(done, pattern="shared_prefix", backend="paged-prefix", stats=stats)
    if rep.prefill_tokens_saved != want_saved:
        raise AssertionError("the report misses the saved prefill tokens")
    cold_ttft = statistics.median(r.first_token_s - r.admitted_s for r in epochs[0]["reqs"])
    warm_ttft = statistics.median(r.first_token_s - r.admitted_s for r in epochs[1]["reqs"])
    log(f"  prefill of an epoch: cold {cold_ttft * 1e3:.1f} ms, warm {warm_ttft * 1e3:.1f} "
        f"ms ({cold_ttft / warm_ttft:.2f}x); report prefix_hit_rate "
        f"{rep.prefix_hit_rate:.3f}, prefill_tokens_saved {rep.prefill_tokens_saved} [{card}]")

    # warm against cold: the epoch-2 prompts on a fresh cache
    by_rid = {r.rid: r for r in done}
    warm_reqs = [by_rid[i] for i in range(4, 8)]
    cold_srv = prefix_server(cfg, params)
    for r in warm_reqs:
        cold_srv.queue.submit(r.prompt, r.max_new_tokens)
    cold = sorted(cold_srv.serve_all(), key=lambda r: r.rid)
    feed = np.array([r.output for r in cold])
    lc, lw = prefix_forced_logits(cfg, params, [by_rid[i].prompt for i in range(4)],
                                  [r.prompt for r in warm_reqs], feed)
    if not (lc.argmax(-1).T.cpu().numpy() == feed).all():
        raise AssertionError("the forced cold run does not reproduce the cold serve")
    err = (lw - lc).abs().amax(-1)                        # (T, 4)
    n_same = 0
    for j, r in enumerate(warm_reqs):
        a, b = r.output, cold[j].output
        if a == b:
            n_same += 1
            continue
        t = next(t for t in range(len(a)) if a[t] != b[t])
        gap = (lc[t, j, b[t]] - lc[t, j, a[t]]).item()
        log(f"  warm req {r.rid}: diverges from cold at {t}: gap {gap:.4f}, err "
            f"{err[t, j].item():.4f}")
        if gap > err[t, j].item():
            raise AssertionError(f"warm req {r.rid} diverges outside a near tie")
    log(f"  warm vs cold: {n_same}/4 requests token-identical; max |warm - cold| "
        f"logit {err.max().item():.4g} over {feed.shape[1]} positions [{card}]")
    seeded_bitwise(cfg, params, [by_rid[i].prompt for i in range(4)], card)
    us = prefix_profile(cfg, params, reqs[:4], card)
    return launches, us

# ----------------------------------------------------------------------------
# phase 2c: speculative decoding on the single-device path, 8 layers
# ----------------------------------------------------------------------------
# phase 2's bursty batch served eight ways, each SpecConfig(k=SPEC_K): (label,
# SpecConfig fields, paged, radix prefix cache, sampled, short prompts). The
# resident draft over all 8 layers runs the target's own layers: the accept
# path (rounds that commit more than one token). Its own cache holds 512
# slots, as the JAX package sizes it, so past a 512-token prompt it drops
# the oldest positions, and the four slots commit in lockstep: at 8 layers
# on random weights both cut its acceptance (the CPU, where its arithmetic
# is the target's, reads 1.0 with a 128-token prompt and 0.29 with 512).
# So the batch's prompts cut to SPEC_SHORT_PROMPT tokens, where the ring
# never wraps, go through that draft once more, dense, paged and paged
# with the prefix cache: there rounds must commit k + 1 (SPEC_SHORT_ACCEPT).
SPEC_SHORT_PROMPT = 128
SPEC_SHORT_ACCEPT = 0.5
# the model draft's logits, kernel path against impl "ref" on its serve's
# inputs (model_draft_check): each launch there reads within 0.0078 of its
# plain version, but on random weights the draft's attention is one-hot
# (scores of std ~134), so a rounding that moves the top slot moves a
# position's logits: up to 0.056 of |logit| max (4 of 128 positions above
# 0.02 on the H100), over LOGIT_REL_TOL's 0.05; planted prefill faults
# read 1.7
DRAFT_LOGIT_REL_TOL = 0.10
_WHOLE = dict(draft="resident", resident_layers=N_LAYERS, adapt_k=False)
SPEC_SERVES = (
    ("dense, n-gram draft", dict(draft="ngram"), False, False, False, False),
    ("dense, resident draft over all 8 layers", _WHOLE, False, False, False, False),
    ("paged, n-gram draft", dict(draft="ngram"), True, False, False, False),
    ("paged + prefix cache, gemma3-1b model draft",
     dict(draft="model", draft_arch="gemma3-1b"), True, True, False, False),
    ("dense, n-gram draft, temperature 0.8 / top-p 0.95", dict(draft="ngram", seed=7),
     False, False, True, False),
    (f"dense, resident draft over all 8 layers, prompt {SPEC_SHORT_PROMPT}", _WHOLE,
     False, False, False, True),
    (f"paged, resident draft over all 8 layers, prompt {SPEC_SHORT_PROMPT}", _WHOLE,
     True, False, False, True),
    (f"paged + prefix cache, resident draft over all 8 layers, prompt {SPEC_SHORT_PROMPT}",
     _WHOLE, True, True, False, True),
)
SPEC_SAMPLER = dict(temperature=0.8, top_p=0.95, seed=7)


def spec_backend(cfg, params, fields, paged, prefix, sampled):
    """The backend of one phase-2c serve: LimeServer's (dense, or paged with
    the radix prefix cache: page 64, prefill rounds of 128), or for the
    paged path without the cache EngineBackend(paged=True) itself, as the
    JAX package's server exposes it."""
    from repro_torch.serving import EngineBackend, LimeServer, SamplerConfig
    from repro_torch.specdec import SpecConfig
    spec = SpecConfig(k=SPEC_K, **fields)
    sampler = SamplerConfig(**SPEC_SAMPLER) if sampled else SamplerConfig()
    if paged and not prefix:
        return EngineBackend(cfg, params, n_slots=4, max_len=MAX_LEN, sampler=sampler,
                             spec=spec, paged=True, page_size=PAGE)
    return LimeServer(cfg, params, max_len=MAX_LEN, pattern="bursty", sampler=sampler,
                      spec=spec, prefix_cache=prefix,
                      prefill_chunk_tokens=PREFIX_CHUNK if prefix else 0,
                      page_size=PAGE).make_backend()


def draft_depth(fields):
    """Layers of the draft's own model decode per drafted or observed
    token (0: the n-gram draft runs none)."""
    from repro_torch.configs import get_smoke_config
    if fields["draft"] == "model":
        return get_smoke_config(fields["draft_arch"]).n_layers
    if fields["draft"] == "resident":
        return fields["resident_layers"]
    return 0


def drive_spec(be, prompts, cfg, draft_layers, prefix, max_new=MAX_NEW):
    """Serve the bursty batch `prompts` (all at t = 0) through `be` one
    scheduler step at a time. Each step launches exactly what it implies:
    the prefill n_layers flash kernels (dense, and paged: the dense prefill
    scattered into pages) or, with the prefix cache, n_layers paged
    multi-query kernels per 128-position round, plus a model or resident
    draft's own prefill per request (draft_layers flash at batch 1); a
    speculative round of k drafts committing c tokens n_layers verify-body
    launches of kernel 4 (dense) or 5 (paged) and draft_layers decode
    launches per live request per drafted and per observed token; every
    launch of kernels 1 and 2 on the Hopper bodies. Returns (requests,
    scheduler stats, the serve's launches)."""
    import torch
    from repro_torch.serving import ContinuousBatchingScheduler, Request, SchedulerConfig
    n = cfg.n_layers
    sched = ContinuousBatchingScheduler(be, SchedulerConfig())
    reqs = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    sched.begin(reqs)
    zero_counts()
    prefills = 0
    while True:
        n_rounds = len(be.rounds)
        live = sum(r.admitted_s is not None and not r.done for r in reqs)
        c0 = read_counts()
        if not sched.step():
            break
        torch.cuda.synchronize()
        got = {k: v - c0[k] for k, v in read_counts().items()}
        want = dict.fromkeys(got, 0)
        if len(be.rounds) > n_rounds:
            k, c = be.rounds[-1]
            if k:
                key = "mq_paged_decode_attention" if be.paged else "mq_decode_attention"
                want[key] = want[key + "@verify"] = n
                want["decode_attention"] = draft_layers * live * (k + c)
            else:                                      # a plain step
                key = "paged_decode_attention" if be.paged else "decode_attention"
                want[key] = want[key + "@hopper"] = n
                want["decode_attention"] += draft_layers * live
        elif any(got.values()):                        # the prefill
            prefills += 1
            if prefix:
                rounds = n * math.ceil(len(prompts[0]) / PREFIX_CHUNK)
                want["mq_paged_decode_attention"] = rounds
                want["mq_paged_decode_attention@prefill"] = rounds
            else:
                want["flash_attention"] = n
            want["flash_attention"] += draft_layers * len(reqs)
        want["flash_attention@hopper"] = want["flash_attention"]
        want["decode_attention@hopper"] = want["decode_attention"]
        if got != want:
            raise AssertionError(f"spec serve round {len(be.rounds)}: launches "
                                 f"{ {k: v for k, v in got.items() if v} }, expected "
                                 f"{ {k: v for k, v in want.items() if v} }")
    done = sorted(sched.finish_run(), key=lambda r: r.rid)
    if prefills != 1:
        raise AssertionError(f"spec serve: {prefills} prefill steps")
    for r in done:
        if len(r.output) != max_new or r.generated != max_new:
            raise AssertionError(f"spec serve req {r.rid}: {len(r.output)} tokens, "
                                 f"expected {max_new}")
    return done, sched.stats, read_counts()


def spec_references(cfg, params, prompts, feed, chunked):
    """Logits (T, 4, V) fp32 of phase 2's bursty batch fed `feed` (4, T)
    by two paths: the decode path (phase 2's: the flash prefill, decode
    steps through kernel 1; forced_logits) and the multi-query path (the
    serve's own prefill: flash, or with `chunked` the prompt in
    128-position rounds through kernel 4 as the prefix serve prefills
    through kernel 5; then position t + 1 as row 0 of a (SPEC_K + 1)-wide
    verify pass over feed[t:], rolled back after each: the verify body at
    the serve's width)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.backend import EngineBackend
    V = cfg.vocab_size
    ld = forced_logits(cfg, params, prompts, feed, 4, "kernel")
    toks = torch.from_numpy(EngineBackend._pad_prompts(prompts)).long().cuda()
    cache = M.init_cache(cfg, 4, MAX_LEN)
    if chunked:
        for off in range(0, toks.shape[1], PREFIX_CHUNK):
            lg, cache = M.verify_step(cfg, params, cache,
                                      toks[:, off:off + PREFIX_CHUNK], impl="kernel")
    else:
        lg, cache = M.prefill(cfg, params, toks, cache, impl="kernel")
    lv = [lg[:, -1, :V].float()]
    P = cache["pos"]
    f = torch.from_numpy(feed).long().cuda()
    W = SPEC_K + 1
    f = torch.cat([f, f[:, -1:].repeat(1, W)], 1)     # windows past the end
    for t in range(feed.shape[1] - 1):
        lg, cache = M.verify_step(cfg, params, cache, f[:, t:t + W], impl="kernel")
        cache["pos"] = P + t + 1
        lv.append(lg[:, 0, :V].float())
    return ld, torch.stack(lv)


def spec_greedy_check(cfg, params, prompts, done, base, label, refs, chunked=False):
    """A greedy speculative serve of phase 2's bursty batch against phase
    2's non-speculative kernel serve `base`: both paths are fed the served
    tokens (spec_references, cached in `refs` by tokens; `chunked`: the
    serve prefilled in multi-query rounds). At every position
    the multi-query path's pick must be the decode path's or a near tie
    (argmax_or_tie, the position's error between the two paths), and the
    served token the multi-query path's pick (the arithmetic that scored
    it, a row of a verify pass of the serve's width) or else a near tie of
    the decode path's pick (the decode path's gap between the two within
    that error), so a divergence from phase 2's tokens is a near tie.
    Returns (positions, near ties, served tokens other than the
    multi-query path's pick, first divergence from phase 2 per request
    (None where `base` is None: prompts phase 2 did not serve),
    worst err / |logit|)."""
    import numpy as np
    import torch
    feed = np.array([r.output for r in done], np.int64)
    key = (feed.tobytes(), len(prompts[0]), chunked)
    if key not in refs:
        refs[key] = spec_references(cfg, params, prompts, feed, chunked)
    ld, lv = refs[key]
    err = (ld - lv).abs().amax(-1)                            # (T, 4)
    argmax_or_tie(f"{label}: multi-query vs decode path", lv.flatten(0, 1),
                  ld.flatten(0, 1), err.flatten())
    fd = torch.from_numpy(feed.T.copy()).cuda()               # (T, 4)
    pick = ld.argmax(-1)
    gap = (ld.gather(-1, pick[..., None]) - ld.gather(-1, fd[..., None]))[..., 0]
    mq_pick = lv.gather(-1, fd[..., None])[..., 0] == lv.amax(-1)
    bad = ~mq_pick & (fd != pick) & (gap > err)
    if bad.any():
        t, j = (int(x) for x in bad.nonzero()[0])
        raise AssertionError(f"{label}: req {j} token {t} is not the decode path's pick "
                             f"outside a near tie (gap {gap[t, j].item():.4f}, err "
                             f"{err[t, j].item():.4f})")
    first = None if base is None else [
        next((t for t, (a, b) in enumerate(zip(r.output, b_.output)) if a != b), MAX_NEW)
        for r, b_ in zip(done, base)]
    rel = (err / ld.abs().amax(-1)).max().item()
    return feed.size, int((fd != pick).sum()), int((~mq_pick).sum()), first, rel


def draft_logits(d, prompt, feed, impl, after_prefill=None):
    """Logits (T, V) fp32 of the model draft `d` (a SmallModelDraft) of one
    request as it runs them: batch 1, its own cache of d.max_len slots
    (512, JAX's size: a 512-token prompt fills it, so every later step
    overwrites the oldest slot), the prompt's prefill, then T - 1 decode
    steps fed `feed` (T,) as observe() feeds the committed tokens.
    after_prefill, where given, edits the prefilled cache (a planted
    fault)."""
    import torch

    from repro_torch.models import model as M
    V = d.cfg.vocab_size
    cache = M.init_cache(d.cfg, 1, d.max_len)
    lg, cache = M.prefill(d.cfg, d.params, torch.as_tensor(prompt).long().cuda()[None],
                          cache, impl=impl)
    if after_prefill is not None:
        after_prefill(cache)
    out = [lg[0, -1, :V].float()]
    for t in feed[:-1]:
        lg, cache = M.decode_step(d.cfg, d.params, cache,
                                  torch.tensor([[int(t)]]).long().cuda(), impl=impl)
        out.append(lg[0, -1, :V].float())
    return torch.stack(out)


def model_draft_check(cfg, prompts, done, label, card):
    """The gemma3-1b model draft of a phase-2c serve (built as its provider
    builds it: H 4, KV 1, dh 64, windows 128; kernels 2 and 1 at batch 1)
    on its serve's inputs: each request's prompt and served tokens through
    draft_logits. Every launch of kernels 2 and 1 there is held to its
    plain version on the same inputs within BF16_REL, and a planted
    off-by-one of each (the plain version without the diagonal, or
    reading V one slot off) must read above it. (Dropping the current
    slot reads 0 here: on random weights the draft's attention is one-hot,
    scores of std ~134, and the top slot is an older one.) The logits against
    impl "ref" must stay within DRAFT_LOGIT_REL_TOL of |logit| max, the
    greedy picks equal or near ties, and planted prefill faults on the
    kernel path must read above that limit."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.specdec import SpecConfig
    from repro_torch.specdec.draft import make_draft_provider
    d = make_draft_provider(SpecConfig(k=SPEC_K, draft="model", draft_arch="gemma3-1b"),
                            cfg, device="cuda")
    feeds = [np.asarray(r.output) for r in done]
    calls = {"flash_attention": [], "decode_attention": []}      # rel errs
    faults = {}
    dec, fl = da.decode_attention, fa.flash_attention

    def dec_checked(q, k, v, ids, pos, window=None):
        out = dec(q, k, v, ids, pos, window=window)
        ref = da.decode_attention_plain(q, k, v, ids, pos, window=window)
        calls["decode_attention"].append(rel_err(out, ref))
        faults.setdefault("decode_attention: V read one slot off", rel_err(
            da.decode_attention_plain(q, k, v.roll(1, 1), ids, pos, window=window), ref))
        return out

    def fl_checked(q, k, v, **kw):
        out = fl(q, k, v, **kw)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        calls["flash_attention"].append(rel_err(out, ref))
        faults.setdefault("flash_attention: diagonal dropped", rel_err(
            fa.flash_attention_plain(q, k, v, **{**kw, "q_offset": -1}), ref))
        return out
    da.decode_attention, fa.flash_attention = dec_checked, fl_checked
    try:
        lk = torch.stack([draft_logits(d, p, f, "kernel")
                          for p, f in zip(prompts, feeds)], 1)              # (T, 4, V)
    finally:
        da.decode_attention, fa.flash_attention = dec, fl
    T, L = lk.shape[0], d.cfg.n_layers
    want = {"flash_attention": 4 * L, "decode_attention": 4 * L * (T - 1)}
    if {k: len(v) for k, v in calls.items()} != want:
        raise AssertionError(f"{label}: draft launches {({k: len(v) for k, v in calls.items()})}"
                             f", expected {want}")
    worst = {k: max(v) for k, v in calls.items()}
    lr = torch.stack([draft_logits(d, p, f, "ref") for p, f in zip(prompts, feeds)], 1)
    scale = lr.abs().amax(-1)
    err = (lk - lr).abs().amax(-1)
    rel = (err / scale).max().item()
    ties = argmax_or_tie(f"{label}: draft kernel vs ref", lk.flatten(0, 1),
                         lr.flatten(0, 1), err.flatten())
    planted = []
    for name, edit, _ in planted_faults(d.cfg):
        lf = torch.stack([draft_logits(d, p, f, "kernel", after_prefill=edit)
                          for p, f in zip(prompts, feeds)], 1)
        planted.append((name, ((lf - lr).abs().amax(-1) / scale).max().item()))
    log(f"  {label}: the draft ({d.cfg.name} smoke: H {d.cfg.n_heads}, KV "
        f"{d.cfg.n_kv_heads}, dh {d.cfg.head_dim}, windows {d.cfg.window_size}, batch 1, "
        f"cache {d.max_len}) on its serve's inputs: each launch against its plain "
        f"version, worst rel_err { {k: round(v, 5) for k, v in worst.items()} } over "
        f"{ {k: len(v) for k, v in calls.items()} } launches (tol {BF16_REL:.4g}), "
        f"planted off-by-ones { {k: round(v, 4) for k, v in faults.items()} }; logits "
        f"against impl 'ref' over {T} positions x 4 requests: worst err {rel:.4f} of "
        f"|logit| max (limit {DRAFT_LOGIT_REL_TOL}), {ties} near-tie picks, planted "
        f"prefill faults {[(n, round(e, 4)) for n, e in planted]} [{card}]")
    for k, v in worst.items():
        if not v <= BF16_REL:
            raise AssertionError(f"{label}: a draft launch of {k} is {v:.4g} from its plain "
                                 f"version (tol {BF16_REL:.4g})")
    for k, v in faults.items():
        if not v > BF16_REL:
            raise AssertionError(f"{label}: the per-launch check passes a planted fault "
                                 f"({k}: {v:.4g})")
    if not rel <= DRAFT_LOGIT_REL_TOL:
        raise AssertionError(f"{label}: the draft's kernel path is {rel:.4f} of |logit| "
                             f"max from its plain version (limit {DRAFT_LOGIT_REL_TOL})")
    for name, e in planted:
        if not e > DRAFT_LOGIT_REL_TOL:
            raise AssertionError(f"{label}: the draft check passes a planted fault "
                                 f"({name}: {e:.4f})")


def planted_commit_fault():
    """A planted fault of the acceptance walk: where a draft is corrected,
    commit one token more (the next row's pick, which was scored after the
    rejected draft token). Returns the restore function."""
    from repro_torch.specdec import SpecDecodeController
    orig = SpecDecodeController.verify

    def verify(self, logits, draft, draft_probs=None):
        out = orig(self, logits, draft, draft_probs)
        i = len(out) - 1
        if i < len(draft) and out[i] != int(draft[i]):
            out.append(int(logits[i + 1, :self.cfg.vocab_size].argmax()))
        return out
    SpecDecodeController.verify = verify
    return lambda: setattr(SpecDecodeController, "verify", orig)


def spec_profile(make, prompts, card, label):
    """Device time of the verify body over one profiled serve (a fresh
    backend from `make`): its µs per call and the device's idle share."""
    import torch
    from repro_torch.serving import ContinuousBatchingScheduler, Request, SchedulerConfig

    def run():
        be = make()
        ContinuousBatchingScheduler(be, SchedulerConfig()).serve(
            [Request(i, p, MAX_NEW) for i, p in enumerate(prompts)])
    prof, wall_us = profiled(run, "verify_sm90_kernel")
    us = busy = 0.0
    calls = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        one_pass(e.key.lower())
        busy += t
        if "verify_sm90_kernel" in e.key:
            us += t
            calls += e.count
    if not calls:
        raise AssertionError(f"{label}: the profiler shows no verify-body launch")
    log(f"  profiled serve ({label}): verify body {us / calls:.2f} us per call ({calls} "
        f"calls); busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall, idle share "
        f"{1 - busy / wall_us:.1%} [{card}; {N_LAYERS} layers]")


def spec_phase(cfg, params, card, base):
    """Phase 2c: phase 2's bursty batch (`base`: prompts and phase 2's
    kernel serve) through the single-device path's speculation, the eight
    SPEC_SERVES on phase 2's weights; each step's launches exact
    (drive_spec), greedy tokens held to phase 2's picks (spec_greedy_check),
    the model draft held to its plain version (model_draft_check), the
    resident draft over the whole stack accepting drafts and committing
    more than one token in a round, and on the short prompts acceptance
    above SPEC_SHORT_ACCEPT with rounds committing k + 1, a planted commit
    fault rejected, the sampled serve's counts exact; a profiled paged
    serve gives kernel 5's verify µs per call. Returns the serves'
    launches."""
    import numpy as np
    import torch
    from repro_torch.serving import summarize
    prompts, base_done = base
    log(f"phase 2c: speculative decoding on the single-device path, {cfg.name} full "
        f"width, {cfg.n_layers} layers: phase 2's bursty batch (4 x prompt {PROMPT_LEN}, "
        f"{MAX_NEW} new tokens), k = {SPEC_K}")
    # warm-up (cuBLAS at the verify width, the allocator), not measured
    warm = spec_backend(cfg, params, dict(draft="ngram"), False, False, False)
    drive_spec(warm, prompts, cfg, 0, False, max_new=3)
    del warm
    launches = dict.fromkeys(kernel_counters(), 0)
    refs = {}
    for label, fields, paged, prefix, sampled, short in SPEC_SERVES:
        ps = [p[:SPEC_SHORT_PROMPT] for p in prompts] if short else prompts
        be = spec_backend(cfg, params, fields, paged, prefix, sampled)
        t0 = time.monotonic()
        done, stats, got = drive_spec(be, ps, cfg, draft_depth(fields), prefix)
        wall = time.monotonic() - t0
        for k, v in got.items():
            launches[k] += v
        rep = summarize(done, pattern="bursty", backend="spec", stats=stats)
        ks = [(k, c) for k, c in be.rounds if k]
        full = sum(c == k + 1 for k, c in ks)
        log(f"  {label}: TTFT p50 {rep.ttft_p50_s * 1e3:.1f} ms; decode "
            f"{1e3 / rep.decode_tok_s_p50:.2f} ms/token per request (p50); acceptance "
            f"{rep.spec_acceptance_rate:.3f} ({rep.spec_accepted}/{rep.spec_drafted} "
            f"drafts); {len(be.rounds)} rounds, committed per round mean "
            f"{np.mean([c for _, c in ks]):.2f}, {full} committing k + 1; launches "
            f"{ {k: v for k, v in got.items() if v} }; {wall:.1f} s wall [{card}; "
            f"{cfg.n_layers} layers]")
        if not ks:
            raise AssertionError(f"{label}: no speculative round")
        if sampled:
            if not all(0 <= t < cfg.vocab_size for r in done for t in r.output):
                raise AssertionError(f"{label}: a token outside the vocabulary")
            continue
        n_pos, n_tie, n_off, first, rel = spec_greedy_check(
            cfg, params, ps, done, None if short else base_done, label, refs,
            chunked=prefix)
        log(f"    {n_pos} positions: every served token the decode path's pick on its "
            f"prefix or a near tie ({n_tie} near ties; {n_off} not the multi-query path's "
            f"own pick); first divergence from phase 2's tokens by request {first}; "
            f"decode vs multi-query path worst logit err {rel:.4f} of |logit| max")
        if fields["draft"] == "model":
            model_draft_check(cfg, ps, done, label, card)
        if fields["draft"] == "resident" and not (
                rep.spec_accepted > 0 and max(c for _, c in ks) > 1):
            raise AssertionError(f"{label}: the whole-stack draft accepted "
                                 f"{rep.spec_accepted} drafts, no round committed more "
                                 "than one token")
        if short and not (rep.spec_acceptance_rate > SPEC_SHORT_ACCEPT and full > 0):
            raise AssertionError(f"{label}: acceptance {rep.spec_acceptance_rate:.3f} "
                                 f"(limit {SPEC_SHORT_ACCEPT}), {full} rounds committing "
                                 "k + 1, where the draft's ring does not wrap")
    # a planted fault: one token committed past each correction
    restore = planted_commit_fault()
    try:
        be = spec_backend(cfg, params, dict(draft="ngram"), False, False, False)
        done, _, _ = drive_spec(be, prompts, cfg, 0, False)
    finally:
        restore()
    try:
        spec_greedy_check(cfg, params, prompts, done, base_done, "planted fault", refs)
    except AssertionError as e:
        log(f"  planted fault (a token committed past each correction) rejected: {e}")
    else:
        raise AssertionError("the greedy check passes a commit past a correction")
    spec_profile(lambda: spec_backend(cfg, params, dict(draft="ngram"), True, False, False),
                 prompts, card, "paged, n-gram draft: kernel 5")
    log(f"  launches {launches}")
    return launches


# ----------------------------------------------------------------------------
# phase 2d: captured steps (CUDA graphs) against eager ones, 8 layers
# ----------------------------------------------------------------------------
# phase 2d's serves are short: on a slow host its fourteen serves, their
# warm-ups and profiles took 100 s at 32 / 16 / 6 tokens
CAPTURE_NEW = 16          # tokens per request in 2d's plain serves
CAPTURE_SPEC_NEW = 8      # ... in its speculative serves
CAPTURE_PROFILE_NEW = 4   # ... in the profiled serves (idle share)
CAPTURE_SERVES = (
    # label, EngineBackend keywords, pattern, requests, tokens a request
    ("dense", {}, "bursty", 4, CAPTURE_NEW),
    ("dense", {}, "sporadic", 2, CAPTURE_NEW),
    ("paged", dict(paged=True, page_size=PAGE), "bursty", 4, CAPTURE_NEW),
    ("paged + prefix cache", dict(prefix_cache=True, page_size=PAGE,
                                  prefill_chunk_tokens=PREFIX_CHUNK),
     "bursty", 4, CAPTURE_NEW),
    ("spec, n-gram draft", dict(spec=dict(draft="ngram")), "bursty", 4,
     CAPTURE_SPEC_NEW),
    ("spec, paged + prefix cache, gemma3-1b model draft",
     dict(spec=dict(draft="model", draft_arch="gemma3-1b"), prefix_cache=True,
          page_size=PAGE, prefill_chunk_tokens=PREFIX_CHUNK), "bursty", 4,
     CAPTURE_SPEC_NEW),
    ("spec, resident draft over all 8 layers", dict(spec=_WHOLE), "bursty", 4,
     CAPTURE_SPEC_NEW),
)


@contextlib.contextmanager
def recorded_logits(rec):
    """Every step's logits appended to rec (a copy): M.decode_step and
    M.verify_step (the target's and the drafts' steps), the paged cache's
    step and verify (its prefill rounds too)."""
    from repro_torch.kvcache.paged_decode import PagedDecodeCache
    from repro_torch.models import model as M

    def wrap(fn, pick):
        def f(*a, **kw):
            out = fn(*a, **kw)
            rec.append(pick(out).clone())
            return out
        return f
    with _patched(M, "decode_step", wrap(M.decode_step, lambda o: o[0])), \
            _patched(M, "verify_step", wrap(M.verify_step, lambda o: o[0])), \
            _patched(PagedDecodeCache, "step", wrap(PagedDecodeCache.step,
                                                    lambda o: o)), \
            _patched(PagedDecodeCache, "verify", wrap(PagedDecodeCache.verify,
                                                      lambda o: o)):
        yield rec


def serve_on(be, prompts, pattern, max_new):
    """The requests through the scheduler on backend `be` (arrivals as the
    launcher's pattern places them); returns them by rid."""
    from repro_torch.serving import (ContinuousBatchingScheduler, Request,
                                     SchedulerConfig, cli_arrivals)
    base = be.now()
    arrivals = cli_arrivals(pattern, len(prompts), prompt_len=len(prompts[0]),
                            max_new_tokens=max_new, burst_size=be.n_slots)
    reqs = [Request(i, p, max_new, arrival_s=base + ev.time_s)
            for i, (ev, p) in enumerate(zip(arrivals, prompts))]
    done = ContinuousBatchingScheduler(be, SchedulerConfig()).serve(reqs)
    return sorted(done, key=lambda r: r.rid)


def idle_share(fn):
    """(busy ms, wall ms, device kernels seen) of fn() under the profiler:
    the device's own time of every kernel and copy it ran, against the
    wall time."""
    import torch
    prof, wall_us = profiled(fn, "repro")
    busy = n = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        busy += e.self_cuda_time_total if us is None else us
        n += e.count
    return busy / 1e3, wall_us / 1e3, n


def capture_phase(cfg, params, card, base):
    """Phase 2d: the single-device serves of phases 2, 2b and 2c on phase
    2's weights and prompts, each eagerly (EngineBackend(capture=False))
    and captured (the default: every prefill, decode and verify step, and
    the drafts' steps and prefills, a replayed CUDA graph). Each backend
    serves a short
    warm-up first (on the captured one it captures the graphs), then the
    measured serve: every step's logits bit-equal between the two, tokens
    identical, the launch counters equal (replays counted); then a
    profiled serve for the device's idle share. Printed per serve: TTFT
    and ms/token p50, idle share, eager against captured; graphs, capture
    seconds, graph-pool bytes. Then the 8-layer model's prefill and decode
    step captured against eager (prefilled_pair). Returns the captured
    serves' launches and the warm captured backend of the dense bursty
    serve (phase 2e serves on it)."""
    import torch
    from repro_torch.serving import EngineBackend, summarize
    from repro_torch.specdec import SpecConfig
    prompts = base[0]
    log(f"phase 2d: captured steps (CUDA graphs) against eager ones, {cfg.name}, "
        f"{cfg.n_layers} layers, phase 2's prompts ({PROMPT_LEN} tokens)")
    launches = dict.fromkeys(kernel_counters(), 0)
    warm = None
    for label, kw, pattern, n_req, max_new in CAPTURE_SERVES:
        kw = dict(kw)
        if "spec" in kw:
            kw["spec"] = SpecConfig(k=SPEC_K, **kw["spec"])
        ps = prompts[:n_req]
        runs = {}
        for capture in (False, True):
            be = EngineBackend(cfg, params, n_slots=4 if pattern == "bursty" else 1,
                               max_len=MAX_LEN, capture=capture, **kw)
            # warm-up: the first serve captures the graphs, and a capture
            # empties the allocator's cache, which the second fills again
            serve_on(be, ps, pattern, 4)
            serve_on(be, ps, pattern, 2)
            rec = []
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.monotonic()
            with recorded_logits(rec):
                done = serve_on(be, ps, pattern, max_new)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            got = read_counts()
            rep = summarize(done, pattern=pattern, backend="single-device")
            busy, pwall, n_dev = idle_share(
                lambda: serve_on(be, ps, pattern, CAPTURE_PROFILE_NEW))
            runs[capture] = dict(rec=rec, out=[r.output for r in done], got=got,
                                 rep=rep, wall=wall, idle=1 - busy / pwall,
                                 busy=busy, pwall=pwall, n_dev=n_dev,
                                 graphs=be.graph_stats)
            if capture and warm is None and not kw and pattern == "bursty":
                warm = be
        e, c = runs[False], runs[True]
        diff = [i for i, (a, b) in enumerate(zip(e["rec"], c["rec"]))
                if not torch.equal(a, b)]
        g = c["graphs"]
        log(f"  {label}, {pattern} ({n_req} x {max_new} tokens): {len(c['rec'])} step "
            f"logits, {len(diff)} not bit-equal; tokens "
            f"{'identical' if e['out'] == c['out'] else 'DIFFERENT'}; launches "
            f"{'equal' if e['got'] == c['got'] else 'DIFFERENT'} "
            f"({ {k: v for k, v in c['got'].items() if v} }); TTFT p50 "
            f"{e['rep'].ttft_p50_s * 1e3:.2f} eager / {c['rep'].ttft_p50_s * 1e3:.2f} "
            f"captured ms; decode {1e3 / e['rep'].decode_tok_s_p50:.3f} / "
            f"{1e3 / c['rep'].decode_tok_s_p50:.3f} ms/token (p50); serve {e['wall']:.2f} "
            f"/ {c['wall']:.2f} s; idle share {e['idle']:.1%} / {c['idle']:.1%} (device "
            f"{e['busy']:.1f} / {c['busy']:.1f} ms of {e['pwall']:.1f} / "
            f"{c['pwall']:.1f} ms wall, {e['n_dev']} / {c['n_dev']} device events, "
            f"{CAPTURE_PROFILE_NEW} tokens a request); graphs {g['graphs']} "
            f"({g['captures']} captured in {g['capture_s'] * 1e3:.0f} ms, "
            f"{g['replays']} replays), the prefills' {g['prefill_graphs']} "
            f"({g['prefill_captures']} in {g['prefill_capture_s'] * 1e3:.0f} ms, "
            f"{g['prefill_replays']} replays), the drafts' {g['draft_graphs']} "
            f"({g['draft_captures']} in {g['draft_capture_s'] * 1e3:.0f} ms, "
            f"{g['draft_replays']} replays), graph pool "
            f"{g['pool_bytes'] / 2**20:.1f} MiB [{card}; {cfg.n_layers} layers]")
        if len(e["rec"]) != len(c["rec"]) or diff:
            raise AssertionError(f"2d {label}: captured step logits differ from the "
                                 f"eager ones at {diff[:8]} ({len(e['rec'])} / "
                                 f"{len(c['rec'])} steps)")
        if e["out"] != c["out"] or e["got"] != c["got"]:
            raise AssertionError(f"2d {label}: tokens or launches differ")
        if g["replays"] <= 0 or g["prefill_replays"] <= 0 or c["n_dev"] <= 0:
            raise AssertionError(f"2d {label}: no replay ({g}) or no device event "
                                 "in the captured profile")
        for k, v in c["got"].items():
            launches[k] += v
    prefilled_pair(cfg, params, prompts, card)
    return launches, warm


# ----------------------------------------------------------------------------
# phase 2e: the flight recorder, SLO engine and dashboard on the serving path
# ----------------------------------------------------------------------------
TRACE_SERVES = 4          # untraced, traced, traced, untraced
TRACE_DASH_S = 0.05       # dashboard interval (backend clock) while traced


def trace_phase(cfg, card, base, be):
    """Phase 2e: phase 2's bursty batch (4 x PROMPT_LEN, MAX_NEW tokens a
    request) served on 2d's warm captured backend `be` four times in turns
    (untraced, traced, traced, untraced): the traced serves under a Tracer
    with an SLOEngine attached to the scheduler and a Dashboard ticking
    between its steps. Checks: every serve's tokens and launch counts are
    the first's (tracing adds no launch); the Chrome export validates; the
    JSONL export reads back as the ring holds it; each request's events
    come in the order arrive <= admit <= prefill end <= decode <= finish
    and its req.span is its latency; one engine.decode span per backend
    round and one engine.prefill; the engine.* spans sum to no more than
    the serve's wall time. Prints ms/token traced and untraced, where the
    spans leave the wall time, and the dashboard's last frame. Returns the
    first serve's launches."""
    import tempfile

    import torch
    from repro_torch.obs import (Dashboard, SLOEngine, Tracer, analyze,
                                 default_targets, export_jsonl, read_jsonl,
                                 set_tracer, to_chrome, validate_chrome)
    from repro_torch.obs import trace as tr_ev
    from repro_torch.serving import (ContinuousBatchingScheduler, Request,
                                     SchedulerConfig, cli_arrivals, summarize)
    prompts = base[0][:4]
    log(f"phase 2e: the flight recorder on the serving path, {cfg.name}, "
        f"{cfg.n_layers} layers, captured, bursty 4 x {PROMPT_LEN} prompt + "
        f"{MAX_NEW} tokens, untraced / traced / traced / untraced")
    runs = []
    for i in range(TRACE_SERVES):
        traced = i in (1, 2)
        arrivals = cli_arrivals("bursty", len(prompts), prompt_len=PROMPT_LEN,
                                max_new_tokens=MAX_NEW, burst_size=be.n_slots)
        t_base = be.now()
        reqs = [Request(j, p, MAX_NEW, arrival_s=t_base + ev.time_s)
                for j, (ev, p) in enumerate(zip(arrivals, prompts))]
        tracer = Tracer() if traced else None
        rounds0 = len(be.rounds)
        torch.cuda.synchronize()
        zero_counts()
        prev = set_tracer(tracer)
        try:
            t0 = time.monotonic()
            sched = ContinuousBatchingScheduler(be, SchedulerConfig())
            slo = dash = frame = None
            if traced:
                slo = SLOEngine(default_targets())
                sched.attach_slo(slo)
                dash = Dashboard(slo=slo, sched=sched, tracer=tracer,
                                 interval_s=TRACE_DASH_S)
            sched.begin(reqs)
            while sched.step():
                if dash is not None:
                    frame = dash.tick(sched.now()) or frame
            done = sorted(sched.finish_run(), key=lambda r: r.rid)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        finally:
            set_tracer(prev)
        rep = summarize(done, pattern="bursty", backend="single-device")
        runs.append(dict(traced=traced, out=[r.output for r in done],
                         got=read_counts(), wall=wall, rep=rep, done=done,
                         tracer=tracer, slo=slo, dash=dash, frame=frame,
                         rounds=len(be.rounds) - rounds0, sched=sched))
    first = runs[0]
    for r in runs[1:]:
        if r["out"] != first["out"]:
            raise AssertionError("2e: a traced serve's tokens differ from the "
                                 "untraced serve's")
        if r["got"] != first["got"]:
            raise AssertionError(f"2e: launches differ between serves "
                                 f"({r['got']} / {first['got']})")
    for r in runs:
        if not r["traced"]:
            continue
        tr = r["tracer"]
        evs = tr.events()
        problems = validate_chrome(to_chrome(tr))
        if problems or tr.dropped:
            raise AssertionError(f"2e: the Chrome export is invalid ({problems[:4]}) "
                                 f"or the ring dropped {tr.dropped} events")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.jsonl")
            export_jsonl(tr, path)
            header, back = read_jsonl(path)
        if header.get("schema") != "lime-trace" or \
                back != [tuple(json.loads(json.dumps(list(e)))) for e in evs]:
            raise AssertionError("2e: the JSONL export does not read back")
        for q in r["done"]:
            lane = {e[tr_ev.EVT_NAME]: e for e in evs
                    if e[tr_ev.EVT_TRACK] == tr_ev.req_track(q.rid)}
            pf = lane[tr_ev.REQ_PREFILL]
            order = [lane[tr_ev.REQ_ARRIVE][tr_ev.EVT_TS],
                     lane[tr_ev.REQ_ADMIT][tr_ev.EVT_TS],
                     pf[tr_ev.EVT_TS] + pf[tr_ev.EVT_DUR],
                     lane[tr_ev.REQ_DECODE][tr_ev.EVT_TS],
                     lane[tr_ev.REQ_FINISH][tr_ev.EVT_TS]]
            span = lane[tr_ev.REQ_SPAN][tr_ev.EVT_DUR]
            if order != sorted(order) or abs(span - q.latency_s) > 1e-9:
                raise AssertionError(f"2e: request {q.rid}'s lifecycle {order}, "
                                     f"span {span} against latency {q.latency_s}")
        spans = [e for e in evs if e[tr_ev.EVT_TRACK] == tr_ev.TRACK_PIPELINE]
        by = {}
        for e in spans:
            by.setdefault(e[tr_ev.EVT_NAME], []).append(e[tr_ev.EVT_DUR])
        busy = sum(e[tr_ev.EVT_DUR] for e in spans)
        if len(by.get(tr_ev.ENGINE_DECODE, [])) != r["rounds"] or \
                len(by.get(tr_ev.ENGINE_PREFILL, [])) != 1:
            raise AssertionError(f"2e: {len(by.get(tr_ev.ENGINE_DECODE, []))} "
                                 f"engine.decode spans for {r['rounds']} rounds, "
                                 f"{len(by.get(tr_ev.ENGINE_PREFILL, []))} prefill")
        if busy > r["wall"]:
            raise AssertionError(f"2e: the engine.* spans sum to {busy:.4f} s, "
                                 f"more than the serve's {r['wall']:.4f} s")
        r["busy"], r["by"], r["evs"] = busy, by, evs
    for i, r in enumerate(runs):
        rep = r["rep"]
        line = (f"  serve {i + 1} ({'traced' if r['traced'] else 'untraced'}): "
                f"{r['wall'] * 1e3:.1f} ms wall, {rep.ms_per_token:.3f} ms/token "
                f"(span / tokens), decode {1e3 / rep.decode_tok_s_p50:.3f} ms/token "
                f"per request (p50), TTFT p50 {rep.ttft_p50_s * 1e3:.2f} ms, "
                f"{r['rounds']} rounds")
        if r["traced"]:
            by = r["by"]
            dec = by[tr_ev.ENGINE_DECODE]
            cp = analyze(r["evs"])
            line += (f"; {r['tracer'].emitted} events; spans: engine.prefill "
                     f"{by[tr_ev.ENGINE_PREFILL][0] * 1e3:.2f} ms, engine.decode "
                     f"{len(dec)} x mean {statistics.mean(dec) * 1e3:.3f} ms (min "
                     f"{min(dec) * 1e3:.3f}, max {max(dec) * 1e3:.3f}); spans "
                     f"{r['busy'] * 1e3:.1f} of {r['wall'] * 1e3:.1f} ms wall "
                     f"({1 - r['busy'] / r['wall']:.1%} outside the steps); "
                     f"critical path rounds {len(cp.rounds)}, "
                     f"waterfalls {len(cp.requests)}")
        log(line + f" [{card}; {cfg.n_layers} layers]")
    un = [r["rep"].ms_per_token for r in runs if not r["traced"]]
    tr_ = [r["rep"].ms_per_token for r in runs if r["traced"]]
    log(f"  ms/token traced {tr_} against untraced {un} (serves 2, 3 against "
        f"1, 4) [{card}; {cfg.n_layers} layers]")
    last = runs[2]
    log("  the dashboard's last frame of serve 3 (and its render at the end):")
    for text in (last["frame"], last["dash"].render(last["sched"].now())):
        for ln in (text or "(no frame)").splitlines():
            log("    " + ln)
    snap = last["slo"].snapshot(last["sched"].now())
    log(f"  SLO health {snap['health']:.2f}, breaching {snap['breaching']}, "
        f"TTFT p99 {snap['targets']['ttft_p99']['p99']}")
    return first["got"]



# ----------------------------------------------------------------------------
# phase 2f: the fleet router over two replicas sharing phase 2's weights
# ----------------------------------------------------------------------------
FLEET_REPLICAS, FLEET_SLOTS, FLEET_NEW = 2, 4, 8
# prompt lengths by turn within a template: two epochs of 4 at 512 tokens
# (cold: the paged multi-query rounds of kernel 5 over the whole prompt,
# then warm: the 384-token template from the radix tree, one suffix round),
# then an epoch of unequal lengths (the dense flash prefill, kernel 2,
# scattered into pages); every decode step on kernel 3
FLEET_LENS = (512,) * 8 + (512, 480, 448, 416)


def fleet_requests(cfg):
    """The shared_prefix traffic of phase 2f: 24 requests of two templates
    (384 shared tokens each, PREFIX_LEN), alternating, FLEET_NEW new tokens,
    lengths FLEET_LENS per template, all arriving at t 0 of the serve."""
    from repro_torch.serving import requests_from_arrivals
    from repro_torch.serving.traffic import ArrivalEvent
    arr = [ArrivalEvent(0.0, FLEET_LENS[i // 2], FLEET_NEW, template_id=i % 2,
                        template_len=PREFIX_LEN) for i in range(2 * len(FLEET_LENS))]
    return requests_from_arrivals(arr, vocab_size=cfg.vocab_size, seed=0)


def fleet_warmup(cfg, be, seed):
    """Capture a replica's graphs before the measured serve: an epoch of 4
    equal 512-token prompts and one of FLEET_LENS' unequal lengths, random
    tokens (their donated pages match no template), 2 new tokens each."""
    import numpy as np
    from repro_torch.serving import (ContinuousBatchingScheduler, Request,
                                     SchedulerConfig)
    rng = np.random.default_rng(seed)
    lens = (512,) * 4 + FLEET_LENS[-4:]
    reqs = [Request(1000 + i, rng.integers(1, cfg.vocab_size, n).astype(np.int32), 2)
            for i, n in enumerate(lens)]
    ContinuousBatchingScheduler(be, SchedulerConfig(page_size=PAGE)).serve(reqs)


def fleet_alone_check(cfg, params, per_replica, card):
    """Every fleet request's tokens against the same prompt served alone
    (one request an epoch) on phase 2b's single-device path
    (LimeServer(prefix_cache=True, prefill_chunk_tokens=128, page_size=64)),
    left-padded with token 0 to the longest prompt of its fleet epoch as
    the backend pads it (the pads are attended, as in the reference):
    equal, or the first divergence is a near tie by compare_greedy's rule
    (both impls fed the alone serve's tokens at its batch shape; the
    reference's logit gap between the two picks within the kernel path's
    logit error there, or the kernel path's own logits of the two picks
    equal). Returns (requests equal, near ties)."""
    import numpy as np
    alone = prefix_server(cfg, params)
    n_same = n_tie = 0
    for recs in per_replica.values():
        epochs = {}
        for r in recs:                    # an epoch emits its first tokens at once
            epochs.setdefault(r.first_token_s, []).append(r)
        for batch in epochs.values():
            width = max(r.prompt_len for r in batch)
            for r in sorted(batch, key=lambda r: r.rid):
                prompt = np.pad(r.prompt, (width - r.prompt_len, 0))
                alone.queue.submit(prompt, r.max_new_tokens)
                a = alone.serve_all()[0].output
                f = r.output
                if a == f:
                    n_same += 1
                    continue
                t = next(t for t in range(len(a)) if a[t] != f[t])
                feed = np.array([a], np.int64)
                lk = forced_logits(cfg, params, [prompt], feed, FLEET_SLOTS, "kernel")
                lr = forced_logits(cfg, params, [prompt], feed, FLEET_SLOTS, "ref")
                err = (lk[t, 0] - lr[t, 0]).abs().max().item()
                gap = (lr[t, 0, a[t]] - lr[t, 0, f[t]]).item()
                kgap = (lk[t, 0, a[t]] - lk[t, 0, f[t]]).item()
                log(f"  fleet req {r.rid}: diverges from its alone serve at {t} ({f[t]} "
                    f"for {a[t]}): reference gap {gap:.4f}, kernel gap {kgap:.4f}, "
                    f"logit err {err:.4f}")
                if gap > err and kgap != 0:
                    raise AssertionError(f"fleet req {r.rid} diverges from its alone "
                                         "serve outside a near tie")
                n_tie += 1
    return n_same, n_tie


def fleet_phase(cfg, params, card):
    """Phase 2f: the launcher's fleet (launch.serve.make_fleet) on phase 2's
    weights: FLEET_REPLICAS single-device EngineBackend(engine=None)
    replicas over the same parameter tensors, each with the radix prefix
    cache (page 64, prefill rounds of 128, 4 slots), under the prefix
    router. fleet_requests' 24 requests arrive at one instant, re-based onto
    the replicas' clocks by the launcher's rebase_arrivals (1 s ahead of
    them), so each replica's first step takes in what was routed to it by
    then and the router sees the first replica's queue when the other
    template arrives. Checks: every request served once, each
    replica served epochs of both prefill routes, the router matched
    prefixes, each replica's counters show kernels 2, 3 and 5 and the
    fleet's totals are their sum (nothing of kernels 1 and 4), the second
    replica adds its KV and graphs to HBM but no weights, and every
    request's tokens are its alone serve's (fleet_alone_check). Returns the
    launches."""
    import torch
    from repro_torch.launch.serve import make_fleet, rebase_arrivals
    gc.collect()
    torch.cuda.empty_cache()
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"phase 2f: the fleet router, {FLEET_REPLICAS} replicas of {cfg.name} "
        f"({cfg.n_layers} layers) over one set of weights ({w_bytes / 1e9:.2f} GB): "
        f"prefix cache, page {PAGE}, prefill rounds of {PREFIX_CHUNK}, "
        f"{FLEET_SLOTS} slots each, prefix router; {2 * len(FLEET_LENS)} shared-prefix "
        f"requests (2 templates of {PREFIX_LEN} tokens, lengths {FLEET_LENS} a "
        f"template, {FLEET_NEW} new tokens) at one instant")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    fleet = make_fleet(cfg, params, replicas=FLEET_REPLICAS, n_slots=FLEET_SLOTS,
                       max_len=MAX_LEN, prefix_cache=True,
                       prefill_chunk_tokens=PREFIX_CHUNK, page_size=PAGE,
                       router="prefix")
    if not all(r.backend.params is params for r in fleet.replicas):
        raise AssertionError("a replica holds its own weights")
    mem = []
    for i, rep in enumerate(fleet.replicas):
        fleet_warmup(cfg, rep.backend, 7 + i)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated() - mem0)
    one, two = mem[0], mem[-1]
    log(f"  HBM beside the weights after each replica's warm-up (graphs captured): "
        f"one replica {one / 1e9:.3f} GB, two {two / 1e9:.3f} GB; HBM allocated "
        f"with one replica {(mem0 + one) / 1e9:.2f} GB, with two "
        f"{(mem0 + two) / 1e9:.2f} GB (weights {w_bytes / 1e9:.2f} GB, held once) "
        f"[{card}; {cfg.n_layers} layers]")
    if two - one > 0.1 * w_bytes:
        raise AssertionError(f"the second replica added {(two - one) / 1e9:.2f} GB")

    per = {rep.name: dict.fromkeys(kernel_counters(), 0) for rep in fleet.replicas}

    def counted(rep):
        step = rep.step

        def wrapped():
            c0 = read_counts()
            out = step()
            for k, v in read_counts().items():
                per[rep.name][k] += v - c0[k]
            return out
        rep.step = wrapped
    for rep in fleet.replicas:
        counted(rep)
    reqs = fleet_requests(cfg)
    rebase_arrivals(fleet, reqs)
    zero_counts()
    wall = time.monotonic()
    res = fleet.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - wall
    total = read_counts()

    served = sorted(r.rid for recs in res.per_replica.values() for r in recs)
    if served != [r.rid for r in reqs] or res.shed \
            or any(r.rejected or len(r.output) != FLEET_NEW for r in res.requests):
        raise AssertionError(f"served {served}, shed {[r.rid for r in res.shed]}")
    part = {n: [r.rid for r in sorted(recs, key=lambda r: r.rid)]
            for n, recs in res.per_replica.items()}
    log(f"  placement {part}; router {fleet.router.stats}; {wall:.2f} s wall")
    if not all(part.values()):
        raise AssertionError("a replica served nothing")
    if fleet.router.stats["prefix_matched"] <= 0:
        raise AssertionError("the prefix router matched no prefix")
    for k in total:
        if sum(p[k] for p in per.values()) != total[k]:
            raise AssertionError(f"{k}: the replicas' launches {[p[k] for p in per.values()]} "
                                 f"do not sum to the fleet's {total[k]}")
    if total["decode_attention"] or total["mq_decode_attention"]:
        raise AssertionError(f"the paged fleet launched contiguous kernels: {total}")
    for name, p in per.items():
        log(f"  {name} launches: flash {p['flash_attention']} (hopper "
            f"{p['flash_attention@hopper']}), paged decode {p['paged_decode_attention']} "
            f"(hopper {p['paged_decode_attention@hopper']}), paged multi-query "
            f"{p['mq_paged_decode_attention']} (prefill rounds "
            f"{p['mq_paged_decode_attention@prefill']})")
        if min(p["flash_attention"], p["paged_decode_attention"],
               p["mq_paged_decode_attention"]) <= 0:
            raise AssertionError(f"{name} did not launch kernels 2, 3 and 5: {p}")
        if p["flash_attention"] != p["flash_attention@hopper"] \
                or p["paged_decode_attention"] != p["paged_decode_attention@hopper"] \
                or p["mq_paged_decode_attention"] \
                != p["mq_paged_decode_attention@prefill"]:
            raise AssertionError(f"{name}: a launch off the Hopper bodies: {p}")
    rep = res.report(pattern="shared_prefix", backend=f"fleet{FLEET_REPLICAS}")

    def line(r):
        return (f"TTFT p50 {r.ttft_p50_s * 1e3:.1f} ms, p99 {r.ttft_p99_s * 1e3:.1f} ms; "
                f"decode {1e3 / r.decode_tok_s_p50:.2f} ms/token per request (p50); "
                f"{r.n_requests} requests")
    log(f"  FleetReport aggregate: {line(rep.aggregate)} [{card}; {cfg.n_layers} layers]")
    for rp in fleet.replicas:
        st = rp.backend.prefix_stats
        log(f"  {rp.name}: {line(rep.replicas[rp.name])}; prefix hits "
            f"{st['prefix_hits']}, prompt tokens from the cache "
            f"{st['prefill_tokens_saved']} [{card}; {cfg.n_layers} layers]")
        if st["prefill_tokens_saved"] <= 0:
            raise AssertionError(f"{rp.name}: no prompt token came from its radix tree")
    n_same, n_tie = fleet_alone_check(cfg, params, res.per_replica, card)
    log(f"  against each prompt served alone on phase 2b's path: {n_same} of "
        f"{len(reqs)} requests token-identical, {n_tie} diverge at a near tie")
    del fleet, res
    gc.collect()
    torch.cuda.empty_cache()
    return total


PAIR_STEPS = 5            # steps of a captured-vs-eager pair check


def step_pair(label, step, tok, card, save, restore, n=PAIR_STEPS, steps=None):
    """n steps of step(tok, steps) (steps None: eager; a CapturedStep:
    replayed), each run eagerly, then with the state put back as the eager
    step found it (save() -> restore(saved)) through the graph: logits bit
    for bit and the launch counters' advance equal; the next token the
    eager step's greedy pick. Prints both paces (the median step; the
    first captured step captures). `steps`: the CapturedStep whose graph
    pool is reported (a new one by default). Returns (eager ms, captured
    ms)."""
    import torch
    from repro_torch.core.capture import CapturedStep
    steps = CapturedStep("cuda") if steps is None else steps
    times = {False: [], True: []}
    for _ in range(n):
        saved = save()
        out = {}
        for cap in (False, True):
            if cap:
                restore(saved)
            c0 = read_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            lg = step(tok, steps if cap else None)
            torch.cuda.synchronize()
            times[cap].append(time.monotonic() - t0)
            out[cap] = (lg, {k: v - c0[k] for k, v in read_counts().items() if v != c0[k]})
        if not torch.equal(out[False][0], out[True][0]):
            raise AssertionError(f"{label}: a captured step's logits differ from the "
                                 "eager step's")
        if out[False][1] != out[True][1] or not out[False][1]:
            raise AssertionError(f"{label}: launches {out[False][1]} eager, "
                                 f"{out[True][1]} captured")
        lg = out[False][0]
        tok = lg.reshape(lg.shape[0], -1, lg.shape[-1])[:, -1].argmax(-1, keepdim=True)
    me, mc = (statistics.median(times[c]) * 1e3 for c in (False, True))
    log(f"  {label}: {n} steps captured against eager, logits bit-equal, launches "
        f"equal ({out[True][1]} a step); {me:.3f} ms eager, {mc:.3f} ms captured a step "
        f"(median; capture {times[True][0] * 1e3:.1f} ms, graph pool "
        f"{steps.pool_bytes() / 2**20:.1f} MiB) [{card}]")
    return me, mc


def model_step_pair(label, cfg, params, cache, tok, card, **kw):
    """step_pair over M.decode_step on a model cache (kw: impl, enc_len),
    the whole cache saved and put back in place around each eager step."""
    from repro_torch.models import model as M

    def save():
        return {k: v.clone() if hasattr(v, "clone") else v for k, v in cache.items()}

    def restore(saved):
        for k, v in saved.items():
            if hasattr(v, "clone"):
                cache[k].copy_(v)
            else:
                cache[k] = v
    return step_pair(label, lambda t, steps: M.decode_step(
        cfg, params, cache, t, steps=steps, **kw)[0], tok, card, save, restore)


def engine_draft_pair(eng, st, tok, card, what, steps):
    """step_pair over the engine's resident-only draft step (`steps`, a
    CapturedStep, for the captured run): pure-KV, so putting the state back
    is rolling its position back. The state ends where it began."""
    P = st["pos"]
    step_pair(f"the engine's draft step ({what}, B {eng.mb})",
              lambda t, s: eng.draft_step(st, t, steps=s)[0], tok, card,
              lambda: st["pos"], lambda p: eng.rollback(st, p), steps=steps)
    eng.rollback(st, P)


def prefilled_pair(cfg, params, prompts, card):
    """model_prefill_pair on the bursty batch `prompts`, then
    model_step_pair on the model's decode step after that prefill (impl
    "kernel")."""
    import numpy as np
    import torch

    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    lg, cache = model_prefill_pair(cfg, params, toks, card)
    model_step_pair(f"{cfg.name} decode step (B {toks.shape[0]}, {cfg.n_layers} "
                    "layers)", cfg, params, cache,
                    lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True), card,
                    impl="kernel")


PREFILL_PAIRS = 3         # prefills of a captured-vs-eager prefill pair


def graph_note(g):
    """A backend's graph_stats in words: its step (an engine's pass),
    prefill and draft graphs, captures, replays, capture seconds, pool."""
    return (f"graphs: steps / passes {g['captures']} captured in "
            f"{g['capture_s'] * 1e3:.0f} ms, {g['replays']} replays; prefills "
            f"{g['prefill_captures']} captured in {g['prefill_capture_s'] * 1e3:.0f} ms, "
            f"{g['prefill_replays']} replays; drafts {g['draft_captures']} captured, "
            f"{g['draft_replays']} replays; pool {g['pool_bytes'] / 2**20:.1f} MiB")


def capture_pair(label, run, card, save, restore, observe, n, steps=None):
    """n calls of run(steps) (steps None: eager; a CapturedStep: the graph
    of the call's shape replayed, captured at the first), each run
    eagerly, then with the state put back as the eager call found it
    (save() -> restore(saved)) through the graph: its logits, what it
    wrote (observe(): tensors) bit for bit and the launch counters'
    advance equal. Prints the eager and the replayed time (median), the
    first captured call's (the eager warm-up plus the capture's host time)
    and the graph-pool MiB the captures added. Returns (eager ms, replayed
    ms, first captured call ms)."""
    import torch
    from repro_torch.core.capture import CapturedStep
    steps = CapturedStep("cuda") if steps is None else steps
    torch.cuda.synchronize()
    pool0 = steps.pool_bytes()
    times = {False: [], True: []}
    for i in range(n):
        saved = save()
        out = {}
        for cap in (False, True):
            if cap:
                restore(saved)
            c0 = read_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            lg = run(steps if cap else None)
            torch.cuda.synchronize()
            times[cap].append(time.monotonic() - t0)
            out[cap] = (lg, {k: v - c0[k] for k, v in read_counts().items()
                             if v != c0[k]}, observe())
        (le, ne, we), (lc, nc, wc) = out[False], out[True]
        if not torch.equal(le, lc):
            raise AssertionError(f"{label}: call {i}: captured logits differ from the "
                                 "eager call's")
        bad = [j for j, (a, b) in enumerate(zip(we, wc)) if not torch.equal(a, b)]
        if bad or len(we) != len(wc):
            raise AssertionError(f"{label}: call {i}: what the captured call wrote "
                                 f"differs from the eager call's (tensors {bad})")
        if ne != nc or not ne:
            raise AssertionError(f"{label}: launches {ne} eager, {nc} captured")
    pool = (steps.pool_bytes() - pool0) / 2**20
    me = statistics.median(times[False]) * 1e3
    mc = statistics.median(times[True][1:] or times[True]) * 1e3
    first = times[True][0] * 1e3
    log(f"  {label}: {n} calls captured against eager, logits and what they wrote "
        f"bit-equal, launches equal ({nc} a call); {me:.3f} ms eager, {mc:.3f} ms "
        f"replayed (median); the first captured call {first:.1f} ms (eager warm-up + "
        f"capture), {steps.captures} graph(s), graph pool +{pool:.1f} MiB [{card}]")
    return me, mc, first


def model_prefill_pair(cfg, params, toks, card, enc_out=None):
    """capture_pair over M.prefill of `toks` (B, S) (impl "kernel"; the
    encoder-decoder family's enc_out a static input of the graph) into a
    cache cleared in place before each call; what each wrote: every cache
    tensor. Returns (logits, cache) of the last prefill."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.core.capture import CapturedStep
    B = toks.shape[0]
    kw = {"enc_out": enc_out} if enc_out is not None else {}
    cache = M.init_cache(cfg, B, MAX_LEN, enc_out=enc_out)
    steps = CapturedStep("cuda")
    last = []

    def run(steps):
        lg, _ = M.prefill(cfg, params, toks, M.clear_cache(cache), impl="kernel",
                          steps=steps, **kw)
        last[:] = [lg]
        return lg

    def observe():
        return tuple(v.clone() for v in cache.values() if isinstance(v, torch.Tensor))
    label = f"{cfg.name} prefill (B {B}, S {toks.shape[1]}, {cfg.n_layers} layers)"
    capture_pair(label, run, card, lambda: None, lambda _: None, observe,
                 PREFILL_PAIRS, steps=steps)
    pass_profile(None, None, None, lambda: run(steps), card, f"replayed {label}")
    return last[0], cache


def engine_pass_pair(eng, st, tok, card, what, n=PAIR_STEPS, prompt=None,
                     enc_out=None):
    """capture_pair over the engine's streamed decode pass of `tok` from
    state st (and first, given `prompt`, its prompt pass into st): the
    pure-KV families put back by rolling the position back, what a pass
    wrote being its K/V slot and pos_ids; the others by copying every state
    tensor back, what it wrote being the whole state (enc_out: the
    encoder-decoder prompt pass's static input). The state ends one pass
    on. Returns the decode pair's (eager ms, replayed ms, first ms)."""
    import torch

    from repro_torch.core.capture import CapturedStep
    from repro_torch.models import model as M
    steps = CapturedStep(eng.device)
    label = f"{eng.cfg.name} engine, {what}"

    def whole():
        return tuple(v.clone() for v in st.values() if isinstance(v, torch.Tensor))
    if prompt is not None:
        what = f"{label}: the prompt pass (B {prompt.shape[0]}, S {prompt.shape[1]})"

        def prompt_pass(s):
            return eng.prefill(prompt, enc_out, cache=st, steps=s)[0]
        capture_pair(what, prompt_pass, card, lambda: None, lambda _: None, whole,
                     PREFILL_PAIRS, steps=steps)
        pass_profile(None, None, None, lambda: prompt_pass(steps), card,
                     f"replayed {what}")
    if eng.cfg.family in M.PURE_KV:
        S_c = st["k"].shape[2]

        def save():
            return st["pos"]

        def restore(p):
            eng.rollback(st, p)

        def observe():
            slot = (st["pos"] - 1) % S_c
            return (st["k"][:, :, slot].clone(), st["v"][:, :, slot].clone(),
                    st["pos_ids"].clone())
    else:
        def save():
            return whole(), st["pos"]

        def restore(saved):
            ts, p = saved
            for a, b in zip((v for v in st.values() if isinstance(v, torch.Tensor)), ts):
                a.copy_(b)
            st["pos"] = p
        observe = whole
    return capture_pair(f"{label}: a decode pass (B {tok.shape[0]})",
                        lambda s: eng.decode_step(st, tok, steps=s)[0], card, save,
                        restore, observe, n, steps=steps)


# ----------------------------------------------------------------------------
# phase 3a: the engine against the model, 8 layers
# ----------------------------------------------------------------------------
def argmax_or_tie(name, got, ref, err):
    """got, ref: (n, V) fp32 logits of the same positions by two paths.
    Each row's pick under `got` must be the pick under `ref` or a near tie
    of it (ref's gap between the two picks within the rows' logit error
    err, or got's own logits of the two picks equal: its argmax broke an
    exact tie by index). Returns the number of near ties."""
    ag, ar = got.argmax(-1), ref.argmax(-1)
    gap = (ref.gather(-1, ar[:, None]) - ref.gather(-1, ag[:, None]))[:, 0]
    kgap = (got.gather(-1, ag[:, None]) - got.gather(-1, ar[:, None]))[:, 0]
    bad = (ag != ar) & (gap > err) & (kgap > 0)
    if bad.any():
        raise AssertionError(f"{name}: greedy picks differ outside a near "
                             f"tie (gaps {gap[bad].tolist()}, err {err})")
    return int((ag != ar).sum())


def engine_check_phase(cfg, params, card):
    """Phase 2's weights in a plan forced to stream: the engine's decode
    and verify run models.model.decode_layer on the same inputs as the
    model's kernel path, so their logits must be bit-equal; its chunked
    prefill (multi-query rounds) against the model's flash prefill stays
    within LOGIT_REL_TOL, greedy equal outside near ties."""
    import numpy as np
    import torch

    from repro_torch.core.engine import InterleavedEngine, UniformPlan
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.models import model as M

    V = cfg.vocab_size
    plan = UniformPlan(1, 2, 2, 2)
    eng = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN,
                            retier_headroom=1)
    st = eng.init_state(params)
    log(f"phase 3a: engine vs model, {cfg.n_layers} layers, plan n_seg "
        f"{plan.n_seg} k_res {plan.k_res} k_off {plan.k_off} headroom 1: "
        f"resident {eng.resident_layer_ids()}, pinned store "
        f"{eng.store.nbytes / 1e9:.2f} GB (registered {eng.store.registered})")
    toks = torch.from_numpy(np.stack(make_prompts(4, V, 21))).long().cuda()
    mc = M.init_cache(cfg, 4, MAX_LEN)
    ml, mc = M.prefill(cfg, params, toks, mc, impl="kernel")
    m0, h0 = mq.launches, mq.hopper_launches
    el, st = eng.prefill_partial(st, toks, chunk=PREFILL_CHUNK)
    torch.cuda.synchronize()
    if mq.launches - m0 != cfg.n_layers or mq.hopper_launches - h0 != cfg.n_layers:
        raise AssertionError("engine prefill: one mq launch per layer, through the "
                             "Hopper mainloop, expected")
    a, b = el[:, -1, :V].float(), ml[:, -1, :V].float()
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    ties = argmax_or_tie("engine prefill vs flash prefill", a, b, err)
    log(f"  prefill_partial (mq rounds) vs M.prefill (flash): max logit err "
        f"{err:.4f} at |logit| max {scale:.2f} (tol {LOGIT_REL_TOL} of it), "
        f"{ties} near ties of 4 picks")
    if err > LOGIT_REL_TOL * scale:
        raise AssertionError("engine prefill logits off the model's")
    # the same cache on both sides from here on
    mc = {"pos": st["pos"], "pos_ids": st["pos_ids"].clone(),
          "k": st["k"].clone(), "v": st["v"].clone()}
    tok = a.argmax(-1, keepdim=True)
    steps = []
    for i in range(4):
        if i == 1:
            eng.retier(st, 0, +1)
        if i == 3:
            eng.retier(st, 0, -1)
        el, st = eng.decode_step(st, tok)
        ml, mc = M.decode_step(cfg, params, mc, tok, impl="kernel")
        steps.append(("decode" + (" after retier(+1)" if i in (1, 2) else ""),
                      el, ml[:, 0]))
        tok = el[:, :V].argmax(-1, keepdim=True)
    mat = torch.cat([tok, toks[:, 1:5]], 1)
    v0 = mq.verify_sm90_launches
    el, st = eng.verify_step(st, mat)
    ml, mc = M.verify_step(cfg, params, mc, mat, impl="kernel")
    torch.cuda.synchronize()
    if mq.verify_sm90_launches - v0 != 2 * cfg.n_layers:
        raise AssertionError("verify q_len 5: every layer's mq launch must take the verify "
                             f"body ({mq.verify_sm90_launches - v0} of {2 * cfg.n_layers})")
    steps.append(("verify q_len 5", el, ml))
    for name, e, m in steps:
        same = torch.equal(e, m)
        log(f"  {name}: engine logits {'bit-equal to' if same else 'DIFFER from'} "
            f"the model's (max |diff| {(e.float() - m.float()).abs().max().item():.3g})")
        if not same:
            raise AssertionError(f"engine {name} differs from the model")
    for key in ("k", "v", "pos_ids"):
        if not torch.equal(st[key], mc[key]):
            raise AssertionError(f"engine cache {key} differs from the model's")
    # the same positions by the two paths a spec serve mixes: decode steps
    # (decode kernel, M = 4 GEMMs) and one verify pass (mq kernel)
    P = st["pos"]
    seq = [tok]
    ld = []
    for _ in range(8):
        el, st = eng.decode_step(st, seq[-1])
        ld.append(el[:, :V].float())
        seq.append(el[:, :V].argmax(-1, keepdim=True))
    eng.rollback(st, P)
    v0, m0 = mq.verify_sm90_launches, mq.launches
    lv, st = eng.verify_step(st, torch.cat(seq[:8], 1))
    torch.cuda.synchronize()
    if (mq.verify_sm90_launches - v0, mq.launches - m0) != (cfg.n_layers,) * 2:
        raise AssertionError("verify q_len 8: every mq launch must take the verify body")
    d = (torch.stack(ld, 1) - lv[..., :V].float()).abs().amax(-1)
    rel = d / torch.stack(ld, 1).abs().amax(-1)
    log(f"  decode steps vs one verify pass over the same 8 positions: logit "
        f"err / |logit| max by position {[round(x, 4) for x in rel.max(0).values.tolist()]} "
        f"[{card}; {cfg.n_layers} layers]")
    eng.close()


# ----------------------------------------------------------------------------
# phase 3c: the recurrent families, full width, 4 of 32 layers
# ----------------------------------------------------------------------------
RECURRENT_ARCHS = ("rwkv6-3b", "hymba-1.5b")
# depth cut: at all 32 layers this phase took 250-443 s of the
# script's time, host-bound, at 16 layers 167-178 s; with phase 3e the
# script took 924 s at 16, so 8 layers kept it inside 900 s beside the
# 80-layer engine's serves, phase 3d and phase 3e; with phases 3f, 3g and
# 3h the script took 1307 s at 8 on an H100 80GB HBM3 (700 W) whose host
# ran every phase 15-40% slower than usual (3c 137.7 s), over its 1200 s
# limit, so 4 (phase 3f serves both at all 32 layers through the engine)
RECURRENT_LAYERS = 4
# Depth amplifies rounding on random weights: one bf16 ulp that flips in
# layer 0 (0.6% of the hidden state's largest |value|) grows to 4-6% by
# layer 16 on the H100, whatever flipped it (the kernel path against the
# reference, or the reference against itself at another batch shape of its
# GEMMs; PERF.md). So the recurrent serves hold the kernel path's logits to
# a fixed RECURRENT_LOGIT_REL_TOL of the largest |logit|, set from 16-layer
# readings (the noise shrinks with depth): the kernel path read 5.9%
# (RWKV6) and 4.0% (Hymba) at 16 layers, a prefill that loses layer 0's
# scan state or every layer's reads 132-137% (planted_faults, checked in
# every run). The reference's own noise floor (noise_floor) is read in the
# same run and must stay under NOISE_FLOOR_MAX (it read 5.9% and 3.8% at
# 16 layers): a floor above it means the shared model code itself moved. A
# prefill's states are held to STATE_REL_TOL of each layer entry's largest
# |value|: the one-pass prefill and the token-by-token decode round their
# bf16 GEMMs differently (B·512 rows against B), while a capture fault (an
# empty cache, as the reference's hybrid prefill leaves it; K/V of shifted
# positions; conv rows or a scan state of another step) is off by ~1.
RECURRENT_LOGIT_REL_TOL = 0.08
NOISE_FLOOR_MAX = 0.07
STATE_REL_TOL = 0.25


def step_launches(cfg, decode):
    """What one scheduler step of the recurrent serves must launch: the
    scan kernel once per layer (a prefill's 512 steps on its chunked body,
    a decode step's one on the sequential body), and for Hymba flash
    (prefill) or decode attention (decode step) once per layer."""
    from repro_torch.configs.base import Family
    L = cfg.n_layers
    want = dict.fromkeys(kernel_counters(), 0)
    scan = "wkv_scan" if cfg.family == Family.SSM else "ssm_scan"
    want[scan] = L
    if not decode:
        want[scan + "@chunked"] = L
    if cfg.family == Family.HYBRID:
        want["decode_attention" if decode else "flash_attention"] = L
        want["decode_attention@hopper" if decode else "flash_attention@hopper"] = L
    return want


def drive_recurrent(srv, prompts, pattern, max_new=MAX_NEW, after_step=None):
    """Serve `prompts` under `pattern` (max_new tokens each) one scheduler
    step at a time: every step's launches must be what it implies
    (step_launches); after_step, where given, is called after each step
    that launched anything.
    Returns (finished requests, scheduler stats)."""
    import torch
    from repro_torch.serving import (ContinuousBatchingScheduler, Request,
                                     SchedulerConfig, cli_arrivals)
    be = srv.make_backend()
    arrivals = cli_arrivals(pattern, len(prompts), prompt_len=PROMPT_LEN,
                            max_new_tokens=max_new, burst_size=srv.slots)
    base = be.now()
    reqs = [Request(i, p, ev.max_new_tokens, arrival_s=base + ev.time_s)
            for i, (ev, p) in enumerate(zip(arrivals, prompts))]
    sched = ContinuousBatchingScheduler(be, SchedulerConfig())
    sched.begin(reqs)
    n_prefill = 0
    while True:
        n_rounds = len(be.rounds)
        c0 = read_counts()
        if not sched.step():
            break
        torch.cuda.synchronize()
        got = {k: v - c0[k] for k, v in read_counts().items()}
        if len(be.rounds) > n_rounds:
            want = step_launches(srv.cfg, decode=True)
        elif any(got.values()):
            want = step_launches(srv.cfg, decode=False)
            n_prefill += 1
        else:                                          # an idle jump
            want = got
        if got != want:
            raise AssertionError(f"{pattern}: a step launched {got}, expected {want}")
        if after_step is not None and any(got.values()):
            after_step()
    if n_prefill != (1 if pattern == "bursty" else len(prompts)):
        raise AssertionError(f"{pattern}: {n_prefill} prefill steps")
    return sorted(sched.finish_run(), key=lambda r: r.rid), sched.stats


def state_bytes(cache, batch):
    """Bytes of a sequence's decode state: its rows of every per-layer
    cache entry (K/V, pos_ids shared, recurrent states, shift and conv
    rows)."""
    return sum(t.numel() * t.element_size() for k, t in cache.items()
               if k not in ("pos", "pos_ids")) / batch


def noise_floor(cfg, params, prompts, feed, batch_logits):
    """The reference path's own rounding noise at this depth: its logits
    `batch_logits` (T, n, V) for the bursty batch (the reference serve's
    tokens `feed` fed at width 4, from compare_greedy) against each request
    fed alone (width 1), where only the batch shape of the GEMMs changes.
    Returns the largest err / |logit| max."""
    import torch
    alone = torch.stack([forced_logits(cfg, params, [p], feed[i:i + 1], 1, "ref")[:, 0]
                         for i, p in enumerate(prompts)], 1)
    return ((alone - batch_logits).abs().amax(-1)
            / batch_logits.abs().amax(-1)).max().item()


def planted_faults(cfg):
    """Capture faults of a prefill, each planted in the kernel path's
    prefilled cache: (label, edit of the cache, whether the logit limit
    must reject it). A state lost early in the stack reaches the logits
    through every later layer; one lost in the last layer reads within the
    depth noise (the per-layer state check of prefill_vs_stepwise is what
    sees it: a lost entry is off by 1). Dense: layer 0's prompt K/V, or
    every layer's prompt V, lost."""
    from repro_torch.configs.base import Family
    L = cfg.n_layers

    def zero(keys, layers):
        def edit(cache):
            for k in keys:
                cache[k][layers].zero_()
        return edit
    if cfg.family == Family.DENSE:
        return [("layer 0's prompt K/V lost", zero(("k", "v"), 0), True),
                ("every layer's prompt V lost", zero(("v",), slice(None)), True)]
    scan = "rwkv_state" if cfg.family == Family.SSM else "ssm_state"
    rows = ("last_tm", "last_cm") if cfg.family == Family.SSM else ("conv_state",)
    return [(f"{scan} of every layer lost", zero((scan,), slice(None)), True),
            (f"{scan} of layer 0 lost", zero((scan,), 0), True),
            (f"{scan} of layer {L - 1} lost", zero((scan,), L - 1), False),
            (f"{'/'.join(rows)} of layer {L - 1} lost", zero(rows, L - 1), False)]


def fault_errors(cfg, params, prompts, feed, batch_logits):
    """The kernel path's logit error against the reference's `batch_logits`
    (T, n, V) with each planted fault: [(label, err / |logit| max, whether
    the limit must reject it)]."""
    out = []
    for label, edit, must in planted_faults(cfg):
        lk = forced_logits(cfg, params, prompts, feed, 4, "kernel", after_prefill=edit)
        err = ((lk - batch_logits).abs().amax(-1)
               / batch_logits.abs().amax(-1)).max().item()
        out.append((label, err, must))
    return out


def prefill_vs_stepwise(cfg, params, prompts, card):
    """The one-pass prefill's cache, then one decode step, against a
    token-by-token decode_step run of the same prompts from an empty cache
    (both through the kernels): the last prompt position's logits and the
    next step's within RECURRENT_LOGIT_REL_TOL of the largest |logit|, the
    next step greedy equal or a near tie; each per-layer state entry within
    STATE_REL_TOL of its largest |value|."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    V = cfg.vocab_size
    tol = RECURRENT_LOGIT_REL_TOL
    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    B, S = toks.shape
    pc = M.init_cache(cfg, B, MAX_LEN)
    lp, pc = M.prefill(cfg, params, toks, pc, impl="kernel")
    sc = M.init_cache(cfg, B, MAX_LEN)
    t0 = time.monotonic()
    for t in range(S):
        ls, sc = M.decode_step(cfg, params, sc, toks[:, t:t + 1], impl="kernel")
    torch.cuda.synchronize()
    t_steps = time.monotonic() - t0
    a0, b0 = lp[:, -1, :V].float(), ls[:, -1, :V].float()
    err0, scale0 = (a0 - b0).abs().max().item(), b0.abs().max().item()
    nxt = ls[:, -1, :V].argmax(-1, keepdim=True)
    lp, pc = M.decode_step(cfg, params, pc, nxt, impl="kernel")
    ls, sc = M.decode_step(cfg, params, sc, nxt, impl="kernel")
    a, b = lp[:, -1, :V].float(), ls[:, -1, :V].float()
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    ties = argmax_or_tie(f"{cfg.name} prefill vs token-by-token", a, b, err)
    worst = {}
    for key, ref in sc.items():
        if key in ("pos", "pos_ids"):
            continue
        got = pc[key].float()
        d = (got - ref.float()).flatten(1).abs().amax(1) \
            / ref.float().flatten(1).abs().amax(1)            # per layer
        worst[key] = (d.max().item(), int(d.argmax()), d[0].item())
    log(f"  {cfg.name}: prefill + 1 step vs {S} token-by-token decode steps "
        f"({t_steps:.1f} s) + 1: last prompt logit err {err0:.4f} at |logit| max "
        f"{scale0:.2f}, next-step logit err {err:.4f} at |logit| max {scale:.2f} "
        f"(tol {tol} of it), {ties} near ties of {B} picks; per-layer state err / "
        f"max |value| (worst, at layer, layer 0): "
        + ", ".join(f"{k} {w:.3g} @{l}, {z:.3g}" for k, (w, l, z) in worst.items())
        + f" (tol {STATE_REL_TOL}) [{card}]")
    if err0 > tol * scale0:
        raise AssertionError(f"{cfg.name}: prefill's last prompt logits off the "
                             "token-by-token run")
    if err > tol * scale:
        raise AssertionError(f"{cfg.name}: prefill's next step off the token-by-token run")
    if pc["pos"] != sc["pos"] or ("pos_ids" in pc
                                  and not torch.equal(pc["pos_ids"], sc["pos_ids"])):
        raise AssertionError(f"{cfg.name}: prefill positions differ")
    bad = {k: w for k, (w, _, _) in worst.items() if w > STATE_REL_TOL}
    if bad:
        raise AssertionError(f"{cfg.name}: prefill states off the token-by-token run {bad}")


def recurrent_breakdown(cfg, params, card):
    """Device time by kernel class over one bursty serve under the profiler
    (GEMMs, the scan, the attention kernels, other), each port kernel's µs
    per call, and the device's idle share of the serve's wall time."""
    import torch

    from repro_torch.configs.base import Family
    prompts = make_prompts(4, cfg.vocab_size, 7)
    scan = "wkv_scan" if cfg.family == Family.SSM else "ssm_scan"
    prof, wall_us = profiled(lambda: serve(cfg, params, "bursty", prompts, "kernel"),
                             scan + "_kernel")
    by = {scan: 0.0, "flash_attention": 0.0, "decode_attention": 0.0, "gemm": 0.0,
          "other": 0.0}
    # the scan's launches in time order: the first n_layers are the
    # prefill's (the serve prefills once), on the chunked body; the rest
    # decode steps', on the sequential one
    scan_us = sorted((e.time_range.start, e.time_range.elapsed_us(), "chunked" in e.name)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "repro" in e.name and scan + "_kernel" in e.name)
    L = cfg.n_layers
    if len(scan_us) != L * MAX_NEW:
        raise AssertionError(f"breakdown: {len(scan_us)} {scan} kernel events, "
                             f"expected {L * MAX_NEW}")
    if not all(c for _, _, c in scan_us[:L]) or any(c for _, _, c in scan_us[L:]):
        raise AssertionError(f"breakdown: {scan}'s prefill calls not all on the chunked "
                             "body, or a decode call on it")
    pre_us = sum(d for _, d, _ in scan_us[:L]) / L
    dec_us = sum(d for _, d, _ in scan_us[L:]) / (L * (MAX_NEW - 1))
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        one_pass(name)
        m = csrc_kernel(name)
        if m is not None:
            cls = {"wkv": "wkv_scan", "ssm": "ssm_scan", "decode": "decode_attention",
                   "flash": "flash_attention"}[m[0]]
        elif any(x in name for x in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "other"
        by[cls] += us
    calls = {scan: L * MAX_NEW, "flash_attention": L, "decode_attention": L * (MAX_NEW - 1)}
    if scan == "wkv_scan":
        calls["flash_attention"] = calls["decode_attention"] = 0
    for cls, n in calls.items():
        if n and by[cls] <= 0:
            raise AssertionError(f"breakdown: no device time for {cls}, whose kernels ran")
    busy = sum(by.values())
    per = ", ".join(f"{c} {by[c] / n:.2f} us per call ({n} calls)"
                    for c, n in calls.items() if n)
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by.items())
    log(f"  {cfg.name} bursty serve under the profiler: {per}; {scan} {pre_us:.2f} us "
        f"per prefill call (S {PROMPT_LEN}, {L} calls), {dec_us:.2f} us per decode "
        f"call ({L * (MAX_NEW - 1)} calls); device time {parts}; "
        f"(every prefill call on the chunked body, every decode call on the "
        f"sequential one); busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall, idle share "
        f"{1 - busy / wall_us:.1%} [{card}]")


def recurrent_serve(arch, card):
    """One recurrent config at full width and RECURRENT_LAYERS layers, random weights
    from seed 0, through LimeServer -> scheduler -> EngineBackend (the
    single-device path), bursty and sporadic, with exact launch counts; the
    reference tokens (impl="ref") fed through both impls; prefill against
    token-by-token decode; a profiled serve. Returns the serves' launches.
    Everything it allocates dies with its frame."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import LimeServer, summarize

    cfg = dataclasses.replace(get_config(arch), n_layers=RECURRENT_LAYERS)
    t0 = time.monotonic()
    t_lap = [t0]

    def lap(what):
        now = time.monotonic()
        log(f"  {what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    before = torch.cuda.memory_allocated()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"phase 3c: {cfg.name} ({cfg.family.value}) at full width, "
        f"{cfg.n_layers} of {get_config(arch).n_layers} layers (d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} kv heads, {cfg.ssm_heads} ssm heads, N "
        f"{cfg.ssm_state_size}, window {cfg.window_size}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}): {n_par / 1e9:.3f} B params in "
        f"{time.monotonic() - t0:.1f} s; {before / 1e9:.2f} GB allocated before them")
    serve(cfg, params, "bursty", make_prompts(4, cfg.vocab_size, 99), "kernel",
          max_new=2)
    serve(cfg, params, "sporadic", make_prompts(1, cfg.vocab_size, 99), "kernel",
          max_new=2)
    torch.cuda.synchronize()
    lap(f"{cfg.name} parameters and warm-up serves")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    outs = {}
    for pattern, n_req in (("bursty", 4), ("sporadic", 2)):
        prompts = make_prompts(n_req, cfg.vocab_size, 0)
        srv = LimeServer(cfg, params, max_len=MAX_LEN, pattern=pattern)
        done, stats = drive_recurrent(srv, prompts, pattern)
        rep = summarize(done, pattern=pattern, backend="single-device", stats=stats)
        log(f"  {pattern}: {rep.n_requests} requests x {MAX_NEW} tokens, prompt "
            f"{PROMPT_LEN}: TTFT p50 {rep.ttft_p50_s * 1e3:.2f} ms, p99 "
            f"{rep.ttft_p99_s * 1e3:.2f} ms, decode {1e3 / rep.decode_tok_s_p50:.3f} "
            f"ms/token per request (p50) [{card}; {cfg.name}, {cfg.n_layers} layers]")
        outs[pattern] = (prompts, done)
    got = read_counts()
    lap(f"{cfg.name} kernel serves")
    cache = M.init_cache(cfg, 1, MAX_LEN)
    log(f"  launches {got}; peak HBM {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB; decode state per sequence {state_bytes(cache, 1) / 1e6:.2f} MB at "
        f"max_len {MAX_LEN} [{card}]")
    log(f"phase 3c: {cfg.name} re-served on the reference math (impl='ref'), both "
        "impls fed the reference's tokens at the served batch shape")
    refs = {pattern: serve(cfg, params, pattern, prompts, "ref")
            for pattern, (prompts, _) in outs.items()}
    lap(f"{cfg.name} reference serves")
    tol = RECURRENT_LOGIT_REL_TOL
    ref_logits = []
    for pattern, (prompts, done) in outs.items():
        width = LimeServer(cfg, params, pattern=pattern).slots
        n_pos, n_tie, worst = compare_greedy(cfg, params, pattern, prompts, done,
                                             refs[pattern], width, tol, ref_logits)
        n_same = sum(a.output == b.output for a, b in zip(done, refs[pattern]))
        log(f"  {pattern}: {n_same}/{len(done)} requests token-identical; "
            f"{n_pos} positions compared, {n_tie} near ties, worst logit err "
            f"{worst:.4f} of |logit| max (tol {tol})")
    lap(f"{cfg.name} forced passes of both impls")
    prompts = outs["bursty"][0]
    floor = noise_floor(cfg, params, prompts,
                        np.array([r.output for r in refs["bursty"]], np.int64),
                        ref_logits[0])
    log(f"  the reference's own noise floor: each bursty request fed alone against "
        f"the 4-wide batch, logit err up to {floor:.4f} of |logit| max (at most "
        f"{NOISE_FLOOR_MAX}) [{card}]")
    if floor > NOISE_FLOOR_MAX:
        raise AssertionError(f"{cfg.name}: the reference's own noise floor {floor:.4f} "
                             f"is above {NOISE_FLOOR_MAX}")
    lap(f"{cfg.name} noise floor")
    feed = np.array([r.output for r in refs["bursty"]], np.int64)
    faults = fault_errors(cfg, params, prompts, feed, ref_logits[0])
    log(f"  planted prefill faults, the kernel path's logit err / |logit| max against "
        f"the reference: {', '.join(f'{k} {v:.4f}' for k, v, _ in faults)} (limit {tol}; "
        f"the last layer's within the depth noise) [{card}]")
    missed = [k for k, v, must in faults if must and v <= tol]
    if missed:
        raise AssertionError(f"{cfg.name}: the logit limit {tol} passes planted "
                             f"faults {missed}")
    lap(f"{cfg.name} planted faults")
    prefill_vs_stepwise(cfg, params, prompts, card)
    lap(f"{cfg.name} prefill vs token-by-token")
    prefilled_pair(cfg, params, prompts, card)
    lap(f"{cfg.name} captured against eager steps")
    recurrent_breakdown(cfg, params, card)
    lap(f"{cfg.name} profiled serve")
    return got


def recurrent_phase(card):
    """Phase 3c: recurrent_serve for RWKV6-3B, then Hymba-1.5B, each on a
    card holding nothing of the other. Returns the summed launches."""
    import torch
    launches = {}
    for arch in RECURRENT_ARCHS:
        for k, n in recurrent_serve(arch, card).items():
            launches[k] = launches.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------------
# phase 3f: the recurrent families through the engine, all 32 layers
# ----------------------------------------------------------------------------
ENGINE_NEW = 8            # tokens per request in phase 3f's serves
ENGINE_PAGE = 64          # the paged Hymba serve's page


def engine_forced_logits(eng, params, prompts, feed, after_prefill=None, steps=None):
    """forced_logits through the engine: its prompt pass over the tiers,
    seed_cache, then decode steps fed the (n, T) tokens `feed` (the first
    `steps` of them where given). Logits (T, n, vocab) fp32."""
    import numpy as np
    import torch

    from repro_torch.serving.backend import EngineBackend
    V = eng.cfg.vocab_size
    toks = torch.from_numpy(EngineBackend._pad_prompts(prompts)).long().cuda()
    T = feed.shape[1] if steps is None else steps + 1
    lg, cache = eng.prefill(toks)
    if after_prefill is not None:
        after_prefill(cache)
    st = eng.seed_cache(eng.init_state(params), cache)
    out = [lg[:, -1, :V].float()]
    for t in range(T - 1):
        lg, st = eng.decode_step(st, torch.from_numpy(
            np.ascontiguousarray(feed[:, t:t + 1])).long().cuda())
        out.append(lg[:, :V].float())
    return torch.stack(out)


def half_streamed_plan(cfg):
    """(budget, plan) of a --hbm-bytes budget whose plan_for plan streams
    half of cfg's layers (2 segments of L/4 resident + L/4 streamed) and
    whose resident layers fit its share by their packed bytes (the
    config's layer_params() count misjudges them: RWKV6 above, Hymba
    below, an encoder-decoder layer by its third norm)."""
    from repro_torch.core.engine import packed_layer_bytes, plan_for
    from repro_torch.launch.serve import HBM_FRAC
    L = cfg.n_layers
    packed, counted = packed_layer_bytes(cfg), cfg.layer_params() * 2
    budget = max(L // 2 * packed, (L // 2 + 0.5) * counted) / HBM_FRAC
    plan = plan_for(cfg, 1, hbm_frac_for_weights=HBM_FRAC, hbm_bytes=budget)
    if (plan.n_seg, plan.k_res, plan.k_off) != (2, L // 4, L // 4) \
            or L // 2 * packed > budget * HBM_FRAC:
        raise AssertionError(f"{cfg.name}: budget {budget:.4g} B plans {plan}")
    return budget, plan


def recurrent_engine_serve(arch, card):
    """One recurrent config at full width and all its layers through the
    InterleavedEngine (half of them streamed, half_streamed_plan), random
    weights from seed 0: a bursty batch served through LimeServer with exact
    launch counts; the engine's logits bit-equal to the model's kernel path
    (M.prefill + M.decode_step) on the same weights and tokens, and within
    phase 3c's limits of impl="ref" (the reference's noise floor read in
    the same run); planted faults (a streamed layer run from the other load
    buffer, a prefill that drops the first streamed layer's scan state)
    rejected; a decode pass timed against the copy of its streamed bytes
    and profiled; Hymba served once more by a paged engine. Returns the
    serves' launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import Family
    from repro_torch.core.engine import InterleavedEngine
    from repro_torch.launch.serve import HBM_FRAC, cost_env, measure_h2d
    from repro_torch.models import model as M
    from repro_torch.serving import LimeServer, summarize

    cfg = get_config(arch)
    V, L = cfg.vocab_size, cfg.n_layers
    t_lap = [time.monotonic()]

    def lap(what):
        now = time.monotonic()
        log(f"  {what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    budget, plan = half_streamed_plan(cfg)
    eng = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN)
    eng.init_state(params)
    torch.cuda.synchronize()
    n_res = len(eng.resident_layer_ids())
    streamed = (L - n_res) * eng.layer_bytes
    rate = measure_h2d(eng.store.data.flatten(0, 1)) / 1e9
    env = cost_env(cfg, budget, width=4, prompt_len=PROMPT_LEN, load_bw=rate * 1e9)
    env.evaluate(plan)
    log(f"phase 3f: {cfg.name} ({cfg.family.value}) at full width and all {L} layers "
        f"through the engine: --hbm-bytes {budget / 1e9:.3f} GB (x {HBM_FRAC}), plan_for "
        f"n_seg {plan.n_seg}, k_res {plan.k_res}, k_off {plan.k_off}: {n_res} resident "
        f"{eng.resident_layer_ids()}, packed layer {eng.layer_bytes / 1e6:.2f} MB (the "
        f"config's count {cfg.layer_params() * 2 / 1e6:.2f} MB), {streamed / 1e9:.3f} GB "
        f"streamed a pass from {eng.store.nbytes / 1e9:.3f} GB pinned (registered "
        f"{eng.store.registered}); H2D {rate:.2f} GB/s on a side stream, the streamed "
        f"bytes' copy {streamed / rate / 1e6:.2f} ms; cost model T_total "
        f"{plan.t_total * 1e3:.2f} ms (T_comp {plan.t_comp * 1e3:.2f}, T_uncover "
        f"{plan.t_uncover * 1e3:.2f}) [{card}]")
    lap(f"{cfg.name} weights and tiers")
    prompts = make_prompts(4, V, 0)
    warm = eng.init_state(params)
    eng.decode_step(warm, torch.ones((4, 1), dtype=torch.long, device="cuda"))
    del warm
    zero_counts()
    srv = LimeServer(cfg, params, engine=eng, max_len=MAX_LEN, pattern="bursty")
    done, stats = drive_recurrent(srv, prompts, "bursty", max_new=ENGINE_NEW)
    torch.cuda.synchronize()
    got = read_counts()
    rep = summarize(done, pattern="bursty", backend="engine", stats=stats)
    feed = np.array([r.output for r in done], np.int64)
    log(f"  bursty through the engine: 4 requests x {ENGINE_NEW} tokens, prompt "
        f"{PROMPT_LEN}: TTFT p50 {rep.ttft_p50_s * 1e3:.2f} ms, decode "
        f"{1e3 / rep.decode_tok_s_p50:.3f} ms/token per request (p50); launches "
        f"{ {k: n for k, n in got.items() if n} } (exact every step); state per "
        f"sequence {state_bytes(M.init_cache(cfg, 1, MAX_LEN), 1) / 1e6:.2f} MB "
        f"[{card}; {L} layers]")
    lap(f"{cfg.name} engine serve")
    le = engine_forced_logits(eng, params, prompts, feed)
    lk = forced_logits(cfg, params, prompts, feed, 4, "kernel")
    served = torch.from_numpy(feed.T).cuda()
    same = torch.equal(le, lk)
    log(f"  engine vs the model's kernel path (M.prefill + M.decode_step) on the "
        f"served tokens: logits {'bit-equal' if same else 'DIFFER'} (max |diff| "
        f"{(le - lk).abs().max().item():.3g}); served tokens "
        f"{'are' if torch.equal(le.argmax(-1), served) else 'ARE NOT'} the engine's "
        f"argmaxes")
    if not same or not torch.equal(le.argmax(-1), served):
        raise AssertionError(f"{cfg.name}: the engine is not the model's kernel path")
    lap(f"{cfg.name} forced engine and model passes")
    tol = RECURRENT_LOGIT_REL_TOL
    lr = forced_logits(cfg, params, prompts, feed, 4, "ref")
    err = (le - lr).abs().amax(-1)
    scale = lr.abs().amax(-1)
    worst = (err / scale).max().item()
    ties = argmax_or_tie(f"{cfg.name} engine vs impl='ref'", le.flatten(0, 1),
                         lr.flatten(0, 1), err.flatten())
    log(f"  the kernel path vs impl='ref' at {L} layers: worst logit err {worst:.4f} "
        f"of |logit| max (tol {tol}), {ties} near ties of {le.shape[0] * 4} picks")
    if worst > tol:
        raise AssertionError(f"{cfg.name}: kernel logits off the reference at {L} layers")
    floor = noise_floor(cfg, params, prompts, feed, lr)
    log(f"  the reference's own noise floor at {L} layers: each request alone against "
        f"the 4-wide batch, up to {floor:.4f} of |logit| max (at most "
        f"{NOISE_FLOOR_MAX}) [{card}]")
    if floor > NOISE_FLOOR_MAX:
        raise AssertionError(f"{cfg.name}: the reference's noise floor {floor:.4f} is "
                             f"above {NOISE_FLOOR_MAX}")
    lap(f"{cfg.name} reference passes and noise floor")
    first = int(eng._off_ids[0, 0, 0])
    scan = "rwkv_state" if cfg.family == Family.SSM else "ssm_state"

    def drop(cache):
        cache[scan][first].zero_()
    eng._buf_views.reverse()
    swapped = engine_forced_logits(eng, params, prompts, feed, steps=1)
    eng._buf_views.reverse()
    dropped = engine_forced_logits(eng, params, prompts, feed, after_prefill=drop,
                                   steps=1)
    faults = []
    for label, lf in (("streamed layers run from the other load buffer", swapped),
                      (f"{scan} of layer {first} (the first streamed) dropped", dropped)):
        n = lf.shape[0]
        faults.append((label, ((lf - lk[:n]).abs().amax(-1)
                               / lk[:n].abs().amax(-1)).max().item(),
                       torch.equal(lf, lk[:n])))
    log("  planted engine faults, rejected by the bit-equality to the model's kernel "
        "path (prefill + 1 step); logit err / |logit| max: "
        + ", ".join(f"{k} {v:.4f}" for k, v, _ in faults)
        + f" (phase 3c's limit {tol} alone would see those above it)")
    missed = [k for k, _, eq in faults if eq]
    if missed or faults[0][1] <= tol:
        raise AssertionError(f"{cfg.name}: planted faults pass {missed or faults[0][0]}")
    lap(f"{cfg.name} planted faults")
    st = eng.seed_cache(eng.init_state(params), eng.prefill(
        torch.from_numpy(np.stack(prompts)).long().cuda())[1])
    tok = torch.from_numpy(feed[:, :1]).cuda()
    passes = sorted(timed_s(lambda: eng.decode_step(st, tok)) for _ in range(3))
    copy_s = streamed / (rate * 1e9)
    log(f"  decode pass (B 4, {L - n_res} of {L} layers streamed): median of 3 "
        f"{passes[1] * 1e3:.2f} ms (min {passes[0] * 1e3:.2f}) against the streamed "
        f"bytes' copy {copy_s * 1e3:.2f} ms at {rate:.2f} GB/s and the cost model's "
        f"T_total {plan.t_total * 1e3:.2f} ms [{card}]")
    pass_profile(eng, st, st["pos"], lambda: eng.decode_step(st, tok), card,
                 f"{cfg.name} decode")
    lap(f"{cfg.name} timed and profiled passes")
    engine_pass_pair(eng, st, tok, card, f"{L - n_res} of {L} layers streamed, the "
                     f"copy {copy_s * 1e3:.2f} ms",
                     prompt=torch.from_numpy(np.stack(prompts)).long().cuda())
    lap(f"{cfg.name} captured against eager passes")
    eng.close()
    if cfg.family == Family.HYBRID:
        engp = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN, paged=True,
                                 page_size=ENGINE_PAGE)
        engp.init_state(params)
        pages = []
        zero_counts()
        srv = LimeServer(cfg, params, engine=engp, max_len=MAX_LEN, pattern="bursty")
        donep, _ = drive_recurrent(srv, prompts, "bursty", max_new=ENGINE_NEW,
                                   after_step=lambda: pages.append(
                                       engp.paged_stats()["pages_in_use"]))
        torch.cuda.synchronize()
        for k, n in read_counts().items():
            got[k] += n
        def per(ctx):            # pages of one slot's table at ctx tokens
            return -(-min(ctx, engp.S_c) // ENGINE_PAGE)
        want = [4 * per(PROMPT_LEN)] + [4 * per(PROMPT_LEN + t)
                                         for t in range(1, ENGINE_NEW - 1)] + [0]
        same = [r.output for r in donep] == [r.output for r in done]
        log(f"  the batch once more through a paged engine (page {ENGINE_PAGE}, "
            f"{engp.page_pool.cfg.device_pages} pages): tokens "
            f"{'equal to' if same else 'DIFFER from'} the unpaged serve's; pages in use "
            f"after each step {pages} (reckoned {want})")
        if not same or pages != want:
            raise AssertionError(f"{cfg.name}: the paged engine serve is off")
        engp.close()
        lap(f"{cfg.name} paged engine serve")
    return got


def recurrent_engine_phase(card):
    """Phase 3f: recurrent_engine_serve for RWKV6-3B, then Hymba-1.5B, each
    on a card holding nothing of the other. Returns the summed launches."""
    import torch
    launches = {}
    for arch in RECURRENT_ARCHS:
        for k, n in recurrent_engine_serve(arch, card).items():
            launches[k] = launches.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------------
# phase 3b: the main path, 80 layers through the engine
# ----------------------------------------------------------------------------
def meminfo():
    out = {}
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024
    for line in pathlib.Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            out["VmRSS"] = int(line.split()[1]) * 1024
    return out


def wait_for_host_memory(need, label, timeout_s=240):
    """Poll MemAvailable until it holds `need` bytes: the card's machine
    hands a closed engine's pinned store back to the system over tens of
    seconds (the process's RSS drops at once). Fails after timeout_s."""
    t0 = time.monotonic()
    first = meminfo()["MemAvailable"]
    while True:
        avail = meminfo()["MemAvailable"]
        waited = time.monotonic() - t0
        if avail >= need:
            log(f"  host memory for {label}: MemAvailable {first / 1e9:.2f} -> "
                f"{avail / 1e9:.2f} GB in {waited:.1f} s (need {need / 1e9:.2f})")
            return
        if waited > timeout_s:
            raise AssertionError(f"host memory for {label}: MemAvailable "
                                 f"{avail / 1e9:.2f} GB after {waited:.0f} s, need "
                                 f"{need / 1e9:.2f}")
        time.sleep(1.0)


def host_mem(label):
    m = meminfo()
    log(f"  host memory {label}: MemAvailable {m['MemAvailable'] / 1e9:.2f} GB, "
        f"this process's RSS {m['VmRSS'] / 1e9:.2f} GB")


def drive(srv, prompts, pattern, n_layers, retier_at=(), scfg=None, host_draft=False,
          max_new=MAX_NEW_80):
    """Serve `prompts` under `pattern` through srv's scheduler (config
    `scfg`, default the reserve policy) one step at a time: each step's mq
    and decode launches must be what the step implies (a prefill round:
    n_layers mq; a speculative round of k drafts: k x live resident layers
    decode + n_layers mq, or with host_draft (n-gram drafts proposed on the
    host) n_layers mq alone; a plain step: n_layers decode), and retier_at's
    (round, delta) moves apply between rounds while requests are live.
    A retier the backend makes itself (an OnlinePlanner's rung or a
    reclaim) lands inside a step before its decode, so the resident count
    is read after the step. Returns (finished requests, stats, launches,
    retiers applied as (round, delta, live), the backend's own retiers as
    (rounds so far, live requests))."""
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.serving import (ContinuousBatchingScheduler, Request,
                                     SchedulerConfig, cli_arrivals)
    be = srv.make_backend()
    eng = srv.engine
    arrivals = cli_arrivals(pattern, len(prompts), prompt_len=PROMPT_LEN,
                            max_new_tokens=max_new, burst_size=srv.slots)
    base = be.now()
    reqs = [Request(i, p, ev.max_new_tokens, arrival_s=base + ev.time_s)
            for i, (ev, p) in enumerate(zip(arrivals, prompts))]
    sched = ContinuousBatchingScheduler(be, scfg or SchedulerConfig())
    sched.begin(reqs)
    n_pf = math.ceil(PROMPT_LEN / PREFILL_CHUNK)
    prefills, applied, fired = 0, [], []
    events = be.adapt_stats["retier_events"]
    mq.launches = da.launches = mq.hopper_launches = da.hopper_launches = 0
    mq.verify_sm90_launches = 0
    while True:
        n_rounds = len(be.rounds)
        m0, d0, h0, hd0 = mq.launches, da.launches, mq.hopper_launches, da.hopper_launches
        v0 = mq.verify_sm90_launches
        if not sched.step():
            break
        res = len(eng.resident_layer_ids())
        if be.adapt_stats["retier_events"] > events:
            events = be.adapt_stats["retier_events"]
            fired.append((len(be.rounds), sum(not r.done for r in reqs)))
        got = (mq.launches - m0, da.launches - d0)
        # prefill rounds (q_len 512) run the Hopper mainloop, verify passes
        # (q_len k + 1) the verify body
        if mq.hopper_launches - h0 != (got[0] if len(be.rounds) == n_rounds else 0):
            raise AssertionError(f"{pattern}: {mq.hopper_launches - h0} Hopper-mainloop "
                                 f"launches in a step of {got[0]} mq launches")
        if mq.verify_sm90_launches - v0 != (got[0] if len(be.rounds) > n_rounds else 0):
            raise AssertionError(f"{pattern}: {mq.verify_sm90_launches - v0} verify-body "
                                 f"launches in a step of {got[0]} mq launches")
        if da.hopper_launches - hd0 != got[1]:
            raise AssertionError(f"{pattern}: {da.hopper_launches - hd0} Hopper decode "
                                 f"launches in a step of {got[1]} decode launches")
        if len(be.rounds) > n_rounds:
            k = be.rounds[-1][0]
            want = (n_layers, 0 if host_draft else k * res) if k else (0, n_layers)
        else:                            # a prefill or an idle jump
            want = got if got in ((0, 0), (n_pf * n_layers, 0)) else None
            prefills += got[0] > 0
        if got != want:
            raise AssertionError(f"{pattern} round {len(be.rounds)}: launches "
                                 f"(mq, decode) {got}, expected {want}")
        live = any(not r.done for r in reqs)
        for at, delta in retier_at:
            if len(be.rounds) == at and (at, delta) not in [x[:2] for x in applied]:
                be.retier(0, delta)
                applied.append((at, delta, live))
    done = sorted(sched.finish_run(), key=lambda r: r.rid)
    if prefills != (1 if pattern == "bursty" else len(prompts)):
        raise AssertionError(f"{pattern}: {prefills} prefill steps")
    return done, sched.stats, (mq.launches, da.launches, mq.hopper_launches,
                               da.hopper_launches, mq.verify_sm90_launches), applied, fired


def reference_check(eng, params, cfg, prompts, got, pattern, also=()):
    """Every served position of each served batch (built as the backend
    builds it: left-pad 0, replica rows inactive) against two greedy
    references on the same engine, without spec and without retier:

    * the plain greedy decode (decode steps, the decode kernel). One verify
      pass over its continuation gives the multi-query path's logits at
      every position and so the two paths' logit error; up to the first
      divergence the served tokens must be this reference's, and a
      divergence must be a near tie (the decode path's gap between the two
      picks within that position's error).
    * the greedy decode through verify passes of the serve's width (k + 1
      positions, the drafts a dummy token), committing column 0 and
      rolling back: each committed token then goes through the arithmetic
      the spec serve used for it (a row's result depends on no other row
      of the pass), so every served token must equal this one exactly.

    `also`: more serves of the same batches (the adaptive serve), held to
    the same references. Returns (positions, near ties, worst err /
    |logit|)."""
    import numpy as np
    import torch

    from repro_torch.serving.backend import EngineBackend
    V = cfg.vocab_size
    T = MAX_NEW_80
    batches = [list(range(len(prompts)))] if pattern == "bursty" \
        else [[i] for i in range(len(prompts))]
    n_pos = n_tie = 0
    worst = 0.0
    for idx in batches:
        n = len(idx)
        toks = EngineBackend._pad_prompts([prompts[i] for i in idx])
        toks = np.concatenate([toks, np.tile(toks[-1:], (eng.mb - n, 1))], 0)
        active = torch.zeros(eng.mb, dtype=torch.bool, device="cuda")
        active[:n] = True
        st = eng.init_state(params)
        lg, st = eng.prefill_partial(st, torch.from_numpy(toks).long().cuda(),
                                     chunk=PREFILL_CHUNK)
        P = st["pos"]
        ld = [lg[:, -1, :V].float()]
        cur = ld[0].argmax(-1, keepdim=True)
        first = cur
        for _ in range(T - 1):
            lg, st = eng.decode_requests(st, cur, active)
            ld.append(lg[:, :V].float())
            cur = torch.where(active[:, None], ld[-1].argmax(-1, keepdim=True), cur)
        ld = torch.stack(ld, 1)                            # (mb, T, V)
        ref = ld.argmax(-1)                                # (mb, T)
        eng.rollback(st, P)
        lv, st = eng.verify_requests(st, ref, active)
        lv = torch.cat([ld[:, :1], lv[:, :T - 1, :V].float()], 1)
        err = (ld - lv).abs().amax(-1)                     # (mb, T)
        rel = err[:n] / ld[:n].abs().amax(-1)
        top2 = ld[:n].topk(2, -1).values
        clear = int(((top2[..., 0] - top2[..., 1]) > err[:n]).sum())
        log(f"  {pattern}: verify pass vs decode path over the reference "
            f"continuation: logit err / |logit| max median "
            f"{rel.median().item():.4f}, max {rel.max().item():.4f}; {clear} of "
            f"{n * T} positions have a decode-path top-2 margin above their err")
        worst = max(worst, rel.max().item())
        # the greedy decode through (k + 1)-wide verify passes
        eng.rollback(st, P)
        cur, vref = first, [first]
        for t in range(T - 1):
            mat = cur.repeat(1, 1 + SPEC_K)
            lg, st = eng.verify_requests(st, mat, active)
            eng.rollback(st, P + t + 1)
            cur = torch.where(active[:, None],
                              lg[:, 0, :V].argmax(-1, keepdim=True), cur)
            vref.append(cur)
        vref = torch.cat(vref, 1)                          # (mb, T)
        for run, j, i in [(run, j, i) for run in (got,) + tuple(also)
                          for j, i in enumerate(idx)]:
            a, b = run[i].output, ref[j].tolist()
            if a != vref[j].tolist():
                t = next(t for t in range(T) if a[t] != vref[j, t].item())
                raise AssertionError(f"{pattern} req {i}: served token {t} is not "
                                     "the (k+1)-wide verify-pass greedy's")
            t_div = next((t for t in range(T) if a[t] != b[t]), T)
            msg = "identical to the decode-path greedy"
            if t_div < T:
                row = ld[j, t_div]
                gap = (row[b[t_div]] - row[a[t_div]]).item()
                if gap > err[j, t_div].item():
                    raise AssertionError(f"{pattern} req {i}: served token {t_div} "
                                         f"diverges from the decode-path greedy "
                                         f"outside a near tie (gap {gap:.4f}, err "
                                         f"{err[j, t_div]:.4f})")
                n_tie += 1
                msg = (f"decode-path greedy up to a near tie at {t_div} (gap "
                       f"{gap:.4f} <= err {err[j, t_div]:.4f})")
            log(f"  {pattern} req {i}: {T} positions equal the verify-pass "
                f"greedy; {msg}")
            n_pos += T
    return n_pos, n_tie, worst


def timed_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def pass_profile(eng, st, P, fn, card, label):
    """Device time by class over one engine pass under torch.profiler:
    GEMMs, the port's attention kernels, H2D copies (the copy engine,
    concurrent with compute), other kernels; and the compute stream's idle
    share of the pass's wall time. The pass fn() leaves the engine's state
    st at position P (eng None: fn is the model path's, nothing to roll
    back)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    by = {"gemm": 0.0, "attention": 0.0, "memcpy_h2d": 0.0, "other": 0.0}
    kern = {}                                    # csrc/ kernel: [µs, launches]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed_s(fn)
    if eng is not None:
        eng.rollback(st, P)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        one_pass(name)
        m = csrc_kernel(name)
        if "memcpy" in name and "htod" in name:
            cls = "memcpy_h2d"
        elif m is not None:
            cls = "attention"
            k = kern.setdefault(m[1], [0.0, 0])
            k[0] += us
            k[1] += e.count
        elif any(x in name for x in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "other"
        by[cls] += us
    compute = by["gemm"] + by["attention"] + by["other"]
    parts = ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in by.items())
    log(f"  profile of one {label} pass: {parts}; compute busy "
        f"{compute / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall, compute idle "
        f"{1 - compute / (wall * 1e6):.1%} [{card}]")
    log("    attention kernels (launches, µs per call): " + ", ".join(
        f"{k} {n}, {us / n:.2f}" for k, (us, n) in sorted(kern.items())))
    return by, wall, kern


def adaptive_trace_check(tracer, done, card, n_layers):
    """Phase 3b's adaptive serve, traced: the Chrome export validates, an
    engine.retier instant lies inside some request's admit..finish window
    (the planner retiered the live engine), the pool's kv.grow instants
    credit the retiered HBM, and the engine.* instants and spans count the
    serve's passes."""
    from repro_torch.obs import to_chrome, validate_chrome
    from repro_torch.obs import trace as tr_ev
    evs = tracer.events()
    problems = validate_chrome(to_chrome(tracer))
    names = {}
    for e in evs:
        names.setdefault((e[tr_ev.EVT_NAME], e[tr_ev.EVT_TRACK]), []).append(e)
    retiers = names.get((tr_ev.ENGINE_RETIER, tr_ev.TRACK_KV), [])
    grows = names.get((tr_ev.KV_GROW, tr_ev.TRACK_KV), [])
    live = [(q.admitted_s, q.finish_s) for q in done]
    while_live = [e for e in retiers
                  if any(a <= e[tr_ev.EVT_TS] <= f for a, f in live)]
    counts = {f"{n}@{track}": len(v) for (n, track), v in sorted(names.items())
              if n.startswith(("engine.", "kv.", "retier"))}
    spans = {n: f"{len(v)} x mean {statistics.mean(e[tr_ev.EVT_DUR] for e in v) * 1e3:.1f} ms"
             for (n, track), v in sorted(names.items()) if track == tr_ev.TRACK_PIPELINE}
    log(f"  adaptive serve traced: {tracer.emitted} events, {tracer.dropped} dropped; "
        f"{counts}; pipeline spans {spans}; engine.retier {[e[tr_ev.EVT_ARGS] for e in retiers]}, "
        f"{len(while_live)} while requests were live; kv.grow "
        f"{[e[tr_ev.EVT_ARGS] for e in grows]} [{card}; {n_layers} layers]")
    if problems or tracer.dropped:
        raise AssertionError(f"3b: the adaptive serve's trace is invalid "
                             f"({problems[:4]}) or dropped {tracer.dropped} events")
    if not while_live or not grows:
        raise AssertionError(f"3b: no engine.retier while requests were live "
                             f"({len(retiers)} retiers) or no kv.grow ({len(grows)})")


def full_model_phase(card):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import (InterleavedEngine, plan_for,
                                         weight_budget)
    from repro_torch.core.capture import CapturedStep
    from repro_torch.core.online_planner import OnlinePlanner
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.launch.serve import HBM_FRAC, cost_env, hetero_plan, measure_h2d
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.models import model as M
    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.serving import LimeServer, SchedulerConfig, summarize
    from repro_torch.specdec import SpecConfig

    base = get_config("llama3.3-70b")
    free, total = torch.cuda.mem_get_info()
    mem = meminfo()
    log(f"phase 3b: free HBM {free / 1e9:.2f} of {total / 1e9:.2f} GB; host "
        f"MemTotal {mem['MemTotal'] / 1e9:.2f} GB, MemAvailable "
        f"{mem['MemAvailable'] / 1e9:.2f} GB [{card}]")
    for depth in range(base.n_layers, MIN_LAYERS - 1, -1):
        cfg = dataclasses.replace(base, n_layers=depth)
        budget = weight_budget(cfg, batch=4, max_len=MAX_LEN, free_bytes=free)
        plan = plan_for(cfg, 1, hbm_frac_for_weights=HBM_FRAC, hbm_bytes=budget)
        eng = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN,
                                retier_headroom=1)
        if eng.streamed_store_bytes + HOST_RESERVE <= mem["MemAvailable"]:
            break
    else:
        raise AssertionError(f"host memory holds the streamed tier of no depth "
                             f">= {MIN_LAYERS}")
    if depth < base.n_layers:
        log(f"DEPTH CUT: {depth} of {base.n_layers} layers (host MemAvailable "
            f"{mem['MemAvailable'] / 1e9:.2f} GB holds no deeper streamed tier)")
    L = cfg.n_layers
    l_bytes = cfg.layer_params() * 2
    n_res = len(eng.resident_layer_ids())
    log(f"  {cfg.name}: {L} layers, full width; weight budget "
        f"{budget / 1e9:.2f} GB x {HBM_FRAC}; plan n_seg {plan.n_seg}, k_res "
        f"{plan.k_res}, k_off {plan.k_off}, retier headroom 1: {n_res} resident "
        f"({n_res * l_bytes / 1e9:.2f} GB), {L - n_res} streamed "
        f"({(L - n_res) * l_bytes / 1e9:.2f} GB), pinned store "
        f"{eng.streamed_store_bytes / 1e9:.2f} GB")
    # the block PyTorch's own pinned allocator takes for one layer (it
    # rounds blocks up; the engine registers plain host memory instead)
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        log(f"  PyTorch's pinned allocator: not measured (torch "
            f"{torch.__version__} has no host_memory_stats)")
    else:
        before = stats().get("allocated_bytes.current", 0)
        probe = torch.empty(eng.layer_numel, dtype=torch.bfloat16,
                            pin_memory=True)
        block = stats().get("allocated_bytes.current", 0) - before
        del probe
        getattr(torch._C, "_host_emptyCache", lambda: None)()
        log(f"  PyTorch's pinned allocator: one {l_bytes / 1e9:.3f} GB layer "
            f"holds a {block / 1e9:.3f} GB block (host_memory_stats)")
    params = M.init_params_by_layer(cfg, seed=0)
    t0 = time.monotonic()
    eng.init_state(params)
    torch.cuda.synchronize()
    store = eng.store
    log(f"  tiers built from the layer source in {time.monotonic() - t0:.1f} s: "
        f"pinned {store.nbytes / 1e9:.2f} GB allocated (cudaHostRegister "
        f"{store.registered}, is_pinned {store.data.is_pinned()}), host "
        f"MemAvailable now {meminfo()['MemAvailable'] / 1e9:.2f} GB, HBM "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    host_mem("after the tiers are built")
    rate = measure_h2d(store.data.flatten(0, 1)) / 1e9
    log(f"  pinned H2D on a side stream: {rate:.2f} GB/s (one-layer copies of "
        f"{l_bytes / 1e9:.3f} GB) [{card}]")
    # the cost model on this card: the H100 profile at the weight budget's
    # resident share and the H2D rate just measured
    env = cost_env(cfg, budget, width=4, prompt_len=PROMPT_LEN, load_bw=rate * 1e9)
    env.evaluate(plan)
    d, w = env.devices[0], env.work
    log(f"  H100 CostEnv: {d.name}, mem {d.mem_bytes / 1e9:.2f} GB (budget x {HBM_FRAC}), "
        f"flops {d.flops / 1e12:.1f} TFLOP/s, mem_bw {d.mem_bw / 1e12:.2f} TB/s, load_bw "
        f"{d.load_bw / 1e9:.2f} GB/s (measured above); one card, no hop (bw_net = "
        f"mem_bw, latency 0); Workload mb 4, ctx {PROMPT_LEN}: layer {w.l_size / 1e9:.3f} "
        f"GB, KV {w.kv_bytes_per_token_layer():.0f} B a token and layer [{card}]")
    log(f"  plan_for's plan priced: T_total {plan.t_total:.4f} s = T_comp "
        f"{plan.t_comp:.4f} + T_comm {plan.t_comm:.2e} + T_uncover {plan.t_uncover:.4f}; "
        f"weights by the reference's formula "
        f"{plan.stages[0].resident_bytes(w, plan.n_seg) / 1e9:.2f} GB against "
        f"{d.mem_bytes / 1e9:.2f} [{card}]")
    a1, _, a1_scale = hetero_plan(cfg, budget, width=4, prompt_len=PROMPT_LEN,
                                  n_emp=PROMPT_LEN, load_bw=rate * 1e9)
    log(f"  Alg. 1 on this env (n_emp {PROMPT_LEN}): scale {a1_scale}, n_seg "
        f"{a1.plan.n_seg}, {dataclasses.astuple(a1.plan.stages[0])} (resident, streamed "
        f"full / attention / MLP a segment), T_total {a1.plan.t_total:.4f} s; "
        f"candidates (n_seg, T_total s): "
        f"{[(n, round(t, 4)) for n, t in a1.candidates]} [{card}]")

    prompts = make_prompts(4, cfg.vocab_size, 0)
    spec = SpecConfig(k=SPEC_K, draft="resident", adapt_k=False)
    launches = {"mq_decode_attention": 0, "decode_attention": 0,
                "mq_decode_attention@prefill": 0, "decode_attention@hopper": 0,
                "mq_decode_attention@verify": 0}
    torch.cuda.reset_peak_memory_stats()
    served = {}
    for pattern, n_req, retier_at in (("bursty", 4, RETIER_AT),
                                      ("sporadic", 2, ())):
        srv = LimeServer(cfg, params, engine=eng, max_len=MAX_LEN,
                         pattern=pattern, spec=spec,
                         prefill_chunk_tokens=PREFILL_CHUNK)
        t0 = time.monotonic()
        done, stats, (m, d, h, hd, vf), applied, _ = drive(
            srv, prompts[:n_req], pattern, L, retier_at)
        wall = time.monotonic() - t0
        launches["mq_decode_attention"] += m
        launches["decode_attention"] += d
        launches["mq_decode_attention@prefill"] += h
        launches["decode_attention@hopper"] += hd
        launches["mq_decode_attention@verify"] += vf
        be = srv.make_backend()
        rep = summarize(done, pattern=pattern, backend="engine", stats=stats)
        spec_rounds = [c for k, c in be.rounds if k]
        g = be.graph_stats
        log(f"  {pattern}, {graph_note(g)} [{card}; {L} layers]")
        log(f"  {pattern}: {rep.n_requests} requests x {MAX_NEW_80} tokens, "
            f"prompt {PROMPT_LEN}: TTFT p50 {rep.ttft_p50_s * 1e3:.1f} ms, p99 "
            f"{rep.ttft_p99_s * 1e3:.1f} ms; decode {1e3 / rep.decode_tok_s_p50:.1f} "
            f"ms/token per request (p50); acceptance {rep.spec_acceptance_rate:.3f} "
            f"({rep.spec_accepted}/{rep.spec_drafted} drafts); "
            f"{len(be.rounds)} rounds, committed per round mean "
            f"{np.mean(spec_rounds):.2f}; launches mq {m} ({vf} verify body), decode {d}; retier "
            f"{applied}; the draft step's graphs: {g['draft_captures']} captured in "
            f"{g['draft_capture_s'] * 1e3:.0f} ms over {1 if pattern == 'bursty' else n_req} epochs, "
            f"{g['draft_replays']} replays, graph pool {g['pool_bytes'] / 2**20:.1f} MiB; "
            f"{wall:.1f} s wall [{card}; {L} layers]")
        # the engine's state is cleared in place between epochs: the draft
        # step is captured again only where a retier moved the tiers
        if not 1 <= g["draft_captures"] <= 1 + sum(abs(a[1]) for a in applied):
            raise AssertionError(f"{pattern}: the draft step was captured "
                                 f"{g['draft_captures']} times ({applied} retiers)")
        if pattern == "bursty" and not (applied and applied[0][2]):
            raise AssertionError("bursty: the retier(+1) did not land mid-serve")
        if eng.demoted(0):               # the serve ended before round 4
            srv.make_backend().retier(0, -eng.demoted(0))
            log("  retier(-1) applied after the serve")
        served[pattern] = done

    # the adaptive bursty serve: paged admission and an OnlinePlanner on
    # this plan; its ladder must retier the live engine
    planner = OnlinePlanner(env, plan, horizon_tokens=4 * 4 * MAX_LEN)
    lad = planner.ladders[0]
    log(f"  adaptive serve: OnlinePlanner ladder of {len(lad)} rungs of "
        f"{planner.chunk} tokens, thresholds "
        f"{sorted({s.threshold_tokens for s in lad})} tokens, first "
        f"{[(s.threshold_tokens, s.alpha, s.beta) for s in lad[:3]]}, last "
        f"{[(s.threshold_tokens, s.alpha, s.beta) for s in lad[-2:]]} (tokens, alpha, "
        f"beta); demote cap min(k_res, headroom) = "
        f"{min(eng.k_res_b[0], eng.H)} slot of {eng.slot_hbm_bytes() / 1e9:.3f} GB")
    srv = LimeServer(cfg, params, engine=eng, max_len=MAX_LEN, pattern="bursty",
                     spec=spec, prefill_chunk_tokens=PREFILL_CHUNK, planner=planner)
    be = srv.make_backend()
    notes, note = [], be.note_kv_pages

    def noted(pages, page_size):
        notes.append((len(be.rounds), pages, pages * page_size))
        note(pages, page_size)
    be.note_kv_pages = noted
    # the flight recorder around this serve (installed before drive builds
    # the scheduler, which binds its clock to the backend's)
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        t0 = time.monotonic()
        done, stats, (m, d, h, hd, vf), _, fired = drive(
            srv, prompts[:4], "bursty", L, scfg=SchedulerConfig(kv_policy="paged",
                                                                 page_size=PAGE))
        wall = time.monotonic() - t0
    finally:
        set_tracer(prev)
    adaptive_trace_check(tracer, done, card, L)
    for key, n in (("mq_decode_attention", m), ("decode_attention", d),
                   ("mq_decode_attention@prefill", h), ("decode_attention@hopper", hd),
                   ("mq_decode_attention@verify", vf)):
        launches[key] += n
    rep = summarize(done, pattern="bursty", backend="engine", stats=stats)
    pool = be._pool
    log(f"  adaptive serve, {graph_note(be.graph_stats)} [{card}; {L} layers]")
    log(f"  adaptive serve: occupancy notes (round, pages, tokens) {notes}; planner "
        f"retiers at (rounds done, live requests) {fired}; retier_events "
        f"{rep.retier_events}, hbm_returned_bytes {rep.hbm_returned_bytes:.0f}, "
        f"layers_streamed_now {stats['layers_streamed_now']}, resident layers "
        f"{len(eng.resident_layer_ids())}; pool {pool.cfg.device_pages} + "
        f"{pool.free_pages() + pool.pages_in_use() - pool.cfg.device_pages} pages of "
        f"{pool.cfg.page_bytes / 1e6:.2f} MB, peak {rep.peak_kv_pages} in use, "
        f"{rep.n_preempted} preempted; {len(be.rounds)} rounds; launches mq {m} ({vf} "
        f"verify body), decode {d}; TTFT p50 {rep.ttft_p50_s * 1e3:.1f} ms, decode "
        f"{1e3 / rep.decode_tok_s_p50:.1f} ms/token (p50); {wall:.1f} s wall "
        f"[{card}; {L} layers]")
    if not fired or not (fired[0][1] > 0 and fired[0][0] < len(be.rounds)):
        raise AssertionError(f"adaptive serve: no planner-driven retier while live ({fired})")
    if rep.retier_events < 1 or stats["layers_streamed_now"] != min(eng.k_res_b[0], eng.H):
        raise AssertionError(f"adaptive serve: retier telemetry {be.adapt_stats}")
    served_adapt = done
    be.retier(0, -eng.demoted(0))        # back to the plan's tier boundary
    if eng.demoted(0) or len(eng.resident_layer_ids()) != n_res:
        raise AssertionError("the tier boundary did not come back")
    log(f"  peak HBM during the serves {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"[{card}]")
    host_mem("after the serves")

    # pass and draft times against the copy time of the streamed bytes
    st = eng.init_state(params)
    toks = torch.from_numpy(np.stack(prompts)).long().cuda()
    lg, st = eng.prefill_partial(st, toks, chunk=PREFILL_CHUNK)
    P = st["pos"]
    cur = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    draft_steps = CapturedStep(eng.device)
    engine_draft_pair(eng, st, cur, card, f"{L} layers, {len(eng.resident_layer_ids())} "
                      "resident", draft_steps)
    mat = torch.cat([cur, toks[:, :SPEC_K]], 1)
    times = {}
    for label, fn in (("draft", lambda: eng.draft_step(st, cur, steps=draft_steps)),
                      ("verify q_len 5", lambda: eng.verify_step(st, mat)),
                      ("decode", lambda: eng.decode_step(st, cur))):
        times[label] = []
        for _ in range(2):
            times[label].append(timed_s(fn))
            eng.rollback(st, P)
    streamed = (L - n_res) * l_bytes
    copy_s = streamed / (rate * 1e9)
    for label, ts in times.items():
        share = "" if label == "draft" else (
            f"; streamed {streamed / 1e9:.1f} GB / {rate:.1f} GB/s = "
            f"{copy_s * 1e3:.0f} ms of copy, {copy_s / min(ts):.1%} of the pass")
        log(f"  one {label} pass: {', '.join(f'{t * 1e3:.1f}' for t in ts)} ms{share} "
            f"[{card}; {L} layers, B 4]")
    log(f"  predicted T_total of plan_for's plan {plan.t_total * 1e3:.1f} ms against "
        f"measured decode {min(times['decode']) * 1e3:.1f} ms, verify "
        f"{min(times['verify q_len 5']) * 1e3:.1f} ms [{card}; {L} layers, B 4]")
    engine_pass_pair(eng, st, cur, card, f"{L} layers, {L - n_res} streamed, the "
                     f"copy {copy_s * 1e3:.0f} ms", n=2)
    eng.rollback(st, P)
    pass_profile(eng, st, P, lambda: eng.decode_step(st, cur), card, "decode")
    pass_profile(eng, st, P, lambda: eng.verify_step(st, mat), card, "verify q_len 5")
    # one chunked-prefill round (q_len 512 from pos 0): kernel 4's prefill
    # regime in serve, and the GEMMs' sustained rate (the profile's flops)
    # (replayed from its CUDA graph, as the serves run it)
    st0 = eng.init_state(params)
    rounds = CapturedStep(eng.device)
    eng.verify_step(st0, toks[:, :PREFILL_CHUNK], steps=rounds)    # captures
    eng.rollback(st0, 0)
    for attempt in (1, 2):           # the profiler now and then loses them all
        by, _, kern = pass_profile(eng, st0, 0, lambda: eng.verify_step(
            st0, toks[:, :PREFILL_CHUNK], steps=rounds), card,
            f"replayed chunked-prefill round (q_len {PREFILL_CHUNK})")
        k4 = kern.get("sm90_attention_kernel")      # kernel 4's prefill regime
        if k4 is not None or attempt == 2:
            break
    if k4 is None or k4[1] != L:
        raise AssertionError(f"prefill round profile: kernel 4's Hopper mainloop {k4}")
    rows = 4 * PREFILL_CHUNK
    flops = 2.0 * rows * (L * cfg.layer_params()
                          + cfg.d_model * (-(-cfg.vocab_size // 256) * 256))
    log(f"  prefill round: kernel 4 (Hopper mainloop) {k4[1]} launches, "
        f"{k4[0] / k4[1]:.2f} µs per "
        f"call; GEMMs {by['gemm'] / 1e3:.2f} ms for {flops / 1e12:.1f} TFLOP = "
        f"{flops / (by['gemm'] * 1e-6) / 1e12:.1f} TFLOP/s, "
        f"{flops / (by['gemm'] * 1e-6) / BF16_PEAK:.3f} of the {BF16_PEAK / 1e12:.1f} "
        f"TFLOP/s bf16 peak [{card}; {L} layers, B 4]")

    log("phase 3b: every served position against the engine's plain greedy decode "
        "(the bursty batch: the scripted and the adaptive serve)")
    for pattern, done in served.items():
        n_req = len(done)
        n_pos, n_tie, worst = reference_check(
            eng, params, cfg, prompts[:n_req], done, pattern,
            also=(served_adapt,) if pattern == "bursty" else ())
        log(f"  {pattern}: {n_pos} positions compared, {n_tie} near ties, worst "
            f"verify-vs-decode logit err {worst:.4f} of |logit| max")
    host_mem("before the engine is closed")
    eng.close()
    gc.collect()
    host_mem("after it is closed")
    return launches, L, {"cfg": cfg, "params": params, "budget": budget,
                         "rate": rate, "prompts": prompts}


# ----------------------------------------------------------------------------
# phase 3d: Alg. 1's plan on the engine (40 of the 80 layers)
# ----------------------------------------------------------------------------
def alg1_phase(card, cfg, params, budget, rate, prompts, phase="3d", ngram=False):
    """The launcher's hetero path at a weight budget and an H2D rate (phase
    3d: phase 3b's): Alg. 1 (n_emp = the prompt length) at the budget's
    resident share, no retier headroom (its pinned store is n_seg
    one-layer slots). Serves the bursty batch `prompts` once (spec k = 4,
    exact launch counts: prefill rounds on the Hopper mainloop, verify
    passes on the verify body) and holds every token to this engine's
    verify-pass greedy; prints the plan, pinned bytes, the H2D rate
    measured on its store and the predicted T_total (at that rate) beside
    the measured decode and verify passes. With ngram, the same engine
    serves the batch once more with n-gram drafts proposed on the host
    (engine.verify_requests on them), held to the same verify-pass greedy.
    Returns the main path's launches."""
    import numpy as np
    import torch

    from repro_torch.core.engine import InterleavedEngine
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.launch.serve import HBM_FRAC, cost_env, hetero_plan, measure_h2d
    from repro_torch.serving import LimeServer, summarize
    from repro_torch.specdec import SpecConfig

    gc.collect()
    torch.cuda.empty_cache()
    host_mem(f"at phase {phase}")
    L, l_bytes = cfg.n_layers, cfg.layer_params() * 2
    r, env, scale = hetero_plan(cfg, budget, width=4, prompt_len=PROMPT_LEN,
                                n_emp=PROMPT_LEN, load_bw=rate * 1e9)
    plan = r.plan
    if scale != 1.0:
        raise AssertionError(f"Alg. 1 relaxed the card's memory x{scale}")
    eng = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN, retier_headroom=0)
    n_res = len(eng.resident_layer_ids())
    mem = meminfo()
    log(f"phase {phase}: {cfg.name}, Alg. 1's plan at a {budget / 1e9:.2f} GB weight "
        f"budget, {L} layers: n_seg {plan.n_seg}, "
        f"{dataclasses.astuple(plan.stages[0])} (resident, streamed full / attention / "
        f"MLP a segment), off_trim {plan.off_trim}; laid out on the engine's grid "
        f"(k_res {plan.k_res}, k_off {plan.k_off}, {plan.n_layers} slots, the last "
        f"segments' resident slot empty): {n_res} "
        f"resident ({n_res * l_bytes / 1e9:.2f} GB of the {budget * HBM_FRAC / 1e9:.2f} GB "
        f"share), {L - n_res} streamed; pinned store {eng.streamed_store_bytes / 1e9:.2f} "
        f"GB (host MemAvailable {mem['MemAvailable'] / 1e9:.2f} GB); predicted T_total "
        f"{plan.t_total:.4f} s = T_comp {plan.t_comp:.4f} + T_comm {plan.t_comm:.2e} + "
        f"T_uncover {plan.t_uncover:.4f} at {rate:.2f} GB/s [{card}]")
    if n_res != plan.stages[0].resident_total:
        raise AssertionError(f"the engine lays out {n_res} resident layers, Alg. 1 "
                             f"chose {plan.stages[0].resident_total}")
    if n_res * l_bytes > budget * HBM_FRAC:
        raise AssertionError("the plan's layout holds more resident bytes than the share")
    wait_for_host_memory(eng.streamed_store_bytes + HOST_RESERVE,
                         "Alg. 1's streamed tier")
    t0 = time.monotonic()
    eng.init_state(params)
    torch.cuda.synchronize()
    log(f"  tiers built in {time.monotonic() - t0:.1f} s: pinned "
        f"{eng.store.nbytes / 1e9:.2f} GB, HBM allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB [{card}]")
    rate_here = measure_h2d(eng.store.data.flatten(0, 1)) / 1e9
    cost_env(cfg, budget, width=4, prompt_len=PROMPT_LEN,
             load_bw=rate_here * 1e9).evaluate(plan)
    log(f"  pinned H2D on a side stream from this store: {rate_here:.2f} GB/s (one-layer "
        f"copies of {l_bytes / 1e9:.3f} GB); the plan priced at it: T_total "
        f"{plan.t_total:.4f} s = T_comp {plan.t_comp:.4f} + T_uncover "
        f"{plan.t_uncover:.4f} [{card}]")
    rate = rate_here
    srv = LimeServer(cfg, params, engine=eng, max_len=MAX_LEN, pattern="bursty",
                     spec=SpecConfig(k=SPEC_K, draft="resident", adapt_k=False),
                     prefill_chunk_tokens=PREFILL_CHUNK)
    t0 = time.monotonic()
    done, stats, (m, d, h, hd, vf), _, _ = drive(srv, prompts[:4], "bursty", L)
    wall = time.monotonic() - t0
    rep = summarize(done, pattern="bursty", backend="engine", stats=stats)
    be = srv.make_backend()
    log(f"  bursty: 4 requests x {MAX_NEW_80} tokens: TTFT p50 {rep.ttft_p50_s * 1e3:.1f} "
        f"ms; decode {1e3 / rep.decode_tok_s_p50:.1f} ms/token per request (p50); "
        f"{len(be.rounds)} rounds; launches mq {m} ({vf} verify body), decode {d}; "
        f"{wall:.1f} s wall [{card}; {cfg.name}, {L} layers]")
    st = eng.init_state(params)
    toks = torch.from_numpy(np.stack(prompts[:4])).long().cuda()
    lg, st = eng.prefill_partial(st, toks, chunk=PREFILL_CHUNK)
    P = st["pos"]
    cur = lg[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    mat = torch.cat([cur, toks[:, :SPEC_K]], 1)
    times = {}
    for label, fn in (("verify q_len 5", lambda: eng.verify_step(st, mat)),
                      ("decode", lambda: eng.decode_step(st, cur))):
        times[label] = []
        for _ in range(2):
            times[label].append(timed_s(fn))
            eng.rollback(st, P)
        log(f"  one {label} pass: {', '.join(f'{t * 1e3:.1f}' for t in times[label])} "
            f"ms [{card}; {cfg.name}, {L} layers, B 4]")
    log(f"  predicted T_total {plan.t_total * 1e3:.1f} ms against measured decode "
        f"{min(times['decode']) * 1e3:.1f} ms, verify {min(times['verify q_len 5']) * 1e3:.1f} "
        f"ms; streamed {(L - n_res) * l_bytes / 1e9:.1f} GB / {rate:.1f} GB/s = "
        f"{(L - n_res) * l_bytes / (rate * 1e6):.0f} ms of copy [{card}; {cfg.name}, {L} layers, B 4]")
    # kernel 4's µs per call in serve: a verify pass, a chunked-prefill round
    pass_profile(eng, st, P, lambda: eng.verify_step(st, mat), card,
                 f"{cfg.name} verify q_len 5")
    st0 = eng.init_state(params)
    pass_profile(eng, st0, 0, lambda: eng.verify_step(st0, toks[:, :PREFILL_CHUNK]),
                 card, f"{cfg.name} chunked-prefill round (q_len {PREFILL_CHUNK})")
    also = ()
    if ngram:
        srv = LimeServer(cfg, params, engine=eng, max_len=MAX_LEN, pattern="bursty",
                         spec=SpecConfig(k=SPEC_K, draft="ngram"),
                         prefill_chunk_tokens=PREFILL_CHUNK)
        t0 = time.monotonic()
        ng, stats, (m2, d2, h2, hd2, vf2), _, _ = drive(srv, prompts[:4], "bursty", L,
                                                         host_draft=True)
        rep = summarize(ng, pattern="bursty", backend="engine", stats=stats)
        be = srv.make_backend()
        log(f"  bursty, n-gram drafts on the host: acceptance "
            f"{rep.spec_acceptance_rate:.3f} ({rep.spec_accepted}/{rep.spec_drafted}); "
            f"{len(be.rounds)} rounds, committed {[c for _, c in be.rounds]}; launches mq "
            f"{m2} ({vf2} verify body), decode {d2}; decode "
            f"{1e3 / rep.decode_tok_s_p50:.1f} ms/token per request (p50); "
            f"{time.monotonic() - t0:.1f} s wall [{card}; {cfg.name}, {L} layers]")
        m, d, h, hd, vf = m + m2, d + d2, h + h2, hd + hd2, vf + vf2
        also = (ng,)
    n_pos, n_tie, worst = reference_check(eng, params, cfg, prompts[:4], done, "bursty",
                                          also)
    log(f"  bursty: {n_pos} positions compared, {n_tie} near ties, worst "
        f"verify-vs-decode logit err {worst:.4f} of |logit| max [{cfg.name}]")
    eng.close()
    return {"mq_decode_attention": m, "decode_attention": d,
            "mq_decode_attention@prefill": h, "decode_attention@hopper": hd,
            "mq_decode_attention@verify": vf}


def _leaves(t):
    for v in t.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ----------------------------------------------------------------------------
# phase 3e: the paper's other Tab. III models, StableLM-2-12B, Pixtral-12B
# ----------------------------------------------------------------------------
# Alg. 1's weight budgets on one H100 (the launcher's --hbm-bytes): LLaMA-
# 2-13B's offloading plans are feasible at few budgets (one streamed layer
# a segment fits its memory formula): 22e9 keeps 28 of 40 layers resident
# and streams 12 (n_seg 12); Qwen3-32B at 40e9 keeps 36 of 64 and streams
# 28 (27.3 GB pinned)
TAB3_BUDGETS = (("llama2-13b", 22e9), ("qwen3-32b", 40e9))
TAB3_CUT = 8               # StableLM-2-12B and Pixtral-12B: 8 of 40 layers
# LLaMA-2-13B on the single-device path: 20 of 40 layers (all 40 took
# ~125 s of 3e's 259.6 s when the script took 1307 s on the slow host of
# RECURRENT_LAYERS' note; Alg. 1's engine below serves all 40)
TAB3_SINGLE = 20
# LLaMA-2-13B's 40 layers on the single-device path: depth carries one
# flipped bf16 ulp on to a large share of |logit| max on random weights.
# On the H100 the kernel path read 0.167 of |logit| max against the
# reference at 40 layers, the reference against itself at another batch
# shape 0.081, the engine's decode path against its verify path 0.128
# (LLaMA-2) and 0.147 (Qwen3, 64 layers); a prefill that loses layer 0's
# K/V or every layer's V reads 1.83-1.92, and must read above the limit
TAB3_LOGIT_REL_TOL = 0.25
# The reference's own noise floor at each 3e depth (each bursty request
# fed alone against the 4-wide batch: only the GEMMs' batch shape
# changes), as 3c's NOISE_FLOOR_MAX: a floor above it means the shared
# model code moved, which TAB3_LOGIT_REL_TOL (3x the floor) could hide.
# The card read 0.0808 for LLaMA-2-13B at 40 layers and 0.0152 for
# StableLM-2-12B at 8 (H100 80GB HBM3, 700 W, the same in three calls)
TAB3_NOISE_FLOOR_MAX = {"llama2-13b": 0.10, "stablelm-12b": 0.03}
PIXTRAL_PATCHES, PIXTRAL_TEXT, PIXTRAL_STEPS = 256, 256, 16


def tab3_phase(card, rate):
    """Phase 3e: LLaMA-2-13B at TAB3_SINGLE of its 40 layers on the
    single-device path; LLaMA-2-13B (all 40 layers) and Qwen3-32B (all
    64) through Alg. 1's engine at TAB3_BUDGETS (H2D rate `rate` for the
    planning, phase 3b's);
    StableLM-2-12B (parallel blocks, head_dim 160) at 8 layers on the
    single-device path; Pixtral-12B's patch prefill at 8 layers. Returns
    {row key: launches} of kernels 1, 2 and 4 at these shapes (the keys
    of kernel_phase's rows) and the summed main-path launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    shapes, launches = {}, {}

    def add(got):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    cfg = dataclasses.replace(get_config("llama2-13b"), n_layers=TAB3_SINGLE)
    t0 = time.monotonic()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"phase 3e: {cfg.name} (Tab. III row 1) on the single-device path at full width, "
        f"DEPTH CUT to {cfg.n_layers} of {get_full_layers(cfg)} layers (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} kv heads: G 1, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B params in "
        f"{time.monotonic() - t0:.1f} s [{card}]")
    got = single_device_checks(cfg, params, card, "3e", tol=TAB3_LOGIT_REL_TOL,
                               faults=True)
    add(got)
    shapes["decode_attention@llama2"] = got["decode_attention"]
    layer_errors(cfg, params, make_prompts(4, cfg.vocab_size, 0), card, cfg.name)
    del params
    fresh()
    for arch, budget in TAB3_BUDGETS:
        cfg = get_config(arch)
        got = alg1_phase(card, cfg, M.init_params_by_layer(cfg, seed=0), budget, rate,
                         make_prompts(4, cfg.vocab_size, 0), phase="3e",
                         ngram=arch == "llama2-13b")
        add(got)
        if arch == "llama2-13b":
            shapes["decode_attention@llama2"] += got["decode_attention"]
            shapes["mq_decode_attention@llama2"] = got["mq_decode_attention@verify"]
        fresh()
    cfg = dataclasses.replace(get_config("stablelm-12b"), n_layers=TAB3_CUT)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    log(f"phase 3e: {cfg.name} (parallel blocks: no ln2, head_dim {cfg.head_dim}) on the "
        f"single-device path at full width, depth cut to {cfg.n_layers} of "
        f"{get_full_layers(cfg)} layers: the non-Hopper attention bodies [{card}]")
    got = single_device_checks(cfg, params, card, "3e", hopper=False, faults=True)
    add(got)
    shapes["decode_attention@dh160"] = got["decode_attention"]
    shapes["flash_attention@dh160"] = got["flash_attention"]
    del params
    fresh()
    add(pixtral_check(card))
    fresh()
    return shapes, launches


def pixtral_check(card):
    """Pixtral-12B's backbone at full width, TAB3_CUT layers, at the model
    level: prefill of PIXTRAL_PATCHES random patch embeddings followed by a
    PIXTRAL_TEXT-token prompt (B 4), then PIXTRAL_STEPS decode steps, the
    kernel path against impl="ref" on the card (both fed the reference's
    picks): argmax equal or a near tie, logits within LOGIT_REL_TOL of
    |logit| max; the patches move the logits; every launch on the Hopper
    bodies. Returns the launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("pixtral-12b"), n_layers=TAB3_CUT)
    V, L = cfg.vocab_size, cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen)
    patches = torch.randn((4, PIXTRAL_PATCHES, cfg.d_model), generator=gen,
                          device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, V, (4, PIXTRAL_TEXT))).long().cuda()
    log(f"phase 3e: {cfg.name} ({cfg.family.value}) backbone at full width, depth cut "
        f"to {L} of {get_full_layers(cfg)} layers: prefill of {PIXTRAL_PATCHES} patch "
        f"embeddings + {PIXTRAL_TEXT} text tokens (B 4), {PIXTRAL_STEPS} decode steps, "
        f"kernel path vs impl='ref' [{card}]")
    zero_counts()
    out = {}
    for impl in ("ref", "kernel"):
        cache = M.init_cache(cfg, 4, MAX_LEN)
        lg, cache = M.prefill(cfg, params, toks, cache, frontend_embeds=patches, impl=impl)
        if cache["pos"] != PIXTRAL_PATCHES + PIXTRAL_TEXT:
            raise AssertionError(f"pixtral: prefill left pos {cache['pos']}")
        out[impl] = (lg[:, -1, :V].float(), cache)
    bare, _ = M.prefill(cfg, params, toks, M.init_cache(cfg, 4, MAX_LEN), impl="ref")
    moved = (bare[:, -1, :V].float() - out["ref"][0]).abs().max().item()
    (lr, cr), (lk, ck) = out["ref"], out["kernel"]
    worst, ties = 0.0, 0
    for t in range(PIXTRAL_STEPS + 1):
        err, scale = (lk - lr).abs().max().item(), lr.abs().max().item()
        worst = max(worst, err / scale)
        if err > LOGIT_REL_TOL * scale:
            raise AssertionError(f"pixtral position {t}: kernel logits off the reference")
        ties += argmax_or_tie(f"pixtral position {t}", lk, lr, err)
        if t == PIXTRAL_STEPS:
            break
        nxt = lr.argmax(-1, keepdim=True)
        lg, cr = M.decode_step(cfg, params, cr, nxt, impl="ref")
        lr = lg[:, -1, :V].float()
        lg, ck = M.decode_step(cfg, params, ck, nxt, impl="kernel")
        lk = lg[:, -1, :V].float()
    torch.cuda.synchronize()
    got = read_counts()
    want = {"flash_attention": L, "flash_attention@hopper": L,
            "decode_attention": L * PIXTRAL_STEPS,
            "decode_attention@hopper": L * PIXTRAL_STEPS}
    log(f"  {4 * (PIXTRAL_STEPS + 1)} positions: worst logit err {worst:.4f} of |logit| max "
        f"(tol {LOGIT_REL_TOL}), {ties} near ties; without the patches the last "
        f"prompt logits move by {moved:.3f}; launches "
        f"{ {k: got[k] for k in want} } [{card}; {L} layers]")
    if {k: got[k] for k in want} != want or any(
            got[k] for k in got if k not in want):
        raise AssertionError(f"pixtral: launches {got}, expected {want}")
    if moved <= LOGIT_REL_TOL * out["ref"][0].abs().max().item():
        raise AssertionError("pixtral: the patch embeddings do not reach the logits")
    return want


# ----------------------------------------------------------------------------
# phase 3g: the MoE family (DeepSeekMoE-16B, Kimi-K2)
# ----------------------------------------------------------------------------
MOE_ARCH, KIMI_ARCH = "deepseek-moe-16b", "kimi-k2-1t-a32b"
# DeepSeekMoE-16B on the single-device path: 14 of 28 layers (all 28 took
# ~98 s of 3g's 147.7 s when the script took 1307 s on the slow host of
# RECURRENT_LAYERS' note; the folded engine serves all 28)
MOE_SINGLE = 14
KIMI_LAYERS = 2           # Kimi-K2: its dense layer 0 and one MoE layer of 61
MOE_NEW = 8               # tokens per request in the folded engine's and Kimi's serves
# the folded engine's --hbm-bytes: plan_for keeps 12 of the 28 packed layers
# (1.18 GB each) resident and streams 16 (2 segments of 6 + 8)
MOE_ENGINE_HBM = 16e9
MOE_RETIER_AT = ((2, +1),)        # (after decode round, delta): one live retier
# Limits of phase 3g, fixed before its first chip call. On DeepSeekMoE-16B as
# the reference initialises it, layer 0's stack of one draws at std 1 (the
# stacked fan-in quirk), so its output (~1.5e5 rms) dominates the residual
# and the 27 MoE layers (std 1/sqrt(27)) add ~2% of it: the logits sit
# within a few bf16 ulps of each other whatever the MoE layers do. At the
# full width, cut to layer 0 + 2 MoE layers on a CPU (the kernels' plain
# versions), the kernel path read 0.0068 of |logit| max against "ref", the
# reference alone against its 4-wide batch 0.0070, and every planted MoE
# fault 0.0070-0.0075: one logit ulp. So the logit limit and the floor
# (3e's dense 40 layers read 0.167 and 0.081) bound the drift and the
# shared code, and the planted faults are read where they act: every MoE
# call of the served path is held to a plain MoE layer (moe_plain) on the
# same input, each token's output within MOE_LAYER_REL of its largest
# |value|. The served layer rounds its combine to bf16 after each of its K
# adds and once more for the shared experts, and runs its experts as
# batched products; the plain one sums in fp32 and runs each expert alone:
# up to (K + 1) / 2 + 1 ulps of a row's largest value (2^-8..2^-7 each;
# 5.5 ulps, 0.043, at Kimi-K2's K 8). A flipped route moves a token by an
# expert's share (~1/K of its routed output); at the smoke width on a CPU
# (E 4, K 2) the faults read 0.55-1.35 and the clean layers 0.0152.
MOE_LOGIT_REL_TOL = 0.10
MOE_NOISE_FLOOR_MAX = 0.10
MOE_LAYER_REL = 2.0 ** -4


def _alloc_stack(specs, n):
    import torch
    return {k: (_alloc_stack(v, n) if isinstance(v, dict) else
                torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device="cuda"))
            for k, v in specs.items()}


def _draw_layer(specs, out, j, gen, scale):
    """Layer j of the stack `out` drawn from `gen` as init_params draws it
    (normal x `scale`, the stack's 1/sqrt(n); "small" leaves 0.01 x N(0, 1);
    zeros left zero), in slices of at most 2^28 elements: no fp32 copy of a
    whole leaf (Kimi-K2's expert leaves hold 5.6e9 elements)."""
    import torch
    for k in sorted(specs):
        s = specs[k]
        if isinstance(s, dict):
            _draw_layer(s, out[k], j, gen, scale)
            continue
        if s.init == "zeros":
            continue
        sc = 0.01 if s.init == "small" else scale
        t = out[k][j]
        t2 = t.reshape(t.shape[0], -1) if t.dim() > 1 else t.reshape(1, -1)
        rows = max(1, (1 << 28) // t2.shape[1])
        for i in range(0, t2.shape[0], rows):
            part = t2[i:i + rows]
            part.copy_(torch.randn(part.shape, generator=gen, dtype=torch.float32,
                                   device="cuda").mul_(sc))


def moe_params(cfg, seed=0):
    """cfg's parameters on the card in the reference's layout (an MoE
    config's first_dense_layers stacked as "dense_layers", the rest as
    "layers"), each layer from its own seed with init_params'
    distributions (the stacked fan-in quirk: a stack of n at 1/sqrt(n));
    the shared weights as init_params_by_layer draws them."""
    import torch

    from repro_torch.models import model as M
    params = {k: v for k, v in M.init_params_by_layer(cfg, seed=seed).items()
              if k != "layers"}
    nd = M.n_dense_first(cfg)
    for key, lo, hi in (("dense_layers", 0, nd), ("layers", nd, cfg.n_layers)):
        if hi == lo:
            continue
        specs = M.layer_specs(cfg, lo)
        params[key] = _alloc_stack(specs, hi - lo)
        for l in range(lo, hi):
            gen = torch.Generator(device="cuda").manual_seed((seed + 1) * 1_000_003 + l)
            _draw_layer(specs, params[key], l - lo, gen, (hi - lo) ** -0.5)
    torch.cuda.synchronize()
    return params


@contextlib.contextmanager
def _patched(mod, name, fn):
    old = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, old)


def moe_faults():
    """Planted MoE faults, each a patch of models/moe.py: [(label, (module,
    attribute, replacement))]."""
    import torch

    from repro_torch.models import moe
    fwd, route, cap = moe.moe_forward, moe._route, moe.capacity

    def cap_from_b(p, x, **kw):
        with _patched(moe, "capacity", lambda n, k, e, cf: cap(x.shape[0], k, e, cf)):
            return fwd(p, x, **kw)

    def no_renorm(router, x, k):
        w, i, p = route(router, x, k)
        return p.gather(-1, i), i, p

    def bf16_router(router, x, k):
        probs = torch.softmax((x.to(torch.bfloat16) @ router.to(torch.bfloat16)).float(), -1)
        w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, i = w[:, :k], i[:, :k]
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), i, probs

    def no_shared(p, x, **kw):
        return fwd({k: v for k, v in p.items() if k != "shared"}, x, **kw)
    return [("capacity from B, not B*S, in the prefill", (moe, "moe_forward", cap_from_b)),
            ("top-k weights not renormalised", (moe, "_route", no_renorm)),
            ("the router product in bf16", (moe, "_route", bf16_router)),
            ("the shared experts dropped", (moe, "moe_forward", no_shared))]


@contextlib.contextmanager
def moe_calls():
    """The routes of every MoE layer call in the block, in call order:
    [(ids (T, K),)]."""
    from repro_torch.models import moe
    calls = []
    route = moe._route

    def rec(router, x, k):
        w, i, p = route(router, x, k)
        calls.append((i.clone(),))
        return w, i, p
    with _patched(moe, "_route", rec):
        yield calls


def route_flips(a, b, n_moe):
    """Tokens whose top-k differs between two runs' MoE calls (the same
    calls in the same order: a prefill's n_moe, then n_moe a decode step),
    per MoE layer: (prefill counts, decode counts summed over the steps,
    routes per layer of a prefill, of all decode steps)."""
    pre, dec = [0] * n_moe, [0] * n_moe
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} MoE calls against {len(b)}")
    for c, ((ia,), (ib,)) in enumerate(zip(a, b)):
        n = int((ia != ib).any(-1).sum())
        (pre if c < n_moe else dec)[c % n_moe] += n
    per_pre = a[0][0].shape[0]
    per_dec = sum(ia.shape[0] for ia, in a[n_moe::n_moe])
    return pre, dec, per_pre, per_dec


def layer_errors(cfg, params, prompts, card, label):
    """ROADMAP §C.1 item 2: the hidden state after each layer, the kernel
    path against impl="ref", over one prefill of the bursty batch and the
    decode step after it (fed the reference's pick). Per layer: the
    accumulated error (each path on its own state) and the layer's own
    (the reference's body run on the kernel path's input: what this
    layer's kernels add), each as ||x_k - x_r|| / ||x_r|| over the layer's
    output; for MoE layers also the tokens whose routes differ (own /
    accumulated). Logs the table; returns {phase: [(acc, own, own flips,
    acc flips)]}."""
    import torch

    from repro_torch.configs.base import Family
    from repro_torch.models import model as M
    from repro_torch.models.modules import rms_norm, unembed
    from repro_torch.serving.backend import EngineBackend
    toks = torch.from_numpy(EngineBackend._pad_prompts(prompts)).long().cuda()
    B, L, V = toks.shape[0], cfg.n_layers, cfg.vocab_size
    win = M.layer_windows(cfg, L)
    caches = {i: M.init_cache(cfg, B, MAX_LEN) for i in ("kernel", "ref")}
    own = M.init_cache(dataclasses.replace(cfg, n_layers=1), B, MAX_LEN)
    moe = cfg.family == Family.MOE

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def flips(a, b):
        return sum(int((x[0] != y[0]).any(-1).sum()) for x, y in zip(a, b))

    out, tok = {}, None
    for phase in ("prefill", "decode"):
        src = toks if phase == "prefill" else tok
        x = {i: M.embed(params, src).to(torch.bfloat16) for i in caches}
        pos = {i: torch.full((), caches[i]["pos"], dtype=torch.int32, device="cuda")
               for i in caches}
        slot = {i: M.new_positions(caches[i], 1, pos[i]) for i in caches} \
            if phase == "decode" else None
        rows = []
        for l in range(L):
            p = M.layer_params(params, l)
            res = {}
            for run, impl, cache, li, inp in (
                    ("kernel", "kernel", caches["kernel"], l, x["kernel"]),
                    ("own", "ref", own, 0, x["kernel"]),
                    ("ref", "ref", caches["ref"], l, x["ref"])):
                if run == "own" and phase == "decode":
                    own["k"][0].copy_(caches["kernel"]["k"][l])
                    own["v"][0].copy_(caches["kernel"]["v"][l])
                    own["pos_ids"], own["pos"] = caches["kernel"]["pos_ids"], \
                        caches["kernel"]["pos"]
                with moe_calls() as calls:
                    if phase == "prefill":
                        y = M.prefill_layer(cfg, p, inp, cache, li, win[l], impl=impl)
                    else:
                        i = "ref" if run == "ref" else "kernel"
                        y = M.step_layer(cfg, p, inp, cache, li, slot[i], pos[i], win[l],
                                         impl=impl)
                res[run] = (y, calls)
            rows.append((rel(res["kernel"][0], res["ref"][0]),
                         rel(res["kernel"][0], res["own"][0]),
                         flips(res["kernel"][1], res["own"][1]),
                         flips(res["kernel"][1], res["ref"][1])))
            x = {"kernel": res["kernel"][0], "ref": res["ref"][0]}
        for i, cache in caches.items():
            if phase == "prefill":
                M.prefill_positions(cache, toks.shape[1])
            else:
                cache["pos"] += 1
        lg = {i: unembed(params, rms_norm(x[i][:, -1:], params["final_norm"],
                                          cfg.norm_eps))[:, 0, :V].float() for i in x}
        lerr = ((lg["kernel"] - lg["ref"]).abs().amax(-1)
                / lg["ref"].abs().amax(-1)).max().item()
        tok = lg["ref"].argmax(-1, keepdim=True)
        acc = [r[0] for r in rows]
        own_e = [r[1] for r in rows]
        worst = max(range(L), key=lambda i: own_e[i])
        log(f"  layer by layer, {label} {phase} (B {B}): ||x_kernel - x_ref|| / ||x_ref|| "
            f"after each layer {[round(a, 4) for a in acc]}; each layer's own (the "
            f"reference's body on the kernel path's input) {[round(a, 4) for a in own_e]}"
            + (f"; routes that differ, own {[r[2] for r in rows]}, accumulated "
               f"{[r[3] for r in rows]}" if moe else "")
            + f"; largest own error at layer {worst} ({own_e[worst]:.4f}, the median "
            f"{statistics.median(own_e):.4f}); last-token logit err {lerr:.4f} of "
            f"|logit| max [{card}]")
        out[phase] = rows
    return out


def moe_plain(p, x, cfg, capacity_factor=1.25, chunk=16):
    """A plain MoE layer for the card's checks, x (T, D) -> (T, D): the
    router's fp32 logits, softmax, the first top_k of a stable descending
    sort, renormalised; expert e keeps the tokens that chose it up to the
    first `capacity` in token order (a token takes one slot an expert);
    every expert's MLP on every token (`chunk` experts at a time), summed
    in fp32 with the kept weights; the shared experts added."""
    import torch
    import torch.nn.functional as F
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"].float(), -1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :K], ids[:, :K]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(1, int(T * K / E * capacity_factor + 0.999))
    chosen = torch.zeros((T, E), dtype=torch.bool, device=x.device).scatter_(1, ids, True)
    kept = chosen & (chosen.long().cumsum(0) <= cap)
    wk = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter_(1, ids, w) * kept
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e0 in range(0, E, chunk):
        e1 = min(e0 + chunk, E)
        xe = x.expand(e1 - e0, T, D)
        y = torch.bmm(F.silu(torch.bmm(xe, p["wi_gate"][e0:e1]))
                      * torch.bmm(xe, p["wi_up"][e0:e1]), p["wo"][e0:e1])
        out += (wk[:, e0:e1].t()[:, :, None] * y.float()).sum(0)
    out = out.to(x.dtype)
    if "shared" in p:
        sh = p["shared"]
        out = out + (F.silu(x @ sh["wi_gate"]) * (x @ sh["wi_up"])) @ sh["wo"]
    return out


@contextlib.contextmanager
def moe_io():
    """Every MoE layer call in the block, in call order: (its parameters,
    input (T, D), output (T, D)), wrapping whatever models/moe.py holds on
    entry (a planted fault included)."""
    from repro_torch.models import moe
    calls = []
    fwd = moe.moe_forward

    def rec(p, x, **kw):
        out, aux = fwd(p, x, **kw)
        calls.append((p, x.reshape(-1, x.shape[-1]), out.reshape(-1, out.shape[-1])))
        return out, aux
    with _patched(moe, "moe_forward", rec):
        yield calls


def moe_layer_errors(cfg, calls):
    """Per MoE call: the largest over its tokens of |out - moe_plain| / the
    plain row's largest |value|."""
    errs = []
    for p, x, out in calls:
        ref = moe_plain(p, x, cfg).float()
        errs.append(((out.float() - ref).abs().amax(-1)
                     / ref.abs().amax(-1).clamp_min(1e-30)).max().item())
    return errs


def moe_fault_check(cfg, params, prompts, feed, card):
    """The served MoE layers and the planted MoE faults (moe_faults), on the
    kernel path's prefill and first decode step of the bursty batch: every
    MoE call's output held to moe_plain on the same input within
    MOE_LAYER_REL (each token's row); each fault must break it at some
    call. The faults' logit errors against impl="ref" are printed beside
    (on this config they read within a few ulps of the clean path's)."""
    def run(fault=None):
        with contextlib.ExitStack() as stack:
            if fault is not None:
                stack.enter_context(_patched(*fault))
            calls = stack.enter_context(moe_io())
            lg = forced_logits(cfg, params, prompts, feed[:, :1], 4, "kernel")
        return lg, moe_layer_errors(cfg, calls)
    lr = forced_logits(cfg, params, prompts, feed[:, :1], 4, "ref")
    scale = lr.abs().amax(-1)
    lk, clean = run()
    clean_logit = ((lk - lr).abs().amax(-1) / scale).max().item()
    res = []
    for label, fault in moe_faults():
        lf, errs = run(fault)
        res.append((label, max(errs), ((lf - lr).abs().amax(-1) / scale).max().item()))
    log(f"  MoE layers against moe_plain on their served inputs (prefill + 1 decode step, "
        f"{len(clean)} calls): worst token err {max(clean):.4f} of its largest |value| "
        f"(limit {MOE_LAYER_REL:.4f}; median call {statistics.median(clean):.4f}); logit "
        f"err against 'ref' {clean_logit:.4f}. Planted faults (worst MoE-layer err, logit "
        f"err of |logit| max against 'ref'): "
        + ", ".join(f"{k} {o:.4f} / {g:.4f}" for k, o, g in res) + f" [{card}]")
    if max(clean) > MOE_LAYER_REL:
        raise AssertionError(f"{cfg.name}: served MoE layers off moe_plain ({max(clean):.4f})")
    missed = [k for k, o, _ in res if o <= MOE_LAYER_REL]
    if missed:
        raise AssertionError(f"{cfg.name}: the MoE layer limit passes planted faults "
                             f"{missed}")
    return clean, res


def moe_spec_check(cfg, params, card, base):
    """One n-gram speculative serve (k SPEC_K) of the bursty batch on the
    single-device path, with exact launch counts (kernel 4's verify body,
    G 1): every served token is the kernel path's pick of its verify (or
    decode) call, and that pick is the reference's on the same calls
    replayed through impl="ref" (the same rows: MoE capacity counts every
    drafted row), or a near tie. The positions where the served tokens
    leave the decode-path serve `base` are counted and printed. Returns
    the serve's launches."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving import EngineBackend, summarize
    from repro_torch.specdec import SpecConfig
    prompts, plain = base
    V = cfg.vocab_size
    calls = []

    def rec(fn, kind):
        def wrapped(cfg_, params_, cache, tokens, **kw):
            pos = cache["pos"]
            lg, cache = fn(cfg_, params_, cache, tokens, **kw)
            calls.append((kind, tokens.clone(), pos, lg[..., :V].float()))
            return lg, cache
        return wrapped
    be = EngineBackend(cfg, params, n_slots=4, max_len=MAX_LEN, impl="kernel",
                       spec=SpecConfig(k=SPEC_K, draft="ngram"))
    with _patched(M, "verify_step", rec(M.verify_step, "verify")), \
            _patched(M, "decode_step", rec(M.decode_step, "decode")):
        done, stats, got = drive_spec(be, prompts, cfg, 0, False)
    torch.cuda.synchronize()
    rep = summarize(done, pattern="bursty", backend="single-device")
    toks = torch.from_numpy(EngineBackend._pad_prompts(prompts)).long().cuda()
    cache = M.init_cache(cfg, 4, MAX_LEN)
    lr0, cache = M.prefill(cfg, params, toks, cache, impl="ref")
    n_pick = n_tie = 0
    rounds = [r for r in be.rounds]
    if len(rounds) != len(calls):
        raise AssertionError(f"{len(rounds)} rounds, {len(calls)} recorded calls")
    for (k, c), (kind, tokens, pos, lk) in zip(rounds, calls):
        cache["pos"] = pos
        fn = M.verify_step if kind == "verify" else M.decode_step
        lr, cache = fn(cfg, params, cache, tokens, impl="ref")
        lr = lr[..., :V].float()
        a, b = lk[:, :c].reshape(-1, V), lr[:, :c].reshape(-1, V)
        n_tie += argmax_or_tie(f"{cfg.name} spec {kind} call", a, b,
                               (a - b).abs().amax(-1))
        n_pick += a.shape[0]
    moved = [next((t for t, (x, y) in enumerate(zip(r.output, q.output)) if x != y),
                  None) for r, q in zip(done, plain)]
    n_diff = sum(sum(x != y for x, y in zip(r.output, q.output))
                 for r, q in zip(done, plain))
    st = be.spec_stats
    log(f"  n-gram speculation (k {SPEC_K}) on the single-device path: {len(rounds)} "
        f"rounds (k, committed) {rounds[:6]}...; drafts accepted "
        f"{st['spec_accepted']} of {st['spec_drafted']}; launches "
        f"{ {k: n for k, n in got.items() if n} } (exact every step); "
        f"{n_pick} committed picks each the reference verify/decode call's or a near "
        f"tie ({n_tie} near ties); against the decode-path serve the served tokens "
        f"differ at {n_diff} of {4 * MAX_NEW} positions (first per request {moved}: "
        f"MoE capacity counts the drafted rows); TTFT p50 {rep.ttft_p50_s * 1e3:.2f} ms, "
        f"{1e3 / rep.decode_tok_s_p50:.3f} ms/token p50 [{card}]")
    return got


def moe_engine_check(card):
    """(b): DeepSeekMoE-16B folded (first_dense_layers=0: every layer an MoE
    layer, widths unchanged; the JAX engine's homogeneous stack) through
    the InterleavedEngine at MOE_ENGINE_HBM (plan_for by the packed layer,
    its fp32 router included), retier headroom 1: the bursty batch (4 x
    512, MOE_NEW tokens) through LimeServer with resident self-speculation
    (k SPEC_K) and a live retier, exact launch counts every step; every
    prefill, verify and decode call of the engine replayed through the
    model's kernel path (the same weights whole on the card, the same rows
    a call) bit for bit, and every served token its verify pass's greedy;
    a decode pass timed against the copy of its streamed bytes, the cost
    model's T_total, Alg. 1's plan at that budget. Returns the launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import InterleavedEngine, packed_layer_bytes, plan_for
    from repro_torch.launch.serve import HBM_FRAC, cost_env, hetero_plan, measure_h2d
    from repro_torch.models import model as M
    from repro_torch.serving import LimeServer, summarize
    from repro_torch.serving.backend import EngineBackend
    from repro_torch.specdec import SpecConfig
    cfg = dataclasses.replace(get_config(MOE_ARCH), first_dense_layers=0)
    L, V = cfg.n_layers, cfg.vocab_size
    params = moe_params(cfg, seed=0)
    packed, counted = packed_layer_bytes(cfg), cfg.layer_params() * 2
    plan = plan_for(cfg, 1, hbm_frac_for_weights=HBM_FRAC,
                    hbm_bytes=MOE_ENGINE_HBM * min(counted / packed, 1.0))
    eng = InterleavedEngine(cfg, plan, mb=4, max_len=MAX_LEN, retier_headroom=1)
    n_res = len(eng.resident_layer_ids())
    if not 0 < n_res < L or n_res * packed > MOE_ENGINE_HBM * HBM_FRAC:
        raise AssertionError(f"folded {cfg.name}: plan {plan} at {MOE_ENGINE_HBM:.3g} B")
    wait_for_host_memory(eng.streamed_store_bytes + HOST_RESERVE, "3g's folded engine")
    eng.init_state(params)
    torch.cuda.synchronize()
    streamed = (L - n_res) * packed
    rate = measure_h2d(eng.store.data.flatten(0, 1)) / 1e9
    env = cost_env(cfg, MOE_ENGINE_HBM, width=4, prompt_len=PROMPT_LEN,
                   load_bw=rate * 1e9)
    env.evaluate(plan)
    try:
        a1, _, a1_scale = hetero_plan(cfg, MOE_ENGINE_HBM, width=4, prompt_len=PROMPT_LEN,
                                      n_emp=PROMPT_LEN, load_bw=rate * 1e9)
        alg1 = (f"scale {a1_scale}, n_seg {a1.plan.n_seg}, "
                f"{dataclasses.astuple(a1.plan.stages[0])} (resident, streamed full / "
                f"attention / MLP a segment), T_total {a1.plan.t_total * 1e3:.2f} ms; "
                f"candidates {[(n, round(t * 1e3, 2)) for n, t in a1.candidates]}")
    except SystemExit as e:
        alg1 = str(e)
    log(f"phase 3g(b): {cfg.name} folded (first_dense_layers 0: layer 0 an MoE layer, "
        f"widths unchanged) at all {L} layers through the engine: --hbm-bytes "
        f"{MOE_ENGINE_HBM / 1e9:.1f} GB (x {HBM_FRAC}), plan_for n_seg {plan.n_seg}, k_res "
        f"{plan.k_res}, k_off {plan.k_off}: {n_res} resident, packed layer "
        f"{packed / 1e9:.4f} GB (the config's count {counted / 1e9:.4f}: the fp32 router "
        f"at 4 bytes), {streamed / 1e9:.2f} GB streamed a pass from "
        f"{eng.store.nbytes / 1e9:.2f} GB pinned; H2D {rate:.2f} GB/s, the streamed bytes' "
        f"copy {streamed / rate / 1e6:.1f} ms; cost model T_total {plan.t_total * 1e3:.2f} "
        f"ms (T_comp {plan.t_comp * 1e3:.2f}, T_uncover {plan.t_uncover * 1e3:.2f}); "
        f"Alg. 1 at this budget: {alg1} [{card}]")
    prompts = make_prompts(4, V, 0)
    log_calls = []
    for name in ("verify_requests", "decode_requests"):
        fn = getattr(eng, name)

        def rec(state, tokens, active, _fn=fn, _name=name, **kw):
            lg, state = _fn(state, tokens, active, **kw)
            log_calls.append((_name, tokens.clone(), torch.as_tensor(active).clone(),
                              state["pos"], lg[..., :V].float()))
            return lg, state
        setattr(eng, name, rec)
    srv = LimeServer(cfg, params, engine=eng, max_len=MAX_LEN, pattern="bursty",
                     spec=SpecConfig(k=SPEC_K, draft="resident", adapt_k=False),
                     prefill_chunk_tokens=PREFILL_CHUNK)
    t0 = time.monotonic()
    done, stats, counts, applied, _ = drive(srv, prompts, "bursty", L, MOE_RETIER_AT,
                                            max_new=MOE_NEW)
    wall = time.monotonic() - t0
    del eng.verify_requests, eng.decode_requests
    rep = summarize(done, pattern="bursty", backend="engine", stats=stats)
    # the replay: the prompt as one verify round (prefill_partial's), then
    # every recorded call on the model's kernel path from the same position
    toks = torch.from_numpy(EngineBackend._pad_prompts(prompts)).long().cuda()
    cache = M.init_cache(cfg, 4, MAX_LEN)
    lg, cache = M.verify_step(cfg, params, cache, toks, impl="kernel")
    out = [[int(t)] for t in lg[:, -1, :V].argmax(-1).tolist()]
    n_calls = 0
    for name, tokens, active, pos_after, le in log_calls:
        tokens = torch.where(active.to(tokens.device)[:, None], tokens,
                             torch.zeros_like(tokens))
        fn = M.verify_step if name == "verify_requests" else M.decode_step
        lm, cache = fn(cfg, params, cache, tokens, impl="kernel")
        lm = lm[..., :V].float()
        if name == "decode_requests":
            lm = lm[:, 0]
        if not torch.equal(lm, le):
            raise AssertionError(f"{cfg.name}: engine call {n_calls} ({name}) is not the "
                                 f"model's kernel path (max |diff| "
                                 f"{(lm - le).abs().max().item():.3g})")
        live = torch.nonzero(active.cpu()).flatten().tolist()
        if name == "decode_requests":
            for s in live:
                out[s].append(int(le[s].argmax()))
        else:
            picks = le.argmax(-1)
            acc = [next((j for j in range(tokens.shape[1] - 1)
                         if tokens[s, j + 1] != picks[s, j]), tokens.shape[1] - 1) + 1
                   for s in live]
            c = min(acc)
            for s in live:
                out[s].extend(picks[s, :c].tolist())
            cache["pos"] = pos_after - tokens.shape[1] + c
        n_calls += 1
    for r in done:
        if r.output != out[r.rid][:len(r.output)]:
            raise AssertionError(f"{cfg.name} req {r.rid}: served tokens are not the "
                                 "verify passes' greedy")
    log(f"  bursty through the engine: 4 requests x {MOE_NEW} tokens, prompt "
        f"{PROMPT_LEN}, resident self-speculation k {SPEC_K}, retier {applied}: "
        f"{len(log_calls)} engine calls replayed through the model's kernel path, logits "
        f"bit-equal at every call, every served token its verify pass's greedy; launches "
        f"(mq, decode, mq prefill, decode hopper, mq verify) {counts}; TTFT p50 "
        f"{rep.ttft_p50_s * 1e3:.2f} ms, {1e3 / rep.decode_tok_s_p50:.3f} ms/token p50, "
        f"serve {wall:.1f} s [{card}]")
    st = eng.seed_cache(eng.init_state(params), eng.prefill(toks)[1])
    tok = torch.from_numpy(np.array([[r.output[0]] for r in done])).cuda()
    passes = sorted(timed_s(lambda: eng.decode_step(st, tok)) for _ in range(3))
    eng.rollback(st, PROMPT_LEN)
    copy_s = streamed / (rate * 1e9)
    log(f"  decode pass (B 4, {L - n_res} of {L} layers streamed): median of 3 "
        f"{passes[1] * 1e3:.2f} ms (min {passes[0] * 1e3:.2f}) against the streamed bytes' "
        f"copy {copy_s * 1e3:.2f} ms at {rate:.2f} GB/s and the cost model's T_total "
        f"{plan.t_total * 1e3:.2f} ms ({(plan.t_total - passes[1]) / passes[1]:+.1%}) "
        f"[{card}]")
    pass_profile(eng, st, st["pos"], lambda: eng.decode_step(st, tok), card,
                 f"folded {cfg.name} decode")
    engine_pass_pair(eng, st, tok, card, f"folded, {L - n_res} of {L} layers "
                     f"streamed, the copy {copy_s * 1e3:.2f} ms")
    host_mem("before 3g's engine is closed")
    eng.close()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"mq_decode_attention": counts[0], "decode_attention": counts[1],
            "mq_decode_attention@prefill": counts[2], "decode_attention@hopper": counts[3],
            "mq_decode_attention@verify": counts[4]}


def kimi_check(card):
    """(c): Kimi-K2 at full width, depth cut to KIMI_LAYERS of 61 (its dense
    layer 0 and one MoE layer of 384 routed top-8 experts, 33.8 GB): the
    bursty batch (4 x 512, MOE_NEW tokens) on the single-device path with
    exact launch counts of kernels 2 and 1, then the reference's re-serve
    fed through both impls (compare_greedy within MOE_LOGIT_REL_TOL) with
    the routes that differ per layer. Returns the launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.serving import summarize
    full = get_config(KIMI_ARCH)
    cfg = dataclasses.replace(full, n_layers=KIMI_LAYERS)
    t0 = time.monotonic()
    params = moe_params(cfg, seed=0)
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"phase 3g(c): {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} kv heads x {cfg.head_dim}, {cfg.n_experts} routed "
        f"experts top-{cfg.top_k} + {cfg.n_shared_experts} shared of d_ff {cfg.moe_d_ff}, "
        f"vocab {cfg.vocab_size}), DEPTH CUT to {cfg.n_layers} of {full.n_layers} layers "
        f"(the dense layer 0 and one MoE layer): {n_par / 1e9:.2f} B params "
        f"({n_par * 2 / 1e9:.1f} GB) in {time.monotonic() - t0:.1f} s, peak HBM "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB [{card}]")
    prompts = make_prompts(4, cfg.vocab_size, 0)
    fa.launches = fa.hopper_launches = da.launches = da.hopper_launches = 0
    done = serve(cfg, params, "bursty", prompts, "kernel", max_new=MOE_NEW)
    torch.cuda.synchronize()
    got = {"flash_attention": fa.launches, "decode_attention": da.launches,
           "flash_attention@hopper": fa.hopper_launches,
           "decode_attention@hopper": da.hopper_launches}
    L = cfg.n_layers
    want = {"flash_attention": L, "decode_attention": L * (MOE_NEW - 1),
            "flash_attention@hopper": L, "decode_attention@hopper": L * (MOE_NEW - 1)}
    if got != want:
        raise AssertionError(f"kimi: launches {got} != {want}")
    rep = summarize(done, pattern="bursty", backend="single-device")
    ref = serve(cfg, params, "bursty", prompts, "ref", max_new=MOE_NEW)
    with moe_calls() as calls:
        n_pos, n_tie, worst = compare_greedy(cfg, params, "bursty", prompts, done, ref, 4,
                                             MOE_LOGIT_REL_TOL, max_new=MOE_NEW)
    half = len(calls) // 2
    pre, dec, per_pre, per_dec = route_flips(calls[:half], calls[half:], L - 1)
    feed = torch.tensor([r.output for r in ref]).numpy()
    with moe_io() as io:
        forced_logits(cfg, params, prompts, feed[:, :1], 4, "kernel")
    layer_err = max(moe_layer_errors(cfg, io))
    del io
    if layer_err > MOE_LAYER_REL:
        raise AssertionError(f"kimi: served MoE layer off moe_plain ({layer_err:.4f})")
    log(f"  bursty: 4 requests x {MOE_NEW} tokens, prompt {PROMPT_LEN}: launches {got}; "
        f"TTFT p50 {rep.ttft_p50_s * 1e3:.2f} ms, {1e3 / rep.decode_tok_s_p50:.3f} "
        f"ms/token p50; against 'ref' {n_pos} positions, {n_tie} near ties, worst logit "
        f"err {worst:.4f} of |logit| max (tol {MOE_LOGIT_REL_TOL}); routes that differ "
        f"from 'ref' in the MoE layer: prefill {pre} of {per_pre} tokens, decode {dec} "
        f"of {per_dec}; the MoE layer against moe_plain on its served inputs (prefill + "
        f"1 step): worst token err {layer_err:.4f} (limit {MOE_LAYER_REL:.4f}) "
        f"[{card}; {cfg.name}, {L} of {full.n_layers} layers]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return got


def moe_phase(card):
    """Phase 3g: (a) DeepSeekMoE-16B as published at MOE_SINGLE of its 28
    layers on the single-device path (single_device_checks: bursty and
    sporadic serves,
    the reference re-serve, its noise floor, route flips per layer, the
    MoE faults at the layers' outputs, the layer-by-layer errors, and an
    n-gram speculative serve); (c) Kimi-K2 at full width, 2 layers; (b)
    DeepSeekMoE-16B folded through the engine (its pinned store last, so
    3b's returns first). Returns ({kernel row: launches} at the MoE
    shapes, the summed launches)."""
    import torch

    from repro_torch.configs import get_config
    shapes, launches = {}, {}

    def add(got):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    t_lap = [time.monotonic()]

    def lap(what):
        now = time.monotonic()
        log(f"  3g {what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_SINGLE)
    params = moe_params(cfg, seed=0)
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"phase 3g(a): {cfg.name} as published on the single-device path, full width, "
        f"DEPTH CUT to {cfg.n_layers} of {get_full_layers(cfg)} layers (dense layer 0 "
        f"of d_ff {cfg.d_ff}, then "
        f"{cfg.n_layers - cfg.first_dense_layers} MoE layers of {cfg.n_experts} routed "
        f"top-{cfg.top_k} + {cfg.n_shared_experts} shared experts of d_ff {cfg.moe_d_ff}; "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads = {cfg.n_kv_heads} kv heads x "
        f"{cfg.head_dim}: G 1; vocab {cfg.vocab_size}): {n_par / 1e9:.2f} B params "
        f"({n_par * 2 / 1e9:.1f} GB) [{card}]")
    served = {}
    got = single_device_checks(cfg, params, card, "3g", tol=MOE_LOGIT_REL_TOL,
                               faults=True, served=served)
    add(got)
    layer_errors(cfg, params, served["bursty"][0], card, cfg.name)
    shapes["decode_attention@moe"] = got["decode_attention"]
    shapes["flash_attention@moe"] = got["flash_attention"]
    lap("(a) serves, reference, faults")
    got = moe_spec_check(cfg, params, card, served["bursty"])
    add(got)
    shapes["mq_decode_attention@moe"] = got["mq_decode_attention"]
    lap("(a) speculative serve")
    prefilled_pair(cfg, params, served["bursty"][0], card)
    lap("(a) captured against eager steps")
    del params, served
    gc.collect()
    torch.cuda.empty_cache()
    add(kimi_check(card))
    lap("(c) Kimi-K2")
    got = moe_engine_check(card)
    add(got)
    shapes["mq_decode_attention@moe"] += got["mq_decode_attention"]
    lap("(b) folded engine")
    return shapes, launches


# ----------------------------------------------------------------------------
# phase 3h: the encoder-decoder family
# ----------------------------------------------------------------------------
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_NEW = 32           # positions per request on the model path (prefill + 31 steps)
ENCDEC_PROFILE = 8        # decode tokens in the profiled run
ENCDEC_ENGINE_NEW = 8     # positions per request in the paged engine run
ENCDEC_RETIER_AT = ((2, +1), (4, -1))    # (after decode step, delta), engine run
# The kernel path against impl="ref" at 12 + 12 layers, and the reference
# against itself (each request alone against the 4-wide batch): fixed
# before the first chip call from CPU runs of the port at full width and
# depth on encdec_params' weights (the CPU's kernel route runs the plain
# versions): the kernel path read 0.0375 of |logit| max (B 2, 128 frames,
# prompt 128, 8 positions) and 0.0308 (512 frames, prompt 512, 16
# positions), the floor 0.0245 and 0.0284, the planted faults 0.37-0.99.
# The limits are 2.7x and 2.8x the largest readings; the faults read 3.7x
# the logit limit or more.
ENCDEC_LOGIT_REL_TOL = 0.10
ENCDEC_NOISE_FLOOR_MAX = 0.08


def encdec_params(cfg, seed=0):
    """init_params from a seed, every stacked matrix of the decoder and the
    encoder then scaled to std 1/sqrt(d_model). The stacked fan-in quirk
    (std 1/sqrt(L), kept by init_params so that both packages build the
    same model) is 9x that at d_model 1024 over 12 layers: attention scores
    of std ~90, every softmax one-hot, and each near tie among 512 keys
    (about one a row in 30) flips its row between any two roundings. Over
    24 such layers the kernel path read 0.95 of |logit| max against
    impl="ref" on the CPU at full width, the planted faults 1.46-1.55: no
    limit tells them apart. At 1/sqrt(d_model) scores have std ~1."""
    import torch

    from repro_torch.models import model as M
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    for stack in ("layers", "encoder"):
        n = cfg.n_layers if stack == "layers" else cfg.n_encoder_layers
        for t in _leaves(params[stack]):
            if t.dim() >= 3:
                t.mul_((n / cfg.d_model) ** 0.5)
    return params


def encdec_inputs(cfg, n=4):
    """Frame embeddings (n, frontend_tokens, d_model) fp32 and prompts (n,
    PROMPT_LEN) from numpy seeds, on the card (the reference's modality
    stub: frames stand for the audio frontend's output)."""
    import numpy as np
    import torch
    fe = np.random.default_rng(7).standard_normal(
        (n, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    toks = np.stack(make_prompts(n, cfg.vocab_size, 0))
    return torch.from_numpy(fe).cuda(), torch.from_numpy(toks).long().cuda()


def encdec_run(cfg, params, fe, toks, impl, feed=None, steps=None, seed=None,
               box=None, counts=False, capture=False):
    """The reference's flow on the model path (its dryrun): encode ->
    seed_cross_kv -> prefill -> decode_step(enc_len=S_enc), `steps`
    positions in all (ENCDEC_NEW by default). Each step is fed feed[:, t]
    (B, steps - 1) where
    given, else the previous position's greedy pick. seed(cfg, params,
    cache, enc), where given, fills the cross K/V in place of
    M.seed_cross_kv (a planted fault); box, where given, receives the
    cache. counts: the encoder must launch kernel 2 once a layer, the
    prompt pass twice a layer (self and cross), every step kernel 1 twice
    a layer, all on the Hopper bodies and nothing else. capture: the
    decode steps replay one CUDA graph (a CapturedStep). Returns (logits
    (steps, B, V) fp32, their argmaxes (B, steps))."""
    import torch

    from repro_torch.core.capture import CapturedStep
    from repro_torch.models import model as M
    graphs = CapturedStep("cuda") if capture else None
    V, L, S_enc = cfg.vocab_size, cfg.n_layers, fe.shape[1]
    steps = ENCDEC_NEW if steps is None else steps

    def expect(c0, **want):
        if not counts:
            return
        torch.cuda.synchronize()
        got = {k: v - c0[k] for k, v in read_counts().items()}
        full = dict.fromkeys(got, 0)
        for k, n in want.items():
            full[k] = full[k + "@hopper"] = n
        if got != full:
            raise AssertionError(f"{cfg.name}: launched {got}, expected {full}")
    c0 = read_counts()
    enc = M.encode(cfg, params, fe, impl=impl)
    expect(c0, flash_attention=cfg.n_encoder_layers)
    c0 = read_counts()
    cache = M.init_cache(cfg, fe.shape[0], MAX_LEN, enc_out=enc)
    if box is not None:
        box.append(cache)
    (seed or M.seed_cross_kv)(cfg, params, cache, enc)
    lg, cache = M.prefill(cfg, params, toks, cache, impl=impl)
    expect(c0, flash_attention=2 * L)
    out = [lg[:, -1, :V].float()]
    for t in range(steps - 1):
        tok = feed[:, t:t + 1] if feed is not None else out[-1].argmax(-1, keepdim=True)
        c0 = read_counts()
        lg, cache = M.decode_step(cfg, params, cache, tok, impl=impl, enc_len=S_enc,
                                  steps=graphs)
        expect(c0, decode_attention=2 * L)
        out.append(lg[:, -1, :V].float())
    logits = torch.stack(out)
    return logits, logits.argmax(-1).T


def encdec_faults(cfg, params):
    """Planted faults of the model path, each a context that plants it:
    [(label, context, seed)]: the encoder run causal (every flash launch of
    attn_forward causal: the decoder's self-attention is causal anyway);
    each decoder layer's cross K/V projected with the next layer's weights
    (seed); rope applied to the cross-attention's q (at positions 0 .. S - 1
    in the prompt pass, at the step's position in a decode step)."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.modules import apply_rope
    real = M.attn_forward
    L = cfg.n_layers
    box = []

    def causal(*a, **kw):
        return real(*a, **{**kw, "causal": True})

    def next_layer(cfg_, params_, cache, enc):
        for l in range(L):
            cache["xk"][l], cache["xv"][l] = M.cross_kv_layer(
                M.layer_params(params_, (l + 1) % L), enc)

    def roped_q(params_, x, start):
        pos = start + torch.arange(x.shape[1], device=x.device)[None, :]
        return apply_rope(A._proj(x, params_["wq"]), pos, cfg.rope_theta)

    def roped_prefill(params_, x, ck, cv, *, impl):
        out = fa.flash_attention(roped_q(params_, x, 0), ck, cv, causal=False)
        return A._out_proj(out, params_["wo"])

    def roped_decode(params_, x, ck, cv, enc_len, *, impl):
        ids = A.cross_pos_ids(ck.shape[1], int(enc_len), ck.device)
        out = da.decode_attention(roped_q(params_, x, box[-1]["pos"]), ck, cv, ids,
                                  ck.shape[1] - 1)
        return A._out_proj(out, params_["wo"])

    @contextlib.contextmanager
    def both_roped():
        with _patched(M, "cross_attn_prefill", roped_prefill), \
                _patched(M, "cross_attn_decode", roped_decode):
            yield
    return [("the encoder run causal", _patched(M, "attn_forward", causal), None, None),
            ("each layer's cross K/V from the next layer's weights",
             contextlib.nullcontext(), next_layer, None),
            ("rope applied to the cross-attention's q", both_roped(), None, box)]


def logit_err(got, ref):
    """The largest err / |logit| max of logits got (T', B, V) against the
    first T' positions of ref (T, B, V)."""
    return ((got - ref[:got.shape[0]]).abs().amax(-1)
            / ref[:got.shape[0]].abs().amax(-1)).max().item()


def encdec_model_check(cfg, params, fe, toks, card):
    """(a): the model path under impl="kernel" (exact launch counts), its
    greedy serve against impl="ref"'s: the reference's tokens fed through
    the kernel path, every pick the reference's or a near tie, logits
    within ENCDEC_LOGIT_REL_TOL, the reference's noise floor under
    ENCDEC_NOISE_FLOOR_MAX, the planted faults above the limit; times and
    a profile. Returns (main-path launches, reference tokens, the kernel
    path's forced logits, the kernel path's greedy tokens)."""
    import torch

    from repro_torch.models import model as M
    n, T = fe.shape[0], ENCDEC_NEW
    zero_counts()
    t0 = time.monotonic()
    lg_k, got = encdec_run(cfg, params, fe, toks, "kernel", counts=True, capture=True)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.monotonic() - t0
    t_enc = timed_s(lambda: M.encode(cfg, params, fe, impl="kernel"))
    t_ttft = timed_s(lambda: encdec_run(cfg, params, fe, toks, "kernel", steps=1))
    lg_r, ref = encdec_run(cfg, params, fe, toks, "ref")
    feed = ref[:, :-1]
    lk, _ = encdec_run(cfg, params, fe, toks, "kernel", feed=feed)
    if not torch.equal(lk[0], lg_k[0]):
        raise AssertionError(f"{cfg.name}: two kernel-path prefills differ")
    err = (lk - lg_r).abs().amax(-1)
    scale = lg_r.abs().amax(-1)
    worst = (err / scale).max().item()
    ties = argmax_or_tie(f"{cfg.name} kernel vs impl='ref'", lk.flatten(0, 1),
                         lg_r.flatten(0, 1), err.flatten())
    t_div = [next((t for t in range(T) if got[i, t] != ref[i, t]), T) for i in range(n)]
    for i, d in enumerate(t_div):
        upto = min(d + 1, T)
        if not torch.equal(got[i, :upto], lk.argmax(-1).T[i, :upto]):
            raise AssertionError(f"{cfg.name} req {i}: the kernel serve's tokens are "
                                 "not the kernel path's argmaxes")
    log(f"  (a) model path, B {n}, {fe.shape[1]} frames, prompt {toks.shape[1]}, {T} "
        f"greedy positions: launches {launches['flash_attention']} flash (12 encoder, "
        f"12 self, 12 cross; all on the Hopper mainloop), "
        f"{launches['decode_attention'] // (T - 1)} decode-attention a step (all on the "
        f"Hopper body), none of kernels 3-7; encode {t_enc * 1e3:.2f} ms, TTFT (encode "
        f"+ cross K/V + prefill) {t_ttft * 1e3:.2f} ms, the greedy run "
        f"{wall * 1e3:.1f} ms ({(wall - t_ttft) / (T - 1) * 1e3:.3f} ms/token with "
        f"the counters' syncs) [{card}]")
    log(f"  the kernel path vs impl='ref' on the reference's tokens: worst logit err "
        f"{worst:.4f} of |logit| max (tol {ENCDEC_LOGIT_REL_TOL}), {ties} near ties of "
        f"{T * n} picks; the kernel serve's tokens agree with the reference's up to "
        f"{t_div}")
    if worst > ENCDEC_LOGIT_REL_TOL:
        raise AssertionError(f"{cfg.name}: kernel logits off the reference")
    alone = torch.stack([encdec_run(cfg, params, fe[i:i + 1], toks[i:i + 1], "ref",
                                    feed=feed[i:i + 1])[0][:, 0] for i in range(n)], 1)
    floor = ((alone - lg_r).abs().amax(-1) / scale).max().item()
    log(f"  the reference's own noise floor (each request alone against the 4-wide "
        f"batch): {floor:.4f} of |logit| max (at most {ENCDEC_NOISE_FLOOR_MAX})")
    if floor > ENCDEC_NOISE_FLOOR_MAX:
        raise AssertionError(f"{cfg.name}: the reference's noise floor {floor:.4f}")
    faults = []
    for label, ctx, seed, fbox in encdec_faults(cfg, params):
        with ctx:
            lf, _ = encdec_run(cfg, params, fe, toks, "kernel", feed=feed, steps=4,
                               seed=seed, box=fbox)
        faults.append((label, logit_err(lf, lg_r)))
    log("  planted faults, logit err / |logit| max over the prefill and 3 steps: "
        + ", ".join(f"{k} {v:.4f}" for k, v in faults))
    missed = [k for k, v in faults if v <= ENCDEC_LOGIT_REL_TOL]
    if missed:
        raise AssertionError(f"{cfg.name}: the limit cannot see {missed}")
    enc = M.encode(cfg, params, fe, impl="kernel")
    cache = M.seed_cross_kv(cfg, params, M.init_cache(cfg, n, MAX_LEN, enc_out=enc), enc)
    _, cache = M.prefill(cfg, params, toks, cache, impl="kernel")

    def steps():
        c = dict(cache)
        c["k"], c["v"], c["pos_ids"] = (cache[k].clone() for k in ("k", "v", "pos_ids"))
        for t in range(ENCDEC_PROFILE):
            M.decode_step(cfg, params, c, got[:, t + 1:t + 2], impl="kernel",
                          enc_len=fe.shape[1])
    t_dec = timed_s(steps)
    log(f"  {ENCDEC_PROFILE} decode steps on the kernel path, no counters: "
        f"{t_dec / ENCDEC_PROFILE * 1e3:.3f} ms/token (B {n}) [{card}]")
    c = {k: v.clone() if k in ("k", "v", "pos_ids") else v for k, v in cache.items()}
    model_step_pair(f"{cfg.name} decode step (B {n}, enc_len {fe.shape[1]})", cfg,
                    params, c, got[:, 1:2], card, impl="kernel", enc_len=fe.shape[1])
    model_prefill_pair(cfg, params, toks, card, enc_out=enc)
    pass_profile(None, None, None, lambda: encdec_run(cfg, params, fe, toks, "kernel",
                                                      steps=1), card,
                 f"{cfg.name} encode + cross K/V + prefill")
    pass_profile(None, None, None, steps, card, f"{cfg.name} {ENCDEC_PROFILE} decode "
                 "steps")
    return launches, ref, lk, got


def encdec_engine_check(cfg, params, fe, toks, ref, lk, got, card):
    """(b): the engine at a --hbm-bytes budget that streams half the
    decoder layers: its encoder, prompt pass over the tiers (each layer's
    cross K/V from its own weights) and decode steps fed the reference's
    tokens, across a retier +1 and -1, bit-equal to the model's kernel path
    (lk); a streamed layer reading the next layer's cross K/V breaks that;
    a paged engine (page 64) gives the kernel path's greedy tokens with the
    pages reckoned; a decode pass timed against the copy of its streamed
    bytes and the cost model's T_total."""
    import torch

    from repro_torch.core.engine import InterleavedEngine
    from repro_torch.launch.serve import HBM_FRAC, cost_env, measure_h2d
    from repro_torch.models import model as M
    n, V, L, S_enc = fe.shape[0], cfg.vocab_size, cfg.n_layers, fe.shape[1]
    feed = ref[:, :-1]
    budget, plan = half_streamed_plan(cfg)
    eng = InterleavedEngine(cfg, plan, mb=n, max_len=MAX_LEN, retier_headroom=1,
                            enc_len=S_enc)
    eng.init_state(params)
    torch.cuda.synchronize()
    n_res = len(eng.resident_layer_ids())
    streamed = (L - n_res) * eng.layer_bytes
    rate = measure_h2d(eng.store.data.flatten(0, 1)) / 1e9
    env = cost_env(cfg, budget, width=n, prompt_len=PROMPT_LEN, load_bw=rate * 1e9)
    env.evaluate(plan)
    log(f"  (b) the engine: --hbm-bytes {budget / 1e9:.3f} GB (x {HBM_FRAC}), plan_for "
        f"n_seg {plan.n_seg}, k_res {plan.k_res}, k_off {plan.k_off}: resident "
        f"{eng.resident_layer_ids()}, packed layer {eng.layer_bytes / 1e6:.2f} MB (the "
        f"config's count {cfg.layer_params() * 2 / 1e6:.2f} MB), {streamed / 1e6:.1f} MB "
        f"streamed a pass from {eng.store.nbytes / 1e6:.1f} MB pinned (retier headroom "
        f"1); H2D {rate:.2f} GB/s, the streamed bytes' copy {streamed / rate / 1e6:.3f} "
        f"ms; cost model T_total {plan.t_total * 1e3:.3f} ms (T_comp "
        f"{plan.t_comp * 1e3:.3f}, T_uncover {plan.t_uncover * 1e3:.3f}) [{card}]")

    def engine_logits(e, steps, retier=(), after_prefill=None):
        enc = e.encode(fe)
        lg, cache = e.prefill(toks, enc_out=enc)
        if after_prefill is not None:
            after_prefill(cache)
        st = e.seed_cache(e.init_state(params), cache)
        out = [lg[:, -1, :V].float()]
        for t in range(steps - 1):
            lg, st = e.decode_step(st, feed[:, t:t + 1])
            out.append(lg[:, :V].float())
            for at, d in retier:
                if at == t:
                    e.retier(st, 0, d)
        return torch.stack(out), enc
    le, enc = engine_logits(eng, ENCDEC_NEW, ENCDEC_RETIER_AT)
    same_enc = torch.equal(enc, M.encode(cfg, params, fe, impl="kernel"))
    same = torch.equal(le, lk)
    log(f"  engine vs the model's kernel path on the reference's tokens "
        f"({ENCDEC_NEW} positions, a retier +1 after step {ENCDEC_RETIER_AT[0][0]} and "
        f"-1 after step {ENCDEC_RETIER_AT[1][0]}): encoder output "
        f"{'bit-equal' if same_enc else 'DIFFERS'}, logits "
        f"{'bit-equal' if same else 'DIFFER'} (max |diff| "
        f"{(le - lk).abs().max().item():.3g}); resident after {eng.resident_layer_ids()}")
    if not (same and same_enc) or len(eng.resident_layer_ids()) != n_res:
        raise AssertionError(f"{cfg.name}: the engine is not the model's kernel path")
    first = int(eng._off_ids[eng._off_ids < L].min())      # the first streamed layer

    def wrong_cross(cache):
        for k in ("xk", "xv"):
            cache[k][first] = cache[k][first + 1].clone()
    lf, _ = engine_logits(eng, 3, after_prefill=wrong_cross)
    log(f"  planted engine fault, streamed layer {first} reading layer {first + 1}'s "
        f"cross K/V: logit err / |logit| max "
        f"{logit_err(lf, lk):.4f}, "
        f"{'REJECTED' if not torch.equal(lf, lk[:3]) else 'NOT REJECTED'} by the "
        "bit-equality")
    if torch.equal(lf, lk[:3]):
        raise AssertionError(f"{cfg.name}: the planted engine fault passes")
    st = eng.seed_cache(eng.init_state(params), eng.prefill(toks, enc_out=enc)[1])
    tok = feed[:, :1]
    passes = sorted(timed_s(lambda: eng.decode_step(st, tok)) for _ in range(3))
    log(f"  decode pass (B {n}, {L - n_res} of {L} layers streamed): median of 3 "
        f"{passes[1] * 1e3:.3f} ms (min {passes[0] * 1e3:.3f}) against the streamed "
        f"bytes' copy {streamed / (rate * 1e9) * 1e3:.3f} ms and the cost model's "
        f"T_total {plan.t_total * 1e3:.3f} ms [{card}]")
    engine_pass_pair(eng, st, tok, card, f"{L - n_res} of {L} layers streamed, the "
                     f"copy {streamed / (rate * 1e9) * 1e3:.3f} ms", prompt=toks,
                     enc_out=enc)
    eng.close()
    engp = InterleavedEngine(cfg, plan, mb=n, max_len=MAX_LEN, paged=True,
                             page_size=ENGINE_PAGE, enc_len=S_enc)
    engp.init_state(params)
    lg, cache = engp.prefill(toks, enc_out=engp.encode(fe))
    st = engp.seed_cache(engp.init_state(params), cache)
    pages = [engp.paged_stats()["pages_in_use"]]
    tok = lg[:, -1, :V].argmax(-1, keepdim=True)
    picks = [tok]
    for _ in range(ENCDEC_ENGINE_NEW - 1):
        lg, st = engp.decode_requests(st, tok, [True] * n)
        tok = lg[:, :V].argmax(-1, keepdim=True)
        picks.append(tok)
        pages.append(engp.paged_stats()["pages_in_use"])
    for s in range(n):
        engp.free_slot(s)
    pages.append(engp.paged_stats()["pages_in_use"])
    picks = torch.cat(picks, 1)
    want = [n * -(-min(PROMPT_LEN + t, engp.S_c) // ENGINE_PAGE)
            for t in range(ENCDEC_ENGINE_NEW)] + [0]
    same = torch.equal(picks, got[:, :ENCDEC_ENGINE_NEW])
    log(f"  a paged engine (page {ENGINE_PAGE}, cross K/V contiguous): "
        f"{ENCDEC_ENGINE_NEW} greedy positions {'equal to' if same else 'DIFFER from'} "
        f"the kernel path's; pages in use after the seed, each step and the release "
        f"{pages} (reckoned {want})")
    if not same or pages != want:
        raise AssertionError(f"{cfg.name}: the paged engine run is off")
    engp.close()


def encdec_phase(card):
    """Phase 3h: SeamlessM4T-medium at full width and 12 + 12 layers,
    random weights from seed 0 (encdec_params): (a) the model path (encdec_model_check),
    (b) the engine (encdec_engine_check), (c) the serving backend's
    refusal before any weight is drawn. Returns (the main path's
    launches: the kernel path's greedy run, {kernel row: launches})."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import EngineBackend
    cfg = get_config(ENCDEC_ARCH)
    t_lap = [time.monotonic()]

    def lap(what):
        now = time.monotonic()
        log(f"  3h {what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now
    try:
        EngineBackend(cfg, None)
        raise AssertionError(f"{cfg.name}: the serving backend took the family")
    except NotImplementedError as e:
        log(f"phase 3h(c): EngineBackend refuses {cfg.name} before any weight is "
            f"drawn: {e}")
    params = encdec_params(cfg)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    fe, toks = encdec_inputs(cfg)
    log(f"phase 3h: {cfg.name} at full width and depth ({cfg.n_encoder_layers} encoder "
        f"+ {cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads = "
        f"{cfg.n_kv_heads} kv heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}): {n_par / 1e9:.3f} B params ({n_par * 2 / 1e9:.2f} GB); "
        f"frames {tuple(fe.shape)}, prompts {tuple(toks.shape)}, max_len {MAX_LEN} "
        f"[{card}]")
    lap("weights")
    launches, ref, lk, got = encdec_model_check(cfg, params, fe, toks, card)
    lap("(a) model path, reference, faults, profile")
    encdec_engine_check(cfg, params, fe, toks, ref, lk, got, card)
    lap("(b) engine")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"flash_attention@encdec": launches["flash_attention"],
                      "decode_attention@encdec": launches["decode_attention"]}


# ----------------------------------------------------------------------------
# phase 0: what the Hopper mainloop and decode body compiled to
# ----------------------------------------------------------------------------
HOPPER_SOURCES = ("_flash_attention_cu", "_mq_decode_attention_cu",
                  "_mq_paged_decode_attention_cu")
# decode_sm90_kernel<DHP, GM, Addr> (kernels 1, 3: DHP 64 / 128 x GM 8 / 16)
# and verify_sm90_kernel<DHP, NW, Addr> (kernels 4, 5: DHP 64 / 128 x 3, 5
# or 8 row warps) per source, Addr naming the source
DECODE_SM90 = {"decode_attention.cu": "ContigAddr", "paged_decode_attention.cu": "PagedAddr"}
VERIFY_SM90 = {"mq_decode_attention.cu": "ContigMqAddr",
               "mq_paged_decode_attention.cu": "PagedMqAddr"}


def _cuobjdump():
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    for cand in (pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                 / "bin" / "cuobjdump",):
        if cand.exists():
            return str(cand)
    import triton                                  # its copy of the tool
    return str(pathlib.Path(triton.__file__).parent / "backends" / "nvidia"
               / "bin" / "cuobjdump")


def hopper_sass_check(lib_path):
    """Each source's instantiations of the Hopper mainloop
    (sm90::attention_kernel) must run on wgmma and TMA: HGMMA and UTMALDG
    in their SASS; each of decode_sm90_kernel's (kernels 1 and 3), of
    verify_sm90_kernel's (kernels 4 and 5) and of the scans' chunked bodies
    (wkv_scan_kernel_chunked, ssm_scan_kernel_chunked: kernels 6 and 7) on
    the tensor cores and asynchronous copies: HMMA and LDGSTS, the scans'
    with no spills; and no second pass is left (decode_combine_kernel,
    mq_combine_kernel). Prints their registers and spills from
    ptxas.log."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    ops, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            f = m.group(1)
            if "combine_kernel" in f:
                raise AssertionError(f"a second pass is still built: {f}")
            cur = f if ("sm90" in f and "attention_kernel" in f) \
                or "decode_sm90_kernel" in f or "verify_sm90_kernel" in f \
                or "scan_kernel_chunked" in f else None
            if cur:
                ops[cur] = set()
        elif cur:
            ops[cur].update(op for op in ("HGMMA", "UTMALDG", "HMMA", "LDGSTS") if op in line)
    regs, cur = {}, None
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if m.group(1) in ops else None
        elif cur and ("registers" in line or "spill" in line):
            regs[cur] = regs.get(cur, "") + " " + line.split(":", 1)[-1].strip()
    for src in HOPPER_SOURCES:
        fns = [f for f in ops if "attention_kernel" in f and src in f
               and (src != "_mq_decode_attention_cu" or "_paged_" not in f)]
        if not fns:
            raise AssertionError(f"no Hopper mainloop kernel in {src[1:]}")
        for f in fns:
            dhp = re.search(r"attention_kernelILi(\d+)", f).group(1)
            log(f"  sass {src[1:-3]}.cu attention_kernel<{dhp}>: {sorted(ops[f])};"
                f"{regs.get(f, ' ptxas: not found')}")
            if not {"HGMMA", "UTMALDG"} <= ops[f]:
                raise AssertionError(f"{src[1:]} attention_kernel<{dhp}>: no HGMMA or "
                                     "UTMALDG in its SASS")
    for kern, sources, count in (("decode_sm90_kernel", DECODE_SM90, 4),
                                 ("verify_sm90_kernel", VERIFY_SM90, 6)):
        for src, addr in sources.items():
            fns = [f for f in ops if kern in f and f"{len(addr)}{addr}" in f]
            if len(fns) != count:
                raise AssertionError(f"{src}: {len(fns)} {kern} instantiations, expected "
                                     f"{count}")
            for f in fns:
                a, b = re.search(kern + r"ILi(\d+)ELi(\d+)", f).groups()
                log(f"  sass {src} {kern}<{a}, {b}>: {sorted(ops[f])};"
                    f"{regs.get(f, ' ptxas: not found')}")
                if not {"HMMA", "LDGSTS"} <= ops[f]:
                    raise AssertionError(f"{src} {kern}<{a}, {b}>: no HMMA or LDGSTS in "
                                         "its SASS")
    # the scans' chunked bodies: on the tensor cores and asynchronous
    # copies, and nothing spilled (their states live in registers)
    bad = []
    for kern, count in (("wkv_scan_kernel_chunked", 3), ("ssm_scan_kernel_chunked", 9)):
        fns = [f for f in ops if kern in f]
        if len(fns) != count:
            raise AssertionError(f"{len(fns)} {kern} instantiations, expected {count}")
        for f in fns:
            args = ", ".join(re.search(kern + r"((?:ILi\d+E|Li\d+E)+)", f).group(1)
                             .replace("I", "").replace("E", "").split("Li")[1:])
            ptx = regs.get(f, " ptxas: not found")
            log(f"  sass {kern}<{args}>: {sorted(ops[f])};{ptx}")
            if not {"HMMA", "LDGSTS"} <= ops[f]:
                bad.append(f"{kern}<{args}>: no HMMA or LDGSTS in its SASS")
            if not re.search(r"(?<!\d)0 bytes spill stores", ptx):
                bad.append(f"{kern}<{args}>: spills ({ptx.strip()})")
    if bad:
        raise AssertionError("; ".join(bad))


# ----------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()
        card = smi[0] if smi else "unknown card"
        log(f"phase 0: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}; card and power limit (nvidia-smi):")
        log(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("phase 0: TF32 off for matmul and cuDNN (fp32 references in full fp32)")
        t0 = time.monotonic()
        lib_path = build.build()
        build.load()
        log(f"phase 0: kernels built in {time.monotonic() - t0:.1f} s -> {lib_path}")
        ptxas = lib_path.parent / "ptxas.log"
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
        log("phase 0: the Hopper mainloop's SASS (wgmma = HGMMA, TMA = UTMALDG) and the "
            "decode and verify bodies' (mma.sync = HMMA, cp.async = LDGSTS)")
        hopper_sass_check(lib_path)

        t_run = time.monotonic()

        def done(phase, t):
            log(f"phase {phase} done in {time.monotonic() - t:.1f} s "
                f"({time.monotonic() - t_run:.1f} s since phase 1 began)")
            return time.monotonic()

        t = time.monotonic()
        rows = kernel_phase()
        t = done(1, t)
        launches, cfg8, params8, base = main_path_phase(card)
        t = done(2, t)
        prefix_launches, serve_us = prefix_phase(cfg8, params8, card)
        for k, n in prefix_launches.items():
            launches[k] = launches.get(k, 0) + n
        t = done("2b", t)
        spec_launches = spec_phase(cfg8, params8, card, base)
        for k, n in spec_launches.items():
            launches[k] = launches.get(k, 0) + n
        t = done("2c", t)
        got, warm = capture_phase(cfg8, params8, card, base)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        t = done("2d", t)
        for k, n in trace_phase(cfg8, card, base, warm).items():
            launches[k] = launches.get(k, 0) + n
        del base, warm
        t = done("2e", t)
        for k, n in fleet_phase(cfg8, params8, card).items():
            launches[k] = launches.get(k, 0) + n
        t = done("2f", t)
        engine_check_phase(cfg8, params8, card)
        t = done("3a", t)
        del params8
        gc.collect()
        torch.cuda.empty_cache()
        for k, n in recurrent_phase(card).items():
            launches[k] = launches.get(k, 0) + n
        t = done("3c", t)
        for k, n in recurrent_engine_phase(card).items():
            launches[k] = launches.get(k, 0) + n
        t = done("3f", t)
        engine_launches, depth, state80 = full_model_phase(card)
        t = done("3b", t)
        for k, n in engine_launches.items():
            launches[k] = launches.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        moe_shapes, got = moe_phase(card)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        t = done("3g", t)
        got, encdec_shapes = encdec_phase(card)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        t = done("3h", t)
        # 3d at ALG1_LAYERS of 3b's 80 layers (a layer source of that depth,
        # seed 0), the weight budget scaled with it so that Alg. 1 plans
        # the same resident share
        from repro_torch.models import model as M
        cfg80, rate, prompts = state80["cfg"], state80["rate"], state80["prompts"]
        budget = state80["budget"] * ALG1_LAYERS / cfg80.n_layers
        log(f"phase 3d: DEPTH CUT to {ALG1_LAYERS} of {cfg80.n_layers} layers, the "
            f"weight budget {state80['budget'] / 1e9:.2f} GB scaled with it")
        del state80
        gc.collect()
        cfg40 = dataclasses.replace(cfg80, n_layers=ALG1_LAYERS)
        for k, n in alg1_phase(card, cfg40, M.init_params_by_layer(cfg40, seed=0),
                               budget, rate, prompts).items():
            launches[k] = launches.get(k, 0) + n
        t = done("3d", t)
        shapes, got = tab3_phase(card, rate)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        launches.update(shapes)
        launches.update(moe_shapes)
        launches.update(encdec_shapes)
        done("3e", t)

        for name in ("decode_attention@hopper", "paged_decode_attention@hopper",
                     "mq_decode_attention@verify", "mq_paged_decode_attention@verify",
                     "wkv_scan@chunked", "ssm_scan@chunked"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{name} never launched on the main path")
        log(f"main-path launches: {launches}")
        kernels = []
        for name, src, tpu in (
                ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:88"),
                ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:104"),
                ("mq_decode_attention", "src/repro_torch/csrc/mq_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:107"),
                ("mq_decode_attention@prefill",
                 "src/repro_torch/csrc/mq_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:107"),
                ("paged_decode_attention", "src/repro_torch/csrc/paged_decode_attention.cu",
                 "src/repro/kernels/decode_attention/paged.py:119"),
                ("mq_paged_decode_attention",
                 "src/repro_torch/csrc/mq_paged_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:248"),
                # kernel 5's verify regime (verify_sm90_kernel), served by
                # phase 2c's paged speculation
                ("mq_paged_decode_attention@verify",
                 "src/repro_torch/csrc/mq_paged_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:248"),
                ("wkv_scan", "src/repro_torch/csrc/wkv_scan.cu",
                 "src/repro/kernels/rwkv6_scan/kernel.py:80"),
                ("ssm_scan", "src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan/kernel.py:80"),
                # phase 3e's shapes: LLaMA-2-13B (G 1, 40 KV heads) and
                # StableLM-2-12B (head_dim 160, the non-Hopper bodies)
                ("decode_attention@llama2", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:88"),
                ("mq_decode_attention@llama2",
                 "src/repro_torch/csrc/mq_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:107"),
                ("decode_attention@dh160", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:88"),
                ("flash_attention@dh160", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:104"),
                # phase 3g's shapes: DeepSeekMoE-16B (G 1, 16 heads)
                ("decode_attention@moe", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:88"),
                ("flash_attention@moe", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:104"),
                ("mq_decode_attention@moe",
                 "src/repro_torch/csrc/mq_decode_attention.cu",
                 "src/repro/kernels/decode_attention/multiquery.py:107"),
                # phase 3h's shapes: SeamlessM4T-medium's bidirectional encoder
                # (and cross prefill) and its cross-attention decode
                ("flash_attention@encdec", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:104"),
                ("decode_attention@encdec", "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:88")):
            r = rows[name]
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the main path")
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        line = {"kernels": kernels}
        if depth < 80:                   # a host-memory-forced depth cut
            line["engine_layers"] = {"served": depth, "of": 80}
        log(json.dumps(line))
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
