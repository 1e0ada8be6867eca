#!/usr/bin/env python3
"""What bounds the chunked bodies of the recurrent scans (kernels 6 and 7,
csrc/scan_chunked.cuh), and their one-step decode launches?

    python3 tools/ablate_scan.py [WORD ...]   # on a machine with one CUDA card

(with WORDs, only the cuts whose names hold one of them)

Builds the kernels' library once as it is and once per ablation, each a
copy of csrc/ with one part cut out (the results are wrong then; only the
time means anything), and times kernel 6 at RWKV6-3B's prefill shapes
(B 4 and B 1, S 512, H 40, dh 64) and kernel 7 at Hymba-1.5B's (H 25, N
16), and both at a decode step (B 4, S 1, the sequential body), with
chip_smoke.py's timer (CUDA events, L2 flushed). A part whose removal
barely moves the time is not what bounds the kernel. The cuts: the launch
returning at once (chunked and sequential bodies), the diagonal blocks /
C·Bᵀ and the decay matrix (the intra-chunk scores), the intra-chunk
products (D·v, M·x), the recurrence over chunk states, the cluster
(blocks alone: no cluster barriers, clusters of 1), the three-term
operands cut to two terms and to one, and forced chunk lengths of 32, 64
and 128 steps. The do-nothing
kernel of tools/ablate_decode.py gives the floor under the timer. Prints
the card's name and power limit, then one JSON line per measurement.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

from ablate_decode import BARRIERS, CLUSTERS, launch_floor  # noqa: E402

_WKV_TOP = ("  const int rounds = (n_chunks + n - 1) / n;\n"
            "  float* st = state + (size_t)bh * DH * DH;\n")
CHUNKED_RETURNS = [(_WKV_TOP, _WKV_TOP + "  if (S > 0) return;\n"),
                   ("  const float a_h = A[hd];\n  float* st = state + (size_t)bh * N * DH;\n",
                    "  const float a_h = A[hd];\n  float* st = state + (size_t)bh * N * DH;\n"
                    "  if (S > 0) return;\n")]
SEQUENTIAL_RETURNS = [("  const int j = threadIdx.x;\n",
                       "  const int j = threadIdx.x;\n  if (S > 0) return;\n"),
                      ("  const int d = threadIdx.x;\n",
                       "  const int d = threadIdx.x;\n  if (S > 0) return;\n")]
# the intra-chunk scores: WKV's diagonal blocks, the selective scan's
# C·Bᵀ ⊙ F ⊙ dt
SCORES = [("        for (int x = 0; x < CPG; ++x) {", "        for (int x = 0; x < 0; ++x) {"),
          ("for (int task = warp; task < (L / 16) * (L / 16); task += Gm::NW) {",
           "for (int task = warp; task < 0; task += Gm::NW) {")]
INTRA = [("            mma_bf16_16816(c3[j], a, bv[0], bv[1]);\n", ""),
         ("          mma_3e(o, m3a, LS, 16 * rt, 16 * kk, bx);\n", "")]
PREFIX = [("    chain.run(n_round, xbh + (size_t)q * n * Chain::SLOT, 1);\n", ""),
          ("    chain.run(n_round, xbh + (size_t)q * n * Chain::SLOT, 0);\n", "")]
# the three-term operands cut: the products of order 2 (TWO_TERMS), of
# orders 1 and 2 (ONE_TERM)
_ORDER2 = ("  mma_bf16_16816(c[2], a[0], b[2][0], b[2][1]);\n"
           "  mma_bf16_16816(c[2], a[1], b[1][0], b[1][1]);\n"
           "  mma_bf16_16816(c[2], a[2], b[0][0], b[0][1]);\n")
_ORDER1 = ("  mma_bf16_16816(c[1], a[0], b[1][0], b[1][1]);\n"
           "  mma_bf16_16816(c[1], a[1], b[0][0], b[0][1]);\n")


def _terms(n):
    return [(_ORDER2, ""),
            ("  for (int j = 0; j < 3; ++j) {\n    uint32_t a[4];",
             f"  for (int j = 0; j < {n}; ++j) {{\n    uint32_t a[4];"),
            ("          for (int j = 0; j < 3; ++j) {\n            uint32_t a[4];",
             f"          for (int j = 0; j < {n}; ++j) {{\n            uint32_t a[4];"),
            ("          for (int j = 0; j < 3; ++j) {\n            uint32_t bh3[4];",
             f"          for (int j = 0; j < {n}; ++j) {{\n            uint32_t bh3[4];")]


TWO_TERMS = _terms(2)
ONE_TERM = _terms(1) + [(_ORDER1, "")]


def chunk_len(n):
    return [("static constexpr int L = DH == 128 ? 32 : 64;  // steps per chunk",
             f"static constexpr int L = {n};  // steps per chunk"),
            ("struct SsmChunkGeom {\n  static constexpr int L = 64;",
             f"struct SsmChunkGeom {{\n  static constexpr int L = {n};")]


# the parts of a block's work: the staging copies, the decay products of
# step 2, the chunk's dS (step 4), the outputs (step 6)
COPIES = [("        cp_async16(smem_addr(rs + t * RS + d0), r + off, in ? 16 : 0);\n"
           "        cp_async16(smem_addr(ks + t * RS + d0), k + off, in ? 16 : 0);\n"
           "        cp_async16(smem_addr(vs + t * RS + d0), v + off, in ? 16 : 0);\n", ""),
          ("          cp_async16(smem_addr(ws + t * WS + d0),\n"
           "                     w + (((size_t)b * S + t0 + t) * H + h) * DH + d0, 16);\n", ""),
          ("        cp_async16(smem_addr(xs + t * XS + d0), x + off, in ? 16 : 0);\n", "")]
PRODUCTS = [("      for (int x = tid; x < DH * NSUB; x += THREADS) {",
             "      for (int x = tid; x < 0; x += THREADS) {")]
DELTA = [("      {\n        Cols acc;", "      if (false) {\n        Cols acc;"),
         ("      if (tile.owner) {\n        float d[SP][2][4];",
          "      if (false) {\n        float d[SP][2][4];")]
OUTPUTS = [("    if (has) {\n      Cols sc;", "    if (false) {\n      Cols sc;"),
           ("    if (has) {\n      if (tile.owner) {\n        state_load_cg(",
            "    if (false) {\n      if (tile.owner) {\n        state_load_cg(")]

# the fences before the cluster barriers (every occurrence)
FENCES = [("    __threadfence();\n", "", "all")]

CUTS = {
    "chunked launch returns at once": CHUNKED_RETURNS,
    "sequential (decode) launch returns at once": SEQUENTIAL_RETURNS,
    "no intra-chunk scores (diagonal blocks; C·Bᵀ, F)": SCORES,
    "no intra-chunk products (D·v; M·x)": INTRA,
    "no intra-chunk scores or products": SCORES + INTRA,
    "no recurrence over chunk states": PREFIX,
    "no staging copies": COPIES,
    "no decay products (WKV step 2)": PRODUCTS,
    "no chunk dS (step 4)": DELTA,
    "no outputs (step 6)": OUTPUTS,
    "no cluster (blocks alone, no barriers)": BARRIERS + CLUSTERS,
    "no fences before the cluster barriers": FENCES,
    "operands as two terms (hi + mid)": TWO_TERMS,
    "operands as one term (hi)": ONE_TERM,
    "chunk length 32": chunk_len(32),
    "chunk length 64": chunk_len(64),
    "chunk length 128": chunk_len(128),
}
# (row key, kind, shape)
SHAPES = (("wkv B4", "wkv", (4, 512, 40, 64)), ("wkv B1", "wkv", (1, 512, 40, 64)),
          ("wkv S1", "wkv", (4, 1, 40, 64)), ("ssm B4", "ssm", (4, 512, 25, 64, 16)),
          ("ssm B1", "ssm", (1, 512, 25, 64, 16)), ("ssm S1", "ssm", (4, 1, 25, 64, 16)))


def variant(name, patches, csrc):
    """csrc copied under build/ablate_scan/<name>/ with the patches applied,
    each (old, new) to the one source (*.cu or *.cuh) that holds its text
    exactly once, each (old, new, "all") to every occurrence in one source;
    a patch whose text no source holds so is refused."""
    dst = ROOT / "build" / "ablate_scan" / re.sub(r"[^a-z0-9]+", "_", name.lower()) / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for old, new, *every in patches:
        holders = [h for h in sorted(dst.glob("*.cu*"))
                   if (h.read_text().count(old) >= 1 if every else h.read_text().count(old) == 1)]
        if len(holders) != 1:
            raise SystemExit(f"{name}: no one source has {old.strip()[:60]!r} once")
        holders[0].write_text(holders[0].read_text().replace(old, new))
    return dst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_scan: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    from repro_torch.kernels.ssm_scan import ops as ssm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {}
    for key, kind, shape in SHAPES:
        a = cs.scan_inputs(kind, shape, gen)
        fn = wkv.wkv if kind == "wkv" else ssm.ssm_scan
        calls[key] = lambda a=a, fn=fn: fn(*a[:5], a[5])
    print(json.dumps({"launch floor": launch_floor(cs, build)}), flush=True)
    base = build.CSRC
    words = sys.argv[1:]
    cuts = [(n, p) for n, p in CUTS.items() if not words or any(w in n for w in words)]
    chunk_len, chunk = wkv.chunk_len, ssm.CHUNK
    for name, patches in [("as built", [])] + cuts:
        build.CSRC = variant(name, patches, base) if patches else base
        build._lib = None
        forced = re.match(r"chunk length (\d+)", name)   # the wrappers size the
        wkv.chunk_len = (lambda dh, n=int(forced.group(1)): n) if forced else chunk_len
        ssm.CHUNK = int(forced.group(1)) if forced else chunk   # exchange buffer by it
        n0 = wkv.chunked_launches + ssm.chunked_launches
        ms = {k: cs.time_ms(fn) for k, fn in calls.items()}
        if wkv.chunked_launches + ssm.chunked_launches == n0:
            raise SystemExit(f"{name}: the chunked bodies did not run")
        print(json.dumps({"library": name, "ms": ms}), flush=True)
    build.CSRC, build._lib = base, None
    wkv.chunk_len, ssm.CHUNK = chunk_len, chunk
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
