#!/usr/bin/env python3
"""What bounds the verify body of the multi-query kernels (verify_sm90_kernel,
kernels 4 and 5 at q_len·G <= 128)?

    python3 tools/ablate_mq.py [WORD ...]   # on a machine with one CUDA card

(with WORDs, only the cuts whose names hold one of them, and no forced
split counts)

Builds the kernels' library once as it is and once per ablation, each a
copy of csrc/ with one part of the verify body (csrc/mq_decode_attention.cuh)
or of its cluster merge (csrc/cluster_merge.cuh) cut out (the results are
wrong then; only the time means anything), and times kernel 4 at the
verify shape (B 4, q_len 5, H 64, KV 8, dh 128, pos 1019 of 1024 slots)
and at phase 3b's sporadic one (B 1, pos 516), and kernel 5 at q_len 5,
ctx 1019 (page 64, shuffled tables), with chip_smoke.py's timer (CUDA
events, L2 flushed). A part whose removal barely moves the time is not
what bounds the kernel. "rows padded to 48" makes every warp compute (the
verify shape's 40 rows take three m16 fragments, 8 of them padding). The
library as built is also timed with the split count forced (1 to 8 blocks
per cluster), and the do-nothing kernel of tools/ablate_decode.py gives
the floor under the timer. Prints the card's name and power limit, then one
JSON line per measurement.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

from ablate_decode import BARRIERS, CLUSTERS, DSMEM, launch_floor, variant  # noqa: E402

KV_COPIES = [("        cp_async16(ks + (r * L::RS + d0) * 2, k + at, in ? 16 : 0);\n"
              "        cp_async16(vs + (r * L::RS + d0) * 2, v + at, in ? 16 : 0);\n", "")]
QK = [("          mma_bf16_16816(s[nt], qa[kk], kb[0], kb[1]);\n"
       "          mma_bf16_16816(s[nt], qa[kk + 1], kb[2], kb[3]);\n", "")]
PV = [("          mma_bf16_16816(o[2 * c2], a, vb[0], vb[1]);\n"
       "          mma_bf16_16816(o[2 * c2 + 1], a, vb[2], vb[3]);\n", "")]
EXP = [("s[nt][e] = s[nt][e] <= NEG_INF ? 0.f : sm90::ex2(s[nt][e] - mrow[e >> 1]);",
        "s[nt][e] = s[nt][e] <= NEG_INF ? 0.f : s[nt][e] - mrow[e >> 1];")]
# ids s & 7: kernel 4 reads slots as built with ids 0-7 (all visible);
# kernel 5 reads pages 0-7 only, which stay in L2, so its time under this
# cut is not comparable
ID_LOADS = [("return tid < VF_TILE && t < n_t && s < s1 ? addr.fetch(b, s) : -1;",
             "return tid < VF_TILE && t < n_t && s < s1 ? (s & 7) : -1;")]
PAD = [("const bool has_rows = warp * 16 < R;", "const bool has_rows = true;")]
# where the fixed cost of a block lies: a kernel that returns at once (the
# floor of this launch: its grid, clusters, threads and shared memory), one
# that walks no tile (prologue and merge), one without Q loads
NOTHING = [("  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);\n",
            "  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);\n"
            "  if (chunk > 0) return;\n")]
NO_TILES = [("  const int n_t = s1 > s0 ? (s1 - s0 + VF_TILE - 1) / VF_TILE : 0;\n"
             "\n  // tile t's raw entries",
             "  const int n_t = 0;\n\n  // tile t's raw entries")]
NO_Q = [("      qa[kk][j] = r < R && col < dh\n", "      qa[kk][j] = false\n")]
# the parts of the merge, on a block that walks no tile
NO_PUSH = [("  if (has_rows) {\n#pragma unroll\n    for (int rr = 0; rr < 2; ++rr) {\n"
            "      const int r = wr + 8 * rr;\n",
            "  if (false) {\n#pragma unroll\n    for (int rr = 0; rr < 2; ++rr) {\n"
            "      const int r = wr + 8 * rr;\n")]
NO_FINISH = [("    for (int i = (int)threadIdx.x; i < (g1 - g0) * C4; i += (int)blockDim.x) {",
              "    for (int i = 0; i < 0; i += (int)blockDim.x) {")]
CUTS = {
    "returns at once": NOTHING,
    "no tiles (prologue and merge only)": NO_TILES,
    "no tiles, no pushes": NO_TILES + NO_PUSH,
    "no tiles, no merge arithmetic (finish)": NO_TILES + NO_FINISH,
    "no tiles, no clusters": NO_TILES + DSMEM + BARRIERS + CLUSTERS,
    "no tiles, nothing of the merge": NO_TILES + NO_PUSH + NO_FINISH + DSMEM + BARRIERS
    + CLUSTERS,
    "no Q loads": NO_Q,
    "rows padded to 48 (every warp computes)": PAD,
    "merge stores to own shared memory": DSMEM,
    "no cluster barriers": DSMEM + BARRIERS,
    "no clusters": DSMEM + BARRIERS + CLUSTERS,
    "no K/V copies": KV_COPIES,
    "no QK^T mma": QK,
    "no PV mma": PV,
    "no QK^T and PV mma": QK + PV,
    "no exp": EXP,
    "no id loads (ids s & 7)": ID_LOADS,
}
CUTS["skeleton (all cut)"] = DSMEM + BARRIERS + CLUSTERS + KV_COPIES + QK + PV + EXP \
    + ID_LOADS
# the verify shape and phase 3b's sporadic one (row key, B, S_c, pos)
SHAPES = (("mq_decode_attention", 4, 1024, 1019), ("mq_decode_attention@B1", 1, 1024, 516))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_mq: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import multiquery as mq
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    calls = {}
    for key, B, S_c, pos in SHAPES:
        a = rn(B, 5, 64, 128), rn(B, S_c, 8, 128), rn(B, S_c, 8, 128), \
            cs.linear_ids(S_c, pos + 4)
        calls[key] = lambda a=a, pos=cs.kernel_pos(pos): mq.mq_decode_attention(*a, pos)
    ctx = (1019,) * 4
    bt, n_pages = cs.shuffled_tables(ctx, 64, 16, g)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    k5 = rn(4, 5, 64, 128), rn(n_pages, 64, 8, 128), rn(n_pages, 64, 8, 128)
    calls["mq_paged_decode_attention@verify"] = \
        lambda: mq.mq_paged_decode_attention(*k5, bt, ctx_t)
    print(json.dumps({"launch floor": launch_floor(cs, build)}), flush=True)
    base_csrc, rule = build.CSRC, mq.verify_split_count
    words = sys.argv[1:]
    cuts = [(n, p) for n, p in CUTS.items() if not words or any(w in n for w in words)]
    for name, patches in [("as built", [])] + cuts:
        build.CSRC = variant(name, patches, base_csrc, "ablate_mq") if patches else base_csrc
        build._lib = None
        n0 = mq.verify_sm90_launches
        ms = {k: cs.time_ms(fn) for k, fn in calls.items()}
        if mq.verify_sm90_launches == n0:
            raise SystemExit(f"{name}: the verify body did not run")
        print(json.dumps({"library": name, "ms": ms}), flush=True)
        if name != "as built" or words:
            continue
        for n in range(1, 9):                # the split count forced
            mq.verify_split_count = lambda *a, n=n: n
            ms = {k: cs.time_ms(calls[k]) for k, *_ in SHAPES}
            print(json.dumps({"library": name, "n_split": n, "ms": ms}), flush=True)
        mq.verify_split_count = rule
    build.CSRC, build._lib = base_csrc, None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
