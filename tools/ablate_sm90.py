#!/usr/bin/env python3
"""What bounds the Hopper attention mainloop (csrc/attention_sm90.cuh)?

    python3 tools/ablate_sm90.py      # on a machine with one CUDA card

Builds the kernels' library once as it is and once per ablation, each a
copy of csrc/ with one part of the mainloop cut out (the results are wrong
then; only the time means anything), and times flash at LLaMA-3.3-70B's
and Hymba-1.5B's prefill shapes and kernel 5's prefill round with
chip_smoke.py's timer (CUDA events, L2 flushed). A part whose removal
barely moves the time is not what bounds the kernel. Prints one JSON line
per library, and the card's name and power limit first.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

HEADER = "attention_sm90.cuh"
S_WGMMA = "        wgmma_ss_m64n64k16(s, dq + q_off, dk + k_off, kk > 0);\n"
PV_WGMMA = ("      wgmma_pv<DHP>(o, pa, smem_u32(sm + L::V_OFF + (prev < 0 ? stage : prev) "
            "* L::TILE));\n      wgmma_commit();\n      wgmma_wait<1>();")
EXP = "s[i] = ex2(fmaf(s[i], scale_log2, -mrow[(i >> 1) & 1]));"
TMA_KV = ("              tma_load_4d(ks + at, &k_map, full, c * 64, kvh, r, o);\n"
          "              tma_load_4d(vs + at, &v_map, full, c * 64, kvh, r, o);\n")
TX = "        if (lane == 0) mbar_expect_tx(full, 2u * NB * box_tx * (uint32_t)__popc(boxes));"
CUTS = {
    "no S wgmma": [(S_WGMMA, "        (void)q_off, (void)k_off;\n")],
    "no PV wgmma": [(PV_WGMMA, "      wgmma_wait<0>();")],
    "no exp (unmasked tiles)": [(EXP, "s[i] = fmaf(s[i], scale_log2, -mrow[(i >> 1) & 1]);")],
    "no K/V TMA": [(TMA_KV, ""), (TX, "        if (lane == 0) mbar_arrive(full);")],
}
CUTS["skeleton (all four cut)"] = [p for v in CUTS.values() for p in v]


def variant(name, patches, csrc):
    """csrc copied under build/ablate/<name>/ with the patches applied."""
    dst = ROOT / "build" / "ablate" / re.sub(r"[^a-z0-9]+", "_", name.lower()) / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    src = (dst / HEADER).read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the mainloop no longer has {old.strip()[:60]!r}")
        src = src.replace(old, new)
    (dst / HEADER).write_text(src)
    return dst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_sm90: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.flash_attention import ops as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    llama = rn(4, 512, 64, 128), rn(4, 512, 8, 128), rn(4, 512, 8, 128)
    hymba = rn(4, 512, 25, 64), rn(4, 512, 5, 64), rn(4, 512, 5, 64)
    ctx = (1019,) * 4
    bt, n_pages = cs.shuffled_tables(ctx, 64, 16, g)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    k5 = rn(4, 128, 64, 128), rn(n_pages, 64, 8, 128), rn(n_pages, 64, 8, 128)
    calls = {
        "flash llama": lambda: fa.flash_attention(*llama),
        "flash hymba": lambda: fa.flash_attention(*hymba, window=1024),
        "kernel 5 round": lambda: mq.mq_paged_decode_attention(*k5, bt, ctx_t),
    }
    base_csrc = build.CSRC
    for name, patches in [("as built", [])] + list(CUTS.items()):
        build.CSRC = variant(name, patches, base_csrc) if patches else base_csrc
        build._lib = None
        ms = {k: cs.time_ms(fn) for k, fn in calls.items()}
        print(json.dumps({"library": name, "ms": ms}), flush=True)
    build.CSRC, build._lib = base_csrc, None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
