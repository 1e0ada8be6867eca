#!/usr/bin/env python3
"""Time the one-token decode kernels (1: contiguous cache, 3: paged) of one
or more checkouts of the port on the card, in turns.

    python3 tools/time_decode.py [ROOT ...]   # on a machine with one CUDA card

For each ROOT in the order given (default: this checkout), a fresh process
builds ROOT's kernels (ROOT/src/repro_torch/csrc) and runs chip_smoke.py's
decode timings against them: kernel 1 at its main, B 1 and Hymba shapes and
kernel 3 at its main shape, each checked against its plain version, with
its device time (CUDA events, L2 flushed), SDPA's, the byte bound and the
time's split over the CUDA kernels one call launches. Give a root twice to
see the spread (parent, change, change, parent). Prints the card's name and
power limit, then one JSON line per root.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def one(root: pathlib.Path) -> dict:
    """The timings of root's kernels, in this process."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                      # puts HERE/src on sys.path
    sys.path.insert(0, str(root / "src"))        # ... behind root's package
    import torch

    from repro_torch.kernels import build
    build.load()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    cs.decode_timed(gen, rows)
    cs.paged_decode_timed(gen, rows)
    keep = ("ms", "library_ms", "plain_ms", "bytes_bound_ms", "max_abs_err", "split")
    return {"root": str(root), "kernels": {k: {f: r[f] for f in keep}
                                           for k, r in rows.items()}}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(pathlib.Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for root in sys.argv[1:] or [str(HERE)]:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        sys.stderr.write(p.stdout[-6000:] + p.stderr[-3000:])
        if p.returncode:
            return p.returncode
        print(p.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
