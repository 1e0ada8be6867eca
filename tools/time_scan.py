#!/usr/bin/env python3
"""Time the recurrent scans (kernels 6: WKV, 7: selective scan) of one or
more checkouts of the port on the card, in turns, and check which kernels'
outputs stay bit-identical between them.

    python3 tools/time_scan.py [ROOT ...]   # on a machine with one CUDA card

For each ROOT in the order given (default: this checkout), a fresh process
builds ROOT's kernels (ROOT/src/repro_torch/csrc) and, with chip_smoke.py's
timer (CUDA events, L2 flushed, host enqueue hidden), times kernel 6 at
RWKV6-3B's shapes (H 40, dh 64) and kernel 7 at Hymba-1.5B's (H 25, dh 64,
N 16): the bursty prefill (B 4, S 512), the sporadic one (B 1, S 512) and a
decode step (B 4, S 1), from a nonzero state, each checked against its
sequential plain version (SCAN_REL), with its byte bound and the profiler's
device µs per call of each CUDA kernel it launches. It also hashes the
outputs of kernels 1-5 on seeded inputs (tools/time_mq.py's) and of the
scan calls that keep the sequential body (S 1, S 50, fp32 at S 512:
output and final state), and reads how well a badly conditioned input
lets any fp32 scan match fp64: kernel 7 at B 4 with dt 20 or 1e-3 (3:7),
whole (the body its shape takes), cut into calls of 100 steps (the
sequential body) and as the fp32 plain loop, each against the fp64 loop
(chip_smoke.scan_f64). Give a root twice to see the spread (parent,
change, change, parent). Prints the card's name and power limit, one JSON
line per root, then which hashes agree across the roots.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent

# (row key, kind, shape): kernel 6 (B, S, H, dh), kernel 7 (B, S, H, dh, N)
TIMED = (("wkv B4 S512", "wkv", (4, 512, 40, 64)), ("wkv B1 S512", "wkv", (1, 512, 40, 64)),
         ("wkv B4 S1", "wkv", (4, 1, 40, 64)), ("ssm B4 S512", "ssm", (4, 512, 25, 64, 16)),
         ("ssm B1 S512", "ssm", (1, 512, 25, 64, 16)), ("ssm B4 S1", "ssm", (4, 1, 25, 64, 16)))
# the scan calls that keep the sequential body: (key, kind, shape, fp32)
SEQUENTIAL = (("wkv S1", "wkv", (4, 1, 40, 64), False),
              ("wkv S50", "wkv", (1, 50, 40, 128), False),
              ("wkv fp32 S512", "wkv", (1, 512, 4, 64), True),
              ("ssm S1", "ssm", (4, 1, 25, 64, 16), False),
              ("ssm S50", "ssm", (1, 50, 25, 128, 16), False),
              ("ssm fp32 S512", "ssm", (1, 512, 5, 64, 16), True))


def _hash(*ts) -> str:
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _scan(kind):
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    from repro_torch.kernels.ssm_scan import ops as ssm
    return (wkv.wkv, wkv.wkv_plain) if kind == "wkv" else (ssm.ssm_scan, ssm.ssm_scan_plain)


def conditioning(cs) -> dict:
    """rel_err against fp64 of kernel 7 on mixed extreme decays (seeds
    1234, 7, 99): {seed: (whole call, 100-step calls, fp32 plain loop)}."""
    import torch

    from repro_torch.kernels.ssm_scan import ops as ssm
    out = {}
    for seed in (1234, 7, 99):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        a = cs.scan_inputs("ssm", (4, 512, 25, 64, 16), gen)
        a[1] = torch.where(torch.rand(a[1].shape, generator=gen, device="cuda") < 0.3,
                           20.0, 1e-3).float()
        ref = cs.scan_f64("ssm", a)[0]
        whole = ssm.ssm_scan(*a[:5], a[5].clone())
        s = a[5].clone()
        cut = torch.cat([ssm.ssm_scan(*(t[:, lo:lo + 100].contiguous() for t in a[:4]), a[4], s)
                         for lo in range(0, 512, 100)], 1)
        out[seed] = [cs.rel_err(x, ref) for x in (whole, cut, ssm.ssm_scan_plain(*a)[0])]
    return out


def one(root: pathlib.Path) -> dict:
    """The timings and hashes of root's kernels, in this process."""
    sys.path[:0] = [str(HERE), str(HERE / "tools")]
    import chip_smoke as cs                      # puts HERE/src on sys.path
    sys.path.insert(0, str(root / "src"))        # ... behind root's package
    import torch

    from repro_torch.kernels import build
    from time_mq import hashes
    build.load()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = {}
    for key, kind, shape in TIMED:
        fn, plain = _scan(kind)
        a = cs.scan_inputs(kind, shape, gen)
        s = a[5].clone()
        out = fn(*a[:5], s)
        ref_o, ref_s = plain(*a)
        err = cs.check(key, out, ref_o, cs.SCAN_REL)
        cs.check(key + " state", s, ref_s, cs.SCAN_REL)
        byts = cs.nbytes(*a[:5]) + 2 * cs.nbytes(a[5]) + cs.nbytes(out)
        rows[key] = dict(ms=cs.time_ms(lambda: fn(*a[:5], s)),
                         bytes_bound_ms=byts / cs.HBM_BYTES_PER_S * 1e3, max_abs_err=err,
                         split=cs.pass_split(lambda: fn(*a[:5], s)))
    out = hashes(cs)
    for key, kind, shape, fp32 in SEQUENTIAL:
        fn, _ = _scan(kind)
        a = cs.scan_inputs(kind, shape, gen)
        if fp32:
            a = [t.float() for t in a]
        s = a[5].clone()
        out[key] = _hash(fn(*a[:5], s), s)
    torch.cuda.synchronize()
    return {"root": str(root), "kernels": rows, "conditioning": conditioning(cs), "hashes": out}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(pathlib.Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_scan: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    seen = {}
    for root in sys.argv[1:] or [str(HERE)]:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-3000:])
        if p.returncode:
            return p.returncode
        line = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps({k: line[k] for k in ("root", "kernels", "conditioning")}), flush=True)
        for name, h in line["hashes"].items():
            seen.setdefault(name, set()).add(h)
    print(json.dumps({"bit-identical across the roots": {
        name: len(hs) == 1 for name, hs in seen.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
