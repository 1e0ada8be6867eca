#!/usr/bin/env python3
"""Time the multi-query kernels' verify regime (4: contiguous cache, 5:
paged) of one or more checkouts of the port on the card, in turns, and
check which other kernels' outputs stay bit-identical between them.

    python3 tools/time_mq.py [ROOT ...]   # on a machine with one CUDA card

For each ROOT in the order given (default: this checkout), a fresh process
builds ROOT's kernels (ROOT/src/repro_torch/csrc) and, with chip_smoke.py's
timer (CUDA events, L2 flushed, host enqueue hidden), times kernel 4 at the
verify shape (B 4, q_len 5, H 64, KV 8, dh 128, pos 1019 of 1024 slots),
at phase 3b's in-serve shapes (B 4 and B 1 at pos 516: the 80-layer
serves verify at positions 512-527 of a 1024-slot cache) and kernel 5 at
q_len 5, ctx 1019 (page 64, shuffled tables), each checked against its
plain version, with SDPA's time, the byte bound and the time's split over
the CUDA kernels one call launches (torch.profiler). It also hashes the
outputs of kernels 1, 2, 3 and of the prefill rounds of 4 and 5 on seeded
inputs. Give a root twice to see the spread (parent, change, change,
parent). Prints the card's name and power limit, one JSON line per root,
then which hashes agree across the roots.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent

# (row key, B, pos of query 0, paged); q_len 5, H 64, KV 8, dh 128, 1024 slots
TIMED = (("verify", 4, 1019, False), ("serve B4 pos516", 4, 516, False),
         ("serve B1 pos516", 1, 516, False), ("paged verify", 4, 1019, True))


def _hash(t) -> str:
    import torch
    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def hashes(cs) -> dict:
    """Output hashes of the kernels this change must leave bit-identical."""
    import torch

    from repro_torch.kernels.decode_attention import multiquery as mq
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg
    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device="cuda").manual_seed(7)

    def rn(*shape):
        return cs.randn(shape, torch.bfloat16, g)
    out = {}
    for key, B, S_c, H, KV, dh, pos, window, *_ in cs.DECODE_TIMED:
        q, k, v = rn(B, 1, H, dh), rn(B, S_c, KV, dh), rn(B, S_c, KV, dh)
        out["kernel 1 " + key] = _hash(da.decode_attention(q, k, v, cs.linear_ids(S_c, pos),
                                                           pos, window=window))
    q, k, v = rn(4, 512, 64, 128), rn(4, 512, 8, 128), rn(4, 512, 8, 128)
    out["kernel 2 main"] = _hash(fa.flash_attention(q, k, v, causal=True))
    q, k, v = rn(4, 512, 64, 128), rn(4, 1024, 8, 128), rn(4, 1024, 8, 128)
    out["kernel 4 prefill round"] = _hash(mq.mq_decode_attention(
        q, k, v, cs.linear_ids(1024, 511), 0))
    ctx = (1019, 700, 300, 130)
    bt, n_pages = cs.shuffled_tables(ctx, 64, 16, g)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    k, v = rn(n_pages, 64, 8, 128), rn(n_pages, 64, 8, 128)
    out["kernel 3 ragged ctx"] = _hash(pg.paged_decode_attention(rn(4, 1, 64, 128), k, v, bt,
                                                                 ctx_t))
    out["kernel 5 prefill round"] = _hash(mq.mq_paged_decode_attention(
        rn(4, 128, 64, 128), k, v, bt, ctx_t))
    torch.cuda.synchronize()
    return out


def one(root: pathlib.Path) -> dict:
    """The timings and hashes of root's kernels, in this process."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                      # puts HERE/src on sys.path
    sys.path.insert(0, str(root / "src"))        # ... behind root's package
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import multiquery as mq
    build.load()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    for key, B, pos, paged in TIMED:
        q = cs.randn((B, 5, 64, 128), torch.bfloat16, gen)
        if paged:
            ctx_t = (pos + 5,) * B
            bt, n_pages = cs.shuffled_tables(ctx_t, cs.PAGE, cs.MAX_PAGES, gen)
            ctx = torch.tensor(ctx_t, dtype=torch.int32, device="cuda")
            k = cs.randn((n_pages, cs.PAGE, 8, 128), torch.bfloat16, gen)
            v = cs.randn((n_pages, cs.PAGE, 8, 128), torch.bfloat16, gen)
            out = mq.mq_paged_decode_attention(q, k, v, bt, ctx)
            err = cs.check(key, out, mq.mq_paged_decode_attention_plain(q, k, v, bt, ctx),
                           cs.BF16_REL)
            r = cs.time_paged(mq.mq_paged_decode_attention, mq.mq_paged_decode_attention_plain,
                              q, k, v, bt, ctx, err)
        else:
            k = cs.randn((B, 1024, 8, 128), torch.bfloat16, gen)
            v = cs.randn((B, 1024, 8, 128), torch.bfloat16, gen)
            ids = cs.mq_ids(1024, pos, 5, "linear")
            pos_t = cs.kernel_pos(pos)

            def fn():
                return mq.mq_decode_attention(q, k, v, ids, pos_t)
            err = cs.check(key, fn(), mq.mq_decode_attention_plain(q, k, v, ids, pos),
                           cs.BF16_REL)
            vis = cs.mq_visible(ids, pos, 5, None)
            n_read = int(vis.any(0).sum())
            byts = 2 * B * n_read * 8 * 128 * 2 + cs.nbytes(q, ids) + cs.nbytes(q)
            r = dict(max_abs_err=err, ms=cs.time_ms(fn),
                     library_ms=cs.library_time_ms(lambda: F.scaled_dot_product_attention(
                         q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         attn_mask=vis, enable_gqa=True)),
                     bytes_bound_ms=byts / cs.HBM_BYTES_PER_S * 1e3, split=cs.pass_split(fn))
        rows[key] = {f: r[f] for f in ("ms", "library_ms", "bytes_bound_ms", "max_abs_err",
                                       "split")}
    return {"root": str(root), "kernels": rows, "hashes": hashes(cs)}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(pathlib.Path(sys.argv[2]).resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_mq: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    seen = {}
    for root in sys.argv[1:] or [str(HERE)]:
        p = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True)
        sys.stderr.write(p.stdout[-6000:] + p.stderr[-3000:])
        if p.returncode:
            return p.returncode
        line = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps({k: line[k] for k in ("root", "kernels")}), flush=True)
        for name, h in line["hashes"].items():
            seen.setdefault(name, set()).add(h)
    print(json.dumps({"bit-identical across the roots": {
        name: len(hs) == 1 for name, hs in seen.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
