#!/usr/bin/env python3
"""What bounds the Hopper decode body (decode_sm90_kernel, kernels 1 and 3)?

    python3 tools/ablate_decode.py      # on a machine with one CUDA card

Builds the kernels' library once as it is and once per ablation, each a
copy of csrc/ with one part of csrc/decode_attention.cuh (or of the merge
it includes, csrc/cluster_merge.cuh) cut out (the results are wrong then;
only the time means anything), and times kernel 1
at its main, B 1 and Hymba shapes and kernel 3 at its main shape with
chip_smoke.py's timer (CUDA events, L2 flushed). A part whose removal
barely moves the time is not what bounds the kernel. The library as built
is also timed at the main and B 1 shapes with the split count forced
(1 to 8 blocks per cluster), and a kernel that does nothing is timed at
the main shape's grid, launched plainly and as clusters: the floor under
the timer. Prints the card's name and power limit, then one JSON line per
measurement.
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

DSMEM = [("return cg::this_cluster().map_shared_rank(rA + (rank * rpo + g - o * rpo) * RST, o);",
          "return rA + (rank * rpo + g - o * rpo) * RST;"),
         ("*cg::this_cluster().map_shared_rank(rM + rank * GM + g, o) = m;",
          "rM[rank * GM + g] = m;"),
         ("*cg::this_cluster().map_shared_rank(rL + rank * GM + g, o) = l;",
          "rL[rank * GM + g] = l;")]
BARRIERS = [(f'asm volatile("barrier.cluster.{op}.aligned;\\n" ::: "memory");', "")
            for op in ("arrive.relaxed", "arrive.release", "wait.acquire")]
CLUSTERS = [("attr[0].val.clusterDim.x = n_split;", "attr[0].val.clusterDim.x = 1;")]
KV_COPIES = [("        cp_async16(ks + (r * L::KS + d0) * 2, k + off, in ? 16 : 0);\n"
              "        cp_async16(vs + (r * DHP + d0) * 2, v + off, in ? 16 : 0);\n", "")]
PV = [("acc[4 * g4 + i][e] += pv[i] * vv[e];", ";")]
Q_LOADS = [("? ld_u32(qb + g * dh + col) : 0u;", "? 0u : 0u;")]
# ids s & 7: kernel 1 reads the same rows as built; kernel 3 reads pages
# 0-7 only, which stay in L2, so its time under this cut is not comparable
ID_LOADS = [("return t < n_t && s < s1 ? a.fetch(s) : -1;", "return t < n_t && s < s1 ? (s & 7) : -1;")]
QK = [("        mma_bf16_16816(s, qa[kk], kb[0], kb[1]);\n"
       "        mma_bf16_16816(s2, qa[kk + 1], kb[2], kb[3]);\n", "")]
ONE_PER_SM = [("  return Sm90Geom<DHP, GM>::BYTES;",
               "  return Sm90Geom<DHP, GM>::BYTES > (120 << 10) ? Sm90Geom<DHP, GM>::BYTES\n"
               "                                                 : (120 << 10);")]
CUTS = {
    "one block per SM (120 KB of shared memory)": ONE_PER_SM,
    "merge stores to own shared memory": DSMEM,
    "no cluster barriers": DSMEM + BARRIERS,
    "no clusters": DSMEM + BARRIERS + CLUSTERS,
    "no K/V copies": KV_COPIES,
    "no PV": PV,
    "no QK^T mma": QK,
    "no Q loads": Q_LOADS,
    "no id loads (ids s & 7)": ID_LOADS,
}
CUTS["skeleton (all cut)"] = DSMEM + BARRIERS + CLUSTERS + KV_COPIES + PV + QK + Q_LOADS \
    + ID_LOADS


# The launch floor: kernels that do nothing but what every decode launch
# does (one store a block), at the main shape's grid of 512 blocks of 128
# threads, launched plainly or as clusters, with and without the body's
# 57 KB of dynamic shared memory.
FLOOR_CU = r"""
#include <cuda_runtime.h>
__global__ void floor_kernel(float* out, int cluster, int smem) {
  extern __shared__ float sm[];
  if (cluster) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    float x = blockIdx.x;
    if (smem) {
      sm[0] = x;
      x = sm[0];
    }
    out[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)] = x;
  }
}
extern "C" int floor_launch(float* out, int smem, int cluster, void* stream) {
  cudaFuncSetAttribute(floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(floor_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (cluster == 0) {
    floor_kernel<<<dim3(16, 8, 4), 128, smem, (cudaStream_t)stream>>>(out, 0, smem);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16, 8, 4);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, floor_kernel, out, 1, smem);
}
"""


def launch_floor(cs, build):
    """Device ms of FLOOR_CU's kernel: plain or clustered (1, 8, 16 blocks),
    0 or 57 KB of shared memory."""
    import ctypes

    import torch
    d = ROOT / "build" / "ablate_decode"
    d.mkdir(parents=True, exist_ok=True)
    (d / "floor.cu").write_text(FLOOR_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(d / "floor.so"),
                    str(d / "floor.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "floor.so"))
    lib.floor_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(512, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for smem in (0, 57 << 10):
        for cluster in (0, 1, 8, 16):
            def fn():
                rc = lib.floor_launch(out.data_ptr(), smem, cluster, stream)
                if rc:
                    raise RuntimeError(f"floor_launch: CUDA error {rc}")
            ms[f"smem {smem >> 10} KB, cluster {cluster or 'none'}"] = cs.time_ms(fn)
    return ms


def variant(name, patches, csrc, tool="ablate_decode"):
    """csrc copied under build/<tool>/<name>/ with the patches applied: each
    to the one header (csrc/*.cuh) that holds its text exactly once."""
    dst = ROOT / "build" / tool / re.sub(r"[^a-z0-9]+", "_", name.lower()) / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for old, new in patches:
        holders = [h for h in sorted(dst.glob("*.cuh")) if h.read_text().count(old) == 1]
        if len(holders) != 1:
            raise SystemExit(f"{name}: no one header has {old.strip()[:60]!r} once")
        holders[0].write_text(holders[0].read_text().replace(old, new))
    return dst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate_decode: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import paged as pg
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    calls = {}
    for key, B, S_c, H, KV, dh, pos, window, *_ in cs.DECODE_TIMED:
        a = rn(B, 1, H, dh), rn(B, S_c, KV, dh), rn(B, S_c, KV, dh), cs.linear_ids(S_c, pos)
        calls[key] = (lambda a=a, pos=cs.kernel_pos(pos), window=window:
                      da.decode_attention(*a, pos, window=window))
    ctx = (1019,) * 4
    bt, n_pages = cs.shuffled_tables(ctx, 64, 16, g)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    k3 = rn(4, 1, 64, 128), rn(n_pages, 64, 8, 128), rn(n_pages, 64, 8, 128)
    calls["paged_decode_attention"] = lambda: pg.paged_decode_attention(*k3, bt, ctx_t)
    print(json.dumps({"launch floor": launch_floor(cs, build)}), flush=True)
    base_csrc, rule = build.CSRC, da.split_count
    for name, patches in [("as built", [])] + list(CUTS.items()):
        build.CSRC = variant(name, patches, base_csrc) if patches else base_csrc
        build._lib = None
        ms = {k: cs.time_ms(fn) for k, fn in calls.items()}
        print(json.dumps({"library": name, "ms": ms}), flush=True)
        if name not in ("as built", "no clusters"):
            continue
        for n in (1, 2, 4, 8):               # the split count forced
            da.split_count = pg.split_count = lambda *a, n=n: n
            ms = {k: cs.time_ms(calls[k]) for k in ("decode_attention", "decode_attention@B1")}
            print(json.dumps({"library": name, "n_split": n, "ms": ms}), flush=True)
        da.split_count = pg.split_count = rule
    build.CSRC, build._lib = base_csrc, None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
