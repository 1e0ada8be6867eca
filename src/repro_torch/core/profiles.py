"""Device profiles for the cost model (counterpart of
``repro.core.profiles``).

``DeviceProfile`` is the JAX package's record unchanged; its profiles of
the paper's testbed (Jetson devices, the E1-E3 environments) stay with the
JAX package as the simulator's data. The port plans for one card, the
H100 below. Its load path is the paper's SSD read made concrete: pinned
host memory copied into HBM over PCIe on a side stream.
"""
from __future__ import annotations

import dataclasses

GB = 1024 ** 3
MB = 1024 ** 2


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    mem_bytes: float           # usable accelerator memory for weights + KV
    flops: float               # effective dense fp16/bf16 FLOP/s
    mem_bw: float              # HBM bandwidth (bytes/s) — decode bound
    load_bw: float             # weight-residency restore bandwidth (bytes/s)
    load_write_bw: float = 0.0 # write-back bandwidth (0 = no write-back)
    host_bw: float = 0.0       # host-RAM -> device staging bandwidth
                               # (0 = same as load_bw)

    def scaled_mem(self, frac: float) -> "DeviceProfile":
        return dataclasses.replace(self, name=f"{self.name}[{frac:.0%}mem]",
                                   mem_bytes=self.mem_bytes * frac)


# NVIDIA H100 80GB HBM3 (SXM5) at a 700 W power limit, as `nvidia-smi
# --query-gpu=name,power.limit` names it. Data-sheet peaks: 989.4 TFLOP/s
# dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB. The sustained
# shares come from this card's runs of chip_smoke.py phase 3b (PERF.md §6):
#   mem_bw   2.85e12: a B 4 decode pass of the 80-layer engine spends
#            48.0-48.3 ms in GEMMs reading ~137 GB of weights (the resident
#            layers and the streamed layers' buffers), 0.85 of the peak;
#   flops    0.79 of the peak: the GEMMs of a 2048-row chunked-prefill
#            round of the same engine ran at 782-793 TFLOP/s;
#   load_bw  44.77e9: pinned host -> HBM one-layer copies on a side stream
#            (38.5-55.0 GB/s across machines).
# mem_bytes and load_bw are replaced at run time by the measured weight
# budget and H2D rate (launch/serve.py cost_env), as the JAX launcher
# replaces its profile's fields with measured ones.
H100_SXM = DeviceProfile(
    name="h100-sxm5-80gb",
    mem_bytes=80e9,
    flops=989.4e12 * 0.79,
    mem_bw=2.85e12,
    load_bw=44.77e9,
)


def mbps(x: float) -> float:
    """Network bandwidth helper: Mbps -> bytes/s (paper uses 100/200 Mbps)."""
    return x * 1e6 / 8
