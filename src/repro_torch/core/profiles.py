"""Device profiles for the cost model and the simulator (counterpart of
``repro.core.profiles``).

``DeviceProfile`` is the JAX package's record unchanged. Two kinds of
profile flow through the same cost model, scheduler and simulator:

  the paper's testbed  Tab. II's Jetson devices with NVMe SSDs and the
                       environments E1-E3 and the low-memory settings of
                       §V-C, the simulator's data (core/pipeline_sim.py,
                       core/baselines.py); their figures are the JAX
                       package's calibration knobs, not measurements
  the port's card      the H100 below, which the launcher and the engine
                       plan for; its load path is the paper's SSD read
                       made concrete: pinned host memory copied into HBM
                       over PCIe on a side stream

The JAX package's TPU profile is left out: its figures are a TPU's.
"""
from __future__ import annotations

import dataclasses
from typing import List

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


# --- the paper's Tab. II devices ---------------------------------------------
# Jetson memory is unified CPU+GPU: the OS, the framework and the CUDA
# context take ~2.5 GB before the model sees a byte, then ~8% headroom for
# activations and fragmentation. Unified memory also means TPI-LLM's "CPU
# RAM" sliding window streams from the same NVMe when the shard exceeds
# device memory: host_bw == load_bw. Effective FLOP/s: the vendor's INT8
# TOPS halved for fp16 at a 30% sustained share. These are the JAX
# package's calibration knobs, unchanged; the paper's claims are relative
# speedups, insensitive to a common scale.
def _jetson(name, mem_gb, tops, mem_bw_gbs, nvme_read_gbs, nvme_write_gbs):
    return DeviceProfile(
        name=name,
        mem_bytes=(mem_gb - 4.0) * 0.90 * GB,
        flops=tops * 1e12 * 0.30 * 0.5,     # INT8->fp16 halves, 30% sustained
        mem_bw=mem_bw_gbs * 0.7 * GB,
        load_bw=nvme_read_gbs * GB,
        load_write_bw=nvme_write_gbs * GB,
        host_bw=nvme_read_gbs * GB,
    )


XAVIER_NX_16 = _jetson("xavier-nx-16g", 16, 21, 59.7, 1.0, 0.8)
AGX_ORIN_32 = _jetson("agx-orin-32g", 32, 200, 204.8, 2.0, 1.4)
AGX_ORIN_64 = _jetson("agx-orin-64g", 64, 275, 204.8, 2.5, 1.8)


# --- the paper's experimental environments (Tab. IV, §V-C) -------------------
def env_E1() -> List[DeviceProfile]:
    return [XAVIER_NX_16, AGX_ORIN_32]


def env_E2() -> List[DeviceProfile]:
    return [XAVIER_NX_16, AGX_ORIN_32, AGX_ORIN_64]


def env_E3() -> List[DeviceProfile]:
    return [XAVIER_NX_16, AGX_ORIN_32, AGX_ORIN_64, AGX_ORIN_64]


def env_lowmem(setting: int) -> List[DeviceProfile]:
    """§V-C Settings 1-3, progressively tighter memory (Qwen3-32B / 70B)."""
    base = [AGX_ORIN_64, AGX_ORIN_32, AGX_ORIN_32, XAVIER_NX_16, XAVIER_NX_16]
    if setting >= 2:
        base[3] = XAVIER_NX_16.scaled_mem(0.5)
    if setting >= 3:
        frac = (32 * 0.85 - 8) / (32 * 0.85)   # 8 GB made unavailable
        base[1] = AGX_ORIN_32.scaled_mem(frac)
    return base


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
# mem_bytes is replaced at run time by the weight budget, and load_bw by
# the H2D rate that tune/measure.py's measure_stream_bw times (pinned host
# rows copied into HBM on a side stream, CUDA events); with --measure or a
# tune cache every timed field (flops, mem_bw, load_bw, load_write_bw,
# host_bw) comes from tune/measure.py's measure_profile (launch/serve.py
# cost_env), as the JAX launcher replaces its profile's fields with
# measured ones.
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
