"""The execution plan's geometry (counterpart of the engine-facing part of
``repro.core.cost_model``: ``StageAlloc`` and ``ExecutionPlan``).

A plan cuts the L layers into C = n_seg · n_stage contiguous chunks;
chunk c runs on stage c mod n_stage and holds that stage's k_res resident
layers followed by its k_off streamed ones. The JAX package's cost terms
(compute, communication, uncovered load time) and the block-split
offload fields are not ported yet: the port's plans stream whole layers.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class StageAlloc:
    """Per-stage allocation: fully-resident layers across all segments,
    and layers streamed in per segment."""
    resident_total: int
    off_full_seg: int = 0

    def layers_total(self, n_seg: int) -> int:
        return self.resident_total + n_seg * self.off_full_seg

    def k_res(self, n_seg: int) -> int:
        """Resident layers per chunk (ceil: a remainder that does not
        divide the segments pads the grid with identity slots)."""
        return -(-self.resident_total // max(n_seg, 1))

    @property
    def k_off(self) -> int:
        return self.off_full_seg


@dataclasses.dataclass
class ExecutionPlan:
    n_seg: int
    stages: List[StageAlloc]

    @property
    def n_stage(self) -> int:
        return len(self.stages)

    @property
    def n_chunks(self) -> int:
        return self.n_seg * self.n_stage

    @property
    def k_res_list(self):
        return tuple(st.k_res(self.n_seg) for st in self.stages)

    @property
    def k_off_list(self):
        return tuple(st.k_off for st in self.stages)

    @property
    def k_max(self) -> int:
        return max(r + o for r, o in zip(self.k_res_list, self.k_off_list))

    @property
    def n_layers(self) -> int:
        """Grid capacity (>= layers_total when resident counts do not
        divide the segments; the overhang is identity padding)."""
        return self.n_seg * sum(r + o for r, o in
                                zip(self.k_res_list, self.k_off_list))

    def layers_total(self) -> int:
        return sum(st.layers_total(self.n_seg) for st in self.stages)

    @property
    def is_uniform(self) -> bool:
        return len({(st.resident_total, st.off_full_seg)
                    for st in self.stages}) <= 1

    @property
    def k_res(self) -> int:
        assert self.is_uniform, "k_res is per-stage on heterogeneous plans"
        return self.stages[0].k_res(self.n_seg)

    @property
    def k_off(self) -> int:
        assert self.is_uniform, "k_off is per-stage on heterogeneous plans"
        return self.stages[0].k_off

    @property
    def k(self) -> int:
        return self.k_res + self.k_off

    @classmethod
    def uniform(cls, n_stage: int, n_seg: int, k_res: int,
                k_off: int) -> "ExecutionPlan":
        return cls(n_seg=n_seg,
                   stages=[StageAlloc(resident_total=k_res * n_seg,
                                      off_full_seg=k_off)
                           for _ in range(n_stage)])
