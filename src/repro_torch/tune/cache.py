"""TuneCache: one JSON file holding everything the autotuner learned
(counterpart of ``repro.tune.cache``; the file format is JAX's, so a
file written by either package loads in the other).

Two sections, both keyed by device kind (``torch.cuda.get_device_name``
or "cpu": measurements from a different device must never be replayed):

  - ``profiles``: device_kind -> MeasuredProfile dict (measure.py)
  - ``kernels``:  device_kind -> kernel -> shape-bucket -> config
                  (sweep.py winners; int launch knobs plus ``_``-prefixed
                  meta like ``_speedup`` / ``_us`` that `kernel_table`
                  strips before installing)

``install`` bridges to the kernels package: it builds the plain
``{kernel: {bucket: {param: int}}}`` table and hands it to
``repro_torch.kernels.tuning.set_tuning_table``; remember the
install-before-capture caveat documented there.

File format is versioned and written atomically (tmp + rename) with the
repo's NaN->null JSON convention.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Mapping, Optional

from repro_torch.kernels import tuning
from repro_torch.obs.log import get_logger
from repro_torch.tune.profiles import MeasuredProfile

VERSION = 1


class TuneCache:
    """In-memory view of the tune cache; load/save are explicit."""

    def __init__(self) -> None:
        self.profiles: Dict[str, MeasuredProfile] = {}
        self.kernels: Dict[str, Dict[str, Dict[str, Dict]]] = {}

    # -- profiles --------------------------------------------------------------
    def put_profile(self, prof: MeasuredProfile) -> None:
        if not prof.device_kind:
            raise ValueError("MeasuredProfile.device_kind is required as "
                             "the cache key")
        self.profiles[prof.device_kind] = prof

    def get_profile(self, device_kind: str) -> Optional[MeasuredProfile]:
        return self.profiles.get(device_kind)

    # -- kernel configs --------------------------------------------------------
    def put_kernel(self, device_kind: str, kernel: str, bucket: str,
                   cfg: Mapping[str, int], **meta) -> None:
        """Record a sweep winner. `cfg` holds the launch knobs exactly as
        the wrapper takes them; `meta` kwargs are stored ``_``-prefixed."""
        row = {k: int(v) for k, v in cfg.items()}
        row.update({"_" + k: v for k, v in meta.items()})
        self.kernels.setdefault(device_kind, {}) \
                    .setdefault(kernel, {})[bucket] = row

    def get_kernel(self, device_kind: str, kernel: str,
                   bucket: str) -> Optional[Dict]:
        return self.kernels.get(device_kind, {}).get(kernel, {}).get(bucket)

    def kernel_table(self, device_kind: str) -> Dict[str, Dict[str, Dict]]:
        """The ``{kernel: {bucket: {param: int}}}`` shape
        `repro_torch.kernels.tuning` consumes, meta keys stripped."""
        out: Dict[str, Dict[str, Dict]] = {}
        for kernel, buckets in self.kernels.get(device_kind, {}).items():
            for bucket, row in buckets.items():
                cfg = {k: v for k, v in row.items()
                       if not k.startswith("_")}
                if cfg:
                    out.setdefault(kernel, {})[bucket] = cfg
        return out

    def install(self, device_kind: str) -> int:
        """Install this cache's tuned kernel configs for `device_kind`
        as the process-wide table; returns the number of (kernel,
        bucket) entries installed (0 clears nothing: an empty table is
        not installed, so defaults stay untouched)."""
        table = self.kernel_table(device_kind)
        n = sum(len(b) for b in table.values())
        if n:
            tuning.set_tuning_table(table)
        return n

    # -- persistence -----------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "version": VERSION,
            "profiles": {k: p.to_dict() for k, p in self.profiles.items()},
            "kernels": self.kernels,
        }

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=2, sort_keys=True,
                          allow_nan=False)
                f.write("\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def from_dict(cls, d: Mapping) -> "TuneCache":
        if not isinstance(d, Mapping):
            raise ValueError("tune cache is not a JSON object")
        ver = d.get("version", 0)
        if ver != VERSION:
            get_logger("repro_torch.tune").warning(
                "tune cache version mismatch; ignoring contents",
                found=ver, expected=VERSION)
            return cls()
        c = cls()
        for k, pd in (d.get("profiles") or {}).items():
            c.profiles[k] = MeasuredProfile.from_dict(pd)
        for dk, kernels in (d.get("kernels") or {}).items():
            for kernel, buckets in kernels.items():
                c.kernels.setdefault(dk, {})[kernel] = {
                    b: dict(row) for b, row in buckets.items()}
        return c

    @classmethod
    def load(cls, path: str) -> "TuneCache":
        """Load, tolerating a missing or corrupt file (returns an empty
        cache with a warning: a bad cache must never block serving)."""
        if not os.path.exists(path):
            return cls()
        try:
            with open(path) as f:
                return cls.from_dict(json.load(f))
        except (json.JSONDecodeError, OSError, ValueError) as e:
            get_logger("repro_torch.tune").warning(
                "tune cache unreadable; starting empty", path=path,
                error=str(e))
            return cls()


def default_cache_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tune_cache.json")
