"""Runtime registry of measured kernel launch knobs (counterpart of
``repro.kernels.tuning``).

The TPU kernels' knob is a block size; the CUDA kernels' is the split
count of the one-token decode kernels (1, 3) and of the multi-query
kernels' verify and mma.sync bodies (4, 5): how many blocks of one
thread-block cluster share a (b, kv head)'s cache slots. The wrappers
pick it by a rule of the shape and the card's SM count (``split_count``
in ``decode_attention/ops.py``, ``n_splits`` in ``multiquery.py``). The
autotuner (``repro_torch.tune.sweep``) times candidates per device kind
and shape bucket and persists the winners; this module is the
consultation point: each wrapper passes its rule's answer as ``default``
and ``resolve`` answers with the tuned value where a table is installed,
or the rule's where none is, so every launch is the rule's until a
sweep has run. The flash kernel and the scans have no launch knob (their
tiles are compile-time); the paged kernels' ``page_size`` is a pool-level
knob, recorded by the sweep and consulted by no pool, as in the JAX
package.

Layering: ``repro_torch.kernels`` does not depend on ``repro_torch.tune``
(the tuner imports the kernels it sweeps), so the table lives here as
plain data, ``{kernel: {bucket: {param: value}}}``, and
``repro_torch.tune.cache`` only fills it.

A tuned split holds only at the launch geometry it was timed at. The
rules read more than the bucket: the grid's blocks a split multiplies
(B · KV for kernels 1 and 3 and the verify body, the row tiles times
B · KV for the mma.sync body) and, for a paged kernel, the pool's page
size. A sweep row records these beside its split (``blocks``, and the
paged rows' ``page_size``), and a wrapper passes its call's as ``at``:
a row applies only where every one of them equals the call's, so a
split timed at B 4 never reaches a B 1 call, which keeps its rule's.

A bad table never blocks serving: a tuned split the kernel cannot take
(``split_legal``) is logged once and ignored, and the rule's split
stands. An explicit override the kernel cannot take raises.

Install before capture: a ``CapturedStep`` records its kernels' launch
arguments by value, the split count among them, so a graph captured
before a table was installed keeps replaying the rule's split. The
launcher installs the table before it builds any backend (as the JAX
launcher installs it before anything traces); the sweep always passes its
split explicitly.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

from repro_torch.obs.log import get_logger

TILE_SLOTS = 64       # cache slots per tile of every split body
CLUSTER_MAX = 8       # splits of one (b, kv head): the blocks of one cluster

# the port's launch knobs per sweepable kernel entry point; None: the
# wrapper's rule of the shape and SM count answers (passed as `default`)
DEFAULTS: Dict[str, Dict[str, Optional[int]]] = {
    "decode_attention": {"n_split": None},
    "mq_decode_attention": {"n_split": None},
    "flash_attention": {},
    "paged_decode_attention": {"page_size": 64, "n_split": None},
    "mq_paged_decode_attention": {"page_size": 64, "n_split": None},
    "rwkv6_scan": {},
    "ssm_scan": {},
}


class Lookup(NamedTuple):
    """One answer of ``resolve``: the value and where it came from."""
    bucket: str
    param: str
    value: int
    source: str           # "override" | "table" | "rule"


_table: Optional[Dict[str, Dict[str, Dict[str, int]]]] = None
_refused: set = set()
_last: Dict[str, Lookup] = {}
# (kernel, source, value, span, geometry) -> lookups since reset_lookups
_counts: Counter = Counter()


def _pow2_at_least(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def shape_bucket(span: int, dh: int) -> str:
    """Stable cache key for a kernel shape: power-of-two bucket of the
    split axis (ceil) x the 128-padded head dim; JAX's key unchanged, so
    a cache written by either package keys alike."""
    lanes = max(-(-dh // 128) * 128, 128)
    return f"s{_pow2_at_least(max(span, 1))}_d{lanes}"


def split_legal(n: int, S: int, min_tiles: int = 1) -> bool:
    """Whether a kernel splitting S slots can take n splits: 1 to
    CLUSTER_MAX blocks of a whole number of TILE_SLOTS-slot tiles, at
    least `min_tiles` each (2 for the verify body), none empty; what the
    wrappers' rules produce for any target."""
    if not 1 <= n <= CLUSTER_MAX:
        return False
    chunk = TILE_SLOTS * max(min_tiles, math.ceil(S / (n * TILE_SLOTS)))
    return math.ceil(S / chunk) == n


def set_tuning_table(table) -> None:
    """Install (or clear, with None) the process-wide tuned-config table:
    ``{kernel: {bucket: {param: int}}}``. Install it before any backend
    captures (see the module docstring)."""
    global _table
    _table = table
    _refused.clear()


def get_tuning_table():
    return _table


def last_lookup(kernel: str) -> Optional[Lookup]:
    """The answer of `kernel`'s last lookup: which split its last launch
    took (None before any)."""
    return _last.get(kernel)


def lookup_counts() -> Dict[Tuple, int]:
    """{(kernel, source, value, span, geometry): lookups} since the last
    ``reset_lookups``: which splits, from where, at which shapes, the
    launches of a run took (a captured graph's replays look nothing up:
    its capture did)."""
    return dict(_counts)


def reset_lookups() -> None:
    _last.clear()
    _counts.clear()


def resolve(kernel: str, span: int, dh: int, param: str,
            override: Optional[int] = None, default: Optional[int] = None,
            legal: Optional[Callable[[int], bool]] = None,
            at: Optional[Mapping[str, int]] = None) -> int:
    """The wrapper-facing lookup: an explicit override wins, then the
    installed table's (kernel, bucket) entry, then `default` (the
    wrapper's rule) or DEFAULTS. `span` is the size of the axis the kernel
    splits; `legal` says which values the kernel takes (a table value it
    refuses is logged once and the default stands; an override it refuses
    raises); `at` is the call's launch geometry (see the module
    docstring): an entry that does not record the same leaves the
    default."""
    bucket = "" if _table is None and override is None \
        else shape_bucket(span, dh)
    if override is not None:
        if legal is not None and not legal(int(override)):
            raise ValueError(f"{kernel}: {param}={override} is not one the "
                             f"kernel takes at span {span}")
        value, source = int(override), "override"
    else:
        value = default if default is not None else DEFAULTS[kernel][param]
        source = "rule"
        cfg = _table.get(kernel, {}).get(bucket) if _table is not None \
            else None
        if cfg and param in cfg \
                and all(cfg.get(k) == v for k, v in (at or {}).items()):
            tuned = int(cfg[param])
            if legal is None or legal(tuned):
                value, source = tuned, "table"
            elif (kernel, bucket, param, tuned, span) not in _refused:
                _refused.add((kernel, bucket, param, tuned, span))
                get_logger("repro_torch.tune").warning(
                    "tuned config refused by the kernel; the rule's stands",
                    kernel=kernel, bucket=bucket, param=param, tuned=tuned,
                    span=span, rule=value)
    _last[kernel] = Lookup(bucket, param, value, source)
    _counts[(kernel, source, value, span,
             tuple(sorted((at or {}).items())))] += 1
    return value
