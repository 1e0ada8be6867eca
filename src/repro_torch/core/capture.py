"""Captured serving steps: the port's counterpart of ``jax.jit``.

The JAX package compiles each serving step once per shape and dispatches
it as one program: the single-device backend's ``jax.jit`` of
``M.decode_step`` and ``M.verify_step`` (``serving/backend.py:603-606``),
the paged decode and verify (``kvcache/paged_decode.py:46, 86``), the
engine's resident-only draft program (``core/engine.py:857``) and the
drafts' decode steps (``specdec/draft.py:84``,
``specdec/resident_draft.py:112``). Its decode kernels read the position
as a runtime scalar, so one compiled step serves every position.

``CapturedStep`` does the same with CUDA graphs. A step is split into a
host prelude (checks, page bookkeeping), a device body and a host
epilogue (the host position advances). The body is a function of a
tokens tensor and a 0-d int32 position tensor that reads no other value
that changes between tokens: kernels 1 and 4 read the position from
device memory, the model writes K/V and ``pos_ids`` at slots computed on
the device. For each key (what fixes a graph: the tokens' shape, which
carries the batch width and q_len, and whatever the caller adds, such as
``enc_len``) the body is captured once and replayed per token, its
static inputs written in place first.

* The first call of a key is the real step, run eagerly on the capture
  stream (the warm-up: cuBLAS handles, the kernels' one-time
  ``cudaFuncSetAttribute`` and cluster-occupancy queries), then the body
  is captured into the backend's graph pool under
  ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the body
  fails the capture. Warm-up and capture run the body once each: a
  recurrent state advances once.
* The launch counters of the kernel wrappers (``KERNEL_MODULES``) count
  in Python, so a capture bumps them once and a replay never: the capture
  takes its counts back and every replay adds them, so the counters stay
  exact.
* ``scope`` (a function, called only where graphs are kept) names the
  memory a graph reads and writes beyond its static buffers (the cache's
  tensors, the weights, the engine's layout version). A call in a new
  scope drops every graph of the old one: they would read freed or moved
  memory.
* On a CPU device (the caller asked for the CPU), or with capture turned
  off, the body runs eagerly with a fresh position tensor. On the card a
  capture or replay that fails raises; it never falls back to the eager
  step.

Sampling, acceptance, rollback and every other host decision stay outside
the graph, as the JAX package keeps them outside its jitted functions.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import multiquery as mq_ops
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import paged as pg_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops

KERNEL_MODULES = (da_ops, pg_ops, mq_ops, fa_ops, wkv_ops, ssm_ops)

Body = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Scope = Callable[[], tuple]


def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every kernel wrapper's launch counters (module-level ints named
    ``*launches``), by (module, name)."""
    return {(m.__name__, n): v for m in KERNEL_MODULES
            for n, v in vars(m).items()
            if n.endswith("launches") and isinstance(v, int)}


def _add_counts(delta: Dict[Tuple[str, str], int]) -> None:
    mods = {m.__name__: m for m in KERNEL_MODULES}
    for (mod, name), n in delta.items():
        m = mods[mod]
        setattr(m, name, getattr(m, name) + n)


def tensor_scope(tree) -> tuple:
    """The addresses and shapes of every tensor in a (nested) dict: what a
    graph that reads or writes them depends on."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out.append((key, tensor_scope(v)))
        elif isinstance(v, torch.Tensor):
            out.append((key, v.data_ptr(), tuple(v.shape)))
    return tuple(out)


class CudaGraphs:
    """What CapturedStep needs of ``torch.cuda``'s graphs, on one device:
    a graph memory pool and the capture stream. A test injects a fake."""

    def __init__(self, device: torch.device, pool=None):
        self.device = device
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def warm(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """fn() run eagerly on the capture stream, ordered after and before
        the current stream's work."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        out.record_stream(cur)
        return out

    def capture(self, fn: Callable[[], torch.Tensor]):
        """(graph, static output) of fn() captured into the pool, any host
        sync inside it an error."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return g, out

    @staticmethod
    def replay(graph) -> None:
        graph.replay()

    def pool_bytes(self) -> int:
        """Device bytes the caching allocator holds in this graph pool."""
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


class _Entry:
    __slots__ = ("tokens", "pos", "graph", "out", "launches")

    def __init__(self, tokens: torch.Tensor, pos: torch.Tensor):
        self.tokens, self.pos = tokens, pos
        self.graph = self.out = None
        self.launches: Dict[Tuple[str, str], int] = {}


class CapturedStep:
    """One CUDA graph per key of a step's device body, replayed per token.
    ``enabled`` False (or a CPU device) runs every call eagerly; ``pool``
    shares a graph memory pool (``torch.cuda.graph_pool_handle()``) with
    another CapturedStep of the same backend; ``graphs`` injects the graph
    machinery (tests). ``CapturedStep.sharing(pool, device)`` is a step in
    a backend's pool, eager where the pool is None (capture off)."""

    def __init__(self, device, *, enabled: bool = True, pool=None,
                 graphs=None):
        self.device = torch.device(device)
        if graphs is None and enabled and self.device.type == "cuda":
            graphs = CudaGraphs(self.device, pool)
        self.graphs = graphs
        self._entries: Dict[tuple, _Entry] = {}
        self._scope = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    @classmethod
    def sharing(cls, pool, device) -> "CapturedStep":
        return cls(device, enabled=pool is not None, pool=pool)

    @property
    def enabled(self) -> bool:
        return self.graphs is not None

    @property
    def pool(self):
        return self.graphs.pool if self.graphs is not None else None

    def pool_bytes(self) -> int:
        return self.graphs.pool_bytes() if self.graphs is not None else 0

    def clear(self) -> None:
        """Drop every graph (the memory they read is going away)."""
        self._entries.clear()
        self._scope = None

    def run(self, key: tuple, body: Body, tokens: torch.Tensor, pos: int, *,
            scope: Scope = tuple) -> torch.Tensor:
        """body(tokens, position) for tokens (B, q_len) at host position
        `pos`: eagerly, or the key's graph replayed (captured at its first
        call). Returns the body's output (a copy of a graph's static
        output: it stays valid across later replays)."""
        if self.graphs is None:
            return run(None, key, body, tokens, pos, device=self.device)
        scope = scope()
        if scope != self._scope:
            self._entries.clear()
            self._scope = scope
        key = (key, tuple(tokens.shape), tokens.dtype)
        e = self._entries.get(key)
        if e is None:
            return self._capture(key, body, tokens, pos)
        self._feed(e, tokens, pos)
        self.graphs.replay(e.graph)
        _add_counts(e.launches)
        self.replays += 1
        return e.out.clone()

    @staticmethod
    def _feed(e: _Entry, tokens: torch.Tensor, pos: int) -> None:
        """Write a call's inputs into the graph's static buffers."""
        e.tokens.copy_(tokens)
        e.pos.fill_(pos)

    def _capture(self, key: tuple, body: Body, tokens: torch.Tensor,
                 pos: int) -> torch.Tensor:
        t0 = time.perf_counter()
        e = _Entry(torch.empty(tokens.shape, dtype=tokens.dtype,
                               device=self.device),
                   torch.empty((), dtype=torch.int32, device=self.device))
        self._feed(e, tokens, pos)
        out = self.graphs.warm(lambda: body(e.tokens, e.pos))
        before = launch_counts()
        try:
            e.graph, e.out = self.graphs.capture(lambda: body(e.tokens, e.pos))
        finally:
            after = launch_counts()
            _add_counts({k: before[k] - v for k, v in after.items()})
        e.launches = {k: v - before[k] for k, v in after.items()
                      if v != before[k]}
        self._entries[key] = e
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out

    def stats(self) -> Dict[str, float]:
        return {"graphs": len(self._entries), "captures": self.captures,
                "replays": self.replays, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes()}


def run(steps: Optional[CapturedStep], key: tuple, body: Body,
        tokens: torch.Tensor, pos: int, *, scope: Scope = tuple,
        device=None) -> torch.Tensor:
    """``steps.run(...)``, or with no CapturedStep the body run eagerly on
    `device` (where the caller's cache lives)."""
    if steps is not None:
        return steps.run(key, body, tokens, pos, scope=scope)
    dev = torch.device(device) if device is not None else tokens.device
    return body(tokens.to(dev),
                torch.full((), pos, dtype=torch.int32, device=dev))
