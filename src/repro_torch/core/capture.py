"""Captured serving steps: the port's counterpart of ``jax.jit``.

The JAX package compiles each serving step once per shape and dispatches
it as one program. ``CapturedStep`` does the same with CUDA graphs, one
graph per shape, for every step the JAX package jits:

* the single-device backend's decode and verify steps (``jax.jit`` of
  ``M.decode_step`` / ``M.verify_step``, ``serving/backend.py:603-606``)
  and its prefill (``jax.jit`` of ``M.prefill``, ``:602``), one graph per
  prompt shape, the encoder-decoder family's ``enc_out`` (or frame
  embeddings) and the VLM's patch embeddings as static inputs;
* the paged decode and verify (``kvcache/paged_decode.py:46, 86``), the
  prefix cache's suffix rounds among them;
* the engine's pass (``core/engine.py:875``): the decode and verify passes,
  the rounds of ``prefill_partial`` and the prompt pass over the tiers,
  streamed layers included (the pass forks the engine's copy stream from
  the capture stream and joins it again before the capture ends), and
  its resident-only draft program (``:857``);
* the drafts' decode steps and their prefill in ``reset``
  (``specdec/draft.py:84-85``, ``specdec/resident_draft.py:112-114``).

Its decode kernels read the position as a runtime scalar, so one compiled
step serves every position.

A step is split into a host prelude (checks, page bookkeeping, buffers
allocated), a device body and a host epilogue (the host position
advances). The body is a function of a tokens tensor, a 0-d int32
position tensor and the step's other static inputs (``inputs``: the
encoder's output, patch embeddings) that reads no other value that
changes between calls: kernels 1 and 4 read the position from device
memory, the model writes K/V and ``pos_ids`` at slots computed on the
device. What it writes in place (a cache, the engine's state) lives
outside the graph's pool at addresses the scope names. For each key
(what fixes a graph: the tokens' shape, which carries the batch width and
q_len or the prompt length, the inputs' shapes, and whatever the caller
adds, such as ``enc_len``) the body is captured once and replayed per
call, its static inputs written in place first.

* The first call of a key is the real step, run eagerly on the capture
  stream (the warm-up: cuBLAS handles, the kernels' one-time
  ``cudaFuncSetAttribute`` and cluster-occupancy queries, cached device
  constants), then the body is captured into the backend's graph pool
  under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the
  body fails the capture. Warm-up and capture run the body once each (the
  capture only records): a recurrent state advances once.
* The launch counters of the kernel wrappers (``KERNEL_MODULES``) count
  in Python, so a capture bumps them once and a replay never: the capture
  takes its counts back and every replay adds them, so the counters stay
  exact.
* ``scope`` (a function, called only where graphs are kept) names the
  memory a graph reads and writes beyond its static buffers (the cache's
  tensors, the weights, the engine's layout version and pinned store). A
  call in a new scope drops every graph of the old one: they would read
  freed or moved memory.
* The output is cloned right after a replay: the graphs of a backend
  share one pool, and a later graph's temporaries may overlap an earlier
  graph's static output.
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

Body = Callable[..., torch.Tensor]
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
    __slots__ = ("tokens", "pos", "inputs", "graph", "out", "launches")

    def __init__(self, tokens: torch.Tensor, pos: torch.Tensor,
                 inputs: Tuple[torch.Tensor, ...]):
        self.tokens, self.pos, self.inputs = tokens, pos, inputs
        self.graph = self.out = None
        self.launches: Dict[Tuple[str, str], int] = {}


class CapturedStep:
    """One CUDA graph per key of a step's device body, replayed per call.
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
            scope: Scope = tuple,
            inputs: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        """body(tokens, position, *inputs) for tokens (B, q_len) at host
        position `pos`: eagerly, or the key's graph replayed (captured at
        its first call). `inputs` are the body's other static inputs (the
        encoder's output of a prefill), copied into the graph's own
        buffers before each replay. Returns the body's output (a copy of a
        graph's static output: it stays valid across later replays)."""
        if self.graphs is None:
            return run(None, key, body, tokens, pos, device=self.device,
                       inputs=inputs)
        scope = scope()
        if scope != self._scope:
            self._entries.clear()
            self._scope = scope
        key = (key, tuple(tokens.shape), tokens.dtype,
               tuple((tuple(t.shape), t.dtype) for t in inputs))
        e = self._entries.get(key)
        if e is None:
            return self._capture(key, body, tokens, pos, inputs)
        self._feed(e, tokens, pos)
        self._feed_inputs(e, inputs)
        self.graphs.replay(e.graph)
        _add_counts(e.launches)
        self.replays += 1
        return e.out.clone()

    @staticmethod
    def _feed(e: _Entry, tokens: torch.Tensor, pos: int) -> None:
        """Write a call's tokens and position into the graph's static
        buffers."""
        e.tokens.copy_(tokens)
        e.pos.fill_(pos)

    @staticmethod
    def _feed_inputs(e: _Entry, inputs: Tuple[torch.Tensor, ...]) -> None:
        """... and its other static inputs."""
        for buf, t in zip(e.inputs, inputs):
            buf.copy_(t)

    def _capture(self, key: tuple, body: Body, tokens: torch.Tensor,
                 pos: int, inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        t0 = time.perf_counter()
        e = _Entry(torch.empty(tokens.shape, dtype=tokens.dtype,
                               device=self.device),
                   torch.empty((), dtype=torch.int32, device=self.device),
                   tuple(torch.empty(t.shape, dtype=t.dtype,
                                     device=self.device) for t in inputs))
        self._feed(e, tokens, pos)
        self._feed_inputs(e, inputs)
        out = self.graphs.warm(lambda: body(e.tokens, e.pos, *e.inputs))
        before = launch_counts()
        try:
            e.graph, e.out = self.graphs.capture(
                lambda: body(e.tokens, e.pos, *e.inputs))
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
        device=None, inputs: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """``steps.run(...)``, or with no CapturedStep the body run eagerly on
    `device` (where the caller's cache lives)."""
    if steps is not None:
        return steps.run(key, body, tokens, pos, scope=scope, inputs=inputs)
    dev = torch.device(device) if device is not None else tokens.device
    return body(tokens.to(dev),
                torch.full((), pos, dtype=torch.int32, device=dev), *inputs)
