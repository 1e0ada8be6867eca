"""LimeServer: the serving front door (counterpart of
``repro.serving.server``).

Composes a RequestQueue clients submit to, the execution backend and the
continuous-batching scheduler behind one call:

    srv = LimeServer(cfg, params, pattern="bursty")
    srv.queue.submit(prompt, max_new_tokens=32)
    finished = srv.serve_all()

The paper's request patterns map to slot counts: sporadic serves one
request at a time, bursty fills the batch (4 slots, or the engine's batch
width). With an InterleavedEngine the backend prefills and decodes through
it, and an OnlinePlanner (planner=) retiers it as the KV pages of a paged
admission grow (serve through a scheduler with
SchedulerConfig(kv_policy="paged")). Without one, prefix_cache=True
serves through a paged KV pool with a radix prefix cache over it
(page_size tokens per page, the uncached suffix prefilled in rounds of
prefill_chunk_tokens). A SpecConfig turns on speculative decoding on
either path: n-gram, small-model or resident drafts, verified in one
multi-query pass, rejection-sampled at temperature > 0. trace=PATH arms
the flight recorder for every serve_all(): Chrome trace-event JSON
(Perfetto), or JSONL when the path ends in .jsonl.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.obs.trace import Tracer, get_tracer, set_tracer
from repro_torch.serving.backend import EngineBackend
from repro_torch.serving.sampling import SamplerConfig
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, SchedulerConfig)


class RequestQueue:
    """Client-facing submission queue (rid assignment + FIFO order)."""

    def __init__(self):
        self._q: deque[Request] = deque()
        self._next = 0

    def submit(self, prompt, max_new_tokens: int, now: float = 0.0) -> Request:
        r = Request(self._next, np.asarray(prompt, np.int32),
                    max_new_tokens, arrival_s=now)
        self._next += 1
        self._q.append(r)
        return r

    def drain(self) -> List[Request]:
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self):
        return len(self._q)


class LimeServer:
    """Pattern-aware serving over an InterleavedEngine, or the
    single-device decode path when engine is None. Runs on the card unless
    ``device='cpu'``; ``impl`` picks the hand-written kernels ("kernel",
    the default) or the reference math ("ref") of the single-device path
    (an engine carries its own)."""

    def __init__(self, cfg: ModelConfig, params, *, engine=None,
                 max_len: int = 512, sampler: SamplerConfig = SamplerConfig(),
                 pattern: str = "sporadic", impl: str = "kernel", spec=None,
                 prefix_cache: bool = False, prefill_chunk_tokens: int = 0,
                 page_size: int = 64, planner=None, capture: bool = True,
                 device=None, trace: Optional[str] = None,
                 trace_capacity: int = 1 << 16):
        self.cfg = cfg
        self.params = params
        self.engine = engine
        self.max_len = max_len
        self.sampler = sampler
        self.pattern = pattern
        self.impl = impl
        self.spec = spec
        self.prefix_cache = prefix_cache      # radix KV reuse, paged pool
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.page_size = page_size
        self.planner = planner                # OnlinePlanner (engine only)
        self.capture = capture                # False: eager steps
        # flight recorder: a path arms tracing for every serve_all()
        self.trace = trace
        self.trace_capacity = trace_capacity
        self.device = engine.device if engine is not None \
            else resolve_device(device)
        self.queue = RequestQueue()
        self._backend: Optional[EngineBackend] = None

    @property
    def slots(self) -> int:
        if self.pattern == "sporadic":
            return 1
        return 4 if self.engine is None else self.engine.mb

    def make_backend(self) -> EngineBackend:
        # cached so the backend's clock keeps running across serve_all()
        if self._backend is None:
            self._backend = EngineBackend(
                self.cfg, self.params, engine=self.engine,
                n_slots=self.slots, max_len=self.max_len,
                sampler=self.sampler, impl=self.impl, spec=self.spec,
                prefix_cache=self.prefix_cache and self.engine is None,
                prefill_chunk_tokens=self.prefill_chunk_tokens,
                page_size=self.page_size, planner=self.planner,
                capture=self.capture, device=self.device)
        return self._backend

    def serve_all(self) -> List[Request]:
        """Drain the queue through the scheduler. Submitted arrival times
        are relative to this call, re-based onto the backend's clock."""
        reqs = self.queue.drain()
        if not reqs:
            return []
        backend = self.make_backend()
        base = backend.now()
        for r in reqs:
            r.arrival_s += base
        # arm the flight recorder before the scheduler is built (it binds
        # the tracer's clock to backend.now at construction); a tracer the
        # caller installed wins, and the caller owns its export then
        tracer = None
        if self.trace and get_tracer() is None:
            tracer = Tracer(capacity=self.trace_capacity)
            set_tracer(tracer)
        try:
            sched = ContinuousBatchingScheduler(backend, SchedulerConfig())
            return sched.serve(reqs)
        finally:
            if tracer is not None:
                set_tracer(None)
                tracer.export(self.trace)
