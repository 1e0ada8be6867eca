"""Flight-recorder tracer: ring-buffered events with a stable vocabulary
(DESIGN.md §15).

LIME's whole argument is a timing argument — interleaved weight streaming
hides behind compute, retier trades HBM between weights and KV, a spec
round amortizes one streaming round over k+1 tokens — so the serving path
carries a low-overhead event recorder that can *show* those overlaps
instead of summarizing them away. Design constraints, in order:

  zero-cost off   tracing is opt-in. `get_tracer()` returns None unless a
                  Tracer was installed; every instrumentation site is a
                  module-global read + None check and nothing else.
  bounded on      events land in a ring (`collections.deque(maxlen=...)`):
                  a long run never grows memory without bound, the *last*
                  N events survive (flight-recorder semantics). Spans that
                  matter long-term (request lifecycles) are emitted at
                  completion, so they survive ring wrap of their live
                  instants.
  one timebase    every event carries an explicit timestamp in seconds on
                  the *backend clock* — wall time for the engine, virtual
                  time for the discrete-event simulator — so sim and
                  engine runs render identically in Perfetto. The
                  scheduler binds `tracer.clock` to `backend.now` at
                  construction; sites without a better clock call
                  `tracer.now()`.

Events are plain tuples (EVT_* index constants below), not objects: the
hot path allocates one tuple and one deque append per event.

Event vocabulary — request lifecycle (track "req:<rid>"):

  req.arrive  req.queue  req.admit  req.prefix_hit  req.prefill
  req.prefill_chunk  req.decode  req.spec_round  req.preempt  req.spill
  req.resume  req.finish  req.reject  req.span

and step / substrate internals (tracks "pipeline", "dev:<i>",
"dev:<i>:loader", "kv", "prefix", "sched", "engine"):

  step  stage.compute  weight.fetch  weight.stall  act.hop
  kv.migrate  kv.spill  kv.fetch  kv.grow  kv.shrink
  prefix.hit  prefix.insert  prefix.evict
  retier  retier.reclaim  planner.fired
  engine.prefill  engine.decode  engine.verify  engine.draft
  engine.seed  engine.retier

Phases follow the Chrome trace-event format (`ph`): "i" instant,
"X" complete (ts + dur), "B"/"E" begin/end, "C" counter.

Copied from ``repro.obs.trace`` with the imports pointed at the port: the
PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the framework-free modules.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

# tuple layout of one event (kept flat for allocation cost)
EVT_NAME, EVT_PH, EVT_TS, EVT_DUR, EVT_TRACK, EVT_ARGS = range(6)

Event = Tuple[str, str, float, float, str, Optional[dict]]

# -- event vocabulary (DESIGN.md §15) ----------------------------------------
# request lifecycle
REQ_ARRIVE = "req.arrive"
REQ_QUEUE = "req.queue"
REQ_ADMIT = "req.admit"
REQ_PREFIX_HIT = "req.prefix_hit"
REQ_PREFILL = "req.prefill"
REQ_PREFILL_CHUNK = "req.prefill_chunk"
REQ_DECODE = "req.decode"
REQ_SPEC_ROUND = "req.spec_round"
REQ_PREEMPT = "req.preempt"
REQ_SPILL = "req.spill"
REQ_RESUME = "req.resume"
REQ_FINISH = "req.finish"
REQ_REJECT = "req.reject"
REQ_SPAN = "req.span"
# step internals
STEP = "step"
STAGE_COMPUTE = "stage.compute"
WEIGHT_FETCH = "weight.fetch"
WEIGHT_STALL = "weight.stall"
ACT_HOP = "act.hop"
KV_MIGRATE = "kv.migrate"
KV_SPILL = "kv.spill"
KV_FETCH = "kv.fetch"
KV_GROW = "kv.grow"
KV_SHRINK = "kv.shrink"
PREFIX_HIT = "prefix.hit"
PREFIX_INSERT = "prefix.insert"
PREFIX_EVICT = "prefix.evict"
RETIER = "retier"
RETIER_RECLAIM = "retier.reclaim"
PLANNER_FIRED = "planner.fired"
ENGINE_PREFILL = "engine.prefill"
ENGINE_DECODE = "engine.decode"
ENGINE_VERIFY = "engine.verify"
ENGINE_DRAFT = "engine.draft"
ENGINE_SEED = "engine.seed"
ENGINE_RETIER = "engine.retier"
# fleet router (DESIGN.md §16; track "router")
FLEET_ROUTE = "fleet.route"
FLEET_SPILLOVER = "fleet.spillover"
FLEET_DRAIN = "fleet.drain"
FLEET_DRAINED = "fleet.drained"
FLEET_JOIN = "fleet.join"
# SLO engine (DESIGN.md §17; track "slo")
SLO_BREACH = "slo.breach"
SLO_RECOVER = "slo.recover"
# measured-profile autotuner (DESIGN.md §18; track "tune")
TUNE_REFIT = "tune.refit"

# tracks
TRACK_SCHED = "sched"
TRACK_PIPELINE = "pipeline"
TRACK_KV = "kv"
TRACK_PREFIX = "prefix"
TRACK_ENGINE = "engine"
TRACK_ROUTER = "router"
TRACK_SLO = "slo"
TRACK_TUNE = "tune"


def req_track(rid: int) -> str:
    return f"req:{rid}"


def dev_track(i: int) -> str:
    return f"dev:{i}"


def loader_track(i: int) -> str:
    return f"dev:{i}:loader"


class Tracer:
    """Ring-buffered flight recorder. All timestamps are seconds on
    `clock` (monotonic by default; serving binds it to the backend's
    clock so sim traces carry virtual time)."""

    def __init__(self, capacity: int = 1 << 16,
                 clock: Callable[[], float] = time.monotonic,
                 namespace: Optional[str] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        # track-name namespace: when N backends trace into ONE ring (the
        # fleet layer) their "sched"/"kv"/"req:0" tracks collide — a
        # namespace "r1" rewrites them to "r1:sched" etc. at push time,
        # and the Chrome exporter maps each rN: group to its own Perfetto
        # process. The fleet executor flips this per replica step.
        self.namespace = namespace
        self.buf: deque = deque(maxlen=capacity)
        self.dropped = 0          # events the ring evicted (wraparound)
        self.emitted = 0          # events ever recorded

    # -- recording ---------------------------------------------------------------
    def now(self) -> float:
        return self.clock()

    def _push(self, evt: Event) -> None:
        ns = self.namespace
        if ns is not None:
            evt = (evt[0], evt[1], evt[2], evt[3],
                   ns + ":" + evt[EVT_TRACK], evt[5])
        if len(self.buf) == self.capacity:
            self.dropped += 1
        self.emitted += 1
        self.buf.append(evt)

    def instant(self, name: str, *, ts: Optional[float] = None,
                track: str = TRACK_SCHED, args: Optional[dict] = None) -> None:
        self._push((name, "i", self.clock() if ts is None else ts,
                    0.0, track, args))

    def complete(self, name: str, *, ts: float, dur: float,
                 track: str = TRACK_SCHED,
                 args: Optional[dict] = None) -> None:
        """One finished span (ph "X"): ts..ts+dur."""
        self._push((name, "X", ts, max(dur, 0.0), track, args))

    def begin(self, name: str, *, ts: Optional[float] = None,
              track: str = TRACK_SCHED, args: Optional[dict] = None) -> None:
        self._push((name, "B", self.clock() if ts is None else ts,
                    0.0, track, args))

    def end(self, name: str, *, ts: Optional[float] = None,
            track: str = TRACK_SCHED) -> None:
        self._push((name, "E", self.clock() if ts is None else ts,
                    0.0, track, None))

    def counter(self, name: str, *, ts: Optional[float] = None,
                track: str = TRACK_SCHED, **values: float) -> None:
        self._push((name, "C", self.clock() if ts is None else ts,
                    0.0, track, values))

    @contextmanager
    def span(self, name: str, *, track: str = TRACK_SCHED,
             args: Optional[dict] = None):
        """Wall-span context manager on the tracer clock (engine paths);
        discrete-event code passes explicit ts/dur via complete()."""
        t0 = self.clock()
        try:
            yield self
        finally:
            self.complete(name, ts=t0, dur=self.clock() - t0,
                          track=track, args=args)

    # -- reading -----------------------------------------------------------------
    def events(self) -> List[Event]:
        return list(self.buf)

    def clear(self) -> None:
        self.buf.clear()
        self.dropped = 0
        self.emitted = 0

    def __len__(self) -> int:
        return len(self.buf)

    # -- export (delegates; repro_torch.obs.exporters owns the formats) ----------
    def export(self, path: str) -> None:
        """Write the buffer to `path`: Chrome trace-event JSON
        (Perfetto-loadable) unless the suffix is .jsonl (append-only
        JSONL for post-hoc analysis)."""
        from repro_torch.obs.exporters import export_chrome, export_jsonl
        if str(path).endswith(".jsonl"):
            export_jsonl(self, path)
        else:
            export_chrome(self, path)


# ----------------------------------------------------------------------------
# global installation: instrumented code pays one global read + None check
# ----------------------------------------------------------------------------
_tracer: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The installed tracer, or None (tracing off — the common case)."""
    return _tracer


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or uninstall with None) the process tracer; returns the
    previous one so callers can restore it."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


@contextmanager
def tracing(capacity: int = 1 << 16,
            clock: Callable[[], float] = time.monotonic):
    """Install a fresh Tracer for the duration of the block."""
    tr = Tracer(capacity=capacity, clock=clock)
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)
