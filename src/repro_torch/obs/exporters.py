"""Trace exporters: Chrome trace-event JSON (Perfetto) + JSONL
(DESIGN.md §15).

Two formats, one source of truth (the Tracer's ring):

  Chrome trace-event JSON   load in Perfetto (ui.perfetto.dev) or
                            chrome://tracing. Tracks map to pid/tid pairs:
                            pid 0 "serving" (scheduler, kv, prefix,
                            engine), pid 1 "fleet" (one tid per device /
                            loader), pid 2 "requests" (one tid per
                            request) — the per-request lifecycle lanes the
                            "where did the p99 TTFT go" question needs. Timestamps convert s -> µs
                            (the format's unit).
  JSONL                     one JSON object per line, first line a header
                            {"schema": "lime-trace", "version": N} —
                            append-friendly, streams through jq/pandas for
                            post-hoc analysis, round-trips losslessly
                            (read_jsonl).

Copied from ``repro.obs.exporters`` with the imports pointed at the port: the
PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the framework-free modules.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

from repro_torch.obs.trace import (EVT_ARGS, EVT_DUR, EVT_NAME, EVT_PH, EVT_TRACK,
                             EVT_TS, Event, Tracer)

JSONL_SCHEMA = "lime-trace"
JSONL_VERSION = 1

_PHASES = ("i", "X", "B", "E", "C", "M")


# pids 0-3 are the single-pipeline process groups; namespaced replica
# tracks ("r<N>:...", Tracer.namespace) land at _REPLICA_PID_BASE + N so
# Perfetto renders one process group per fleet replica
_PID_NAMES = {0: "serving", 1: "fleet", 2: "requests", 3: "router"}
_REPLICA_PID_BASE = 10


def _replica_of(track: str):
    """'r3:sched' -> 3; None for un-namespaced tracks ('req:5' included)."""
    ns, sep, rest = track.partition(":")
    if sep and rest and len(ns) > 1 and ns[0] == "r" and ns[1:].isdigit():
        return int(ns[1:])
    return None


def _track_pids(tracks) -> Dict[str, Tuple[int, int]]:
    """Stable track -> (pid, tid) assignment. Request tracks get their
    own process so Perfetto renders one lane per request; device tracks
    one lane per device/loader; every replica-namespaced track (rN:...)
    lands in that replica's own process group; router events get their
    own fleet-level process."""
    out: Dict[str, Tuple[int, int]] = {}
    next_tid: Dict[int, int] = {}
    for tr in sorted(set(tracks)):
        rep = _replica_of(tr)
        if rep is not None:
            pid = _REPLICA_PID_BASE + rep
        elif tr == "router" or tr.startswith("fleet"):
            pid = 3
        elif tr.startswith("req:"):
            pid = 2
        elif tr.startswith("dev:"):
            pid = 1
        else:
            pid = 0
        out[tr] = (pid, next_tid.get(pid, 0))
        next_tid[pid] = next_tid.get(pid, 0) + 1
    return out


def _pid_names(pids: Dict[str, Tuple[int, int]]) -> Dict[int, str]:
    names = dict(_PID_NAMES)
    for pid, _ in pids.values():
        if pid >= _REPLICA_PID_BASE:
            names[pid] = f"replica r{pid - _REPLICA_PID_BASE}"
    return names


def to_chrome(tracer: Tracer) -> dict:
    """The Chrome trace-event representation (JSON object format)."""
    events = tracer.events()
    pids = _track_pids([e[EVT_TRACK] for e in events])
    out: List[dict] = []
    for pid, pname in sorted(_pid_names(pids).items()):
        out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": pname}})
    for track, (pid, tid) in pids.items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": track}})
        # request lanes in rid order, devices in index order
        out.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"sort_index": tid}})
    for e in events:
        pid, tid = pids[e[EVT_TRACK]]
        rec = {"name": e[EVT_NAME], "ph": e[EVT_PH], "pid": pid, "tid": tid,
               "ts": e[EVT_TS] * 1e6}
        if e[EVT_PH] == "X":
            rec["dur"] = e[EVT_DUR] * 1e6
        if e[EVT_PH] == "i":
            rec["s"] = "t"                       # thread-scoped instant
        if e[EVT_ARGS]:
            rec["args"] = dict(e[EVT_ARGS])
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"schema": JSONL_SCHEMA, "version": JSONL_VERSION,
                          "dropped_events": tracer.dropped}}


def export_chrome(tracer: Tracer, path: str) -> int:
    """Write Perfetto-loadable Chrome trace JSON; returns events written."""
    doc = to_chrome(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def export_jsonl(tracer: Tracer, path: str, append: bool = False) -> int:
    """Write (or append) the buffer as JSONL; returns events written."""
    mode = "a" if append else "w"
    events = tracer.events()
    with open(path, mode) as f:
        if not append:
            f.write(json.dumps({"schema": JSONL_SCHEMA,
                                "version": JSONL_VERSION}) + "\n")
        for e in events:
            f.write(json.dumps({"name": e[EVT_NAME], "ph": e[EVT_PH],
                                "ts": e[EVT_TS], "dur": e[EVT_DUR],
                                "track": e[EVT_TRACK],
                                "args": e[EVT_ARGS]}) + "\n")
    return len(events)


def read_jsonl(path: str) -> Tuple[dict, List[Event]]:
    """Load a JSONL trace back into (header, event tuples) — the inverse
    of export_jsonl, so analysis code works on the in-memory layout."""
    header: dict = {}
    events: List[Event] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if i == 0 and "schema" in rec:
                header = rec
                continue
            events.append((rec["name"], rec["ph"], rec["ts"], rec["dur"],
                           rec["track"], rec["args"]))
    return header, events


def validate_chrome(doc: dict) -> List[str]:
    """Check a Chrome trace-event document against the format's schema
    (the subset Perfetto requires). Returns a list of problems — empty
    means valid. Used by tests and the CI trace smoke."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing top-level 'traceEvents'"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    open_spans: Dict[Tuple[int, int], List[str]] = {}
    for i, e in enumerate(events):
        where = f"event {i}"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                problems.append(f"{where}: missing '{key}'")
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        if ph != "M":
            if not isinstance(e.get("ts"), (int, float)):
                problems.append(f"{where}: non-numeric ts")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event needs dur >= 0")
        key = (e.get("pid"), e.get("tid"))
        if ph == "B":
            open_spans.setdefault(key, []).append(e.get("name", ""))
        elif ph == "E":
            stack = open_spans.get(key, [])
            if not stack:
                problems.append(f"{where}: E without matching B on {key}")
            else:
                stack.pop()
    for key, stack in open_spans.items():
        if stack:
            problems.append(f"unclosed B events on track {key}: {stack}")
    return problems


def validate_chrome_file(path: str) -> List[str]:
    with open(path) as f:
        return validate_chrome(json.load(f))
