"""Traffic generation for LIME-Serve (DESIGN.md §9, EXPERIMENTS.md §Serving).

The paper evaluates two request regimes (§V-A): *sporadic* — one request in
flight, the pipeline drains between requests — and *bursty* — |D| requests
co-scheduled as micro-batches. Serving under real traffic needs those as
explicit arrival timelines plus the patterns a front-end actually sees, so
this module generates deterministic, seeded arrival streams:

  sporadic      requests spaced far enough apart that the pipeline drains
  bursty        groups of `burst_size` simultaneous arrivals
  poisson       memoryless arrivals at `rate_rps` (exponential gaps)
  trace         replay of explicit (time_s, prompt_len, max_new_tokens) rows
  shared_prefix N prompt templates × many users: every request opens with
                one of `n_templates` shared prefix streams (system prompts
                / few-shot templates), then a per-request unique suffix —
                the radix prefix cache's home workload (DESIGN.md §12)
  multiturn     conversational sessions whose follow-up arrivals re-send
                the growing conversation: turn t's prompt extends turn
                t-1's, so a session's own history is a guaranteed prefix
                hit once inserted

Every generator is a pure function of its arguments (numpy Generator seeded
explicitly), so benchmark runs and tests are reproducible bit-for-bit.
Template-bearing events (`template_id` set) carry enough metadata for
`requests_from_arrivals` (serving/scheduler.py) to materialize actual
token ids deterministically — the prefix cache keys on token content, so
these two patterns produce real (synthetic but stable) prompts.

Copied unchanged from ``repro.serving.traffic``: the PyTorch port imports nothing of
the JAX package, so it keeps its own copy of the framework-free modules.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One request hitting the front door. `template_id`/`template_len`
    mark the leading `template_len` prompt tokens as drawn from shared
    stream `template_id` (see template_tokens); the rest of the prompt is
    unique to the request."""
    time_s: float
    prompt_len: int
    max_new_tokens: int
    template_id: Optional[int] = None
    template_len: int = 0
    session_id: Optional[int] = None   # conversation identity (multiturn):
                                       # follow-up turns carry the same id,
                                       # so routers can pin a session to a
                                       # replica without inspecting tokens


_STREAM_CHUNK = 4096


def template_tokens(template_id: int, n: int, *, vocab_size: int = 32768,
                    seed: int = 0, salt: int = 0) -> np.ndarray:
    """First `n` tokens of shared stream (`seed`, `salt`, `template_id`) —
    prefix-stable by construction: the stream is always drawn in
    _STREAM_CHUNK-sized blocks and sliced, so template_tokens(t, 5) is a
    prefix of template_tokens(t, 9) regardless of generator internals."""
    rng = np.random.default_rng([seed, salt, template_id])
    full = -(-max(n, 1) // _STREAM_CHUNK) * _STREAM_CHUNK
    return rng.integers(1, max(vocab_size, 2),
                        size=full).astype(np.int32)[:n]


def _lengths(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    if hi <= lo:
        return np.full(n, lo, np.int64)
    return rng.integers(lo, hi + 1, size=n)


def _sample_lengths(rng: np.random.Generator, n: int, prompt_len,
                    max_new_tokens) -> Tuple[np.ndarray, np.ndarray]:
    """Draw per-request prompt/new-token lengths; scalars are fixed,
    (lo, hi) tuples sample uniformly inclusive."""
    pl = prompt_len if isinstance(prompt_len, tuple) else (prompt_len,) * 2
    mn = max_new_tokens if isinstance(max_new_tokens, tuple) \
        else (max_new_tokens,) * 2
    return _lengths(rng, n, *pl), _lengths(rng, n, *mn)


def sporadic(n_requests: int, *, gap_s: float = 4.0, jitter: float = 0.25,
             prompt_len: Union[int, Tuple[int, int]] = 64,
             max_new_tokens: Union[int, Tuple[int, int]] = 32,
             seed: int = 0) -> List[ArrivalEvent]:
    """Lone arrivals, `gap_s` apart (±jitter fraction): the paper's
    1-micro-batch regime — each request owns the pipeline."""
    rng = np.random.default_rng(seed)
    plens, mnews = _sample_lengths(rng, n_requests, prompt_len,
                                   max_new_tokens)
    t, out = 0.0, []
    for i in range(n_requests):
        out.append(ArrivalEvent(t, int(plens[i]), max(int(mnews[i]), 1)))
        t += gap_s * (1.0 + jitter * (2.0 * rng.random() - 1.0))
    return out


def bursty(n_requests: int, *, burst_size: int = 4, gap_s: float = 8.0,
           prompt_len: Union[int, Tuple[int, int]] = 64,
           max_new_tokens: Union[int, Tuple[int, int]] = 32,
           seed: int = 0) -> List[ArrivalEvent]:
    """Simultaneous groups of `burst_size`: the paper's |D|-micro-batch
    regime — the interleaved pipeline is kept full within a burst."""
    rng = np.random.default_rng(seed)
    plens, mnews = _sample_lengths(rng, n_requests, prompt_len,
                                   max_new_tokens)
    out = []
    for i in range(n_requests):
        t = (i // burst_size) * gap_s
        out.append(ArrivalEvent(t, int(plens[i]), max(int(mnews[i]), 1)))
    return out


def poisson(n_requests: int, *, rate_rps: float = 0.5,
            prompt_len: Union[int, Tuple[int, int]] = 64,
            max_new_tokens: Union[int, Tuple[int, int]] = 32,
            seed: int = 0) -> List[ArrivalEvent]:
    """Memoryless arrivals at `rate_rps` requests/second — the open-loop
    load model serving benchmarks default to; bursts and lulls emerge."""
    rng = np.random.default_rng(seed)
    plens, mnews = _sample_lengths(rng, n_requests, prompt_len,
                                   max_new_tokens)
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), size=n_requests)
    times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [ArrivalEvent(float(times[i]), int(plens[i]),
                         max(int(mnews[i]), 1))
            for i in range(n_requests)]


def trace_replay(rows: Union[str, Iterable[Sequence[float]]],
                 **_ignored) -> List[ArrivalEvent]:
    """Replay explicit arrivals. `rows` is either an iterable of
    (time_s, prompt_len, max_new_tokens) triples or a path to a JSON file
    holding a list of such triples / of {time_s, prompt_len,
    max_new_tokens} objects."""
    if isinstance(rows, str):
        with open(rows) as f:
            rows = json.load(f)
    out = []
    for row in rows:
        if isinstance(row, dict):
            ev = ArrivalEvent(float(row["time_s"]), int(row["prompt_len"]),
                              max(int(row["max_new_tokens"]), 1))
        else:
            t, p, m = row
            ev = ArrivalEvent(float(t), int(p), max(int(m), 1))
        out.append(ev)
    return sorted(out, key=lambda e: e.time_s)


def shared_prefix(n_requests: int, *, n_templates: int = 4,
                  prefix_len: int = 256, rate_rps: float = 1.0,
                  prompt_len: Union[int, Tuple[int, int]] = 320,
                  max_new_tokens: Union[int, Tuple[int, int]] = 32,
                  seed: int = 0) -> List[ArrivalEvent]:
    """N templates × many users (DESIGN.md §12): Poisson arrivals whose
    prompts all open with one of `n_templates` shared `prefix_len`-token
    streams — production front-door traffic dominated by system prompts
    and few-shot templates. The per-request suffix keeps total length at
    `prompt_len` (clamped so at least one unique token follows the
    template: a fully-shared prompt would leave nothing to prefill)."""
    rng = np.random.default_rng(seed)
    plens, mnews = _sample_lengths(rng, n_requests, prompt_len,
                                   max_new_tokens)
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), size=n_requests)
    times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    out = []
    for i in range(n_requests):
        total = max(int(plens[i]), prefix_len + 1)
        out.append(ArrivalEvent(
            float(times[i]), total, max(int(mnews[i]), 1),
            template_id=int(rng.integers(0, max(n_templates, 1))),
            template_len=min(prefix_len, total - 1)))
    return out


def multiturn(n_requests: int, *, turns: int = 3,
              prompt_len: Union[int, Tuple[int, int]] = 64,
              user_len: int = 16, think_s: float = 4.0,
              rate_rps: float = 0.5,
              max_new_tokens: Union[int, Tuple[int, int]] = 32,
              seed: int = 0) -> List[ArrivalEvent]:
    """Conversational sessions: each session opens at a Poisson arrival,
    then re-sends its growing conversation every `think_s` (±50% jitter)
    seconds — turn t's prompt is turn t-1's prompt plus the assistant
    turn (max_new tokens) plus `user_len` new user tokens, all drawn from
    the session's template stream so consecutive turns are exact prefix
    extensions. `prompt_len` sizes the first turn; `n_requests` total
    arrivals across ceil(n/turns) sessions."""
    rng = np.random.default_rng(seed)
    n_sessions = -(-max(n_requests, 1) // max(turns, 1))
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), size=n_sessions)
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    out = []
    first = prompt_len if isinstance(prompt_len, int) else prompt_len[0]
    for s in range(n_sessions):
        t = float(starts[s])
        plen = first
        for turn in range(turns):
            if len(out) >= n_requests:
                break
            mn = _sample_lengths(rng, 1, plen, max_new_tokens)[1][0]
            out.append(ArrivalEvent(t, plen, max(int(mn), 1),
                                    template_id=s, template_len=plen,
                                    session_id=s))
            plen += int(mn) + user_len     # next turn re-sends everything
            t += think_s * (0.5 + rng.random())
    return sorted(out, key=lambda e: e.time_s)


PATTERNS = {
    "sporadic": sporadic,
    "bursty": bursty,
    "poisson": poisson,
    "trace": trace_replay,
    "shared_prefix": shared_prefix,
    "multiturn": multiturn,
}


def make_arrivals(pattern: str, n_requests: int = 0, *,
                  trace: Optional[Union[str, list]] = None,
                  **kwargs) -> List[ArrivalEvent]:
    """Uniform entry point: make_arrivals("poisson", 32, seed=1, ...)."""
    if pattern == "trace":
        if trace is None:
            raise ValueError("pattern 'trace' needs trace=<path or rows>")
        return trace_replay(trace)
    if pattern not in PATTERNS:
        raise KeyError(f"unknown traffic pattern {pattern!r}; "
                       f"have {sorted(PATTERNS)}")
    return PATTERNS[pattern](n_requests, **kwargs)


def cli_arrivals(pattern: str, n_requests: int, *, seed: int = 0,
                 prompt_len=64, max_new_tokens=32, gap_s: float = 4.0,
                 burst_size: int = 4, rate_rps: float = 1.0,
                 n_templates: int = 4, prefix_len: int = 256,
                 turns: int = 3, trace=None) -> List[ArrivalEvent]:
    """Map the common CLI knob set onto the right generator's kwargs
    (shared by launch/serve.py and benchmarks/bench_serving.py so the
    per-pattern dispatch lives in exactly one place)."""
    if pattern == "trace":
        return make_arrivals("trace", trace=trace)
    kw = dict(seed=seed, prompt_len=prompt_len,
              max_new_tokens=max_new_tokens)
    if pattern == "sporadic":
        kw["gap_s"] = gap_s
    elif pattern == "bursty":
        kw.update(burst_size=burst_size, gap_s=gap_s)
    elif pattern == "poisson":
        kw["rate_rps"] = rate_rps
    elif pattern == "shared_prefix":
        kw.update(n_templates=n_templates, prefix_len=prefix_len,
                  rate_rps=rate_rps)
    elif pattern == "multiturn":
        kw.update(turns=turns, rate_rps=rate_rps)
    return make_arrivals(pattern, n_requests, **kw)
