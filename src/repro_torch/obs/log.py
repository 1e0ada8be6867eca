"""Structured, level-gated logging for the repro (DESIGN.md §15).

Replaces the `print`-based progress lines in the training and serving
paths. Built on stdlib `logging` with two repo conventions:

  level gate   REPRO_LOG=debug|info|warning|error overrides; otherwise
               INFO normally, WARNING under pytest (test output stays
               clean — the suite asserts on stdout in places).
  structure    `log.info("admitted", rid=3, pages=7)` renders
               "admitted rid=3 pages=7" — grep-stable key=value pairs
               instead of ad-hoc f-strings.

Copied from ``repro.obs.log`` with the imports pointed at the port: the
PyTorch port imports nothing of the JAX package, so it keeps its own copy
of the framework-free modules.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Dict

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR}


def _default_level() -> int:
    env = os.environ.get("REPRO_LOG", "").lower()
    if env in _LEVELS:
        return _LEVELS[env]
    # quiet by default under pytest: progress lines would interleave with
    # captured assertions
    if "PYTEST_CURRENT_TEST" in os.environ or "pytest" in sys.modules:
        return logging.WARNING
    return logging.INFO


class StructuredLogger:
    """Thin kwargs->key=value wrapper over one stdlib logger."""

    def __init__(self, logger: logging.Logger):
        self._log = logger

    @staticmethod
    def _fmt(msg: str, kw: Dict) -> str:
        if not kw:
            return msg
        return msg + " " + " ".join(f"{k}={v}" for k, v in kw.items())

    def debug(self, msg: str, **kw) -> None:
        self._log.debug(self._fmt(msg, kw))

    def info(self, msg: str, **kw) -> None:
        self._log.info(self._fmt(msg, kw))

    def warning(self, msg: str, **kw) -> None:
        self._log.warning(self._fmt(msg, kw))

    def error(self, msg: str, **kw) -> None:
        self._log.error(self._fmt(msg, kw))

    def set_level(self, level: str) -> None:
        self._log.setLevel(_LEVELS[level.lower()])

    def is_enabled_for(self, level: str) -> bool:
        return self._log.isEnabledFor(_LEVELS[level.lower()])


_cache: Dict[str, StructuredLogger] = {}


def get_logger(name: str = "repro_torch") -> StructuredLogger:
    """Process-cached structured logger. First call per name wires a
    stderr handler and the gated default level."""
    lg = _cache.get(name)
    if lg is not None:
        return lg
    raw = logging.getLogger(name)
    if not raw.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "[%(levelname).1s %(name)s] %(message)s"))
        raw.addHandler(h)
        raw.setLevel(_default_level())
        raw.propagate = False
    lg = _cache[name] = StructuredLogger(raw)
    return lg
