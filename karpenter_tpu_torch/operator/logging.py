"""Structured logging with a Nop mode for simulations.

Mirrors the reference's pkg/operator/logging/logging.go: zap-style leveled
JSON logging configured from Options.log_level, and the
NopLogger-inside-simulations pattern (helpers.go:102,115) — consolidation
runs hundreds of scheduling simulations per pass and their logs are noise,
so `nop()` silences every logger within the context.

Usage:
    log = logger("provisioner")
    log.info("computed new nodeclaim(s)", nodeclaims=2, pods=40)
    with nop():           # simulations stay silent
        simulate(...)
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import sys
import time
from typing import Iterator

_NOP = contextvars.ContextVar("karpenter_log_nop", default=False)

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class _JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "level": record.levelname.lower(),
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(record.created)
            ),
            "logger": record.name,
            "message": record.getMessage(),
        }
        if _base_fields:
            entry.update(_base_fields)
        extra = getattr(record, "kv", None)
        if extra:
            entry.update(extra)
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry)


class Logger:
    """Thin leveled wrapper adding key=value structure and the nop gate."""

    def __init__(self, inner: logging.Logger):
        self._inner = inner

    def _log(self, level: int, message: str, kv: dict) -> None:
        if _NOP.get():
            return
        if self._inner.isEnabledFor(level):
            exc_info = kv.pop("exc_info", None)
            # correlation fields: any log emitted inside a span carries its
            # trace/span ids, so `grep trace_id=X` yields the same story
            # /debug/traces?trace_id=X tells (explicit fields win)
            from karpenter_tpu_torch import tracing

            ctx = tracing.current()
            if ctx is not None and ctx.sampled:
                kv.setdefault("trace_id", ctx.trace_id)
                kv.setdefault("span_id", ctx.span_id)
            self._inner.log(level, message, extra={"kv": kv}, exc_info=exc_info)

    def debug(self, message: str, **kv) -> None:
        self._log(logging.DEBUG, message, kv)

    def info(self, message: str, **kv) -> None:
        self._log(logging.INFO, message, kv)

    def warning(self, message: str, **kv) -> None:
        self._log(logging.WARNING, message, kv)

    def error(self, message: str, **kv) -> None:
        self._log(logging.ERROR, message, kv)


_ROOT = "karpenter"
_configured = False
# global structured fields stamped on every entry (e.g. cluster name from
# --cluster-name, matching the reference's zap base fields)
_base_fields: dict = {}


def configure(level: str = "info", stream=None, **base_fields) -> None:
    """Install the JSON handler on the karpenter root logger (idempotent;
    repeat calls adjust the level, and replace the stream only when one is
    explicitly given — so a harness-configured sink survives startup).
    Keyword base_fields are stamped on every subsequent entry; each
    configure() call replaces the full set (omitting them clears)."""
    global _configured
    _base_fields.clear()
    _base_fields.update(base_fields)
    root = logging.getLogger(_ROOT)
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    if stream is None and _configured and root.handlers:
        return
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_JSONFormatter())
    root.addHandler(handler)
    root.propagate = False
    _configured = True


def logger(name: str) -> Logger:
    if not _configured:
        configure()
    return Logger(logging.getLogger(f"{_ROOT}.{name}"))


@contextlib.contextmanager
def nop() -> Iterator[None]:
    """Silence all karpenter loggers within the context (the reference's
    NopLogger injection for scheduling simulations)."""
    token = _NOP.set(True)
    try:
        yield
    finally:
        _NOP.reset(token)


def is_nop() -> bool:
    return _NOP.get()
