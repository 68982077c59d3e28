"""Logging helpers (reference logging/logging.go + memberlist.go:268-286).

The reference ships two small utilities around logrus: a log level that
(un)marshals to JSON so daemon config files can carry it
(logging/logging.go:26-54), and a pipe-writer adapter that feeds a
third-party library's raw log output into the structured logger
(newLogWriter, memberlist.go:268-286).  Python equivalents over the
stdlib logging module, plus the `category=gubernator` logger setup the
daemon and CLIs share (gubernator.go:67, config.go:231-235).
"""

from __future__ import annotations

import io
import json
import logging
import sys
from typing import Optional

CATEGORY = "gubernator"


class LogLevelJSON:
    """JSON-(un)marshalable wrapper around a logging level
    (logging/logging.go:26-54): serializes as the lowercase level name,
    parses either a name or a numeric level."""

    def __init__(self, level: int = logging.INFO):
        self.level = level

    def to_json(self) -> str:
        return json.dumps(logging.getLevelName(self.level).lower())

    @classmethod
    def from_json(cls, data: str) -> "LogLevelJSON":
        v = json.loads(data)
        if isinstance(v, int):
            return cls(v)
        name = str(v).upper()
        level = logging.getLevelName(name)
        if not isinstance(level, int):
            raise ValueError(f"unknown log level '{v}'")
        return cls(level)

    def __eq__(self, other) -> bool:
        return isinstance(other, LogLevelJSON) and other.level == self.level

    def __repr__(self) -> str:
        return f"LogLevelJSON({logging.getLevelName(self.level)})"


class LogWriter(io.TextIOBase):
    """File-like adapter that forwards complete lines into a logger at
    DEBUG — the newLogWriter pattern (memberlist.go:268-286) for
    capturing third-party components' raw output (e.g. an embedded
    server's access log) into the structured log."""

    def __init__(self, logger: logging.Logger, level: int = logging.DEBUG):
        self.logger = logger
        self.level = level
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, _, self._buf = self._buf.partition("\n")
            if line.strip():
                self.logger.log(self.level, line.rstrip())
        return len(s)

    def flush(self) -> None:
        if self._buf.strip():
            self.logger.log(self.level, self._buf.rstrip())
        self._buf = ""


def category_logger(name: str = "") -> logging.Logger:
    """The shared `category=gubernator` logger tree (gubernator.go:67)."""
    return logging.getLogger(f"{CATEGORY}.{name}" if name else CATEGORY)


class TraceContextFilter(logging.Filter):
    """Stamps trace_id/span_id onto every record from the calling
    thread's active trace context (tracing.py), so logs and traces join
    on one id; "-" when no sampled trace is active.  A Filter, not a
    LogRecordFactory: the stamp must apply only to the gubernator tree,
    not hijack the process-global record factory."""

    def filter(self, record: logging.LogRecord) -> bool:
        # Local import: tracing imports category_logger from here.
        from .. import tracing

        ctx = tracing.current() if tracing.enabled() else None
        record.trace_id = ctx.trace_hex if ctx is not None else "-"
        record.span_id = ctx.span_hex if ctx is not None else "-"
        return True


def setup_logging(debug: bool = False, stream=None) -> logging.Logger:
    """Configure the gubernator logger tree: level from the debug flag
    (GUBER_DEBUG / -debug, config.go:231-235), one structured line per
    record, trace/span ids stamped when a trace context is active."""
    logger = logging.getLogger(CATEGORY)
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.addFilter(TraceContextFilter())
        handler.setFormatter(
            logging.Formatter(
                fmt=(
                    "time=%(asctime)s level=%(levelname)s category=" + CATEGORY +
                    " logger=%(name)s trace_id=%(trace_id)s"
                    " span_id=%(span_id)s msg=%(message)s"
                ),
                datefmt="%Y-%m-%dT%H:%M:%S%z",
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
    return logger
