"""Structured logging: JSON-to-file + ANSI console, request-id correlation.

Capability parity with the reference logger (app/utils/logger.py:19-91 for
the two formatters, :16/:37-39/:81-83 for the ContextVar request-id
correlation, :178-240 for the domain helpers), rebuilt around a single
module-level registry so every subsystem shares one configuration.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from contextvars import ContextVar
from typing import Any

request_id_var: ContextVar[str | None] = ContextVar("request_id", default=None)

_ANSI = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry: dict[str, Any] = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        rid = request_id_var.get()
        if rid:
            entry["request_id"] = rid
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        extra = getattr(record, "extra_fields", None)
        if extra:
            entry.update(extra)
        return json.dumps(entry, ensure_ascii=False, default=str)


class ConsoleFormatter(logging.Formatter):
    def __init__(self, color: bool = True):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        rid = request_id_var.get()
        rid_part = f" [{rid[:8]}]" if rid else ""
        level = record.levelname
        if self.color:
            level = f"{_ANSI.get(level, '')}{level:<8}{_RESET}"
        else:
            level = f"{level:<8}"
        msg = f"{ts} {level} {record.name}{rid_part}: {record.getMessage()}"
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        return msg


_configured = False


def configure_logging(level: str = "INFO", log_path: str | None = None,
                      console: bool = True,
                      json_console: bool | None = None) -> None:
    """Install handlers on the ``fasttalk`` root logger (idempotent).

    ``json_console`` switches the console stream to structured JSON
    lines (one object per record, request-id correlated) — for
    deployments whose log shipper wants machine-parseable stderr.
    Defaults from ``LOG_FORMAT=json``; the ANSI console otherwise.
    """
    global _configured
    if json_console is None:
        json_console = os.getenv("LOG_FORMAT", "").strip().lower() in (
            "json", "jsonl", "structured")
    root = logging.getLogger("fasttalk")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()
    root.propagate = False
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(JsonFormatter() if json_console
                       else ConsoleFormatter(color=sys.stderr.isatty()))
        root.addHandler(h)
    if log_path:
        os.makedirs(log_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_path, "fasttalk.jsonl"))
        fh.setFormatter(JsonFormatter())
        root.addHandler(fh)
    _configured = True


def get_logger(name: str) -> "StructuredLogger":
    if not _configured:
        configure_logging(os.getenv("LOG_LEVEL", "INFO"))
    return StructuredLogger(logging.getLogger(f"fasttalk.{name}"))


class StructuredLogger:
    """Thin wrapper adding structured-extra and domain log helpers."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _log(self, level: int, msg: str, exc_info: bool = False, **extra: Any) -> None:
        self._logger.log(level, msg, exc_info=exc_info,
                         extra={"extra_fields": extra} if extra else None)

    def debug(self, msg: str, **extra: Any) -> None:
        self._log(logging.DEBUG, msg, **extra)

    def info(self, msg: str, **extra: Any) -> None:
        self._log(logging.INFO, msg, **extra)

    def warning(self, msg: str, **extra: Any) -> None:
        self._log(logging.WARNING, msg, **extra)

    def error(self, msg: str, exc_info: bool = False, **extra: Any) -> None:
        self._log(logging.ERROR, msg, exc_info=exc_info, **extra)

    def critical(self, msg: str, exc_info: bool = False, **extra: Any) -> None:
        self._log(logging.CRITICAL, msg, exc_info=exc_info, **extra)

    # Domain helpers (reference: logger.py:178-240) — true token counts here,
    # since this framework owns the tokenizer.
    def log_generation(self, session_id: str, tokens: int, duration_s: float,
                       ttft_ms: float | None = None, **extra: Any) -> None:
        tok_s = tokens / duration_s if duration_s > 0 else 0.0
        self.info(
            f"[{session_id}] generated {tokens} tok in {duration_s:.2f}s ({tok_s:.1f} tok/s)",
            session_id=session_id, tokens=tokens, duration_s=duration_s,
            tokens_per_second=tok_s, ttft_ms=ttft_ms, **extra)

    def log_connection(self, session_id: str, event: str,
                       level: str = "info", **extra: Any) -> None:
        # Per-connection close lines are DEBUG at the call site: at 16+
        # concurrent bench sessions the INFO tail was nothing but
        # "connection closed" lines burying the throughput summary.
        getattr(self, level, self.info)(
            f"[{session_id}] connection {event}", session_id=session_id,
            event=event, **extra)

    def log_performance(self, name: str, duration_ms: float, **extra: Any) -> None:
        self.debug(f"perf {name}: {duration_ms:.1f}ms", perf=name,
                   duration_ms=duration_ms, **extra)
