"""Error taxonomy, circuit breaker and error history of the serving path.

A subset of ``fasttalk_tpu/utils/errors.py`` (same classes, same wire
dict), kept as the port's own copy.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class ErrorCategory(str, Enum):
    CONNECTION = "connection_error"
    TIMEOUT = "timeout_error"
    MODEL = "model_error"
    VALIDATION = "validation_error"
    RATE_LIMIT = "rate_limit_error"
    RESOURCE = "resource_error"
    CANCELLED = "cancelled"
    INTERNAL = "internal_error"


class ErrorSeverity(str, Enum):
    LOW = "low"
    MEDIUM = "medium"
    HIGH = "high"
    CRITICAL = "critical"


class LLMServiceError(Exception):
    """Service error carrying category/severity/recoverability hints that
    are surfaced to WebSocket clients."""

    def __init__(self, message: str,
                 category: ErrorCategory = ErrorCategory.INTERNAL,
                 severity: ErrorSeverity = ErrorSeverity.MEDIUM,
                 recoverable: bool = True,
                 retry_after: float | None = None,
                 details: dict[str, Any] | None = None):
        super().__init__(message)
        self.message = message
        self.category = category
        self.severity = severity
        self.recoverable = recoverable
        self.retry_after = retry_after
        self.details = details or {}

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "code": self.category.value,
            "message": self.message,
            "severity": self.severity.value,
            "recoverable": self.recoverable,
        }
        if self.retry_after is not None:
            d["retry_after"] = self.retry_after
        if self.details:
            d["details"] = self.details
        return d


class AdmissionRejected(LLMServiceError):
    """A request shed by the engine to protect itself (KV block pool
    exhausted, a deadline that expired in the queue): recoverable, with a
    ``retry_after``. Load shedding, not a backend fault: the serving layer
    must not count it against the circuit breaker."""

    def __init__(self, message: str, retry_after: float,
                 reason: str = "shed"):
        super().__init__(message, category=ErrorCategory.RATE_LIMIT,
                         severity=ErrorSeverity.MEDIUM, recoverable=True,
                         retry_after=retry_after,
                         details={"reason": reason})
        self.reason = reason

    @classmethod
    def from_shed_event(cls, event: dict) -> "AdmissionRejected":
        """From an engine terminal error event whose ``code`` is in
        ``ENGINE_SHED_CODES``; the code rides on as ``details.reason``."""
        return cls(str(event.get("error") or "request shed"),
                   retry_after=float(event.get("retry_after") or 1.0),
                   reason=str(event.get("code") or "shed"))


# Engine terminal-error codes that are load shedding, not backend faults:
# the serving layer sends them as rate-limit frames with retry_after and
# leaves the circuit breaker untouched.
ENGINE_SHED_CODES = ("deadline_expired", "kv_blocks_exhausted")


class CircuitBreakerOpen(LLMServiceError):
    def __init__(self, retry_after: float):
        super().__init__(
            "Service temporarily unavailable (circuit open)",
            category=ErrorCategory.RESOURCE, severity=ErrorSeverity.HIGH,
            recoverable=True, retry_after=retry_after)


class CircuitBreaker:
    """CLOSED -> OPEN after ``failure_threshold`` consecutive failures;
    OPEN -> HALF_OPEN after ``reset_timeout``; HALF_OPEN closes after
    ``half_open_successes`` successes or re-opens on any failure."""

    def __init__(self, failure_threshold: int = 5, reset_timeout: float = 30.0,
                 half_open_successes: int = 2):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.half_open_successes = half_open_successes
        self._state = "closed"
        self._failures = 0
        self._successes = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def _maybe_half_open(self) -> None:
        if self._state == "open" \
                and time.monotonic() - self._opened_at >= self.reset_timeout:
            self._state = "half_open"
            self._successes = 0

    def check(self) -> None:
        """Raise CircuitBreakerOpen if calls must not proceed."""
        with self._lock:
            self._maybe_half_open()
            if self._state == "open":
                remaining = self.reset_timeout - (time.monotonic()
                                                  - self._opened_at)
                raise CircuitBreakerOpen(retry_after=max(0.0, remaining))

    def record_success(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._successes += 1
                if self._successes >= self.half_open_successes:
                    self._state = "closed"
                    self._failures = 0
            else:
                self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = time.monotonic()
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._state = "open"
                self._opened_at = time.monotonic()

    def to_dict(self) -> dict[str, Any]:
        with self._lock:
            self._maybe_half_open()
            return {"state": self._state, "failures": self._failures}


@dataclass
class ErrorRecord:
    ts: float
    category: str
    severity: str
    message: str
    context: dict[str, Any] = field(default_factory=dict)


class ErrorHandler:
    """Categorizes foreign exceptions and keeps a bounded history (the
    ``errors`` block of ``/stats``)."""

    _PATTERNS: list[tuple[tuple[str, ...], ErrorCategory, ErrorSeverity]] = [
        (("connection", "refused", "unreachable", "reset by peer"),
         ErrorCategory.CONNECTION, ErrorSeverity.HIGH),
        (("timeout", "timed out", "deadline"),
         ErrorCategory.TIMEOUT, ErrorSeverity.MEDIUM),
        (("out of memory", "oom", "resource exhausted", "hbm"),
         ErrorCategory.RESOURCE, ErrorSeverity.CRITICAL),
        (("rate limit", "too many requests"),
         ErrorCategory.RATE_LIMIT, ErrorSeverity.MEDIUM),
        (("invalid", "validation", "must be", "expected"),
         ErrorCategory.VALIDATION, ErrorSeverity.LOW),
        (("cancel",), ErrorCategory.CANCELLED, ErrorSeverity.LOW),
    ]

    def __init__(self, history_size: int = 200):
        self._history: deque[ErrorRecord] = deque(maxlen=history_size)
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def handle_error(self, exc: BaseException,
                     context: dict[str, Any] | None = None) -> LLMServiceError:
        if isinstance(exc, LLMServiceError):
            err = exc
        else:
            text = str(exc).lower()
            category, severity = ErrorCategory.INTERNAL, ErrorSeverity.MEDIUM
            for needles, cat, sev in self._PATTERNS:
                if any(n in text for n in needles):
                    category, severity = cat, sev
                    break
            err = LLMServiceError(str(exc) or type(exc).__name__,
                                  category=category, severity=severity)
        with self._lock:
            self._history.append(ErrorRecord(
                ts=time.time(), category=err.category.value,
                severity=err.severity.value, message=err.message,
                context=context or {}))
            self._counts[err.category.value] = self._counts.get(err.category.value, 0) + 1
        return err

    def get_error_stats(self) -> dict[str, Any]:
        with self._lock:
            recent = [
                {"ts": r.ts, "category": r.category, "severity": r.severity,
                 "message": r.message}
                for r in list(self._history)[-10:]
            ]
            return {
                "total_errors": sum(self._counts.values()),
                "by_category": dict(self._counts),
                "recent": recent,
            }
