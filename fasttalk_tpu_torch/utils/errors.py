"""Error taxonomy and circuit breaker of the serving path.

A subset of ``fasttalk_tpu/utils/errors.py`` (same classes, same wire
dict), kept as the port's own copy.
"""

from __future__ import annotations

import threading
import time
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
                 retry_after: float | None = None):
        super().__init__(message)
        self.message = message
        self.category = category
        self.severity = severity
        self.recoverable = recoverable
        self.retry_after = retry_after

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "code": self.category.value,
            "message": self.message,
            "severity": self.severity.value,
            "recoverable": self.recoverable,
        }
        if self.retry_after is not None:
            d["retry_after"] = self.retry_after
        return d


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
