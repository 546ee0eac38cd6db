"""Bounded structured event log: the service's operational incident record.

A copy of ``fasttalk_tpu/observability/events.py`` (the port imports
nothing of the JAX package); the scheduler emits its shed and drain
events through it.

Metrics say *how much*, traces say *where one request went* — neither
says *what happened to the service*: when shedding started, when the
watchdog caught a hung engine step, when a drain began, when a
mid-traffic recompile stalled the pipeline. This module is that third
surface: a process-wide bounded ring of typed events, exposed as
``GET /events`` on the monitoring port and optionally mirrored to a
JSONL file for log shippers (``EVENTS_JSONL`` env).

Event kinds in use across the stack (open set — callers may add more):

- ``slo_burn_start`` / ``slo_burn_stop`` — a priority class entered /
  left an SLO burn-rate alert state (observability/slo.py)
- ``stall_detected`` / ``stall_cleared`` — the watchdog caught (or saw
  recover) a hung engine step or a token-stalled request
  (observability/watchdog.py)
- ``watchdog_cancel`` — a hopelessly stalled request was terminated
  with a proper terminal error instead of a silent WebSocket
- ``shed_burst`` — admission control started shedding (coalesced: one
  event per burst with a running ``count``, not one per shed)
- ``drain`` — graceful drain began (server shutdown)
- ``recompile`` — a jitted executable was compiled while serving
  traffic (warmup misses; a mid-stream compile is a latency incident)
- ``engine_restart`` — supervised in-process engine recovery ran
- ``loop_lag`` — the serving event loop fell badly behind

Design constraints mirror the tracer's: cheap (one lock + one deque
append), thread-safe (events arrive from the engine thread, the asyncio
loop and the scheduler's callers), bounded (ring of ``EVENTS_RING``
entries, default 512), and clearable in place for tests.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("observability.events")

_SEVERITIES = ("info", "warning", "critical")


def env_float(name: str, default: float) -> float:
    """Silent-fallback float env knob (shared by the observability
    modules; utils.config keeps its stricter raising variant for the
    validated Config surface)."""
    raw = os.getenv(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass
class Event:
    seq: int                 # monotonically increasing per process
    kind: str
    severity: str
    ts: float                # wall-clock epoch seconds (first emission)
    last_ts: float           # wall clock of the latest coalesced hit
    count: int = 1           # coalesced occurrences
    attrs: dict[str, Any] = field(default_factory=dict)
    last_mirrored: float = 0.0  # JSONL-mirror throttle (not exported)
    ckey: str = ""              # coalesce key (not exported)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "seq": self.seq,
            "kind": self.kind,
            "severity": self.severity,
            "ts": self.ts,
            "count": self.count,
        }
        if self.count > 1:
            out["last_ts"] = self.last_ts
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class EventLog:
    """Process-wide bounded ring of typed operational events."""

    def __init__(self, ring_size: int | None = None,
                 jsonl_path: str | None = None,
                 clock=time.time):
        if ring_size is None:
            try:
                ring_size = int(os.getenv("EVENTS_RING", "512"))
            except ValueError:
                ring_size = 512
        if jsonl_path is None:
            jsonl_path = os.getenv("EVENTS_JSONL", "")
        self.ring_size = max(1, ring_size)
        self.jsonl_path = jsonl_path or ""
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque[Event] = deque()
        self._seq = 0
        self._total = 0
        # coalesce key -> most recent event still in the ring
        # (coalescing handle; O(1) instead of scanning the ring).
        self._last_by_key: dict[tuple[str, str], Event] = {}
        self._jsonl_warned = False
        # Subscribers (observability/flight.py): called outside the
        # lock on every emit (including coalesce bumps). A listener
        # must be cheap or hand off to its own thread — it runs on the
        # EMITTER's thread (engine, asyncio loop, scheduler callers).
        self._listeners: list[Any] = []

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(event)`` to every emit (idempotent)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def emit(self, kind: str, severity: str = "info",
             coalesce_s: float = 0.0, coalesce_key: str = "",
             **attrs: Any) -> Event:
        """Record one event. With ``coalesce_s`` > 0, a repeat of the
        same kind (and ``coalesce_key`` — e.g. the shed *reason*, so
        queue_full and slo_burn bursts stay distinct events) within
        that window bumps the previous event's ``count`` and refreshes
        its attrs instead of appending — burst kinds like
        ``shed_burst`` must not flood the ring out of its useful
        history. The JSONL mirror re-writes a bumped event at most
        once per window, so the shipped log still ends up carrying the
        burst's running count rather than a permanent ``count: 1``."""
        if severity not in _SEVERITIES:
            severity = "info"
        now = self._clock()
        key = (kind, coalesce_key)
        mirror_ev: Event | None = None
        with self._lock:
            if coalesce_s > 0:
                last = self._last_by_key.get(key)
                if last is not None and now - last.last_ts <= coalesce_s:
                    last.count += 1
                    last.last_ts = now
                    last.attrs.update(attrs)  # freshest depth/retry/...
                    self._total += 1
                    if now - last.last_mirrored >= coalesce_s:
                        last.last_mirrored = now
                        mirror_ev = last
                    ev = last
                else:
                    ev = None
            else:
                ev = None
            if ev is None:
                self._seq += 1
                self._total += 1
                ev = Event(seq=self._seq, kind=kind, severity=severity,
                           ts=now, last_ts=now, last_mirrored=now,
                           attrs=dict(attrs), ckey=coalesce_key)
                self._ring.append(ev)
                self._last_by_key[key] = ev
                mirror_ev = ev
                if len(self._ring) > self.ring_size:
                    dropped = self._ring.popleft()  # O(1) eviction
                    dkey = (dropped.kind, dropped.ckey)
                    if self._last_by_key.get(dkey) is dropped:
                        self._last_by_key.pop(dkey, None)
        # Mirror outside the lock: a slow disk must not serialise the
        # engine thread against the asyncio loop on the event lock.
        if self.jsonl_path and mirror_ev is not None:
            self._mirror(mirror_ev)
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(ev)
            except Exception as e:  # a broken listener must not take
                log.error(f"event listener failed: {e}")  # emit() down
        return ev

    def _mirror(self, ev: Event) -> None:
        try:
            with open(self.jsonl_path, "a", encoding="utf-8") as fp:
                fp.write(json.dumps(ev.to_dict(), ensure_ascii=False,
                                    default=str) + "\n")
        except OSError as e:
            if not self._jsonl_warned:
                self._jsonl_warned = True
                log.warning(f"events JSONL mirror disabled: {e}")
            self.jsonl_path = ""

    def recent(self, limit: int = 100,
               kind: str | None = None,
               min_severity: str | None = None) -> list[dict[str, Any]]:
        """Newest-first event dicts, optionally filtered."""
        with self._lock:
            events = list(self._ring)
        events.reverse()
        if kind:
            events = [e for e in events if e.kind == kind]
        if min_severity in _SEVERITIES:
            floor = _SEVERITIES.index(min_severity)
            events = [e for e in events
                      if _SEVERITIES.index(e.severity) >= floor]
        return [e.to_dict() for e in events[:max(0, limit)]]

    @property
    def total_emitted(self) -> int:
        return self._total

    def clear(self) -> None:
        """Test hook: drop all recorded events IN PLACE (modules cache
        the EventLog handle at construction, like metrics/tracer)."""
        with self._lock:
            self._ring.clear()
            self._last_by_key.clear()
            self._total = 0


_events: EventLog | None = None


def get_events() -> EventLog:
    global _events
    if _events is None:
        _events = EventLog()
    return _events


def reset_events() -> None:
    """Test hook: clear the process-wide event log in place."""
    if _events is not None:
        _events.clear()
