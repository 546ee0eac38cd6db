"""Request-lifecycle span tracing for the whole serving stack.

The reference gateway's only observability was wall-clock log lines
(SURVEY.md §5); our metrics registry gives aggregates but cannot answer
*where* one slow request spent its time — queue wait, prefill, decode
steps, detokenize, or the WebSocket send. This module records exactly
that: lightweight named spans (monotonic-clock start/end + attrs) per
request, collected into a bounded per-process ring buffer of completed
traces, plus a separate ring of engine-step records (per retired decode
call, with batch-occupancy / slot-utilization / spec accept counts).

Design constraints, in priority order:

- **Cheap.** The engine thread touches the tracer on admission,
  activation, retirement and finish — never per token. Every public
  method is a no-op when tracing is disabled (``TRACE_ENABLED=0``), and
  the enabled path is one lock + one list append.
- **Thread-safe.** Spans arrive from the asyncio serving loop AND the
  engine thread for the same request; a single process-wide lock
  serialises them (contention is negligible at these call rates).
- **Correlated.** ``bind_request`` sets the same ContextVar the logger
  reads (utils/logger.request_id_var), so every log line inside a bound
  task carries the request id — one id from WS frame to decode step.

Timestamps are ``time.monotonic()`` (robust to clock steps); the tracer
keeps one process-wide (wall, monotonic) anchor pair so exporters can
render absolute wall-clock times.

Export (Chrome trace-event JSON for Perfetto, JSONL for offline
analysis) lives in observability/export.py; HTTP download endpoints in
monitoring/monitor.py; the offline percentile report in
scripts/trace_report.py.
"""

from __future__ import annotations

import contextvars
import os
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

from fasttalk_tpu_torch.utils.logger import request_id_var

# Hard cap on spans kept per trace: a runaway generation (thousands of
# decode calls) must not grow one trace without bound. Overflow is
# counted on the trace so the export can say what was dropped.
_MAX_SPANS_PER_TRACE = 2048

# ---------------------------------------------------------------------
# Trace-context propagation (docs/OBSERVABILITY.md "Fleet tracing").
#
# A trace id is minted once at the serving edge (WS accept / OpenAI
# request) and threaded through every hop after that: the ContextVar
# carries it across the asyncio task tree (and through
# asyncio.to_thread, which copies the context), the W3C-style
# ``traceparent`` header carries it across processes (the /v1 remote
# client and the /kv/parked migration wire), and stitch.py reassembles
# per-process fragments by it.
# ---------------------------------------------------------------------

trace_id_var: contextvars.ContextVar[str] = contextvars.ContextVar(
    "fasttalk_trace_id", default="")

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def propagate_enabled() -> bool:
    """TRACE_PROPAGATE gate (default on): whether outbound hops attach
    the traceparent header and inbound edges adopt it."""
    return os.getenv("TRACE_PROPAGATE", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def mint_trace_id() -> str:
    """A fresh 32-hex trace id (W3C trace-context format)."""
    return uuid.uuid4().hex


def current_trace_id() -> str:
    """The trace id bound in this context ("" when unbound)."""
    return trace_id_var.get()


def make_traceparent(trace_id: str) -> str:
    """Render a W3C ``traceparent`` header value for this hop. The
    span-id segment is minted per call (each hop is its own parent);
    we only consume the trace-id segment on the receiving side."""
    return f"00-{trace_id}-{uuid.uuid4().hex[:16]}-01"


def parse_traceparent(header: str | None) -> str | None:
    """Extract the trace id from a ``traceparent`` header value; None
    when absent or malformed (a bad header never fails the request —
    the trace just starts fresh on this process)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    tid = m.group(1)
    return None if tid == "0" * 32 else tid


def current_traceparent() -> str | None:
    """A ready-to-send traceparent header for the bound trace, or None
    when no trace is bound or propagation is disabled."""
    tid = trace_id_var.get()
    if not tid or not propagate_enabled():
        return None
    return make_traceparent(tid)


@dataclass
class Span:
    name: str
    t0: float            # time.monotonic() at start
    t1: float            # time.monotonic() at end
    attrs: dict[str, Any] = field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1000.0


@dataclass
class RequestTrace:
    request_id: str
    session_id: str
    started_mono: float = field(default_factory=time.monotonic)
    spans: list[Span] = field(default_factory=list)
    phase: str = "queued"
    finished: bool = False
    dropped_spans: int = 0
    attrs: dict[str, Any] = field(default_factory=dict)
    # Fleet-wide identity: the edge-minted trace id this request's
    # spans belong to. Fragments of one logical request on different
    # processes (failover, migration) share it; stitch.py joins on it.
    trace_id: str = ""

    def age_s(self) -> float:
        return time.monotonic() - self.started_mono


@dataclass
class StepRecord:
    """One retired engine decode call: process-level telemetry that is
    not owned by any single request (a call advances every active
    slot)."""
    name: str
    t0: float
    t1: float
    attrs: dict[str, Any] = field(default_factory=dict)


class Tracer:
    """Process-wide request tracer with a bounded completed-trace ring."""

    def __init__(self, enabled: bool | None = None, ring_size: int = 256,
                 step_ring_size: int = 1024):
        if enabled is None:
            enabled = os.getenv("TRACE_ENABLED", "1").strip().lower() \
                not in ("0", "false", "off", "no")
        self.enabled = enabled
        self._lock = threading.Lock()
        self._inflight: dict[str, RequestTrace] = {}
        self._ring: deque[RequestTrace] = deque(maxlen=max(1, ring_size))
        self._steps: deque[StepRecord] = deque(maxlen=max(1, step_ring_size))
        # One anchor pair for the whole process: exporters turn any
        # monotonic timestamp into wall time with wall0 + (t - mono0).
        self.wall0 = time.time()
        self.mono0 = time.monotonic()

    # ---------------- request lifecycle ----------------

    def start(self, request_id: str, session_id: str = "",
              trace_id: str | None = None) -> bool:
        """Register an in-flight request. Returns True if this call
        created the trace (the creator is responsible for finish());
        False if it already existed or tracing is disabled.

        ``trace_id`` resolution: an explicit id wins (the serving edge
        mints one), else the id bound in the current context (a replica
        adopting a propagated traceparent), else a fresh mint — every
        trace carries a fleet-unique id either way."""
        if not self.enabled:
            return False
        tid = trace_id or trace_id_var.get() or mint_trace_id()
        with self._lock:
            existing = self._inflight.get(request_id)
            if existing is not None:
                if not existing.trace_id:
                    existing.trace_id = tid
                return False
            self._inflight[request_id] = RequestTrace(
                request_id=request_id, session_id=session_id,
                trace_id=tid)
            return True

    def finish(self, request_id: str) -> None:
        """Move a request's trace to the completed ring (idempotent)."""
        if not self.enabled:
            return
        with self._lock:
            trace = self._inflight.pop(request_id, None)
            if trace is None:
                return
            trace.finished = True
            trace.phase = "done"
            self._ring.append(trace)

    def add_span(self, request_id: str, name: str, t0: float, t1: float,
                 summary: bool = False, **attrs: Any) -> None:
        """Record a completed span with explicit monotonic timestamps
        (the engine thread records phases retroactively at
        transitions).

        ``summary=True`` marks the once-per-request phase spans
        (decode, detokenize, upstream_stream): they bypass the span
        cap, so a long generation that filled the trace with per-call
        decode_step / per-frame ws_send spans still gets its phase
        breakdown — exactly the requests the cap would otherwise
        silence. Bounded regardless: a request emits only a handful of
        summary spans by construction."""
        if not self.enabled:
            return
        with self._lock:
            trace = self._inflight.get(request_id)
            if trace is None:
                return
            if not summary and len(trace.spans) >= _MAX_SPANS_PER_TRACE:
                trace.dropped_spans += 1
                return
            trace.spans.append(Span(name, t0, t1, attrs))

    @contextmanager
    def span(self, request_id: str, name: str,
             **attrs: Any) -> Iterator[None]:
        """Context-manager form of add_span for async-side callers."""
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_span(request_id, name, t0, time.monotonic(), **attrs)

    def event(self, request_id: str, name: str, **attrs: Any) -> None:
        """Zero-duration marker (e.g. first_token)."""
        now = time.monotonic()
        self.add_span(request_id, name, now, now, **attrs)

    def set_phase(self, request_id: str, phase: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            trace = self._inflight.get(request_id)
            if trace is not None:
                trace.phase = phase
                if attrs:
                    trace.attrs.update(attrs)

    # ---------------- engine-step telemetry ----------------

    def step(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        """Record one retired engine decode call (process-level row in
        the export, separate from any request's trace)."""
        if not self.enabled:
            return
        with self._lock:
            self._steps.append(StepRecord(name, t0, t1, attrs))

    # ---------------- read side ----------------

    def inflight_summary(self) -> list[dict[str, Any]]:
        """Live requests with current phase and age — /debug/requests."""
        with self._lock:
            traces = list(self._inflight.values())
        return [{
            "request_id": t.request_id,
            "session_id": t.session_id,
            "phase": t.phase,
            "age_s": round(t.age_s(), 3),
            "spans": len(t.spans),
            **({"attrs": dict(t.attrs)} if t.attrs else {}),
        } for t in traces]

    def get(self, request_id: str) -> RequestTrace | None:
        with self._lock:
            trace = self._inflight.get(request_id)
            if trace is not None:
                return trace
            for t in self._ring:
                if t.request_id == request_id:
                    return t
        return None

    def find_by_trace_id(self, trace_id: str) -> list[RequestTrace]:
        """Every local trace (in-flight or completed) carrying this
        fleet trace id — a failed-over request leaves one fragment per
        re-dispatch on a remote replica; stitch.py merges them."""
        if not trace_id:
            return []
        with self._lock:
            out = [t for t in self._inflight.values()
                   if t.trace_id == trace_id]
            out.extend(t for t in self._ring if t.trace_id == trace_id)
        return out

    def completed(self) -> list[RequestTrace]:
        with self._lock:
            return list(self._ring)

    def steps(self) -> list[StepRecord]:
        with self._lock:
            return list(self._steps)

    def to_wall(self, mono_t: float) -> float:
        """Monotonic timestamp → wall-clock epoch seconds."""
        return self.wall0 + (mono_t - self.mono0)

    def clear(self) -> None:
        """Drop all recorded state (in-flight, ring, steps)."""
        with self._lock:
            self._inflight.clear()
            self._ring.clear()
            self._steps.clear()

    def scoped(self, component: str) -> "ComponentTracer":
        """A view of this tracer that stamps ``component=<name>`` on
        every span/event/step it records — how router, serving and
        each in-proc replica distinguish their rows inside the ONE
        shared trace of a BENCH_MODE=fleet process."""
        return ComponentTracer(self, component)


class ComponentTracer:
    """Thin delegating wrapper around a Tracer that injects a
    ``component`` attr into recorded spans, events and step records
    (explicit attrs win). Lifecycle methods (start/finish/set_phase/
    read side) pass straight through — there is still exactly one
    underlying tracer and one trace per request id."""

    def __init__(self, inner: Tracer, component: str):
        self._inner = inner
        self.component = component

    @property
    def enabled(self) -> bool:
        return self._inner.enabled

    def add_span(self, request_id: str, name: str, t0: float, t1: float,
                 summary: bool = False, **attrs: Any) -> None:
        attrs.setdefault("component", self.component)
        self._inner.add_span(request_id, name, t0, t1, summary=summary,
                             **attrs)

    def event(self, request_id: str, name: str, **attrs: Any) -> None:
        attrs.setdefault("component", self.component)
        self._inner.event(request_id, name, **attrs)

    @contextmanager
    def span(self, request_id: str, name: str,
             **attrs: Any) -> Iterator[None]:
        if not self._inner.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_span(request_id, name, t0, time.monotonic(),
                          **attrs)

    def step(self, name: str, t0: float, t1: float,
             **attrs: Any) -> None:
        attrs.setdefault("component", self.component)
        self._inner.step(name, t0, t1, **attrs)

    def scoped(self, component: str) -> "ComponentTracer":
        return ComponentTracer(self._inner, component)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


@contextmanager
def bind_request(request_id: str,
                 trace_id: str | None = None) -> Iterator[None]:
    """Bind the request id into the logging/tracing ContextVar so every
    log line inside the block carries it (utils/logger formatters read
    the same var). When ``trace_id`` is given, bind it too — downstream
    hops in this task tree (the /v1 remote client, to_thread migration
    workers) read it via current_traceparent()."""
    token = request_id_var.set(request_id)
    t_token = trace_id_var.set(trace_id) if trace_id else None
    try:
        yield
    finally:
        request_id_var.reset(token)
        if t_token is not None:
            trace_id_var.reset(t_token)


_tracer: Tracer | None = None


def get_tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer


def reset_tracer() -> None:
    """Test hook: clear the process-wide tracer IN PLACE — modules
    cache the Tracer at construction time (engine.__init__), so
    dropping the singleton would orphan their handle exactly the way
    reset_metrics() used to orphan cached counters."""
    if _tracer is not None:
        _tracer.clear()
