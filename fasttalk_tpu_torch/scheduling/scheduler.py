"""Admission-controlled request scheduling: the engine's front door.

A copy of ``fasttalk_tpu/scheduling/scheduler.py`` (``RequestScheduler``
:82), kept in the port because the port imports nothing of the JAX
package; the two must make the same decisions on the same sequence.

The seed engine queued submissions in an unbounded FIFO list
(engine.py `_waiting`): under sustained overload, queue depth and tail
latency grew without bound and every client eventually timed out
instead of a few being told to back off. This module is the
JetStream-style serving discipline the ROADMAP north star requires —
the system degrades *predictably*:

- **Bounded queue.** At most ``queue_bound`` requests wait; the
  excess is shed immediately with a computed ``retry_after``
  (AdmissionRejected rides the LLMServiceError taxonomy, so the WS
  error frame and the OpenAI route's 429 + Retry-After both carry it).
- **Priority classes.** "interactive" admits before "bulk",
  configurable per session/request; an aging threshold promotes a
  long-waiting bulk head so sustained interactive load can never
  starve bulk entirely.
- **Per-session fairness.** Within a class, sessions round-robin: a
  session that dumps 50 requests gets one admission per turn, not 50
  in a row, and no session waits forever behind a chatty neighbour.
  Pops are O(1) amortised (deque rotations; never a ``list.pop(i)``
  scan like the seed's skip-busy-sessions loop).
- **Deadlines.** Every queued request carries an absolute deadline
  (per-request ``deadline_s`` or the configured default). Expired
  entries are swept out with a terminal event before they ever touch
  the device; a submission whose *estimated* wait already exceeds its
  deadline is shed at the door instead of being queued to die.
- **Overload state machine.** healthy → pressured → shedding
  (published as the ``sched_overload_state`` gauge and through the
  health/stats endpoints) so operators and load balancers see the
  transition before the cliff.
- **Graceful drain.** ``begin_drain()`` keeps serving everything
  already queued or running but rejects new submissions with
  ``retry_after`` — wired into server shutdown so a rolling restart
  finishes its users' sentences.

Thread-safety: submissions arrive from asyncio handlers while the
engine thread pops/expires; one lock serialises all structure access
(the critical sections are a few dict/deque ops).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.utils.errors import AdmissionRejected
from fasttalk_tpu_torch.utils.metrics import get_metrics

PRIORITIES = ("interactive", "bulk")

# Overload states, in escalation order; gauge values for Prometheus.
STATE_HEALTHY = "healthy"
STATE_PRESSURED = "pressured"
STATE_SHEDDING = "shedding"
STATE_DRAINING = "draining"
_STATE_GAUGE = {STATE_HEALTHY: 0, STATE_PRESSURED: 1,
                STATE_SHEDDING: 2, STATE_DRAINING: 3}


@dataclass
class QueuedRequest:
    """One queued submission. ``payload`` is opaque to the scheduler
    (the engine stores its _Request there)."""

    request_id: str
    session_id: str
    priority: str
    submitted_at: float          # time.monotonic()
    deadline: float              # absolute monotonic expiry
    payload: Any = None
    cancelled: bool = field(default=False, compare=False)

    def deadline_in_s(self, now: float | None = None) -> float:
        return self.deadline - (time.monotonic() if now is None else now)


class RequestScheduler:
    """Bounded, deadline-aware, session-fair admission queue."""

    def __init__(self, *, queue_bound: int = 256,
                 default_deadline_s: float = 30.0,
                 bulk_aging_s: float = 5.0,
                 slots: int = 16,
                 shed_hold_s: float = 5.0,
                 pressured_frac: float = 0.5,
                 sweep_interval_s: float = 0.05,
                 slo_gate=None,
                 clock=time.monotonic):
        if queue_bound <= 0:
            raise ValueError("queue_bound must be > 0")
        if default_deadline_s <= 0:
            raise ValueError("default_deadline_s must be > 0")
        if bulk_aging_s <= 0:
            raise ValueError("bulk_aging_s must be > 0")
        self.queue_bound = queue_bound
        self.default_deadline_s = default_deadline_s
        self.bulk_aging_s = bulk_aging_s
        self.slots = max(1, slots)
        self.shed_hold_s = shed_hold_s
        self.pressured_frac = pressured_frac
        self._sweep_interval = sweep_interval_s
        # Injectable time source (must be monotonic): every deadline,
        # aging and state decision reads THIS clock, so tests drive
        # expiry-vs-admission races deterministically by warping it
        # (the fake-clock pattern of slo.py/watchdog.py).
        self._clock = clock
        # Optional SLO consult (observability/slo.py should_shed):
        # callable(priority) -> True when this class must be shed
        # because a latency objective is burning. Evaluated OUTSIDE
        # severity checks the queue itself makes — the SLO engine sees
        # what the queue cannot (latency of requests already served).
        self._slo_gate = slo_gate
        self._events = get_events()
        self._lock = threading.Lock()
        # Per class: round-robin deque of session ids + per-session
        # FIFO deques. A session id may linger in the RR after its
        # deque empties (cancel tombstones); pop() drops it lazily.
        self._sessions: dict[str, dict[str, deque[QueuedRequest]]] = {
            p: {} for p in PRIORITIES}
        self._rr: dict[str, deque[str]] = {p: deque() for p in PRIORITIES}
        self._by_id: dict[str, QueuedRequest] = {}
        self._depth = 0               # live (non-tombstone) entries
        self._draining = False
        self._expired_pending: list[QueuedRequest] = []
        self._last_sweep = 0.0
        self._last_shed = float("-inf")
        # EMA of admission→finish service time, fed by the engine at
        # request finish; drives the wait estimate and retry_after.
        self._service_ema_s = 0.0
        m = get_metrics()
        self._m_shed = m.counter(
            "sched_shed_total",
            "submissions shed at admission (queue full, estimated wait "
            "past deadline, or draining)")
        self._m_expired = m.counter(
            "sched_expired_total",
            "queued requests expired past their deadline before "
            "admission")
        self._m_state = m.gauge(
            "sched_overload_state",
            "scheduler overload state (0=healthy 1=pressured "
            "2=shedding 3=draining)")
        self._m_bound = m.gauge("sched_queue_bound",
                                "configured admission queue bound")
        self._m_depth = m.gauge("sched_queue_depth",
                                "live queued requests awaiting admission")
        self._m_bound.set(queue_bound)
        self._m_state.set(0)

    # ---------------- submission side (any thread) ----------------

    def __len__(self) -> int:
        return self._depth

    @property
    def draining(self) -> bool:
        return self._draining

    def submit(self, request_id: str, session_id: str, *,
               priority: str = "interactive",
               deadline_s: float | None = None,
               payload: Any = None,
               wait_discount_s: float = 0.0) -> QueuedRequest:
        """Enqueue a request, or raise AdmissionRejected (with a
        computed retry_after) when it must be shed: drain mode, queue
        at bound, or estimated wait already past the deadline.

        ``wait_discount_s``: expected service-time saving the caller
        knows about and the queue cannot (the engine passes the
        estimated prefill a parked host-KV restore will skip,
        kvcache/policy.py restore_saving_s) — subtracted from the
        estimated wait before the wait_too_long shed decision, so a
        cheap-to-serve returning session is not turned away by an
        estimate calibrated on full prefills."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        now = self._clock()
        ttl = self.default_deadline_s if deadline_s is None else deadline_s
        # SLO consult BEFORE taking the queue lock: the gate may
        # evaluate burn windows under its own lock, and nesting it
        # inside ours would order the two locks both ways round.
        slo_shed = self._slo_gate is not None \
            and self._slo_gate(priority)
        try:
            with self._lock:
                if self._draining:
                    raise self._shed_locked(
                        now, "server is draining: finishing in-flight "
                        "requests, not accepting new ones",
                        reason="draining")
                if slo_shed:
                    raise self._shed_locked(
                        now, f"{priority} submissions are being shed: "
                        "the service is burning its interactive "
                        "latency SLO budget", reason="slo_burn")
                if self._depth >= self.queue_bound:
                    raise self._shed_locked(
                        now, f"admission queue full "
                        f"({self.queue_bound} waiting)",
                        reason="queue_full")
                est = max(0.0, self._estimate_wait_locked()
                          - max(0.0, wait_discount_s))
                if est > ttl:
                    raise self._shed_locked(
                        now, f"estimated queue wait {est:.1f}s exceeds "
                        f"the request deadline {ttl:.1f}s",
                        reason="wait_too_long")
                entry = QueuedRequest(
                    request_id=request_id, session_id=session_id,
                    priority=priority, submitted_at=now,
                    deadline=now + ttl, payload=payload)
                self._push_locked(entry, front=False)
                self._update_state_locked(now)
                return entry
        except AdmissionRejected as e:
            # One event per shed BURST per reason (coalesced), emitted
            # outside the queue lock — see _shed_locked.
            payload_ev = getattr(e, "_shed_event", None)
            if payload_ev:
                self._events.emit("shed_burst", severity="warning",
                                  coalesce_s=5.0,
                                  coalesce_key=payload_ev["reason"],
                                  **payload_ev)
            raise

    def _shed_locked(self, now: float, message: str,
                     reason: str) -> AdmissionRejected:
        if reason == "queue_full":
            # Only capacity sheds drive the overload state machine: a
            # wait_too_long shed can be caused entirely by ONE client's
            # unrealistically small deadline_s, and flipping /health to
            # "shedding" for it would let a single misbehaving client
            # distort the operator/load-balancer signal.
            self._last_shed = now
        self._m_shed.inc()
        retry = self._retry_after_locked()
        self._update_state_locked(now)
        exc = AdmissionRejected(message, retry_after=retry, reason=reason)
        # Event payload rides the exception; submit() emits it AFTER
        # releasing the queue lock — emit() may mirror to a (possibly
        # slow) EVENTS_JSONL disk, and that write must never serialise
        # concurrent submitters and the engine's pop against this lock.
        exc._shed_event = {"reason": reason, "depth": self._depth,
                           "bound": self.queue_bound,
                           "retry_after": round(retry, 2)}
        return exc

    def _push_locked(self, entry: QueuedRequest, front: bool) -> None:
        sessions = self._sessions[entry.priority]
        q = sessions.get(entry.session_id)
        if q is None:
            sessions[entry.session_id] = q = deque()
            rr = self._rr[entry.priority]
            # The sid may already sit in the RR as a stale entry (its
            # queue emptied via an expiry sweep, which doesn't touch
            # the RR): re-appending would hand the session two turns
            # per round. Membership scan is bounded by queue_bound.
            if entry.session_id not in rr:
                (rr.appendleft if front else rr.append)(entry.session_id)
        (q.appendleft if front else q.append)(entry)
        self._by_id[entry.request_id] = entry
        self._depth += 1
        self._m_depth.set(self._depth)

    def cancel(self, request_id: str) -> QueuedRequest | None:
        """Remove a queued request (O(1): tombstone + index drop).
        Returns the entry if it was still queued, else None."""
        with self._lock:
            entry = self._by_id.pop(request_id, None)
            if entry is None:
                return None
            entry.cancelled = True
            self._depth -= 1
            self._m_depth.set(self._depth)
            self._update_state_locked(self._clock())
            return entry

    # ---------------- admission side (engine thread) ----------------

    def pop(self, busy_sessions: set[str] | frozenset[str] = frozenset(),
            now: float | None = None) -> QueuedRequest | None:
        """Next admissible request, honouring priority (with bulk
        aging), per-session round-robin, deadlines and tombstones.
        Sessions in ``busy_sessions`` are skipped but stay queued.
        Entries found expired are diverted to take_expired()."""
        now = self._clock() if now is None else now
        with self._lock:
            for priority in self._class_order_locked(now):
                entry = self._pop_class_locked(priority, busy_sessions,
                                               now)
                if entry is not None:
                    self._update_state_locked(now)
                    return entry
            return None

    def _class_order_locked(self, now: float) -> tuple[str, ...]:
        # Aging: when the bulk class's next-in-turn head entry has
        # waited past bulk_aging_s, bulk admits first this pop —
        # sustained interactive load can delay bulk, never starve it.
        rr = self._rr["bulk"]
        sessions = self._sessions["bulk"]
        # Drop stale heads (queues emptied by an expiry sweep) here:
        # under sustained interactive load the bulk class may never be
        # popped, so pop()'s lazy cleanup would never reach them and a
        # stale head would permanently mask the aging check.
        while rr and rr[0] not in sessions:
            rr.popleft()
        if rr:
            q = sessions[rr[0]]
            if q and now - q[0].submitted_at > self.bulk_aging_s:
                return ("bulk", "interactive")
        return ("interactive", "bulk")

    def _pop_class_locked(self, priority: str, busy, now: float,
                          ) -> QueuedRequest | None:
        rr = self._rr[priority]
        sessions = self._sessions[priority]
        for _ in range(len(rr)):
            sid = rr.popleft()
            q = sessions.get(sid)
            entry = None
            while q:
                head = q.popleft()
                if head.cancelled:
                    continue  # tombstone; depth already decremented
                if head.deadline <= now:
                    self._expire_entry_locked(head)
                    continue
                entry = head
                break
            if entry is None:
                sessions.pop(sid, None)  # drained; rr entry dropped
                continue
            if sid in busy:
                # Restore the head and rotate the session to the tail:
                # it stays queued while its earlier turn runs.
                q.appendleft(entry)
                rr.append(sid)
                continue
            if q:
                rr.append(sid)  # fairness: session goes to the back
            else:
                sessions.pop(sid, None)
            self._by_id.pop(entry.request_id, None)
            self._depth -= 1
            self._m_depth.set(self._depth)
            return entry
        return None

    def requeue_front(self, entry: QueuedRequest) -> None:
        """Put a just-popped entry back at the head of its session's
        queue (no free slot this iteration); it keeps its deadline and
        its next-in-turn position."""
        with self._lock:
            self._push_locked(entry, front=True)

    def _expire_entry_locked(self, entry: QueuedRequest) -> None:
        self._by_id.pop(entry.request_id, None)
        self._depth -= 1
        self._m_depth.set(self._depth)
        self._m_expired.inc()
        self._expired_pending.append(entry)

    def take_expired(self, now: float | None = None,
                     ) -> list[QueuedRequest]:
        """Expired entries needing a terminal event. Sweeps the whole
        queue at most every ``sweep_interval_s`` (bounded by
        queue_bound, so the engine loop never pays an unbounded scan)
        and drains entries pop() found expired."""
        now = self._clock() if now is None else now
        with self._lock:
            if now - self._last_sweep >= self._sweep_interval:
                self._last_sweep = now
                for priority in PRIORITIES:
                    sessions = self._sessions[priority]
                    for sid in list(sessions):
                        q = sessions[sid]
                        if not any(e.cancelled or e.deadline <= now
                                   for e in q):
                            continue
                        keep: deque[QueuedRequest] = deque()
                        for e in q:
                            if e.cancelled:
                                continue
                            if e.deadline <= now:
                                self._expire_entry_locked(e)
                            else:
                                keep.append(e)
                        if keep:
                            sessions[sid] = keep
                        else:
                            # rr keeps the sid; pop() drops it lazily.
                            sessions.pop(sid, None)
            out, self._expired_pending = self._expired_pending, []
            if out:
                self._update_state_locked(now)
            return out

    # ---------------- lifecycle ----------------

    def begin_drain(self) -> None:
        """Stop admitting new submissions; queued and in-flight work
        still completes. Irreversible for this scheduler instance."""
        with self._lock:
            already = self._draining
            self._draining = True
            self._update_state_locked(self._clock())
        if not already:
            self._events.emit("drain", depth=self._depth,
                              bound=self.queue_bound)

    def clear(self) -> None:
        """Drop every queued entry (engine shutdown/crash: the caller
        emits the terminal events via its request registry)."""
        with self._lock:
            for p in PRIORITIES:
                self._sessions[p].clear()
                self._rr[p].clear()
            self._by_id.clear()
            self._depth = 0
            self._expired_pending.clear()
            self._m_depth.set(0)
            self._update_state_locked(self._clock())

    def remove_finished(self) -> None:
        """Drop entries whose payload already carries a terminal state
        (restart after a crash: _abort_all errored them; their queue
        entries must not be re-admitted)."""
        with self._lock:
            for p in PRIORITIES:
                sessions = self._sessions[p]
                for sid in list(sessions):
                    keep: deque[QueuedRequest] = deque()
                    for e in sessions[sid]:
                        if e.cancelled:
                            continue  # tombstone: not counted in depth
                        if getattr(e.payload, "finished", False):
                            self._by_id.pop(e.request_id, None)
                            self._depth -= 1
                        else:
                            keep.append(e)
                    if keep:
                        sessions[sid] = keep
                    else:
                        sessions.pop(sid, None)
            self._m_depth.set(self._depth)

    # ---------------- estimation + state ----------------

    def note_service_time(self, seconds: float) -> None:
        """Feed one request's admission→finish wall time into the
        service-time EMA (drives wait estimates and retry_after)."""
        if seconds <= 0:
            return
        with self._lock:
            if self._service_ema_s == 0.0:
                self._service_ema_s = seconds
            else:
                self._service_ema_s = (0.8 * self._service_ema_s
                                       + 0.2 * seconds)

    def _estimate_wait_locked(self) -> float:
        """Expected queue wait for a submission arriving now: queue
        depth over slot-level service rate. Zero until the first
        request finishes (conservative: never shed on no data)."""
        return (self._depth / self.slots) * self._service_ema_s

    def estimate_wait(self) -> float:
        with self._lock:
            return self._estimate_wait_locked()

    def _retry_after_locked(self) -> float:
        base = self._estimate_wait_locked() or self._service_ema_s or 1.0
        return min(30.0, max(1.0, base))

    def retry_after(self) -> float:
        """Suggested client back-off in seconds, bounded to [1, 30]."""
        with self._lock:
            return self._retry_after_locked()

    def overload_state(self, now: float | None = None) -> str:
        now = self._clock() if now is None else now
        with self._lock:
            return self._state_locked(now)

    def _state_locked(self, now: float) -> str:
        if self._draining:
            return STATE_DRAINING
        if self._depth >= self.queue_bound \
                or now - self._last_shed <= self.shed_hold_s:
            return STATE_SHEDDING
        if self._depth >= self.pressured_frac * self.queue_bound:
            return STATE_PRESSURED
        return STATE_HEALTHY

    def _update_state_locked(self, now: float) -> None:
        self._m_state.set(_STATE_GAUGE[self._state_locked(now)])

    # ---------------- read side ----------------

    def stats(self) -> dict[str, Any]:
        now = self._clock()
        with self._lock:
            return {
                "state": self._state_locked(now),
                "depth": self._depth,
                "bound": self.queue_bound,
                "draining": self._draining,
                "shed_total": self._m_shed.value,
                "expired_total": self._m_expired.value,
                "service_time_ema_s": round(self._service_ema_s, 4),
                "estimated_wait_s": round(self._estimate_wait_locked(),
                                          4),
            }

    def snapshot(self, now: float | None = None) -> list[dict[str, Any]]:
        """Queued entries in approximate admission order, with position
        and remaining deadline — /debug/requests."""
        now = self._clock() if now is None else now
        out: list[dict[str, Any]] = []
        with self._lock:
            pos = 0
            for priority in self._class_order_locked(now):
                rr = self._rr[priority]
                sessions = self._sessions[priority]
                # Walk sessions in RR order, one entry per turn, like
                # pop() would — positions reflect real admission order.
                cursors = {sid: 0 for sid in rr if sid in sessions}
                order = [sid for sid in rr if sid in sessions]
                progressed = True
                while progressed:
                    progressed = False
                    for sid in order:
                        q = sessions[sid]
                        i = cursors[sid]
                        while i < len(q) and q[i].cancelled:
                            i += 1
                        if i >= len(q):
                            cursors[sid] = i
                            continue
                        e = q[i]
                        cursors[sid] = i + 1
                        progressed = True
                        out.append({
                            "request_id": e.request_id,
                            "session_id": e.session_id,
                            "priority": e.priority,
                            "position": pos,
                            "queued_s": round(now - e.submitted_at, 3),
                            "deadline_in_s": round(e.deadline - now, 3),
                        })
                        pos += 1
        return out
