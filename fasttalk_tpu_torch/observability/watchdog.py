"""Stall watchdog: turns "no forward progress" into a detected event.

A copy of ``fasttalk_tpu/observability/watchdog.py`` (the port
imports nothing of the JAX package); the two must behave the same on
the same inputs.

A serving stack can hang in ways none of the existing surfaces notice:
the engine thread blocks forever inside a device call (every WebSocket
goes silent but /health still says healthy), a single request stops
producing tokens while the loop spins on (its client waits on a socket
that will never speak again), or the asyncio serving loop itself falls
seconds behind (token frames stall even though the engine is fine).
This module watches all three:

- **Engine-step heartbeat.** The engine loop stamps a monotonic float
  every iteration (engine.heartbeat_age()); while the engine has
  pending work, a heartbeat older than ``WATCHDOG_STEP_STALL_S``
  (default 15 s) is a hung step — a ``stall_detected`` event is
  emitted and /health turns degraded until it recovers.
- **Per-request token stalls.** The engine's per-request progress
  stamps (engine.progress_report()) expose how long each admitted
  request has gone without a token. Past ``WATCHDOG_TOKEN_STALL_S``
  (default 30 s) the request is flagged; past
  ``WATCHDOG_CANCEL_STALL_S`` (default 2x) it is terminated through
  engine.force_fail() with a proper terminal error frame — the client
  gets ``code: "stalled"`` plus a ``watchdog_cancel`` event, instead
  of a silent WebSocket.
- **Serving-event-loop lag.** The watchdog's own tick measures how
  late ``asyncio.sleep`` fires; the excess lands in the
  ``event_loop_lag_ms`` histogram and, past ``WATCHDOG_LOOP_LAG_MS``
  (default 500), emits a coalesced ``loop_lag`` event.

Everything is duck-typed against the engine (getattr), so FakeEngine
and the remote providers — which have no engine thread to hang — are
simply unwatched. The clock is injectable and ``check()`` is a plain
method, so tests drive synthetic stalls with a fake clock and zero
real sleeps.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any

from fasttalk_tpu_torch.observability.events import (EventLog, env_float,
                                                     get_events)
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("observability.watchdog")


class Watchdog:
    """Progress watchdog over one engine; process-wide singleton in
    serving (get_watchdog), standalone-constructible in tests."""

    def __init__(self, *,
                 token_stall_s: float | None = None,
                 step_stall_s: float | None = None,
                 cancel_stall_s: float | None = None,
                 interval_s: float | None = None,
                 loop_lag_warn_ms: float | None = None,
                 clock=time.monotonic,
                 events: EventLog | None = None):
        self.token_stall_s = token_stall_s if token_stall_s is not None \
            else env_float("WATCHDOG_TOKEN_STALL_S", 30.0)
        self.step_stall_s = step_stall_s if step_stall_s is not None \
            else env_float("WATCHDOG_STEP_STALL_S", 15.0)
        self.cancel_stall_s = cancel_stall_s \
            if cancel_stall_s is not None \
            else env_float("WATCHDOG_CANCEL_STALL_S",
                            2.0 * self.token_stall_s)
        if self.cancel_stall_s < self.token_stall_s:
            # Cancellation can never precede detection (_check_tokens
            # only examines requests past the detection threshold), so
            # a smaller cancel threshold would silently mean
            # max(token, cancel). Honor the operator's intent instead:
            # detect AND cancel at the cancel threshold.
            log.warning(
                f"WATCHDOG_CANCEL_STALL_S ({self.cancel_stall_s}s) < "
                f"WATCHDOG_TOKEN_STALL_S ({self.token_stall_s}s); "
                "lowering the detection threshold to match — stalled "
                "requests are terminated as soon as they are flagged")
            self.token_stall_s = self.cancel_stall_s
        self.interval_s = interval_s if interval_s is not None \
            else max(0.05, env_float("WATCHDOG_INTERVAL_S", 1.0))
        self.loop_lag_warn_ms = loop_lag_warn_ms \
            if loop_lag_warn_ms is not None \
            else env_float("WATCHDOG_LOOP_LAG_MS", 500.0)
        self._clock = clock
        self._events = events if events is not None else get_events()
        self._lock = threading.Lock()
        self._engine: Any = None
        self._step_stalled = False
        self._token_stalled: dict[str, float] = {}  # rid -> detected at
        # Requests already force-failed: the engine thread may stay
        # blocked (unable to process the cancel) for many more ticks,
        # and each one would otherwise re-detect and re-terminate the
        # same request — duplicate frames, spammed events.
        self._cancelled: set[str] = set()
        m = get_metrics()
        self._m_loop_lag = m.histogram(
            "event_loop_lag_ms",
            "serving event loop scheduling lag per watchdog tick "
            "(how late asyncio.sleep fired)",
            buckets=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 10000))
        self._m_hb_age = m.gauge(
            "engine_step_heartbeat_age_s",
            "seconds since the engine loop last completed an iteration")
        self._m_degraded = m.gauge(
            "watchdog_degraded",
            "1 while the watchdog sees a stalled engine step or "
            "token-stalled requests")
        self._m_stalls = m.counter(
            "watchdog_stalls_total",
            "stall detections (engine-step and per-request token "
            "stalls)")
        self._m_cancelled = m.counter(
            "watchdog_cancelled_total",
            "hopelessly stalled requests terminated by the watchdog")

    # ---------------- wiring ----------------

    def bind_engine(self, engine: Any) -> None:
        """Attach the engine to watch (duck-typed: engines without
        heartbeat/progress surfaces are left unwatched)."""
        with self._lock:
            if engine is not self._engine:
                self._engine = engine
                self._step_stalled = False
                self._token_stalled.clear()
                self._cancelled.clear()

    def heartbeat_age(self, now: float | None = None) -> float | None:
        engine = self._engine
        fn = getattr(engine, "heartbeat_age", None)
        if fn is None:
            return None
        try:
            return fn(now)
        except TypeError:
            return fn()
        except Exception:
            return None

    def sample(self) -> None:
        """Cheap gauge refresh (called by the monitoring app before
        rendering /metrics, so the heartbeat age is visible to scrapers
        even before the watchdog trips)."""
        age = self.heartbeat_age()
        if age is not None:
            self._m_hb_age.set(round(age, 3))

    # ---------------- the check ----------------

    def check(self, now: float | None = None) -> dict[str, Any]:
        """One watchdog pass; returns (and stores) the status dict."""
        now = self._clock() if now is None else now
        engine = self._engine
        step_stalled = False
        hb_age = None
        if engine is not None:
            hb_age = self.heartbeat_age(now)
            if hb_age is not None:
                self._m_hb_age.set(round(hb_age, 3))
                pending = getattr(engine, "pending_requests",
                                  lambda: 0)()
                step_stalled = bool(pending > 0
                                    and hb_age > self.step_stall_s)
        with self._lock:
            was = self._step_stalled
            self._step_stalled = step_stalled
        if step_stalled and not was:
            self._m_stalls.inc()
            self._events.emit(
                "stall_detected", severity="critical",
                stall="engine_step", heartbeat_age_s=round(hb_age, 3),
                threshold_s=self.step_stall_s)
            log.critical(f"engine step loop stalled: no iteration for "
                         f"{hb_age:.1f}s with pending work")
        elif was and not step_stalled:
            self._events.emit("stall_cleared", stall="engine_step")
            log.warning("engine step loop recovered")

        token_stalled = self._check_tokens(engine, now)

        degraded = step_stalled or bool(token_stalled)
        self._m_degraded.set(1.0 if degraded else 0.0)
        return {
            "ok": not degraded,
            "step_stalled": step_stalled,
            "heartbeat_age_s": round(hb_age, 3)
            if hb_age is not None else None,
            "token_stalled": token_stalled,
        }

    def _check_tokens(self, engine: Any,
                      now: float) -> list[dict[str, Any]]:
        report_fn = getattr(engine, "progress_report", None)
        if report_fn is None:
            with self._lock:
                self._token_stalled.clear()
            return []
        try:
            report = report_fn(now)
        except TypeError:
            report = report_fn()
        except Exception as e:
            log.error(f"progress_report failed: {e}")
            return []
        stalled: list[dict[str, Any]] = []
        seen: set[str] = set()
        for entry in report:
            rid = entry.get("request_id", "")
            age = float(entry.get("no_progress_s", 0.0))
            seen.add(rid)
            with self._lock:
                if rid in self._cancelled:
                    continue  # terminated; engine just hasn't reaped it
                known = rid in self._token_stalled
            if age <= self.token_stall_s:
                if known:
                    with self._lock:
                        self._token_stalled.pop(rid, None)
                    self._events.emit("stall_cleared", stall="token",
                                      request_id=rid)
                continue
            if not known:
                with self._lock:
                    self._token_stalled[rid] = now
                self._m_stalls.inc()
                self._events.emit(
                    "stall_detected", severity="warning", stall="token",
                    request_id=rid,
                    session_id=entry.get("session_id", ""),
                    phase=entry.get("phase", ""),
                    no_token_for_s=round(age, 3),
                    threshold_s=self.token_stall_s)
                log.warning(f"request {rid} token-stalled: no token "
                            f"for {age:.1f}s")
            if age > self.cancel_stall_s:
                self._cancel_stalled(engine, rid, age)
                continue
            stalled.append({"request_id": rid,
                            "no_token_for_s": round(age, 3)})
        # Requests that vanished from the report (finished, cancelled)
        # stop being tracked without a cleared event — their terminal
        # frame already told the story.
        with self._lock:
            for rid in list(self._token_stalled):
                if rid not in seen:
                    self._token_stalled.pop(rid, None)
            self._cancelled &= seen
        return stalled

    def _cancel_stalled(self, engine: Any, rid: str, age: float) -> None:
        with self._lock:
            self._cancelled.add(rid)
        fail = getattr(engine, "force_fail", None)
        ok = False
        if fail is not None:
            try:
                ok = bool(fail(
                    rid,
                    error=f"no forward progress for {age:.0f}s; "
                    "terminated by the stall watchdog",
                    code="stalled"))
            except Exception as e:
                log.error(f"force_fail({rid}) raised: {e}")
        if ok:
            self._m_cancelled.inc()
            self._events.emit("watchdog_cancel", severity="critical",
                              request_id=rid,
                              no_token_for_s=round(age, 3))
            log.error(f"request {rid} cancelled by the stall watchdog "
                      f"after {age:.1f}s without progress")
        with self._lock:
            self._token_stalled.pop(rid, None)

    # ---------------- status / loop ----------------

    def status(self, now: float | None = None) -> dict[str, Any]:
        """Health-surface view without re-running detection: the
        flags the last check() left behind."""
        hb_age = self.heartbeat_age(now)
        with self._lock:
            step = self._step_stalled
            tokens = list(self._token_stalled)
        return {
            "ok": not (step or tokens),
            "step_stalled": step,
            "heartbeat_age_s": round(hb_age, 3)
            if hb_age is not None else None,
            "token_stalled": tokens,
        }

    def note_loop_lag(self, lag_ms: float) -> None:
        self._m_loop_lag.observe(max(0.0, lag_ms))
        if lag_ms > self.loop_lag_warn_ms:
            self._events.emit("loop_lag", severity="warning",
                              coalesce_s=30.0,
                              lag_ms=round(lag_ms, 1),
                              threshold_ms=self.loop_lag_warn_ms)

    async def run(self) -> None:
        """The serving-side loop (started by the server at startup):
        tick, measure our own scheduling lag, check. Uses the real
        clock by construction — tests call check() directly."""
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.interval_s)
            lag_ms = (time.monotonic() - t0 - self.interval_s) * 1000.0
            self.note_loop_lag(lag_ms)
            try:
                self.check()
            except Exception as e:  # the watchdog must not die quietly
                log.error(f"watchdog check failed: {e}", exc_info=True)

    def clear(self) -> None:
        """Test hook: unbind and drop all detection state IN PLACE."""
        with self._lock:
            self._engine = None
            self._step_stalled = False
            self._token_stalled.clear()
            self._cancelled.clear()
        self._m_degraded.set(0.0)


_watchdog: Watchdog | None = None


def get_watchdog() -> Watchdog:
    global _watchdog
    if _watchdog is None:
        _watchdog = Watchdog()
    return _watchdog


def reset_watchdog() -> None:
    """Test hook: clear the process-wide watchdog in place."""
    if _watchdog is not None:
        _watchdog.clear()
