"""SLO engine: per-priority-class objectives, multi-window burn rates,
alert states and goodput accounting.

A copy of ``fasttalk_tpu/observability/slo.py`` (the port
imports nothing of the JAX package); the two must behave the same on
the same inputs.

The tracer gives the service measurements (spans, phase histograms) and
the scheduler gives it load control (admission, shedding) — this module closes the
loop with an explicit notion of *the latency promise* and whether the
service is currently keeping it. The pattern is standard SRE practice
scaled to serving-time windows:

- **Objectives per priority class** (scheduling/scheduler.py classes:
  ``interactive``, ``bulk``): TTFT p95, inter-token p99, queue-wait
  p95, and error rate, each an env knob (``SLO_TTFT_P95_MS``,
  ``SLO_INTER_TOKEN_P99_MS``, ``SLO_QUEUE_WAIT_P95_MS``,
  ``SLO_ERROR_RATE``). Bulk relaxes the latency targets by
  ``SLO_BULK_FACTOR`` (default 4x) unless overridden per class
  (``SLO_BULK_TTFT_P95_MS`` etc. — any base knob prefixed with the
  upper-cased class name).
- **Multi-window burn rates.** Each objective has an error budget (a
  p95 target tolerates 5% violations, a p99 target 1%, the error-rate
  target is its own budget). Burn = observed violation fraction over a
  rolling window divided by the budget; burn 1.0 means exactly
  spending the budget, 10 means burning it 10x too fast. Windows are
  1m/5m/30m (``SLO_WINDOWS_S``).
- **Alert states** (classic fast/slow pairing): ``page`` when the
  short AND mid windows both burn at ≥ ``SLO_PAGE_BURN`` (default 10 —
  a fast, severe burn), ``warn`` when the mid AND long windows both
  burn at ≥ ``SLO_WARN_BURN`` (default 2 — slow but budget-exhausting),
  else ``ok``. A window with fewer than ``SLO_MIN_SAMPLES`` completed
  requests never alerts (no paging on three unlucky requests at 4 am).
  Transitions emit ``slo_burn_start`` / ``slo_burn_stop`` events
  (observability/events.py).
- **Goodput**: the fraction of completed requests that met *every*
  objective, per class and window — the honest headline under
  overload, where raw tok/s keeps looking fine while half the users
  wait seconds for a first token. The inter-token SLI is per-request:
  a request is inter-token-good when its **worst** gap is at or under
  the target (budgeted at 1%, the p99 discipline applied per request).

Recording is one ``record_request`` call per finished request (engine
``_finish``) — O(1) append under a lock; evaluation is lazy and cached
(at most once per second unless forced), so the hot path never pays
the window math.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any

from fasttalk_tpu_torch.observability.events import (EventLog, env_float,
                                                     get_events)
from fasttalk_tpu_torch.utils.metrics import Histogram

# One source of truth for the knob defaults; scripts/trace_report.py
# --slo mirrors these (stdlib-only, cannot import this module) and
# tests/test_slo.py pins the two tables equal.
DEFAULTS: dict[str, float] = {
    "SLO_TTFT_P95_MS": 1500.0,
    "SLO_INTER_TOKEN_P99_MS": 250.0,
    "SLO_QUEUE_WAIT_P95_MS": 1000.0,
    "SLO_ERROR_RATE": 0.01,
}
DEFAULT_BULK_FACTOR = 4.0
DEFAULT_WINDOWS_S = (60.0, 300.0, 1800.0)
DEFAULT_PAGE_BURN = 10.0
DEFAULT_WARN_BURN = 2.0
DEFAULT_MIN_SAMPLES = 20

# Error budgets implied by the objective's percentile: a p95 target
# tolerates 5% of requests over it, a p99 target 1%.
_BUDGETS = {"ttft": 0.05, "inter_token": 0.01, "queue_wait": 0.05}

ALERT_OK = "ok"
ALERT_WARN = "warn"
ALERT_PAGE = "page"
_ALERT_RANK = {ALERT_OK: 0, ALERT_WARN: 1, ALERT_PAGE: 2}


@dataclass(frozen=True)
class ClassObjectives:
    """Targets for one priority class (ms / fraction)."""
    ttft_p95_ms: float
    inter_token_p99_ms: float
    queue_wait_p95_ms: float
    error_rate: float

    def to_dict(self) -> dict[str, float]:
        return {
            "ttft_p95_ms": self.ttft_p95_ms,
            "inter_token_p99_ms": self.inter_token_p99_ms,
            "queue_wait_p95_ms": self.queue_wait_p95_ms,
            "error_rate": self.error_rate,
        }


def objectives_from_env(cls: str = "interactive") -> ClassObjectives:
    """Resolve one class's targets: per-class env override
    (``SLO_BULK_TTFT_P95_MS``) → base env (``SLO_TTFT_P95_MS``) →
    default, with bulk's latency targets relaxed by ``SLO_BULK_FACTOR``
    when only the base is set."""
    factor = 1.0
    if cls != "interactive":
        factor = max(1.0, env_float("SLO_BULK_FACTOR",
                                     DEFAULT_BULK_FACTOR))

    def knob(base_name: str, latency: bool) -> float:
        base = env_float(base_name, DEFAULTS[base_name])
        if latency:
            base *= factor
        override = f"SLO_{cls.upper()}_{base_name[len('SLO_'):]}"
        return env_float(override, base)

    return ClassObjectives(
        ttft_p95_ms=knob("SLO_TTFT_P95_MS", latency=cls != "interactive"),
        inter_token_p99_ms=knob("SLO_INTER_TOKEN_P99_MS",
                                latency=cls != "interactive"),
        queue_wait_p95_ms=knob("SLO_QUEUE_WAIT_P95_MS",
                               latency=cls != "interactive"),
        error_rate=knob("SLO_ERROR_RATE", latency=False),
    )


@dataclass
class _Sample:
    """One completed request, stamped with everything the objectives
    need. ``None`` fields mean the dimension does not apply (an errored
    request that never got a token has no TTFT; a one-token reply has
    no inter-token gap)."""
    t: float                     # monotonic completion time
    ok: bool                     # terminal done/stop/length (not error)
    good: bool                   # ok AND met every latency objective
    ttft_ms: float | None
    queue_wait_ms: float | None
    max_gap_ms: float | None


class _ClassState:
    def __init__(self, objectives: ClassObjectives):
        self.objectives = objectives
        self.samples: list[_Sample] = []
        self.alert = ALERT_OK
        self.total_requests = 0
        self.total_errors = 0
        self.total_good = 0
        self.total_shed = 0


def _window_label(seconds: float) -> str:
    if seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{int(seconds)}s"


class SLOEngine:
    """Rolling multi-window SLO evaluation over per-request samples."""

    def __init__(self, *,
                 windows_s: tuple[float, ...] | None = None,
                 page_burn: float | None = None,
                 warn_burn: float | None = None,
                 min_samples: int | None = None,
                 shed_bulk_on_page: bool | None = None,
                 clock=time.monotonic,
                 events: EventLog | None = None,
                 eval_interval_s: float = 1.0,
                 max_samples_per_class: int = 8192):
        if windows_s is None:
            raw = os.getenv("SLO_WINDOWS_S", "")
            try:
                windows_s = tuple(sorted(
                    float(x) for x in raw.split(",") if x.strip())) \
                    or DEFAULT_WINDOWS_S
            except ValueError:
                windows_s = DEFAULT_WINDOWS_S
        if len(windows_s) < 2:
            windows_s = DEFAULT_WINDOWS_S
        self.windows_s = tuple(sorted(windows_s))
        self.page_burn = page_burn if page_burn is not None \
            else env_float("SLO_PAGE_BURN", DEFAULT_PAGE_BURN)
        self.warn_burn = warn_burn if warn_burn is not None \
            else env_float("SLO_WARN_BURN", DEFAULT_WARN_BURN)
        self.min_samples = min_samples if min_samples is not None \
            else int(env_float("SLO_MIN_SAMPLES", DEFAULT_MIN_SAMPLES))
        if shed_bulk_on_page is None:
            shed_bulk_on_page = os.getenv(
                "SLO_SHED_BULK_ON_PAGE", "true").strip().lower() in (
                "1", "true", "yes", "on")
        self.shed_bulk_on_page = shed_bulk_on_page
        self._clock = clock
        self._events = events if events is not None else get_events()
        self._eval_interval = eval_interval_s
        self._max_samples = max_samples_per_class
        self._lock = threading.Lock()
        self._classes: dict[str, _ClassState] = {}
        self._last_eval = float("-inf")
        self._last_report: dict[str, dict[str, Any]] = {}

    # ---------------- recording (engine thread) ----------------

    def _class_state_locked(self, cls: str) -> _ClassState:
        st = self._classes.get(cls)
        if st is None:
            st = _ClassState(objectives_from_env(cls))
            self._classes[cls] = st
        return st

    def record_request(self, cls: str, *, ok: bool,
                       ttft_ms: float | None,
                       queue_wait_ms: float | None,
                       max_gap_ms: float | None,
                       now: float | None = None) -> None:
        """One finished request (done/stop/length or error; cancels are
        the client's choice and are not recorded)."""
        now = self._clock() if now is None else now
        with self._lock:
            st = self._class_state_locked(cls)
            o = st.objectives
            good = bool(
                ok
                and (ttft_ms is not None and ttft_ms <= o.ttft_p95_ms)
                and (queue_wait_ms is None
                     or queue_wait_ms <= o.queue_wait_p95_ms)
                and (max_gap_ms is None
                     or max_gap_ms <= o.inter_token_p99_ms))
            st.samples.append(_Sample(
                t=now, ok=ok, good=good, ttft_ms=ttft_ms,
                queue_wait_ms=queue_wait_ms, max_gap_ms=max_gap_ms))
            st.total_requests += 1
            st.total_errors += 0 if ok else 1
            st.total_good += 1 if good else 0
            self._prune_locked(st, now)

    def record_shed(self, cls: str, now: float | None = None) -> None:
        """A submission shed at admission — tracked for the snapshot,
        deliberately NOT an SLO error: shedding is the scheduler keeping
        the promise for everyone it admitted."""
        with self._lock:
            self._class_state_locked(cls).total_shed += 1

    def _prune_locked(self, st: _ClassState, now: float) -> None:
        horizon = now - self.windows_s[-1]
        samples = st.samples
        if len(samples) > self._max_samples:
            del samples[:len(samples) - self._max_samples]
        # Amortised: drop the aged head (samples arrive in time order).
        i = 0
        while i < len(samples) and samples[i].t < horizon:
            i += 1
        if i:
            del samples[:i]

    # ---------------- evaluation ----------------

    @staticmethod
    def _burn(frac_bad: float, budget: float) -> float:
        return frac_bad / budget if budget > 0 else 0.0

    def _eval_window_locked(self, st: _ClassState, now: float,
                            window_s: float) -> dict[str, Any]:
        cut = now - window_s
        sub = [s for s in st.samples if s.t >= cut]
        n = len(sub)
        o = st.objectives
        out: dict[str, Any] = {"n": n}
        if n == 0:
            out.update(goodput=None, burn={}, max_burn=0.0)
            return out
        ttfts = sorted(s.ttft_ms for s in sub if s.ttft_ms is not None)
        gaps = sorted(s.max_gap_ms for s in sub
                      if s.max_gap_ms is not None)
        waits = sorted(s.queue_wait_ms for s in sub
                       if s.queue_wait_ms is not None)
        burn: dict[str, float] = {}
        if ttfts:
            frac = sum(1 for v in ttfts if v > o.ttft_p95_ms) / len(ttfts)
            burn["ttft"] = self._burn(frac, _BUDGETS["ttft"])
            out["ttft_p95_ms"] = round(Histogram._quantile(ttfts, 95), 3)
        if gaps:
            frac = sum(1 for v in gaps
                       if v > o.inter_token_p99_ms) / len(gaps)
            burn["inter_token"] = self._burn(frac,
                                             _BUDGETS["inter_token"])
            out["inter_token_p99_ms"] = round(
                Histogram._quantile(gaps, 99), 3)
        if waits:
            frac = sum(1 for v in waits
                       if v > o.queue_wait_p95_ms) / len(waits)
            burn["queue_wait"] = self._burn(frac, _BUDGETS["queue_wait"])
            out["queue_wait_p95_ms"] = round(
                Histogram._quantile(waits, 95), 3)
        err_frac = sum(1 for s in sub if not s.ok) / n
        burn["error"] = self._burn(err_frac, o.error_rate)
        out["error_rate"] = round(err_frac, 4)
        out["goodput"] = round(sum(1 for s in sub if s.good) / n, 4)
        out["burn"] = {k: round(v, 3) for k, v in burn.items()}
        out["max_burn"] = round(max(burn.values(), default=0.0), 3)
        return out

    def _alert_from_windows_locked(
            self, windows: dict[str, dict[str, Any]]) -> tuple[str, str]:
        """(state, worst_objective): page on fast+mid burn, warn on
        mid+long burn — both windows must agree AND both must hold at
        least min_samples, so a thin window can never page alone."""
        labels = [_window_label(w) for w in self.windows_s]
        short, mid, long_ = (windows[labels[0]], windows[labels[1]],
                             windows[labels[-1]])

        def burning(w: dict[str, Any], threshold: float) -> str | None:
            if w["n"] < self.min_samples:
                return None
            over = {k: v for k, v in w.get("burn", {}).items()
                    if v >= threshold}
            if not over:
                return None
            return max(over, key=over.get)  # worst objective name

        fast = burning(short, self.page_burn)
        if fast is not None and burning(mid, self.page_burn) is not None:
            return ALERT_PAGE, fast
        slow = burning(mid, self.warn_burn)
        if slow is not None and burning(long_, self.warn_burn) is not None:
            return ALERT_WARN, slow
        return ALERT_OK, ""

    def evaluate(self, now: float | None = None,
                 force: bool = False) -> dict[str, dict[str, Any]]:
        """Recompute every class's window report and alert state,
        emitting slo_burn_start/stop events on transitions. Cached:
        callers on hot paths (scheduler gate, health) pay a dict read
        unless ``eval_interval_s`` has elapsed."""
        now = self._clock() if now is None else now
        # Transition events are collected under the lock and emitted
        # after it: emit() may mirror to a (possibly slow) EVENTS_JSONL
        # disk, and that write must never block record_request on the
        # engine's _finish hot path against this lock.
        pending: list[tuple[str, dict[str, Any]]] = []
        with self._lock:
            if not force and now - self._last_eval < self._eval_interval:
                return self._last_report
            self._last_eval = now
            report: dict[str, dict[str, Any]] = {}
            for cls, st in self._classes.items():
                self._prune_locked(st, now)
                windows = {
                    _window_label(w): self._eval_window_locked(st, now, w)
                    for w in self.windows_s}
                state, worst = self._alert_from_windows_locked(windows)
                prev = st.alert
                st.alert = state
                report[cls] = {
                    "objectives": st.objectives.to_dict(),
                    "alert": state,
                    "windows": windows,
                    "totals": {
                        "requests": st.total_requests,
                        "errors": st.total_errors,
                        "good": st.total_good,
                        "shed": st.total_shed,
                        "goodput": round(
                            st.total_good / st.total_requests, 4)
                        if st.total_requests else None,
                    },
                }
                if _ALERT_RANK[state] > _ALERT_RANK[prev]:
                    pending.append(("slo_burn_start", dict(
                        severity="critical" if state == ALERT_PAGE
                        else "warning",
                        cls=cls, state=state, objective=worst,
                        windows={k: w.get("burn", {})
                                 for k, w in windows.items()})))
                elif prev != ALERT_OK and state == ALERT_OK:
                    pending.append(("slo_burn_stop",
                                    dict(cls=cls, recovered_from=prev)))
            self._last_report = report
        for kind, kw in pending:
            self._events.emit(kind, **kw)
        return report

    # ---------------- read side ----------------

    def alert_state(self, cls: str, now: float | None = None) -> str:
        report = self.evaluate(now)
        return report.get(cls, {}).get("alert", ALERT_OK)

    def should_shed(self, priority: str,
                    now: float | None = None) -> bool:
        """Admission-control hook (scheduling/scheduler.py slo_gate):
        while the interactive class is page-burning, incoming bulk is
        shed at the door — capacity goes to the class whose promise is
        being broken. Interactive itself is never SLO-shed (the queue
        bound and deadline checks already govern it)."""
        if not self.shed_bulk_on_page or priority == "interactive":
            return False
        return self.alert_state("interactive", now) == ALERT_PAGE

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        """The ``GET /slo`` body."""
        report = self.evaluate(now, force=True)
        return {
            "windows_s": list(self.windows_s),
            "thresholds": {
                "page_burn": self.page_burn,
                "warn_burn": self.warn_burn,
                "min_samples": self.min_samples,
            },
            "shed_bulk_on_page": self.shed_bulk_on_page,
            "classes": report,
        }

    def alert_summary(self, now: float | None = None) -> dict[str, str]:
        """{class: alert_state} — the health surface's view."""
        report = self.evaluate(now)
        return {cls: body["alert"] for cls, body in report.items()}

    def clear(self) -> None:
        """Test hook: drop samples and alert state IN PLACE."""
        with self._lock:
            self._classes.clear()
            self._last_eval = float("-inf")
            self._last_report = {}


_slo: SLOEngine | None = None


def get_slo() -> SLOEngine:
    global _slo
    if _slo is None:
        _slo = SLOEngine()
    return _slo


def reset_slo() -> None:
    """Test hook: clear the process-wide SLO engine in place (modules
    cache the handle at construction, like metrics/tracer)."""
    if _slo is not None:
        _slo.clear()
