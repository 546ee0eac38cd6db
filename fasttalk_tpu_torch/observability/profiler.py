"""Continuous host profiler: always-on stack sampling by thread role.

A copy of ``fasttalk_tpu/observability/profiler.py`` (the port imports
nothing of the JAX package) with the thread roles of the port: the
engine loop (``torch-engine``, engine/engine.py ``start``), the KV copy
thread (``kv-offload``, kvcache/offload.py) and the asyncio event loop
(``MainThread`` under the serving entry point).

The perf ledger (observability/perf.py) decomposes engine wall time
into device-busy intervals and host gaps, but a gap is just an absence
— nothing in the step records says WHAT the host was doing while the
device starved. This module closes that hole from the outside: a
daemon thread samples ``sys._current_frames()`` at ``PROF_HZ`` (default
~67 Hz — deliberately co-prime with common 10/20/50 ms periodic work so
the sampler doesn't alias against it), aggregates collapsed stacks per
thread ROLE, and keeps a bounded timeline of what the engine thread
was doing at each sample so the ledger can classify its host gaps by
cause (detok / ws_send / scheduler / radix / gc / other).

Overhead contract (same discipline as resilience/failpoints.py): the
profiler is strictly PULL-based — no hot path ever calls into it, the
engine/serving threads carry zero added instructions, and with
``PROF_ENABLED=false`` no thread exists at all. The only cost when on
is the sampler thread's own work (~15 ms-spaced GIL grabs of a few
hundred microseconds); ``chip_smoke.py`` phase 12 logs the on/off
host time of a decode step and decode tok/s.

GC pauses are invisible to stack sampling (the collector runs inside
whatever frame triggered allocation), so those are captured exactly
instead: a ``gc.callbacks`` hook records each collection's
[start, stop] interval, and the ledger subtracts the overlap from its
host gaps before distributing the rest across sampled causes.

Read side:

- ``GET /debug/profile`` — flamegraph-collapsed text (one
  ``role;frame;frame... count`` line per aggregated stack, feed it
  straight to ``flamegraph.pl`` / speedscope), ``?format=json`` for
  the structured report.
- flight bundles fold ``profile.txt`` +
  ``profile.json`` sections in, so every incident ships with "what was
  every thread doing".
- ``causes_between(t0, t1)`` / ``gc_overlap_s(t0, t1)`` — the perf
  ledger's host-gap classification inputs (time.monotonic clock, same
  as the tracer's step records).
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from collections import deque
from typing import Any

from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("observability.profiler")

DEFAULT_HZ = 67.0
DEFAULT_MAX_STACKS = 2000
_MAX_DEPTH = 48           # frames kept per stack (root-first)
_TIMELINE_CAP = 8192      # engine-thread cause observations kept
_GC_CAP = 512             # completed GC pause intervals kept

# Thread-name prefix -> role. Names are set at thread creation
# (engine loop: engine.py start(); KV copy: kvcache/offload.py);
# MainThread runs the asyncio event loop under the serving entrypoint.
_ROLES: tuple[tuple[str, str], ...] = (
    ("torch-engine", "engine_loop"),
    ("kv-offload", "kv_copy"),
    ("MainThread", "event_loop"),
)

# Host-gap cause taxonomy (ROADMAP item 4's input): substrings matched
# against "filename:function" of every frame in an engine-thread
# sample, most-specific first. A sample names ONE cause — the deepest
# match wins because the leaf frames say what the loop iteration was
# actually doing while the outer frames are always the engine loop.
_CAUSES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("detok", ("detok", "tokenizer", "_consume_token", "_flush_emit",
               "decode_text")),
    ("ws_send", ("websocket", "ws_server", "_emit", "send_json",
                 "send_str", "connection_manager")),
    ("radix", ("radix", "blocks.py", "_kv_blocks", "_paged",
               "allocator", "alias")),
    ("scheduler", ("_admit", "_schedule", "scheduler", "_sched",
                   "submit", "queue_wait", "_try_restore",
                   "_park_slot")),
)
CAUSE_NAMES = ("detok", "ws_send", "scheduler", "radix", "gc", "other")


def _env_bool(name: str, default: bool) -> bool:
    raw = os.getenv(name, "").strip().lower()
    if not raw:
        return default
    return raw in ("1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    raw = os.getenv(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class ContinuousProfiler:
    """The process's stack sampler; standalone-constructible in tests
    (injectable clock for the read side, ``sample_once()`` to drive
    sampling deterministically without the thread)."""

    def __init__(self, *, enabled: bool | None = None,
                 hz: float | None = None,
                 max_stacks: int | None = None,
                 clock=time.monotonic):
        self.enabled = _env_bool("PROF_ENABLED", True) \
            if enabled is None else enabled
        self.hz = _env_float("PROF_HZ", DEFAULT_HZ) if hz is None else hz
        self.hz = min(1000.0, max(0.1, self.hz))
        self.max_stacks = int(_env_float("PROF_MAX_STACKS",
                                         DEFAULT_MAX_STACKS)) \
            if max_stacks is None else max_stacks
        self._clock = clock
        self._lock = threading.Lock()
        # role -> {collapsed_stack: count}; bounded at max_stacks
        # DISTINCT stacks across all roles (each is ~a few hundred
        # bytes; the counter grows unbounded, the key set must not).
        self._stacks: dict[str, dict[str, int]] = {}
        self._role_samples: dict[str, int] = {}
        self._timeline: deque[tuple[float, str]] = deque(
            maxlen=_TIMELINE_CAP)
        self._gc_done: deque[tuple[float, float]] = deque(maxlen=_GC_CAP)
        self._gc_t0: float | None = None
        self._gc_pauses = 0
        self._gc_pause_s = 0.0
        self.samples = 0
        self.errors = 0
        self.dropped_stacks = 0
        self.started_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._gc_installed = False

    # ---------------- lifecycle ----------------

    def start(self) -> None:
        """Spawn the sampler thread (idempotent; a disabled profiler
        spawns nothing — the off state owns no resources at all)."""
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self.started_at = self._clock()
        if not self._gc_installed:
            gc.callbacks.append(self._on_gc)
            self._gc_installed = True
        self._thread = threading.Thread(target=self._run,
                                        name="prof-sampler", daemon=True)
        self._thread.start()
        log.info(f"continuous profiler sampling at {self.hz:g} Hz "
                 f"(max {self.max_stacks} stacks)")

    def stop(self) -> None:
        t = self._thread
        self._stop.set()
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        if self._gc_installed:
            try:
                gc.callbacks.remove(self._on_gc)
            except ValueError:
                pass
            self._gc_installed = False

    # ---------------- sampling ----------------

    def _run(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(period):
            try:
                self.sample_once(exclude=me)
            except Exception as e:
                # A torn frame mid-walk (threads die under us — that's
                # the point of sampling live threads) costs one tick,
                # never the sampler.
                self.errors += 1
                if self.errors <= 3:
                    log.debug(f"profile sample failed: {e}")

    def sample_once(self, exclude: int | None = None) -> None:
        """One sampling tick: snapshot every thread's stack, aggregate
        per role, and note the engine thread's cause observation."""
        now = self._clock()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        with self._lock:
            self.samples += 1
            for tid, frame in frames.items():
                if tid == exclude:
                    continue
                role = self._role(names.get(tid, f"tid-{tid}"))
                parts: list[str] = []
                cause: str | None = None
                f = frame
                depth = 0
                while f is not None and depth < _MAX_DEPTH:
                    code = f.f_code
                    parts.append(code.co_name)
                    if role == "engine_loop" and cause is None:
                        # leaf-first walk: the first (deepest) match
                        # names the cause
                        cause = self._classify(code.co_filename,
                                               code.co_name)
                    f = f.f_back
                    depth += 1
                parts.reverse()  # root-first, the collapsed convention
                stack = ";".join(parts)
                per_role = self._stacks.setdefault(role, {})
                self._role_samples[role] = \
                    self._role_samples.get(role, 0) + 1
                if stack in per_role:
                    per_role[stack] += 1
                elif sum(len(d) for d in self._stacks.values()) \
                        < self.max_stacks:
                    per_role[stack] = 1
                else:
                    self.dropped_stacks += 1
                if role == "engine_loop":
                    self._timeline.append((now, cause or "other"))

    @staticmethod
    def _role(name: str) -> str:
        for prefix, role in _ROLES:
            if name.startswith(prefix):
                return role
        return name

    @staticmethod
    def _classify(filename: str, func: str) -> str | None:
        probe = f"{filename.rsplit('/', 1)[-1]}:{func}"
        for cause, needles in _CAUSES:
            for n in needles:
                if n in probe:
                    return cause
        return None

    # ---------------- GC pause capture ----------------

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = self._clock()
        elif phase == "stop" and self._gc_t0 is not None:
            t0, self._gc_t0 = self._gc_t0, None
            t1 = self._clock()
            self._gc_pauses += 1
            self._gc_pause_s += t1 - t0
            self._gc_done.append((t0, t1))

    # ---------------- ledger read side ----------------

    def causes_between(self, t0: float, t1: float) -> dict[str, int]:
        """Engine-thread cause observation counts within [t0, t1]
        (monotonic clock — the tracer's). Empty dict = the sampler saw
        nothing there (off, or the gap was shorter than a tick)."""
        out: dict[str, int] = {}
        with self._lock:
            snap = list(self._timeline)
        for t, cause in snap:
            if t0 <= t <= t1:
                out[cause] = out.get(cause, 0) + 1
        return out

    def gc_overlap_s(self, t0: float, t1: float) -> float:
        """Seconds of captured GC pause overlapping [t0, t1]."""
        with self._lock:
            snap = list(self._gc_done)
        total = 0.0
        for g0, g1 in snap:
            lo, hi = max(t0, g0), min(t1, g1)
            if hi > lo:
                total += hi - lo
        return total

    # ---------------- report side ----------------

    def collapsed(self) -> str:
        """Flamegraph-collapsed text: ``role;frame;... count`` lines,
        hottest first."""
        with self._lock:
            rows = [(f"{role};{stack}", n)
                    for role, stacks in self._stacks.items()
                    for stack, n in stacks.items()]
        rows.sort(key=lambda r: (-r[1], r[0]))
        return "\n".join(f"{stack} {n}" for stack, n in rows) + "\n"

    def report(self, top: int = 20) -> dict[str, Any]:
        with self._lock:
            threads = {}
            for role, stacks in self._stacks.items():
                hot = sorted(stacks.items(), key=lambda kv: -kv[1])[:top]
                threads[role] = {
                    "samples": self._role_samples.get(role, 0),
                    "distinct_stacks": len(stacks),
                    "top": [{"stack": s, "count": n} for s, n in hot],
                }
            timeline_counts: dict[str, int] = {}
            for _, cause in self._timeline:
                timeline_counts[cause] = timeline_counts.get(cause, 0) + 1
        return {
            "enabled": self.enabled,
            "running": self._thread is not None,
            "hz": self.hz,
            "samples": self.samples,
            "errors": self.errors,
            "dropped_stacks": self.dropped_stacks,
            "max_stacks": self.max_stacks,
            "started_at": self.started_at,
            "threads": threads,
            "engine_causes": timeline_counts,
            "gc": {"pauses": self._gc_pauses,
                   "pause_s": round(self._gc_pause_s, 6)},
        }

    def clear(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._role_samples.clear()
            self._timeline.clear()
            self._gc_done.clear()
            self.samples = 0
            self.errors = 0
            self.dropped_stacks = 0
            self._gc_pauses = 0
            self._gc_pause_s = 0.0


_profiler: ContinuousProfiler | None = None


def get_profiler() -> ContinuousProfiler:
    global _profiler
    if _profiler is None:
        _profiler = ContinuousProfiler()
    return _profiler


def reset_profiler() -> None:
    """Test hook: stop the sampler and drop the singleton so the next
    get_profiler() re-reads the environment."""
    global _profiler
    if _profiler is not None:
        _profiler.stop()
    _profiler = None
