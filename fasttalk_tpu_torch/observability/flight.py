"""Incident flight recorder: automatic evidence capture when paging.

The port's rewrite of ``fasttalk_tpu/observability/flight.py``: the
triggers, the bundle sections, pruning and ``inline`` mode are copied;
the timed device capture is a ``torch.profiler`` Chrome trace
(``cuda_trace/``) in place of the ``jax.profiler`` one, and the default
directory is the port's own, so the two packages never share bundles.

When the SLO engine pages or the watchdog catches a stall, the
evidence an operator needs — the event tail, the trace ring, the
metrics and the attribution report AS THEY WERE at the incident — is
all in bounded in-process rings that traffic will overwrite within
minutes. Today the operator has to reproduce the incident by hand
before ``POST /profiler/start`` is any use. This module snapshots
everything the moment trouble is detected:

**Triggers** (an EventLog listener, installed by the serving layer):

- ``slo_burn_start`` with ``state: "page"`` — a broken latency promise
- ``stall_detected`` / ``watchdog_cancel`` — a hung engine step or a
  token-stalled request
- a ``recompile`` burst — ``FLIGHT_RECOMPILE_BURST`` (default 5)
  serving-time compiles within ``FLIGHT_RECOMPILE_WINDOW_S`` (default
  60) — one compile is an event, a burst is a shape-churn incident
- ``POST /debug/bundle`` on the monitoring port (manual, any time)

**Bundle** — one timestamped directory under ``FLIGHT_DIR`` (default
``/tmp/fasttalk-tpu-torch-flight``):

- ``manifest.json`` — trigger, timestamps, section errors if any
- ``events.json`` — newest-first event-ring tail
- ``slo.json`` — the full per-class SLO report
- ``perf.json`` — the attribution ledger report (observability/perf.py)
- ``metrics.prom`` / ``metrics.json`` — the metrics registry
- ``trace.json`` (Perfetto-loadable Chrome trace of the completed ring
  + engine-step row) and ``trace.jsonl``
- ``config.json`` — resolved service config with secret-shaped values
  redacted
- optionally ``cuda_trace/trace.json`` — a timed ``torch.profiler``
  capture (CPU, and CUDA kernels on the card) of the NEXT
  ``FLIGHT_AUTOPROF_S`` seconds as a Chrome trace (default 0 = off;
  the error lands in the manifest when a manual profiler trace is
  already active)

**Bounded and off-loop.** Writes run on a daemon thread (the trigger
may fire on the engine thread or the asyncio loop — neither may block
on disk); at most one bundle per ``FLIGHT_MIN_INTERVAL_S`` (default
120; a page storm produces ONE bundle, not a disk-filling flood);
only the newest ``FLIGHT_MAX_BUNDLES`` (default 8) directories are
kept. Every section write is individually fault-isolated — a broken
exporter costs that file, not the bundle.

Fake-clock testable: the clock is injectable and ``inline=True`` makes
trigger() write synchronously, so tests drive a synthetic page event
and assert on the bundle with zero sleeps.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

from fasttalk_tpu_torch.observability.events import (Event, EventLog, env_float,
                                                     get_events)
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("observability.flight")

DEFAULT_DIR = "/tmp/fasttalk-tpu-torch-flight"
DEFAULT_MAX_BUNDLES = 8
DEFAULT_MIN_INTERVAL_S = 120.0
DEFAULT_RECOMPILE_BURST = 5
DEFAULT_RECOMPILE_WINDOW_S = 60.0
DEFAULT_EVENTS_TAIL = 256

# Config keys whose values never belong in a bundle shipped to a bug
# tracker (matched as substrings of the field name).
_SECRET_MARKERS = ("key", "token", "secret", "password")


def redact_config(cfg: dict[str, Any]) -> dict[str, Any]:
    """Secret-shaped values → "***". The exemption is by FIELD NAME
    (`*_path` / `*_dir`, e.g. tokenizer_path carries "token" but is a
    path), never by value shape — a slash inside a credential (base64,
    JWT segments) must not smuggle it into a shareable bundle."""
    out: dict[str, Any] = {}
    for k, v in cfg.items():
        lk = k.lower()
        if any(m in lk for m in _SECRET_MARKERS) \
                and not lk.endswith(("_path", "_dir")) \
                and isinstance(v, str) and v:
            out[k] = "***"
        else:
            out[k] = v
    return out


class FlightRecorder:
    """Event-triggered debug-bundle writer; process-wide singleton in
    serving (get_flight), standalone-constructible in tests."""

    def __init__(self, *, enabled: bool | None = None,
                 base_dir: str | None = None,
                 max_bundles: int | None = None,
                 min_interval_s: float | None = None,
                 autoprof_s: float | None = None,
                 recompile_burst: int | None = None,
                 recompile_window_s: float | None = None,
                 events_tail: int | None = None,
                 clock=time.time,
                 inline: bool = False,
                 config_provider=None):
        if enabled is None:
            enabled = os.getenv("FLIGHT_ENABLED", "true").strip().lower() \
                in ("1", "true", "yes", "on")
        self.enabled = enabled
        self.base_dir = base_dir if base_dir is not None \
            else (os.getenv("FLIGHT_DIR", "").strip() or DEFAULT_DIR)
        self.max_bundles = max_bundles if max_bundles is not None \
            else max(1, int(env_float("FLIGHT_MAX_BUNDLES",
                                      DEFAULT_MAX_BUNDLES)))
        self.min_interval_s = min_interval_s \
            if min_interval_s is not None \
            else max(0.0, env_float("FLIGHT_MIN_INTERVAL_S",
                                    DEFAULT_MIN_INTERVAL_S))
        self.autoprof_s = autoprof_s if autoprof_s is not None \
            else max(0.0, env_float("FLIGHT_AUTOPROF_S", 0.0))
        self.recompile_burst = recompile_burst \
            if recompile_burst is not None \
            else max(2, int(env_float("FLIGHT_RECOMPILE_BURST",
                                      DEFAULT_RECOMPILE_BURST)))
        self.recompile_window_s = recompile_window_s \
            if recompile_window_s is not None \
            else max(1.0, env_float("FLIGHT_RECOMPILE_WINDOW_S",
                                    DEFAULT_RECOMPILE_WINDOW_S))
        self.events_tail = events_tail if events_tail is not None \
            else max(1, int(env_float("FLIGHT_EVENTS_TAIL",
                                      DEFAULT_EVENTS_TAIL)))
        self._clock = clock
        self._inline = inline
        self._config_provider = config_provider
        self._lock = threading.Lock()
        self._last_bundle_ts: float | None = None
        self._writing = False
        self._recompile_ts: list[float] = []
        self._installed_on: EventLog | None = None
        self.bundles_written = 0
        self.triggers_suppressed = 0

    # ---------------- wiring ----------------

    def install(self, events: EventLog | None = None) -> None:
        """Subscribe to the event log (idempotent)."""
        events = events if events is not None else get_events()
        events.add_listener(self.on_event)
        self._installed_on = events

    def uninstall(self) -> None:
        if self._installed_on is not None:
            self._installed_on.remove_listener(self.on_event)
            self._installed_on = None

    # ---------------- triggers ----------------

    def on_event(self, ev: Event) -> None:
        """EventLog listener: map incident-class events to bundles.
        Runs on the emitter's thread — every path here is O(1) checks
        plus, at most, spawning the writer thread."""
        if not self.enabled:
            return
        kind = ev.kind
        if kind == "slo_burn_start":
            if ev.attrs.get("state") == "page":
                self.trigger(f"slo_page:{ev.attrs.get('cls', '?')}",
                             kind=kind)
        elif kind in ("stall_detected", "watchdog_cancel",
                      "engine_restart", "router_failover",
                      "router_partition"):
            # router_failover: a replica died with a stream on it — the
            # evidence (events, traces, per-replica stats) is exactly
            # what the post-mortem needs and is gone minutes later.
            # router_partition: the probe-death flavour — the replica
            # may be healthy but unreachable; the bundle captures the
            # router's view before recovery overwrites it.
            self.trigger(kind, kind=kind)
        elif kind == "recompile":
            now = self._clock()
            with self._lock:
                self._recompile_ts.append(now)
                horizon = now - self.recompile_window_s
                self._recompile_ts = [t for t in self._recompile_ts
                                      if t >= horizon]
                burst = len(self._recompile_ts) >= self.recompile_burst
                if burst:
                    self._recompile_ts.clear()
            if burst:
                self.trigger("recompile_burst", kind=kind)

    def trigger(self, reason: str, kind: str = "manual",
                force: bool = False, now: float | None = None,
                ) -> str | None:
        """Request a bundle. Returns the bundle directory (claimed
        synchronously; contents written off-thread unless inline) or
        None when disabled, rate-limited, or already writing. ``force``
        (the manual endpoint) bypasses the rate limit WITHOUT consuming
        it — an operator's curl must never eat the window a real
        incident needs minutes later — but never bypasses the
        in-progress guard."""
        if not self.enabled:
            return None
        now = self._clock() if now is None else now
        with self._lock:
            if self._writing:
                self.triggers_suppressed += 1
                return None
            if not force and self._last_bundle_ts is not None \
                    and now - self._last_bundle_ts < self.min_interval_s:
                self.triggers_suppressed += 1
                return None
            self._writing = True
        try:
            stamp = time.strftime("%Y%m%d-%H%M%S",
                                  time.localtime(time.time()))
            bundle_dir = os.path.join(
                self.base_dir, f"{stamp}-{self.bundles_written:03d}")
            os.makedirs(bundle_dir, exist_ok=True)
        except OSError as e:
            # Nothing was written: do NOT consume the rate limit — a
            # transiently unwritable disk must not also suppress the
            # next real incident's capture.
            log.error(f"flight bundle dir failed: {e}")
            with self._lock:
                self._writing = False
            return None
        if not force:
            # Consume the window only once a bundle dir actually
            # exists, and only for automatic triggers.
            with self._lock:
                self._last_bundle_ts = now
        if self._inline:
            self._write_bundle(bundle_dir, reason, kind, now)
        else:
            threading.Thread(
                target=self._write_bundle, name="flight-recorder",
                args=(bundle_dir, reason, kind, now), daemon=True,
            ).start()
        return bundle_dir

    # ---------------- the bundle ----------------

    def _write_bundle(self, bundle_dir: str, reason: str, kind: str,
                      now: float) -> None:
        t0 = time.monotonic()
        errors: dict[str, str] = {}

        def section(name: str, build) -> None:
            try:
                payload = build()
                with open(os.path.join(bundle_dir, name), "w",
                          encoding="utf-8") as fp:
                    if isinstance(payload, str):
                        fp.write(payload)
                    else:
                        json.dump(payload, fp, ensure_ascii=False,
                                  default=str, indent=1)
            except Exception as e:  # one broken exporter costs one file
                errors[name] = str(e)

        def events_tail():
            # Snapshot the log the recorder is subscribed to (the one
            # that carries the triggering event); the process singleton
            # when triggered manually without an install.
            src = self._installed_on if self._installed_on is not None \
                else get_events()
            return src.recent(limit=self.events_tail)

        def slo_report():
            from fasttalk_tpu_torch.observability.slo import get_slo

            return get_slo().snapshot()

        def perf_report():
            from fasttalk_tpu_torch.observability.perf import get_perf

            return get_perf().report()

        def metrics_prom():
            from fasttalk_tpu_torch.utils.metrics import get_metrics

            return get_metrics().prometheus()

        def metrics_json():
            from fasttalk_tpu_torch.utils.metrics import get_metrics

            return get_metrics().to_dict()

        def trace_chrome():
            from fasttalk_tpu_torch.observability.export import chrome_trace
            from fasttalk_tpu_torch.observability.trace import get_tracer

            tr = get_tracer()
            return chrome_trace(tr, tr.completed(), tr.steps())

        def trace_jsonl():
            from fasttalk_tpu_torch.observability.export import jsonl_dump
            from fasttalk_tpu_torch.observability.trace import get_tracer

            tr = get_tracer()
            return jsonl_dump(tr, tr.completed(), tr.steps())

        def config_redacted():
            if self._config_provider is not None:
                raw = self._config_provider()
            else:
                from fasttalk_tpu_torch.utils.config import Config

                raw = Config().to_dict()
            return redact_config(dict(raw))

        def profile_collapsed():
            from fasttalk_tpu_torch.observability.profiler import get_profiler

            return get_profiler().collapsed()

        def profile_report():
            from fasttalk_tpu_torch.observability.profiler import get_profiler

            return get_profiler().report()

        try:
            section("events.json", events_tail)
            section("slo.json", slo_report)
            section("perf.json", perf_report)
            section("metrics.prom", metrics_prom)
            section("metrics.json", metrics_json)
            section("trace.json", trace_chrome)
            section("trace.jsonl", trace_jsonl)
            section("config.json", config_redacted)
            # What every thread was DOING when the incident fired —
            # the continuous sampler's aggregate (collapsed text for
            # flamegraph tooling + the structured report). Disabled
            # profiler still writes honest (empty) sections.
            section("profile.txt", profile_collapsed)
            section("profile.json", profile_report)
            autoprof = None
            if self.autoprof_s > 0:
                autoprof = self._autoprof(bundle_dir, errors)
            manifest = {
                "reason": reason,
                "trigger_kind": kind,
                "ts": time.time(),
                "trigger_clock": now,
                "write_s": round(time.monotonic() - t0, 3),
                "autoprof": autoprof,
                **({"errors": errors} if errors else {}),
            }
            try:
                with open(os.path.join(bundle_dir, "manifest.json"),
                          "w", encoding="utf-8") as fp:
                    json.dump(manifest, fp, indent=1, default=str)
            except OSError as e:
                log.error(f"flight manifest failed: {e}")
            self.bundles_written += 1
            self._prune()
            log.warning(
                f"flight bundle written: {bundle_dir} (reason "
                f"{reason}{', errors ' + str(sorted(errors)) if errors else ''})")
        finally:
            with self._lock:
                self._writing = False

    def _autoprof(self, bundle_dir: str,
                  errors: dict[str, str]) -> dict[str, Any] | None:
        """Timed ``torch.profiler`` capture into the bundle's
        ``cuda_trace/`` as a Chrome trace (worker thread — the sleep
        never touches the event loop). A profiler already running (a
        manual ``/profiler/start``) makes the start raise: the error
        is recorded and the section skipped."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        trace_dir = os.path.join(bundle_dir, "cuda_trace")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            prof.start()
        except Exception as e:
            errors["cuda_trace"] = str(e)
            return None
        try:
            time.sleep(self.autoprof_s)
        finally:
            try:
                prof.stop()
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(trace_dir, "trace.json"))
            except Exception as e:
                errors["cuda_trace"] = str(e)
                return None
        return {"dir": trace_dir, "duration_s": self.autoprof_s}

    def _prune(self) -> None:
        """Keep only the newest max_bundles directories."""
        try:
            entries = sorted(
                d for d in os.listdir(self.base_dir)
                if os.path.isdir(os.path.join(self.base_dir, d)))
        except OSError:
            return
        for stale in entries[:max(0, len(entries) - self.max_bundles)]:
            shutil.rmtree(os.path.join(self.base_dir, stale),
                          ignore_errors=True)

    # ---------------- read side ----------------

    def list_bundles(self) -> list[str]:
        try:
            return sorted(
                os.path.join(self.base_dir, d)
                for d in os.listdir(self.base_dir)
                if os.path.isdir(os.path.join(self.base_dir, d)))
        except OSError:
            return []

    def stats(self) -> dict[str, Any]:
        with self._lock:
            last = self._last_bundle_ts
        return {
            "enabled": self.enabled,
            "dir": self.base_dir,
            "bundles_written": self.bundles_written,
            "triggers_suppressed": self.triggers_suppressed,
            "last_bundle_ts": last,
            "min_interval_s": self.min_interval_s,
            "max_bundles": self.max_bundles,
            "autoprof_s": self.autoprof_s,
        }

    def clear(self) -> None:
        """Test hook: detach and drop trigger state IN PLACE (written
        bundles are left on disk — they are the product, not state)."""
        self.uninstall()
        with self._lock:
            self._last_bundle_ts = None
            self._writing = False
            self._recompile_ts.clear()
        self.bundles_written = 0
        self.triggers_suppressed = 0


_flight: FlightRecorder | None = None


def get_flight() -> FlightRecorder:
    global _flight
    if _flight is None:
        _flight = FlightRecorder()
    return _flight


def reset_flight() -> None:
    """Test hook: detach the process-wide recorder and drop it, so the
    next get_flight() reads FLIGHT_* (the directory among them) again."""
    global _flight
    if _flight is not None:
        _flight.clear()
    _flight = None
