"""Fleet incident flight recorder: cross-replica evidence capture.

A copy of ``fasttalk_tpu/observability/fleetflight.py`` (the port imports nothing of the JAX
package); the two behave the same on the same inputs.

The per-process FlightRecorder (observability/flight.py) snapshots ONE
process's rings when that process pages. A fleet incident — a probe
partition, a failover burst, an SLO page on any replica — scatters its
evidence across every replica's rings, and each replica's own recorder
only sees its local fraction (a dead replica's survivor peers hold the
interesting half). This recorder runs ROUTER-side and fans bundle
collection out to every live replica into ONE incident directory:

    <FLEET_FLIGHT_DIR>/<stamp>-<n>/
      manifest.json            trigger, per-replica status, errors
      router.json              fleet_stats (placements, probes, KV)
      events.json              the router process's event tail
      slo.json                 the router process's SLO report
      fleet_metrics.prom       the label-merged fleet exposition
      replicas/<id>/health.json   per-replica probe signals
      replicas/<id>/slo.json      remote replica's /slo (HTTP)
      replicas/<id>/metrics.prom  remote replica's /metrics (HTTP)
      traces/<request_id>.json    stitched traces of in-flight requests

**Triggers** (an EventLog listener, installed by the serving layer
when the engine is a FleetRouter):

- ``router_partition`` — a replica probed dead
- a ``router_failover`` burst — ``FLEET_FLIGHT_FAILOVER_BURST``
  (default 3) failovers within ``FLEET_FLIGHT_WINDOW_S`` (default 60):
  one failover is routine, a burst is a dying fleet
- ``replica_slo_page`` — a remote replica's probe body reports a
  page-severity burn (router/router.py probe_once emits it on the
  transition)
- ``slo_burn_start`` with ``state: "page"`` — the local process's own
  SLO engine paged

Same discipline as flight.py: O(1) on the emitter's thread, writes on
a daemon thread (``inline=True`` for tests), at most one bundle per
``FLEET_FLIGHT_MIN_INTERVAL_S``, newest ``FLEET_FLIGHT_MAX_BUNDLES``
kept, every section individually fault-isolated — one unreachable
replica costs its directory, not the incident.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

from fasttalk_tpu_torch.observability.events import (Event, EventLog,
                                                     env_float, get_events)
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("observability.fleetflight")

DEFAULT_DIR = "/tmp/fasttalk-tpu-torch-fleet-flight"
DEFAULT_MAX_BUNDLES = 4
DEFAULT_MIN_INTERVAL_S = 120.0
DEFAULT_FAILOVER_BURST = 3
DEFAULT_WINDOW_S = 60.0
DEFAULT_EVENTS_TAIL = 256
# Stitched traces per bundle: enough for every in-flight request of a
# sanely sized fleet, bounded against a pathological one.
MAX_TRACES = 16


class FleetFlightRecorder:
    """Router-side incident bundle collector; constructed by the
    serving launcher when the engine is a FleetRouter, standalone-
    constructible in tests (injectable clock, inline writes)."""

    def __init__(self, router: Any, *, enabled: bool | None = None,
                 base_dir: str | None = None,
                 max_bundles: int | None = None,
                 min_interval_s: float | None = None,
                 failover_burst: int | None = None,
                 window_s: float | None = None,
                 events_tail: int | None = None,
                 clock=time.time, inline: bool = False):
        if enabled is None:
            enabled = os.getenv("FLEET_FLIGHT_ENABLED",
                                "true").strip().lower() \
                in ("1", "true", "yes", "on")
        self.enabled = enabled
        self.router = router
        self.base_dir = base_dir if base_dir is not None \
            else (os.getenv("FLEET_FLIGHT_DIR", "").strip()
                  or DEFAULT_DIR)
        self.max_bundles = max_bundles if max_bundles is not None \
            else max(1, int(env_float("FLEET_FLIGHT_MAX_BUNDLES",
                                      DEFAULT_MAX_BUNDLES)))
        self.min_interval_s = min_interval_s \
            if min_interval_s is not None \
            else max(0.0, env_float("FLEET_FLIGHT_MIN_INTERVAL_S",
                                    DEFAULT_MIN_INTERVAL_S))
        self.failover_burst = failover_burst \
            if failover_burst is not None \
            else max(2, int(env_float("FLEET_FLIGHT_FAILOVER_BURST",
                                      DEFAULT_FAILOVER_BURST)))
        self.window_s = window_s if window_s is not None \
            else max(1.0, env_float("FLEET_FLIGHT_WINDOW_S",
                                    DEFAULT_WINDOW_S))
        self.events_tail = events_tail if events_tail is not None \
            else max(1, int(env_float("FLIGHT_EVENTS_TAIL",
                                      DEFAULT_EVENTS_TAIL)))
        self._clock = clock
        self._inline = inline
        self._lock = threading.Lock()
        self._last_bundle_ts: float | None = None
        self._writing = False
        self._failover_ts: list[float] = []
        self._installed_on: EventLog | None = None
        self.bundles_written = 0
        self.triggers_suppressed = 0

    # ---------------- wiring ----------------

    def install(self, events: EventLog | None = None) -> None:
        events = events if events is not None else get_events()
        events.add_listener(self.on_event)
        self._installed_on = events

    def uninstall(self) -> None:
        if self._installed_on is not None:
            self._installed_on.remove_listener(self.on_event)
            self._installed_on = None

    # ---------------- triggers ----------------

    def on_event(self, ev: Event) -> None:
        """EventLog listener — O(1) checks on the emitter's thread."""
        if not self.enabled:
            return
        kind = ev.kind
        if kind in ("router_partition", "replica_slo_page"):
            self.trigger(f"{kind}:{ev.attrs.get('replica', '?')}",
                         kind=kind)
        elif kind == "slo_burn_start":
            if ev.attrs.get("state") == "page":
                self.trigger(f"slo_page:{ev.attrs.get('cls', '?')}",
                             kind=kind)
        elif kind == "router_failover":
            now = self._clock()
            with self._lock:
                self._failover_ts.append(now)
                horizon = now - self.window_s
                self._failover_ts = [t for t in self._failover_ts
                                     if t >= horizon]
                burst = len(self._failover_ts) >= self.failover_burst
                if burst:
                    self._failover_ts.clear()
            if burst:
                self.trigger("failover_burst", kind=kind)

    def trigger(self, reason: str, kind: str = "manual",
                force: bool = False,
                now: float | None = None) -> str | None:
        """Request a fleet bundle; same contract as
        FlightRecorder.trigger (rate-limited, one writer, ``force``
        bypasses the window without consuming it)."""
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
            log.error(f"fleet flight bundle dir failed: {e}")
            with self._lock:
                self._writing = False
            return None
        if not force:
            with self._lock:
                self._last_bundle_ts = now
        if self._inline:
            self._write_bundle(bundle_dir, reason, kind, now)
        else:
            threading.Thread(
                target=self._write_bundle, name="fleet-flight",
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
                path = os.path.join(bundle_dir, name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w", encoding="utf-8") as fp:
                    if isinstance(payload, str):
                        fp.write(payload)
                    else:
                        json.dump(payload, fp, ensure_ascii=False,
                                  default=str, indent=1)
            except Exception as e:  # one broken source costs one file
                errors[name] = str(e)

        def events_tail():
            src = self._installed_on if self._installed_on is not None \
                else get_events()
            return src.recent(limit=self.events_tail)

        def slo_report():
            from fasttalk_tpu_torch.observability.slo import get_slo

            return get_slo().snapshot()

        def profile_collapsed():
            from fasttalk_tpu_torch.observability.profiler import get_profiler

            return get_profiler().collapsed()

        def profile_report():
            from fasttalk_tpu_torch.observability.profiler import get_profiler

            return get_profiler().report()

        router = self.router
        section("router.json", router.fleet_stats)
        section("events.json", events_tail)
        section("slo.json", slo_report)
        section("fleet_metrics.prom", router.fleet_metrics)
        # The router process's own continuous-profiler aggregate: a
        # fleet incident's routing-side half (probe loops, failover
        # bursts) happens on THIS process's threads.
        section("profile.txt", profile_collapsed)
        section("profile.json", profile_report)

        replica_status: dict[str, dict[str, Any]] = {}
        for h in list(getattr(router, "replicas", ())):
            rid = h.replica_id
            replica_status[rid] = {"state": h.state,
                                   "alive": h.alive(),
                                   "remote": hasattr(h, "base_url")}
            section(f"replicas/{rid}/health.json", h.to_dict)
            if not h.alive():
                replica_status[rid]["collected"] = False
                continue
            if hasattr(h, "base_url"):
                # Remote: its rings live in its process — fetch them.
                section(f"replicas/{rid}/metrics.prom",
                        lambda h=h: h.fetch_metrics() or "")
                section(f"replicas/{rid}/slo.json",
                        lambda h=h: h.fetch_slo() or {})
            replica_status[rid]["collected"] = \
                f"replicas/{rid}/health.json" not in errors

        # Stitched traces of in-flight requests: the requests the
        # incident interrupted, reassembled across every replica that
        # held a fragment.
        trace_ids: list[str] = []
        try:
            from fasttalk_tpu_torch.observability.trace import get_tracer

            inflight = [t["request_id"] for t
                        in get_tracer().inflight_summary()]
            for rid in inflight[:MAX_TRACES]:
                safe = rid.replace("/", "_").replace(":", "_")
                section(f"traces/{safe}.json",
                        lambda rid=rid: router.stitched_trace(rid)
                        or {})
                trace_ids.append(rid)
        except Exception as e:
            errors["traces"] = str(e)

        manifest = {
            "reason": reason,
            "trigger_kind": kind,
            "ts": time.time(),
            "trigger_clock": now,
            "write_s": round(time.monotonic() - t0, 3),
            "replicas": replica_status,
            "stitched_traces": trace_ids,
            **({"errors": errors} if errors else {}),
        }
        try:
            with open(os.path.join(bundle_dir, "manifest.json"), "w",
                      encoding="utf-8") as fp:
                json.dump(manifest, fp, indent=1, default=str)
        except OSError as e:
            log.error(f"fleet flight manifest failed: {e}")
        self.bundles_written += 1
        self._prune()
        log.warning(
            f"fleet flight bundle written: {bundle_dir} (reason "
            f"{reason}{', errors ' + str(sorted(errors)) if errors else ''})")
        with self._lock:
            self._writing = False

    def _prune(self) -> None:
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
            "failover_burst": self.failover_burst,
            "window_s": self.window_s,
        }
