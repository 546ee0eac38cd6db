"""Replica handles: one engine replica as the router sees it.

A copy of ``fasttalk_tpu/router/replica.py`` (the port imports nothing of the JAX
package); the two behave the same on the same inputs.

A handle wraps one backend — an in-process ``EngineBase`` (the common
CPU-fleet/bench shape, and the dp-style multi-engine shape on real
hardware) or a remote FastTalk server reached over HTTP (the same
``remote.py`` client protocol the legacy providers speak) — and keeps
the router-side view of it: health state, the latest probe's load
signals, and the set of requests currently routed here.

Health is a small state machine:

    healthy ⇄ degraded      (probe signals: overload state, SLO burn)
    any     → dead          (``dead_probes`` consecutive probe failures,
                             or a stream failing while check_connection()
                             is already False — fast-path detection so a
                             mid-stream death never waits a probe period)
    dead    → healthy       (a later probe finds the engine back — e.g.
                             the launcher's supervised engine restart)

``draining`` is orthogonal to health: a draining replica finishes what
it has but takes no new placements (docs/ROUTER.md).

Probes are synchronous by design — the router runs them on its own
daemon thread (in-proc probes are a few dict reads; remote probes are
one short HTTP GET), never on the serving event loop. ``clock`` is
injectable for deterministic tests, like the scheduler's.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from fasttalk_tpu_torch.engine.engine import EngineBase
from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("router.replica")

STATE_HEALTHY = "healthy"
STATE_DEGRADED = "degraded"
STATE_DEAD = "dead"

# Load-score weights: a replica's score is the expected queueing cost of
# placing one more request on it. Queue depth dominates (each queued
# request is one service time of wait); overload states add the
# scheduler's own judgement; an SLO page means the replica is already
# breaking promises. Lower score wins.
_OVERLOAD_PENALTY = {"healthy": 0.0, "pressured": 2.0,
                     "shedding": 8.0, "draining": float("inf")}
_SLO_PENALTY = {"ok": 0.0, "warn": 2.0, "page": 8.0}


class ReplicaHandle:
    """One in-process engine replica, as the router tracks it."""

    def __init__(self, replica_id: str, engine: EngineBase, *,
                 role: str = "mixed", dead_probes: int = 2,
                 clock=time.monotonic):
        self.replica_id = replica_id
        self.engine = engine
        # Disaggregated-serving role (router/disagg.py): placement
        # filters by it, /fleet surfaces it. Mirrored onto the engine
        # so an in-proc prefill replica enforces its zero-decode-slot
        # guarantee itself (remote engines are client stubs — the
        # remote server enforces its own configured role).
        self.role = role
        engine.role = role
        self.dead_probes = max(1, dead_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = STATE_HEALTHY
        self.draining = False
        # Why the replica is dead ("probe" = consecutive probe
        # failures, the network-partition signature; "stream" = a
        # stream failed with the backend unreachable). None while not
        # dead. The router emits `router_partition` for probe deaths.
        self.dead_reason: str | None = None
        # Last begin_drain/drain_replica failure against this replica
        # (None = drains clean) — surfaced on GET /fleet so a stuck
        # drain is visible, not a log line (docs/ROUTER.md).
        self.drain_error: str | None = None
        self._consec_failures = 0
        self.last_probe: dict[str, Any] = {}
        self.last_probe_at: float | None = None
        # Request ids currently streaming from this replica (router-side
        # bookkeeping; feeds the load score between probes).
        self.inflight: set[str] = set()
        self.placements = 0          # lifetime placements (stats)
        self.failovers = 0           # streams that died here (stats)

    # ---------------- probing ----------------

    def probe_now(self) -> dict[str, Any]:
        """One synchronous health/load probe. Updates ``state`` and
        ``last_probe``; returns the signal dict. Never raises."""
        try:
            if _fp.enabled:
                # Chaos seam: `error` here IS a network partition as
                # the router experiences one — the backend may be
                # perfectly alive, the router just cannot see it.
                _fp.fire("router.probe", replica=self.replica_id)
            alive = self.engine.check_connection()
        except Exception:
            alive = False
        if not alive:
            return self._probe_failed("backend not connected")
        try:
            signals = self._collect_signals()
        except Exception as e:  # a flaky stats surface is not a death
            signals = {"error": f"stats probe failed: {e}"}
        with self._lock:
            self._consec_failures = 0
            recovered = self.state == STATE_DEAD
            self.dead_reason = None
            self.state = (STATE_DEGRADED
                          if signals.get("overload_state")
                          in ("pressured", "shedding")
                          or signals.get("slo_alert") == "page"
                          else STATE_HEALTHY)
            self.last_probe = signals
            self.last_probe_at = self._clock()
        if recovered:
            log.info(f"replica {self.replica_id} recovered "
                     f"(state {self.state})")
        return signals

    def _collect_signals(self) -> dict[str, Any]:
        """Load signals from an in-proc engine's own stats surface —
        the same numbers /health and /stats publish, read directly.

        Deliberately NO slo_alert here: in-proc replicas share the
        process-wide SLO engine, so its alert state is identical for
        every replica and carries no per-replica routing information.
        The SLO placement penalty applies to remote replicas, whose
        /health body reports their own burn state."""
        stats = self.engine.get_stats() or {}
        sched = stats.get("scheduler") or {}
        slots = stats.get("slots") or {}
        return {
            "alive": True,
            "waiting": stats.get("waiting", 0) or 0,
            "running": (stats.get("running", slots.get("active", 0))
                        or 0),
            "slots_total": slots.get("total_slots"),
            "overload_state": sched.get("state", "healthy"),
            "estimated_wait_s": sched.get("estimated_wait_s", 0.0),
            "draining_backend": bool(sched.get("draining", False)),
        }

    def _probe_failed(self, reason: str) -> dict[str, Any]:
        with self._lock:
            self._consec_failures += 1
            died = (self.state != STATE_DEAD
                    and self._consec_failures >= self.dead_probes)
            if died:
                self.state = STATE_DEAD
                self.dead_reason = "probe"
            self.last_probe = {"alive": False, "error": reason}
            self.last_probe_at = self._clock()
        if died:
            log.warning(f"replica {self.replica_id} marked dead: "
                        f"{reason}")
        return self.last_probe

    def note_stream_failure(self) -> bool:
        """Fast-path death detection: a stream just failed here. If the
        backend is also unreachable, mark dead NOW instead of waiting
        out ``dead_probes`` probe periods. Returns True when this call
        transitioned the replica to dead."""
        try:
            alive = self.engine.check_connection()
        except Exception:
            alive = False
        with self._lock:
            self.failovers += 1
            if not alive and self.state != STATE_DEAD:
                self.state = STATE_DEAD
                self.dead_reason = "stream"
                self._consec_failures = self.dead_probes
                log.warning(f"replica {self.replica_id} marked dead "
                            "(stream failed and backend unreachable)")
                return True
        return False

    # ---------------- placement view ----------------

    def alive(self) -> bool:
        try:
            return bool(self.engine.check_connection())
        except Exception:
            return False

    def available(self) -> bool:
        """Eligible for NEW placements: not dead, not draining."""
        return self.state != STATE_DEAD and not self.draining

    def load_score(self) -> float:
        """Expected cost of placing one more request here (lower is
        better). Uses the latest probe's signals plus the router's own
        live in-flight count, so the score moves between probes."""
        with self._lock:
            p = dict(self.last_probe)
            inflight = len(self.inflight)
        if self.draining or p.get("draining_backend"):
            return float("inf")
        score = float(p.get("waiting", 0) or 0) + float(inflight)
        slots = p.get("slots_total")
        if slots:
            score += float(p.get("running", 0) or 0) / float(slots)
        score += _OVERLOAD_PENALTY.get(p.get("overload_state", "healthy"),
                                       0.0)
        score += _SLO_PENALTY.get(p.get("slo_alert", "ok"), 0.0)
        return score

    # ---------------- KV migration channel (router/migrate.py) ----

    # In-proc replicas hand the parked entry's numpy arrays over
    # directly through the engine seam; RemoteReplicaHandle overrides
    # with the /kv/parked HTTP wire form. All four run on the router's
    # migrate worker thread (never the event loop) and may raise — the
    # transfer classifies and the router falls back to re-prefill.

    def parked_info(self, session_id: str) -> tuple[int, int] | None:
        return self.engine.parked_kv_info(session_id)

    def export_parked(self, session_id: str,
                      traceparent: str | None = None):
        # traceparent is a wire concern: in-proc transfers already live
        # inside the process tracer, so the kwarg is accepted (one
        # transfer() call shape for both handle types) and ignored.
        return self.engine.export_parked_kv(session_id)

    def import_parked(self, entry, traceparent: str | None = None,
                      ) -> bool:
        return bool(self.engine.import_parked_kv(entry))

    def drop_parked(self, session_id: str) -> bool:
        return bool(self.engine.drop_parked_kv(session_id))

    # ---------------- fleet observability fan-out ----------------
    # (router/router.py stitched_trace / fleet_metrics / fleet_slo,
    # observability/fleetflight.py). In-proc replicas share the
    # router-front process's tracer, metrics registry and SLO engine —
    # their contribution is already in the local fragment/exposition,
    # so fetching from them would double-count. RemoteReplicaHandle
    # overrides with the serving-port HTTP surfaces.

    def fetch_trace(self, request_id: str,
                    trace_id: str = "") -> list[dict[str, Any]]:
        """Trace fragments this replica holds for a request ([] for
        in-proc: the local collect_fragments already saw them)."""
        return []

    def fetch_metrics(self) -> str | None:
        """Prometheus exposition text (None for in-proc: the shared
        registry is the local text)."""
        return None

    def fetch_slo(self) -> dict[str, Any] | None:
        """SLO report (None for in-proc: the shared engine's snapshot
        is the local report)."""
        return None

    def to_dict(self) -> dict[str, Any]:
        with self._lock:
            return {
                "replica_id": self.replica_id,
                "role": self.role,
                "state": self.state,
                "dead_reason": self.dead_reason,
                "draining": self.draining,
                "drain_error": self.drain_error,
                "inflight": len(self.inflight),
                "placements": self.placements,
                "failovers": self.failovers,
                "load_score": None,  # filled by caller outside the lock
                "last_probe": dict(self.last_probe),
                "last_probe_at": self.last_probe_at,
            }


class RemoteReplicaHandle(ReplicaHandle):
    """A replica reached over HTTP: another FastTalk server (its
    OpenAI-compatible /v1 surface carries generations via the existing
    ``remote.py`` client; its /health carries the probe signals).

    ``base_url`` is the serving root, e.g. ``http://replica-2:8000``.
    """

    def __init__(self, replica_id: str, base_url: str, model: str, *,
                 role: str = "mixed", dead_probes: int = 2,
                 probe_timeout_s: float = 3.0,
                 timeout_s: float = 600.0, max_inflight: int = 32,
                 admission_timeout_s: float = 30.0,
                 connect_retries: int = 2, clock=time.monotonic):
        from fasttalk_tpu_torch.engine.remote import VLLMRemoteEngine

        self.base_url = base_url.rstrip("/")
        self.probe_timeout_s = probe_timeout_s
        engine = VLLMRemoteEngine(
            f"{self.base_url}/v1", model, timeout_s=timeout_s,
            max_inflight=max_inflight,
            admission_timeout_s=admission_timeout_s,
            connect_retries=connect_retries)
        super().__init__(replica_id, engine, role=role,
                         dead_probes=dead_probes, clock=clock)

    def probe_now(self) -> dict[str, Any]:
        import requests

        try:
            if _fp.enabled:
                # Chaos seam: the remote flavour of a partition — the
                # health GET never arrives.
                _fp.fire("router.probe", replica=self.replica_id)
            r = requests.get(f"{self.base_url}/health",
                             timeout=self.probe_timeout_s)
            body = r.json() if r.content else {}
        except Exception as e:
            return self._probe_failed(f"health probe failed: {e}")
        if r.status_code >= 500:
            return self._probe_failed(f"health returned {r.status_code}")
        sched = body.get("scheduler") or {}
        slo = body.get("slo") or {}
        signals = {
            "alive": True,
            "status": body.get("status"),
            "waiting": sched.get("depth", 0) or 0,
            "running": body.get("active_sessions", 0) or 0,
            "slots_total": None,
            "overload_state": sched.get("state", "healthy"),
            "estimated_wait_s": sched.get("estimated_wait_s", 0.0),
            "draining_backend": bool(sched.get("draining", False)),
            # Worst class alert ("page" beats "warn" beats "ok").
            "slo_alert": max(slo.values(), default="ok",
                             key=("ok", "warn", "page").index)
            if all(v in ("ok", "warn", "page") for v in slo.values())
            else "ok",
        }
        with self._lock:
            self._consec_failures = 0
            recovered = self.state == STATE_DEAD
            self.dead_reason = None
            self.state = (STATE_DEGRADED
                          if signals["overload_state"]
                          in ("pressured", "shedding")
                          or signals["slo_alert"] == "page"
                          else STATE_HEALTHY)
            self.last_probe = signals
            self.last_probe_at = self._clock()
        if recovered:
            log.info(f"replica {self.replica_id} recovered")
        return signals

    def alive(self) -> bool:
        # The remote engine's check_connection() probes /health itself;
        # state from the last probe is the cheaper, equivalent signal.
        return self.state != STATE_DEAD

    def note_stream_failure(self) -> bool:
        """No blocking liveness probe here — the base implementation's
        check_connection() would be a synchronous HTTP GET executed on
        the asyncio event loop mid-failover, freezing every other live
        stream for the TCP timeout. A stream failing against a remote
        replica (after the client's own pre-first-token retries) marks
        it dead immediately; the probe thread recovers it as soon as
        /health answers again."""
        with self._lock:
            self.failovers += 1
            if self.state != STATE_DEAD:
                self.state = STATE_DEAD
                self.dead_reason = "stream"
                self._consec_failures = self.dead_probes
                log.warning(f"replica {self.replica_id} marked dead "
                            "(stream failed)")
                return True
        return False

    # ---------------- KV migration over HTTP ----------------
    # The serving port's /kv/parked/{session_id} endpoints
    # (serving/server.py) carry the wire form from router/migrate.py.
    # Synchronous `requests` by design: these run on the router's
    # disposable migrate worker thread, which the router bounds with
    # ROUTER_MIGRATE_TIMEOUT_S — never on the event loop.

    MIGRATE_HTTP_TIMEOUT_S = 30.0

    def parked_info(self, session_id: str) -> tuple[int, int] | None:
        import requests

        r = requests.get(f"{self.base_url}/kv/parked/{session_id}",
                         params={"meta": "1"},
                         timeout=self.probe_timeout_s)
        if r.status_code != 200:
            return None
        body = r.json()
        return int(body["kept"]), int(body["nbytes"])

    def export_parked(self, session_id: str,
                      traceparent: str | None = None):
        import requests

        from fasttalk_tpu_torch.router.migrate import deserialize_parked

        r = requests.get(f"{self.base_url}/kv/parked/{session_id}",
                         headers={"traceparent": traceparent}
                         if traceparent else None,
                         timeout=self.MIGRATE_HTTP_TIMEOUT_S)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return deserialize_parked(r.content)

    def import_parked(self, entry, traceparent: str | None = None,
                      ) -> bool:
        import requests

        from fasttalk_tpu_torch.router.migrate import serialize_parked

        headers = {"Content-Type": "application/octet-stream"}
        if traceparent:
            headers["traceparent"] = traceparent
        r = requests.post(
            f"{self.base_url}/kv/parked/{entry.session_id}",
            data=serialize_parked(entry),
            headers=headers,
            timeout=self.MIGRATE_HTTP_TIMEOUT_S)
        return r.status_code == 200

    def drop_parked(self, session_id: str) -> bool:
        import requests

        r = requests.delete(f"{self.base_url}/kv/parked/{session_id}",
                            timeout=self.probe_timeout_s)
        return r.status_code == 200

    # ---------------- fleet observability fan-out ----------------

    def fetch_trace(self, request_id: str,
                    trace_id: str = "") -> list[dict[str, Any]]:
        """Fragments this replica's serving port holds for a request
        (GET /traces/{request_id}, serving/server.py). Raises on
        transport failure — the router classifies and keeps stitching
        from the replicas that answered."""
        import requests

        r = requests.get(f"{self.base_url}/traces/{request_id}",
                         params={"trace_id": trace_id}
                         if trace_id else None,
                         timeout=self.probe_timeout_s)
        if r.status_code == 404:
            return []
        r.raise_for_status()
        body = r.json()
        frags = body.get("fragments", [])
        for f in frags:
            f.setdefault("source", self.replica_id)
        return frags

    def fetch_metrics(self) -> str | None:
        import requests

        r = requests.get(f"{self.base_url}/metrics",
                         timeout=self.probe_timeout_s)
        r.raise_for_status()
        return r.text

    def fetch_slo(self) -> dict[str, Any] | None:
        import requests

        r = requests.get(f"{self.base_url}/slo",
                         timeout=self.probe_timeout_s)
        r.raise_for_status()
        return r.json()
