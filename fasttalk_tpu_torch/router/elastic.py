"""Elastic replica scaling: spawn and retire fleet replicas on load.

A copy of ``fasttalk_tpu/router/elastic.py`` (the port imports nothing of the JAX
package); the two behave the same on the same inputs.

The launcher attaches an ``ElasticScaler`` to the FleetRouter when
``FLEET_SCALE_MAX`` exceeds the base fleet size (docs/ROUTER.md
"Elastic replicas"). Decisions reuse the signals the stack already
publishes — the scheduler's queue depth (admission control) and
the SLO engine's burn-rate alert states — so the scaler adds no
new health protocol, just a control loop:

- **Scale up** when aggregate queued work reaches
  ``FLEET_SCALE_UP_QUEUE`` or any SLO class is page-burning, and the
  fleet is under ``FLEET_SCALE_MAX``. A new in-process replica is
  built, started, probed and registered; placement starts sending it
  work on the next request.
- **Scale down** when the whole fleet has been idle (no queued, no
  running work) for ``FLEET_SCALE_DOWN_IDLE_S`` and the fleet is above
  ``FLEET_SCALE_MIN``. Scale-down is **drain-then-migrate**: the
  victim stops taking placements, its parked sessions' KV migrates to
  survivors (their next turn restores — the retirement is
  client-invisible), its in-flight streams finish in place, and only
  then is the replica removed and shut down.

Exactly one membership change is in flight at a time, and the check
loop is clock-injectable so tests drive it deterministically.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Callable

from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.router.disagg import (ROLE_DECODE, ROLE_MIXED,
                                              ROLE_PREFILL, role_of,
                                              tier_stats)
from fasttalk_tpu_torch.router.replica import ReplicaHandle
from fasttalk_tpu_torch.router.router import FleetRouter
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("router.elastic")


class ElasticScaler:
    """Queue-depth + SLO-burn driven fleet sizing over a FleetRouter.

    In a role-split fleet (router/disagg.py) the two tiers scale
    INDEPENDENTLY off their own saturation signals: the prefill tier
    off its aggregate queue depth (its work WAITS by design — depth is
    the whole signal), the decode tier off queue depth, SLO page-burn
    or slot occupancy crossing ``DECODE_OCCUPANCY_UP`` (decode
    saturates by filling slots long before it queues). Scale-up
    preserves the starved tier's role on the new replica; scale-down
    never retires the last replica of a tier. All-mixed fleets take
    the original single-signal path unchanged."""

    # Decode-tier scale-up trigger: fraction of the tier's decode
    # slots running. Queue depth alone under-fires for decode — slots
    # fill and streams slow down (inter-token latency) before the
    # scheduler queue grows.
    DECODE_OCCUPANCY_UP = 0.9

    def __init__(self, router: FleetRouter,
                 build_replica: Callable[[str], ReplicaHandle], *,
                 min_replicas: int = 1, max_replicas: int = 2,
                 up_queue_depth: int = 8,
                 down_idle_s: float = 120.0,
                 check_interval_s: float = 5.0,
                 slo_alerts: Callable[[], dict] | None = None,
                 clock=time.monotonic):
        self.router = router
        self.build_replica = build_replica
        self.min_replicas = max(1, min_replicas)
        self.max_replicas = max(self.min_replicas, max_replicas)
        self.up_queue_depth = max(1, up_queue_depth)
        self.down_idle_s = down_idle_s
        self.check_interval_s = check_interval_s
        self._slo_alerts = slo_alerts
        self._clock = clock
        self._idle_since: float | None = None
        self._pending_down: str | None = None  # replica draining out
        self._seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._events = get_events()
        m = get_metrics()
        self._m_up = m.counter(
            "router_scale_up_total",
            "replicas added by the elastic scaler")
        self._m_down = m.counter(
            "router_scale_down_total",
            "replicas retired by the elastic scaler (drain-then-"
            "migrate, client-invisible)")

    # ---------------- lifecycle ----------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="router-elastic",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self.check_once()
            except Exception as e:  # the control loop must never die
                log.error(f"elastic check failed: {e}", exc_info=True)

    # ---------------- the control decision ----------------

    def _fleet_load(self) -> tuple[int, int]:
        """(queued, running) across the fleet, from the same stats the
        probes already read."""
        stats = self.router.get_stats()
        return (int(stats.get("waiting", 0) or 0),
                int(stats.get("running", 0) or 0))

    def _slo_paging(self) -> bool:
        if self._slo_alerts is None:
            return False
        try:
            return any(v == "page"
                       for v in (self._slo_alerts() or {}).values())
        except Exception:
            return False

    def check_once(self) -> dict[str, Any]:
        """One control-loop pass (public + synchronous for tests).
        Returns a decision summary."""
        now = self._clock()
        self._reap_pending_down()
        live = [h for h in self.router.replicas
                if h.replica_id != self._pending_down]
        n = len(live)
        waiting, running = self._fleet_load()
        paging = self._slo_paging()
        decision = "hold"
        if self._pending_down is not None:
            # A retirement is still in flight (victim's streams
            # finishing). Exactly one membership change at a time:
            # hold here — a load spike just waits one reap (the
            # next pass scales up once the victim is gone, and the
            # victim's capacity is still serving its own streams
            # meanwhile).
            pass
        elif n < self.min_replicas:
            decision = self._scale_up("below_min")
        elif (waiting >= self.up_queue_depth or paging
              or self._decode_saturated(live)) \
                and n < self.max_replicas:
            decision = self._scale_up(
                "slo_burn" if paging else (
                    "queue_depth" if waiting >= self.up_queue_depth
                    else "decode_occupancy"),
                role=self._starved_role(live, waiting, paging),
                waiting=waiting)
        elif waiting == 0 and running == 0:
            if self._idle_since is None:
                self._idle_since = now
            elif (self.down_idle_s > 0
                  and now - self._idle_since >= self.down_idle_s
                  and n > self.min_replicas
                  and self._pending_down is None):
                decision = self._initiate_down()
        else:
            self._idle_since = None
        return {"decision": decision, "replicas": n,
                "waiting": waiting, "running": running,
                "paging": paging, "pending_down": self._pending_down}

    # ---------------- role-split tier signals (router/disagg.py) ----

    def _decode_saturated(self, live: list[ReplicaHandle]) -> bool:
        """Decode-tier slot occupancy at/over ``DECODE_OCCUPANCY_UP``
        — the decode tier's own saturation signal in a role-split
        fleet (occupancy comes from the replicas' last probe; an
        unprobed fleet reads as not saturated)."""
        if all(role_of(h) == ROLE_MIXED for h in live):
            return False
        return any(t.get("occupancy") is not None
                   and t["occupancy"] >= self.DECODE_OCCUPANCY_UP
                   for role, t in tier_stats(live).items()
                   if role != ROLE_PREFILL)

    def _starved_role(self, live: list[ReplicaHandle], waiting: int,
                      paging: bool) -> str:
        """Which tier the new replica should join. Mixed fleets grow
        mixed (unchanged behaviour). In a role-split fleet the prefill
        tier wins only when its OWN queue crossed the threshold and
        the decode tier is not in distress — decode latency is the
        user-facing signal, so ties go to decode."""
        if all(role_of(h) == ROLE_MIXED for h in live):
            return ROLE_MIXED
        tiers = tier_stats(live)
        pf_waiting = tiers.get(ROLE_PREFILL, {}).get("waiting", 0)
        if pf_waiting >= self.up_queue_depth and not paging \
                and not self._decode_saturated(live):
            return ROLE_PREFILL
        return ROLE_DECODE

    def _build(self, replica_id: str, role: str) -> ReplicaHandle:
        """Invoke the launcher's build function, passing the role
        through when it accepts one (older build functions — and the test suite's
        1-arg lambdas — predate roles; their handles get the role
        stamped on after the fact, engine mirror included, so
        scale-up preserves the starved tier either way)."""
        try:
            wants_role = len(inspect.signature(
                self.build_replica).parameters) >= 2
        except (TypeError, ValueError):
            wants_role = False
        if wants_role:
            handle = self.build_replica(replica_id, role)
        else:
            handle = self.build_replica(replica_id)
        if role_of(handle) != role:
            handle.role = role
            try:
                handle.engine.role = role
            except Exception:
                pass
        return handle

    # ---------------- scale up ----------------

    def _scale_up(self, reason: str, role: str = ROLE_MIXED,
                  **attrs: Any) -> str:
        self._seq += 1
        replica_id = f"elastic-{self._seq}"
        if role != ROLE_MIXED:
            attrs["role"] = role
        try:
            handle = self._build(replica_id, role)
            handle.engine.start()
            handle.probe_now()
            self.router.add_replica(handle)
        except Exception as e:
            log.error(f"scale-up failed: {e}", exc_info=True)
            self._events.emit("router_scale", severity="critical",
                              action="up_failed", reason=reason,
                              error=str(e)[:200])
            return "up_failed"
        self._m_up.inc()
        self._idle_since = None
        self._events.emit("router_scale", severity="warning",
                          action="up", replica=replica_id,
                          reason=reason, fleet=len(self.router.replicas),
                          **attrs)
        log.info(f"scaled UP ({reason}): added {replica_id}, fleet is "
                 f"now {len(self.router.replicas)}")
        return "up"

    # ---------------- scale down (drain-then-migrate) ----------------

    def _initiate_down(self) -> str:
        """Pick a victim and start its client-invisible retirement:
        drain_replica migrates its parked KV to survivors and stops
        placements; the handle is reaped once its streams finish.

        Remote replicas (ROUTER_BACKENDS) are NEVER victims: the
        scaler's build_replica only makes in-process engines, so a
        retired remote backend could not come back on the next
        scale-up — the static fleet would degrade permanently."""
        from fasttalk_tpu_torch.router.replica import RemoteReplicaHandle

        candidates = [h for h in self.router.replicas
                      if h.available()
                      and not isinstance(h, RemoteReplicaHandle)]
        if any(role_of(h) != ROLE_MIXED for h in self.router.replicas):
            # Role-split fleet: never retire the last available
            # replica of a tier — an empty prefill tier silently turns
            # every long prompt into a fallback, an empty decode tier
            # cannot serve at all.
            tier_avail: dict[str, int] = {}
            for h in self.router.replicas:
                if h.available():
                    tier_avail[role_of(h)] = \
                        tier_avail.get(role_of(h), 0) + 1
            candidates = [h for h in candidates
                          if tier_avail.get(role_of(h), 0) > 1]
        if not candidates \
                or len([h for h in self.router.replicas
                        if h.available()]) <= self.min_replicas:
            return "hold"
        victim = min(candidates, key=lambda h: h.load_score())
        summary = self.router.drain_replica(victim.replica_id)
        self._pending_down = victim.replica_id
        self._events.emit("router_scale", severity="warning",
                          action="down_draining",
                          replica=victim.replica_id,
                          migrated_kv=summary.get("migrated_kv", 0),
                          busy=len(summary.get("busy_sessions", [])))
        log.info(f"scaling DOWN: draining {victim.replica_id} "
                 f"(migrated_kv={summary.get('migrated_kv', 0)})")
        self._reap_pending_down()
        return "down_draining"

    def _reap_pending_down(self) -> None:
        """Finish a retirement whose streams have drained: remove the
        replica from the router and shut its engine down."""
        rid = self._pending_down
        if rid is None:
            return
        handle = next((h for h in self.router.replicas
                       if h.replica_id == rid), None)
        if handle is None:  # already gone (operator removed it)
            self._pending_down = None
            return
        try:
            busy = len(handle.inflight) \
                or int(handle.engine.pending_requests() or 0)
        except Exception:
            busy = 0
        if busy:
            return  # streams still finishing in place
        try:
            self.router.remove_replica(rid)
        except ValueError:
            return  # last replica — never remove
        self._pending_down = None
        self._m_down.inc()
        try:
            handle.engine.shutdown()
        except Exception as e:
            log.error(f"retired replica {rid} shutdown error: {e}")
        self._events.emit("router_scale", severity="warning",
                          action="down", replica=rid,
                          fleet=len(self.router.replicas))
        log.info(f"scaled DOWN: retired {rid}, fleet is now "
                 f"{len(self.router.replicas)}")

    def stats(self) -> dict[str, Any]:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "up_queue_depth": self.up_queue_depth,
            "down_idle_s": self.down_idle_s,
            "pending_down": self._pending_down,
            "scale_ups": self._m_up.value,
            "scale_downs": self._m_down.value,
        }
