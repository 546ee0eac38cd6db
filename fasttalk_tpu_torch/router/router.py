"""FleetRouter: health-aware routing across N engine replicas.

A copy of ``fasttalk_tpu/router/router.py`` (the port imports nothing of the JAX
package); the two behave the same on the same inputs.

The scale-OUT tier the ROADMAP north star requires: one EngineBase-
shaped front that spreads sessions across a fleet of engine replicas
(in-process engines and/or remote FastTalk servers), the way
JetStream/llm-d-style deployments front their model servers. Because
the router IS an ``EngineBase``, the entire serving stack — WebSocket
server, OpenAI routes, breaker, drain-on-shutdown — runs unchanged on
top of it; the router slots in where a single engine used to be.

What it adds over a bare engine (docs/ROUTER.md):

- **Replica registry + probes.** A daemon thread probes every replica
  each ``probe_interval_s`` using the signals the stack already
  publishes (check_connection / get_stats for in-proc replicas, the
  /health body for remote ones) — no new health protocol.
- **Session affinity.** A session sticks to the replica holding its
  resident or host-parked KV (policy.py), so the host-KV restore path
  keeps paying off across the fleet; new sessions place
  weighted-least-loaded (queue depth, overload state, SLO burn).
- **Failover.** A replica dying mid-stream triggers resume-on-survivor:
  the transcript re-prefills on a healthy replica, already-delivered
  text is trimmed from the new stream, and the client sees one
  ``resumed`` event — not an error. Pre-first-token failures re-route
  silently (nothing was delivered, the retry is idempotent); when no
  healthy replica remains the request sheds with ``retry_after``.
- **Coordinated drain.** ``drain_replica()`` stops placement to one
  replica, lets its in-flight streams finish, and migrates its idle
  parked sessions to a survivor — the fleet keeps serving through a
  rolling restart.
- **Cross-replica KV migration** (router/migrate.py). Drain, failover
  and rebalancing move a parked session's host-KV entry to the target
  replica's pool, so the next turn RESTORES (copy + delta prefill)
  instead of re-prefilling the transcript. The three-way decision —
  migrate vs re-prefill vs restore-local — is priced by the
  kvcache/policy.py EMAs with a migration-bandwidth term; transfers
  are bounded by ``ROUTER_MIGRATE_TIMEOUT_S`` and fall back to
  re-prefill on any failure with exact byte accounting on both pools.
- **Prefix-aware placement + elastic replicas.** Same-system-prompt
  tenants co-locate while nearly free (policy.py PREFIX_SLACK) to hit
  the shared-prefix stamp; router/elastic.py scales the fleet up on
  queue depth / SLO burn and down via drain-then-migrate
  (client-invisible).

Resume caveat: the survivor re-generates from the transcript, so with
temperature > 0 the continuation may diverge from what the dead replica
would have said; with greedy sampling it is identical. The overlap trim
is by character count of delivered text.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import replace as _dc_replace
from typing import Any, AsyncGenerator

from fasttalk_tpu_torch.engine.engine import (EngineBase, GenerationParams,
                                              raw_prompt_text)
from fasttalk_tpu_torch.kvcache.policy import RestorePolicy, kv_env_defaults
from fasttalk_tpu_torch.kvcache.radix import chain_digest
from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.observability.trace import (current_traceparent,
                                                    get_tracer)
import fasttalk_tpu_torch.router.migrate as _migrate
from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.router.disagg import (DECODE_ROLES, ROLE_MIXED,
                                              ROLE_PREFILL, DisaggController,
                                              parse_roles, role_of,
                                              tier_stats)
from fasttalk_tpu_torch.router.policy import AffinityMap, PlacementPolicy
from fasttalk_tpu_torch.router.replica import (STATE_DEAD, ReplicaHandle,
                                               RemoteReplicaHandle)
from fasttalk_tpu_torch.utils.errors import (AdmissionRejected, ErrorCategory,
                                             LLMServiceError)
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("router")

# LLMServiceError categories that indicate the REPLICA failed (connect
# refused, timeout, OOM) rather than the request being malformed —
# these are failover-eligible; validation/model errors propagate.
_FAULT_CATEGORIES = (ErrorCategory.CONNECTION, ErrorCategory.TIMEOUT,
                     ErrorCategory.RESOURCE)


class FleetRouter(EngineBase):
    """Engine-shaped front over a fleet of replicas."""

    def __init__(self, replicas: list[ReplicaHandle], *,
                 probe_interval_s: float = 2.0,
                 affinity_ttl_s: float = 600.0,
                 failover_retries: int = 2,
                 resume: bool = True,
                 migrate: bool = True,
                 migrate_timeout_s: float = 10.0,
                 prefix_affinity: bool = True,
                 disagg_prefill_min_tokens: int = 512,
                 clock=time.monotonic):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        ids = [h.replica_id for h in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas = list(replicas)
        self.probe_interval_s = probe_interval_s
        self.failover_retries = max(0, failover_retries)
        self.resume_enabled = resume
        self.migrate_enabled = migrate
        self.migrate_timeout_s = max(0.05, migrate_timeout_s)
        self._clock = clock
        # Three-way migrate/re-prefill/restore-local pricing
        # (kvcache/policy.py): migration bandwidth learned from this
        # router's own completed transfers, prefill throughput from the
        # fleet's done-event stats (prompt_tokens / ttft).
        self.kv_policy = RestorePolicy(
            min_tokens=int(kv_env_defaults()["min_tokens"]))
        # Disaggregated prefill/decode (router/disagg.py): the handoff
        # decision + its learned wire-cost model, sharing the same
        # pricing EMAs as drain/failover migration. Dormant (and
        # byte-identical to the pre-disagg router) until a replica
        # carries a non-mixed role.
        self.disagg = DisaggController(
            self.kv_policy,
            prefill_min_tokens=disagg_prefill_min_tokens)
        # request_id -> (prefill handle, sub-request id) while a
        # handoff's prefill leg is in flight — cancel() forwards there.
        self._handoff_streams: dict[str, tuple[ReplicaHandle, str]] = {}
        # First in-proc replica's tokenizer, resolved lazily: the
        # router has no model of its own, but the threshold routing
        # needs a prompt-length estimate (falls back to chars/4 for
        # all-remote fleets).
        self._tok: Any = False  # False = unresolved, None = none found
        self.affinity = AffinityMap(ttl_s=affinity_ttl_s, clock=clock)
        self.policy = PlacementPolicy(
            self.affinity, prefix_affinity=prefix_affinity,
            on_prefix_hit=lambda: self._m_prefix.inc())
        self._routes: dict[str, tuple[str, ReplicaHandle]] = {}
        self._cancelled: set[str] = set()
        self._draining = False
        self._started = False
        self._probe_thread: threading.Thread | None = None
        self._probe_stop = threading.Event()
        self._events = get_events()
        # Router spans carry component="router" so a stitched trace
        # (observability/stitch.py) keeps the fleet's hops apart from
        # the replicas' queue_wait/prefill/decode_step spans even when
        # everything shares one in-proc process tracer.
        self._tracer = get_tracer().scoped("router")
        m = get_metrics()
        self._m_replicas = m.gauge(
            "router_replicas", "replicas registered with the router")
        self._m_available = m.gauge(
            "router_replicas_available",
            "replicas currently placeable (not dead, not draining)")
        self._m_placements = m.counter(
            "router_placements_total", "requests placed on a replica")
        self._m_affinity_hits = m.counter(
            "router_affinity_hits_total",
            "placements that reused the session's pinned replica")
        self._m_failovers = m.counter(
            "router_failovers_total",
            "streams that failed on a replica and were re-routed")
        self._m_resumes = m.counter(
            "router_resumes_total",
            "mid-stream failovers resumed on a survivor (client saw a "
            "resumed event, not an error)")
        self._m_sheds = m.counter(
            "router_sheds_total",
            "requests shed by the router (no placeable replica)")
        self._m_migrations = m.counter(
            "router_migrations_total",
            "parked-KV entries migrated between replicas")
        self._m_migration_failures = m.counter(
            "router_migration_failures_total",
            "cross-replica KV migrations that failed (both pools left "
            "with exact byte accounting; session falls back to "
            "re-prefill)")
        self._m_migration_bytes = m.counter(
            "router_migration_bytes",
            "parked-KV bytes moved between replica pools")
        self._m_migration_ms = m.histogram(
            "router_migration_ms",
            "cross-replica KV migration latency (export + transfer + "
            "import)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000,
                     4000, 10000))
        self._m_drain_errors = m.counter(
            "router_drain_errors_total",
            "per-replica drain calls that failed (partial drain — "
            "surfaced on GET /fleet)")
        self._m_partitions = m.counter(
            "router_partitions_total",
            "replicas declared dead by consecutive probe failures "
            "(the network-partition signature)")
        self._m_prefix = m.counter(
            "router_prefix_colocations_total",
            "placements co-located with their shared-prefix tenant "
            "replica (prefix-stamp reuse)")
        self._m_handoffs = m.counter(
            "router_disagg_handoffs_total",
            "disaggregated prefill->decode handoffs completed (prefill "
            "tier computed the KV, the decode tier restored it)")
        self._m_handoff_ms = m.histogram(
            "router_disagg_handoff_ms",
            "disagg handoff settle latency (park wait + KV transfer "
            "to the decode replica; the prefill itself is not in "
            "here — TTFT = prefill + this)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000,
                     4000, 10000))
        self._m_handoff_fallbacks = m.counter(
            "router_disagg_fallback_total",
            "streams that fell back to mixed placement (pricing said "
            "re-prefill, no prefill replica, or the handoff "
            "failed/hung — zero client-visible error frames either "
            "way)")
        self._m_replicas.set(len(self.replicas))

    # ---------------- lifecycle ----------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for h in self.replicas:
            try:
                h.engine.start()
            except Exception as e:
                log.error(f"replica {h.replica_id} failed to start: {e}")
        self.probe_once()
        if self.probe_interval_s > 0:
            self._probe_stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="router-probe", daemon=True)
            self._probe_thread.start()

    def shutdown(self) -> None:
        self._started = False
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None
        for h in self.replicas:
            try:
                h.engine.shutdown()
            except Exception as e:
                log.error(f"replica {h.replica_id} shutdown error: {e}")

    def warmup(self, level: str = "off") -> None:
        for h in self.replicas:
            h.engine.warmup(level)

    def begin_drain(self) -> None:
        """Fleet-wide drain (server shutdown): every replica stops
        admitting; queued and in-flight work finishes. A replica whose
        drain call fails is a PARTIAL drain — not a log line: it emits
        a ``router_drain_error`` event, bumps the counter, and latches
        ``drain_error`` on the handle so GET /fleet shows the operator
        which replica is stuck."""
        self._draining = True
        self._events.emit("router_drain", severity="warning",
                          scope="fleet", replicas=len(self.replicas))
        for h in self.replicas:
            h.draining = True
            self._drain_engine(h)

    def _drain_engine(self, handle: ReplicaHandle) -> bool:
        """begin_drain one replica's engine, recording failure as
        visible partial-drain state. Returns True when clean."""
        handle.drain_error = None
        try:
            handle.engine.begin_drain()
            return True
        except Exception as e:
            handle.drain_error = str(e)[:500]
            self._m_drain_errors.inc()
            self._events.emit(
                "router_drain_error", severity="critical",
                replica=handle.replica_id, error=str(e)[:200])
            log.error(f"replica {handle.replica_id} drain error: {e}")
            return False

    def drain_replica(self, replica_id: str) -> dict[str, Any]:
        """Coordinated single-replica drain (rolling restart): stop
        placement here, let in-flight streams finish, and MIGRATE idle
        sessions' parked KV to a healthy replica so their next turn
        restores there instead of re-prefilling (docs/ROUTER.md). When
        a session has no parked entry, migration is off, the policy
        prices prefill cheaper, or the transfer fails/hangs, the old
        behaviour is the fallback: the entry is released and the pin
        dropped — the next turn places fresh and re-prefills. Sessions
        with a stream still running here keep their pin until it
        completes.

        Returns a summary dict; raises KeyError for an unknown id."""
        handle = self._handle(replica_id)
        handle.draining = True
        self._drain_engine(handle)
        busy_sessions = {sid for sid, h
                         in list(self._routes.values())
                         if h is handle}
        moved = self.affinity.drop_replica(replica_id,
                                           keep=busy_sessions)
        self.policy.drop_replica(replica_id)
        migrated_kv = released = 0
        channel_wedged = False
        for sid in moved:
            dst = None if channel_wedged \
                else self._migrate_target(sid, handle)
            if dst is not None:
                status = self._migrate_session(sid, handle, dst)
                if status == "ok":
                    # The entry now lives on dst: re-pin the session
                    # there so its next turn goes straight to its
                    # restored KV — UNLESS a new turn already placed
                    # it somewhere during the transfer window (that
                    # replica holds fresher KV than what just moved;
                    # the migrated copy ages out by TTL/LRU).
                    if self.affinity.get(sid) is None:
                        self.affinity.set(sid, dst.replica_id)
                    migrated_kv += 1
                    continue
                if status == "timeout":
                    # One hung transfer means the channel (NIC, peer)
                    # is wedged: N sessions must not each pay the
                    # full timeout — the drain stays bounded by ONE
                    # timeout and the rest release immediately.
                    channel_wedged = True
            # Fallback: purge the parked KV on the draining replica
            # (keeping the entry would only pin host RAM on a replica
            # that is going away); the next turn re-prefills elsewhere.
            try:
                handle.engine.release_session(sid)
            except Exception:
                pass
            released += 1
        self._events.emit("router_drain", severity="warning",
                          scope="replica", replica=replica_id,
                          migrated_sessions=len(moved),
                          migrated_kv=migrated_kv, released=released,
                          busy_sessions=len(busy_sessions),
                          drain_error=handle.drain_error)
        self._update_gauges()
        return {"replica_id": replica_id, "draining": True,
                "migrated_sessions": len(moved),
                "migrated_kv": migrated_kv, "released": released,
                "drain_error": handle.drain_error,
                "busy_sessions": sorted(busy_sessions)}

    # ---------------- cross-replica KV migration ----------------

    def _migrate_target(self, session_id: str,
                        src: ReplicaHandle) -> ReplicaHandle | None:
        """Pick where a parked session's KV should go — or None when
        migration is off, nothing is parked, or the three-way policy
        prices re-prefill cheaper than the transfer. Least-loaded
        available replica wins (no affinity side effects here)."""
        if not self.migrate_enabled:
            return None
        if not self._migration_priced(session_id, src):
            return None
        # Never migrate a session's KV onto a prefill-role replica:
        # its next decode turn could not be served there (the engine's
        # role gate rejects decode streams), so the entry would just
        # age out unreachable.
        candidates = [h for h in self.replicas
                      if h is not src and h.available()
                      and role_of(h) != ROLE_PREFILL]
        if not candidates:
            return None
        return min(candidates, key=lambda h: h.load_score())

    def _migration_priced(self, session_id: str,
                          src: ReplicaHandle) -> bool:
        """True when ``src`` holds a parked entry for the session AND
        the three-way policy prices moving it cheaper than
        re-prefilling — the single gate both drain and failover
        migration run."""
        try:
            info = src.parked_info(session_id)
        except Exception:
            return False
        if info is None:
            return False
        kept, nbytes = info
        return self.kv_policy.decide(kept, nbytes, local=False,
                                     migratable=True) == "migrate"

    def _migrate_session(self, session_id: str, src: ReplicaHandle,
                         dst: ReplicaHandle,
                         request_id: str = "") -> str:
        """One bounded migration: run the transfer on a disposable
        worker thread so a hung channel (router.migrate_send=hang, a
        wedged NIC) can NEVER wedge the caller — drain and failover
        wait at most ``migrate_timeout_s`` and fall back to
        re-prefill. On success the source entry is dropped (its bytes
        leave that pool exactly); on any failure both pools are
        untouched by construction (transfer() exports a peek and the
        target's put is atomic; a worker that outlives the deadline
        undoes its own late import). Returns ``"ok"``, ``"failed"``,
        or ``"timeout"`` — drain treats a timeout as the channel being
        wedged and stops attempting further migrations."""
        t0 = self._clock()
        done = threading.Event()
        abandoned = threading.Event()
        handoff = threading.Lock()
        box: dict[str, Any] = {}
        # Captured HERE: the ContextVar carrying the fleet trace id is
        # copied into asyncio.to_thread contexts but NOT into the plain
        # worker thread below — the wire header (and the span plumbing)
        # must travel explicitly.
        traceparent = current_traceparent()
        tracer = self._tracer if request_id else None

        def work() -> None:
            try:
                result = _migrate.transfer(src, dst, session_id,
                                           traceparent=traceparent,
                                           tracer=tracer,
                                           request_id=request_id)
            except BaseException as e:  # disposable thread: report all
                result = (False, 0, str(e), 0)
            with handoff:
                if not abandoned.is_set():
                    box["result"] = result
                    done.set()
                    return
            # The caller already timed out and fell back to re-prefill
            # (drain may have released the source entry, failover
            # re-prefilled). If the slow transfer then LANDED, the
            # entry would exist on the target with nobody owning it —
            # undo the import so exact-accounting holds even for a
            # worker that outlives its deadline. Guarded: the session
            # may have parked a FRESH entry on the target since (the
            # resumed turn completed there) — only drop when the pool
            # still holds what THIS transfer imported (same kept);
            # otherwise leave it (an orphan ages out by TTL/LRU, a
            # destroyed fresh entry costs the session a full
            # re-prefill).
            if result[0]:
                try:
                    info = dst.parked_info(session_id)
                    if info is not None and info[0] == result[3]:
                        dst.drop_parked(session_id)
                except Exception:
                    pass

        threading.Thread(target=work, daemon=True,
                         name="router-migrate").start()
        timed_out = not done.wait(self.migrate_timeout_s)
        if timed_out:
            # Atomic handoff: either the worker already posted its
            # result (use it), or it is now marked abandoned and will
            # undo a late success itself.
            with handoff:
                if "result" not in box:
                    abandoned.set()
                else:
                    timed_out = False
        if timed_out:
            self._m_migration_failures.inc()
            self._events.emit(
                "router_migration_failed", severity="warning",
                session=session_id, src=src.replica_id,
                dst=dst.replica_id, reason="timeout",
                timeout_s=self.migrate_timeout_s)
            log.warning(f"KV migration {src.replica_id} -> "
                        f"{dst.replica_id} for {session_id} timed out "
                        f"after {self.migrate_timeout_s}s; falling "
                        "back to re-prefill")
            return "timeout"
        ok, nbytes, reason = (box.get("result")
                              or (False, 0, "worker died", 0))[:3]
        if not ok:
            self._m_migration_failures.inc()
            self._events.emit(
                "router_migration_failed", severity="warning",
                session=session_id, src=src.replica_id,
                dst=dst.replica_id, reason=str(reason)[:200])
            log.warning(f"KV migration {src.replica_id} -> "
                        f"{dst.replica_id} for {session_id} failed: "
                        f"{reason}")
            return "failed"
        dt = max(self._clock() - t0, 1e-6)
        # Target confirmed: NOW the source gives its copy up (exact
        # byte accounting — the entry was owned by exactly one pool at
        # every instant an observer could look).
        try:
            src.drop_parked(session_id)
        except Exception:
            pass  # a dead source's pool entry dies with the replica
        self._m_migrations.inc()
        self._m_migration_bytes.inc(nbytes)
        self._m_migration_ms.observe(dt * 1000.0)
        self.kv_policy.note_migrate(nbytes, dt)
        self._events.emit("router_migration", severity="info",
                          session=session_id, src=src.replica_id,
                          dst=dst.replica_id, bytes=nbytes,
                          ms=round(dt * 1000.0, 2))
        log.info(f"migrated {nbytes} parked-KV bytes for {session_id}: "
                 f"{src.replica_id} -> {dst.replica_id} in "
                 f"{dt * 1000:.1f} ms")
        return "ok"

    def pending_requests(self) -> int:
        return sum(self._safe(h, "pending_requests", 0)
                   for h in self.replicas)

    # ---------------- elastic membership (router/elastic.py) -------

    def add_replica(self, handle: ReplicaHandle) -> None:
        """Register a freshly built replica (scale-up). The list is
        REBOUND, never mutated in place — every reader (placement,
        probe loop, failover) sees either the old or the new list."""
        if any(h.replica_id == handle.replica_id for h in self.replicas):
            raise ValueError(f"duplicate replica id "
                             f"{handle.replica_id!r}")
        self.replicas = self.replicas + [handle]
        self._m_replicas.set(len(self.replicas))
        self._update_gauges()

    def remove_replica(self, replica_id: str) -> ReplicaHandle:
        """Deregister a replica (scale-down, after its drain-then-
        migrate emptied it). The caller owns shutting the engine down.
        Raises KeyError for an unknown id."""
        handle = self._handle(replica_id)
        if len(self.replicas) <= 1:
            raise ValueError("cannot remove the last replica")
        self.replicas = [h for h in self.replicas if h is not handle]
        self.affinity.drop_replica(replica_id)
        self.policy.drop_replica(replica_id)
        self._m_replicas.set(len(self.replicas))
        self._update_gauges()
        return handle

    # ---------------- probing ----------------

    def _probe_loop(self) -> None:
        while not self._probe_stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception as e:  # the probe loop must never die
                log.error(f"router probe failed: {e}", exc_info=True)

    def probe_once(self) -> None:
        """Probe every replica once and refresh gauges/affinity.
        Public and synchronous so tests drive health transitions
        deterministically without the probe thread."""
        for h in self.replicas:
            before = h.state
            slo_before = h.last_probe.get("slo_alert", "ok")
            t_probe = time.monotonic()
            h.probe_now()
            if self._tracer.enabled:
                # Process-level probe row: the fleet's health sampling
                # is visible in the same trace dump as engine steps.
                self._tracer.step(
                    "probe", t_probe, time.monotonic(),
                    replica=h.replica_id, state=h.state)
            if h.last_probe.get("slo_alert", "ok") == "page" \
                    and slo_before != "page":
                # A remote replica's own SLO engine crossed into page
                # (its /health body said so). One event per transition:
                # the fleet flight recorder fans out evidence
                # collection while the incident is still live.
                self._events.emit(
                    "replica_slo_page", severity="critical",
                    replica=h.replica_id,
                    slo=h.last_probe.get("slo_alert"))
            if h.state != before:
                self._events.emit(
                    "router_replica_dead" if h.state == STATE_DEAD
                    else "router_replica_state",
                    severity=("critical" if h.state == STATE_DEAD
                              else "info"),
                    replica=h.replica_id, was=before, now=h.state)
                if h.state == STATE_DEAD:
                    # Idle sessions pinned to a dead replica re-place
                    # fresh; sessions with live streams are already in
                    # the failover path.
                    busy = {sid for sid, hh
                            in list(self._routes.values())
                            if hh is h}
                    pinned = self.affinity.drop_replica(h.replica_id,
                                                        keep=busy)
                    self.policy.drop_replica(h.replica_id)
                    if h.dead_reason == "probe":
                        # Death by consecutive probe failures is the
                        # network-partition signature (the backend may
                        # be fine — the router just cannot reach it).
                        # The event triggers the flight recorder: the
                        # evidence of WHY the fleet shrank is gone
                        # minutes later.
                        self._m_partitions.inc()
                        self._events.emit(
                            "router_partition", severity="critical",
                            replica=h.replica_id,
                            dead_probes=h.dead_probes,
                            pinned_sessions=len(pinned),
                            busy_streams=len(busy))
        self.affinity.prune()
        self._update_gauges()

    def _update_gauges(self) -> None:
        self._m_available.set(
            sum(1 for h in self.replicas if h.available()))

    # ---------------- routing ----------------

    def _handle(self, replica_id: str) -> ReplicaHandle:
        for h in self.replicas:
            if h.replica_id == replica_id:
                return h
        raise KeyError(f"unknown replica {replica_id!r}")

    def _place(self, session_id: str, exclude: set[str],
               prefix_key: str | None = None,
               roles: tuple[str, ...] | None = None) -> ReplicaHandle:
        handle, affine = self.policy.place(session_id, self.replicas,
                                           exclude,
                                           prefix_key=prefix_key,
                                           roles=roles)
        if handle is None:
            self._m_sheds.inc()
            raise AdmissionRejected(
                "no healthy replica available"
                + (" (fleet is draining)" if self._draining else ""),
                retry_after=max(1.0, self.probe_interval_s or 1.0),
                reason="no_replica")
        self._m_placements.inc()
        if affine:
            self._m_affinity_hits.inc()
        return handle

    # Chained-digest parameters mirroring the engine-side radix
    # prefix cache (kvcache/radix.py): fixed char blocks, each link
    # committing to everything before it, capped at a small depth.
    # ~1 KB of leading content covers the system prompt + few-shot
    # header in practice and is STABLE as a transcript grows, so
    # every turn of an agent loop maps to the same key.
    _PREFIX_CHAIN_CHARS = 256
    _PREFIX_CHAIN_DEPTH = 4

    @classmethod
    def _prefix_key(cls, messages: list[dict]) -> str | None:
        """Radix chain-hash prefix of the request's leading history
        (every message before the final turn, system prompt included):
        chained sha1 over fixed char blocks, the same chaining scheme
        the engine's radix tree uses over token blocks, so requests
        sharing it co-locate onto the replica most likely to already
        hold their cached prefix blocks. Upgrades the old system-
        prompt-only sha1: multi-turn transcripts without a system
        message now co-locate too. None when there is no leading
        content — bare single-turn traffic spreads least-loaded as
        before."""
        head = messages[:-1] if messages else []
        text = "".join(
            f"{m.get('role', '')}\x1f{m.get('content') or ''}\x1e"
            for m in head)
        if not text.strip("\x1f\x1e"):
            return None
        digest = ""
        for i in range(cls._PREFIX_CHAIN_DEPTH):
            chunk = text[i * cls._PREFIX_CHAIN_CHARS:
                         (i + 1) * cls._PREFIX_CHAIN_CHARS]
            if not chunk:
                break
            digest = chain_digest(digest,
                                  chunk.encode("utf-8", "replace"))
        return digest[:16]

    def _failover_migrate(self, session_id: str, src: ReplicaHandle,
                          dst: ReplicaHandle,
                          request_id: str = "") -> bool:
        """Best-effort parked-KV pull from the failed replica to the
        chosen survivor (migrate worker thread via to_thread). Never
        raises. Runs under the caller's copied context (to_thread), so
        the fleet trace id is still bound here — it is captured into an
        explicit traceparent before the plain worker thread loses it."""
        try:
            if not self._migration_priced(session_id, src):
                return False
            return self._migrate_session(
                session_id, src, dst, request_id=request_id) == "ok"
        except Exception as e:
            log.debug(f"failover migration probe failed for "
                      f"{session_id}: {e}")
            return False

    # ---------------- disaggregated prefill/decode (router/disagg.py,
    # docs/ROUTER.md "Disaggregated prefill/decode") ----------------

    def _decode_roles(self) -> tuple[str, ...] | None:
        """Role filter for normal (decode) stream placement: None in
        an all-mixed fleet (today's behaviour, zero role checks on the
        hot path), the decode/mixed tier once any replica carries a
        role — a decode stream must never land on a prefill replica,
        whose engine rejects it."""
        if all(role_of(h) == ROLE_MIXED for h in self.replicas):
            return None
        return DECODE_ROLES

    def _estimate_prompt_tokens(self, messages: list[dict],
                                params: GenerationParams) -> int:
        """Prompt length for the threshold routing decision. Exact
        when an in-proc replica lends its tokenizer; chars/4 for
        all-remote fleets — the threshold gates a heuristic either
        way, and the engine re-counts authoritatively at admission."""
        if self._tok is False:
            self._tok = next(
                (t for h in self.replicas
                 if (t := getattr(h.engine, "tokenizer", None))
                 is not None), None)
        if self._tok is not None:
            try:
                if params.raw_prompt:
                    return len(self._tok.encode_prompt(
                        raw_prompt_text(messages)))
                return len(self._tok.apply_chat_template(messages))
            except Exception:
                pass
        chars = sum(len(str(m.get("content") or ""))
                    for m in messages)
        return max(1, chars // 4)

    @staticmethod
    def _safe_parked_info(src: ReplicaHandle,
                          session_id: str) -> tuple[int, int] | None:
        try:
            return src.parked_info(session_id)
        except Exception:
            return None

    async def _disagg_settle(self, request_id: str, session_id: str,
                             src: ReplicaHandle,
                             prefix_key: str | None,
                             ) -> tuple[ReplicaHandle, int, int]:
        """Post-prefill half of a handoff: wait for the async park
        (the D2H fetch lands on the source's offload thread), pick the
        decode replica (radix prefix affinity applies WITHIN the
        decode tier), and move the entry over the migration wire.
        Unbounded by itself — the caller wraps the whole settle in ONE
        ``migrate_timeout_s`` budget, so a hung park, a hung channel
        or the ``router.handoff`` chaos hang all cost at most one
        timeout before the fallback."""
        if _fp.enabled:
            # Chaos seam: the handoff settling — fire_ASYNC (event
            # loop) so delay/hang rules yield instead of freezing
            # every stream; `error` here is a handoff channel fault
            # and must fall back to mixed placement with zero
            # client-visible error frames.
            await _fp.fire_async("router.handoff",
                                 session_id=session_id,
                                 replica=src.replica_id)
        while True:
            info = await asyncio.to_thread(self._safe_parked_info,
                                           src, session_id)
            if info is not None:
                break
            await asyncio.sleep(0.005)
        kept, nbytes = info
        dst, _ = self.policy.place(session_id, self.replicas,
                                   {src.replica_id},
                                   prefix_key=prefix_key,
                                   roles=DECODE_ROLES)
        if dst is None:
            raise LLMServiceError("no decode replica for handoff",
                                  category=ErrorCategory.CONNECTION,
                                  recoverable=True)
        # No pricing re-check here: the transfer was priced on the
        # estimate BEFORE the prefill ran; with the prefill paid, the
        # transfer is the cheap way to finish the job.
        status = await asyncio.to_thread(self._migrate_session,
                                         session_id, src, dst,
                                         request_id)
        if status != "ok":
            raise LLMServiceError(f"handoff transfer {status}",
                                  category=ErrorCategory.CONNECTION,
                                  recoverable=True)
        return dst, kept, nbytes

    async def _disagg_handoff(self, request_id: str, session_id: str,
                              messages: list[dict],
                              params: GenerationParams,
                              prefix_key: str | None,
                              ) -> ReplicaHandle | None:
        """The prefill→handoff→decode lifecycle, client-invisibly: run
        a ``prefill_only`` sub-request on the prefill tier, then (one
        ``migrate_timeout_s`` budget) wait for the parked entry and
        migrate it to a decode replica, which is returned with the
        session pinned to it — the caller's normal placement hits the
        pin and the stream admits via the restore path. Any failure on
        either side returns None: the caller places decode-local and
        re-prefills, so the client sees no error frame, ever."""
        src = self.policy.pick_tier(self.replicas, (ROLE_PREFILL,))
        if src is None:
            self._m_handoff_fallbacks.inc()
            self.disagg.note_fallback()
            return None
        rid = f"{request_id}.prefill"
        t0 = time.monotonic()
        ok = False
        failure = ""
        pf_stats: dict[str, Any] = {}
        self._handoff_streams[request_id] = (src, rid)
        src.inflight.add(rid)
        src.placements += 1
        try:
            async for ev in src.engine.generate(
                    request_id=rid, session_id=session_id,
                    messages=messages,
                    params=_dc_replace(params, prefill_only=True)):
                et = ev.get("type")
                if et == "done":
                    ok = True
                    pf_stats = ev.get("stats") or {}
                elif et in ("error", "cancelled"):
                    failure = str(ev.get("error", et))
        except asyncio.CancelledError:
            src.engine.cancel(rid)
            raise
        except Exception as e:
            failure = str(e)
        finally:
            src.inflight.discard(rid)
            self._handoff_streams.pop(request_id, None)
        if request_id in self._cancelled:
            return None  # the caller's loop emits the cancelled frame
        if ok:
            st = pf_stats
            if st.get("ttft_ms") and st.get("prefill_tokens"):
                # The prefill tier's completions feed the SAME prefill
                # EMA as decode-tier streams: prefill_only TTFT is the
                # chunked prefill wall time, the honest throughput the
                # handoff pricing needs.
                self.kv_policy.note_prefill(
                    int(st["prefill_tokens"]),
                    float(st["ttft_ms"]) / 1000.0)
            t_settle = time.monotonic()
            try:
                dst, kept, nbytes = await asyncio.wait_for(
                    self._disagg_settle(request_id, session_id, src,
                                        prefix_key),
                    timeout=self.migrate_timeout_s)
                dt_ms = (time.monotonic() - t_settle) * 1000.0
                self._m_handoffs.inc()
                self._m_handoff_ms.observe(dt_ms)
                self.disagg.note_handoff(kept, nbytes)
                if self._tracer.enabled:
                    self._tracer.add_span(
                        request_id, "handoff", t0, time.monotonic(),
                        src=src.replica_id, dst=dst.replica_id,
                        kept=kept, bytes=nbytes,
                        settle_ms=round(dt_ms, 2))
                self._events.emit(
                    "router_disagg_handoff", severity="info",
                    session=session_id, src=src.replica_id,
                    dst=dst.replica_id, kept=kept, bytes=nbytes,
                    settle_ms=round(dt_ms, 2))
                return dst
            except asyncio.TimeoutError:
                failure = (f"handoff settle exceeded "
                           f"{self.migrate_timeout_s}s")
            except Exception as e:  # incl. FaultInjected from the seam
                failure = str(e)
        # ---------- fallback to mixed placement ----------
        # The prefill leg died mid-chunk, the settle hung, or the
        # transfer failed: the decode tier re-prefills the prompt —
        # slower, never wrong, and the client sees nothing. A stale
        # parked entry left on the prefill replica ages out by
        # TTL/LRU; the pin (if the settle's place() set one) must not
        # survive, or the next turn would chase KV that never arrived.
        self._m_handoff_fallbacks.inc()
        self.disagg.note_fallback()
        self.affinity.drop(session_id)
        if self._tracer.enabled:
            self._tracer.add_span(request_id, "handoff", t0,
                                  time.monotonic(),
                                  src=src.replica_id, ok=False,
                                  error=failure[:200])
        self._events.emit("router_disagg_fallback", severity="warning",
                          session=session_id, src=src.replica_id,
                          error=failure[:200])
        log.warning(f"[{request_id}] disagg handoff via "
                    f"{src.replica_id} fell back to mixed placement: "
                    f"{failure}")
        return None

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        if self._draining:
            self._m_sheds.inc()
            raise AdmissionRejected(
                "fleet is draining: finishing in-flight requests, not "
                "accepting new ones", retry_after=5.0, reason="draining")
        excluded: set[str] = set()
        delivered = 0          # chars already yielded to the caller
        progress_mark = 0      # delivered at the last failure
        attempt = 0
        resumed_total = 0
        pending_resume = False
        prefix_key = self._prefix_key(messages)
        failed_handle: ReplicaHandle | None = None
        roles = self._decode_roles()
        try:
            if roles is not None and self.migrate_enabled \
                    and params.structured is None \
                    and any(role_of(h) == ROLE_PREFILL
                            and h.available()
                            for h in self.replicas) \
                    and self.disagg.wants_handoff(
                        self._estimate_prompt_tokens(messages, params)):
                # Disaggregated path: long prompt → prefill tier, KV
                # over the wire, session pinned to the decode replica.
                # Success or fallback, the loop below runs unchanged —
                # on success the pin routes it to the decode replica
                # where the restore path admits; on fallback it places
                # decode-local and re-prefills (no error frame either
                # way).
                await self._disagg_handoff(request_id, session_id,
                                           messages, params,
                                           prefix_key)
            while True:
                # A cancel can land while no replica owns the stream —
                # between attempts, or while the generator is suspended
                # yielding the resumed frame. Check at every point we
                # regain control with no replica-side stream to carry
                # the cancel for us.
                if request_id in self._cancelled:
                    yield {"type": "cancelled",
                           "finish_reason": "cancelled", "stats": {}}
                    return
                if _fp.enabled:
                    try:
                        # Chaos seam: a placement fault is what a fully
                        # partitioned fleet looks like — it must
                        # surface as a shed with retry_after
                        # (rate-limit taxonomy, breaker untouched),
                        # never an internal error. fire_ASYNC: this
                        # runs on the event loop, so delay/hang rules
                        # must yield instead of freezing every stream
                        # and the /debug/fault clear path.
                        await _fp.fire_async("router.place",
                                             session_id=session_id)
                    except _fp.FaultInjected as e:
                        self._m_sheds.inc()
                        raise AdmissionRejected(
                            f"placement failed: {e}",
                            retry_after=max(1.0,
                                            self.probe_interval_s
                                            or 1.0),
                            reason="no_replica") from e
                t_place = time.monotonic()
                handle = self._place(session_id, excluded, prefix_key,
                                     roles=roles)
                if self._tracer.enabled:
                    self._tracer.add_span(
                        request_id, "place", t_place, time.monotonic(),
                        replica=handle.replica_id, attempt=attempt,
                        excluded=len(excluded))
                if failed_handle is not None \
                        and failed_handle is not handle:
                    # Failover migration: the dead/failed replica may
                    # still hold this session's parked KV (an in-proc
                    # pool survives its engine thread; a drained
                    # remote still answers /kv). Pulling it to the
                    # survivor BEFORE re-dispatching turns the resume's
                    # transcript re-prefill into a restore + delta
                    # prefill. Bounded by migrate_timeout_s and fully
                    # best-effort — a failure changes nothing.
                    src = failed_handle
                    failed_handle = None
                    if self.migrate_enabled:
                        await asyncio.to_thread(
                            self._failover_migrate, session_id, src,
                            handle, request_id)
                if pending_resume:
                    pending_resume = False
                    resumed_total += 1
                    self._m_resumes.inc()
                    # The stitched-trace resume marker (stitch.py
                    # RESUME_SPAN): exactly one per failover the client
                    # survived, tagged with where the stream landed.
                    self._tracer.event(request_id, "resume",
                                       replica=handle.replica_id,
                                       attempt=attempt)
                    yield {"type": "resumed",
                           "replica": handle.replica_id,
                           "attempt": attempt}
                    if request_id in self._cancelled:
                        yield {"type": "cancelled",
                               "finish_reason": "cancelled",
                               "stats": {}}
                        return
                self._routes[request_id] = (session_id, handle)
                handle.inflight.add(request_id)
                handle.placements += 1
                failure: str | None = None
                skip = delivered
                t0 = self._clock()
                try:
                    async for ev in handle.engine.generate(
                            request_id, session_id, messages, params):
                        et = ev.get("type")
                        if et == "token":
                            text = ev.get("text", "")
                            if skip > 0:  # resume overlap trim
                                if len(text) <= skip:
                                    skip -= len(text)
                                    continue
                                text = text[skip:]
                                skip = 0
                            if not text:
                                continue
                            delivered += len(text)
                            yield {**ev, "text": text}
                        elif et in ("done", "cancelled"):
                            st = ev.get("stats") or {}
                            if et == "done" and st.get("ttft_ms") \
                                    and st.get("prefill_tokens"):
                                # Feed the three-way policy's prefill
                                # EMA from the fleet's own completions
                                # — tokens actually PREFILLED over
                                # TTFT, so the migrate-vs-reprefill
                                # pricing tracks real hardware. NOT
                                # prompt_tokens: a cache-hit turn
                                # prefills only the delta, and pricing
                                # with the full prompt would inflate
                                # the EMA by the hit fraction and turn
                                # migration off exactly in the warm
                                # steady state it serves. Engines that
                                # don't report the field (remote,
                                # fakes) just don't feed the EMA.
                                self.kv_policy.note_prefill(
                                    int(st["prefill_tokens"]),
                                    float(st["ttft_ms"]) / 1000.0)
                            if resumed_total:
                                ev = {**ev,
                                      "stats": {**st,
                                                "resumed": resumed_total}}
                            yield ev
                            return
                        elif et == "error":
                            # code "internal_error" is emitted ONLY by
                            # the engine's crash/shutdown abort path
                            # (_abort_all) — a replica fault even when
                            # check_connection() hasn't flipped yet
                            # (the abort events race the thread's
                            # teardown). Anything else is judged by
                            # liveness: deadline_expired / stalled /
                            # validation errors from a live replica
                            # propagate.
                            if ev.get("code") == "internal_error" \
                                    or not handle.alive():
                                failure = str(ev.get("error", ""))
                                break
                            yield ev  # genuine request error: propagate
                            return
                        else:
                            yield ev  # tool_call etc.: pass through
                except asyncio.CancelledError:
                    handle.engine.cancel(request_id)
                    raise
                except AdmissionRejected:
                    # This replica's queue shed us. A fresh request can
                    # try a less-loaded replica; a resumed stream (or a
                    # fully-excluded fleet) must surface the shed with
                    # its retry_after.
                    excluded.add(handle.replica_id)
                    if delivered == 0 and len(excluded) < len(
                            self.replicas):
                        continue
                    raise
                except LLMServiceError as e:
                    if e.category in _FAULT_CATEGORIES \
                            or not handle.alive():
                        failure = str(e)
                    else:
                        raise
                except Exception as e:
                    if not handle.alive():
                        failure = str(e)
                    else:
                        raise
                finally:
                    handle.inflight.discard(request_id)
                if failure is None:
                    # Stream ended with no terminal event (a replica
                    # torn down mid-yield can do this): same treatment
                    # as an explicit failure.
                    failure = "stream ended without a terminal event"
                # ---------- failover ----------
                died = handle.note_stream_failure()
                self._m_failovers.inc()
                self._tracer.event(request_id, "failover")
                self._events.emit(
                    "router_failover", severity="critical",
                    replica=handle.replica_id, request=request_id,
                    session=session_id, mid_stream=delivered > 0,
                    attempt=attempt, error=failure[:200])
                if died:
                    busy = {sid for sid, hh
                            in list(self._routes.values())
                            if hh is handle}
                    self.affinity.drop_replica(handle.replica_id,
                                               keep=busy)
                    self.policy.drop_replica(handle.replica_id)
                failed_handle = handle
                self._update_gauges()
                log.warning(
                    f"[{request_id}] replica {handle.replica_id} failed "
                    f"{'mid-stream' if delivered else 'pre-token'} "
                    f"(attempt {attempt}): {failure}")
                if request_id in self._cancelled:
                    yield {"type": "cancelled",
                           "finish_reason": "cancelled", "stats": {}}
                    return
                if delivered > progress_mark:
                    # The stream made progress since its last failure,
                    # so earlier exclusions (and spent retries) are
                    # stale: during a rolling restart every replica
                    # fails ONCE but is healthy again by the time a
                    # long-lived stream comes back around —
                    # accumulating them forever would shed a stream
                    # that merely outlives N sequential restarts. Only
                    # the replica that JUST failed is suspect;
                    # back-to-back failures with no progress still
                    # accumulate (no ping-pong between two dying
                    # replicas, and the retry budget still bounds
                    # them).
                    excluded.clear()
                    attempt = 0
                progress_mark = delivered
                excluded.add(handle.replica_id)
                attempt += 1
                if attempt > self.failover_retries:
                    yield {"type": "error",
                           "error": f"replica {handle.replica_id} "
                           f"failed and failover retries exhausted: "
                           f"{failure}",
                           "code": "replica_failed"}
                    return
                if delivered > 0:
                    if params.structured is not None:
                        # Constrained stream (docs/STRUCTURED.md): a
                        # resume re-generates the document on the
                        # survivor, and splicing a NEW document onto
                        # already-delivered text would hand the client
                        # invalid output — the one thing structured
                        # mode promises never happens. Fail the stream
                        # instead; pre-first-token failover above
                        # still re-routes silently.
                        yield {"type": "error",
                               "error": f"replica {handle.replica_id} "
                               "died mid-stream of a structured "
                               "generation (resume would break the "
                               f"validity contract): {failure}",
                               "code": "replica_failed"}
                        return
                    if not self.resume_enabled:
                        yield {"type": "error",
                               "error": f"replica {handle.replica_id} "
                               f"died mid-stream (resume disabled): "
                               f"{failure}",
                               "code": "replica_failed"}
                        return
                    # Affinity moves with the resume: the survivor
                    # re-prefills the transcript and becomes the
                    # session's home.
                    pending_resume = True
                self._tracer.add_span(request_id, "failover", t0,
                                      self._clock(),
                                      replica=handle.replica_id,
                                      mid_stream=delivered > 0)
        finally:
            self._routes.pop(request_id, None)
            self._cancelled.discard(request_id)

    # ---------------- EngineBase surface ----------------

    def cancel(self, request_id: str) -> bool:
        # Mark first: a cancel landing between failover attempts (no
        # replica owns the stream at that instant) must still terminate
        # the retry loop.
        self._cancelled.add(request_id)
        # A cancel during a disagg handoff's prefill leg: the client's
        # request_id never reaches the prefill replica (the sub-request
        # runs as "<id>.prefill"), so forward the cancel there — the
        # handoff aborts, and the outer loop emits the cancelled frame.
        handoff = self._handoff_streams.get(request_id)
        if handoff is not None:
            src, rid = handoff
            try:
                src.engine.cancel(rid)
            except Exception:
                pass
        route = self._routes.get(request_id)
        if route is not None:
            try:
                return bool(route[1].engine.cancel(request_id))
            except Exception:
                return False
        return False

    def release_session(self, session_id: str) -> None:
        self.affinity.drop(session_id)
        # Fan out: a failed-over session may have parked KV on more
        # than one replica (release is idempotent everywhere).
        for h in self.replicas:
            try:
                h.engine.release_session(session_id)
            except Exception:
                pass

    def check_connection(self) -> bool:
        return self._started and any(h.available() and h.alive()
                                     for h in self.replicas)

    def get_model_info(self) -> dict:
        info: dict[str, Any] = {}
        for h in self.replicas:
            try:
                info = dict(h.engine.get_model_info())
                break
            except Exception:
                continue
        info["fleet_size"] = len(self.replicas)
        info["router"] = True
        return info

    def get_stats(self) -> dict:
        per_replica = {}
        waiting = running = 0
        for h in self.replicas:
            stats = self._safe(h, "get_stats", {}) or {}
            per_replica[h.replica_id] = {
                "state": h.state, "draining": h.draining,
                "role": role_of(h),
                "inflight": len(h.inflight),
                "waiting": stats.get("waiting", 0),
            }
            waiting += int(stats.get("waiting", 0) or 0)
            running += int(stats.get("running", 0) or 0)
        return {
            "router": {
                "replicas": len(self.replicas),
                "available": sum(1 for h in self.replicas
                                 if h.available()),
                "dead": sum(1 for h in self.replicas
                            if h.state == STATE_DEAD),
                "affinity_sessions": len(self.affinity),
                "placements": self._m_placements.value,
                "affinity_hits": self._m_affinity_hits.value,
                "failovers": self._m_failovers.value,
                "resumes": self._m_resumes.value,
                "sheds": self._m_sheds.value,
                "migrations": self._m_migrations.value,
                "migration_failures": self._m_migration_failures.value,
                "draining": self._draining,
            },
            "per_replica": per_replica,
            "waiting": waiting,
            "running": running,
        }

    def fleet_stats(self) -> dict:
        """The /fleet endpoint's body: registry view with live scores."""
        replicas = []
        for h in self.replicas:
            d = h.to_dict()
            score = h.load_score()
            d["load_score"] = (None if score == float("inf")
                               else round(score, 3))
            replicas.append(d)
        return {
            "replicas": replicas,
            "affinity_sessions": len(self.affinity),
            "draining": self._draining,
            # A drain that failed on some replica is a PARTIAL drain:
            # operators watching /fleet see which handle is stuck
            # (drain_error per replica) instead of a silent log line.
            "partial_drain": any(h.drain_error is not None
                                 for h in self.replicas),
            "migration": {
                "enabled": self.migrate_enabled,
                "timeout_s": self.migrate_timeout_s,
                "policy": self.kv_policy.stats(),
            },
            # Disaggregated serving view (docs/ROUTER.md): per-role
            # tier aggregates (queue depth and slot occupancy per
            # tier — the elastic scaler's signals) plus the handoff
            # controller's counters and learned wire-cost model.
            "disagg": {
                "tiers": tier_stats(self.replicas),
                **self.disagg.stats(),
            },
            "counters": {
                "placements": self._m_placements.value,
                "affinity_hits": self._m_affinity_hits.value,
                "failovers": self._m_failovers.value,
                "resumes": self._m_resumes.value,
                "sheds": self._m_sheds.value,
                "migrations": self._m_migrations.value,
                "migration_failures": self._m_migration_failures.value,
                "migration_bytes": self._m_migration_bytes.value,
                "drain_errors": self._m_drain_errors.value,
                "partitions": self._m_partitions.value,
                "prefix_colocations": self._m_prefix.value,
            },
        }

    # ---------------- fleet observability (docs/OBSERVABILITY.md
    # "Fleet tracing and the token journey") ----------------
    # All three fan out over synchronous HTTP to remote replicas —
    # callers on an event loop must run them off-loop (the serving and
    # monitoring routes do).

    def stitched_trace(self, request_id: str) -> dict[str, Any] | None:
        """ONE cross-replica timeline for a request: local fragments
        (router + serving + any in-proc replica, all in this process's
        tracer) joined with every remote replica's fragments fetched
        over its serving port. None when nobody remembers the id."""
        from fasttalk_tpu_torch.observability.stitch import (collect_fragments,
                                                             stitch)

        frags = collect_fragments(get_tracer(), request_id,
                                  source="router")
        trace_id = frags[0].get("trace_id", "") if frags else ""
        for h in self.replicas:
            try:
                frags.extend(h.fetch_trace(request_id, trace_id))
            except Exception as e:
                log.debug(f"trace fetch from {h.replica_id} failed "
                          f"for {request_id}: {e}")
        return stitch(frags)

    def fleet_metrics(self) -> str:
        """Label-merged Prometheus exposition across the fleet (export
        merge_prometheus): the local registry — router + serving + any
        in-proc replicas, which share it — as ``replica="router"``,
        each remote replica's /metrics under its own label, histograms
        summed. Unreachable replicas become free comments, never a
        broken scrape."""
        from fasttalk_tpu_torch.observability.export import merge_prometheus

        remotes: dict[str, str | None] = {}
        for h in self.replicas:
            if not hasattr(h, "base_url"):
                continue  # in-proc: already in the local registry
            try:
                remotes[h.replica_id] = h.fetch_metrics()
            except Exception:
                remotes[h.replica_id] = None
        return merge_prometheus(get_metrics().prometheus(), "router",
                                remotes)

    def fleet_slo(self) -> dict[str, Any]:
        """Fleet SLO rollup: the local engine's report (shared by the
        router front and in-proc replicas) plus each remote replica's
        /slo, with the worst alert across the fleet on top."""
        from fasttalk_tpu_torch.observability.slo import get_slo

        rank = ("ok", "warn", "page").index
        engine = get_slo()
        local = engine.snapshot()
        worst = max(list(engine.alert_summary().values()) or ["ok"],
                    key=lambda s: rank(s) if s in ("ok", "warn",
                                                   "page") else 0)
        replicas: dict[str, Any] = {}
        for h in self.replicas:
            if hasattr(h, "base_url"):
                try:
                    report = h.fetch_slo()
                except Exception:
                    report = None
                alert = h.last_probe.get("slo_alert", "ok")
                replicas[h.replica_id] = {"alert": alert,
                                          "report": report}
                if alert in ("warn", "page") \
                        and rank(alert) > rank(worst):
                    worst = alert
            else:
                replicas[h.replica_id] = {"shared_process": True}
        return {"worst_alert": worst, "local": local,
                "replicas": replicas}

    @staticmethod
    def _safe(h: ReplicaHandle, method: str, default):
        try:
            return getattr(h.engine, method)()
        except Exception:
            return default


def build_fleet(cfg, device=None) -> FleetRouter:
    """Construct the configured fleet: ``FLEET_REPLICAS`` in-process
    engine replicas (each its own engine instance on ``device``, which
    ``build_engine`` resolves: ``cuda`` unless the caller asks for the
    CPU) plus one remote replica per ``ROUTER_BACKENDS`` URL (other
    FastTalk servers, reached through the existing remote.py client
    protocol)."""
    from dataclasses import replace as dc_replace

    from fasttalk_tpu_torch.engine.factory import build_engine

    inproc_roles = parse_roles(getattr(cfg, "fleet_roles", ""),
                               cfg.fleet_replicas, "FLEET_ROLES")
    handles: list[ReplicaHandle] = []
    for i in range(cfg.fleet_replicas):
        role = inproc_roles[i]
        ecfg = cfg
        if role == ROLE_PREFILL:
            # A prefill-role replica is a batch machine, not a latency
            # machine: deepen its admission queue (long prefills WAIT
            # there, by design — the whole point is that the waiting
            # happens away from decode streams). Slots stay as
            # configured — chunked prefill occupies one slot per
            # request and the engine rejects decode streams by role.
            ecfg = dc_replace(cfg, sched_queue_bound=4
                              * cfg.sched_queue_bound)
        engine = build_engine(ecfg, device=device)
        # Component tagging: in-proc replicas share the process tracer,
        # so the replica id on each span is what keeps a stitched
        # trace's fragments attributable (observability/stitch.py).
        engine.set_trace_component(f"inproc-{i}")
        handles.append(ReplicaHandle(
            f"inproc-{i}", engine, role=role,
            dead_probes=cfg.router_dead_probes))
    urls = [u.strip() for u in cfg.router_backends.split(",")
            if u.strip()]
    remote_roles = parse_roles(getattr(cfg, "router_backend_roles", ""),
                               len(urls), "ROUTER_BACKEND_ROLES")
    for i, url in enumerate(urls):
        handle = RemoteReplicaHandle(
            f"remote-{i}", url, cfg.model_name,
            role=remote_roles[i],
            dead_probes=cfg.router_dead_probes,
            timeout_s=cfg.vllm_timeout,
            max_inflight=cfg.remote_max_inflight,
            admission_timeout_s=cfg.sched_default_deadline_s,
            connect_retries=cfg.remote_connect_retries)
        handle.engine.set_trace_component(f"remote-{i}")
        handles.append(handle)
    return FleetRouter(
        handles,
        probe_interval_s=cfg.router_probe_interval_s,
        affinity_ttl_s=cfg.router_affinity_ttl_s,
        failover_retries=cfg.router_failover_retries,
        resume=cfg.router_resume,
        migrate=cfg.router_migrate,
        migrate_timeout_s=cfg.router_migrate_timeout_s,
        prefix_affinity=cfg.router_prefix_affinity,
        disagg_prefill_min_tokens=getattr(
            cfg, "disagg_prefill_min_tokens", 512))
