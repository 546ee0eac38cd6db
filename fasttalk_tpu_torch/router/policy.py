"""Placement policy: session affinity first, weighted-least-loaded else.

A copy of ``fasttalk_tpu/router/policy.py`` (the port imports nothing of the JAX
package); the two behave the same on the same inputs.

Affinity is the fleet-level mirror of the engine's KV residency story
(docs/KVCACHE.md): a session's resident or host-parked KV lives on ONE
replica, so routing its next turn anywhere else throws away the host-KV
restore path and re-prefills the whole history. The map is therefore
sticky for ``ttl_s`` of idleness (default matches KV_PARK_TTL_S — once
the parked entry has expired server-side there is nothing left to be
sticky to) and is dropped on release_session, replica death, and
replica drain.

New sessions place by weighted least-loaded: each candidate's
``load_score()`` (queue depth + live in-flight + overload/SLO
penalties, replica.py) is compared and the minimum wins; ties break by
rotation so equal replicas share arrivals instead of all landing on
index 0.

Shared-prefix affinity (the fleet mirror of the engine's block-
aliasing/prefix-stamp tier, docs/KVCACHE.md): sessions carrying the
same system prompt CO-LOCATE when it is nearly free — the placement
remembers which replica last served each ``prefix_key`` and prefers it
while its load score is within ``PREFIX_SLACK`` of the best candidate.
On the preferred replica the new session's prompt prefix is already
device-resident (alias stamp: zero row copies on the paged tier), so a
small amount of extra queue is cheaper than a cold prefill elsewhere;
past the slack, load wins — prefix affinity must never pile a hot
tenant onto one replica.

Thread-safety: placement runs on the asyncio loop while the probe
thread reads for pruning — one lock, a few dict ops.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Iterable

from fasttalk_tpu_torch.router.replica import ReplicaHandle


class AffinityMap:
    """session_id → (replica_id, last_used) with TTL eviction."""

    def __init__(self, ttl_s: float = 600.0, clock=time.monotonic):
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._map: dict[str, tuple[str, float]] = {}

    def get(self, session_id: str) -> str | None:
        now = self._clock()
        with self._lock:
            entry = self._map.get(session_id)
            if entry is None:
                return None
            replica_id, last = entry
            if now - last > self.ttl_s:
                del self._map[session_id]
                return None
            return replica_id

    def set(self, session_id: str, replica_id: str) -> None:
        with self._lock:
            self._map[session_id] = (replica_id, self._clock())

    def touch(self, session_id: str) -> None:
        with self._lock:
            entry = self._map.get(session_id)
            if entry is not None:
                self._map[session_id] = (entry[0], self._clock())

    def drop(self, session_id: str) -> None:
        with self._lock:
            self._map.pop(session_id, None)

    def drop_replica(self, replica_id: str,
                     keep: Iterable[str] = ()) -> list[str]:
        """Forget every session pinned to ``replica_id`` except those in
        ``keep`` (sessions with a stream still finishing there during a
        drain). Returns the dropped session ids."""
        keep = set(keep)
        with self._lock:
            dropped = [sid for sid, (rid, _) in self._map.items()
                       if rid == replica_id and sid not in keep]
            for sid in dropped:
                del self._map[sid]
            return dropped

    def prune(self) -> int:
        """TTL sweep (probe-thread housekeeping). Returns #evicted."""
        now = self._clock()
        with self._lock:
            stale = [sid for sid, (_, last) in self._map.items()
                     if now - last > self.ttl_s]
            for sid in stale:
                del self._map[sid]
            return len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def snapshot(self) -> dict[str, str]:
        with self._lock:
            return {sid: rid for sid, (rid, _) in self._map.items()}


class PlacementPolicy:
    """Affinity-then-prefix-then-least-loaded placement."""

    # How much extra load score a prefix co-location may cost: one
    # queued request's worth. Past this, spreading wins — a hot tenant
    # must not pile onto one replica just to share a system prompt.
    PREFIX_SLACK = 1.0
    # prefix_key → replica_id memory is a bounded LRU: tenant count is
    # unbounded, the placement hint is best-effort.
    PREFIX_CAP = 512

    def __init__(self, affinity: AffinityMap,
                 prefix_affinity: bool = True,
                 on_prefix_hit=None):
        self.affinity = affinity
        self.prefix_affinity = prefix_affinity
        self._on_prefix_hit = on_prefix_hit
        self._prefix: "OrderedDict[str, str]" = OrderedDict()
        self._rr = 0  # tie-break rotation counter
        self._lock = threading.Lock()

    def drop_replica(self, replica_id: str) -> None:
        """Forget prefix hints pointing at a dead/drained/removed
        replica (the affinity map's drop_replica is separate)."""
        with self._lock:
            for key in [k for k, rid in self._prefix.items()
                        if rid == replica_id]:
                del self._prefix[key]

    @staticmethod
    def pick_tier(replicas: list[ReplicaHandle],
                  roles: tuple[str, ...],
                  exclude: frozenset[str] | set[str] = frozenset(),
                  ) -> ReplicaHandle | None:
        """Least-loaded available replica within a role tier, with NO
        affinity or prefix side effects — the prefill side of a
        disagg handoff (router/disagg.py) is transient by design: the
        session must end up pinned to its DECODE replica, where the
        migrated KV lives, never to the prefill replica that computed
        it."""
        candidates = [h for h in replicas
                      if h.available() and h.replica_id not in exclude
                      and getattr(h, "role", "mixed") in roles]
        if not candidates:
            return None
        return min(candidates, key=lambda h: h.load_score())

    def place(self, session_id: str, replicas: list[ReplicaHandle],
              exclude: frozenset[str] | set[str] = frozenset(),
              prefix_key: str | None = None,
              roles: tuple[str, ...] | None = None,
              ) -> tuple[ReplicaHandle | None, bool]:
        """Pick a replica for one request. Returns (handle, affine) —
        ``affine`` True when the session's pinned replica served (KV
        reuse preserved); None when no replica is placeable.
        ``prefix_key`` identifies the request's shared prefix (system
        prompt hash) for co-location. ``roles`` restricts candidates
        to replicas of those roles (disaggregated serving,
        router/disagg.py: decode streams place on the decode/mixed
        tier — a pin pointing at a prefill-role replica is ignored,
        never followed); None = role-blind (today's behaviour)."""
        def _role_ok(h: ReplicaHandle) -> bool:
            return roles is None or getattr(h, "role", "mixed") in roles

        by_id = {h.replica_id: h for h in replicas}
        pinned = self.affinity.get(session_id)
        if pinned is not None and pinned not in exclude:
            h = by_id.get(pinned)
            if h is not None and h.available() and _role_ok(h):
                self.affinity.touch(session_id)
                return h, True
        candidates = [h for h in replicas
                      if h.available() and h.replica_id not in exclude
                      and _role_ok(h)]
        if not candidates:
            return None, False
        scored = [(h.load_score(), h) for h in candidates]
        best = min(s for s, _ in scored)
        chosen: ReplicaHandle | None = None
        if self.prefix_affinity and prefix_key is not None:
            with self._lock:
                hinted = self._prefix.get(prefix_key)
            if hinted is not None:
                for s, h in scored:
                    if h.replica_id == hinted \
                            and s <= best + self.PREFIX_SLACK:
                        chosen = h
                        if self._on_prefix_hit is not None:
                            self._on_prefix_hit()
                        break
        if chosen is None:
            tied = [h for s, h in scored if s == best]
            with self._lock:
                chosen = tied[self._rr % len(tied)]
                self._rr += 1
        if self.prefix_affinity and prefix_key is not None:
            with self._lock:
                self._prefix[prefix_key] = chosen.replica_id
                self._prefix.move_to_end(prefix_key)
                while len(self._prefix) > self.PREFIX_CAP:
                    self._prefix.popitem(last=False)
        self.affinity.set(session_id, chosen.replica_id)
        return chosen, False
