"""Disaggregated prefill/decode serving: replica roles over the KV
migration wire (docs/ROUTER.md "Disaggregated prefill/decode").

A copy of ``fasttalk_tpu/router/disagg.py`` (the port imports nothing of the JAX
package); the two behave the same on the same inputs.

Long prefills and decode streams interfere when they share a replica:
one 32k-token prefill chunk sits in front of every co-resident decode
step, and the decode streams' inter-token latency pays for it.
DistServe (OSDI'24) and Splitwise (ISCA'24) remove the interference by
splitting the two phases onto separate pools; the fleet fabric already
has the hard part — a session's KV moves between replica pools over
``/kv/parked`` with three-way migrate/re-prefill/restore pricing
(router/migrate.py, kvcache/policy.py) — so the split here is thin:

- Each replica carries a **role** — ``prefill`` | ``decode`` |
  ``mixed`` (``FLEET_ROLES`` / ``ROUTER_BACKEND_ROLES``; empty =
  all-mixed, byte-identical to the pre-disagg fleet). A prefill-role
  replica runs long-context chunked prefill with a deep queue and
  ZERO decode slots (the engine rejects anything but ``prefill_only``
  requests); decode/mixed replicas serve streams.
- The router routes a new stream whose estimated prompt length clears
  ``DISAGG_PREFILL_MIN_TOKENS`` through the **handoff**: a
  ``prefill_only`` sub-request runs on the prefill tier, parks the
  finished KV, and the parked entry migrates to a decode replica where
  the stream admits via the restore path. Short prompts place
  decode-local; radix ``prefix_key`` affinity still applies within the
  decode tier.
- The handoff is **priced** by the same EMAs as every other migration:
  expected transfer bytes (a learned bytes-per-token EMA times the
  prompt estimate) against re-prefilling on the decode tier. When the
  transfer costs more than the interference it saves (tiny prompts,
  cold or wedged channel), the stream falls back to mixed placement —
  the subsystem degrades to today's behaviour, never adds a cliff.

This module holds the role vocabulary, the per-tier aggregation the
/fleet endpoint and the elastic scaler read, and the pricing
controller; the orchestration (one client-invisible stream across the
prefill→handoff→decode lifecycle) lives in ``FleetRouter``.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable

__all__ = ["ROLES", "ROLE_PREFILL", "ROLE_DECODE", "ROLE_MIXED",
           "DECODE_ROLES", "parse_roles", "role_of", "tier_stats",
           "DisaggController"]

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)
# Roles that may serve a decode stream (normal placement tier).
DECODE_ROLES = (ROLE_DECODE, ROLE_MIXED)

# Cold-start wire footprint of one prefilled token's KV rows. Real
# values depend on geometry/quantization and are learned from the
# first completed handoff; the cold default is deliberately small so
# the first long prefill takes the handoff path (handing off is also
# what produces the first measurement — the same cold-start philosophy
# as the RestorePolicy bandwidth EMAs).
_DEFAULT_BYTES_PER_TOKEN = 4096.0


def parse_roles(spec: str, count: int, what: str = "fleet") -> list[str]:
    """``"prefill,decode,decode"`` → validated role list of exactly
    ``count`` entries (empty spec = all-mixed). Raises ValueError with
    a named reason — Config.validate and build_fleet share this so a
    bad spec is one error message, not two behaviours."""
    if not spec.strip():
        return [ROLE_MIXED] * count
    roles = [r.strip().lower() for r in spec.split(",")]
    bad = [r for r in roles if r not in ROLES]
    if bad:
        raise ValueError(f"invalid replica role(s) {bad!r} for {what} "
                         f"(each must be one of {'|'.join(ROLES)})")
    if len(roles) != count:
        raise ValueError(f"{what} role list has {len(roles)} entries "
                         f"but {count} replica(s) are configured — one "
                         "role per replica, in order")
    return roles


def role_of(handle) -> str:
    """A replica handle's role; handles built before roles existed
    (tests constructing ReplicaHandle directly) default to mixed."""
    return getattr(handle, "role", ROLE_MIXED)


def tier_stats(replicas: Iterable[Any]) -> dict[str, dict[str, Any]]:
    """Per-role aggregates from the replicas' latest probe signals —
    the view ``GET /fleet`` surfaces and the elastic scaler's per-tier
    signals read: prefill scales on aggregate queue depth, decode on
    slot occupancy. Only roles present in the fleet appear."""
    tiers: dict[str, dict[str, Any]] = {}
    for h in replicas:
        t = tiers.setdefault(role_of(h), {
            "replicas": 0, "available": 0, "waiting": 0,
            "running": 0, "slots_total": 0, "inflight": 0})
        p = h.last_probe
        t["replicas"] += 1
        t["available"] += 1 if h.available() else 0
        t["waiting"] += int(p.get("waiting", 0) or 0)
        t["running"] += int(p.get("running", 0) or 0)
        t["slots_total"] += int(p.get("slots_total") or 0)
        t["inflight"] += len(h.inflight)
    for t in tiers.values():
        t["occupancy"] = (round(t["running"] / t["slots_total"], 3)
                          if t["slots_total"] else None)
    return tiers


class DisaggController:
    """The handoff decision + its learned wire-cost model.

    Owns no replicas and no orchestration — just the two questions the
    router asks per new stream: *is this prompt long enough for the
    prefill tier* (``DISAGG_PREFILL_MIN_TOKENS``) and *does the priced
    transfer beat re-prefilling on the decode tier* (the shared
    RestorePolicy EMAs, with expected bytes = prompt estimate times a
    bytes-per-token EMA learned from completed handoffs)."""

    def __init__(self, kv_policy, prefill_min_tokens: int = 512):
        self.kv_policy = kv_policy
        self.prefill_min_tokens = max(1, int(prefill_min_tokens))
        self._lock = threading.Lock()
        self._bytes_per_token = 0.0  # learned from completed handoffs
        self.handoffs = 0
        self.fallbacks = 0

    def bytes_per_token(self) -> float:
        with self._lock:
            return self._bytes_per_token or _DEFAULT_BYTES_PER_TOKEN

    def wants_handoff(self, est_tokens: int) -> bool:
        """True when a prompt of ``est_tokens`` should take the
        prefill-tier handoff path: long enough to interfere with
        decode, and the priced transfer (wire + target H2D copy)
        beats recomputing it decode-local. A ``False`` here IS the
        documented fallback to mixed placement."""
        if est_tokens < self.prefill_min_tokens:
            return False
        est_bytes = int(est_tokens * self.bytes_per_token())
        return self.kv_policy.decide(est_tokens, est_bytes,
                                     local=False,
                                     migratable=True) == "migrate"

    def note_handoff(self, kept_tokens: int, nbytes: int) -> None:
        """Feed the wire-cost model from one completed handoff (the
        migrated entry's real trusted-row count and byte size)."""
        if kept_tokens <= 0 or nbytes <= 0:
            return
        bpt = nbytes / kept_tokens
        with self._lock:
            self._bytes_per_token = bpt \
                if self._bytes_per_token == 0.0 \
                else 0.8 * self._bytes_per_token + 0.2 * bpt
            self.handoffs += 1

    def note_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "prefill_min_tokens": self.prefill_min_tokens,
                "bytes_per_token": round(
                    self._bytes_per_token or _DEFAULT_BYTES_PER_TOKEN,
                    1),
                "handoffs": self.handoffs,
                "fallbacks": self.fallbacks,
            }
