"""The park/restore decision: copy cost vs prefill cost.

A copy of ``fasttalk_tpu/kvcache/policy.py`` (the port imports nothing of
the JAX package). On the port the copy bandwidth is the offload thread's
CUDA-event time of each device-to-host park copy.

A restore pays one host→device copy of the parked rows; the
alternative pays recomputing the same rows through the model; the
fleet fabric (docs/ROUTER.md) adds a third option — pull the parked
entry over the network from another replica's pool, paying transfer
plus copy (``decide`` prices all three). Costs are estimated from the
engine's OWN measurements — host-copy
bandwidth from the offload thread's device→host fetches, prefill
throughput from completed prefills — so the decision tracks the actual
hardware (a relayed dev attach and a real v5e differ by orders of
magnitude) instead of a hardcoded constant. Cold start is deliberately
restore-friendly: until the first prefill is measured, any matched
prefix above the floor restores (restoring is also what *produces* the
first copy measurement).

Falling through is always safe: the admission path continues into the
existing shared-prefix / delta-prefill machinery unchanged.
"""

from __future__ import annotations

import os
import threading
from typing import Any

# Cold-start estimates. Copy bandwidth is deliberately conservative
# (PCIe-ish, not the relay's worst case); prefill throughput is
# deliberately low so the first decisions favour restore.
_DEFAULT_COPY_BPS = 1e9
_DEFAULT_PREFILL_TPS = 500.0
# Cross-replica migration cold start: NIC-ish, well under the local
# copy bandwidth — deliberately still fast enough that a long parked
# session's first failover migrates (migrating is also what produces
# the first bandwidth measurement, mirroring the restore cold start).
_DEFAULT_MIGRATE_BPS = 2e8


def kv_env_defaults() -> dict[str, float]:
    """KV_* env knobs with their defaults — the same resolution
    utils.config.Config performs, for engines constructed directly
    (tests, bench) without a Config. Invalid values fall back silently
    here; Config's validated surface is where operators get errors."""
    def _f(name: str, default: float) -> float:
        raw = os.getenv(name, "").strip()
        try:
            return float(raw) if raw else default
        except ValueError:
            return default

    return {
        "budget_mb": _f("KV_HOST_BUDGET_MB", 0.0),
        "ttl_s": _f("KV_PARK_TTL_S", 600.0),
        "idle_s": _f("KV_PARK_IDLE_S", 30.0),
        "min_tokens": _f("KV_RESTORE_MIN_TOKENS", 32.0),
    }


class RestorePolicy:
    """EMA-backed cost model deciding restore-vs-prefill."""

    def __init__(self, min_tokens: int = 32):
        self.min_tokens = max(1, int(min_tokens))
        self._lock = threading.Lock()
        self._copy_bps = 0.0      # measured host-copy bytes/s EMA
        self._prefill_tps = 0.0   # measured prefill tokens/s EMA
        self._migrate_bps = 0.0   # measured replica-to-replica bytes/s

    # ---------------- measurement feeds ----------------

    def note_copy(self, nbytes: int, seconds: float) -> None:
        """One completed device↔host KV copy (offload thread)."""
        if seconds <= 0 or nbytes <= 0:
            return
        bps = nbytes / seconds
        with self._lock:
            self._copy_bps = bps if self._copy_bps == 0.0 \
                else 0.8 * self._copy_bps + 0.2 * bps

    def note_prefill(self, tokens: int, seconds: float) -> None:
        """One completed prefill (engine thread, at activation)."""
        if seconds <= 0 or tokens <= 0:
            return
        tps = tokens / seconds
        with self._lock:
            self._prefill_tps = tps if self._prefill_tps == 0.0 \
                else 0.8 * self._prefill_tps + 0.2 * tps

    def note_migrate(self, nbytes: int, seconds: float) -> None:
        """One completed cross-replica migration transfer (router's
        migrate worker): export + wire + import, end to end."""
        if seconds <= 0 or nbytes <= 0:
            return
        bps = nbytes / seconds
        with self._lock:
            self._migrate_bps = bps if self._migrate_bps == 0.0 \
                else 0.8 * self._migrate_bps + 0.2 * bps

    # ---------------- decisions ----------------

    def _costs(self, match_tokens: int, nbytes: int) -> tuple[float, float]:
        with self._lock:
            bps = self._copy_bps or _DEFAULT_COPY_BPS
            tps = self._prefill_tps or _DEFAULT_PREFILL_TPS
        return nbytes / bps, match_tokens / tps

    def should_restore(self, match_tokens: int, nbytes: int) -> bool:
        """Restore when the estimated copy beats recomputing the
        matched prefix. Below the token floor the fixed dispatch cost
        dominates either estimate — fall through to prefill (where the
        shared-prefix copy may still serve the rows for free)."""
        if match_tokens < self.min_tokens:
            return False
        copy_s, prefill_s = self._costs(match_tokens, nbytes)
        return copy_s < prefill_s

    def decide(self, match_tokens: int, nbytes: int, *,
               local: bool = True, migratable: bool = False) -> str:
        """The three-way decision the fleet fabric prices: restore the
        entry from THIS replica's host pool ("restore"), pull it over
        the network from another replica's pool then restore it
        ("migrate"), or recompute the matched prefix ("prefill").
        ``local``/``migratable`` gate which options exist — the router
        calls with local=False (the entry is on the dying/draining
        replica, not the target); the engine's own admission path is
        the local=True, migratable=False case should_restore covers.
        Migration pays the transfer AND the target's host→device copy;
        below the token floor the fixed dispatch cost dominates every
        estimate and prefill wins outright."""
        if match_tokens < self.min_tokens:
            return "prefill"
        with self._lock:
            bps = self._copy_bps or _DEFAULT_COPY_BPS
            tps = self._prefill_tps or _DEFAULT_PREFILL_TPS
            mbps = self._migrate_bps or _DEFAULT_MIGRATE_BPS
        restore_s = nbytes / bps
        options = {"prefill": match_tokens / tps}
        if local:
            options["restore"] = restore_s
        if migratable:
            options["migrate"] = nbytes / mbps + restore_s
        return min(options, key=options.get)

    def restore_saving_s(self, match_tokens: int, nbytes: int) -> float:
        """Expected seconds saved by restoring instead of prefilling
        the matched prefix (0 when restore would not be chosen) — the
        scheduler subtracts this from its queue-wait estimate at
        admission (scheduling/scheduler.py submit)."""
        if match_tokens < self.min_tokens:
            return 0.0
        copy_s, prefill_s = self._costs(match_tokens, nbytes)
        return max(0.0, prefill_s - copy_s)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "min_tokens": self.min_tokens,
                "copy_bytes_per_s": round(self._copy_bps, 1),
                "prefill_tokens_per_s": round(self._prefill_tps, 1),
                "migrate_bytes_per_s": round(self._migrate_bps, 1),
            }
