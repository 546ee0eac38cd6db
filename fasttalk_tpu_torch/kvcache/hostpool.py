"""Budgeted host-RAM pool of parked session KV entries.

A copy of ``fasttalk_tpu/kvcache/hostpool.py`` (the port imports nothing
of the JAX package) whose entries hold pinned host tensors instead of
numpy arrays, so a restore is a true asynchronous host-to-device copy;
``entry_problem`` and the byte counts read numpy views of them
(``host_array``).

One entry per session: the kept-length KV rows (already copied off the
device; the offload copy thread waited for the copy's CUDA event) plus
the token ids those rows encode. The pool is the *only* owner of parked
bytes, so its accounting is exact: entries enter through ``put`` (which
enforces the ``KV_HOST_BUDGET_MB`` budget with LRU eviction), leave
through ``take``/``purge``/TTL sweep, and every transition updates the
``kv_host_*`` gauges.

Thread-safety: the offload copy thread inserts, the engine thread
consumes, and the monitoring port reads — one lock serialises the few
dict ops. Entries are immutable after construction (arrays and token
lists are never mutated in place), so readers may use a popped entry
outside the lock.

The pool holds host memory only (the JAX engine keeps it across
``engine.restart()``, which the port does not carry yet).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("kvcache.hostpool")


@dataclass
class ParkedKV:
    """One session's parked KV: ``kept`` trusted rows stored in a
    power-of-two ``bucket`` (rows beyond ``kept`` are padding/stale and
    never trusted — restore sets ``kv_written`` to the matched prefix,
    exactly like the engine's watermark discipline)."""

    session_id: str
    tokens: list[int]            # kept token ids (len == kept)
    kept: int                    # trusted KV rows
    bucket: int                  # stored row length (>= kept)
    k: Any                       # pinned host tensor [L, rows, Kv, H]
    v: Any                       # pinned host tensor [L, rows, Kv, H]
    nbytes: int                  # honest host-RAM footprint (bucketed;
    #   int8 rows + scale rows under KV_QUANT=int8 — the budget and
    #   the kv_host_bytes gauge see quantized bytes, so the same
    #   KV_HOST_BUDGET_MB parks ~2x the sessions)
    parked_at: float = field(default_factory=time.monotonic)
    last_used: float = field(default_factory=time.monotonic)
    # Best-effort device-staged copies (offload.prestage): uploaded on
    # the copy thread while the request waits in the admission queue so
    # the restore dispatch pays no host→device transfer.
    k_dev: Any = None
    v_dev: Any = None
    # The CUDA event that completes the staged upload (recorded on the
    # copy thread's stream); the restore's stream waits on it.
    staged_event: Any = None
    # Device bytes the staged copies actually hold. On the paged tier
    # the host entry is TRIMMED to exact block rows but the staged
    # arrays pad back to ``bucket`` — the prestage HBM cap must count
    # the padded footprint, not the trimmed one (0 = not staged;
    # dense entries stage exactly nbytes).
    staged_nbytes: int = 0
    # Quantized tier (KV_QUANT=int8): per-row float32 scales
    # [L, bucket, G] riding alongside the int8 rows (None on the bf16
    # tier), plus their prestaged device copies.
    k_scale: Any = None
    v_scale: Any = None
    k_scale_dev: Any = None
    v_scale_dev: Any = None
    # True when the entry arrived over the fleet migration wire
    # (import_parked_kv) rather than from this replica's own park
    # path. The restore path donates IMPORTED prefixes into the radix
    # tree at admission — the decode tier builds its prefix cache from
    # handed-off prefills, not only its own traffic (router/disagg.py).
    imported: bool = False


def strip_device(entry: ParkedKV) -> ParkedKV:
    """A copy of an entry safe to hand to another replica (fleet KV
    migration, router/migrate.py): device-staged buffers (prestage
    uploads) belong to the SOURCE replica's HBM and must never travel
    with the host bytes."""
    from dataclasses import replace

    return replace(entry, k_dev=None, v_dev=None, k_scale_dev=None,
                   v_scale_dev=None, staged_nbytes=0, staged_event=None)


def host_array(arr: Any):
    """A numpy view of a host row array (a numpy array, or a CPU torch
    tensor: bf16 viewed as int16, the same bytes and shape), or None for
    anything else."""
    import numpy as np
    import torch

    if isinstance(arr, np.ndarray):
        return arr
    if isinstance(arr, torch.Tensor) and arr.device.type == "cpu":
        if arr.dtype == torch.bfloat16:
            arr = arr.view(torch.int16)
        return arr.numpy()
    return None


def entry_problem(entry: ParkedKV) -> str | None:
    """Structural validation every migration-import path runs BEFORE
    touching a pool: a corrupted transfer must be refused with byte
    accounting intact, never inserted and trusted at restore time.
    Returns a reason string, or None when the entry is coherent."""
    if entry.kept < 1:
        return f"kept={entry.kept} (no trusted rows)"
    if len(entry.tokens) != entry.kept:
        return (f"token list length {len(entry.tokens)} != kept "
                f"{entry.kept}")
    k, v = host_array(entry.k), host_array(entry.v)
    for name, arr in (("k", k), ("v", v)):
        if arr is None or arr.ndim != 4:
            return f"{name} is not a [L, rows, Kv, H] array"
    if k.shape != v.shape:
        return f"k/v shape mismatch {k.shape} vs {v.shape}"
    # Every legitimate entry stores at least `kept` rows (dense parks
    # the pow2 bucket >= kept; paged trims to whole blocks >= kept) —
    # a small declared bucket must not let an under-stored entry slip
    # through to be zero-padded into "trusted" rows at import time.
    if entry.bucket < entry.kept:
        return (f"bucket {entry.bucket} cannot cover kept "
                f"{entry.kept}")
    if k.shape[1] < entry.kept:
        return (f"stored rows {k.shape[1]} cannot cover kept "
                f"{entry.kept}")
    if (entry.k_scale is None) != (entry.v_scale is None):
        return "one of k_scale/v_scale missing"
    scales = ()
    if entry.k_scale is not None:
        scales = (host_array(entry.k_scale), host_array(entry.v_scale))
        for name, arr in zip(("k_scale", "v_scale"), scales):
            if arr is None or arr.ndim != 3 \
                    or arr.shape[:2] != k.shape[:2]:
                return f"{name} does not match the row arrays"
    nbytes = sum(int(a.nbytes) for a in (k, v, *scales))
    if entry.nbytes != nbytes:
        return (f"declared nbytes {entry.nbytes} != actual array "
                f"bytes {nbytes}")
    return None


class HostKVPool:
    """LRU + TTL + budget-bounded session_id → ParkedKV map."""

    def __init__(self, budget_mb: float = 0.0, ttl_s: float = 600.0,
                 clock=time.monotonic):
        self.budget_bytes = int(max(0.0, budget_mb) * 1024 * 1024)
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: dict[str, ParkedKV] = {}
        self._bytes = 0
        self._lookups = 0
        self._hits = 0
        # Instance-local counts for stats(): the registry counters are
        # process-global (shared across engine instances in one
        # process, e.g. tests), so stats() must not read them back.
        self._n_parked = 0
        self._n_restored = 0
        self._n_evicted = 0
        self._n_rejected = 0
        # Tombstones for released (dead) sessions: a park job already
        # in flight on the copy thread when the release purge ran must
        # not insert its entry afterwards — the pool would leak budget
        # to a session that can never return until TTL. Bounded; a
        # session id seen again at admission is revived (engine-seam
        # callers may reuse ids after release).
        self._dead: deque[str] = deque(maxlen=1024)
        self._dead_set: set[str] = set()
        self._events = get_events()
        m = get_metrics()
        self._m_bytes = m.gauge(
            "kv_host_bytes", "host RAM held by parked session KV")
        self._m_sessions = m.gauge(
            "kv_host_sessions", "sessions currently parked in host RAM")
        self._m_hit_ratio = m.gauge(
            "kv_restore_hit_ratio",
            "fraction of fresh-slot admissions served by a host-KV "
            "restore instead of full prefill")
        self._m_parked = m.counter(
            "kv_park_total", "session KV snapshots parked to host RAM")
        self._m_restored = m.counter(
            "kv_restore_total",
            "admissions whose kept prefix was restored from host RAM")
        self._m_evicted = m.counter(
            "kv_evicted_total",
            "parked entries evicted (budget LRU or TTL)")
        self._m_rejected = m.counter(
            "kv_park_rejected_total",
            "park attempts refused (entry alone exceeds the budget)")

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ---------------- write side ----------------

    def put(self, entry: ParkedKV, *, revive: bool = False) -> bool:
        """Insert (or replace) a session's parked entry, evicting LRU
        entries while over budget. Returns False when the entry alone
        exceeds the whole budget (emits a ``kv_pressure`` event — the
        operator sized the pool below one session's history).

        ``revive=True`` re-admits a released (tombstoned) session —
        the migration import path, where the session is coming BACK.
        The tombstone is cleared only together with a successful
        insert: a refused import must leave the tombstone standing so
        a stale park snapshot still in flight cannot re-insert the
        dead session either."""
        if not self.enabled:
            return False
        with self._lock:
            if not revive and entry.session_id in self._dead_set:
                return False  # released while the copy was in flight
        if entry.nbytes > self.budget_bytes:
            self._m_rejected.inc()
            with self._lock:
                self._n_rejected += 1
            self._events.emit(
                "kv_pressure", severity="warning", coalesce_s=30.0,
                coalesce_key="oversized", reason="entry_over_budget",
                session_id=entry.session_id, entry_bytes=entry.nbytes,
                budget_bytes=self.budget_bytes)
            return False
        evicted = 0
        with self._lock:
            if revive:
                self._dead_set.discard(entry.session_id)
            old = self._entries.pop(entry.session_id, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[entry.session_id] = entry
            self._bytes += entry.nbytes
            while self._bytes > self.budget_bytes and len(self._entries) > 1:
                victim_sid = min(
                    (sid for sid in self._entries
                     if sid != entry.session_id),
                    key=lambda sid: self._entries[sid].last_used)
                self._bytes -= self._entries.pop(victim_sid).nbytes
                evicted += 1
            self._m_parked.inc()
            self._n_parked += 1
            self._update_gauges_locked()
        if evicted:
            self._m_evicted.inc(evicted)
            with self._lock:
                self._n_evicted += evicted
            self._events.emit(
                "kv_pressure", severity="warning", coalesce_s=30.0,
                coalesce_key="budget", reason="budget_eviction",
                evicted=evicted, bytes=self._bytes,
                budget_bytes=self.budget_bytes)
        return True

    def get(self, session_id: str) -> ParkedKV | None:
        """Live entry for a session (touches LRU recency); expired
        entries are dropped on access."""
        now = self._clock()
        with self._lock:
            entry = self._entries.get(session_id)
            if entry is None:
                return None
            if self.ttl_s > 0 and now - entry.last_used > self.ttl_s:
                self._entries.pop(session_id, None)
                self._bytes -= entry.nbytes
                self._m_evicted.inc()
                self._n_evicted += 1
                self._update_gauges_locked()
                return None
            entry.last_used = now
            return entry

    def take(self, session_id: str) -> ParkedKV | None:
        """Pop a session's entry (restore consumed it: the KV is about
        to be device-resident again; a later eviction re-parks it)."""
        with self._lock:
            entry = self._entries.pop(session_id, None)
            if entry is not None:
                self._bytes -= entry.nbytes
                self._update_gauges_locked()
            return entry

    def purge(self, session_id: str) -> bool:
        """Drop a session's parked entry (session released/dead — the
        pool must never leak entries for sessions that cannot return).
        Also tombstones the id so a park snapshot still in flight on
        the copy thread cannot re-insert it (see ``revive``)."""
        with self._lock:
            if session_id not in self._dead_set:
                if len(self._dead) == self._dead.maxlen:
                    self._dead_set.discard(self._dead[0])
                self._dead.append(session_id)
                self._dead_set.add(session_id)
            entry = self._entries.pop(session_id, None)
            if entry is None:
                return False
            self._bytes -= entry.nbytes
            self._update_gauges_locked()
            return True

    def revive(self, session_id: str) -> None:
        """Clear a session's released-tombstone (it was admitted
        again: engine-seam callers may reuse ids after release)."""
        with self._lock:
            self._dead_set.discard(session_id)

    def staged_bytes(self) -> int:
        """Device bytes currently held by prestage uploads awaiting
        their restore — bounds how much HBM prestaging may hold
        (kvcache/offload.py). Counts the staged (bucket-padded)
        footprint, which exceeds the trimmed host nbytes on the paged
        tier."""
        with self._lock:
            return sum(e.staged_nbytes or e.nbytes
                       for e in self._entries.values()
                       if e.k_dev is not None)

    def sweep(self, now: float | None = None) -> int:
        """TTL eviction pass (engine-loop tick); returns entries dropped."""
        if self.ttl_s <= 0:
            return 0
        now = self._clock() if now is None else now
        horizon = now - self.ttl_s
        with self._lock:
            dead = [sid for sid, e in self._entries.items()
                    if e.last_used < horizon]
            for sid in dead:
                self._bytes -= self._entries.pop(sid).nbytes
            if dead:
                self._m_evicted.inc(len(dead))
                self._n_evicted += len(dead)
                self._update_gauges_locked()
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._update_gauges_locked()

    # ---------------- read side ----------------

    def parked_len(self, session_id: str) -> int:
        """Kept length of a session's parked entry (0 if none) without
        touching LRU recency — the idle-park check must not keep its
        own candidates perpetually fresh."""
        with self._lock:
            entry = self._entries.get(session_id)
            return entry.kept if entry is not None else 0

    def note_lookup(self, restored: bool) -> None:
        """One fresh-slot admission consulted the pool; ``restored``
        when the kept prefix actually came back from host RAM."""
        with self._lock:
            self._lookups += 1
            if restored:
                self._hits += 1
                self._m_restored.inc()
                self._n_restored += 1
            self._m_hit_ratio.set(self._hits / self._lookups)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "sessions": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "ttl_s": self.ttl_s,
                "parked_total": self._n_parked,
                "restored_total": self._n_restored,
                "evicted_total": self._n_evicted,
                "rejected_total": self._n_rejected,
                "restore_lookups": self._lookups,
                "restore_hits": self._hits,
                "restore_hit_ratio": (self._hits / self._lookups
                                      if self._lookups else None),
            }

    def snapshot(self) -> list[dict[str, Any]]:
        """Per-session parked-entry view for /debug/requests."""
        now = self._clock()
        with self._lock:
            return [{
                "session_id": e.session_id,
                "tokens": e.kept,
                "bytes": e.nbytes,
                "parked_s": round(now - e.parked_at, 3),
                "idle_s": round(now - e.last_used, 3),
                "prestaged": e.k_dev is not None,
            } for e in self._entries.values()]

    def _update_gauges_locked(self) -> None:
        self._m_bytes.set(self._bytes)
        self._m_sessions.set(len(self._entries))
