"""Decode-slot management: session pinning, prefix reuse, LRU eviction.

The continuous-batching engine decodes a fixed batch of S slots (static
shapes for XLA). Each slot owns one contiguous region of the KV cache
arrays. A *session* (WebSocket conversation) is pinned to a slot between
turns, so its KV stays resident in TPU HBM and a follow-up turn only
prefills the new tokens — the north-star requirement the reference could
not meet (its KV lived inside an external engine container and was gone
between HTTP calls; BASELINE.json north_star).

All methods are called from the engine thread only — no locks by design
(contrast: the reference's lock-discipline bugs, SURVEY.md §5 race
detection: get_detailed_stats self-deadlock).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def _lcp(a: list[int], b: list[int], limit: int) -> int:
    """Length of the longest common prefix of a[:limit] and b[:limit].
    Slice-equality blocks keep the comparison at C speed — a per-token
    Python loop over multi-thousand-token resident histories runs on
    the engine thread inside admission and costs TTFT."""
    n = 0
    step = 256
    while n < limit:
        m = min(step, limit - n)
        if a[n:n + m] == b[n:n + m]:
            n += m
            continue
        for i in range(n, n + m):
            if a[i] != b[i]:
                return i
        return n + m
    return n


@dataclass
class Slot:
    index: int
    session_id: str | None = None     # pinned session (None = free)
    tokens: list[int] = field(default_factory=list)  # kept token ids
    # How many leading entries of ``tokens`` have their KV actually
    # written in HBM. A token's KV is written when it is *fed*, one step
    # after it is sampled — so a request finishing on max_tokens keeps a
    # final token whose KV row was never written. Prefix reuse must not
    # trust rows beyond this watermark.
    kv_written: int = 0
    active: bool = False              # currently decoding a request
    last_used: float = 0.0

    @property
    def length(self) -> int:
        return len(self.tokens)


class SlotManager:
    def __init__(self, num_slots: int, max_len: int, on_evict=None,
                 on_unpin=None):
        self.slots = [Slot(i) for i in range(num_slots)]
        self.max_len = max_len
        self._by_session: dict[str, Slot] = {}
        # Called with the victim Slot BEFORE an LRU eviction clears it
        # (engine hook: snapshot the resident KV to the host pool,
        # kvcache/offload.py). Only acquire()-driven evictions fire it
        # — an explicit release_session means the session is done and
        # its KV is not worth keeping anywhere.
        self.on_evict = on_evict
        # Called with the Slot on EVERY unpin (eviction and explicit
        # release alike), before its fields clear — the paged KV tier
        # frees the slot's block table here (kvcache/blocks.py), so
        # device blocks can never outlive the session that owned them.
        self.on_unpin = on_unpin

    def lookup(self, session_id: str) -> Slot | None:
        return self._by_session.get(session_id)

    def acquire(self, session_id: str) -> Slot | None:
        """Pin a slot for this session: existing pin → free slot → evict
        the least-recently-used idle session. None if all slots are
        actively decoding (caller queues the request)."""
        slot = self._by_session.get(session_id)
        if slot is not None:
            slot.last_used = time.monotonic()
            return slot
        for slot in self.slots:
            if slot.session_id is None:
                return self._pin(slot, session_id)
        victims = [s for s in self.slots if not s.active]
        if not victims:
            return None
        victim = min(victims, key=lambda s: s.last_used)
        if self.on_evict is not None and victim.session_id is not None:
            self.on_evict(victim)
        self._unpin(victim)
        return self._pin(victim, session_id)

    def _pin(self, slot: Slot, session_id: str) -> Slot:
        slot.session_id = session_id
        slot.tokens = []
        slot.kv_written = 0
        slot.active = False
        slot.last_used = time.monotonic()
        self._by_session[session_id] = slot
        return slot

    def _unpin(self, slot: Slot) -> None:
        if self.on_unpin is not None:
            self.on_unpin(slot)
        if slot.session_id is not None:
            self._by_session.pop(slot.session_id, None)
        slot.session_id = None
        slot.tokens = []
        slot.kv_written = 0
        slot.active = False

    def release_session(self, session_id: str) -> None:
        slot = self._by_session.get(session_id)
        if slot is not None and not slot.active:
            self._unpin(slot)
        elif slot is not None:
            # Active request: mark for release when generation finishes.
            slot.last_used = 0.0

    def reuse_prefix(self, slot: Slot, prompt_tokens: list[int]) -> int:
        """Longest reusable cached prefix for this prompt.

        Returns the number of leading prompt tokens whose KV is already in
        the slot (0 → full prefill). Never returns the full prompt length:
        at least one token must run through the model to produce logits,
        so reuse is capped at len(prompt) - 1. Also capped at kv_written —
        a kept token whose KV row was never written (request finished the
        step it was sampled) must be re-fed, not trusted.
        """
        cached = slot.tokens
        limit = min(len(cached), len(prompt_tokens) - 1, slot.kv_written)
        n = _lcp(cached, prompt_tokens, limit)
        if n < len(cached):
            # Divergence: the cache beyond n is for a different history.
            # Positions beyond n will be overwritten by the new prefill —
            # and until then nothing may trust them, so the watermark
            # drops too (best_shared_prefix reads other slots' tokens up
            # to kv_written; a stale watermark past len(tokens) crashed
            # the engine thread).
            slot.tokens = cached[:n]
            slot.kv_written = min(slot.kv_written, n)
        return n

    def best_shared_prefix(self, slot: Slot, prompt_tokens: list[int],
                           min_len: int = 16) -> tuple[Slot | None, int]:
        """Longest common prefix between this prompt and any OTHER
        slot's written KV — the cross-session case (a fleet of sessions
        sharing one system prompt re-prefilled it once per slot; the
        engine can copy the resident rows instead, engine.py
        shared-prefix path). Capped at the source's kv_written
        watermark and len(prompt) - 1; returns (None, 0) below
        ``min_len`` (a copy dispatch isn't worth a handful of rows)."""
        best, best_n = None, min_len - 1
        cap = len(prompt_tokens) - 1
        for other in self.slots:
            if other is slot or other.kv_written == 0:
                continue
            ot = other.tokens
            limit = min(other.kv_written, len(ot), cap)
            n = _lcp(ot, prompt_tokens, limit)
            if n > best_n:
                best, best_n = other, n
                if best_n >= cap:
                    break  # nothing longer is possible
        return best, (best_n if best is not None else 0)

    def active_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.active]

    def stats(self) -> dict:
        return {
            "total_slots": len(self.slots),
            "active": sum(1 for s in self.slots if s.active),
            "pinned": sum(1 for s in self.slots if s.session_id is not None),
            "resident_tokens": sum(s.length for s in self.slots),
        }
