"""Host-side block allocator for the paged KV tier (KV_LAYOUT=paged).

A copy of ``fasttalk_tpu/kvcache/blocks.py`` (the port imports nothing of
the JAX package): holds, aliasing, copy-on-write of a shared tail, the
pressure callback, the gauges and the ``kv.block_alloc`` failpoint. The
device-side data movement is the port engine's (tensor indexing and
``copy_`` on the CUDA stream).

The device holds one flat pool of KV rows per layer —
``[L, num_blocks * block_size, Kv, H]`` — and every decode slot maps its
logical token positions onto pool rows through a *block table*: entry
``i`` of a slot's table names the pool block holding that slot's
positions ``[i*block_size, (i+1)*block_size)``. This module is the pure
bookkeeping half: which blocks are free, which slot(s) reference each
block, and what each slot's table currently says. All device-side data
movement (gather reads, scatter writes, the copy-on-write block copy)
lives in the engine; everything here is plain Python
on the engine thread (no locks by design, same discipline as
engine/slots.py — the monitoring port reads ``stats()``, which only
touches atomically-swapped ints and copies).

Refcounts make shared prefixes *aliasing* instead of row copies: a
fresh admission whose prompt starts with blocks resident in another
slot appends the same block ids to its own table (``alias``) and bumps
their refcounts; only a partially-shared tail block ever needs a device
copy (copy-on-write, driven by the engine). A block returns to the free
list when its last referent drops it — eviction, truncation on history
divergence, or session release.

Beyond slot tables, a block may carry *holds* — references owned by a
non-slot structure (the radix prefix tree, kvcache/radix.py). A hold is
one refcount like any table entry; ``hold``/``unhold`` maintain them,
and the pressure callback installed with ``set_pressure`` lets the
holder shed refcount-free holds when ``_take`` would otherwise raise,
so cached-but-unreferenced prefix blocks are reclaimed before a live
admission is shed.

Invariant (asserted by ``check_leaks``): every block is either on the
free list with refcount 0, or its refcount equals its table
multiplicity plus its hold multiplicity. ``kv.block_alloc`` is a chaos
failpoint at the single place blocks are taken from the free list, so
pool exhaustion mid-prefill is a rehearsed incident, not a novel one
(docs/RESILIENCE.md).
"""

from __future__ import annotations

from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("kvcache.blocks")


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` rows (ceil division)."""
    return -(-max(0, tokens) // block_size)


class BlockExhausted(RuntimeError):
    """The pool has no free block for a required allocation."""


class BlockAllocator:
    """Free-list + refcount bookkeeping over ``num_blocks`` fixed-size
    blocks, with one block table per decode slot."""

    def __init__(self, num_blocks: int, block_size: int,
                 num_slots: int) -> None:
        if num_blocks <= 0:
            raise ValueError("num_blocks must be > 0")
        if block_size <= 0 or block_size & (block_size - 1):
            raise ValueError(
                f"block_size must be a power of two, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._ref = [0] * num_blocks
        # Pop from the end → low block ids hand out first (stable ids
        # make test assertions and debug dumps readable).
        self._free = list(range(num_blocks - 1, -1, -1))
        self._tables: list[list[int]] = [[] for _ in range(num_slots)]
        self.cow_copies = 0       # copy-on-write block copies performed
        self.alias_events = 0     # alias() calls that shared >= 1 block
        m = get_metrics()
        self._m_total = m.gauge(
            "kv_blocks_total", "device KV block-pool size (blocks)")
        self._m_in_use = m.gauge(
            "kv_blocks_in_use", "device KV blocks with refcount >= 1")
        self._m_aliased = m.gauge(
            "kv_blocks_aliased",
            "device KV blocks shared by more than one slot "
            "(refcount >= 2)")
        self._m_frag = m.gauge(
            "kv_block_fragmentation",
            "fraction of in-use KV block capacity holding no live "
            "token rows (allocation granularity waste)")
        self._m_total.set(num_blocks)
        self._aliased = 0
        # Non-slot references (block id -> hold multiplicity), owned by
        # the radix prefix cache. Counted inside _ref like table
        # entries; kept separately so check_leaks can prove the split.
        self._held: dict[int, int] = {}
        # Invoked by _take when the free list cannot cover a request:
        # cb(shortfall_blocks) should release holds (via unhold) and
        # may return the number of blocks it freed. Installed by the
        # engine when the radix cache is on.
        self._pressure = None
        self._update_gauges()

    # ---------------- queries ----------------

    def available(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def table(self, slot: int) -> list[int]:
        """The slot's live block table (do not mutate)."""
        return self._tables[slot]

    def slot_blocks(self, slot: int) -> int:
        return len(self._tables[slot])

    def tail_shared(self, slot: int) -> bool:
        """True when the slot's last table block is referenced by
        another slot too — writing into it would corrupt the other
        referent's trusted rows (the engine copy-on-writes first)."""
        t = self._tables[slot]
        return bool(t) and self._ref[t[-1]] > 1

    def block_shared(self, slot: int, index: int) -> bool:
        return self._ref[self._tables[slot][index]] > 1

    def ref(self, blk: int) -> int:
        return self._ref[blk]

    def held(self) -> int:
        """Distinct blocks currently carrying at least one hold."""
        return len(self._held)

    # ---------------- allocation ----------------

    def _take(self, n: int) -> list[int]:
        """Pop ``n`` free blocks (all-or-nothing). The ``kv.block_alloc``
        failpoint fires BEFORE any state changes, so an injected
        exhaustion leaves the accounting exactly as it found it."""
        if n <= 0:
            return []
        if _fp.enabled:
            _fp.fire("kv.block_alloc", exc=BlockExhausted, need=str(n))
        if n > len(self._free) and self._pressure is not None:
            # Reclaim radix-held blocks before declaring exhaustion —
            # the callback unholds LRU cached prefixes, growing _free.
            self._pressure(n - len(self._free))
        if n > len(self._free):
            raise BlockExhausted(
                f"KV block pool exhausted: need {n} blocks, "
                f"{len(self._free)} free of {self.num_blocks}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow the slot's table to cover ``tokens`` positions.
        Returns False (state untouched) when the pool cannot supply the
        missing blocks; never shrinks (see ``truncate``)."""
        need = blocks_for(tokens, self.block_size) - len(self._tables[slot])
        if need <= 0:
            return True
        try:
            fresh = self._take(need)
        except BlockExhausted:
            return False
        self._tables[slot].extend(fresh)
        self._update_gauges()
        return True

    def append_block(self, slot: int) -> int | None:
        """Append one fresh block to the slot's table (the engine's
        copy-on-write target). None when the pool is empty."""
        try:
            blk = self._take(1)[0]
        except BlockExhausted:
            return None
        self._tables[slot].append(blk)
        self._update_gauges()
        return blk

    # ---------------- release ----------------

    def _drop(self, blk: int) -> None:
        ref = self._ref[blk]
        assert ref > 0, f"double free of KV block {blk}"
        if ref == 2:
            self._aliased -= 1
        self._ref[blk] = ref - 1
        if ref == 1:
            self._free.append(blk)

    def truncate(self, slot: int, tokens: int) -> int:
        """Drop table blocks beyond what ``tokens`` positions need
        (history divergence, post-finish hygiene). Returns blocks
        dropped."""
        keep = blocks_for(tokens, self.block_size)
        t = self._tables[slot]
        dropped = 0
        while len(t) > keep:
            self._drop(t.pop())
            dropped += 1
        if dropped:
            self._update_gauges()
        return dropped

    def release(self, slot: int) -> None:
        """Drop the slot's whole table (unpin/eviction/release)."""
        self.truncate(slot, 0)

    # ---------------- holds (radix prefix cache) ----------------

    def set_pressure(self, cb) -> None:
        """Install the reclaim-under-pressure callback (or None).
        ``cb(shortfall)`` runs inside ``_take`` when the free list is
        short, after the chaos failpoint and before the exhaustion
        raise; it should ``unhold`` cached blocks to grow the pool."""
        self._pressure = cb

    def hold(self, blocks: list[int]) -> None:
        """Take one non-slot reference on each (live) block. The
        holder keeps the rows alive after every slot table drops
        them."""
        for blk in blocks:
            ref = self._ref[blk]
            assert ref > 0, f"hold on free KV block {blk}"
            if ref == 1:
                self._aliased += 1
            self._ref[blk] = ref + 1
            self._held[blk] = self._held.get(blk, 0) + 1
        if blocks:
            self._update_gauges()

    def unhold(self, blocks: list[int]) -> None:
        """Release one hold per block; blocks whose last reference
        this was return to the free list."""
        for blk in blocks:
            h = self._held.get(blk, 0)
            assert h > 0, f"unhold without hold on KV block {blk}"
            if h == 1:
                del self._held[blk]
            else:
                self._held[blk] = h - 1
            self._drop(blk)
        if blocks:
            self._update_gauges()

    # ---------------- aliasing (shared prefix) ----------------

    def alias(self, src_slot: int, dst_slot: int, n_blocks: int) -> int:
        """Share the source slot's first ``n_blocks`` table entries
        into the (empty) destination table, bumping refcounts — the
        zero-copy shared-prefix stamp. Returns blocks aliased."""
        dst = self._tables[dst_slot]
        assert not dst, "alias target must be a fresh (empty) table"
        src = self._tables[src_slot]
        n = min(n_blocks, len(src))
        for blk in src[:n]:
            if self._ref[blk] == 1:
                self._aliased += 1
            self._ref[blk] += 1
            dst.append(blk)
        if n:
            self.alias_events += 1
            self._update_gauges()
        return n

    def alias_blocks(self, dst_slot: int, blocks: list[int]) -> int:
        """Share an explicit block chain (radix-tree match) into the
        (empty) destination table, bumping refcounts. Returns blocks
        aliased."""
        dst = self._tables[dst_slot]
        assert not dst, "alias target must be a fresh (empty) table"
        for blk in blocks:
            ref = self._ref[blk]
            assert ref > 0, f"alias of free KV block {blk}"
            if ref == 1:
                self._aliased += 1
            self._ref[blk] = ref + 1
            dst.append(blk)
        if blocks:
            self.alias_events += 1
            self._update_gauges()
        return len(blocks)

    def cow_tail(self, slot: int) -> tuple[int, int] | None:
        """Copy-on-write the slot's tail block: swap the (shared) last
        table entry for a fresh exclusive block, dropping one reference
        on the old. Returns (old_block, new_block) for the engine's
        device copy, or None when the pool is empty (the caller
        truncates to the block boundary instead)."""
        t = self._tables[slot]
        assert t, "cow_tail on an empty table"
        old = t[-1]
        try:
            new = self._take(1)[0]
        except BlockExhausted:
            return None
        t[-1] = new
        self._drop(old)
        self.cow_copies += 1
        self._update_gauges()
        return old, new

    # ---------------- observability / invariants ----------------

    def _update_gauges(self) -> None:
        self._m_in_use.set(self.in_use())
        self._m_aliased.set(self._aliased)

    def note_used_tokens(self, used_tokens: int) -> None:
        """Feed live token-row occupancy (sum of slot kept lengths over
        DISTINCT blocks' capacity) into the fragmentation gauge."""
        cap = self.in_use() * self.block_size
        frag = 1.0 - min(1.0, used_tokens / cap) if cap else 0.0
        self._m_frag.set(round(frag, 6))

    def stats(self, used_tokens: int | None = None) -> dict:
        in_use = self.in_use()
        out = {
            "total": self.num_blocks,
            "block_size": self.block_size,
            "free": len(self._free),
            "in_use": in_use,
            "aliased": self._aliased,
            "alias_events": self.alias_events,
            "cow_copies": self.cow_copies,
            "held": len(self._held),
            "tables": [len(t) for t in self._tables],
        }
        if used_tokens is not None:
            cap = in_use * self.block_size
            out["used_tokens"] = used_tokens
            out["fragmentation"] = (round(1.0 - min(1.0, used_tokens / cap),
                                          4) if cap else 0.0)
            self.note_used_tokens(used_tokens)
        return out

    def check_leaks(self) -> None:
        """Assert the pool invariant: refcounts equal table
        multiplicity plus hold multiplicity, and free+referenced
        covers every block exactly. Test/debug surface —
        O(blocks + table entries)."""
        mult: dict[int, int] = {}
        for t in self._tables:
            for blk in t:
                mult[blk] = mult.get(blk, 0) + 1
        for blk, h in self._held.items():
            assert h > 0, f"block {blk}: zero-multiplicity hold entry"
            mult[blk] = mult.get(blk, 0) + h
        free = set(self._free)
        assert len(free) == len(self._free), "free-list duplicates"
        for blk in range(self.num_blocks):
            ref = self._ref[blk]
            assert mult.get(blk, 0) == ref, \
                f"block {blk}: refcount {ref} != table+hold " \
                f"multiplicity {mult.get(blk, 0)}"
            assert (blk in free) == (ref == 0), \
                f"block {blk}: ref {ref} but free={blk in free}"
