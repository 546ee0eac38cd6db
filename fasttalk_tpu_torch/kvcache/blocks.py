"""Host-side block allocator for the paged KV tier (KV_LAYOUT=paged).

Counterpart of ``fasttalk_tpu/kvcache/blocks.py`` (``blocks_for`` :49,
``BlockExhausted`` :54, ``BlockAllocator`` :58) without the radix holds,
the shared-prefix aliasing and the copy-on-write of a shared tail, which
this port does not carry yet, and without the failpoint and metric gauges.

The device holds one flat pool of KV rows per layer,
``[L, num_blocks * block_size, Kv, H]`` (models/llama.py
``init_paged_cache``), and every decode slot maps its logical positions
onto pool rows through a *block table*: entry ``i`` names the pool block
holding positions ``[i*block_size, (i+1)*block_size)``. This module is the
bookkeeping half: which blocks are free, which slot references each block,
and what each slot's table says. It runs on the engine thread only (no
locks, as engine/slots.py).

Invariant (asserted by ``check_leaks``): every block is either on the free
list with refcount 0, or its refcount equals its table multiplicity.
"""

from __future__ import annotations


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` rows (ceil division)."""
    return -(-max(0, tokens) // block_size)


class BlockExhausted(RuntimeError):
    """The pool has no free block for a required allocation."""


class BlockAllocator:
    """Free list + refcount bookkeeping over ``num_blocks`` fixed-size
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
        # Pop from the end: low block ids hand out first.
        self._free = list(range(num_blocks - 1, -1, -1))
        self._tables: list[list[int]] = [[] for _ in range(num_slots)]

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

    # ---------------- allocation ----------------

    def _take(self, n: int) -> list[int]:
        """Pop ``n`` free blocks, all or nothing."""
        if n <= 0:
            return []
        if n > len(self._free):
            raise BlockExhausted(
                f"KV block pool exhausted: need {n} blocks, "
                f"{len(self._free)} free of {self.num_blocks}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow the slot's table to cover ``tokens`` positions. Returns
        False (state untouched) when the pool cannot supply the missing
        blocks; never shrinks (see ``truncate``)."""
        need = blocks_for(tokens, self.block_size) - len(self._tables[slot])
        if need <= 0:
            return True
        try:
            fresh = self._take(need)
        except BlockExhausted:
            return False
        self._tables[slot].extend(fresh)
        return True

    # ---------------- release ----------------

    def _drop(self, blk: int) -> None:
        ref = self._ref[blk]
        assert ref > 0, f"double free of KV block {blk}"
        self._ref[blk] = ref - 1
        if ref == 1:
            self._free.append(blk)

    def truncate(self, slot: int, tokens: int) -> int:
        """Drop table blocks beyond what ``tokens`` positions need (history
        divergence, decode-growth slack after a finish). Returns blocks
        dropped."""
        keep = blocks_for(tokens, self.block_size)
        t = self._tables[slot]
        dropped = 0
        while len(t) > keep:
            self._drop(t.pop())
            dropped += 1
        return dropped

    def release(self, slot: int) -> None:
        """Drop the slot's whole table (unpin, eviction, release)."""
        self.truncate(slot, 0)

    # ---------------- observability / invariants ----------------

    def stats(self, used_tokens: int | None = None) -> dict:
        in_use = self.in_use()
        out = {
            "total": self.num_blocks,
            "block_size": self.block_size,
            "free": len(self._free),
            "in_use": in_use,
            "tables": [len(t) for t in self._tables],
        }
        if used_tokens is not None:
            cap = in_use * self.block_size
            out["used_tokens"] = used_tokens
            out["fragmentation"] = (round(1.0 - min(1.0, used_tokens / cap),
                                          4) if cap else 0.0)
        return out

    def check_leaks(self) -> None:
        """Assert the pool invariant: refcounts equal table multiplicity,
        and free + referenced covers every block exactly once."""
        mult: dict[int, int] = {}
        for t in self._tables:
            for blk in t:
                mult[blk] = mult.get(blk, 0) + 1
        free = set(self._free)
        assert len(free) == len(self._free), "free-list duplicates"
        for blk in range(self.num_blocks):
            ref = self._ref[blk]
            assert mult.get(blk, 0) == ref, \
                f"block {blk}: refcount {ref} != table multiplicity " \
                f"{mult.get(blk, 0)}"
            assert (blk in free) == (ref == 0), \
                f"block {blk}: ref {ref} but free={blk in free}"
