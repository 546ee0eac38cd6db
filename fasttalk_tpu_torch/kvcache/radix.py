"""Radix-tree automatic prefix cache over the paged KV block pool.

A copy of ``fasttalk_tpu/kvcache/radix.py`` (the port imports nothing of
the JAX package). Its sha1 chain digests are byte-equal to the JAX
package's: they are the fleet router's placement key.

SGLang's RadixAttention / vLLM's automatic prefix caching, adapted to
this engine's paged tier (docs/KVCACHE.md): a radix tree whose nodes
own *block-size-aligned* token runs and the pool block ids holding
their KV rows. Every admission silently reuses the longest cached
block chain — no explicit prefix registration — and every finished or
parked session donates its clean prefix blocks to the tree instead of
freeing them.

Structure
---------
- Each node owns a run of whole blocks: ``tokens`` (len a multiple of
  ``block_size``) and a parallel ``blocks`` list of pool ids. Children
  are keyed by the chained digest of the child's *first* block, so
  siblings always differ in their first block (splits happen only at
  block boundaries, hence a partially-matching child is split into a
  shared-prefix parent plus the diverging remainder).
- Per-block *chain digests*: ``h_i = sha1(h_{i-1} || tokens_i)``. The
  digest after block ``i`` commits to the whole token prefix through
  block ``i``, which is what makes it usable as the fleet router's
  placement key (router/policy.py) — two prompts share a chain-digest
  prefix iff they share the underlying cached blocks.

Refcount contract (kvcache/blocks.py)
-------------------------------------
The tree owns exactly one allocator *hold* per block it references.
A slot that admits through ``match`` aliases the chain into its table
(ref goes to >= 2); the tree block becomes evictable again only when
every aliasing slot has released it (ref back to 1). Because slots
alias chain *prefixes*, refcounts are non-increasing along any chain,
so trimming a leaf from its tail while ``ref == 1`` can never free a
block a slot still reads — the chaos suite asserts exactly this
(tests/test_chaos.py).

Eviction
--------
``evict(need)`` walks leaves in policy order (``lru`` by last touch,
``fifo`` by insertion) and trims tail blocks with ``ref == 1``,
deleting emptied nodes, until ``need`` blocks returned to the free
list or nothing evictable remains. The allocator's pressure callback
(installed by the engine) calls this from inside ``_take``, so cached
prefixes are reclaimed *before* a live admission is shed.
"""

from __future__ import annotations

import hashlib

from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("kvcache.radix")

EVICT_POLICIES = ("lru", "fifo")


def chain_digest(prev: str, chunk: bytes) -> str:
    """One link of the chained prefix hash: commits to ``prev`` (the
    digest of everything before) plus this chunk. Shared by the tree
    (token blocks) and the fleet router (char blocks of leading
    messages) so placement keys and cache keys agree in shape."""
    h = hashlib.sha1()
    h.update(prev.encode("ascii"))
    h.update(chunk)
    return h.hexdigest()


def _block_bytes(tokens: list[int]) -> bytes:
    # Fixed-width little-endian token ids: unambiguous concatenation.
    return b"".join(t.to_bytes(4, "little", signed=False)
                    for t in tokens)


class _Node:
    __slots__ = ("parent", "tokens", "blocks", "digests", "children",
                 "last_access", "created")

    def __init__(self, parent: "_Node | None") -> None:
        self.parent = parent
        self.tokens: list[int] = []     # multiple of block_size
        self.blocks: list[int] = []     # pool ids, parallel per block
        self.digests: list[str] = []    # chain digest after block i
        self.children: dict[str, _Node] = {}
        self.last_access = 0
        self.created = 0


class RadixTree:
    """Prefix cache over a ``BlockAllocator``. All methods run on the
    engine thread (same no-lock discipline as the allocator); the
    monitoring port only reads ``stats()`` snapshots."""

    def __init__(self, alloc, *, min_free_blocks: int = 0,
                 evict_policy: str = "lru",
                 token_bytes: int = 0) -> None:
        if evict_policy not in EVICT_POLICIES:
            raise ValueError(
                f"unknown radix evict policy {evict_policy!r} "
                f"(expected one of {EVICT_POLICIES})")
        self.alloc = alloc
        self.block_size = alloc.block_size
        self.min_free_blocks = min_free_blocks
        self.evict_policy = evict_policy
        # Bytes of device KV per token row (all layers, K+V) — for the
        # bytes-saved counter; 0 when the engine doesn't care.
        self.token_bytes = token_bytes
        self._root = _Node(None)
        self._tick = 0
        self._blocks = 0          # blocks currently held by the tree
        self._nodes = 0
        # Cumulative counters (mirrored to Prometheus below).
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        m = get_metrics()
        self._m_nodes = m.gauge(
            "kv_radix_nodes", "radix prefix-cache tree nodes")
        self._m_blocks = m.gauge(
            "kv_radix_blocks",
            "device KV blocks held by the radix prefix cache")
        self._m_hit_tokens = m.counter(
            "kv_radix_hit_tokens_total",
            "prompt tokens served from the radix prefix cache "
            "instead of prefill")
        self._m_bytes_saved = m.counter(
            "kv_radix_bytes_saved_total",
            "device KV bytes not re-computed thanks to radix "
            "prefix-cache hits")
        self._m_lookups = m.counter(
            "kv_radix_lookups_total", "radix prefix-cache lookups")
        self._m_hits = m.counter(
            "kv_radix_hits_total",
            "radix prefix-cache lookups matching >= 1 block")
        self._m_inserted = m.counter(
            "kv_radix_inserted_blocks_total",
            "blocks donated to the radix prefix cache")
        self._m_evicted = m.counter(
            "kv_radix_evicted_blocks_total",
            "radix prefix-cache blocks reclaimed under pool pressure")

    # ---------------- queries ----------------

    def nodes(self) -> int:
        return self._nodes

    def blocks(self) -> int:
        return self._blocks

    def evictable_blocks(self) -> int:
        """Held blocks no slot currently aliases (ref == 1) — what
        eviction could return to the free list right now. Admission
        counts these as available (engine ``_paged_admissible``)."""
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            for blk in node.blocks:
                if self.alloc.ref(blk) == 1:
                    n += 1
            stack.extend(node.children.values())
        return n

    # ---------------- match (admission) ----------------

    def match(self, tokens: list[int], max_blocks: int | None = None,
              count: bool = True) -> tuple[list[int], str]:
        """Longest cached chain that is a block-aligned prefix of
        ``tokens``. Returns (pool block ids, chain digest at the match
        end). Touches the path for LRU. The caller aliases the blocks
        into a slot table (bumping refs) *before* anything can trigger
        eviction, and credits the hit with ``note_hit`` only once the
        alias actually lands (a peeked-then-discarded match must not
        inflate the hit counters)."""
        bs = self.block_size
        limit = len(tokens) // bs
        if max_blocks is not None:
            limit = min(limit, max_blocks)
        if count:
            self.lookups += 1
            self._m_lookups.inc(1)
        out: list[int] = []
        digest = ""
        self._tick += 1
        node = self._root
        pos = 0
        while len(out) < limit:
            key = chain_digest(
                digest, _block_bytes(tokens[pos:pos + bs]))
            child = node.children.get(key)
            if child is None:
                break
            child.last_access = self._tick
            # First block already verified via the keyed digest; the
            # rest of the run must match token-for-token.
            nb = len(child.blocks)
            take = 0
            d = digest
            for i in range(min(nb, limit - len(out))):
                lo = pos + i * bs
                if i and child.tokens[i * bs:(i + 1) * bs] \
                        != tokens[lo:lo + bs]:
                    break
                d = child.digests[i]
                take = i + 1
            out.extend(child.blocks[:take])
            pos += take * bs
            digest = d
            if take < nb:       # diverged (or hit limit) mid-node
                break
            node = child
        return out, digest

    def note_hit(self, tokens_served: int) -> None:
        """Credit a consumed match (the engine aliased the chain into
        a slot table): hit-rate, tokens and bytes-saved counters."""
        self.hits += 1
        self._m_hits.inc(1)
        self.hit_tokens += tokens_served
        self._m_hit_tokens.inc(tokens_served)
        if self.token_bytes:
            self._m_bytes_saved.inc(tokens_served * self.token_bytes)

    # ---------------- insert (retirement / park / stamp) ----------------

    def insert(self, tokens: list[int], table: list[int],
               written: int | None = None) -> int:
        """Donate a slot's clean prefix to the tree. ``tokens`` is the
        slot history, ``table`` its block table; only whole blocks
        whose rows are fully written (``written`` caps, default all of
        ``tokens``) are eligible. Blocks the tree already caches for
        this token prefix are skipped (the slot's duplicates free on
        release as usual); genuinely new suffix blocks get one
        allocator hold each. Returns blocks newly held."""
        bs = self.block_size
        n_tok = len(tokens) if written is None else min(written,
                                                       len(tokens))
        nb = min(n_tok // bs, len(table))
        if nb <= 0:
            return 0
        self._tick += 1
        node = self._root
        node.last_access = self._tick
        digest = ""
        i = 0       # blocks consumed
        while i < nb:
            key = chain_digest(
                digest, _block_bytes(tokens[i * bs:(i + 1) * bs]))
            child = node.children.get(key)
            if child is None:
                break
            child.last_access = self._tick
            cb = len(child.blocks)
            same = 0
            d = digest
            for j in range(min(cb, nb - i)):
                lo = (i + j) * bs
                if j and child.tokens[j * bs:(j + 1) * bs] \
                        != tokens[lo:lo + bs]:
                    break
                d = child.digests[j]
                same = j + 1
            i += same
            digest = d
            if same < cb:
                if i < nb:
                    # Diverged mid-node: split so the shared prefix
                    # becomes the parent of both remainders.
                    node = self._split(child, same)
                    node.last_access = self._tick
                    break
                return 0    # prefix fully cached (ends mid-node)
            node = child
        if i >= nb:
            return 0        # prefix fully cached at a node boundary
        # New suffix: one leaf owning all remaining blocks.
        leaf = _Node(node)
        leaf.tokens = list(tokens[i * bs:nb * bs])
        leaf.blocks = list(table[i:nb])
        d = digest
        for j in range(nb - i):
            d = chain_digest(
                d, _block_bytes(leaf.tokens[j * bs:(j + 1) * bs]))
            leaf.digests.append(d)
        leaf.last_access = leaf.created = self._tick
        key = chain_digest(
            digest, _block_bytes(leaf.tokens[:bs]))
        node.children[key] = leaf
        self.alloc.hold(leaf.blocks)
        took = len(leaf.blocks)
        self._nodes += 1
        self._blocks += took
        self.inserted_blocks += took
        self._m_inserted.inc(took)
        self._update_gauges()
        # Keep the configured free headroom: the cache must never be
        # the reason the next admission sheds.
        if self.min_free_blocks and \
                self.alloc.available() < self.min_free_blocks:
            self.evict(self.min_free_blocks - self.alloc.available())
        return took

    def _split(self, node: _Node, at_blocks: int) -> _Node:
        """Split ``node`` so its first ``at_blocks`` blocks become a
        new parent and the remainder stays in ``node`` (re-keyed as
        its child). Returns the new parent."""
        assert 0 < at_blocks < len(node.blocks)
        bs = self.block_size
        parent = node.parent
        head = _Node(parent)
        head.tokens = node.tokens[:at_blocks * bs]
        head.blocks = node.blocks[:at_blocks]
        head.digests = node.digests[:at_blocks]
        head.last_access = node.last_access
        head.created = node.created
        # Re-key node under its (now shorter) first block. Only the
        # root has an empty run, so the chain digest at the start of
        # node's run is the parent's last digest (or "" at the root).
        prev = parent.digests[-1] if parent.digests else ""
        old_key = chain_digest(prev, _block_bytes(node.tokens[:bs]))
        del parent.children[old_key]
        parent.children[chain_digest(prev,
                                     _block_bytes(head.tokens[:bs]))] \
            = head
        node.tokens = node.tokens[at_blocks * bs:]
        node.blocks = node.blocks[at_blocks:]
        node.digests = node.digests[at_blocks:]
        node.parent = head
        head.children[chain_digest(head.digests[-1],
                                   _block_bytes(node.tokens[:bs]))] \
            = node
        self._nodes += 1
        self._update_gauges()
        return head

    # ---------------- eviction ----------------

    def evict(self, need: int) -> int:
        """Reclaim up to ``need`` blocks from unreferenced (ref == 1)
        leaf tails, policy order. Returns blocks freed."""
        freed = 0
        while freed < need:
            leaf = self._pick_victim()
            if leaf is None:
                break
            trimmed: list[int] = []
            while leaf.blocks and len(trimmed) < need - freed \
                    and self.alloc.ref(leaf.blocks[-1]) == 1:
                trimmed.append(leaf.blocks.pop())
                leaf.digests.pop()
                del leaf.tokens[-self.block_size:]
            if not trimmed:
                break   # victim pinned by a slot alias — nothing left
            self.alloc.unhold(trimmed)
            freed += len(trimmed)
            self._blocks -= len(trimmed)
            self.evicted_blocks += len(trimmed)
            self._m_evicted.inc(len(trimmed))
            if not leaf.blocks:
                self._remove(leaf)
        if freed:
            self._update_gauges()
            log.debug(
                f"radix evicted {freed} block(s) under pool pressure")
        return freed

    def _pick_victim(self) -> _Node | None:
        """Oldest leaf (policy order) with at least one trimmable tail
        block. Leaves whose tails are slot-aliased are skipped — their
        refcount >= 2 blocks must never be evicted."""
        best: _Node | None = None
        best_key = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children or not node.blocks:
                continue
            if self.alloc.ref(node.blocks[-1]) != 1:
                continue
            key = (node.last_access if self.evict_policy == "lru"
                   else node.created)
            if best is None or key < best_key:
                best, best_key = node, key
        return best

    def _remove(self, node: _Node) -> None:
        assert not node.children and not node.blocks
        parent = node.parent
        for key, child in list(parent.children.items()):
            if child is node:
                del parent.children[key]
                break
        self._nodes -= 1

    def clear(self) -> int:
        """Drop every hold and reset the tree (engine restart /
        disable). Returns blocks released."""
        released = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.blocks:
                self.alloc.unhold(node.blocks)
                released += len(node.blocks)
        self._root = _Node(None)
        self._nodes = 0
        self._blocks = 0
        self._update_gauges()
        return released

    # ---------------- observability ----------------

    def _update_gauges(self) -> None:
        self._m_nodes.set(self._nodes)
        self._m_blocks.set(self._blocks)

    def stats(self) -> dict:
        return {
            "nodes": self._nodes,
            "blocks": self._blocks,
            "evictable_blocks": self.evictable_blocks(),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": (round(self.hits / self.lookups, 4)
                         if self.lookups else 0.0),
            "hit_tokens": self.hit_tokens,
            "bytes_saved": self.hit_tokens * self.token_bytes,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "evict_policy": self.evict_policy,
        }

    def check_integrity(self) -> None:
        """Test surface: structural invariants — block-aligned runs,
        digest chains consistent, child keys correct, hold accounting
        matches the allocator."""
        bs = self.block_size
        seen: set[int] = set()
        nodes = 0

        def walk(node: _Node, digest: str) -> None:
            nonlocal nodes
            if node is not self._root:
                nodes += 1
                assert node.tokens and len(node.tokens) % bs == 0
                assert len(node.blocks) == len(node.tokens) // bs
                assert len(node.digests) == len(node.blocks)
                d = digest
                for j, blk in enumerate(node.blocks):
                    assert blk not in seen, f"block {blk} in tree twice"
                    seen.add(blk)
                    d = chain_digest(
                        d, _block_bytes(
                            node.tokens[j * bs:(j + 1) * bs]))
                    assert d == node.digests[j], "digest chain broken"
                digest = d
            for key, child in node.children.items():
                assert child.parent is node
                assert key == chain_digest(
                    digest, _block_bytes(child.tokens[:bs]))
                walk(child, digest)

        walk(self._root, "")
        assert nodes == self._nodes, \
            f"node count {self._nodes} != walked {nodes}"
        assert len(seen) == self._blocks, \
            f"block count {self._blocks} != walked {len(seen)}"
        for blk in seen:
            assert self.alloc.ref(blk) >= 1
