"""Device-resident FSM union arena for the engine's decode loop.

One batched decode step serves up to ``num_slots`` concurrent
generations, each possibly constrained by a *different* FSM. The jitted
step cannot index per-request Python objects, so every active FSM's
tables are packed into ONE set of device arrays with disjoint state
ranges, and each slot carries (state, selector) indices into them:

    masks  uint32 [state_cap, ceil(vocab/32)]   per-STATE allowed bits
    nexts  int32  [state_cap, class_cap]        per-STATE transitions
    cls    int32  [sel_cap,   vocab]            per-FSM token classes

Global state 0 is FREE (every token allowed, self-loop) — the state
every unconstrained slot sits in, so the same jitted program serves
mixed batches with the mask a no-op for free rows. Global state 1 is
DONE (EOS-only, absorbing) — where a completed constrained generation
parks while pipelined calls drain past its finish.

Capacities bucket to powers of two (bounded by the STRUCTURED_STATE_
BUDGET knob), so the jitted decode executables key on a handful of
shapes, not on every schema's exact state count. Registration happens
at admission on the engine thread; the (numpy) arena is rebuilt only
when a new FSM enters, and re-uploaded as one host→device put — never
on the per-step hot path. Released FSMs stay resident (sticky) until
capacity pressure evicts them, so the common serve-many-requests-of-
one-schema pattern uploads once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from fasttalk_tpu_torch.structured.fsm import DEAD, DONE, TokenFSM

FREE_STATE = 0
DONE_STATE = 1
_RESERVED_STATES = 2
FREE_SEL = 0
_RESERVED_SELS = 1


class ArenaFull(RuntimeError):
    """No room for another FSM while every resident one is pinned."""


@dataclass
class _Entry:
    fsm: TokenFSM
    base: int          # global state offset
    sel: int           # row in the cls table
    refs: int = 0


class FSMArena:
    """Host-side assembly of the union tables (numpy); the engine owns
    the device upload. Engine-thread only (no locking)."""

    def __init__(self, vocab: int, eos_ids: tuple[int, ...],
                 num_slots: int, state_budget: int = 8192):
        self.vocab = vocab
        self.words = (vocab + 31) // 32
        self.eos_ids = tuple(e for e in eos_ids if 0 <= e < vocab)
        self.state_budget = max(state_budget, _RESERVED_STATES + 2)
        self.sel_cap = 1 << (num_slots + _RESERVED_SELS - 1).bit_length()
        self._entries: dict[int, _Entry] = {}   # id(fsm) -> entry
        self._order: list[_Entry] = []          # registration order
        self.state_cap = 0
        self.class_cap = 0
        self.masks: np.ndarray | None = None
        self.cls: np.ndarray | None = None
        self.nexts: np.ndarray | None = None
        self.dirty = False   # device copy stale

    # ------------------------------------------------- registration

    def register(self, fsm: TokenFSM) -> _Entry:
        """Pin one FSM into the arena (idempotent per object). Raises
        ArenaFull when the state budget cannot hold it even after
        evicting every unpinned entry."""
        entry = self._entries.get(id(fsm))
        if entry is not None:
            entry.refs += 1
            return entry
        need = fsm.n_states
        if need + _RESERVED_STATES > self.state_budget:
            raise ArenaFull(
                f"FSM needs {need} states; STRUCTURED_STATE_BUDGET is "
                f"{self.state_budget} (minus {_RESERVED_STATES} "
                "reserved)")
        if self._used_states() + need > self.state_budget \
                or len(self._order) + _RESERVED_SELS >= self.sel_cap:
            self._evict(need)
        entry = _Entry(fsm=fsm, base=0, sel=0, refs=1)
        self._order.append(entry)
        self._entries[id(fsm)] = entry
        self._rebuild()
        return entry

    def release(self, fsm: TokenFSM) -> None:
        entry = self._entries.get(id(fsm))
        if entry is not None and entry.refs > 0:
            entry.refs -= 1
        # Sticky: the tables stay resident for the next request of the
        # same schema; eviction is capacity-driven only.

    def _used_states(self) -> int:
        return _RESERVED_STATES + sum(e.fsm.n_states for e in self._order)

    def _evict(self, need: int) -> None:
        """Drop oldest UNPINNED entries until ``need`` states and one
        selector row fit; raise when the pinned set alone is too big."""
        order = list(self._order)
        states = _RESERVED_STATES + sum(e.fsm.n_states for e in order)

        def fits() -> bool:
            return (states + need <= self.state_budget
                    and len(order) + _RESERVED_SELS < self.sel_cap)

        for e in list(order):
            if fits():
                break
            if e.refs <= 0:
                order.remove(e)
                states -= e.fsm.n_states
                self._entries.pop(id(e.fsm), None)
        self._order = order
        if not fits():
            raise ArenaFull(
                f"{self._used_states()} states pinned by running "
                f"requests; no room for {need} more within "
                f"STRUCTURED_STATE_BUDGET={self.state_budget}")

    # ------------------------------------------------- table build

    def _rebuild(self) -> None:
        """Re-pack every entry into fresh union tables. Offsets are
        reassigned — callers re-derive per-slot global states from the
        entries, which the engine does by patching device state from
        the host mirrors whenever the arena is dirty."""
        total = _RESERVED_STATES
        max_cls = 1
        for e in self._order:
            e.base = total
            total += e.fsm.n_states
            max_cls = max(max_cls, e.fsm.n_classes)
        state_cap = max(4, 1 << (total - 1).bit_length())
        if state_cap > self.state_budget:
            state_cap = total  # over-budget pow2 round-up: exact fit
        class_cap = max(2, 1 << (max_cls - 1).bit_length())

        masks = np.zeros((state_cap, self.words), np.uint32)
        nexts = np.full((state_cap, class_cap), DONE_STATE, np.int32)
        cls = np.zeros((self.sel_cap, self.vocab), np.int32)

        # FREE: everything (< vocab) allowed, absorbing.
        masks[FREE_STATE] = np.uint32(0xFFFFFFFF)
        tail = self.vocab % 32
        if tail:
            masks[FREE_STATE, -1] = np.uint32((1 << tail) - 1)
        nexts[FREE_STATE] = FREE_STATE
        # DONE: EOS-only, absorbing.
        for e in self.eos_ids:
            masks[DONE_STATE, e // 32] |= np.uint32(1) << np.uint32(e % 32)
        if not self.eos_ids:
            masks[DONE_STATE, 0] |= np.uint32(1)
        nexts[DONE_STATE] = DONE_STATE

        for i, e in enumerate(self._order):
            f = e.fsm
            e.sel = _RESERVED_SELS + i
            masks[e.base:e.base + f.n_states] = f.mask_words
            block = f.next.astype(np.int64, copy=True)
            live = block >= 0
            block[live] += e.base
            block[block == DEAD] = DONE_STATE  # unreachable for sampled
            block[block == DONE] = DONE_STATE
            nexts[e.base:e.base + f.n_states, :f.n_classes] = block
            # Padded class columns default to DONE_STATE (harmless:
            # only classes the FSM defines are ever gathered).
            v = min(self.vocab, len(f.cls))
            cls[e.sel, :v] = f.cls[:v]
            # EOS tokens get a dedicated class column so accept-state
            # EOS transitions land in DONE: give them class_cap-1...
            # unless the FSM already classed them (it never does — EOS
            # bytes are specials, disallowed in-body).
        # EOS transition: EOS ids are class 0 ("dead everywhere") in
        # every compiled FSM, and nexts[:, 0] for entry rows is DEAD →
        # DONE_STATE, which is exactly the wanted accept→DONE edge (the
        # mask permits EOS only in accept states, so a sampled EOS can
        # only occur there).
        self.masks, self.nexts, self.cls = masks, nexts, cls
        self.state_cap, self.class_cap = state_cap, class_cap
        self.dirty = True

    # ------------------------------------------------- accessors

    def global_state(self, entry: _Entry, local_state: int) -> int:
        if local_state == DONE:
            return DONE_STATE
        if local_state == DEAD:
            return DONE_STATE
        return entry.base + local_state

    def stats(self) -> dict:
        return {"fsms": len(self._order),
                "pinned": sum(1 for e in self._order if e.refs > 0),
                "states_used": self._used_states(),
                "state_cap": self.state_cap,
                "class_cap": self.class_cap,
                "state_budget": self.state_budget}


def pack_mask_row(fsm: TokenFSM, state: int, words: int,
                  eos_ids: tuple[int, ...]) -> np.ndarray:
    """One packed allowed-row for a host-supplied state (the masked
    first-token sample after prefill / jump-forward), padded to the
    arena's word width."""
    row = np.zeros((words,), np.uint32)
    if state in (DEAD, DONE):
        for e in eos_ids:
            row[e // 32] |= np.uint32(1) << np.uint32(e % 32)
        if not eos_ids:
            row[0] |= np.uint32(1)
        return row
    src = fsm.mask_words[state]
    row[:len(src)] = src
    return row
