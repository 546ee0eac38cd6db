"""Byte DFA → token-level FSM over a real tokenizer vocabulary.

The per-step decode mask needs *token*-level transitions: token ``t``
is allowed in DFA state ``s`` iff walking t's UTF-8 bytes from ``s``
stays inside the (live-pruned) DFA; the token transition is the state
the walk ends in. Lifting walks a byte trie of the whole vocabulary
once per state, so shared token prefixes are walked once (the
Outlines §4 index construction, trie-shared).

Device representation (consumed by structured/runtime.py):

- ``mask_words``  uint32 [n_states, ceil(vocab/32)] — packed allowed
  bitmask, one row gathered per slot per decode step on device.
- token **classes**: tokens with identical transition columns share a
  class, so the next-state table is [n_states, n_classes] instead of
  [n_states, vocab] — for JSON FSMs the class count is tens-to-
  hundreds where the vocab is tens of thousands, which is what makes
  the table small enough to live in HBM next to the KV cache.
- ``next``  int32 [n_states, n_classes], local state ids; ``DEAD`` (-1)
  where disallowed (never gathered for a *sampled* token — the mask
  already excluded it). EOS transitions are implicit: EOS ids sit in
  the dead class, and the host ``step()`` / the arena's table assembly
  turn accept-state EOS into the absorbing ``DONE`` sentinel.

EOS handling is compiled in: accepting states allow the tokenizer's
EOS ids (→ DONE); non-accepting states never do — which is exactly the
"model cannot end the document early" half of the validity guarantee.
Tokens that decode to nothing (specials, padding) are disallowed
everywhere: they would be invisible no-progress loops inside a
constrained generation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from fasttalk_tpu_torch.structured.regex_dfa import DFA

DEAD = -1
DONE = -2

# Forced chains longer than this are cut (jump-forward consumes the
# rest on its next trigger); also the cycle guard for degenerate FSMs.
MAX_FORCED_CHAIN = 512


class FSMTooLarge(ValueError):
    """Compiled FSM exceeds the configured state budget."""


# ---------------------------------------------------- token bytes

def _bytelevel_map() -> dict[str, int]:
    """The GPT-2 byte-level printable-unicode ↔ byte table (the
    ByteLevel pre-tokenizer's encoding; tokenizers/openai encodings
    share it)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def token_byte_table(tokenizer: Any) -> list[bytes | None]:
    """bytes each token id contributes to the output stream; None =
    never allowed in constrained output (specials, empty decodes,
    unmappable ids).

    - ByteTokenizer: ids 0..255 are raw bytes; specials are None.
    - HF fast tokenizers with a ByteLevel pre-tokenizer (the common
      llama/gpt2 family): vocab strings map through the byte-level
      table, so a token holding *half* a UTF-8 character still gets
      its exact bytes (plain decode() would mangle it to U+FFFD).
    - Anything else: per-token decode() fallback; tokens that decode
      to replacement chars are disallowed rather than guessed.
    """
    vocab = int(getattr(tokenizer, "vocab_size", 0))
    rust = getattr(tokenizer, "_tok", None)
    if rust is not None:
        table: list[bytes | None] = [None] * vocab
        bl = _bytelevel_map()
        try:
            specials = {tid for tid in
                        (rust.token_to_id(t.content)
                         for t in rust.get_added_tokens_decoder().values())
                        if tid is not None}
        except Exception:
            specials = set()
        items = rust.get_vocab()  # token string -> id
        mapped = 0
        for tok_str, tid in items.items():
            if tid >= vocab or tid in specials:
                continue
            try:
                table[tid] = bytes(bl[ch] for ch in tok_str)
                mapped += 1
            except KeyError:
                table[tid] = None
        if mapped >= 0.5 * max(1, len(items)):
            return table
        # Not a ByteLevel vocab: decode each id individually.
        table = [None] * vocab
        for tid in range(vocab):
            if tid in specials:
                continue
            text = tokenizer.decode([tid])
            if text and "�" not in text:
                table[tid] = text.encode("utf-8")
        return table
    # Byte-fallback tokenizer (engine/tokenizer.ByteTokenizer shape):
    # ids below 256 are raw bytes, everything above is special.
    table = [None] * vocab
    for tid in range(min(256, vocab)):
        table[tid] = bytes([tid])
    return table


# ---------------------------------------------------- the token FSM

@dataclass
class TokenFSM:
    """One compiled constraint over one tokenizer (immutable; shared
    across requests via the compiler cache)."""

    n_states: int
    start: int
    vocab: int
    n_classes: int
    cls: np.ndarray          # int32 [vocab] — token -> class (0 = dead)
    next: np.ndarray         # int32 [n_states, n_classes]
    mask_words: np.ndarray   # uint32 [n_states, ceil(vocab/32)]
    accept: frozenset[int]
    # Exactly-one-token states: the forced token id, else -1.
    forced_tok: np.ndarray   # int32 [n_states]
    eos_ids: tuple[int, ...]
    pattern: str = ""
    _chains: dict[int, tuple[list[int], int]] = field(
        default_factory=dict, repr=False)

    def step(self, state: int, token_id: int) -> int:
        """Host-side transition (mirrors the device gather)."""
        if state in (DEAD, DONE):
            return state
        if token_id in self.eos_ids:
            return DONE if state in self.accept else DEAD
        if token_id >= self.vocab:
            return DEAD
        return int(self.next[state, self.cls[token_id]])

    def is_terminal(self, state: int) -> bool:
        """Accepting with EOS as the only allowed continuation: the
        document is complete and the engine may finish with
        finish_reason "stop" without spending a step on the EOS."""
        return state in self.accept and int(self.forced_tok[state]) == -2

    def forced_chain(self, state: int) -> tuple[list[int], int]:
        """The maximal single-outgoing-transition chain from ``state``
        (empty when the state allows a choice or is accepting): the
        tokens jump-forward can emit without model steps, and the state
        the chain ends in. Cached per state; chains are capped at
        MAX_FORCED_CHAIN (the follow-up trigger consumes the rest)."""
        hit = self._chains.get(state)
        if hit is not None:
            return hit
        chain: list[int] = []
        cur = state
        while (cur not in (DEAD, DONE) and cur not in self.accept
               and len(chain) < MAX_FORCED_CHAIN):
            tok = int(self.forced_tok[cur])
            if tok < 0:
                break
            chain.append(tok)
            cur = int(self.next[cur, self.cls[tok]])
        out = (chain, cur)
        self._chains[state] = out
        return out

    @property
    def nbytes(self) -> int:
        return (self.cls.nbytes + self.next.nbytes
                + self.mask_words.nbytes + self.forced_tok.nbytes)


def lift_dfa(dfa: DFA, token_bytes: Sequence[bytes | None],
             eos_ids: Sequence[int], vocab: int,
             max_states: int = 4096, pattern: str = "") -> TokenFSM:
    """Lift a byte DFA to a TokenFSM over ``vocab`` token ids.

    ``token_bytes`` may cover fewer ids than ``vocab`` (model vocab
    larger than tokenizer vocab); uncovered ids are disallowed.
    """
    # Byte trie over the vocabulary: node = (children: {byte: node},
    # token ids ending exactly here).
    root: dict = {}
    ends_here: dict[int, list[int]] = {}  # id(trie node) -> token ids
    for tid in range(min(vocab, len(token_bytes))):
        tb = token_bytes[tid]
        if not tb:  # None or empty: invisible in output — disallowed
            continue
        node = root
        for b in tb:
            node = node.setdefault(b, {})
        ends_here.setdefault(id(node), []).append(tid)

    # Per-state token transitions, collected by DFS over (trie, DFA).
    def lift_state(s: int) -> dict[int, int]:
        row: dict[int, int] = {}
        stack = [(root, s)]
        while stack:
            node, ds = stack.pop()
            toks = ends_here.get(id(node))
            if toks is not None:
                for tid in toks:
                    row[tid] = ds
            trans = dfa.transitions[ds]
            for b, child in node.items():
                nxt = trans.get(b)
                if nxt is not None:
                    stack.append((child, nxt))
        return row

    # Only TOKEN-level reachable states matter: a byte-DFA state in the
    # middle of a multi-byte character (or mid-keyword) is walked
    # *through* by a token but never rested in when the vocabulary only
    # spells that region with merged tokens — such states legitimately
    # have no token of their own and must not fail compilation (nor
    # waste mask rows). BFS from start over token transitions.
    lifted_by_old: dict[int, dict[int, int]] = {}
    work = [dfa.start]
    while work:
        s = work.pop()
        if s in lifted_by_old:
            continue
        if len(lifted_by_old) >= max_states:
            # The bound is on TOKEN-FSM states — what the device arena
            # actually holds — not on the (typically much larger) byte
            # DFA (compile_regex carries its own resource guard).
            # Checked mid-BFS so an oversized schema stops lifting
            # immediately instead of finishing the walk first.
            raise FSMTooLarge(
                f"token FSM exceeds {max_states} states "
                f"(STRUCTURED_MAX_STATES); simplify the schema or "
                "raise the knob")
        row = lift_state(s)
        lifted_by_old[s] = row
        work.extend(ds for ds in row.values()
                    if ds not in lifted_by_old)
    order = sorted(lifted_by_old)
    remap = {old: new for new, old in enumerate(order)}
    n = len(order)
    lifted: list[dict[int, int]] = [
        {tid: remap[ds] for tid, ds in lifted_by_old[old].items()}
        for old in order
    ]
    accept_set = frozenset(remap[s] for s in dfa.accept
                           if s in remap)
    start = remap[dfa.start]

    eos = tuple(sorted({e for e in eos_ids if 0 <= e < vocab}))

    # Token classes: group tokens by their full transition column.
    cols: dict[int, list[tuple[int, int]]] = {}
    for s in range(n):
        for tid, ds in lifted[s].items():
            cols.setdefault(tid, []).append((s, ds))
    class_of: dict[tuple, int] = {}
    cls = np.zeros((vocab,), np.int32)  # class 0 = dead everywhere
    class_rows: list[list[tuple[int, int]]] = [[]]
    for tid, col in cols.items():
        key = tuple(col)
        ci = class_of.get(key)
        if ci is None:
            ci = len(class_rows)
            class_of[key] = ci
            class_rows.append(col)
        cls[tid] = ci

    n_classes = len(class_rows)
    nxt = np.full((n, n_classes), DEAD, np.int32)
    for ci, col in enumerate(class_rows):
        if ci == 0:
            continue
        for s, ds in col:
            nxt[s, ci] = ds

    # Packed masks + forced-token detection.
    words = (vocab + 31) // 32
    mask = np.zeros((n, words), np.uint32)
    forced = np.full((n,), -1, np.int32)
    for s in range(n):
        row = lifted[s]
        ids = np.fromiter(row.keys(), np.int64, len(row)) \
            if row else np.empty((0,), np.int64)
        if len(ids):
            np.bitwise_or.at(mask[s], ids // 32,
                             np.uint32(1) << (ids % 32).astype(np.uint32))
        if s in accept_set:
            for e in eos:
                mask[s, e // 32] |= np.uint32(1) << np.uint32(e % 32)
            if not row:
                forced[s] = -2  # terminal: EOS-only continuation
            if not eos and not row:
                # No EOS in vocab and nothing else allowed: the state
                # must still offer one legal bit or on-device sampling
                # degenerates; allow token 0 (host finishes first via
                # is_terminal, so this is belt-and-braces).
                mask[s, 0] |= np.uint32(1)
        elif len(ids) == 1:
            forced[s] = int(ids[0])
        elif not row:
            # A token-REACHABLE non-accepting state with no outgoing
            # token: the vocabulary genuinely cannot spell any
            # continuation of this constraint (e.g. a tokenizer with
            # no way to write '{'). Masking cannot fix that — fail
            # with a client-shape error.
            raise FSMTooLarge(
                f"state {s} has no allowed token: the tokenizer cannot "
                "spell any continuation of this constraint")

    return TokenFSM(n_states=n, start=start, vocab=vocab,
                    n_classes=n_classes, cls=cls, next=nxt,
                    mask_words=mask, accept=accept_set,
                    forced_tok=forced, eos_ids=eos, pattern=pattern)
