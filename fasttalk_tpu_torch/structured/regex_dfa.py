r"""Anchored regex → byte-level DFA, pure Python (interegular-free).

The constrained-decoding compiler (docs/STRUCTURED.md) needs a DFA it
fully owns: states must be enumerable, transitions must be walkable
byte-by-byte (tokens are byte strings, and one UTF-8 character may span
several tokens of a byte-level tokenizer), and dead states must be
prunable so every reachable state is guaranteed a path to acceptance —
the property that makes the per-step logit mask a *guarantee* rather
than a heuristic. ``re`` exposes none of that, so this module compiles
a deliberately small regex dialect itself:

    literals   escapes  \\ \" \n \r \t \f \b \d \w \s and \x{hh}
    classes    [abc] [a-z0-9] [^"\\] (ranges, escapes, negation)
    any        .  (any character except newline)
    groups     ( ... )        alternation  a|b
    repeats    * + ? {m} {m,} {m,n}

The dialect is consumed only by schema.py's generators (the user never
writes raw regex against it except via the ``regex`` structured kind),
so it favours predictability over features: no backrefs, no lookaround,
no lazy quantifiers — everything stays regular and compiles to a DFA.

Unicode: patterns are character-level; compilation lowers characters to
UTF-8 bytes. A class covering "everything except a few ASCII chars"
(the JSON string-body case) lowers its non-ASCII part to the standard
well-formed-UTF-8 byte automaton, so multi-byte characters are accepted
byte-by-byte and a token carrying half a glyph still walks the DFA.
Explicit non-ASCII characters in a class lower to their byte sequences.

Thompson NFA → subset construction → reachable/live pruning. States
that cannot reach an accepting state are removed entirely; a transition
into them simply does not exist, so the token mask can never steer a
generation into a dead end.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class RegexError(ValueError):
    """Pattern outside the supported dialect (message names the spot)."""


# Counted repeats unroll into NFA copies BEFORE any DFA-size guard can
# run; an unbounded client-supplied count ("a{2000000000}") would OOM
# the compile worker at NFA construction. Generous for real schemas
# (strings/arrays longer than this have no business in a logit mask).
MAX_REPEAT = 4096


# ---------------------------------------------------------------- AST

@dataclass
class _Node:
    pass


@dataclass
class _Lit(_Node):          # one character class (set of codepoints or
    chars: object           # ("neg", frozenset) for a negated class
    # chars: frozenset[int] | tuple("neg", frozenset[int])


@dataclass
class _Cat(_Node):
    parts: list


@dataclass
class _Alt(_Node):
    options: list


@dataclass
class _Rep(_Node):
    inner: _Node
    lo: int
    hi: int | None          # None = unbounded


_ESCAPES = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "b": 0x08,
            "0": 0x00}
_CLASS_SHORTHAND = {
    "d": frozenset(range(0x30, 0x3A)),
    "w": frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
                   + list(range(0x61, 0x7B)) + [0x5F]),
    "s": frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B]),
}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> RegexError:
        return RegexError(f"{msg} at position {self.i} in {self.p!r}")

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> _Node:
        node = self.alternation()
        if self.i != len(self.p):
            raise self.error("unbalanced ')'")
        return node

    def alternation(self) -> _Node:
        options = [self.concat()]
        while self.peek() == "|":
            self.take()
            options.append(self.concat())
        return options[0] if len(options) == 1 else _Alt(options)

    def concat(self) -> _Node:
        parts: list[_Node] = []
        while True:
            ch = self.peek()
            if ch is None or ch in "|)":
                break
            parts.append(self.repeat())
        if not parts:
            return _Cat([])  # empty string
        return parts[0] if len(parts) == 1 else _Cat(parts)

    def repeat(self) -> _Node:
        atom = self.atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                atom = _Rep(atom, 0, None)
            elif ch == "+":
                self.take()
                atom = _Rep(atom, 1, None)
            elif ch == "?":
                self.take()
                atom = _Rep(atom, 0, 1)
            elif ch == "{":
                save = self.i
                self.take()
                digits = ""
                while self.peek() and self.peek().isdigit():
                    digits += self.take()
                if not digits:
                    # Not a counted repeat ("{" literal, e.g. JSON).
                    self.i = save
                    break
                lo = int(digits)
                hi: int | None = lo
                if self.peek() == ",":
                    self.take()
                    digits = ""
                    while self.peek() and self.peek().isdigit():
                        digits += self.take()
                    hi = int(digits) if digits else None
                if self.peek() != "}":
                    raise self.error("malformed {m,n} repeat")
                self.take()
                if hi is not None and hi < lo:
                    raise self.error(f"repeat bounds {{{lo},{hi}}} "
                                     "inverted")
                if max(lo, hi or 0) > MAX_REPEAT:
                    raise self.error(
                        f"repeat bound {max(lo, hi or 0)} exceeds the "
                        f"supported maximum {MAX_REPEAT}")
                atom = _Rep(atom, lo, hi)
            else:
                break
        return atom

    def atom(self) -> _Node:
        ch = self.take()
        if ch == "(":
            inner = self.alternation()
            if self.peek() != ")":
                raise self.error("missing ')'")
            self.take()
            return inner
        if ch == "[":
            return self.char_class()
        if ch == ".":
            # Any character except newline (full unicode).
            return _Lit(("neg", frozenset([0x0A])))
        if ch == "\\":
            esc = self.escape()
            # Class shorthands (\d \w \s) escape to a SET of
            # codepoints; single-char escapes to one codepoint.
            return _Lit(esc if isinstance(esc, frozenset)
                        else frozenset([esc]))
        if ch in "*+?":
            raise self.error(f"dangling quantifier {ch!r}")
        return _Lit(frozenset([ord(ch)]))

    def escape(self) -> int | frozenset:
        if self.i >= len(self.p):
            raise self.error("dangling backslash")
        ch = self.take()
        if ch in _ESCAPES:
            return _ESCAPES[ch]
        if ch in _CLASS_SHORTHAND:
            # Returned as a set; callers that need a single char reject.
            return _CLASS_SHORTHAND[ch]
        if ch == "x":
            if self.i + 1 >= len(self.p):
                raise self.error(r"\x needs two hex digits")
            hexpair = self.take() + self.take()
            try:
                return int(hexpair, 16)
            except ValueError:
                raise self.error(rf"bad \x escape {hexpair!r}") from None
        if ch == "u":
            if self.i + 3 >= len(self.p):
                raise self.error(r"\u needs four hex digits")
            quad = "".join(self.take() for _ in range(4))
            try:
                return int(quad, 16)
            except ValueError:
                raise self.error(rf"bad \u escape {quad!r}") from None
        # Everything else escapes to itself ( \{ \} \[ \" \\ \. ... ).
        return ord(ch)

    def char_class(self) -> _Node:
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        chars: set[int] = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise self.error("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            self.take()
            if ch == "\\":
                esc = self.escape()
                if isinstance(esc, frozenset):
                    chars |= esc
                    continue
                lo = esc
            else:
                lo = ord(ch)
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()  # '-'
                ch2 = self.take()
                if ch2 == "\\":
                    esc2 = self.escape()
                    if isinstance(esc2, frozenset):
                        raise self.error("class shorthand in range")
                    hi = esc2
                else:
                    hi = ord(ch2)
                if hi < lo:
                    raise self.error(f"inverted range "
                                     f"{chr(lo)}-{chr(hi)}")
                chars |= set(range(lo, hi + 1))
            else:
                chars.add(lo)
        fs = frozenset(chars)
        return _Lit(("neg", fs) if negated else fs)


# ------------------------------------------------- character → bytes

def _utf8_tail(nfa: "_NFA", src: int, dst: int, n: int) -> None:
    """n continuation bytes (0x80-0xBF) from src to dst."""
    cur = src
    for k in range(n):
        nxt = dst if k == n - 1 else nfa.new_state()
        nfa.edge(cur, nxt, range(0x80, 0xC0))
        cur = nxt


def _any_non_ascii(nfa: "_NFA", src: int, dst: int) -> None:
    """The well-formed-UTF-8 automaton for any codepoint >= 0x80
    (RFC 3629 byte ranges, surrogate-range excluded)."""
    # 2-byte: C2-DF 80-BF
    s = nfa.new_state()
    nfa.edge(src, s, range(0xC2, 0xE0))
    _utf8_tail(nfa, s, dst, 1)
    # 3-byte: E0 A0-BF 80-BF
    s = nfa.new_state()
    nfa.edge(src, s, [0xE0])
    t = nfa.new_state()
    nfa.edge(s, t, range(0xA0, 0xC0))
    _utf8_tail(nfa, t, dst, 1)
    # 3-byte: E1-EC / EE-EF 80-BF 80-BF
    s = nfa.new_state()
    nfa.edge(src, s, list(range(0xE1, 0xED)) + [0xEE, 0xEF])
    _utf8_tail(nfa, s, dst, 2)
    # 3-byte: ED 80-9F 80-BF (surrogates D800-DFFF excluded)
    s = nfa.new_state()
    nfa.edge(src, s, [0xED])
    t = nfa.new_state()
    nfa.edge(s, t, range(0x80, 0xA0))
    _utf8_tail(nfa, t, dst, 1)
    # 4-byte: F0 90-BF ..., F1-F3 80-BF ..., F4 80-8F ...
    s = nfa.new_state()
    nfa.edge(src, s, [0xF0])
    t = nfa.new_state()
    nfa.edge(s, t, range(0x90, 0xC0))
    _utf8_tail(nfa, t, dst, 2)
    s = nfa.new_state()
    nfa.edge(src, s, range(0xF1, 0xF4))
    _utf8_tail(nfa, s, dst, 3)
    s = nfa.new_state()
    nfa.edge(src, s, [0xF4])
    t = nfa.new_state()
    nfa.edge(s, t, range(0x80, 0x90))
    _utf8_tail(nfa, t, dst, 2)


# An explicit non-ASCII class larger than this must use the negated
# form instead (enumerating each char's byte sequence would explode).
_MAX_EXPLICIT_NON_ASCII = 4096


# ---------------------------------------------------------------- NFA

class _NFA:
    """Thompson NFA over the byte alphabet. Edges carry byte iterables;
    epsilon edges are kept separately."""

    def __init__(self) -> None:
        self.edges: list[dict[int, set[int]]] = []  # state -> byte -> dsts
        self.eps: list[set[int]] = []

    def new_state(self) -> int:
        self.edges.append({})
        self.eps.append(set())
        return len(self.edges) - 1

    def edge(self, src: int, dst: int, bytes_: object) -> None:
        d = self.edges[src]
        for b in bytes_:
            d.setdefault(b, set()).add(dst)

    def epsilon(self, src: int, dst: int) -> None:
        self.eps[src].add(dst)

    # -- fragment builders: each returns nothing, wiring src → dst.

    def lit(self, src: int, dst: int, chars: object) -> None:
        if isinstance(chars, tuple) and chars[0] == "neg":
            excluded = chars[1]
            ascii_ok = [c for c in range(0x80) if c not in excluded]
            self.edge(src, dst, ascii_ok)
            non_ascii_excl = {c for c in excluded if c >= 0x80}
            if not non_ascii_excl:
                _any_non_ascii(self, src, dst)
            else:
                raise RegexError(
                    "negated class excluding non-ASCII characters is "
                    "not supported (JSON never needs it)")
            return
        ascii_chars = [c for c in chars if c < 0x80]
        if ascii_chars:
            self.edge(src, dst, ascii_chars)
        non_ascii = [c for c in chars if c >= 0x80]
        if len(non_ascii) > _MAX_EXPLICIT_NON_ASCII:
            raise RegexError(
                f"character class with {len(non_ascii)} explicit "
                "non-ASCII characters; use a negated class instead")
        for c in non_ascii:
            seq = chr(c).encode("utf-8")
            cur = src
            for k, b in enumerate(seq):
                nxt = dst if k == len(seq) - 1 else self.new_state()
                self.edge(cur, nxt, [b])
                cur = nxt

    def build(self, node: _Node, src: int, dst: int) -> None:
        if isinstance(node, _Lit):
            self.lit(src, dst, node.chars)
        elif isinstance(node, _Cat):
            cur = src
            for i, part in enumerate(node.parts):
                nxt = dst if i == len(node.parts) - 1 else self.new_state()
                self.build(part, cur, nxt)
                cur = nxt
            if not node.parts:
                self.epsilon(src, dst)
        elif isinstance(node, _Alt):
            for opt in node.options:
                self.build(opt, src, dst)
        elif isinstance(node, _Rep):
            cur = src
            for _ in range(node.lo):  # mandatory copies
                nxt = self.new_state()
                self.build(node.inner, cur, nxt)
                cur = nxt
            if node.hi is None:
                # cur -ε-> dst with a loop state for inner*
                loop = self.new_state()
                self.epsilon(cur, loop)
                self.build(node.inner, loop, loop)
                self.epsilon(loop, dst)
            else:
                self.epsilon(cur, dst)
                for _ in range(node.hi - node.lo):  # optional copies
                    nxt = self.new_state()
                    self.build(node.inner, cur, nxt)
                    self.epsilon(nxt, dst)
                    cur = nxt
        else:  # pragma: no cover
            raise RegexError(f"unknown node {node!r}")


# ---------------------------------------------------------------- DFA

@dataclass
class DFA:
    """Byte-level DFA: ``transitions[s]`` maps byte → state; ``accept``
    is the accepting-state set; every state is reachable AND live (can
    reach an accepting state)."""

    transitions: list[dict[int, int]] = field(default_factory=list)
    accept: frozenset[int] = frozenset()
    start: int = 0

    @property
    def n_states(self) -> int:
        return len(self.transitions)

    def walk(self, state: int, data: bytes) -> int | None:
        """Walk ``data`` from ``state``; None on a missing edge."""
        for b in data:
            nxt = self.transitions[state].get(b)
            if nxt is None:
                return None
            state = nxt
        return state

    def matches(self, data: bytes) -> bool:
        end = self.walk(self.start, data)
        return end is not None and end in self.accept


def compile_regex(pattern: str, max_states: int = 1 << 16) -> DFA:
    """Parse + compile one anchored pattern to a pruned byte DFA.

    ``max_states`` bounds the subset construction — a pathological
    pattern fails with a named error instead of eating the host.
    """
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    s0, s1 = nfa.new_state(), nfa.new_state()
    nfa.build(ast, s0, s1)

    def closure(states) -> frozenset[int]:
        out: set[int] = set()
        stack = list(states)
        while stack:
            s = stack.pop()
            if s in out:
                continue
            out.add(s)
            stack.extend(nfa.eps[s])
        return frozenset(out)

    start = closure([s0])
    index: dict[frozenset[int], int] = {start: 0}
    trans: list[dict[int, int]] = [{}]
    accept: set[int] = set()
    if s1 in start:
        accept.add(0)
    work = [start]
    while work:
        cur = work.pop()
        ci = index[cur]
        # byte → union of NFA destinations
        by_byte: dict[int, set[int]] = {}
        for s in cur:
            for b, dsts in nfa.edges[s].items():
                by_byte.setdefault(b, set()).update(dsts)
        for b, dsts in by_byte.items():
            nxt = closure(dsts)
            ni = index.get(nxt)
            if ni is None:
                ni = len(trans)
                if ni >= max_states:
                    raise RegexError(
                        f"DFA exceeds {max_states} states for "
                        f"pattern of length {len(pattern)}")
                index[nxt] = ni
                trans.append({})
                if s1 in nxt:
                    accept.add(ni)
                work.append(nxt)
            trans[ci][b] = ni

    return _prune(DFA(trans, frozenset(accept), 0))


def _prune(dfa: DFA) -> DFA:
    """Keep only states that are reachable from start AND can reach an
    accepting state. This is what upgrades the token mask from "locally
    legal byte" to "a completion to a valid document always exists"."""
    n = dfa.n_states
    # Live: reverse reachability from accepting states.
    rev: list[set[int]] = [set() for _ in range(n)]
    for s, edges in enumerate(dfa.transitions):
        for dst in edges.values():
            rev[dst].add(s)
    live: set[int] = set()
    stack = list(dfa.accept)
    while stack:
        s = stack.pop()
        if s in live:
            continue
        live.add(s)
        stack.extend(rev[s])
    if dfa.start not in live:
        raise RegexError("pattern matches nothing")
    # Reachable within live states.
    keep: set[int] = set()
    stack = [dfa.start]
    while stack:
        s = stack.pop()
        if s in keep:
            continue
        keep.add(s)
        stack.extend(d for d in dfa.transitions[s].values() if d in live)
    remap = {old: new for new, old in enumerate(sorted(keep))}
    trans = [
        {b: remap[d] for b, d in dfa.transitions[old].items() if d in keep}
        for old in sorted(keep)
    ]
    return DFA(trans, frozenset(remap[s] for s in dfa.accept if s in keep),
               remap[dfa.start])
