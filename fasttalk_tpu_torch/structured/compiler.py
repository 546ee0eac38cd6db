"""Structured-spec normalisation + the (schema, tokenizer) FSM cache.

A constrained request carries a *spec* (validated at the serving edge,
GenerationParams.validate_structured_spec): one of

    {"kind": "json_object"}
    {"kind": "json_schema", "schema": {...}}
    {"kind": "regex",       "regex": "..."}
    {"kind": "tool_call",   "tools": [{"name", "parameters"}, ...]}

Compilation (schema → regex → byte DFA → token FSM) is pure host work
— milliseconds for chat-scale schemas on a small vocab, whole seconds
for a large schema over a 100k vocab — so it runs on a dedicated
single worker thread (``compile_fsm_async``), never on the engine
thread or the event loop: admission is never blocked by a cold schema.
Results are LRU-cached per (canonical spec, tokenizer identity); a hot
schema costs one dict lookup. In-flight compiles of the same key are
deduplicated (a burst of identical response_format requests compiles
once).

Observability: ``fsm_compile_ms`` histogram (cache misses only),
``structured_fsm_cache_{hits,misses}_total`` counters.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.structured.fsm import (
    TokenFSM, lift_dfa, token_byte_table)
from fasttalk_tpu_torch.structured.regex_dfa import RegexError, compile_regex
from fasttalk_tpu_torch.structured.schema import (
    SchemaError, json_object_regex, schema_to_regex, tool_call_regex)
from fasttalk_tpu_torch.utils.metrics import get_metrics

STRUCTURED_KINDS = ("json_object", "json_schema", "regex", "tool_call")


class StructuredError(ValueError):
    """Bad or uncompilable structured spec — a client-shape error
    (400 / invalid_config), never a 500."""


def validate_structured_spec(spec: Any) -> dict:
    """Shape-check a client-supplied spec; returns it normalised.
    Raises StructuredError naming the bad field."""
    if not isinstance(spec, dict):
        raise StructuredError(
            f"structured must be an object with a 'kind', got "
            f"{type(spec).__name__}")
    kind = spec.get("kind")
    if kind not in STRUCTURED_KINDS:
        raise StructuredError(
            f"structured.kind must be one of {STRUCTURED_KINDS}, "
            f"got {kind!r}")
    if kind == "json_schema" and not isinstance(spec.get("schema"), dict):
        raise StructuredError(
            "structured.schema must be a JSON Schema object")
    if kind == "regex" and not (isinstance(spec.get("regex"), str)
                                and spec["regex"]):
        raise StructuredError(
            "structured.regex must be a non-empty pattern string")
    if kind == "tool_call" and not (isinstance(spec.get("tools"), list)
                                    and spec["tools"]):
        raise StructuredError(
            "structured.tools must be a non-empty tool-spec list")
    return spec


def spec_key(spec: dict, json_depth: int) -> str:
    """Cache key: kind + payload with KEY ORDER PRESERVED — object
    property declaration order is part of the compiled contract (the
    document emits properties in that order), so two schemas differing
    only in property order must NOT alias to one FSM. Wrapper-level
    key-order differences merely cost a cache miss."""
    return json.dumps({**spec, "_depth": json_depth},
                      separators=(",", ":"), default=str)


def spec_to_regex(spec: dict, json_depth: int) -> str:
    kind = spec["kind"]
    try:
        if kind == "json_object":
            return json_object_regex(json_depth)
        if kind == "json_schema":
            return schema_to_regex(spec["schema"])
        if kind == "regex":
            return spec["regex"]
        return tool_call_regex(spec["tools"])
    except (SchemaError, RegexError) as e:
        raise StructuredError(f"structured spec does not compile: {e}") \
            from e


class FSMCompiler:
    """LRU of compiled TokenFSMs for ONE tokenizer (engine-owned: the
    tokenizer's vocab is baked into every compiled table)."""

    def __init__(self, tokenizer: Any, *, cache_size: int = 64,
                 max_states: int = 4096, json_depth: int = 3,
                 sample_vocab: int | None = None):
        self._tokenizer = tokenizer
        self._cache_size = max(1, cache_size)
        self.max_states = max_states
        self.json_depth = json_depth
        self.sample_vocab = (sample_vocab if sample_vocab is not None
                             else int(getattr(tokenizer, "vocab_size",
                                              0)))
        self._lock = threading.Lock()
        self._cache: OrderedDict[str, TokenFSM] = OrderedDict()
        self._inflight: dict[str, Future] = {}
        self._token_bytes: list[bytes | None] | None = None  # lazy
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="fsm-compile")
        m = get_metrics()
        self._m_ms = m.histogram(
            "fsm_compile_ms",
            "schema->regex->DFA->token-FSM compile wall time "
            "(cache misses only)",
            buckets=(1, 4, 16, 64, 256, 1000, 4000, 16000))
        self._m_hit = m.counter("structured_fsm_cache_hits_total",
                                "FSM compile cache hits")
        self._m_miss = m.counter("structured_fsm_cache_misses_total",
                                 "FSM compile cache misses")

    def _tbl(self) -> list[bytes | None]:
        # Built once per engine (vocab scan); guarded by _lock callers.
        if self._token_bytes is None:
            self._token_bytes = token_byte_table(self._tokenizer)
        return self._token_bytes

    def compile(self, spec: dict) -> TokenFSM:
        """Synchronous compile-or-cache (the worker thread's body; also
        usable directly from tests/bench)."""
        key = spec_key(spec, self.json_depth)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self._m_hit.inc()
                return hit
        self._m_miss.inc()
        if _fp.enabled:
            # Chaos seam (docs/RESILIENCE.md): a compile-worker fault
            # is a client-shape error (StructuredError -> 400 /
            # invalid_config at the engine seam), never a 500 and
            # never a breaker hit.
            _fp.fire("structured.compile", exc=StructuredError)
        t0 = time.monotonic()
        pattern = spec_to_regex(spec, self.json_depth)
        try:
            dfa = compile_regex(pattern,
                                max_states=max(self.max_states * 4,
                                               1 << 14))
        except RegexError as e:
            raise StructuredError(
                f"structured spec does not compile: {e}") from e
        with self._lock:
            tbl = self._tbl()
        eos = sorted(getattr(self._tokenizer, "eos_ids", ()) or ())
        fsm = lift_dfa(dfa, tbl, eos, self.sample_vocab,
                       max_states=self.max_states, pattern=pattern)
        self._m_ms.observe((time.monotonic() - t0) * 1000)
        with self._lock:
            self._cache[key] = fsm
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return fsm

    async def compile_async(self, spec: dict) -> TokenFSM:
        """Event-loop-friendly compile: cache hit returns immediately;
        a miss runs on the compile worker with in-flight dedup."""
        key = spec_key(spec, self.json_depth)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self._m_hit.inc()
                return hit
            fut = self._inflight.get(key)
            if fut is None:
                fut = self._pool.submit(self.compile, spec)
                self._inflight[key] = fut

                def _clear(_f, key=key):
                    with self._lock:
                        self._inflight.pop(key, None)

                fut.add_done_callback(_clear)
        return await asyncio.wrap_future(fut)

    def stats(self) -> dict:
        with self._lock:
            return {"cached": len(self._cache),
                    "cache_size": self._cache_size,
                    "bytes": sum(f.nbytes for f in self._cache.values())}

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
