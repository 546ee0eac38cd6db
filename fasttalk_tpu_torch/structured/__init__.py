"""Structured decoding: grammar/JSON-schema-constrained generation.

Schema → regex → byte DFA → token FSM, applied as a per-slot packed-
bitmask logit mask inside the jitted decode step, with jump-forward
emission of forced token runs. See docs/STRUCTURED.md.
"""

from fasttalk_tpu_torch.structured.compiler import (
    FSMCompiler, StructuredError, validate_structured_spec)
from fasttalk_tpu_torch.structured.fsm import (
    DEAD, DONE, FSMTooLarge, TokenFSM, lift_dfa, token_byte_table)
from fasttalk_tpu_torch.structured.regex_dfa import (
    DFA, RegexError, compile_regex)
from fasttalk_tpu_torch.structured.runtime import (
    ArenaFull, FSMArena, DONE_STATE, FREE_SEL, FREE_STATE, pack_mask_row)
from fasttalk_tpu_torch.structured.schema import (
    SchemaError, json_object_regex, schema_to_regex, tool_call_regex)

__all__ = [
    "FSMCompiler", "StructuredError", "validate_structured_spec",
    "TokenFSM", "FSMTooLarge", "lift_dfa", "token_byte_table",
    "DEAD", "DONE", "DFA", "RegexError", "compile_regex",
    "ArenaFull", "FSMArena", "DONE_STATE", "FREE_SEL", "FREE_STATE",
    "pack_mask_row", "SchemaError", "json_object_regex",
    "schema_to_regex", "tool_call_regex",
]
