"""JSON Schema → regex over the in-tree dialect (regex_dfa.py).

The Outlines lowering (Willard & Louf 2023): a schema compiles to one
anchored regex whose language is a subset of the schema's valid
documents; the regex then compiles to a byte DFA and a token FSM. The
subset is deliberate — regular languages cannot carry full JSON Schema
— and every narrowing is explicit:

- **Compact form.** No optional whitespace: one canonical rendering
  (``{"a":1,"b":[2,3]}``-style with no spaces). SGLang's compressed-FSM
  observation applies directly: fixed punctuation becomes single-path
  FSM chains that jump-forward can emit without model steps.
- **Objects.** Properties appear in declaration order and are all
  required (a "required" list naming a subset is rejected with the
  property names, not silently widened). additionalProperties are not
  generated.
- **Recursion.** ``$ref`` into ``$defs``/``definitions`` is inlined;
  a reference cycle is rejected (a recursive schema is not regular).
- **Strings.** JSON string syntax with the standard escapes; full
  unicode bodies (the DFA walks UTF-8 byte-wise). ``enum``/``const``
  compile to exact alternatives; ``pattern`` is rejected by name
  (user-supplied patterns are outside the supported dialect's
  guarantees).
- **json_object mode.** "Any JSON" is not regular either; the generic
  grammar unrolls to ``max_depth`` nesting levels (STRUCTURED_JSON_
  DEPTH), scalars-only at the innermost level.
"""

from __future__ import annotations

import json
from typing import Any


class SchemaError(ValueError):
    """Unsupported or malformed schema; the message names the spot."""


# Regex-dialect metacharacters that must be escaped in literals.
_META = set("\\.[](){}*+?|^$\"")


def _esc(text: str) -> str:
    out = []
    for ch in text:
        if ch in _META:
            out.append("\\" + ch)
        elif ord(ch) < 0x20:
            out.append(f"\\x{ord(ch):02x}")
        else:
            out.append(ch)
    return "".join(out)


# JSON scalar building blocks (compact form).
_INT = r"-?(0|[1-9][0-9]*)"
_NUMBER = _INT + r"(\.[0-9]+)?([eE][+-]?[0-9]+)?"
_BOOL = r"(true|false)"
_NULL = r"null"
# String body: any char except '"', '\' and control chars, or an
# escape sequence. Matches the JSON grammar (compact, no surrogate
# validation beyond UTF-8 well-formedness).
_CHAR = (r'([^"\\\x00-\x1f]'
         r'|\\["\\/bfnrt]'
         r'|\\u[0-9a-fA-F][0-9a-fA-F][0-9a-fA-F][0-9a-fA-F])')
_STRING = r"\"" + _CHAR + r"*\""


def _literal(value: Any) -> str:
    """A regex matching exactly this JSON value (compact encoding)."""
    return _esc(json.dumps(value, ensure_ascii=False,
                           separators=(",", ":")))


def _bound(value, name: str):
    """Length/count bounds compile to counted repeats, which unroll
    into NFA states — cap them before the regex layer must."""
    from fasttalk_tpu_torch.structured.regex_dfa import MAX_REPEAT

    if isinstance(value, int) and value > MAX_REPEAT:
        raise SchemaError(f"{name}={value} exceeds the supported "
                          f"maximum {MAX_REPEAT}")
    return value


def _string_regex(schema: dict) -> str:
    if "pattern" in schema:
        raise SchemaError(
            "string 'pattern' is not supported (user regex is outside "
            "the compiled dialect's guarantees); use enum/const or "
            "min/maxLength")
    lo = _bound(schema.get("minLength", 0), "minLength")
    hi = _bound(schema.get("maxLength"), "maxLength")
    if not isinstance(lo, int) or lo < 0:
        raise SchemaError(f"minLength must be a non-negative integer, "
                          f"got {lo!r}")
    if hi is not None and (not isinstance(hi, int) or hi < lo):
        raise SchemaError(f"maxLength must be an integer >= minLength, "
                          f"got {hi!r}")
    if lo == 0 and hi is None:
        return _STRING
    bound = f"{{{lo},{hi}}}" if hi is not None else f"{{{lo},}}"
    return r"\"" + _CHAR + bound + r"\""


def _number_regex(schema: dict, integer: bool) -> str:
    for k in ("minimum", "maximum", "exclusiveMinimum",
              "exclusiveMaximum", "multipleOf"):
        if k in schema:
            raise SchemaError(
                f"numeric bound {k!r} is not supported (not regular); "
                "use an enum of allowed values")
    return _INT if integer else _NUMBER


def _array_regex(schema: dict, defs: dict, stack: tuple) -> str:
    items = schema.get("items", True)
    item = (_value_regex(defs, stack) if items is True
            else _compile_node(items, defs, stack))
    lo = _bound(schema.get("minItems", 0), "minItems")
    hi = _bound(schema.get("maxItems"), "maxItems")
    if not isinstance(lo, int) or lo < 0:
        raise SchemaError(f"minItems must be a non-negative integer, "
                          f"got {lo!r}")
    if hi is not None and (not isinstance(hi, int) or hi < lo):
        raise SchemaError(f"maxItems must be an integer >= minItems, "
                          f"got {hi!r}")
    if hi == 0:
        return r"\[\]"
    if lo == 0:
        more = r"(," + item + r")*" if hi is None \
            else r"(," + item + r"){0," + str(hi - 1) + r"}"
        return r"\[(" + item + more + r")?\]"
    more = r"(," + item + r")"
    tail = (more + r"{" + str(lo - 1) + r",}" if hi is None
            else more + r"{" + str(lo - 1) + r"," + str(hi - 1) + r"}")
    return r"\[" + item + tail + r"\]"


def _object_regex(schema: dict, defs: dict, stack: tuple) -> str:
    """Object with properties in declaration order. A "required" list
    marks the subset that must appear (optionals may be omitted, order
    preserved); ABSENT "required" means every property is required —
    the predictable fixed shape, matching OpenAI strict mode's
    required-must-name-everything rule rather than draft semantics."""
    props = schema.get("properties")
    if props is None:
        # Free-form object: one nesting level of the generic grammar.
        return _generic_object(_value_regex(defs, stack))
    if not isinstance(props, dict):
        raise SchemaError(f"properties must be an object, got "
                          f"{type(props).__name__}")
    required = schema.get("required")
    if required is None:
        req = set(props)
    else:
        extra = [k for k in required if k not in props]
        if extra:
            raise SchemaError(f"required names undeclared "
                              f"properties: {extra}")
        req = set(required)
    if not props:
        return r"\{\}"
    items = [(_literal(name) + ":" + _compile_node(sub, defs, stack),
              name in req) for name, sub in props.items()]
    # Tail from property i on, each emission comma-prefixed; optional
    # properties wrap in (,p)? — order is fixed, so tails compose by
    # plain concatenation.
    tails = [""] * (len(items) + 1)
    for i in range(len(items) - 1, -1, -1):
        p, is_req = items[i]
        tails[i] = ("," + p + tails[i + 1] if is_req
                    else r"(," + p + r")?" + tails[i + 1])
    # First EMITTED property k carries no comma; every property before
    # it must be optional (and skipped). Empty body iff none required.
    heads = []
    for k, (p, is_req) in enumerate(items):
        heads.append(p + tails[k + 1])
        if is_req:
            break
    else:
        heads.append("")  # all optional: {} is valid
    if len(heads) == 1:
        return r"\{" + heads[0] + r"\}"
    return r"\{(" + "|".join(h if h else "()" for h in heads) + r")\}"


def _generic_object(value: str) -> str:
    member = _STRING + ":" + value
    return r"\{(" + member + r"(," + member + r")*)?\}"


def _generic_array(value: str) -> str:
    return r"\[(" + value + r"(," + value + r")*)?\]"


_SCALAR = "(" + "|".join([_STRING, _NUMBER, _BOOL, _NULL]) + ")"


def json_value_regex(max_depth: int) -> str:
    """Any JSON value, containers unrolled to ``max_depth`` levels
    (scalars only at the innermost)."""
    value = _SCALAR
    for _ in range(max(0, max_depth)):
        value = ("(" + _SCALAR + "|" + _generic_object(value) + "|"
                 + _generic_array(value) + ")")
    return value


def json_object_regex(max_depth: int) -> str:
    """A JSON *object* document (the ``json_object`` response_format
    contract) with values nested to ``max_depth``."""
    return _generic_object(json_value_regex(max(0, max_depth - 1)))


def _value_regex(defs: dict, stack: tuple) -> str:
    # Unconstrained subschema inside a constrained one: modest depth.
    return json_value_regex(2)


def _resolve_ref(ref: str, defs: dict) -> Any:
    for prefix in ("#/$defs/", "#/definitions/"):
        if ref.startswith(prefix):
            name = ref[len(prefix):]
            if name not in defs:
                raise SchemaError(f"unresolvable $ref {ref!r}")
            return name, defs[name]
    raise SchemaError(f"only local $ref into $defs/definitions is "
                      f"supported, got {ref!r}")


def _compile_node(schema: Any, defs: dict, stack: tuple) -> str:
    if schema is True or schema == {}:
        return _value_regex(defs, stack)
    if schema is False:
        raise SchemaError("schema 'false' matches nothing")
    if not isinstance(schema, dict):
        raise SchemaError(f"schema node must be an object, got "
                          f"{type(schema).__name__}")
    if "$ref" in schema:
        name, sub = _resolve_ref(schema["$ref"], defs)
        if name in stack:
            raise SchemaError(
                f"recursive $ref {schema['$ref']!r} (cycle via "
                f"{' -> '.join(stack + (name,))}); recursive schemas "
                "are not regular — bound the depth explicitly")
        return _compile_node(sub, defs, stack + (name,))
    if "const" in schema:
        return _literal(schema["const"])
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise SchemaError(f"enum must be a non-empty list, "
                              f"got {vals!r}")
        return "(" + "|".join(_literal(v) for v in vals) + ")"
    for key in ("anyOf", "oneOf"):
        if key in schema:
            opts = schema[key]
            if not isinstance(opts, list) or not opts:
                raise SchemaError(f"{key} must be a non-empty list")
            return "(" + "|".join(_compile_node(o, defs, stack)
                                  for o in opts) + ")"
    if "allOf" in schema:
        raise SchemaError("allOf is not supported (schema "
                          "intersection is not regular in general)")
    t = schema.get("type")
    if isinstance(t, list):
        return "(" + "|".join(
            _compile_node({**schema, "type": one}, defs, stack)
            for one in t) + ")"
    if t == "string":
        return _string_regex(schema)
    if t == "integer":
        return _number_regex(schema, integer=True)
    if t == "number":
        return _number_regex(schema, integer=False)
    if t == "boolean":
        return _BOOL
    if t == "null":
        return _NULL
    if t == "array":
        return _array_regex(schema, defs, stack)
    if t == "object":
        return _object_regex(schema, defs, stack)
    if t is None:
        # No type, no combinator: any value.
        return _value_regex(defs, stack)
    raise SchemaError(f"unsupported type {t!r}")


def schema_to_regex(schema: dict) -> str:
    """Compile one JSON Schema document to an anchored regex."""
    if not isinstance(schema, dict):
        raise SchemaError(f"schema must be an object, got "
                          f"{type(schema).__name__}")
    defs = {}
    for key in ("$defs", "definitions"):
        sub = schema.get(key)
        if isinstance(sub, dict):
            defs.update(sub)
    return _compile_node(schema, defs, ())


def tool_call_regex(tools: list[dict]) -> str:
    """Hermes tool-call markup with schema-constrained arguments:

        <tool_call>{"name": "N", "arguments": A}</tool_call>

    ``tools`` are hermes specs ({"name", "parameters"}); the arguments
    object of each alternative is compiled from its parameters schema.
    The field spelling matches tools_system_prompt exactly (one space
    after each colon — the format the model was instructed to emit).
    """
    if not tools:
        raise SchemaError("tool_call constraint needs at least one tool")
    alts = []
    for t in tools:
        name = t.get("name")
        if not name:
            raise SchemaError("tool spec without a name")
        params = t.get("parameters") or {"type": "object",
                                         "properties": {}}
        if not isinstance(params, dict):
            raise SchemaError(f"tool {name!r} parameters must be an "
                              "object schema")
        pdefs = {}
        for key in ("$defs", "definitions"):
            sub = params.get(key)
            if isinstance(sub, dict):
                pdefs.update(sub)
        try:
            args = _compile_node(params, pdefs, ())
        except SchemaError:
            # A tool schema outside the compilable subset (pattern,
            # numeric bounds, recursion) must not fail the whole
            # request: tool_choice enforcement degrades to "arguments
            # are a well-formed JSON object" — the markup and JSON
            # guarantees hold, only the per-field validation is
            # relaxed for THIS tool.
            args = _generic_object(json_value_regex(2))
        alts.append(r"\{\"name\": " + _literal(name)
                    + r", \"arguments\": " + args + r"\}")
    return (r"<tool_call>(" + "|".join(alts) + r")</tool_call>")
