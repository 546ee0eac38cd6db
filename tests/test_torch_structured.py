"""Structured decoding of fasttalk_tpu_torch held against the JAX package.

The copied ``structured/`` modules (regex -> byte DFA, JSON Schema ->
regex, the token FSM, the union arena) give the JAX package's tables array
for array, and the same error messages, for the inputs of
tests/test_structured.py, over the byte tokenizer, the tinychat BPE and
tinychat's BPE with the JSON punctuation added. The constrained decode step
(``plain_steps`` with ``FSMTables``) gives the tokens and FSM states of
JAX's ``decode_fsm`` on test-tiny. ``TorchEngine(device="cpu")`` on the
trained tinychat checkpoint gives ``TPUEngine``'s greedy constrained text
token for token on the dense and paged caches, the int8 KV cache and int4
weights, with jump-forward on and off. The engine's behaviour follows
tests/test_structured.py: mixed batches, sampled batteries, cancel,
mid-stream repacks, slot reuse, spec pause and resume, the stats surface.
"""

import asyncio
import json
import os
import shutil

import numpy as np
import pytest
import torch

from fasttalk_tpu.structured import compiler as jcompiler
from fasttalk_tpu.structured import fsm as jfsm
from fasttalk_tpu.structured import regex_dfa as jdfa
from fasttalk_tpu.structured import runtime as jruntime
from fasttalk_tpu.structured import schema as jschema
from fasttalk_tpu_torch.structured import compiler as tcompiler
from fasttalk_tpu_torch.structured import fsm as tfsm
from fasttalk_tpu_torch.structured import regex_dfa as tdfa
from fasttalk_tpu_torch.structured import runtime as truntime
from fasttalk_tpu_torch.structured import schema as tschema
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
TINYCHAT = os.path.join(ASSETS, "tinychat")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
FINITE_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 6},
    "mood": {"enum": ["happy", "sad"]},
    "ok": {"type": "boolean"}}}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)




def validates(instance, schema) -> bool:
    """The supported schema subset, checked by hand."""
    if "const" in schema:
        return instance == schema["const"]
    if "enum" in schema:
        return instance in schema["enum"]
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return any(validates(instance, s) for s in schema[key])
    t = schema.get("type")
    if t == "object":
        if not isinstance(instance, dict):
            return False
        props = schema.get("properties", {})
        req = schema.get("required")
        req = set(props) if req is None else set(req)
        return req <= set(instance) <= set(props) and all(
            validates(v, props[k]) for k, v in instance.items())
    if t == "array":
        if not isinstance(instance, list):
            return False
        if not schema.get("minItems", 0) <= len(instance) \
                <= schema.get("maxItems", len(instance)):
            return False
        items = schema.get("items")
        return items is None or all(validates(v, items) for v in instance)
    if t == "string":
        return isinstance(instance, str) \
            and schema.get("minLength", 0) <= len(instance) \
            <= schema.get("maxLength", len(instance))
    if t == "integer":
        return isinstance(instance, int) and not isinstance(instance, bool)
    if t == "boolean":
        return isinstance(instance, bool)
    if t == "null":
        return instance is None
    return True


# ---------------------------------------------------------------------
# The copied modules against their originals
# ---------------------------------------------------------------------

REGEXES = [r"ab+(c|d)?", r"[a-c]{2,3}[0-9]+", r"\{a{2}\}", r'"[^"\\]*"',
           "café", r"a[bc]d", r"\d+-\w\s?", r"(yes|no)!", r"[ab]{150}",
           r"[?_a]{6}"]
BAD_REGEXES = [r"a(b", r"*a", r"[z-a]", r"[abc", r"a{2000000000}"]
SCHEMAS = [
    {"type": "integer"}, {"type": "number"}, {"type": "boolean"},
    {"type": "null"}, {"type": "string"}, FINITE_SCHEMA,
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"}}},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 1,
     "maxItems": 3},
    {"enum": ["a b", 3, None, True]}, {"const": {"k": [1]}},
    {"anyOf": [{"type": "integer"}, {"type": "null"}]},
    {"type": "object", "properties": {"a": {"$ref": "#/$defs/leaf"}},
     "$defs": {"leaf": {"type": "boolean"}}},
    {"type": "object", "properties": {
        "a": {"type": "boolean"}, "b": {"type": "integer"},
        "c": {"type": "null"}}, "required": ["b"]},
    {"type": "object", "properties": {"x": {"type": "boolean"}},
     "required": []},
]
BAD_SCHEMAS = [
    {"type": "object", "properties": {"a": {"$ref": "#/$defs/node"}},
     "$defs": {"node": {"type": "object", "properties": {
         "next": {"$ref": "#/$defs/node"}}}}},
    {"type": "string", "pattern": "a+"}, {"type": "integer", "minimum": 3},
    {"allOf": [{"type": "integer"}]},
    {"type": "object", "properties": {"a": {"type": "integer"}},
     "required": ["a", "zz"]},
    {"type": "string", "minLength": 1000000000},
    {"type": "array", "maxItems": 99999999},
]
TOOLS = [[{"name": "get_weather", "parameters": {
    "type": "object", "properties": {"city": {"type": "string"}}}},
          {"name": "noop", "parameters": None}],
         [{"name": "grep", "parameters": {"type": "object", "properties": {
             "expr": {"type": "string", "pattern": "a+"}}}}]]


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the message is the result
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("pattern", REGEXES + BAD_REGEXES)
def test_regex_dfa_equals_jax(pattern):
    """Same DFA (transitions, accept states, start), or the same error."""
    err = _error(jdfa.compile_regex, pattern)
    assert _error(tdfa.compile_regex, pattern) == err
    if err is not None:
        return
    j, t = jdfa.compile_regex(pattern), tdfa.compile_regex(pattern)
    assert (t.transitions, t.accept, t.start) == \
        (j.transitions, j.accept, j.start)


@pytest.mark.parametrize("schema", SCHEMAS + BAD_SCHEMAS,
                         ids=lambda s: json.dumps(s)[:40])
def test_schema_regex_equals_jax(schema):
    """Same regex text, or the same error message."""
    err = _error(jschema.schema_to_regex, schema)
    assert _error(tschema.schema_to_regex, schema) == err
    if err is None:
        assert tschema.schema_to_regex(schema) == \
            jschema.schema_to_regex(schema)


@pytest.mark.parametrize("which", ["json_object", "tool_call0",
                                   "tool_call1"])
def test_generic_and_tool_call_regexes_equal_jax(which):
    if which == "json_object":
        assert tschema.json_object_regex(3) == jschema.json_object_regex(3)
    else:
        tools = TOOLS[int(which[-1])]
        assert tschema.tool_call_regex(tools) == jschema.tool_call_regex(tools)


def json_tinychat(root: str) -> str:
    """A copy of tinychat whose tokenizer adds JSON punctuation, digits and
    the tool-call markup's "<", ">", "_" as single-byte tokens in the
    embedding headroom (the committed BPE cannot spell "{"), as
    tests/test_structured.py's battery does.
    Returns the model root holding ``tinychat/``."""
    ckpt = os.path.join(root, "tinychat")
    if os.path.isdir(ckpt):
        return root
    os.makedirs(ckpt)
    for name in ("config.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(TINYCHAT, name), os.path.join(ckpt, name))
    os.symlink(os.path.join(TINYCHAT, "model.safetensors"),
               os.path.join(ckpt, "model.safetensors"))
    with open(os.path.join(TINYCHAT, "tokenizer.json")) as f:
        tok = json.load(f)
    vocab = tok["model"]["vocab"]
    next_id = max(vocab.values()) + 1
    for ch in "\"{}[]:,0123456789-+.\\/<>_":
        if ch not in vocab:
            vocab[ch] = next_id
            next_id += 1
    assert next_id <= 2048
    with open(os.path.join(ckpt, "tokenizer.json"), "w") as f:
        json.dump(tok, f)
    return root


@pytest.fixture(scope="module")
def json_root(tmp_path_factory):
    return json_tinychat(str(tmp_path_factory.mktemp("tinychat-json")))


def _tokenizers(which: str, json_root: str):
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JByte
    from fasttalk_tpu.engine.tokenizer import load_tokenizer as jload
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer as TByte
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer as tload

    if which == "byte":
        return JByte(), TByte()
    root = ASSETS if which == "tinychat" else json_root
    return jload(root, "tinychat"), tload(root, "tinychat")


SPECS = [{"kind": "json_schema", "schema": FINITE_SCHEMA},
         {"kind": "json_object"},
         {"kind": "regex", "regex": r"(yes|no)!"},
         {"kind": "regex", "regex": r"[?_a]{6}"},
         {"kind": "tool_call", "tools": TOOLS[0]},
         {"kind": "json_schema", "schema": {"type": "string",
                                            "pattern": "a+"}},
         {"kind": "regex", "regex": "(("}]


@pytest.mark.parametrize("which", ["byte", "tinychat", "tinychat-json"])
def test_token_fsm_equals_jax(which, json_root):
    """Every spec compiles to the JAX package's TokenFSM, array for array
    (classes, transitions, mask words, forced tokens, start, accept), or
    fails with the same message; the vocabulary byte tables are equal."""
    jtok, ttok = _tokenizers(which, json_root)
    assert tfsm.token_byte_table(ttok) == jfsm.token_byte_table(jtok)
    jc, tc = jcompiler.FSMCompiler(jtok), tcompiler.FSMCompiler(ttok)
    try:
        for spec in SPECS:
            err = _error(jc.compile, spec)
            assert _error(tc.compile, spec) == err, spec
            if err is not None:
                continue
            j, t = jc.compile(spec), tc.compile(spec)
            for name in ("cls", "next", "mask_words", "forced_tok"):
                np.testing.assert_array_equal(getattr(t, name),
                                              getattr(j, name), err_msg=name)
                assert getattr(t, name).dtype == getattr(j, name).dtype
            assert (t.n_states, t.start, t.vocab, t.n_classes, t.accept,
                    t.eos_ids) == (j.n_states, j.start, j.vocab,
                                   j.n_classes, j.accept, j.eos_ids)
            state = t.start
            assert t.forced_chain(state) == j.forced_chain(state)
    finally:
        jc.shutdown()
        tc.shutdown()


def _arena_tables(arena):
    return {"masks": arena.masks, "nexts": arena.nexts, "cls": arena.cls,
            "entries": [(e.base, e.sel, e.refs) for e in arena._order],
            "stats": arena.stats()}


def _assert_arenas_equal(t, j):
    tt, jt = _arena_tables(t), _arena_tables(j)
    for name in ("masks", "nexts", "cls"):
        np.testing.assert_array_equal(tt[name], jt[name], err_msg=name)
        assert tt[name].dtype == jt[name].dtype
    assert tt["entries"] == jt["entries"]
    assert tt["stats"] == jt["stats"]


@pytest.mark.parametrize("which", ["byte", "tinychat-json"])
def test_arena_union_and_mask_rows_equal_jax(which, json_root):
    """The union tables after each register / release / evict, the
    ArenaFull message, and ``pack_mask_row`` of every state (and the DONE /
    DEAD sentinels) are bit-equal to the JAX package's."""
    jtok, ttok = _tokenizers(which, json_root)
    jc, tc = jcompiler.FSMCompiler(jtok), tcompiler.FSMCompiler(ttok)
    specs = [{"kind": "regex", "regex": "ab"},
             {"kind": "regex", "regex": "[0-9]{1,4}"},
             {"kind": "json_schema", "schema": FINITE_SCHEMA},
             {"kind": "regex", "regex": "x{1,50}"},
             {"kind": "regex", "regex": "y{1,500}"}]
    try:
        jf = [jc.compile(s) for s in specs]
        tf = [tc.compile(s) for s in specs]
        eos = tuple(sorted(jtok.eos_ids))
        ja = jruntime.FSMArena(jtok.vocab_size, eos, 4, state_budget=160)
        ta = truntime.FSMArena(ttok.vocab_size, eos, 4, state_budget=160)
        script = [("register", 0), ("register", 1), ("register", 2),
                  ("release", 0), ("release", 1), ("register", 3),
                  ("register", 0), ("release", 2), ("register", 4)]
        for op, i in script:
            jr = _error(getattr(ja, op), jf[i])
            assert _error(getattr(ta, op), tf[i]) == jr, (op, i)
            _assert_arenas_equal(ta, ja)
        for i in (0, 2):
            for state in list(range(tf[i].n_states)) + [tfsm.DEAD,
                                                         tfsm.DONE]:
                t_row = truntime.pack_mask_row(tf[i], state, ta.words,
                                               tf[i].eos_ids)
                j_row = jruntime.pack_mask_row(jf[i], state, ja.words,
                                               jf[i].eos_ids)
                assert t_row.dtype == j_row.dtype
                np.testing.assert_array_equal(t_row, j_row)
    finally:
        jc.shutdown()
        tc.shutdown()


@pytest.mark.parametrize("spec", [
    {"type": "json_object"}, {"kind": "json_schema"},
    {"kind": "regex", "regex": ""}, {"kind": "tool_call", "tools": []},
    "json", {"kind": "json_object"}])
def test_validate_structured_spec_equals_jax(spec):
    assert _error(tcompiler.validate_structured_spec, spec) == \
        _error(jcompiler.validate_structured_spec, spec)


@pytest.mark.parametrize("kw", [
    dict(ignore_eos=True), dict(stop=["}"]), dict(prefill_only=True),
    dict(structured={"type": "json_object"}, raw=True), dict()])
def test_generation_params_reject_as_jax_does(kw):
    """``structured`` with ``ignore_eos``, ``stop`` or ``prefill_only``,
    and a bad spec shape, fail with JAX's messages."""
    from fasttalk_tpu.engine.engine import GenerationParams as JParams
    from fasttalk_tpu_torch.engine.engine import GenerationParams as TParams

    kw = dict(kw)
    if not kw.pop("raw", False):
        kw["structured"] = {"kind": "json_object"}
    err = _error(JParams, **kw)
    assert _error(TParams, **kw) == err
    assert (err is None) == (kw == {"structured": {"kind": "json_object"}})


def test_structured_knobs_have_the_jax_defaults_and_messages(monkeypatch):
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    fields = ("structured_mode", "structured_max_states",
              "structured_state_budget", "structured_jf_min",
              "structured_cache", "structured_json_depth")
    port, ref = Config(), JaxConfig(llm_provider="tpu")
    assert {f: getattr(port, f) for f in fields} == \
        {f: getattr(ref, f) for f in fields}
    for env in ({"STRUCTURED_JF_MIN": "-3"},
                {"STRUCTURED_MAX_STATES": "4096",
                 "STRUCTURED_STATE_BUDGET": "1024"},
                {"STRUCTURED_CACHE": "0"}, {"STRUCTURED_JSON_DEPTH": "9"},
                {"STRUCTURED_MAX_STATES": "8"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            with pytest.raises(ValueError) as jax_err:
                JaxConfig(llm_provider="tpu")
            with pytest.raises(ValueError) as port_err:
                Config()
        want = str(jax_err.value).split(": ", 1)[1].split("; ")
        assert all(line.strip() in str(port_err.value) for line in want), \
            (want, str(port_err.value))


# ---------------------------------------------------------------------
# The constrained decode step against JAX's decode_fsm
# ---------------------------------------------------------------------

def test_unpack_mask_reads_bit_31_and_the_last_partial_word():
    """Token ids = 31 (mod 32) are the int32 sign bit; the last word of a
    263-token vocabulary holds 7 tokens. The unpacked rows equal numpy's
    unpacking of the uint32 words, and masked logits stay -1e30 outside."""
    from fasttalk_tpu_torch.engine.decode_steps import (bit_powers,
                                                        unpack_mask)

    rng = np.random.default_rng(3)
    vocab = 263
    words = rng.integers(0, 2**32, (5, (vocab + 31) // 32),
                         dtype=np.uint64).astype(np.uint32)
    words[0, :] = 1 << 31
    words[1, -1] = (1 << 7) - 1
    want = ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .reshape(5, -1)[:, :vocab].astype(bool)
    got = unpack_mask(torch.from_numpy(words.view(np.int32)),
                      bit_powers(torch.device("cpu")), vocab).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 31] and got[0, 63] and got[0, 255] and not got[0, 30]
    assert got[1, 256:263].all()


def test_constrained_step_equals_jax_decode_fsm():
    """One 8-step call of the constrained step on test-tiny (float32, byte
    tokenizer) against JAX's ``decode_fsm`` on the same prefilled cache,
    the same arena tables and the same greedy parameters: slot 0 under
    FINITE_SCHEMA, slot 1 free, slot 2 under a regex whose tokens sit at
    bit 31 of their words, slot 3 inactive. Tokens and final FSM states
    are equal, every constrained token is allowed by its state, and the
    first step's masked logits agree to 1e-4 of the logit range with
    -1e30 exactly where the mask forbids."""
    import jax
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JByte
    from fasttalk_tpu.models import llama as jllama
    from fasttalk_tpu.models.configs import get_model_config as jcfg_of
    from fasttalk_tpu_torch.engine.decode_steps import (DecodeState,
                                                        FSMTables,
                                                        fsm_mask,
                                                        plain_steps)
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer as TByte
    from fasttalk_tpu_torch.models import llama as tllama
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import from_jax_params

    jcfg, tcfg = jcfg_of("test-tiny"), get_model_config("test-tiny")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    s, max_len, k, vocab = 4, 512, 8, JByte.vocab_size
    specs = [{"kind": "json_schema", "schema": FINITE_SCHEMA},
             {"kind": "regex", "regex": r"[?_a]{6}"}]
    jc, tc = jcompiler.FSMCompiler(JByte()), tcompiler.FSMCompiler(TByte())
    jf = [jc.compile(x) for x in specs]
    tf = [tc.compile(x) for x in specs]
    jc.shutdown()
    tc.shutdown()
    eos = (JByte.EOS,)
    ja = jruntime.FSMArena(vocab, eos, s)
    ta = truntime.FSMArena(vocab, eos, s)
    jent = [ja.register(f) for f in jf]
    tent = [ta.register(f) for f in tf]
    sel = np.array([jent[0].sel, 0, jent[1].sel, 0], np.int32)
    fst = np.array([ja.global_state(jent[0], jf[0].start), 0,
                    ja.global_state(jent[1], jf[1].start), 0], np.int32)
    assert [e.sel for e in tent] == [e.sel for e in jent]

    prompt = np.random.default_rng(5).integers(0, 256, (s, 10)).astype(
        np.int32)
    t = prompt.shape[1] - 1
    jcache = jllama.init_cache(jcfg, s, max_len, jnp.float32)
    tcache = tllama.init_cache(tcfg, s, max_len, torch.float32, "cpu")
    pos = np.tile(np.arange(t, dtype=np.int32), (s, 1))
    _, jcache = jllama.forward(jparams, jcfg, jnp.asarray(prompt[:, :t]),
                               jnp.asarray(pos), jcache,
                               jnp.zeros((s,), jnp.int32), blockwise=True)
    tllama.forward(tparams, tcfg, torch.from_numpy(prompt[:, :t]).long(),
                   torch.from_numpy(pos).long(), tcache,
                   torch.zeros((s,), dtype=torch.long), blockwise=True)
    cur = prompt[:, t]
    positions = np.full((s,), t, np.int32)
    active = np.array([True, True, True, False])

    # First-step logits of both packages, masked.
    jl, _ = jllama.forward_decode(jparams, jcfg, jnp.asarray(cur),
                                  jnp.asarray(positions), jcache,
                                  jnp.asarray(active), attn_len=max_len)
    jl = np.asarray(jl)[:, :vocab]
    allow = ((ja.masks[fst][:, :, None]
              >> np.arange(32, dtype=np.uint32)) & 1).reshape(s, -1)[
        :, :vocab].astype(bool)
    want = np.where(allow, jl, np.float32(-1e30))
    tables = FSMTables.upload(ta.masks, ta.nexts, ta.cls,
                              torch.from_numpy(sel).long(),
                              torch.device("cpu"))
    tl, _ = tllama.forward_decode(tparams, tcfg, torch.from_numpy(cur).long(),
                                  torch.from_numpy(positions).long(), tcache,
                                  torch.from_numpy(active), attn_len=max_len)
    got = fsm_mask(tl[:, :vocab], torch.from_numpy(fst).long(),
                   tables).numpy()
    np.testing.assert_array_equal(got == np.float32(-1e30), ~allow)
    span = float(np.ptp(jl))
    assert float(np.abs(got - want)[allow].max()) <= 1e-4 * span

    eng = TPUEngine(jcfg, jparams, JByte(), num_slots=s, max_len=max_len,
                    spec_decode="off", dtype=jnp.float32)
    fn = eng._build_fsm_decode(max_len, k, False, jnp.arange(s), max_len)
    zeros = np.zeros((s,), np.float32)
    _, _, jfst, jtoks, _, _, _ = fn(
        jparams, jcache, jnp.zeros((s, vocab), jnp.int32), jnp.asarray(fst),
        jnp.asarray(cur), jnp.asarray(positions), jnp.asarray(active),
        jnp.asarray(zeros), jnp.zeros((s,), jnp.int32),
        jnp.ones((s,), jnp.float32), jnp.ones((s,), jnp.float32),
        jnp.asarray(zeros), jnp.asarray(zeros), jax.random.PRNGKey(0),
        jnp.asarray(sel), jnp.asarray(ja.masks), jnp.asarray(ja.cls),
        jnp.asarray(ja.nexts))

    st = DecodeState.zeros(s, vocab, 0, torch.device("cpu"), 0)
    st.cur = torch.from_numpy(cur).long()
    st.pos = torch.from_numpy(positions).long()
    st.active = torch.from_numpy(active)
    st.fst = torch.from_numpy(fst).long()
    toks = plain_steps(tparams, tcfg, tcache, st, k, max_len,
                       sample_vocab=vocab, method="fast", fsm=tables)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(st.fst.numpy(), np.asarray(jfst))
    # The constrained slots followed their FSMs on the host mirror too.
    for slot, f, e in ((0, tf[0], tent[0]), (2, tf[1], tent[1])):
        state = f.start
        for tok in toks[:, slot].tolist():
            state = f.step(state, tok)
            assert state != tfsm.DEAD, (slot, toks[:, slot])
        assert ta.global_state(e, state) == int(st.fst[slot])
    assert set(toks[:, 2].tolist()) <= {ord("?"), ord("_"), ord("a"),
                                        JByte.EOS}
    assert int(st.fst[1]) == 0 and int(st.fst[3]) == 0


# ---------------------------------------------------------------------
# The engine on trained tinychat, greedy, against TPUEngine
# ---------------------------------------------------------------------

SKY = [{"role": "user", "content": "what color is the sky?"}]
TRAINED_SPECS = [
    ("schema", {"kind": "json_schema", "schema": {
        "type": "object", "properties": {
            "name": {"type": "string", "maxLength": 8},
            "color": {"enum": ["blue", "red", "green"]}}}}, 64),
    # A long forced run (digits are single-byte tokens here): the case
    # jump-forward takes.
    ("numeric-key", {"kind": "json_schema", "schema": {
        "type": "object", "properties": {
            "12345678901234567890": {"enum": ["blue", "red"]}}}}, 64),
    ("object", {"kind": "json_object"}, 40),
    ("regex", {"kind": "regex", "regex": r"(blue|red|green) sky!"}, 16),
]
TIERS = {
    "dense": {},
    "paged": dict(kv_layout="paged"),
    "int8kv": dict(kv_quant="int8"),
    "int4": dict(weight_quant="int4"),
}


async def _collect(engine, params_cls, rid, messages, **kw):
    text, final = "", {}
    async for ev in engine.generate(rid, f"s-{rid}", messages,
                                    params_cls(**kw)):
        if ev["type"] == "token":
            text += ev["text"]
        else:
            final = ev
    return text, final


def _run_specs(engine, params_cls):
    """Greedy text of every spec, with jump-forward at STRUCTURED_JF_MIN=4
    and off (0), one request at a time."""
    out = {}

    async def run():
        for jf in (4, 0):
            engine._st_jf_min = jf
            for name, spec, n in TRAINED_SPECS:
                text, final = await _collect(
                    engine, params_cls, f"{name}-{jf}", SKY, max_tokens=n,
                    structured=spec, **GREEDY)
                out[(name, jf)] = (text, final.get("finish_reason"))
    asyncio.run(run())
    return out


def _jax_engine(root, tier, max_len=512):
    import jax
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer
    from fasttalk_tpu.models.configs import get_model_config as jcfg_of
    from fasttalk_tpu.models.loader import load_params
    from fasttalk_tpu.quantization import int4 as j4

    cfg = jcfg_of("tinychat", root)
    ckpt = os.path.join(root, "tinychat")
    kw = dict(TIERS[tier])
    if kw.pop("weight_quant", None):
        def put(a, path):
            return jax.device_put(jnp.asarray(a, jnp.float32))

        def raw(a, path):
            return jax.device_put(jnp.asarray(a))

        params = load_params(cfg, ckpt, jnp.float32,
                             j4.quantizing_put_int4(put, raw, 128))
        kw.update(weight_quant="int4", weight_quant_group=128)
    else:
        params = load_params(cfg, ckpt, jnp.float32)
    return TPUEngine(cfg, params, load_tokenizer(
        root, "tinychat", template=cfg.chat_template), num_slots=4,
        max_len=max_len, dtype=jnp.float32, steps_per_call=8,
        spec_decode="off",
        shared_prefix=False, **kw)


def _torch_engine(root, tier, **extra):
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params

    cfg = get_model_config("tinychat", root)
    kw = dict(TIERS[tier])
    quant = kw.pop("weight_quant", "off")
    params = load_params(cfg, os.path.join(root, "tinychat"), torch.float32,
                         "cpu", quantize=quant, weight_quant_group=128)
    opts = dict(num_slots=4, max_len=512, dtype=torch.float32,
                steps_per_call=8, **kw)
    opts.update(extra)
    return TorchEngine(cfg, params, load_tokenizer(
        root, "tinychat", template=cfg.chat_template), device="cpu", **opts)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_trained_constrained_greedy_equals_jax_engine(tier, json_root):
    """Token for token on each tier, jump-forward on and off; every
    document completes ("stop") and parses, and jump-forward emitted
    tokens on the numeric-key schema."""
    from fasttalk_tpu.engine.engine import GenerationParams as JParams
    from fasttalk_tpu_torch.engine.engine import GenerationParams as TParams

    jeng = _jax_engine(json_root, tier)
    jeng.start()
    try:
        want = _run_specs(jeng, JParams)
    finally:
        jeng.shutdown()
    teng = _torch_engine(json_root, tier)
    teng.start()
    try:
        got = _run_specs(teng, TParams)
        jumped = teng.get_stats()["structured"]["jump_forward_tokens"]
    finally:
        teng.shutdown()
    assert got == want
    assert jumped > 0
    for name, spec, _ in TRAINED_SPECS:
        for jf in (4, 0):
            text, reason = got[(name, jf)]
            if name == "object" and reason == "length":
                continue  # "any JSON" may not close within the budget
            assert reason == "stop", (name, jf, text)
            if name == "regex":
                assert text in ("blue sky!", "red sky!", "green sky!")
            else:
                assert validates(json.loads(text), spec.get("schema", {}))


# ---------------------------------------------------------------------
# Engine behaviour (tests/test_structured.py :529-857, on the port)
# ---------------------------------------------------------------------

def _tiny_engine(**kw):
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.llama import init_params

    cfg = get_model_config("test-tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    opts = dict(num_slots=4, max_len=256, prefill_chunk=64,
                dtype=torch.float32, spec_decode="off")
    opts.update(kw)
    return TorchEngine(cfg, params, ByteTokenizer(), device="cpu", **opts)


@pytest.fixture(scope="module")
def tiny():
    eng = _tiny_engine()
    eng.start()
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def trained(json_root):
    eng = _torch_engine(json_root, "dense")
    eng.start()
    yield eng
    eng.shutdown()


def _one(engine, rid, content, **kw):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    return asyncio.run(_collect(engine, GenerationParams, rid,
                                [{"role": "user", "content": content}], **kw))


def _many(engine, jobs):
    """Run (rid, content, params kwargs) jobs concurrently."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        return await asyncio.gather(*(
            _collect(engine, GenerationParams, rid,
                     [{"role": "user", "content": content}], **kw)
            for rid, content, kw in jobs))
    return asyncio.run(run())


def _schema(schema, **kw):
    return dict(structured={"kind": "json_schema", "schema": schema}, **kw)


def test_mixed_batch_leaves_the_plain_slots_tokens_unchanged(trained):
    """Two constrained and two plain sessions at once: the plain sessions'
    greedy text equals their text run alone, the constrained documents
    are valid, and constrained calls carried the whole batch."""
    schema = TRAINED_SPECS[0][1]["schema"]
    plain = [("p0", "what color is the sky?"),
             ("p1", "what is three plus four?")]
    alone = {rid: _one(trained, f"{rid}-alone", text, max_tokens=24,
                       **GREEDY)[0] for rid, text in plain}
    calls = trained.get_stats()["structured"]["calls"]
    out = _many(trained, [
        ("c0", "what color is the sky?",
         _schema(schema, max_tokens=64, **GREEDY)),
        ("p0", plain[0][1], dict(max_tokens=24, **GREEDY)),
        ("c1", "what is your name?",
         _schema(schema, max_tokens=64, **GREEDY)),
        ("p1", plain[1][1], dict(max_tokens=24, **GREEDY))])
    assert out[1][0] == alone["p0"] and out[3][0] == alone["p1"]
    for text, final in (out[0], out[2]):
        assert final["finish_reason"] == "stop"
        assert validates(json.loads(text), schema)
    assert trained.get_stats()["structured"]["calls"] > calls


def test_constrained_slot_reuse_does_not_rewind_the_fsm(json_root):
    """Two slots: a long plain stream holds one, and four queued requests
    take the other in turn: constrained, constrained, plain, constrained.
    Each constrained request takes the slot straight after the previous
    one finished, and decode calls go on for the plain stream while its
    first token is in flight, so the previous occupant's finish -> FREE
    patch is still queued when the masked first sample writes the slot's
    state; it must be dropped, or the device FSM steps back a token. Each
    document is the one its request gives alone."""
    schema = TRAINED_SPECS[0][1]["schema"]
    prompts = ["what color is the sky?", "what is your name?",
               "hello there", "what is the opposite of hot?"]
    eng = _torch_engine(json_root, "dense", num_slots=2)
    # On the CPU a first token's copy lands at once; on the card it lands
    # later, and decode calls go on meanwhile. Emulate the card: a first
    # token is consumed only where the engine waits for it.
    drain = eng._drain_firsts
    eng._drain_firsts = lambda block: drain(True) if block else None
    eng.start()
    try:
        alone = [_one(eng, f"a{i}", p, **_schema(schema, max_tokens=64,
                                                  **GREEDY))[0]
                 for i, p in enumerate(prompts)]
        jobs = [("long", "tell me a story",
                 dict(max_tokens=400, ignore_eos=True, **GREEDY))]
        jobs += [(f"q{i}", p, _schema(schema, max_tokens=64, **GREEDY)
                  if i != 2 else dict(max_tokens=6, **GREEDY))
                 for i, p in enumerate(prompts)]
        out = _many(eng, jobs)[1:]
    finally:
        eng.shutdown()
    for i in (0, 1, 3):
        assert out[i][0] == alone[i], (i, out[i][0], alone[i])
        assert validates(json.loads(out[i][0]), schema)


def test_sampled_battery_always_parses(tiny):
    schemas = [
        FINITE_SCHEMA, {"enum": ["alpha", "beta", 3, None]},
        {"type": "array", "items": {"type": "boolean"}, "minItems": 1,
         "maxItems": 4},
        {"type": "object", "properties": {
            "tags": {"type": "array", "items": {"enum": ["x", "y"]},
                     "maxItems": 3},
            "note": {"type": "string", "maxLength": 5}}},
    ]
    jobs = [(f"b{i}.{j}", f"doc {i}.{j}",
             _schema(schema, max_tokens=96, temperature=1.0, top_k=40,
                     top_p=0.95))
            for i, schema in enumerate(schemas) for j in range(2)]
    for (rid, _, _), (text, final) in zip(jobs, _many(tiny, jobs)):
        schema = schemas[int(rid[1])]
        assert final["finish_reason"] == "stop", (rid, text, final)
        assert validates(json.loads(text), schema), (rid, text)


def test_greedy_is_deterministic_and_finishes_stop_at_the_budget_edge(tiny):
    t1, f1 = _one(tiny, "g1", "json", **_schema(FINITE_SCHEMA, max_tokens=64,
                                                **GREEDY))
    t2, f2 = _one(tiny, "g2", "json", **_schema(
        FINITE_SCHEMA, max_tokens=f1["stats"]["tokens_generated"], **GREEDY))
    assert t1 == t2 and validates(json.loads(t1), FINITE_SCHEMA)
    assert f1["finish_reason"] == f2["finish_reason"] == "stop"
    t3, _ = _one(tiny, "g3", "r", structured={"kind": "regex",
                                              "regex": r"(yes|no)!"},
                 max_tokens=32, **GREEDY)
    assert t3 in ("yes!", "no!")


def test_cancel_mid_stream_releases_the_arena_pin(tiny):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        params = GenerationParams(
            max_tokens=4096, temperature=1.0, top_k=40, top_p=0.9,
            structured={"kind": "regex", "regex": "[ab]{2000}"})
        got, terminal = 0, None
        async for ev in tiny.generate("cx", "scx",
                                      [{"role": "user", "content": "c"}],
                                      params):
            if ev["type"] == "token":
                got += 1
                if got == 2:
                    tiny.cancel("cx")
            else:
                terminal = ev
        return terminal
    assert asyncio.run(run())["type"] == "cancelled"
    _, final = _one(tiny, "after-cancel", "hi", max_tokens=8, **GREEDY)
    assert final["type"] == "done"
    assert tiny.get_stats()["structured"]["arena"]["pinned"] == 0


def test_new_schema_admitted_mid_stream_repacks_safely(tiny):
    """A new schema grows the arena while a constrained stream decodes: the
    pipeline drains, the tables are uploaded again and the running slot's
    state refreshed; both documents stay valid."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    late_schema = {"type": "object", "properties": {
        "late": {"enum": ["x", "y"]}, "n": {"enum": [1, 2, 3]}}}
    before = tiny.get_stats()["structured"].get("arena", {}).get("fsms", 0)

    async def long_stream():
        p = GenerationParams(max_tokens=160, temperature=1.0, top_k=40,
                             top_p=0.9, structured={"kind": "regex",
                                                    "regex": "[ab]{150}"})
        text = ""
        async for ev in tiny.generate("repack-a", "srpa",
                                      [{"role": "user", "content": "a"}], p):
            if ev["type"] == "token":
                text += ev["text"]
                if len(text) >= 20 and not late.done() and not started:
                    started.append(True)
                    go.set()
        return text

    async def late_stream():
        await go.wait()
        return await _collect(tiny, GenerationParams, "repack-b",
                              [{"role": "user", "content": "b"}],
                              max_tokens=96, temperature=1.0, top_k=40,
                              top_p=0.9, structured={
                                  "kind": "json_schema",
                                  "schema": late_schema})

    async def run():
        nonlocal go, late
        go = asyncio.Event()
        late = asyncio.ensure_future(late_stream())
        return await long_stream(), await late

    go = late = None
    started: list = []
    a_text, (b_text, b_final) = asyncio.run(run())
    assert set(a_text) <= {"a", "b"} and len(a_text) == 150
    assert b_final["finish_reason"] == "stop"
    assert validates(json.loads(b_text), late_schema)
    assert tiny.get_stats()["structured"]["arena"]["fsms"] > before


def test_uncompilable_schema_and_disabled_engine_are_validation_errors(tiny):
    """A schema outside the compilable subset, and any constrained request
    to an engine built with STRUCTURED_MODE=off, fail at the engine seam
    as validation errors; the off engine's reason is JAX's."""
    import jax
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JByte
    from fasttalk_tpu.models import llama as jllama
    from fasttalk_tpu.models.configs import get_model_config as jcfg_of
    from fasttalk_tpu_torch.utils.errors import ErrorCategory, LLMServiceError

    with pytest.raises(LLMServiceError, match="pattern") as e:
        _one(tiny, "bad", "x", structured={"kind": "json_schema", "schema": {
            "type": "string", "pattern": "a+"}})
    assert e.value.category == ErrorCategory.VALIDATION
    jcfg = jcfg_of("test-tiny")
    ref = TPUEngine(jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(0),
                                             jnp.float32), JByte(),
                    num_slots=2, max_len=256, spec_decode="off",
                    structured="off")
    off = _tiny_engine(num_slots=2, structured="off")
    assert off.structured_reason == ref.structured_reason is not None
    assert off.get_stats()["structured"]["reason"] == off.structured_reason
    off.start()
    try:
        with pytest.raises(LLMServiceError, match="STRUCTURED_MODE") as e:
            _one(off, "d1", "x", structured={"kind": "json_object"})
        assert e.value.category == ErrorCategory.VALIDATION
    finally:
        off.shutdown()
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        _tiny_engine(structured="maybe")


def test_spec_pauses_while_constrained_and_resumes_after():
    """With TPU_SPEC_DECODE=ngram, no speculative call is made while the
    constrained slot runs (its calls are the constrained ones); the plain
    request afterwards takes speculative calls again."""
    eng = _tiny_engine(num_slots=2, spec_decode="ngram", spec_draft_len=3)
    eng.start()
    try:
        text, final = _one(eng, "sp1", "json", **_schema(
            FINITE_SCHEMA, max_tokens=64, **GREEDY))
        st = eng.get_stats()
        assert final["finish_reason"] == "stop"
        assert validates(json.loads(text), FINITE_SCHEMA)
        assert st["spec"]["calls"] == 0 and st["structured"]["calls"] > 0
        _, final = _one(eng, "sp2", "hi", max_tokens=12, **GREEDY)
        assert final["type"] == "done"
        assert eng.get_stats()["spec"]["calls"] > 0
    finally:
        eng.shutdown()


def test_stats_surface(tiny):
    from fasttalk_tpu_torch.utils.metrics import get_metrics

    schema = {"type": "object", "properties": {"stats": {"enum": [1, 2]}}}
    _one(tiny, "st1", "json", **_schema(schema, max_tokens=64, **GREEDY))
    st = tiny.get_stats()["structured"]
    assert st["available"] is True and "reason" not in st
    assert {"compiler", "arena", "calls", "steps", "host_s",
            "jump_forward_tokens"} <= set(st)
    assert st["arena"]["fsms"] >= 1 and st["compiler"]["cached"] >= 1
    m = get_metrics()
    assert m.counter("structured_requests_total").value >= 1
    assert m.histogram("fsm_compile_ms").summary()["count"] >= 1
