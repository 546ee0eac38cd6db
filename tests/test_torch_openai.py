"""The port's OpenAI ``/v1`` routes against the JAX package's.

The same requests go to ``fasttalk_tpu``'s ``register_openai_routes`` and
to ``fasttalk_tpu_torch``'s. Protocol cases run the JAX routes over the JAX
package's ``FakeEngine`` and the port's over ``TorchEngine(device="cpu")``
on test-tiny: status codes and error bodies are equal, the messages and
generation parameters that reach the two engines are equal (hermes rewriting
of tool turns, the injected tools section, the forced tool call's
constraint), and the SSE frames and tool-call shapes have the same
structure. A drained engine of each package gives the same 429 with
``Retry-After``. Content cases run ``TPUEngine`` against ``TorchEngine`` on
the trained tinychat checkpoint (its tokenizer given the JSON punctuation),
greedy: ``response_format`` and a forced ``tool_choice`` give equal bodies
and frames apart from ids and timestamps.
"""

import asyncio
import json
import os
import sys

import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from fasttalk_tpu.engine.fake import FakeEngine
from fasttalk_tpu.serving.openai_api import \
    register_openai_routes as jax_routes
from fasttalk_tpu.utils.errors import CircuitBreaker as JaxBreaker
from fasttalk_tpu_torch.serving.openai_api import \
    register_openai_routes as torch_routes
from fasttalk_tpu_torch.utils.errors import CircuitBreaker

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_structured import (_jax_engine, _torch_engine,  # noqa: E402
                                   json_tinychat, validates)
from tests._port_isolation import port_isolation  # noqa: F401,E402

GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}
DEFAULTS = {"temperature": 0.7, "top_p": 0.9, "top_k": 40, "max_tokens": 8,
            "repeat_penalty": 1.1, "presence_penalty": 0.0,
            "frequency_penalty": 0.0, "priority": "interactive"}
WEATHER = {"type": "function", "function": {
    "name": "get_weather", "description": "Current weather for a city.",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string", "maxLength": 6},
        "units": {"enum": ["C", "F"]}}}}}
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 8},
    "color": {"enum": ["blue", "red", "green"]}}}
MSGS = [{"role": "user", "content": "what color is the sky?"}]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)




class _Spy:
    """Records what each request hands the engine's ``generate``."""

    def __init__(self, engine):
        self.seen = []
        self.engine = engine
        self._generate = engine.generate
        engine.generate = self

    def __call__(self, request_id, session_id, messages, params):
        self.seen.append({"messages": messages, "params": params})
        return self._generate(request_id, session_id, messages, params)

    def close(self):
        del self.engine.generate


def _app(routes, engine, breaker_cls):
    app = web.Application()
    routes(app, backend=engine, model_name="test-model",
           defaults=DEFAULTS, breaker=breaker_cls())
    return app


async def _call(app, method, path, body=None, raw=None):
    """One request: (status, headers, JSON body or the SSE frames)."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        if method == "GET":
            r = await client.get(path)
        elif raw is not None:
            r = await client.post(path, data=raw,
                                  headers={"Content-Type":
                                           "application/json"})
        else:
            r = await client.post(path, json=body)
        if r.content_type == "text/event-stream":
            text = (await r.read()).decode()
            frames = [line[6:] for line in text.split("\n\n") if line]
            return r.status, r.headers, frames
        return r.status, r.headers, await r.json()
    finally:
        await client.close()


def _both(jax_engine, torch_engine, method, path, body=None, raw=None):
    """The same request through both route sets; also what each engine was
    asked (None when the request never reached it)."""
    jspy, tspy = _Spy(jax_engine), _Spy(torch_engine)
    try:
        jax = asyncio.run(asyncio.wait_for(_call(
            _app(jax_routes, jax_engine, JaxBreaker), method, path, body,
            raw), 120))
        port = asyncio.run(asyncio.wait_for(_call(
            _app(torch_routes, torch_engine, CircuitBreaker), method, path,
            body, raw), 120))
    finally:
        jspy.close()
        tspy.close()
    return jax, port, jspy.seen, tspy.seen


_PARAM_FIELDS = ("temperature", "top_k", "top_p", "max_tokens", "stop",
                 "repeat_penalty", "presence_penalty", "frequency_penalty",
                 "ignore_eos", "priority", "deadline_s", "raw_prompt",
                 "structured")


def _asked(seen):
    return [(s["messages"], {f: getattr(s["params"], f)
                             for f in _PARAM_FIELDS}) for s in seen]


@pytest.fixture(scope="module")
def engines():
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    fake = FakeEngine(delay_s=0.0)
    fake.start()
    cfg = Config(model_name="test-tiny", model_path="", weight_quant="off",
                 dtype="float32", decode_slots=2, max_model_len=1024,
                 default_context_window=1024, spec_decode="off")
    eng = build_engine(cfg, device="cpu")
    eng.start()
    yield fake, eng
    eng.shutdown()


BAD = [
    ("chat", None, "{not json"),
    ("chat", {"messages": []}, None),
    ("chat", {"messages": "hi"}, None),
    ("chat", {"messages": MSGS, "repeat_penalty": 0}, None),
    ("chat", {"messages": MSGS, "ignore_eos": "yes"}, None),
    ("chat", {"messages": MSGS, "priority": "vip"}, None),
    ("chat", {"messages": MSGS, "deadline_s": -1}, None),
    ("chat", {"messages": MSGS, "tools": "x"}, None),
    ("chat", {"messages": MSGS, "tool_choice": "required"}, None),
    ("chat", {"messages": MSGS, "tools": [{"type": "function"}]}, None),
    ("chat", {"messages": MSGS, "tools": [WEATHER], "tool_choice": {
        "type": "function", "function": {"name": "nope"}}}, None),
    ("chat", {"messages": MSGS, "tools": [WEATHER], "tool_choice": {
        "type": "function"}}, None),
    ("chat", {"messages": MSGS, "tools": [WEATHER],
              "tool_choice": "sometimes"}, None),
    ("chat", {"messages": MSGS, "tools": [WEATHER], "tool_choice":
              "required", "ignore_eos": True}, None),
    ("chat", {"messages": MSGS, "response_format": {"type": "yaml"}}, None),
    ("chat", {"messages": MSGS, "response_format": "json"}, None),
    ("chat", {"messages": MSGS, "response_format": {
        "type": "json_schema"}}, None),
    ("chat", {"messages": MSGS, "n": 2, "response_format": {
        "type": "json_object"}}, None),
    ("chat", {"messages": MSGS, "tools": [WEATHER], "response_format": {
        "type": "json_object"}}, None),
    ("chat", {"messages": MSGS, "ignore_eos": True, "response_format": {
        "type": "json_object"}}, None),
    ("chat", {"messages": MSGS, "stop": ["}"], "response_format": {
        "type": "json_object"}}, None),
    ("chat", {"messages": [{"role": "assistant", "tool_calls": "x"}]}, None),
    ("chat", {"messages": [{"role": "assistant", "tool_calls": [3]}]}, None),
    ("completions", None, "[1"),
    ("completions", {"prompt": ["a", "b"]}, None),
    ("completions", {"prompt": ""}, None),
    ("completions", {"prompt": "x", "top_k": "many"}, None),
    ("completions", {"prompt": "x", "response_format": {
        "type": "json_schema", "json_schema": {}}}, None),
]
PATHS = {"chat": "/v1/chat/completions", "completions": "/v1/completions"}


@pytest.mark.parametrize("case", range(len(BAD)))
def test_bad_requests_get_the_same_400(case, engines):
    route, body, raw = BAD[case]
    jax, port, jseen, tseen = _both(*engines, "POST", PATHS[route], body,
                                    raw)
    assert port[0] == jax[0] == 400, (jax, port)
    assert port[2] == jax[2]
    assert jseen == tseen == []


def test_models_list_has_the_same_shape(engines):
    jax, port, _, _ = _both(*engines, "GET", "/v1/models")
    assert port[0] == jax[0] == 200
    for body in (jax[2], port[2]):
        body["data"][0].pop("created")
    assert port[2] == jax[2]


def _strip_ids(obj):
    """A body or frame with its ids and timestamps taken out."""
    if isinstance(obj, dict):
        return {k: _strip_ids(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip_ids(v) for v in obj]
    return obj


def _shape(obj):
    """The keys and value types of a body, recursively, without the
    values of strings and numbers."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_shape(v) for v in obj[:1]]
    return type(obj).__name__


GOOD = [
    ("chat", {"messages": MSGS, "max_tokens": 4, "ignore_eos": True,
              **GREEDY}),
    ("chat", {"messages": MSGS, "max_completion_tokens": 3,
              "repetition_penalty": 1.3, "presence_penalty": 0.5,
              "frequency_penalty": -0.5, "stop": "zz", "priority": "bulk",
              "deadline_s": 9.0, "user": "alice", "ignore_eos": True}),
    ("chat", {"messages": [
        {"role": "system", "content": [{"type": "text", "text": "Be "},
                                       {"type": "text", "text": "brief."}]},
        {"role": "user", "content": "weather in Oslo?"},
        {"role": "assistant", "content": None, "tool_calls": [{
            "id": "call_1", "type": "function", "function": {
                "name": "get_weather",
                "arguments": '{"city": "Oslo"}'}}]},
        {"role": "tool", "tool_call_id": "call_1", "content": "4 C"}],
        "tools": [WEATHER], "max_tokens": 3, "ignore_eos": True}),
    ("completions", {"prompt": "Once upon", "ignore_eos": True}),
    ("completions", {"prompt": ["Once upon"], "max_tokens": 5,
                     "ignore_eos": True, **GREEDY}),
]


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case", range(len(GOOD)))
def test_served_requests_reach_the_engines_alike(case, stream, engines):
    """Both engines are asked the same messages (hermes tool turns, the
    tools section) and parameters; bodies and SSE frames have the same
    structure, finish reason and frame order."""
    route, body = GOOD[case]
    body = {**body, "stream": stream}
    jax, port, jseen, tseen = _both(*engines, "POST", PATHS[route], body)
    assert port[0] == jax[0] == 200, (jax, port)
    assert _asked(tseen) == _asked(jseen)
    if not stream:
        assert _shape(port[2]) == _shape(jax[2])
        assert port[2]["choices"][0]["finish_reason"] == \
            jax[2]["choices"][0]["finish_reason"] == "length"
        assert port[2]["object"] == jax[2]["object"]
        assert port[2]["model"] == jax[2]["model"] == "test-model"
        return
    for frames in (jax[2], port[2]):
        assert frames[-1] == "[DONE]"
        chunks = [json.loads(f) for f in frames[:-1]]
        assert len({c["id"] for c in chunks}) == 1
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        assert all(c["choices"][0]["finish_reason"] is None
                   for c in chunks[:-1])
    jc = [json.loads(f) for f in jax[2][:-1]]
    pc = [json.loads(f) for f in port[2][:-1]]
    assert _shape(pc[0]) == _shape(jc[0]) and _shape(pc[-1]) == _shape(jc[-1])
    if route == "chat":
        assert pc[0]["choices"] == jc[0]["choices"]  # the role chunk
    assert pc[-1]["choices"] == jc[-1]["choices"]
    body_shapes = {repr(_shape(c)) for c in jc[1:-1]}
    assert all(repr(_shape(c)) in body_shapes for c in pc[1:-1])


@pytest.mark.parametrize("stream", [False, True])
def test_forced_tool_call_has_the_same_shape(stream, engines):
    """A forced ``tool_choice``: both engines get the same tool-call
    constraint and prompt; the FakeEngine replays hermes markup, the port
    decodes under the constraint; both answers carry one call of the
    forced tool with JSON arguments meeting its parameters, in the same
    frame and body shapes."""
    fake, eng = engines
    call = ('<tool_call>{"name": "get_weather", "arguments": '
            '{"city": "Oslo", "units": "C"}}</tool_call>')
    fake.reply, fake.n_repeats = call, 1
    body = {"messages": MSGS, "tools": [WEATHER], "max_tokens": 120,
            "temperature": 1.0, "stream": stream,
            "tool_choice": {"type": "function",
                            "function": {"name": "get_weather"}}}
    try:
        jax, port, jseen, tseen = _both(fake, eng, "POST",
                                        PATHS["chat"], body)
    finally:
        fake.reply, fake.n_repeats = "Hello from the fake engine. ", 4
    assert port[0] == jax[0] == 200
    assert _asked(tseen) == _asked(jseen)
    assert tseen[0]["params"].structured["kind"] == "tool_call"

    def calls_of(result):
        if not stream:
            choice = result[2]["choices"][0]
            assert choice["finish_reason"] == "tool_calls"
            assert choice["message"]["content"] is None
            return choice["message"]["tool_calls"]
        chunks = [json.loads(f) for f in result[2][:-1]]
        assert chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"
        return [tc for c in chunks
                for tc in c["choices"][0]["delta"].get("tool_calls", [])]
    for result in (jax, port):
        calls = calls_of(result)
        assert len(calls) == 1 and calls[0]["index"] == 0
        assert calls[0]["type"] == "function"
        assert calls[0]["id"].startswith("call_")
        assert calls[0]["function"]["name"] == "get_weather"
        args = json.loads(calls[0]["function"]["arguments"])
        assert validates(args, WEATHER["function"]["parameters"]), args
    assert _shape(calls_of(port)) == _shape(calls_of(jax))


def test_a_drained_engine_sheds_as_the_same_429():
    """Both packages' real engines, drained: the scheduler sheds the
    submission, a non-streamed request gets 429 with ``Retry-After`` and
    the same body, a streamed one the same error frame and ``[DONE]``."""
    import jax
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JByte
    from fasttalk_tpu.models import llama as jllama
    from fasttalk_tpu.models.configs import get_model_config as jcfg_of
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.llama import init_params

    jcfg, tcfg = jcfg_of("test-tiny"), get_model_config("test-tiny")
    jeng = TPUEngine(jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(0),
                                              jnp.float32), JByte(),
                     num_slots=2, max_len=256, spec_decode="off")
    teng = TorchEngine(tcfg, init_params(tcfg, torch.Generator()
                                         .manual_seed(0), torch.float32,
                                         "cpu"), ByteTokenizer(),
                       device="cpu", num_slots=2, max_len=256,
                       dtype=torch.float32)
    for eng in (jeng, teng):
        eng.start()
        eng.begin_drain()
    try:
        for stream in (False, True):
            body = {"messages": MSGS, "stream": stream}
            jax_r, port, _, _ = _both(jeng, teng, "POST", PATHS["chat"],
                                      body)
            if stream:
                assert port[0] == jax_r[0] == 200
                assert port[2][-1] == jax_r[2][-1] == "[DONE]"
                assert [_strip_ids(json.loads(f)) for f in port[2][:-1]] == \
                    [_strip_ids(json.loads(f)) for f in jax_r[2][:-1]]
                err = json.loads(port[2][-2])["error"]
                assert err["code"] == "rate_limit_error"
                assert err["retry_after"] > 0
            else:
                assert port[0] == jax_r[0] == 429
                assert port[1]["Retry-After"] == jax_r[1]["Retry-After"]
                assert int(port[1]["Retry-After"]) >= 1
                assert port[2] == jax_r[2]
                assert port[2]["error"]["type"] == "rate_limit_error"
                assert port[2]["error"]["code"] == "draining"
    finally:
        jeng.shutdown()
        teng.shutdown()


# ---------------------------------------------------------------------
# Content: TPUEngine against TorchEngine on trained tinychat, greedy
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tinychat_pair(tmp_path_factory):
    root = json_tinychat(str(tmp_path_factory.mktemp("tinychat-json")))
    jeng = _jax_engine(root, "dense", max_len=1024)
    teng = _torch_engine(root, "dense", max_len=1024)
    for eng in (jeng, teng):
        eng.start()
    yield jeng, teng
    for eng in (jeng, teng):
        eng.shutdown()


CONTENT = [
    ("schema", {"messages": MSGS, "max_tokens": 64, **GREEDY,
                "repeat_penalty": 1.0, "response_format": {
                    "type": "json_schema",
                    "json_schema": {"name": "doc", "schema": SCHEMA}}}),
    ("object", {"messages": MSGS, "max_tokens": 24, **GREEDY,
                "response_format": {"type": "json_object"}}),
    ("tool", {"messages": MSGS, "max_tokens": 120, **GREEDY,
              "repeat_penalty": 1.0, "tools": [WEATHER],
              "tool_choice": {"type": "function",
                              "function": {"name": "get_weather"}}}),
    ("completions", {"prompt": "the sky is", "max_tokens": 64, **GREEDY,
                     "response_format": {"type": "json_schema",
                                         "json_schema": {"schema": SCHEMA}}}),
    ("uncompilable", {"messages": MSGS, "response_format": {
        "type": "json_schema", "json_schema": {"schema": {
            "type": "string", "pattern": "a+"}}}}),
]


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("name", [c[0] for c in CONTENT])
def test_constrained_answers_equal_the_jax_engine(name, stream,
                                                  tinychat_pair):
    body = {**dict(CONTENT)[name], "stream": stream}
    path = PATHS["completions" if name == "completions" else "chat"]
    jax, port, jseen, tseen = _both(*tinychat_pair, "POST", path, body)
    assert port[0] == jax[0], (jax, port)
    assert _asked(tseen) == _asked(jseen)
    if name == "uncompilable":
        if stream:
            assert [_strip_ids(json.loads(f)) for f in port[2][:-1]] == \
                [_strip_ids(json.loads(f)) for f in jax[2][:-1]]
            assert "pattern" in json.loads(port[2][-2])["error"]["message"]
        else:
            assert port[0] == 400 and port[2] == jax[2]
            assert "pattern" in port[2]["error"]["message"]
        return
    assert port[0] == 200
    if not stream:
        got, want = _strip_ids(port[2]), _strip_ids(jax[2])
        if name == "tool":
            calls = [got["choices"][0]["message"]["tool_calls"],
                     want["choices"][0]["message"]["tool_calls"]]
            assert calls[0] and calls[0] == calls[1]
            assert got["choices"][0]["finish_reason"] == "tool_calls"
        assert got == want
        if name in ("schema", "completions"):
            key = "text" if name == "completions" else "message"
            choice = got["choices"][0]
            text = choice[key] if name == "completions" \
                else choice[key]["content"]
            assert choice["finish_reason"] == "stop"
            assert validates(json.loads(text), SCHEMA)
        return
    assert [_strip_ids(json.loads(f)) if f != "[DONE]" else f
            for f in port[2]] == \
        [_strip_ids(json.loads(f)) if f != "[DONE]" else f for f in jax[2]]
