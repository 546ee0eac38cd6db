"""The remote providers of ``fasttalk_tpu_torch`` (engine/remote.py:
``VLLMRemoteEngine`` for ``LLM_PROVIDER=vllm|openai``, ``OllamaRemoteEngine``
for ``ollama``) held against the JAX package's on the CPU.

Each case runs both packages' engines against the same local upstream (an
``aiohttp.test_utils.TestServer`` on 127.0.0.1 that speaks vLLM's SSE or
Ollama's NDJSON and records every request body; nothing is fetched from
outside) and compares what the caller sees (events, or the error raised
and its ``retry_after``), what the upstream received (the JSON bodies and
the number of attempts), ``check_connection`` and ``get_model_info``.
Covered: streaming with and without usage accounting, the sampling and
stop parameters on the wire, raw-prompt passthrough, the pre-first-token
retry discipline (5xx retried, 4xx and mid-stream failures not), the
``remote.connect`` and ``remote.stream`` failpoints, cancel, the upstream
concurrency bound's shed, and the ``/v1`` route through the port's server
passing a client tool loop to a remote upstream verbatim.
"""

import asyncio
import json

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from tests._port_isolation import port_isolation  # noqa: F401,E402

USER = [{"role": "user", "content": "x"}]


def _pkg(name):
    """(remote module, GenerationParams, errors module, failpoints)."""
    if name == "jax":
        from fasttalk_tpu.engine import remote
        from fasttalk_tpu.engine.engine import GenerationParams
        from fasttalk_tpu.resilience import failpoints
        from fasttalk_tpu.utils import errors
    else:
        from fasttalk_tpu_torch.engine import remote
        from fasttalk_tpu_torch.engine.engine import GenerationParams
        from fasttalk_tpu_torch.resilience import failpoints
        from fasttalk_tpu_torch.utils import errors
    return remote, GenerationParams, errors, failpoints


@pytest.fixture(autouse=True)
def _no_jax_faults():
    from fasttalk_tpu.resilience import failpoints

    failpoints.clear()
    yield
    failpoints.clear()


class Upstream:
    """A local vLLM/Ollama stand-in: ``script(n)`` gives the n-th attempt's
    reply as ("stream", chunks) or ("status", code)."""

    def __init__(self, kind, script):
        self.kind, self.script = kind, script
        self.bodies = []
        app = web.Application()
        if kind == "vllm":
            app.router.add_post("/v1/chat/completions", self._reply)
            app.router.add_post("/v1/completions", self._reply)
            app.router.add_get("/health", self._ok)
            app.router.add_get("/v1/models", self._models)
        else:
            app.router.add_post("/api/chat", self._reply)
            app.router.add_post("/api/generate", self._reply)
            app.router.add_get("/", self._ok)
            app.router.add_get("/api/tags", self._models)
        self.server = TestServer(app)

    async def __aenter__(self):
        await self.server.start_server()
        return self

    async def __aexit__(self, *exc):
        await self.server.close()

    @property
    def url(self):
        base = f"http://127.0.0.1:{self.server.port}"
        return base + "/v1" if self.kind == "vllm" else base

    async def _ok(self, request):
        return web.json_response({})

    async def _models(self, request):
        return web.json_response({"data": [{"id": "m1"}],
                                  "models": [{"name": "m1"}]})

    async def _reply(self, request):
        self.bodies.append((request.path, await request.json()))
        what, arg = self.script(len(self.bodies))
        if what == "status":
            return web.Response(status=arg, text="upstream says no")
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream" if self.kind == "vllm"
            else "application/x-ndjson"})
        await resp.prepare(request)
        for piece in arg:
            if piece == "SLOW":
                await asyncio.sleep(0.3)
                continue
            await resp.write(piece.encode())
        return resp


def _sse(words, usage=True, done=True):
    out = [f"data: {json.dumps({'choices': [{'delta': {'content': w}, 'finish_reason': None}]})}\n\n"
           for w in words]
    out.append(f"data: {json.dumps({'choices': [{'delta': {}, 'finish_reason': 'stop'}]})}\n\n")
    if usage:
        out.append(f"data: {json.dumps({'choices': [], 'usage': {'prompt_tokens': 11, 'completion_tokens': 5}})}\n\n")
    if done:
        out.append("data: [DONE]\n\n")
    return out


def _ndjson(words):
    out = [json.dumps({"message": {"content": w}, "done": False}) + "\n"
           for w in words]
    out.append(json.dumps({"message": {"content": ""}, "done": True,
                           "eval_count": 4, "prompt_eval_count": 9}) + "\n")
    return out


def _norm(events):
    for ev in events:
        for k in ("processing_time_ms", "tokens_per_second", "ttft_ms"):
            ev.get("stats", {}).pop(k, None)
    return events


async def _drive(pkg, kind, script, params=None, messages=USER,
                 spec=None, **eng_kw):
    """What one generation gives the caller and the upstream."""
    remote, GenerationParams, errors, failpoints = _pkg(pkg)
    async with Upstream(kind, script) as up:
        cls = remote.VLLMRemoteEngine if kind == "vllm" \
            else remote.OllamaRemoteEngine
        eng = cls(up.url, "m1", **eng_kw)
        eng.start()
        if spec:
            failpoints.activate(spec)
        events, err = [], None
        try:
            async for ev in eng.generate("r1", "s1", messages,
                                         GenerationParams(**(params or {}))):
                events.append(ev)
        except errors.LLMServiceError as e:
            err = (type(e).__name__, e.category.value,
                   e.retry_after is not None)
        finally:
            failpoints.clear()
            eng.shutdown()
        return {"events": _norm(events), "error": err,
                "bodies": up.bodies}


def _both(kind, script, **kw):
    async def go():
        return [await _drive(pkg, kind, script, **kw)
                for pkg in ("torch", "jax")]
    port, ref = asyncio.run(go())
    assert port == ref
    return port


SAMPLING = {"temperature": 0.3, "top_p": 0.8, "top_k": 7, "max_tokens": 33,
            "stop": ["END"], "repeat_penalty": 1.2,
            "presence_penalty": 0.5, "frequency_penalty": -0.25}


@pytest.mark.parametrize("kind", ["vllm", "ollama"])
@pytest.mark.parametrize("params", [{}, SAMPLING], ids=["defaults",
                                                        "sampling"])
def test_streaming_and_wire_payload_match_jax(kind, params):
    script = (lambda n: ("stream", _sse(["Stream", "ing ", "works."])))\
        if kind == "vllm" else \
        (lambda n: ("stream", _ndjson(["Old", " school", " NDJSON"])))
    got = _both(kind, script, params=params)
    assert got["events"][-1]["type"] == "done"
    assert len(got["bodies"]) == 1
    if kind == "vllm":
        assert got["events"][-1]["stats"]["tokens_generated"] == 5
        assert got["bodies"][0][1]["stream_options"] == {
            "include_usage": True}
    else:
        assert got["events"][-1]["stats"]["tokens_generated"] == 4


def test_no_usage_reports_no_token_count_as_jax():
    got = _both("vllm", lambda n: ("stream", _sse(["a", "b"], usage=False)))
    assert got["events"][-1]["stats"]["tokens_generated"] is None


@pytest.mark.parametrize("kind", ["vllm", "ollama"])
def test_raw_prompt_passthrough_matches_jax(kind):
    script = (lambda n: ("stream", _sse(["raw"]))) if kind == "vllm" \
        else (lambda n: ("stream", [json.dumps({"response": "raw",
                                                "done": False}) + "\n",
                                    json.dumps({"done": True,
                                                "eval_count": 1}) + "\n"]))
    got = _both(kind, script, params={"raw_prompt": True},
                messages=[{"role": "user", "content": "Once upon"}])
    path = got["bodies"][0][0]
    assert path.endswith("completions" if kind == "vllm" else "generate")


@pytest.mark.parametrize("kind", ["vllm", "ollama"])
def test_5xx_before_the_first_token_retries_as_jax(kind):
    ok = _sse(["ok"]) if kind == "vllm" else _ndjson(["ok"])
    got = _both(kind, lambda n: ("status", 503) if n <= 2 else ("stream", ok),
                connect_retries=2)
    assert len(got["bodies"]) == 3 and got["error"] is None


@pytest.mark.parametrize("status,attempts", [(503, 2), (400, 1)])
def test_failures_surface_as_jax_does(status, attempts):
    """Retries exhausted (5xx) and a 4xx (never retried) raise the same
    error after the same number of attempts."""
    got = _both("vllm", lambda n: ("status", status), connect_retries=1)
    assert got["error"] is not None and len(got["bodies"]) == attempts


def test_connect_failpoint_is_retried_as_jax():
    got = _both("vllm", lambda n: ("stream", _sse(["ok"])),
                connect_retries=2, spec="remote.connect=error;count=1")
    assert got["events"][-1]["type"] == "done"
    assert len(got["bodies"]) == 1   # the injected failure never reached it


def test_stream_failpoint_mid_stream_is_not_retried_as_jax():
    got = _both("vllm", lambda n: ("stream", _sse(["a", "b", "c", "d"])),
                connect_retries=3, spec="remote.stream=error;after=2")
    assert got["error"] is not None
    assert any(e["type"] == "token" for e in got["events"])
    assert len(got["bodies"]) == 1


def test_connection_check_and_model_info_match_jax():
    async def go():
        out = []
        for pkg in ("torch", "jax"):
            remote = _pkg(pkg)[0]
            for kind, cls in (("vllm", remote.VLLMRemoteEngine),
                              ("ollama", remote.OllamaRemoteEngine)):
                async with Upstream(kind, lambda n: ("status", 500)) as up:
                    eng = cls(up.url, "m1")
                    eng.start()
                    ok = await asyncio.to_thread(eng.check_connection)
                    info = eng.get_model_info()
                    assert info.pop("base_url") == up.url
                    out.append((pkg, kind, ok, info))
                    eng.shutdown()
        return out
    got = asyncio.run(go())
    assert [g[1:] for g in got[:2]] == [g[1:] for g in got[2:]]
    assert all(g[2] for g in got)


def test_cancel_ends_the_stream_as_jax():
    async def go(pkg):
        remote, GenerationParams, _, _ = _pkg(pkg)
        slow = ["data: " + json.dumps({"choices": [{"delta": {
            "content": "w"}, "finish_reason": None}]}) + "\n\n", "SLOW"] * 20
        async with Upstream("vllm", lambda n: ("stream", slow)) as up:
            eng = remote.VLLMRemoteEngine(up.url, "m1")
            eng.start()
            events = []
            async for ev in eng.generate("rc", "s1", USER,
                                         GenerationParams()):
                events.append(ev)
                if ev["type"] == "token":
                    assert eng.cancel("rc")
            eng.shutdown()
            return [e["type"] for e in events]
    port, ref = (asyncio.run(go(p)) for p in ("torch", "jax"))
    assert port == ref and port[-1] == "cancelled"


def test_upstream_bound_sheds_as_jax():
    """``max_inflight=1``: a second request that cannot start within the
    admission timeout sheds with ``AdmissionRejected`` and retry_after."""
    async def go(pkg):
        remote, GenerationParams, errors, _ = _pkg(pkg)
        slow = _sse(["a"])[:1] + ["SLOW"] * 3 + _sse(["b"])
        async with Upstream("vllm", lambda n: ("stream", slow)) as up:
            eng = remote.VLLMRemoteEngine(up.url, "m1", max_inflight=1,
                                          admission_timeout_s=0.2)
            eng.start()

            async def one(rid):
                try:
                    return [e["type"] async for e in eng.generate(
                        rid, rid, USER, GenerationParams())][-1]
                except errors.AdmissionRejected as e:
                    return ("shed", e.retry_after is not None)
            first = asyncio.create_task(one("a"))
            await asyncio.sleep(0.05)
            second = await one("b")
            out = (await first, second)
            eng.shutdown()
            return out
    port, ref = (asyncio.run(go(p)) for p in ("torch", "jax"))
    assert port == ref == ("done", ("shed", True))


async def test_v1_route_passes_a_tool_loop_to_a_remote_verbatim(
        monkeypatch):
    """The port's server over a remote provider: the ``/v1`` route hands
    the client's tool-call turns to the upstream as they came (the
    ``tool_call_id`` intact), as the JAX route does; the in-tree engine
    would get the hermes rewrite instead."""
    from fasttalk_tpu_torch.engine.remote import VLLMRemoteEngine
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("LLM_PROVIDER", "vllm")
    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    convo = [
        {"role": "user", "content": "time?"},
        {"role": "assistant", "content": None, "tool_calls": [
            {"id": "call_abc123", "type": "function",
             "function": {"name": "get_current_time", "arguments": "{}"}}]},
        {"role": "tool", "tool_call_id": "call_abc123", "content": "16:00"},
    ]
    async with Upstream("vllm", lambda n: ("stream", _sse(["4pm."]))) as up:
        eng = VLLMRemoteEngine(up.url, "m1")
        eng.start()
        server = WebSocketLLMServer(Config(), eng)
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            r = await client.post("/v1/chat/completions", json={
                "model": "m1", "messages": convo, "stream": False})
            assert r.status == 200
            body = await r.json()
            assert body["choices"][0]["message"]["content"] == "4pm."
            assert up.bodies[0][1]["messages"] == convo
            root = await (await client.get("/")).json()
            assert root["provider"] == "vllm"
        finally:
            await client.close()
            eng.shutdown()
