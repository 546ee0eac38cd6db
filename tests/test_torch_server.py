"""The port's WebSocket server against the JAX server, frame for frame.

The same frames go to ``fasttalk_tpu``'s server over its ``FakeEngine``
and to ``fasttalk_tpu_torch``'s server over ``TorchEngine(device="cpu")``
(test-tiny with random weights from ``build_engine``; the trained tinychat
checkpoint where the text must hold sentences). Covered: ``update_config``
answers ``config_updated`` and changes the next generation's parameters;
``DEFAULT_PRESENCE_PENALTY`` / ``DEFAULT_FREQUENCY_PENALTY`` reach the
generation parameters, and an out-of-range value is the same named startup
error in both packages; ``tts_chunking`` frames carry the same speakable
chunks for the same token stream; the admission keys ``priority`` and
``deadline_s`` reach the generation parameters in both, from
``start_session`` and from ``update_config``, and so does ``structured``,
which gives the port a constrained generation; ``journey``, the last session
key of the JAX server the port refused, now reaches the generation in both
and gives the same waterfall; ``/``,
``/stats`` (with the engine's ``scheduler`` section) and ``/metrics``
answer; and ``serve`` drains on shutdown: a running generation completes,
a new submission sheds as a rate-limit frame.
"""

import asyncio
import json
import os

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from fasttalk_tpu.engine.fake import FakeEngine
from fasttalk_tpu.serving.server import WebSocketLLMServer as JaxServer
from fasttalk_tpu.serving.text_processor import \
    extract_speakable_chunk as jax_extract
from fasttalk_tpu.utils.config import Config as JaxConfig
from fasttalk_tpu_torch.serving.server import WebSocketLLMServer as TorchServer
from fasttalk_tpu_torch.serving.text_processor import extract_speakable_chunk
from fasttalk_tpu_torch.utils.config import Config as TorchConfig
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}
# Session keys the port once refused by name; each now reaches the
# generation as in the JAX server.
UNSUPPORTED = {"journey": True}
STRUCTURED = {"kind": "json_schema", "schema": {
    "type": "object", "properties": {"mood": {"enum": ["happy", "sad"]},
                                     "ok": {"type": "boolean"}}}}
ADMISSION = {"priority": "bulk", "deadline_s": 5.0}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_config(monkeypatch):
    monkeypatch.setenv("LLM_PROVIDER", "fake")
    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    return JaxConfig()


def _tiny_config(**kw):
    return TorchConfig(model_name="test-tiny", model_path="",
                       weight_quant="off", dtype="float32", decode_slots=2,
                       max_model_len=256, default_context_window=256,
                       default_max_tokens=8, **kw)


class _Spy:
    """Wraps an engine's ``generate`` and records what each request asks."""

    def __init__(self, engine):
        self.seen = []
        self._generate = engine.generate
        engine.generate = self

    def __call__(self, request_id, session_id, messages, params):
        self.seen.append({"messages": messages, "params": params})
        return self._generate(request_id, session_id, messages, params)


@pytest.fixture(scope="module")
def tiny_engine():
    from fasttalk_tpu_torch.engine.factory import build_engine

    eng = build_engine(_tiny_config(), device="cpu")
    eng.start()
    try:
        yield eng
    finally:
        eng.shutdown()


class _Replay(FakeEngine):
    """The JAX package's fake engine, streaming a given list of token
    texts (so both servers see one token stream)."""

    def __init__(self, tokens):
        super().__init__()
        self.tokens = list(tokens)

    async def generate(self, request_id, session_id, messages, params):
        self.requests_seen.append({"messages": messages, "params": params})
        for text in self.tokens:
            await asyncio.sleep(0)
            yield {"type": "token", "text": text}
        yield {"type": "done", "finish_reason": "length",
               "stats": self._stats(len(self.tokens), 0.0)}


async def _converse(server, frames_out):
    """Open one WS session on ``server``, send each frame of
    ``frames_out`` and collect the replies: one frame per control message,
    and for a ``user_message`` every frame up to the terminal one."""
    client = TestClient(TestServer(server.app))
    await client.start_server()
    try:
        ws = await client.ws_connect("/ws/llm")
        replies = [json.loads((await ws.receive(timeout=60)).data)]
        for frame in frames_out:
            await ws.send_json(frame)
            while True:
                m = json.loads((await ws.receive(timeout=60)).data)
                replies.append(m)
                if frame["type"] != "user_message" or m["type"] != "token":
                    break
        await ws.close()
        return replies
    finally:
        await client.close()


def _run(server, frames_out):
    return asyncio.run(asyncio.wait_for(_converse(server, frames_out), 120))


def _jax_server(monkeypatch, engine=None):
    engine = engine or FakeEngine(delay_s=0.0)
    engine.start()
    return JaxServer(_jax_config(monkeypatch), engine), engine


def _param_view(p):
    return (p.temperature, p.top_k, p.top_p, p.max_tokens, list(p.stop),
            p.repeat_penalty, p.presence_penalty, p.frequency_penalty,
            p.ignore_eos)


def test_update_config_is_answered_and_applies_in_both(monkeypatch,
                                                       tiny_engine):
    update = {"max_tokens": 3, "temperature": 0.5, "top_k": 7,
              "stop": "zz", "presence_penalty": 0.25,
              "system_prompt": "be brief"}
    frames = [{"type": "start_session", "config": {"max_tokens": 5,
                                                   **GREEDY}},
              {"type": "user_message", "text": "hello"},
              {"type": "update_config", "config": update},
              {"type": "user_message", "text": "again"}]
    jax_srv, fake = _jax_server(monkeypatch)
    jax_frames = _run(jax_srv, frames)
    spy = _Spy(tiny_engine)
    try:
        port_frames = _run(TorchServer(_tiny_config(), tiny_engine), frames)
    finally:
        del tiny_engine.generate
    for got in (jax_frames, port_frames):
        done = [f for f in got if f["type"] not in ("token",)]
        assert [f["type"] for f in done] == [
            "session_started", "session_configured", "response_complete",
            "config_updated", "response_complete"], done
        assert done[3] == {"type": "config_updated", "success": True,
                           "config": update}
    jax_seen = fake.requests_seen
    assert len(jax_seen) == len(spy.seen) == 2
    for j, t in zip(jax_seen, spy.seen):
        assert _param_view(j["params"]) == _param_view(t["params"])
        assert j["messages"][0] == t["messages"][0]
    first, second = spy.seen
    assert (first["params"].max_tokens, first["params"].temperature) == (5, 0.0)
    assert (second["params"].max_tokens, second["params"].temperature,
            second["params"].top_k, second["params"].stop,
            second["params"].presence_penalty) == (3, 0.5, 7, ["zz"], 0.25)
    assert second["messages"][0] == {"role": "system", "content": "be brief"}


@pytest.mark.parametrize("name", ["DEFAULT_PRESENCE_PENALTY",
                                  "DEFAULT_FREQUENCY_PENALTY"])
def test_penalty_defaults_reach_the_generation_in_both(monkeypatch, name,
                                                       tiny_engine):
    monkeypatch.setenv(name, "0.5")
    field = name.lower().replace("default_", "")
    frames = [{"type": "start_session", "config": {"max_tokens": 2}},
              {"type": "user_message", "text": "hi"}]
    jax_srv, fake = _jax_server(monkeypatch)
    _run(jax_srv, frames)
    cfg = _tiny_config()
    assert getattr(cfg, name.lower()) == 0.5
    spy = _Spy(tiny_engine)
    try:
        port_frames = _run(TorchServer(cfg, tiny_engine), frames)
    finally:
        del tiny_engine.generate
    assert port_frames[-1]["type"] == "response_complete", port_frames
    assert getattr(fake.requests_seen[0]["params"], field) == 0.5
    assert getattr(spy.seen[0]["params"], field) == 0.5
    other = ({"presence_penalty", "frequency_penalty"} - {field}).pop()
    assert getattr(spy.seen[0]["params"], other) == 0.0


@pytest.mark.parametrize("name", ["DEFAULT_PRESENCE_PENALTY",
                                  "DEFAULT_FREQUENCY_PENALTY"])
@pytest.mark.parametrize("value", ["3", "-2.5"])
def test_penalty_default_out_of_range_is_the_same_startup_error(
        monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    msg = f"{name.lower()} must be in [-2, 2]"
    with pytest.raises(ValueError) as jax_err:
        _jax_config(monkeypatch)
    with pytest.raises(ValueError) as port_err:
        TorchConfig()
    assert msg in str(jax_err.value) and msg in str(port_err.value)
    monkeypatch.setenv(name, "-2")
    _jax_config(monkeypatch)
    assert getattr(TorchConfig(), name.lower()) == -2.0


def test_the_chunker_is_the_jax_one():
    for buf in ["Hello there, friend. How are you?", "short.", "",
                "a-b-c-d-e-f-g-h-i-j-k-l", "The sky is blue.\nIt is."]:
        for min_chars in (1, 12):
            assert extract_speakable_chunk(buf, min_chars) == \
                jax_extract(buf, min_chars)


@pytest.fixture(scope="module")
def tinychat_engine():
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params

    cfg = get_model_config("tinychat", ASSETS)
    eng = TorchEngine(cfg, load_params(cfg, os.path.join(ASSETS, "tinychat"),
                                       torch.float32, "cpu"),
                      load_tokenizer(ASSETS, "tinychat",
                                     template=cfg.chat_template),
                      device="cpu", num_slots=2, max_len=512,
                      dtype=torch.float32, steps_per_call=8)
    eng.start()
    try:
        yield eng
    finally:
        eng.shutdown()


def test_tts_chunking_gives_the_same_speakable_frames(monkeypatch,
                                                      tinychat_engine):
    """The port's tinychat reply, streamed plain, is the token stream; the
    same reply with ``tts_chunking`` through the port's server and that
    token stream with ``tts_chunking`` through the JAX server give the
    same frames: speakable sentence chunks, then the flushed rest."""
    cfg = TorchConfig(model_name="tinychat", model_path=ASSETS,
                      max_model_len=512, default_context_window=512)
    ask = {"type": "user_message",
           "text": "tell me about the sky and the sea."}
    start = {"max_tokens": 40, "ignore_eos": True, **GREEDY}
    plain = _run(TorchServer(cfg, tinychat_engine),
                 [{"type": "start_session", "config": start}, ask])
    tokens = [f["data"] for f in plain if f["type"] == "token"]
    assert all("speakable" not in f for f in plain)
    chunked = {"type": "start_session",
               "config": {**start, "tts_chunking": True}}
    port = _run(TorchServer(cfg, tinychat_engine), [chunked, ask])
    jax_srv, _ = _jax_server(monkeypatch, _Replay(tokens))
    jax = _run(jax_srv, [chunked, ask])

    def speakable(frames):
        return [(f["data"], f.get("speakable")) for f in frames
                if f["type"] == "token"]
    assert speakable(port) == speakable(jax)
    chunks = [d for d, s in speakable(port)]
    assert all(s is True for _, s in speakable(port))
    assert "".join(chunks) == "".join(tokens)
    # Sentences were cut before the end (the text holds split points), and
    # every chunk but the flushed last one ends on a split character.
    assert len(chunks) >= 2, chunks
    assert all(c[-1] in ".!?,;:\n-。、" for c in chunks[:-1])


@pytest.mark.parametrize("key", sorted(UNSUPPORTED))
@pytest.mark.parametrize("message", ["start_session", "update_config"])
def test_unsupported_session_keys_are_refused_by_name(key, message,
                                                      monkeypatch,
                                                      tiny_engine):
    """The port refuses no session key of the JAX server any more: the key
    it once refused by name (``journey``), set by ``start_session`` or
    ``update_config``, is answered as the JAX server answers it, reaches
    ``GenerationParams`` in both, and ``response_complete`` carries the
    same journey waterfall keys."""
    cfg = {key: UNSUPPORTED[key]}
    frames = ([{"type": "start_session", "config": {"max_tokens": 2, **cfg}}]
              if message == "start_session" else
              [{"type": "start_session", "config": {"max_tokens": 2}},
               {"type": "update_config", "config": cfg}])
    frames.append({"type": "user_message", "text": "hi"})
    jax_srv, fake = _jax_server(monkeypatch)
    jax_frames = _run(jax_srv, frames)
    spy = _Spy(tiny_engine)
    try:
        port_frames = _run(TorchServer(_tiny_config(), tiny_engine), frames)
    finally:
        del tiny_engine.generate
    def kinds(frames):
        return [f["type"] for f in frames if f["type"] != "token"]

    assert kinds(port_frames) == kinds(jax_frames)
    for got in (jax_frames, port_frames):
        assert "error" not in [f["type"] for f in got], got
        assert got[-1]["type"] == "response_complete", got
    assert getattr(spy.seen[0]["params"], key) is \
        getattr(fake.requests_seen[0]["params"], key) is True
    port_j = port_frames[-1]["stats"]["journey"]
    jax_j = jax_frames[-1]["stats"]["journey"]
    assert set(port_j) == set(jax_j)
    assert set(port_j["hops_ms"]) == set(jax_j["hops_ms"])
    assert all("st" in f for f in port_frames if f["type"] == "token")


@pytest.mark.parametrize("key", sorted(ADMISSION))
@pytest.mark.parametrize("message", ["start_session", "update_config"])
def test_admission_keys_reach_the_generation_in_both(key, message,
                                                     monkeypatch,
                                                     tiny_engine):
    """``priority`` and ``deadline_s`` set by ``start_session`` or
    ``update_config`` reach ``GenerationParams`` in the JAX server (over
    its FakeEngine) and in the port's, and the generation completes."""
    cfg = {key: ADMISSION[key]}
    frames = ([{"type": "start_session", "config": {"max_tokens": 2, **cfg}}]
              if message == "start_session" else
              [{"type": "start_session", "config": {"max_tokens": 2}},
               {"type": "update_config", "config": cfg}])
    frames.append({"type": "user_message", "text": "hi"})
    jax_srv, fake = _jax_server(monkeypatch)
    jax_frames = _run(jax_srv, frames)
    spy = _Spy(tiny_engine)
    try:
        port_frames = _run(TorchServer(_tiny_config(), tiny_engine), frames)
    finally:
        del tiny_engine.generate
    for got in (jax_frames, port_frames):
        assert got[-1]["type"] == "response_complete", got
    jax_params = fake.requests_seen[0]["params"]
    port_params = spy.seen[0]["params"]
    assert getattr(port_params, key) == getattr(jax_params, key) == cfg[key]
    assert (port_params.priority, port_params.deadline_s) == \
        (jax_params.priority, jax_params.deadline_s)


@pytest.mark.parametrize("message", ["start_session", "update_config"])
def test_structured_key_reaches_a_constrained_generation_in_both(
        message, monkeypatch, tiny_engine):
    """``structured`` set by ``start_session`` or ``update_config`` reaches
    ``GenerationParams`` in the JAX server (over its FakeEngine) and in the
    port's, where the reply is a document of the schema that ends with
    ``stop``, decoded by constrained calls."""
    cfg = {"structured": STRUCTURED, "max_tokens": 48, **GREEDY}
    frames = ([{"type": "start_session", "config": cfg}]
              if message == "start_session" else
              [{"type": "start_session", "config": {"max_tokens": 2}},
               {"type": "update_config", "config": cfg}])
    frames.append({"type": "user_message", "text": "hi"})
    jax_srv, fake = _jax_server(monkeypatch)
    jax_frames = _run(jax_srv, frames)
    calls = tiny_engine.get_stats()["structured"]["calls"]
    spy = _Spy(tiny_engine)
    try:
        port_frames = _run(TorchServer(_tiny_config(), tiny_engine), frames)
    finally:
        del tiny_engine.generate
    for got in (jax_frames, port_frames):
        assert got[-1]["type"] == "response_complete", got
    jax_params = fake.requests_seen[0]["params"]
    port_params = spy.seen[0]["params"]
    assert port_params.structured == jax_params.structured == STRUCTURED
    text = "".join(f["data"] for f in port_frames if f["type"] == "token")
    doc = json.loads(text)
    assert set(doc) == {"mood", "ok"} and doc["mood"] in ("happy", "sad")
    assert isinstance(doc["ok"], bool)
    assert port_frames[-1]["stats"]["finish_reason"] == "stop"
    assert tiny_engine.get_stats()["structured"]["calls"] > calls


def test_http_surface_answers(tiny_engine):
    """``/`` names the service, ``/stats`` carries the engine's stats with
    its ``scheduler`` section and the lifetime totals, ``/metrics`` is
    Prometheus text with the engine's and the scheduler's families."""
    server = TorchServer(_tiny_config(), tiny_engine)

    async def fetch():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            ws = await client.ws_connect("/ws/llm")
            await ws.receive()
            await ws.send_json({"type": "start_session",
                                "config": {"max_tokens": 2}})
            await ws.receive()
            await ws.send_json({"type": "user_message", "text": "hi"})
            while json.loads((await ws.receive()).data)["type"] == "token":
                pass
            await ws.close()
            out = {}
            for path in ("/", "/stats", "/metrics", "/health"):
                r = await client.get(path)
                assert r.status == 200, path
                out[path] = (await r.json() if path != "/metrics"
                             else await r.text())
            return out
        finally:
            await client.close()
    got = asyncio.run(asyncio.wait_for(fetch(), 60))
    assert got["/"]["status"] == "ready" and got["/"]["model"] == "test-tiny"
    stats = got["/stats"]
    assert set(stats["engine"]["scheduler"]) >= {
        "state", "depth", "bound", "draining", "shed_total",
        "expired_total", "service_time_ema_s", "estimated_wait_s"}
    assert stats["engine"]["scheduler"]["bound"] == 256
    assert stats["lifetime"]["requests"] >= 1
    assert stats["lifetime"]["tokens_generated"] >= 1
    text = got["/metrics"]
    for family in ("engine_tokens_generated_total", "engine_ttft_ms_bucket",
                   "sched_queue_depth", "sched_shed_total"):
        assert f"\n{family}" in text, family
    assert got["/health"]["status"] == "healthy"


def test_serve_drains_on_shutdown():
    """``serve`` with its stop event set mid-generation: the running
    stream completes (drain), a submission during the drain sheds as a
    ``rate_limit_error`` frame with ``retry_after`` and the reason
    ``draining``, and the server then stops."""
    import socket

    import aiohttp

    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.serving.server import serve

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cfg = _tiny_config(host="127.0.0.1", port=port,
                       monitoring_host="127.0.0.1", monitoring_port=0)
    engine = build_engine(cfg, device="cpu")
    engine.start()

    async def run():
        stop = asyncio.Event()
        task = asyncio.create_task(serve(cfg, engine, stop))
        url = f"ws://127.0.0.1:{port}/ws/llm"
        async with aiohttp.ClientSession() as http:
            for _ in range(100):
                try:
                    ws = await http.ws_connect(url)
                    break
                except aiohttp.ClientError:
                    await asyncio.sleep(0.05)
            ws2 = await http.ws_connect(url)
            for w in (ws, ws2):
                await w.receive()
                await w.send_json({"type": "start_session", "config": {
                    "max_tokens": 140, "ignore_eos": True, **GREEDY}})
                await w.receive()
            await ws.send_json({"type": "user_message", "text": "hello"})
            first = json.loads((await ws.receive()).data)
            stop.set()
            while not engine._sched.draining:
                await asyncio.sleep(0.01)
            await ws2.send_json({"type": "user_message", "text": "late"})
            shed = json.loads((await ws2.receive()).data)
            frames = [first]
            while frames[-1]["type"] == "token":
                frames.append(json.loads((await ws.receive()).data))
        await asyncio.wait_for(task, 60)
        return frames, shed
    try:
        frames, shed = asyncio.run(asyncio.wait_for(run(), 120))
    finally:
        engine.shutdown()
    assert frames[0]["type"] == "token"
    assert frames[-1]["type"] == "response_complete"
    assert frames[-1]["stats"]["tokens_generated"] == 140
    assert shed["type"] == "error"
    assert shed["error"]["code"] == "rate_limit_error"
    assert shed["error"]["retry_after"] >= 1.0
    assert shed["error"]["details"]["reason"] == "draining"
