"""The tool-calling agent of ``fasttalk_tpu_torch`` (agents/) and where it
is built, held against the JAX package on the CPU.

- The default entry point: ``python -m fasttalk_tpu_torch websocket`` runs
  the port's ``ServerLauncher``, which wraps the engine in a ``VoiceAgent``
  when ``ENABLE_PYDANTIC_AI`` and ``ENABLE_TOOLS`` are true (the default),
  as JAX's ``main.py websocket`` does. Both launchers' servers on the
  trained tinychat checkpoint, with ``WEB_SEARCH_BACKEND=offline`` and
  otherwise the default settings, answer the same session with the same
  prompt token count (the tool section included) and the same greedy
  tokens. The agent is built by the launcher and ``start_local_server``
  only: never by ``WebSocketLLMServer``, ``serve`` or ``build_engine``.
- ``VoiceAgent`` against JAX's on one scripted engine whose replies carry
  ``<tool_call>`` markup: the same events, the same tool executions and
  the same messages handed to the engine on every round.
- The tool registry, its specs, the offline search backend and the
  ``WEB_SEARCH_BACKEND`` mapping give the JAX package's results (nothing
  is fetched: no test builds a live search backend's session).
- The server with an agent: ``tool_call`` frames, ``agent_enabled`` on
  ``/``, ``/health`` and ``session_started``, ``update_config`` forwarded
  to the agent, and the ``/v1`` route's ``_unwrap_agent``.
"""

import asyncio
import json
import os
import socket

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------
# The default entry point builds the agent where JAX's does
# ---------------------------------------------------------------------

def _tinychat_engines():
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer as jax_tok
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.loader import load_params as jax_load
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params

    opts = dict(num_slots=2, max_len=1024, steps_per_call=8)
    jcfg = jax_cfg("tinychat", ASSETS)
    jeng = TPUEngine(jcfg, jax_load(jcfg, os.path.join(ASSETS, "tinychat"),
                                    jnp.float32),
                     jax_tok(ASSETS, "tinychat", template=jcfg.chat_template),
                     dtype=jnp.float32, **opts)
    cfg = get_model_config("tinychat", ASSETS)
    teng = TorchEngine(cfg, load_params(cfg, os.path.join(ASSETS, "tinychat"),
                                        torch.float32, "cpu"),
                       load_tokenizer(ASSETS, "tinychat",
                                      template=cfg.chat_template),
                       device="cpu", dtype=torch.float32, **opts)
    return jeng, teng


async def _one_session(launcher, port):
    """The frames of one greedy session on a running launcher."""
    import aiohttp

    async with aiohttp.ClientSession() as http:
        for _ in range(500):
            try:
                ws = await http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm")
                break
            except aiohttp.ClientError:
                await asyncio.sleep(0.02)
        frames = [json.loads((await ws.receive(timeout=60)).data)]
        await ws.send_json({"type": "start_session", "config": {
            "max_tokens": 12, "ignore_eos": True, **GREEDY}})
        frames.append(json.loads((await ws.receive(timeout=60)).data))
        await ws.send_json({"type": "user_message",
                            "text": "what is the weather like today?"})
        while frames[-1]["type"] not in ("response_complete", "error"):
            frames.append(json.loads((await ws.receive(timeout=120)).data))
        await ws.close()
    return frames


def test_default_launchers_serve_the_same_prompt_as_jax(monkeypatch):
    """The repair of the port's default entry point: with the default agent
    settings both launchers put the hermes tool section into the system
    prompt, so the same session gives the same prompt token count and the
    same greedy tokens. (Before the port's launcher existed its server ran
    agent-less and its prompt was shorter by the whole tool section.)"""
    from fasttalk_tpu.serving.launcher import ServerLauncher as JaxLauncher
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.agents.hermes import (inject_tools_section,
                                                  tools_system_prompt)
    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.utils.config import Config

    for k in ("ENABLE_PYDANTIC_AI", "ENABLE_TOOLS", "ENABLE_WEB_SEARCH",
              "LLM_PROVIDER", "SYSTEM_PROMPT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in {"WEB_SEARCH_BACKEND": "offline", "TPU_WARMUP": "off",
                 "LLM_MODEL": "tinychat", "MODEL_PATH": ASSETS,
                 "TPU_MAX_MODEL_LEN": "1024", "DEFAULT_CONTEXT_WINDOW": "1024",
                 "DEFAULT_MAX_TOKENS": "64", "LLM_HOST": "127.0.0.1",
                 "LLM_MONITORING_HOST": "127.0.0.1"}.items():
        monkeypatch.setenv(k, v)
    jeng, teng = _tinychat_engines()
    launchers = {}
    for name, cls, cfg_cls, eng in (("jax", JaxLauncher, JaxConfig, jeng),
                                    ("torch", ServerLauncher, Config, teng)):
        monkeypatch.setenv("LLM_PORT", str(_free_port()))
        monkeypatch.setenv("LLM_MONITORING_PORT", str(_free_port()))
        cfg = cfg_cls()
        launchers[name] = (cls(cfg, engine=eng), cfg.port)

    async def drive():
        out = {}
        for name, (launcher, port) in launchers.items():
            run = asyncio.create_task(launcher.run())
            try:
                out[name] = await _one_session(launcher, port)
            finally:
                launcher.stop()
                await asyncio.wait_for(run, 60)
        return out

    try:
        frames = asyncio.run(asyncio.wait_for(drive(), 300))
    finally:
        jeng.shutdown()
        teng.shutdown()
    done = {k: f[-1] for k, f in frames.items()}
    tokens = {k: [x["data"] for x in f if x["type"] == "token"]
              for k, f in frames.items()}
    assert done["torch"]["type"] == done["jax"]["type"] == "response_complete"
    assert frames["torch"][0]["agent_enabled"] is True
    assert done["torch"]["stats"]["prompt_tokens"] == \
        done["jax"]["stats"]["prompt_tokens"]
    assert "".join(tokens["torch"]) == "".join(tokens["jax"])
    assert done["torch"]["stats"]["tokens_generated"] == 12
    # The prompt carries the tool section of the default registry.
    agent = launchers["torch"][0].agent
    plain = [{"role": "system", "content": Config().system_prompt},
             {"role": "user", "content": "what is the weather like today?"}]
    with_tools = inject_tools_section(
        plain, tools_system_prompt(agent.registry.specs()))
    tok = teng.tokenizer
    assert done["torch"]["stats"]["prompt_tokens"] == \
        len(tok.apply_chat_template(with_tools)) > \
        len(tok.apply_chat_template(plain))


def test_cli_websocket_runs_the_launcher_with_the_agent(monkeypatch):
    """``python -m fasttalk_tpu_torch websocket`` builds a ``ServerLauncher``
    whose server carries the agent (its start is stubbed here)."""
    from fasttalk_tpu_torch import __main__ as cli
    from fasttalk_tpu_torch.agents.voice_agent import VoiceAgent
    from fasttalk_tpu_torch.serving import launcher as launcher_mod

    for k in ("ENABLE_PYDANTIC_AI", "ENABLE_TOOLS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in {"LLM_MODEL": "test-tiny", "MODEL_PATH": "",
                 "WEB_SEARCH_BACKEND": "offline", "TPU_DECODE_SLOTS": "2",
                 "TPU_MAX_MODEL_LEN": "256"}.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(launcher_mod.ServerLauncher, "start",
                        lambda self: seen.append(self))
    assert cli.main(["websocket", "--device", "cpu"]) == 0
    (launcher,) = seen
    assert isinstance(launcher.agent, VoiceAgent)
    assert launcher.server.agent is launcher.agent
    assert launcher.agent.engine is launcher.engine
    assert type(launcher.engine).__name__ == "TorchEngine"
    launcher.engine.shutdown()


@pytest.mark.parametrize("env", [{"ENABLE_PYDANTIC_AI": "false"},
                                 {"ENABLE_TOOLS": "false"}])
def test_build_agent_follows_the_jax_switches(monkeypatch, env):
    from fasttalk_tpu.serving.launcher import build_agent as jax_build
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.engine.fake import FakeEngine
    from fasttalk_tpu_torch.serving.launcher import build_agent
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("WEB_SEARCH_BACKEND", "offline")
    assert build_agent(Config(), FakeEngine()) is not None
    assert jax_build(JaxConfig(llm_provider="tpu"), FakeEngine()) is not None
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert build_agent(Config(), FakeEngine()) is None
    assert jax_build(JaxConfig(llm_provider="tpu"), FakeEngine()) is None


def test_the_agent_is_never_built_implicitly(monkeypatch):
    """With the default agent settings, ``build_engine`` returns the bare
    engine and ``WebSocketLLMServer`` and ``serve``'s server carry no agent
    unless one is passed."""
    import inspect

    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.serving import server as server_mod
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("WEB_SEARCH_BACKEND", "offline")
    cfg = Config(model_name="test-tiny", model_path="", decode_slots=2,
                 max_model_len=256, default_context_window=256,
                 default_max_tokens=8)
    assert cfg.enable_agent and cfg.enable_tools
    eng = build_engine(cfg, device="cpu")
    assert type(eng) is TorchEngine
    srv = server_mod.WebSocketLLMServer(cfg, eng)
    assert srv.agent is None and srv._backend() is eng
    src = inspect.getsource(server_mod)
    assert "VoiceAgent(" not in src and "build_agent(" not in src


# ---------------------------------------------------------------------
# VoiceAgent against JAX's on a scripted engine
# ---------------------------------------------------------------------

class ScriptedEngine:
    """An engine seam that yields one scripted reply per call, in small
    chunks (duck-typed, so both packages' agents drive the same one)."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []
        self.cancelled = []

    async def generate(self, request_id, session_id, messages, params):
        self.calls.append({"request_id": request_id, "messages": messages,
                           "max_tokens": params.max_tokens})
        text = self.responses.pop(0)
        for i in range(0, len(text), 7):
            yield {"type": "token", "text": text[i:i + 7]}
        yield {"type": "done", "finish_reason": "stop",
               "stats": {"tokens_generated": len(text) // 4 + 1,
                         "prompt_tokens": 10}}

    def cancel(self, request_id):
        self.cancelled.append(request_id)
        return True

    def release_session(self, session_id):
        pass

    def check_connection(self):
        return True

    def begin_drain(self):
        pass

    def get_model_info(self):
        return {"model": "scripted"}

    def get_stats(self):
        return {}


CALL_T = '<tool_call>{"name": "echo", "arguments": {"x": 1}}</tool_call>'
CALL_S = ('<tool_call>{"name": "web_search", "arguments": '
          '{"query": "weather"}}</tool_call>')
SCRIPTS = {
    "plain": (["Just a plain answer."], 4),
    "call_then_resume": (["Let me check. " + CALL_T, "It is noon."], 4),
    "prose_and_trailer": (["Let me check. " + CALL_T + " suppressed",
                           "It is noon."], 4),
    "two_calls": ([CALL_T + CALL_S, "Both done."], 4),
    "round_limit": ([CALL_T] * 6, 2),
    "malformed": (['<tool_call>{"name": oops</tool_call> and on',
                   "recovered"], 4),
    "offline_search": ([CALL_S, "No web today."], 4),
}


def _agent(pkg, engine, max_tool_rounds):
    if pkg == "jax":
        from fasttalk_tpu.agents import tools
        from fasttalk_tpu.agents.voice_agent import VoiceAgent
    else:
        from fasttalk_tpu_torch.agents import tools
        from fasttalk_tpu_torch.agents.voice_agent import VoiceAgent
    reg = tools.build_default_registry(
        enable_web_search=True, search_backend=tools.OfflineSearchBackend(),
        search_rate_limit_s=0.0)
    reg.register(tools.Tool("echo", "echoes its argument",
                            {"type": "object", "properties": {
                                "x": {"type": "integer"}}},
                            lambda x=0: f"echo {x}"))
    return VoiceAgent(engine, registry=reg, max_tool_rounds=max_tool_rounds)


def _drive(pkg, script):
    if pkg == "jax":
        from fasttalk_tpu.engine.engine import GenerationParams
    else:
        from fasttalk_tpu_torch.engine.engine import GenerationParams
    responses, rounds = SCRIPTS[script]
    engine = ScriptedEngine(responses)
    agent = _agent(pkg, engine, rounds)

    async def go():
        return [ev async for ev in agent.generate(
            "r", "s", [{"role": "user", "content": "hi"}],
            GenerationParams(max_tokens=64))]
    events = asyncio.run(go())
    for ev in events:   # wall-clock fields differ run to run
        for k in ("processing_time_ms", "tokens_per_second", "ttft_ms"):
            ev.get("stats", {}).pop(k, None)
    return events, engine.calls


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_voice_agent_matches_jax(script):
    port_events, port_calls = _drive("torch", script)
    jax_events, jax_calls = _drive("jax", script)
    assert port_events == jax_events
    assert port_calls == jax_calls
    assert port_events[-1]["type"] == "done"
    if script != "plain":
        assert port_calls[0]["messages"][0]["role"] == "system"
        assert "<tool_call>" in port_calls[0]["messages"][0]["content"]


def test_agent_cancel_reaches_the_live_sub_request():
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    engine = ScriptedEngine(["Let me check. " + CALL_T, "x" * 400])
    agent = _agent("torch", engine, 4)

    async def go():
        async for ev in agent.generate("top", "s",
                                       [{"role": "user", "content": "hi"}],
                                       GenerationParams(max_tokens=64)):
            if ev["type"] == "token" and len(engine.calls) == 2:
                assert agent.cancel("top")
                break
    asyncio.run(go())
    assert engine.cancelled == ["top.t1"]


# ---------------------------------------------------------------------
# Tools and search backends
# ---------------------------------------------------------------------

def test_tool_specs_and_prompt_are_the_jax_ones():
    from fasttalk_tpu.agents import hermes as jhermes
    from fasttalk_tpu.agents import tools as jtools
    from fasttalk_tpu_torch.agents import hermes, tools

    for web in (True, False):
        port = tools.build_default_registry(enable_web_search=web)
        ref = jtools.build_default_registry(enable_web_search=web)
        assert port.specs() == ref.specs()
        assert port.names() == ref.names()
        assert hermes.tools_system_prompt(port.specs()) == \
            jhermes.tools_system_prompt(ref.specs())


@pytest.mark.parametrize("name,args", [
    ("web_search", {"query": "weather"}), ("teleport", {}),
    ("get_session_info", {"bogus": 1})])
def test_tool_results_are_the_jax_ones(name, args):
    from fasttalk_tpu.agents import tools as jtools
    from fasttalk_tpu_torch.agents import tools

    ctx = {"session_id": "s9", "turns": 2, "started_at": 1.5}
    out = [asyncio.run(mod.build_default_registry(
        search_rate_limit_s=0.0).execute(name, args, context=ctx))
        for mod in (tools, jtools)]
    assert out[0] == out[1]
    assert "UTC" in asyncio.run(tools.build_default_registry().execute(
        "get_current_time", {}))


def test_a_failing_tool_becomes_its_result_as_in_jax():
    from fasttalk_tpu.agents import tools as jtools
    from fasttalk_tpu_torch.agents import tools

    outs = []
    for mod in (tools, jtools):
        reg = mod.ToolRegistry()
        reg.register(mod.Tool("boom", "explodes", {}, lambda: 1 / 0))
        outs.append(json.loads(asyncio.run(reg.execute("boom", {}))))
    assert outs[0] == outs[1] and "failed" in outs[0]["error"]


@pytest.mark.parametrize("kind", ["offline", "duckduckgo", "auto"])
def test_search_backend_selection_is_the_jax_one(kind):
    from types import SimpleNamespace

    from fasttalk_tpu.agents.search import \
        backend_from_config as jax_backend
    from fasttalk_tpu_torch.agents.search import backend_from_config

    cfg = SimpleNamespace(web_search_backend=kind, web_search_timeout=3.0)
    port, ref = backend_from_config(cfg), jax_backend(cfg)
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__module__.startswith("fasttalk_tpu_torch.")


# ---------------------------------------------------------------------
# The server with an agent
# ---------------------------------------------------------------------

def _servers(monkeypatch, script):
    from fasttalk_tpu.serving.server import WebSocketLLMServer as JaxServer
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("LLM_PROVIDER", "fake")
    out = {}
    for pkg, srv_cls, cfg_cls in (("torch", WebSocketLLMServer, Config),
                                  ("jax", JaxServer, JaxConfig)):
        engine = ScriptedEngine(list(SCRIPTS[script][0]))
        agent = _agent(pkg, engine, SCRIPTS[script][1])
        out[pkg] = (srv_cls(cfg_cls(), engine, agent), engine, agent)
    return out


async def _ws_frames(server, messages):
    client = TestClient(TestServer(server.app))
    await client.start_server()
    try:
        ws = await client.ws_connect("/ws/llm")
        frames = [json.loads((await ws.receive()).data)]
        for m in messages:
            await ws.send_json(m)
            while True:
                f = json.loads((await ws.receive(timeout=30)).data)
                frames.append(f)
                if f["type"] in ("response_complete", "error",
                                 "session_configured", "config_updated"):
                    break
        await ws.close()
        info = {p: await (await client.get(p)).json()
                for p in ("/", "/health")}
        return frames, info
    finally:
        await client.close()


def test_tool_call_frames_and_agent_surfaces_match_jax(monkeypatch):
    servers = _servers(monkeypatch, "call_then_resume")
    msgs = [{"type": "start_session", "config": {"max_tokens": 16}},
            {"type": "update_config", "config": {"max_tokens": 20}},
            {"type": "user_message", "text": "time?"}]
    got = {pkg: asyncio.run(_ws_frames(srv, msgs))
           for pkg, (srv, _, _) in servers.items()}

    def view(frames):
        out = []
        for f in frames:
            f = dict(f)
            f.pop("session_id", None)
            if f["type"] == "response_complete":
                f = {"type": f["type"],
                     "finish_reason": f["stats"]["finish_reason"]}
            out.append(f)
        return out
    assert view(got["torch"][0]) == view(got["jax"][0])
    kinds = [f["type"] for f in got["torch"][0]]
    assert "tool_call" in kinds and kinds[-1] == "response_complete"
    assert got["torch"][0][0]["agent_enabled"] is True
    for path in ("/", "/health"):
        assert set(got["torch"][1][path]) == set(got["jax"][1][path]), path
        assert got["torch"][1][path]["agent_enabled"] is True
    for pkg in servers:
        assert servers[pkg][1].calls[0]["max_tokens"] == 20


def test_update_config_reaches_the_agent(monkeypatch):
    servers = _servers(monkeypatch, "plain")
    msgs = [{"type": "update_config", "config": {"max_tokens": 5}}]
    for pkg, (srv, _, agent) in servers.items():
        seen = []
        agent.update_config = lambda **kw: seen.append(kw)
        asyncio.run(_ws_frames(srv, msgs))
        assert seen == [{"max_tokens": 5}], pkg


def test_openai_route_unwraps_the_agent_as_jax_does():
    from fasttalk_tpu.serving.openai_api import _unwrap_agent as jax_unwrap
    from fasttalk_tpu_torch.serving.openai_api import _unwrap_agent

    engine = ScriptedEngine([])
    port_agent, jax_agent = _agent("torch", engine, 1), _agent("jax",
                                                               engine, 1)
    assert _unwrap_agent(port_agent) is engine
    assert jax_unwrap(jax_agent) is engine
    assert _unwrap_agent(engine) is engine
    # Another package's agent is not the port's: left as it is.
    assert _unwrap_agent(jax_agent) is jax_agent
