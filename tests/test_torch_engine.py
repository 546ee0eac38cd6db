"""fasttalk_tpu_torch's engine and server on the CPU, and its import rules.

``TorchEngine(device="cpu")`` on the trained tinychat checkpoint must give
the same greedy text as the JAX package's ``TPUEngine`` for the prompts of
tests/test_trained_tiny.py, whether the sessions run one at a time or
four at once; cancel ends a stream with a ``cancelled`` event; one
WebSocket round trip runs through the port's server. The port and
``chip_smoke.py`` import neither ``jax`` nor ``fasttalk_tpu``, and an
entry point asked for no device refuses to run without a GPU.
"""

import ast
import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
PORT_PKG = os.path.join(REPO, "fasttalk_tpu_torch")

GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
PROMPTS = [
    ("sky", [{"role": "user", "content": "what color is the sky?"}], 48),
    ("alice", [{"role": "user", "content": "my name is Alice."},
               {"role": "assistant", "content": "Nice to meet you, Alice!"},
               {"role": "user", "content": "what is my name?"}], 24),
    ("bob", [{"role": "user", "content": "my name is Bob."},
             {"role": "assistant", "content": "Nice to meet you, Bob!"},
             {"role": "user", "content": "what is my name?"}], 24),
    ("math", [{"role": "user", "content": "what is three plus four?"}], 24),
    ("opp", [{"role": "user", "content": "what is the opposite of hot?"}], 24),
]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


async def _collect(engine, params_cls, rid, messages, max_tokens, **kw):
    params = params_cls(max_tokens=max_tokens, **{**GREEDY, **kw})
    text, final = "", {}
    async for ev in engine.generate(rid, f"s-{rid}", messages, params):
        if ev["type"] == "token":
            text += ev["text"]
        else:
            final = ev
    return text, final


@pytest.fixture(scope="module")
def jax_texts():
    """Greedy replies of the JAX engine, one session at a time (float32)."""
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import GenerationParams, TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer
    from fasttalk_tpu.models.configs import get_model_config
    from fasttalk_tpu.models.loader import load_params

    cfg = get_model_config("tinychat", ASSETS)
    eng = TPUEngine(cfg, load_params(cfg, os.path.join(ASSETS, "tinychat"),
                                     jnp.float32),
                    load_tokenizer(ASSETS, "tinychat",
                                   template=cfg.chat_template),
                    num_slots=4, max_len=512, dtype=jnp.float32,
                    steps_per_call=8, spec_decode="off",
                    shared_prefix=False)
    eng.start()
    try:
        async def run():
            return {rid: await _collect(eng, GenerationParams, rid, msgs, n)
                    for rid, msgs, n in PROMPTS}
        return asyncio.run(run())
    finally:
        eng.shutdown()


def _torch_engine():
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params

    cfg = get_model_config("tinychat", ASSETS)
    return TorchEngine(cfg, load_params(cfg, os.path.join(ASSETS, "tinychat"),
                                        torch.float32, "cpu"),
                       load_tokenizer(ASSETS, "tinychat",
                                      template=cfg.chat_template),
                       device="cpu", num_slots=4, max_len=512,
                       dtype=torch.float32, steps_per_call=8)


@pytest.fixture(scope="module")
def torch_engine():
    eng = _torch_engine()
    eng.start()
    try:
        yield eng
    finally:
        eng.shutdown()


def test_one_session_at_a_time_matches_jax_engine(torch_engine, jax_texts):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        return {rid: await _collect(torch_engine, GenerationParams, rid,
                                    msgs, n) for rid, msgs, n in PROMPTS}
    got = asyncio.run(run())
    for rid, (text, final) in got.items():
        assert text == jax_texts[rid][0], rid
        assert final["finish_reason"] == jax_texts[rid][1]["finish_reason"]
        assert final["stats"]["tokens_generated"] == \
            jax_texts[rid][1]["stats"]["tokens_generated"]
    assert "blue" in got["sky"][0].lower() and "Alice" in got["alice"][0]


def test_four_concurrent_sessions_match_jax_engine(torch_engine, jax_texts):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        return await asyncio.gather(*(
            _collect(torch_engine, GenerationParams, f"c-{rid}", msgs, n)
            for rid, msgs, n in PROMPTS[:4]))
    got = asyncio.run(run())
    for (rid, _, _), (text, final) in zip(PROMPTS[:4], got):
        assert text == jax_texts[rid][0], rid
        assert final["type"] == "done"


def test_cancel_ends_the_stream(torch_engine):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        params = GenerationParams(max_tokens=400, ignore_eos=True, **GREEDY)
        events = []
        async for ev in torch_engine.generate(
                "cx", "s-cx", PROMPTS[0][1], params):
            events.append(ev)
            if ev["type"] == "token":
                torch_engine.cancel("cx")
        return events
    events = asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert events[-1]["type"] == "cancelled"
    assert events[-1]["stats"]["tokens_generated"] < 400
    assert torch_engine.get_stats()["running"] == 0


def test_websocket_round_trip():
    import aiohttp
    from aiohttp import web

    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    async def run():
        engine = _torch_engine()
        engine.start()
        runner = None
        try:
            server = WebSocketLLMServer(
                Config(model_name="tinychat", model_path=ASSETS,
                       max_model_len=512, default_context_window=512),
                engine)
            runner = web.AppRunner(server.app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
            base = f"http://127.0.0.1:{port}"
            async with aiohttp.ClientSession() as http:
                async with http.get(f"{base}/health") as r:
                    assert r.status == 200
                async with http.get(f"{base}/models") as r:
                    assert (await r.json())["model"] == "tinychat"
                async with http.ws_connect(f"{base}/ws/llm") as ws:
                    frames = [json.loads((await ws.receive()).data)]
                    await ws.send_json({"type": "start_session", "config": {
                        "max_tokens": 48, **GREEDY}})
                    frames.append(json.loads((await ws.receive()).data))
                    await ws.send_json({"type": "user_message",
                                        "text": "what color is the sky?"})
                    text = ""
                    while True:
                        m = json.loads((await ws.receive()).data)
                        frames.append(m)
                        if m["type"] == "token":
                            text += m["data"]
                        else:
                            break
                    await ws.send_json({"type": "end_session"})
                    frames.append(json.loads((await ws.receive()).data))
            return frames, text
        finally:
            if runner is not None:
                await runner.cleanup()
            engine.shutdown()

    frames, text = asyncio.run(asyncio.wait_for(run(), timeout=120))
    types = [f["type"] for f in frames]
    assert types[:2] == ["session_started", "session_configured"]
    assert types[-2:] == ["response_complete", "session_ended"]
    assert "error" not in types and "blue" in text.lower()
    assert frames[-2]["stats"]["finish_reason"] == "stop"


def _imported_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "fasttalk_tpu"), (path, name)


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys\n"
        "import fasttalk_tpu_torch, fasttalk_tpu_torch.__main__\n"
        "import fasttalk_tpu_torch.engine.factory\n"
        "import fasttalk_tpu_torch.serving.server\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fasttalk_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_refuse_to_run_without_a_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config, resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine(Config(model_name="tinychat", model_path=ASSETS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _default_device_engine()
    assert resolve_device("cpu").type == "cpu"


def _default_device_engine():
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config

    return TorchEngine(get_model_config("test-tiny"), {}, ByteTokenizer())


@pytest.mark.parametrize("env", [
    {"TPU_SPEC_DECODE": "ngram"}, {"KV_QUANT": "int8"},
    {"KV_LAYOUT": "paged"}, {"KV_HOST_BUDGET_MB": "64"},
    {"KV_RADIX_ENABLED": "true"}, {"STRUCTURED_MODE": "on"},
    {"TPU_TP_SIZE": "2"}, {"WEIGHT_QUANT": "int4"}])
def test_config_rejects_features_outside_the_slice(monkeypatch, env):
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="not implemented yet"):
        Config()
