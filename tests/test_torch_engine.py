"""fasttalk_tpu_torch's engine and server on the CPU, and its import rules.

``TorchEngine(device="cpu")`` on the trained tinychat checkpoint must give
the same greedy text as the JAX package's ``TPUEngine`` for the prompts of
tests/test_trained_tiny.py, whether the sessions run one at a time or
four at once, on the dense bf16 cache and on the paged int8 pool (the
JAX engine then runs the same KV settings); cancel ends a stream with a
``cancelled`` event; one WebSocket round trip runs through the port's
server. A small block pool sheds with ``kv_blocks_exhausted`` and
``retry_after`` at admission and mid-decode while the engine keeps
serving, and the WebSocket client sees that as a ``rate_limit_error``
frame. The port and ``chip_smoke.py`` import neither ``jax`` nor
``fasttalk_tpu``, and an entry point asked for no device refuses to run
without a GPU.
"""

import ast
import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch
from tests._port_isolation import port_isolation  # noqa: F401,E402

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


PAGED_INT8 = dict(kv_layout="paged", kv_quant="int8")


def _jax_replies(**kv):
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
                    shared_prefix=False, **kv)
    eng.start()
    try:
        async def run():
            return {rid: await _collect(eng, GenerationParams, rid, msgs, n)
                    for rid, msgs, n in PROMPTS}
        return asyncio.run(run())
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def jax_texts():
    return _jax_replies()


@pytest.fixture(scope="module")
def jax_texts_paged_int8():
    return _jax_replies(**PAGED_INT8)


def _torch_engine(**kw):
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
                       dtype=torch.float32, steps_per_call=8, **kw)


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


@pytest.fixture(scope="module")
def torch_engine_paged_int8():
    eng = _torch_engine(**PAGED_INT8)
    eng.start()
    try:
        yield eng
    finally:
        eng.shutdown()


def test_paged_int8_one_session_at_a_time_matches_jax_engine(
        torch_engine_paged_int8, jax_texts_paged_int8):
    """KV_LAYOUT=paged with KV_QUANT=int8 on both engines: the same greedy
    text, finish reason and token count; all blocks return once the
    sessions are released."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    eng = torch_engine_paged_int8
    assert eng.get_model_info()["kv_layout"] == "paged"

    async def run():
        out = {rid: await _collect(eng, GenerationParams, rid, msgs, n)
               for rid, msgs, n in PROMPTS}
        for rid, _, _ in PROMPTS:
            eng.release_session(f"s-{rid}")
        # A command after the releases: they are processed once it ends.
        await _collect(eng, GenerationParams, "sync", PROMPTS[0][1], 1)
        eng.release_session("s-sync")
        await _collect(eng, GenerationParams, "sync2", PROMPTS[0][1], 1)
        return out
    got = asyncio.run(run())
    for rid, (text, final) in got.items():
        want_text, want_final = jax_texts_paged_int8[rid]
        assert text == want_text, rid
        assert final["finish_reason"] == want_final["finish_reason"]
        assert final["stats"]["tokens_generated"] == \
            want_final["stats"]["tokens_generated"]
    assert "blue" in got["sky"][0].lower() and "Alice" in got["alice"][0]
    eng._kv_blocks.check_leaks()
    assert eng.get_stats()["kv_blocks"]["in_use"] == \
        eng._kv_blocks.slot_blocks(eng.slots.lookup("s-sync2").index)


def test_paged_int8_four_concurrent_sessions_match_jax_engine(
        torch_engine_paged_int8, jax_texts_paged_int8):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        return await asyncio.gather(*(
            _collect(torch_engine_paged_int8, GenerationParams, f"c-{rid}",
                     msgs, n) for rid, msgs, n in PROMPTS[:4]))
    got = asyncio.run(run())
    for (rid, _, _), (text, final) in zip(PROMPTS[:4], got):
        assert text == jax_texts_paged_int8[rid][0], rid
        assert final["type"] == "done"
    torch_engine_paged_int8._kv_blocks.check_leaks()


def test_small_pool_sheds_with_retry_after_and_keeps_serving():
    """A 6-block pool of 16 tokens: a long prompt sheds at admission, then
    two long generations with no reserve outgrow the pool mid-decode and
    the most recently admitted one sheds; every shed carries
    ``kv_blocks_exhausted`` and ``retry_after``, the survivor finishes,
    short requests keep being served once the long sessions are released,
    and no block leaks."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    eng = _torch_engine(kv_layout="paged", kv_pool_blocks=6,
                        kv_reserve_policy="none")
    eng.start()
    try:
        async def run():
            long_msgs = [{"role": "user", "content": "tell me a story " * 30}]
            shed = await _collect(eng, GenerationParams, "long", long_msgs, 8)
            ok = await _collect(eng, GenerationParams, "sky", PROMPTS[0][1],
                                48)
            grow = await asyncio.gather(*(
                _collect(eng, GenerationParams, f"g{i}", PROMPTS[0][1], 60,
                         ignore_eos=True) for i in range(2)))
            # Idle pinned sessions keep their blocks until released.
            for i in range(2):
                eng.release_session(f"s-g{i}")
            after = await _collect(eng, GenerationParams, "sky2",
                                   PROMPTS[0][1], 48)
            return shed, ok, grow, after
        shed, ok, grow, after = asyncio.run(asyncio.wait_for(run(), 120))
    finally:
        eng.shutdown()
    for _, final in [shed] + [g for g in grow if g[1]["type"] == "error"]:
        assert final["type"] == "error"
        assert final["code"] == "kv_blocks_exhausted"
        assert final["retry_after"] >= 0.5
    assert sorted(g[1]["type"] for g in grow) == ["done", "error"]
    survivor = next(g for g in grow if g[1]["type"] == "done")
    assert survivor[1]["stats"]["tokens_generated"] == 60
    assert "blue" in ok[0].lower() and after[0] == ok[0]
    eng._kv_blocks.check_leaks()


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


def test_websocket_shed_is_a_rate_limit_frame():
    """A terminal ``kv_blocks_exhausted`` reaches the client as a
    ``rate_limit_error`` frame with ``retry_after`` and the reason, the
    circuit breaker counts no failure, and /models reports the KV tier."""
    import aiohttp
    from aiohttp import web

    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    async def run():
        engine = _torch_engine(kv_layout="paged", kv_quant="int8",
                               kv_pool_blocks=4)
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
                async with http.get(f"{base}/models") as r:
                    info = await r.json()
                async with http.ws_connect(f"{base}/ws/llm") as ws:
                    await ws.receive()
                    await ws.send_json({"type": "start_session", "config": {
                        "max_tokens": 16, **GREEDY}})
                    await ws.receive()
                    await ws.send_json({"type": "user_message",
                                        "text": "tell me a story " * 30})
                    frame = json.loads((await ws.receive()).data)
            return info, frame, server.breaker.to_dict()
        finally:
            if runner is not None:
                await runner.cleanup()
            engine.shutdown()

    info, frame, breaker = asyncio.run(asyncio.wait_for(run(), timeout=120))
    assert (info["kv_layout"], info["kv_quant"], info["kv_block_size"]) == \
        ("paged", "int8", 16)
    assert frame["type"] == "error"
    err = frame["error"]
    assert err["code"] == "rate_limit_error" and err["retry_after"] >= 0.5
    assert err["details"]["reason"] == "kv_blocks_exhausted"
    assert breaker == {"state": "closed", "failures": 0}


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
    scanned = {os.path.relpath(p, PORT_PKG) for p in files}
    assert {"structured/compiler.py", "structured/fsm.py",
            "structured/regex_dfa.py", "structured/runtime.py",
            "structured/schema.py", "agents/hermes.py",
            "resilience/failpoints.py", "observability/trace.py",
            "serving/openai_api.py", "router/__init__.py",
            "router/replica.py", "router/policy.py", "router/migrate.py",
            "router/disagg.py", "router/router.py", "router/elastic.py",
            "observability/fleetflight.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/distributed.py",
            "parallel/collectives.py", "parallel/sharding.py",
            "parallel/ring_attention.py", "parallel/spmd_serving.py",
            "parallel/train.py", "training/__init__.py",
            "training/trainer.py", "training/export.py",
            "training/optim.py", "training/tinychat.py"} \
        <= scanned
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "fasttalk_tpu",
                               "ml_dtypes"), (path, name)


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys\n"
        "import fasttalk_tpu_torch, fasttalk_tpu_torch.__main__\n"
        "import fasttalk_tpu_torch.engine.factory\n"
        "import fasttalk_tpu_torch.serving.server\n"
        "import fasttalk_tpu_torch.quantization\n"
        "import fasttalk_tpu_torch.quantization.awq\n"
        "import fasttalk_tpu_torch.models.prepared_cache\n"
        "import fasttalk_tpu_torch.training.corpus\n"
        "import fasttalk_tpu_torch.ops.cuda_int4\n"
        "import fasttalk_tpu_torch.structured\n"
        "import fasttalk_tpu_torch.agents.hermes\n"
        "import fasttalk_tpu_torch.resilience.failpoints\n"
        "import fasttalk_tpu_torch.observability.trace\n"
        "import fasttalk_tpu_torch.serving.openai_api\n"
        "import fasttalk_tpu_torch.monitoring.monitor\n"
        "import fasttalk_tpu_torch.observability.flight\n"
        "import fasttalk_tpu_torch.router\n"
        "import fasttalk_tpu_torch.observability.fleetflight\n"
        "import fasttalk_tpu_torch.parallel.spmd_serving\n"
        "import fasttalk_tpu_torch.parallel.ring_attention\n"
        "import fasttalk_tpu_torch.parallel.distributed\n"
        "import fasttalk_tpu_torch.parallel.train\n"
        "import fasttalk_tpu_torch.training\n"
        "import fasttalk_tpu_torch.training.tinychat\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fasttalk_tpu', 'ml_dtypes')]\n"
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
    {"TPU_TP_SIZE": "2"}, {"WEIGHT_QUANT": "int4", "TPU_TP_SIZE": "2"}])
def test_config_rejects_features_outside_the_slice(monkeypatch, env):
    """A mesh without the process group of one rank per device is refused
    with how to launch one; int4 on a mesh also gets the JAX message."""
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="one process per device") as err:
        Config()
    if "WEIGHT_QUANT" in env:
        assert "WEIGHT_QUANT=int4 is single-device only" in str(err.value)


@pytest.mark.parametrize("env", [
    {"KV_QUANT": "int8", "TPU_SPEC_DECODE": "ngram"},
    {"KV_QUANT": "int8"},
    {"TPU_SPEC_DECODE": "eagle"}, {"TPU_SPEC_DRAFT": "0"},
    {"SCHED_DEFAULT_PRIORITY": "vip"}, {"TPU_SAMPLING": "topk"},
    {"STRUCTURED_MODE": "maybe"},
    {"KV_RADIX_ENABLED": "true"}, {"KV_RADIX_EVICT_POLICY": "mru"},
    {"KV_HOST_BUDGET_MB": "-1"},
    {"KV_LAYOUT": "paged", "KV_RADIX_ENABLED": "true",
     "KV_POOL_BLOCKS": "64", "KV_RADIX_MIN_BLOCKS": "64"}])
def test_config_rejects_bad_engine_settings_as_jax_does(monkeypatch, env):
    """Speculative decoding with int8 KV (also by the auto default), a bad
    TPU_SPEC_DECODE, TPU_SPEC_DRAFT=0, a bad SCHED_DEFAULT_PRIORITY, a bad
    TPU_SAMPLING, a bad STRUCTURED_MODE, the radix cache without the paged
    layout, a bad KV_RADIX_EVICT_POLICY, a negative KV_HOST_BUDGET_MB and a
    radix headroom covering the whole pool fail at startup with the JAX
    Config's own messages."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(llm_provider="tpu")
    with pytest.raises(ValueError) as port_err:
        Config()
    want = str(jax_err.value).split(": ", 1)[1].split("; ")
    assert want and all(line in str(port_err.value) for line in want), \
        (want, str(port_err.value))


KV_HIERARCHY = ("kv_host_budget_mb", "kv_park_ttl_s", "kv_park_idle_s",
                "kv_restore_min_tokens", "kv_radix_enabled",
                "kv_radix_min_blocks", "kv_radix_evict_policy")


@pytest.mark.parametrize("env", [
    {"KV_LAYOUT": "paged", "KV_RADIX_ENABLED": "true"},
    {"KV_HOST_BUDGET_MB": "64", "KV_PARK_TTL_S": "30", "KV_PARK_IDLE_S": "0",
     "KV_RESTORE_MIN_TOKENS": "16"}])
def test_config_accepts_the_kv_hierarchy_as_jax_does(monkeypatch, env):
    """The radix cache on the paged pool and the host-offload tier are
    accepted, and their seven settings resolve to the JAX Config's values;
    build_engine passes them to the engine."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = Config(), JaxConfig(llm_provider="tpu")
    assert {f: getattr(port, f) for f in KV_HIERARCHY} == \
        {f: getattr(ref, f) for f in KV_HIERARCHY}
    port.model_name, port.model_path = "test-tiny", ""
    port.max_model_len = port.default_context_window = 512
    port.decode_slots = 2
    eng = build_engine(port, device="cpu")
    try:
        assert (eng._kv_radix is not None) == port.kv_radix_enabled
        assert eng._kv_pool.enabled == (port.kv_host_budget_mb > 0)
        assert eng._kv_policy.min_tokens == port.kv_restore_min_tokens
    finally:
        eng.shutdown()


def test_config_has_the_jax_serving_defaults():
    """With no environment, the settings of the JAX engine's serving path
    (sampling, shared prefix, speculative decoding, the scheduler) have the
    JAX Config's values, field by field."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    fields = ("sampling", "shared_prefix", "spec_decode", "spec_draft_len",
              "spec_breakeven", "sched_queue_bound",
              "sched_default_deadline_s", "sched_default_priority",
              "sched_bulk_aging_s", "sched_drain_timeout_s") + KV_HIERARCHY
    port, ref = Config(), JaxConfig(llm_provider="tpu")
    assert {f: getattr(port, f) for f in fields} == \
        {f: getattr(ref, f) for f in fields}
    assert (port.spec_decode, port.spec_draft_len, port.spec_breakeven,
            port.shared_prefix, port.sampling) == ("auto", 7, 1.45, True,
                                                   "fast")
