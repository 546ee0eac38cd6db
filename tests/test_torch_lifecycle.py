"""The engine lifecycle of ``fasttalk_tpu_torch`` held against the JAX
package on the CPU: ``restart()`` after an engine-thread crash, warm-up,
``shutdown``, the launcher's supervisor, and the settings of the slice.

- Trained tinychat, greedy, in both packages: a prompt's tokens before a
  crash equal its tokens after ``restart()``, and equal the other
  package's; a session parked to the host pool before a crash is restored
  after the restart (the pool survives it) and continues with the other
  package's tokens.
- ``restart()`` refuses after ``shutdown`` and while the old thread is
  alive, releases the old KV cache before it allocates the new one (its
  rows freed even where a tensor is still referenced), and
  fails (the supervisor's budget then runs out and ``/health`` reads dead)
  when the device cannot finish the crashed thread's work, as after a
  sticky CUDA error.
- ``warmup`` runs before ``start()`` only, writes nothing the engine reads
  (the cache stays zero, the decode state is the fresh one) and changes no
  greedy output.
- The launcher end to end on test-tiny: a ``crash_thread`` drill through
  ``POST /debug/fault``, the supervisor's restart (``engine_restarts_total``
  1, ``/health`` ok), the next request served, a clean shutdown.
- The new modules import no JAX; the slice's settings have the JAX
  Config's defaults and messages; the fleet settings are accepted or
  refused as the JAX Config does them, and the SPMD setting is refused by
  name.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import init_params
from fasttalk_tpu_torch.resilience import failpoints as fp
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
PROMPT = [{"role": "user", "content": "tell me about the sky and the sea."}]
MSG_A = [{"role": "user", "content": "what is the weather like today?"}]
FILLERS = ([{"role": "user", "content": "say something about cats."}],
           [{"role": "user", "content": "tell me a short story."}])
ENGINE_OPTS = dict(num_slots=2, max_len=512, steps_per_call=8,
                   spec_decode="off", shared_prefix=False,
                   kv_host_budget_mb=64.0, kv_park_ttl_s=600.0,
                   kv_park_idle_s=0.0, kv_restore_min_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pin_policy(eng):
    """Fixed measurements: a restore beats the prefill in both engines."""
    pol = eng._kv_policy
    pol.note_copy = lambda *a: None
    pol.note_prefill = lambda *a: None
    pol._copy_bps, pol._prefill_tps = 1e9, 1e3


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _run(eng, params_cls, rid, sid, msgs, max_tokens=16):
    """(text, terminal event) of one greedy generation."""
    async def go():
        text, last = "", None
        async for ev in eng.generate(rid, sid, msgs, params_cls(
                max_tokens=max_tokens, **GREEDY)):
            if ev["type"] == "token":
                text += ev["text"]
            last = ev
        return text, last
    return asyncio.run(go())


@pytest.fixture
def engines():
    """(package, engine, GenerationParams, failpoints) for the JAX and the
    port's tinychat engines, float32 on the CPU. Built for each test: a
    failpoint fires in every engine of the process, so no engine outlives
    the test that arms one."""
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer as jax_tok
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.loader import load_params as jax_load
    from fasttalk_tpu.resilience import failpoints as jfp
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.loader import load_params

    jcfg = jax_cfg("tinychat", ASSETS)
    jeng = TPUEngine(jcfg, jax_load(jcfg, os.path.join(ASSETS, "tinychat"),
                                    jnp.float32),
                     jax_tok(ASSETS, "tinychat", template=jcfg.chat_template),
                     dtype=jnp.float32, **ENGINE_OPTS)
    cfg = get_model_config("tinychat", ASSETS)
    teng = TorchEngine(cfg, load_params(cfg, os.path.join(ASSETS, "tinychat"),
                                        torch.float32, "cpu"),
                       load_tokenizer(ASSETS, "tinychat",
                                      template=cfg.chat_template),
                       device="cpu", dtype=torch.float32, **ENGINE_OPTS)
    out = {"jax": (jeng, JaxParams, jfp), "torch": (teng, GenerationParams,
                                                    fp)}
    for eng, _, _ in out.values():
        _pin_policy(eng)
        eng.start()
    yield out
    jfp.clear()
    for eng, _, _ in out.values():
        eng.shutdown()


def _crash(eng, failpoints):
    """Kill the engine thread at its loop seam and wait until it is down."""
    failpoints.activate("engine.loop.tick=crash_thread;count=1")
    try:
        assert _wait(lambda: not eng.check_connection(), 10.0)
    finally:
        failpoints.clear()


def test_greedy_tokens_survive_a_restart_in_both_packages(engines):
    got = {}
    for pkg, (eng, params, failpoints) in engines.items():
        before = _run(eng, params, f"{pkg}-b", f"{pkg}-B", PROMPT)
        _crash(eng, failpoints)
        assert not eng.check_connection()
        assert eng.restart()
        after = _run(eng, params, f"{pkg}-a", f"{pkg}-A", PROMPT)
        assert after[1]["type"] == before[1]["type"] == "done"
        assert after[0] == before[0] and before[0], pkg
        got[pkg] = before[0]
    assert got["torch"] == got["jax"]


def test_parked_session_restores_after_a_restart_in_both_packages(engines):
    got = {}
    for pkg, (eng, params, failpoints) in engines.items():
        sid = f"{pkg}-park"
        reply, _ = _run(eng, params, f"{pkg}-p1", sid, MSG_A)
        for i, msgs in enumerate(FILLERS):   # evict the session: it parks
            _run(eng, params, f"{pkg}-f{i}", f"{pkg}-F{i}", msgs, 4)
        assert _wait(lambda: eng._kv_pool.parked_len(sid) > 0), pkg
        kept = eng._kv_pool.parked_len(sid)
        _crash(eng, failpoints)
        assert eng.restart()
        assert eng._kv_pool.parked_len(sid) == kept   # the pool survived
        restored = eng.get_stats()["kv_host"]["restored_total"]
        follow = MSG_A + [{"role": "assistant", "content": reply},
                          {"role": "user", "content": "and tomorrow?"}]
        text, done = _run(eng, params, f"{pkg}-p2", sid, follow)
        assert done["type"] == "done"
        assert eng.get_stats()["kv_host"]["restored_total"] == restored + 1
        assert done["stats"]["prefill_tokens"] < done["stats"][
            "prompt_tokens"]
        got[pkg] = (reply, kept, text)
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------
# restart(), shutdown() and warmup() of the port's engine (test-tiny)
# ---------------------------------------------------------------------

def _tiny_engine(start=True, **kw) -> TorchEngine:
    opts = dict(num_slots=2, max_len=256, prefill_chunk=64,
                dtype=torch.float32, steps_per_call=8)
    opts.update(kw)
    eng = TorchEngine(TINY, init_params(TINY, torch.Generator().manual_seed(0),
                                        torch.float32, "cpu"),
                      ByteTokenizer(), device="cpu", **opts)
    if start:
        eng.start()
    return eng


def test_restart_refusals():
    eng = _tiny_engine()
    try:
        assert eng.restart()                 # running: nothing to do
        eng.check_connection = lambda: False  # thread alive, looks dead
        assert not eng.restart()
        del eng.__dict__["check_connection"]
    finally:
        eng.shutdown()
    assert not eng.restart()                 # shut down: never resurrected
    assert not eng.check_connection()


def test_restart_releases_the_old_cache_before_the_new_one():
    eng = _tiny_engine(kv_layout="paged")
    try:
        fp.activate("engine.loop.tick=crash_thread;count=1")
        assert _wait(lambda: not eng.check_connection(), 5.0)
        fp.clear()
        seen = []
        make = eng._make_cache

        def spy():
            seen.append(eng.cache)
            return make()
        eng._make_cache = spy
        old = eng.cache
        assert eng.restart()
        assert seen == [None] and eng.cache is not old
        # Rows still referenced elsewhere (here: ``old``) are freed anyway.
        assert all(x.untyped_storage().nbytes() == 0
                   for x in old if x is not None)
        async def go():
            return [ev async for ev in eng.generate(
                "r", "s", MSG_A, GenerationParams(max_tokens=4, **GREEDY))]
        assert asyncio.run(go())[-1]["type"] == "done"
    finally:
        fp.clear()
        eng.shutdown()


def _sticky_device_error(monkeypatch, eng):
    """The device reports an error on every synchronize, as a CUDA
    context does after an illegal address."""
    def sync(device=None):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(eng, "device", torch.device("cuda", 0))


def test_a_sticky_device_error_fails_the_restart(monkeypatch):
    eng = _tiny_engine()
    try:
        fp.activate("engine.loop.tick=crash_thread;count=1")
        assert _wait(lambda: not eng.check_connection(), 5.0)
        fp.clear()
        cache = eng.cache
        with monkeypatch.context() as m:
            _sticky_device_error(m, eng)
            assert not eng.restart()
            assert not eng.check_connection()
            assert eng.cache is cache        # nothing torn down
        assert eng.restart()                 # the device answers again
    finally:
        fp.clear()
        eng.shutdown()


async def test_a_sticky_device_error_exhausts_the_supervisor(monkeypatch):
    from aiohttp.test_utils import TestClient, TestServer

    from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app
    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    eng = _tiny_engine()
    cfg = Config(supervisor_max_restarts=2, supervisor_backoff_s=0.01)
    launcher = ServerLauncher(cfg, engine=eng)
    try:
        fp.activate("engine.loop.tick=crash_thread;count=1")
        for _ in range(250):
            if not eng.check_connection():
                break
            await asyncio.sleep(0.02)
        fp.clear()
        with monkeypatch.context() as m:
            _sticky_device_error(m, eng)
            task = asyncio.create_task(launcher._watchdog(interval=0.02))
            for _ in range(300):
                await asyncio.sleep(0.02)
                if launcher.restart_budget.exhausted:
                    break
            task.cancel()
        assert launcher.restart_budget.exhausted
        assert not eng.check_connection()
        assert launcher._m_restarts.value == 0
        client = TestClient(TestServer(build_monitoring_app(
            ready_check=launcher._ready,
            supervisor_info=launcher.supervisor_info)))
        await client.start_server()
        try:
            assert (await (await client.get("/health")).json())[
                "status"] == "dead"
            assert (await client.get("/health/ready")).status == 503
        finally:
            await client.close()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [{}, {"kv_layout": "paged"},
                                {"spec_decode": "ngram"},
                                {"kv_quant": "int8"}],
                         ids=["dense", "paged", "spec", "int8"])
def test_warmup_writes_nothing_and_changes_no_output(kw):
    cold = _tiny_engine(**kw)
    warm = _tiny_engine(start=False, **kw)
    try:
        warm.warmup("full")
        assert not warm._dev_pending
        fresh = _tiny_engine(start=False, **kw)
        for name in ("cur", "pos", "active", "counts"):
            assert torch.equal(getattr(warm._dev, name),
                               getattr(fresh._dev, name)), name
        assert torch.equal(warm._dev.gen.get_state(),
                           fresh._dev.gen.get_state())
        for part in warm.cache:
            if part is None:
                continue
            if warm.paged:   # masked decode writes land in the sink block
                part = part[:, :-warm.kv_block_size]
            assert not part.any()
        warm.start()

        async def go(eng):
            return [ev.get("text") async for ev in eng.generate(
                "r", "s", MSG_A, GenerationParams(max_tokens=12, **GREEDY,
                                                  repeat_penalty=1.3))]
        assert asyncio.run(go(warm)) == asyncio.run(go(cold))
    finally:
        cold.shutdown()
        warm.shutdown()


def test_warmup_runs_before_start_only():
    eng = _tiny_engine()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            eng.warmup("fast")
        eng.warmup("off")   # off is a no-op at any time
    finally:
        eng.shutdown()
    with pytest.raises(ValueError, match="off\\|fast\\|full"):
        _tiny_engine(start=False).warmup("warm")


# ---------------------------------------------------------------------
# The launcher end to end (test-tiny, the CPU)
# ---------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_restarts_a_crashed_engine_end_to_end(monkeypatch):
    """``ServerLauncher.run`` on test-tiny: a ``crash_thread`` armed
    through ``POST /debug/fault`` kills the engine at a session's first
    decode call (one terminal error frame), the supervisor restarts it, ``/health`` reads ok with
    ``engine_restarts_total`` 1, the next session is served, and the stop
    shuts the engine down."""
    import aiohttp

    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in {"LLM_MODEL": "test-tiny", "MODEL_PATH": "",
                 "WEIGHT_QUANT": "off", "TPU_DTYPE": "float32",
                 "TPU_DECODE_SLOTS": "2", "TPU_MAX_MODEL_LEN": "2048",
                 "TPU_DECODE_STEPS": "4", "TPU_SPEC_DECODE": "off",
                 "DEFAULT_CONTEXT_WINDOW": "2048",
                 "DEFAULT_MAX_TOKENS": "8", "WEB_SEARCH_BACKEND": "offline",
                 "FAULT_HTTP": "true", "SUPERVISOR_BACKOFF_S": "0.05",
                 "LLM_HOST": "127.0.0.1", "LLM_MONITORING_HOST": "127.0.0.1",
                 "LLM_PORT": str(_free_port()),
                 "LLM_MONITORING_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    launcher = ServerLauncher(Config(), device="cpu",
                              watchdog_interval_s=0.05)
    assert launcher.agent is not None   # the default: the agent is on

    async def session(http, url, text, **cfg):
        ws = await http.ws_connect(url)
        frames = [json.loads((await ws.receive()).data)]
        await ws.send_json({"type": "start_session", "config": {
            "max_tokens": 200, "ignore_eos": True, **GREEDY, **cfg}})
        frames.append(json.loads((await ws.receive()).data))
        await ws.send_json({"type": "user_message", "text": text})
        while True:
            f = json.loads((await ws.receive(timeout=60)).data)
            frames.append(f)
            if f["type"] in ("response_complete", "error"):
                await ws.close()
                return frames

    async def drive():
        run = asyncio.create_task(launcher.run())
        while "monitoring" not in launcher.addresses:
            await asyncio.sleep(0.02)
        ws_url = f"ws://127.0.0.1:{launcher.addresses['serving'][1]}/ws/llm"
        mon = f"http://127.0.0.1:{launcher.addresses['monitoring'][1]}"
        async with aiohttp.ClientSession() as http:
            assert (await (await http.get(mon + "/health")).json())[
                "supervisor"]["state"] == "ok"
            # Armed first: the session's first decode call crashes the
            # thread after its prefill, with the request in flight.
            r = await http.post(mon + "/debug/fault", json={
                "spec": "engine.decode.dispatch=crash_thread;count=1"})
            assert r.status == 200
            crashed = await session(http, ws_url, "hello")
            for _ in range(500):
                if launcher._m_restarts.value >= 1:
                    break
                await asyncio.sleep(0.02)
            await http.post(mon + "/debug/fault", json={"clear": True})
            health = await (await http.get(mon + "/health")).json()
            metrics = await (await http.get(mon + "/metrics")).text()
            after = await session(http, ws_url, "again", max_tokens=6)
        launcher.stop()
        await asyncio.wait_for(run, 60)
        return crashed, health, metrics, after

    crashed, health, metrics, after = asyncio.run(
        asyncio.wait_for(drive(), 120))
    assert crashed[0]["agent_enabled"] is True
    terminal = [f for f in crashed if f["type"] in ("error",
                                                    "response_complete")]
    assert [f["type"] for f in terminal] == ["error"], crashed[-3:]
    assert health["status"] == "healthy"
    assert health["supervisor"]["state"] == "ok"
    assert health["supervisor"]["restarts_in_window"] == 1
    assert "\nengine_restarts_total 1" in metrics
    assert after[-1]["type"] == "response_complete"
    assert after[-1]["stats"]["tokens_generated"] == 6
    assert not launcher.engine.check_connection()
    assert not launcher.engine._thread.is_alive()


# ---------------------------------------------------------------------
# Imports and settings
# ---------------------------------------------------------------------

def test_the_slices_modules_load_no_jax_module():
    code = (
        "import sys\n"
        "import fasttalk_tpu_torch.serving.launcher\n"
        "import fasttalk_tpu_torch.serving.local\n"
        "import fasttalk_tpu_torch.agents\n"
        "import fasttalk_tpu_torch.agents.search\n"
        "import fasttalk_tpu_torch.engine.remote\n"
        "import fasttalk_tpu_torch.engine.fake\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fasttalk_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


SLICE_FIELDS = (
    "llm_provider", "vllm_base_url", "vllm_model", "vllm_api_key",
    "vllm_timeout", "ollama_base_url", "ollama_keep_alive", "ollama_timeout",
    "remote_max_inflight", "remote_connect_retries", "enable_agent",
    "enable_web_search", "enable_tools", "web_search_rate_limit",
    "web_search_backend", "web_search_timeout", "engine_auto_restart",
    "supervisor_max_restarts", "supervisor_window_s",
    "supervisor_backoff_s", "fault_points", "fault_http_enabled", "warmup",
    "default_repeat_penalty")


@pytest.mark.parametrize("env", [{}, {"LLM_PROVIDER": "vllm"},
                                 {"LLM_PROVIDER": "fake"}],
                         ids=["default", "vllm", "fake"])
def test_slice_settings_have_the_jax_defaults(monkeypatch, env):
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, ref = Config(), JaxConfig()
    assert {f: getattr(port, f) for f in SLICE_FIELDS} == \
        {f: getattr(ref, f) for f in SLICE_FIELDS}


@pytest.mark.parametrize("env,message", [
    ({"SUPERVISOR_MAX_RESTARTS": "0"}, "supervisor_max_restarts must be"),
    ({"SUPERVISOR_WINDOW_S": "0"}, "supervisor_window_s must be > 0"),
    ({"SUPERVISOR_BACKOFF_S": "0"}, "supervisor_backoff_s must be > 0"),
    ({"TPU_WARMUP": "warm"}, "warmup must be 'off', 'fast' or 'full'"),
    ({"LLM_PROVIDER": "bogus"}, "llm_provider must be one of")])
def test_bad_slice_settings_fail_as_in_jax(monkeypatch, env, message):
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cls in (Config, JaxConfig):
        with pytest.raises(ValueError) as err:
            cls()
        assert message in str(err.value), cls


@pytest.mark.parametrize("env", [
    {"ROUTER_ENABLED": "true"}, {"KV_MIGRATE_HTTP": "true"},
    {"FLEET_SCALE_MAX": "2"}, {"TPU_SPMD_ROLE": "leader"},
    {"ROUTER_ENABLED": "true", "FLEET_SCALE_MAX": "2"},
    {"ROUTER_ENABLED": "true", "FLEET_SCALE_MIN": "3",
     "FLEET_SCALE_MAX": "2"},
    {"ROUTER_ENABLED": "true", "FLEET_ROLES": "prefill"},
    {"ROUTER_ENABLED": "true", "FLEET_ROLES": "prefill,decode"},
    {"FLEET_ROLES": "prefill,decode"},
    {"ROUTER_ENABLED": "true", "FLEET_ROLES": "prefill,prefill"},
    {"ROUTER_ENABLED": "true", "FLEET_REPLICAS": "0"},
    {"ROUTER_ENABLED": "true", "ROUTER_MIGRATE_TIMEOUT_S": "0"},
    {"FLEET_FLIGHT_FAILOVER_BURST": "1"},
    {"ROUTER_ENABLED": "true", "TPU_SPMD_ROLE": "leader"}])
def test_router_and_spmd_settings_are_refused_by_name(monkeypatch, env):
    """The fleet settings are accepted or refused as the JAX Config does,
    with its messages; multi-host SPMD (``TPU_SPMD_ROLE``) without the
    process group's settings is refused by name with how to launch it, and
    beside ``ROUTER_ENABLED`` the port also gives JAX's router x SPMD
    message."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "TPU_SPMD_ROLE" in env:
        with pytest.raises(ValueError,
                           match="one process per device") as err:
            Config()
        assert "TPU_SPMD_ROLE" in str(err.value)
        if "ROUTER_ENABLED" in env:
            assert "router_enabled is incompatible with multi-host SPMD " \
                "serving" in str(err.value)
        return
    try:
        JaxConfig()
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        cfg = Config()
        for k in env:
            field = {"ROUTER_ENABLED": "router_enabled",
                     "KV_MIGRATE_HTTP": "kv_migrate_http",
                     "FLEET_SCALE_MAX": "fleet_scale_max",
                     "FLEET_ROLES": "fleet_roles"}[k]
            assert getattr(cfg, field) == getattr(JaxConfig(), field)
        return
    with pytest.raises(ValueError) as err:
        Config()
    # The same messages: JAX joins them with "; ", the port one a line.
    got = [line.strip() for line in str(err.value).splitlines()[1:]]
    assert got and want == "Invalid configuration: " + "; ".join(got)


@pytest.mark.parametrize("provider,cls_name", [
    ("fake", "FakeEngine"), ("vllm", "VLLMRemoteEngine"),
    ("openai", "VLLMRemoteEngine"), ("ollama", "OllamaRemoteEngine")])
def test_factory_selects_the_provider_as_jax_does(monkeypatch, provider,
                                                  cls_name):
    from fasttalk_tpu.engine.factory import build_engine as jax_build
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("LLM_PROVIDER", provider)
    port, ref = build_engine(Config()), jax_build(JaxConfig())
    assert type(port).__name__ == type(ref).__name__ == cls_name
    assert type(port).__module__.startswith("fasttalk_tpu_torch.")
    for attr in ("base_url", "model", "max_inflight", "connect_retries"):
        assert getattr(port, attr, None) == getattr(ref, attr, None), attr
