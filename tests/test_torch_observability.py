"""The port's observability stack against the JAX package's.

Parity runs (``_drive``, one fresh process per package and KV tier, so
each metrics registry holds only what the served path registers): the
same greedy WebSocket traffic on test-tiny goes through ``TPUEngine``
behind the JAX server and ``TorchEngine(device="cpu")`` behind the port's,
each with its monitoring app, on the dense tier and on the paged tier
with the radix cache. The Prometheus ``# TYPE`` families are equal, and
so are the key sets of ``/stats``, ``/health``, ``/slo`` and ``/perf``
(the port's engine stats carry more counters than the JAX engine's: there
the JAX keys are a subset). ``/perf``'s programs ``fsum`` to its busy
total bit for bit, and a journey session's stamps and waterfall have the
same names.

Then, each in both packages: ``program_key`` strings for the same call;
a stalled request force-failed by the watchdog ends with the same frame;
an SLO page sheds a bulk submission; idle-session housekeeping (Queue C
1) drops the conversation and closes the connection; a dead engine reads
``degraded`` on ``/health`` and a refusal at ``LLM_MAX_CONNECTIONS``
carries the same ``retry_after`` hint (Queue C 3). And the port's own:
flight bundles and profiler traces go to its own default directories
(under ``tmp_path`` here), a bundle holds a ``cuda_trace/`` Chrome trace,
and no thread the port starts outlives a server's cleanup.
"""

import asyncio
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import types

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tests._port_isolation import port_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
# The paged tier runs with the shared-prefix burst off: the JAX engine's
# dense stamp crashes on the paged pool (tests/test_torch_shared_prefix.py).
TIERS = {"dense": {},
         "paged_radix": {"kv_layout": "paged", "kv_radix": True,
                         "shared_prefix": False}}
PROMPTS = ["Tell me about the ocean.", "What is a good breakfast?"]
GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------
# The parity runs (each in a child process)
# ---------------------------------------------------------------------

def _engine(pkg: str, **kv):
    """test-tiny with random float32 weights in ``pkg``'s engine: 2 slots,
    max_len 256, 8 steps a call, speculative decoding off."""
    common = dict(num_slots=2, max_len=256, steps_per_call=8,
                  spec_decode="off", **kv)
    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        from fasttalk_tpu.engine.engine import TPUEngine
        from fasttalk_tpu.engine.tokenizer import ByteTokenizer
        from fasttalk_tpu.models import llama
        from fasttalk_tpu.models.configs import get_model_config

        cfg = get_model_config("test-tiny")
        return TPUEngine(cfg, llama.init_params(cfg, jax.random.PRNGKey(0),
                                                jnp.float32),
                         ByteTokenizer(), dtype=jnp.float32, **common)
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.llama import init_params

    cfg = get_model_config("test-tiny")
    return TorchEngine(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        torch.float32, "cpu"),
                       ByteTokenizer(), device="cpu", dtype=torch.float32,
                       **common)


def _chat_engine(pkg: str, **kv):
    """The trained tinychat checkpoint in ``pkg``'s engine (float32, 2
    slots, max_len 512, 8 steps a call, speculative decoding off): its
    greedy replies are text, so every token frame carries its stamps
    (test-tiny's random weights stream bytes that decode to no text)."""
    common = dict(num_slots=2, max_len=512, steps_per_call=8,
                  spec_decode="off", **kv)
    if pkg == "jax":
        import jax.numpy as jnp

        from fasttalk_tpu.engine.engine import TPUEngine
        from fasttalk_tpu.engine.tokenizer import load_tokenizer
        from fasttalk_tpu.models.configs import get_model_config
        from fasttalk_tpu.models.loader import load_params

        cfg = get_model_config("tinychat", ASSETS)
        return TPUEngine(cfg, load_params(cfg, os.path.join(ASSETS,
                                                            "tinychat"),
                                          jnp.float32),
                         load_tokenizer(ASSETS, "tinychat",
                                        template=cfg.chat_template),
                         dtype=jnp.float32, **common)
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params

    cfg = get_model_config("tinychat", ASSETS)
    return TorchEngine(cfg, load_params(cfg, os.path.join(ASSETS,
                                                          "tinychat"),
                                        torch.float32, "cpu"),
                       load_tokenizer(ASSETS, "tinychat",
                                      template=cfg.chat_template),
                       device="cpu", dtype=torch.float32, **common)


def _server_and_monitor(pkg: str, engine, **cfg):
    """``pkg``'s WebSocket server over ``engine`` and its monitoring app."""
    if pkg == "jax":
        from fasttalk_tpu.monitoring.monitor import build_monitoring_app
        from fasttalk_tpu.serving.server import WebSocketLLMServer
        from fasttalk_tpu.utils.config import Config

        os.environ.update(LLM_PROVIDER="tpu", ENABLE_PYDANTIC_AI="false")
    else:
        from fasttalk_tpu_torch.monitoring.monitor import \
            build_monitoring_app
        from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
        from fasttalk_tpu_torch.utils.config import Config
    config = Config(max_model_len=512, default_context_window=512,
                    default_max_tokens=8, **cfg)
    return (WebSocketLLMServer(config, engine),
            build_monitoring_app(ready_check=engine.check_connection,
                                 sched_info=engine.scheduler_debug))


async def _session(client, text: str, **cfg) -> list[dict]:
    """One WS session: start it, send ``text``, collect every frame up to
    the terminal one, end it."""
    ws = await client.ws_connect("/ws/llm")
    frames = [json.loads((await ws.receive(timeout=120)).data)]
    await ws.send_json({"type": "start_session", "config": cfg})
    frames.append(json.loads((await ws.receive(timeout=120)).data))
    await ws.send_json({"type": "user_message", "text": text})
    while True:
        frames.append(json.loads((await ws.receive(timeout=120)).data))
        if frames[-1]["type"] != "token":
            break
    await ws.send_json({"type": "end_session"})
    frames.append(json.loads((await ws.receive(timeout=120)).data))
    await ws.close()
    return frames


def _drive(pkg: str, tier: str) -> dict:
    """Serve ``pkg`` on ``tier`` and run the same greedy traffic: two
    concurrent sessions of 8 tokens, then one journey session. Returns the
    bodies of ``/stats``, ``/health``, ``/slo`` (serving port) and
    ``/perf`` (monitoring port), the ``# TYPE`` families of ``/metrics``,
    and the journey session's token stamps and waterfall."""
    os.environ["PROF_ENABLED"] = "false"
    engine = _chat_engine(pkg, **TIERS[tier])
    engine.start()
    seen_j: list[dict] = []
    gen = engine.generate

    async def spy(*a, **kw):
        async for ev in gen(*a, **kw):
            if ev["type"] == "token" and "j" in ev:
                seen_j.append(ev["j"])
            yield ev

    engine.generate = spy
    server, monitor = _server_and_monitor(pkg, engine)

    async def run():
        client = TestClient(TestServer(server.app))
        mon = TestClient(TestServer(monitor))
        await client.start_server()
        await mon.start_server()
        try:
            opts = {"max_tokens": 8, **GREEDY}
            await asyncio.gather(*(_session(client, p, **opts)
                                   for p in PROMPTS))
            journey = await _session(client, PROMPTS[0], journey=True,
                                     **opts)
            out = {"journey": journey[-2]["stats"].get("journey"),
                   "stamps": sorted({k for j in seen_j for k in j})}
            for name, c, path in (("stats", client, "/stats"),
                                  ("health", client, "/health"),
                                  ("slo", client, "/slo"),
                                  ("perf", mon, "/perf")):
                r = await c.get(path)
                out[name] = [r.status, await r.json()]
            r = await mon.get("/metrics")
            out["types"] = sorted(line[len("# TYPE "):]
                                  for line in (await r.text()).splitlines()
                                  if line.startswith("# TYPE "))
            return out
        finally:
            await mon.close()
            await client.close()

    try:
        return asyncio.run(asyncio.wait_for(run(), 600))
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def driven():
    """``_drive`` for both packages and both tiers: {(pkg, tier): result}.
    One child process at a time, one thread each, so the runs add little
    load to a parallel test session."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = {}
    for tier in TIERS:
        for pkg in ("jax", "torch"):
            r = subprocess.run(
                [sys.executable, "-m", "tests.test_torch_observability", pkg,
                 tier], cwd=REPO, env=env, capture_output=True, text=True,
                timeout=600)
            assert r.returncode == 0, (pkg, tier, r.stderr[-4000:])
            out[pkg, tier] = json.loads(r.stdout.strip().splitlines()[-1])
    return out


def _key_tree(obj):
    """The nested key structure of a JSON body: dicts by key, lists by
    their first element (an empty list has none), scalars as None."""
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_key_tree(obj[0])] if obj else []
    return None


def _same_keys(port, jax, path=""):
    """Assert equal key trees; a list empty on one side is not compared
    (the JAX ledger lists its warmup compiles, the eager port none)."""
    if isinstance(jax, dict):
        assert isinstance(port, dict), path
        assert set(port) == set(jax), (path, sorted(set(port) ^ set(jax)))
        for k in jax:
            _same_keys(port[k], jax[k], f"{path}.{k}")
    elif isinstance(jax, list) and jax and port:
        _same_keys(port[0], jax[0], path + "[0]")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_metrics_families_are_the_jax_packages(driven, tier):
    """Queue C 2: after the same traffic the port's registry renders the
    same ``# TYPE`` families as the JAX package's, ``perf_*`` included."""
    port = set(driven["torch", tier]["types"])
    jax = set(driven["jax", tier]["types"])
    assert port == jax, {"port only": sorted(port - jax),
                         "jax only": sorted(jax - port)}
    for family in ("engine_decode_wait_ms histogram",
                   "engine_active_slots gauge", "engine_queue_depth gauge",
                   "inter_token_ms histogram",
                   "ws_tokens_streamed_total counter",
                   "ws_connections_total counter",
                   "perf_device_busy_frac gauge"):
        assert family in port, family


@pytest.mark.parametrize("route", ["stats", "health", "slo", "perf"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_route_bodies_have_the_jax_packages_keys(driven, tier, route):
    """Queue C 3 and the new routes: the bodies' key sets equal the JAX
    package's after the same traffic; the engine block of ``/stats``
    holds every key of the JAX engine's (``kv_quant`` and ``kv_layout``
    among them) and the port's own counters beside them."""
    (p_status, port), (j_status, jax) = (driven["torch", tier][route],
                                         driven["jax", tier][route])
    assert p_status == j_status == 200
    if route == "stats":
        assert set(port["engine"]) >= set(jax["engine"])
        assert port["engine"]["kv_layout"] == jax["engine"]["kv_layout"]
        port, jax = ({k: v for k, v in body.items() if k != "engine"}
                     for body in (port, jax))
    _same_keys(port, jax)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_perf_programs_fsum_to_the_busy_total(driven, tier):
    """``device_busy_s`` is the ``math.fsum`` of the per-program busy
    seconds, bit for bit, and the served program kinds each took time."""
    perf = driven["torch", tier]["perf"][1]
    progs = perf["programs"]["by_program"]
    total = perf["programs"]["total_busy_s"]
    assert math.fsum(p["busy_s"] for p in progs) == total
    assert round(total, 4) == perf["wall"]["device_busy_s"]
    assert perf["wall"]["device_busy_s"] <= perf["wall"]["window_s"]
    kinds = {p["program"].split(" ")[0]: p["busy_s"] for p in progs}
    assert kinds.get("decode", 0) > 0
    assert kinds.get("batched_prefill", 0) + kinds.get("prefill", 0) > 0
    # No peak is known for the CPU: null, never a made-up figure.
    assert perf["mfu"]["mfu"] is None and perf["hbm"]["bw_util"] is None
    assert perf["tokens"]["decode_tokens"] > 0


def test_journey_stamps_have_the_same_names(driven):
    port, jax = driven["torch", "dense"], driven["jax", "dense"]
    assert port["stamps"] == jax["stamps"] == ["e", "f", "w"]
    _same_keys(port["journey"], jax["journey"])
    assert port["journey"]["frames"] >= 1


def test_jax_trace_report_reads_a_dump_of_the_port(tmp_path):
    """The port's engine and server record the JAX package's span and step
    names, so ``scripts/trace_report.py`` reads a dump of the port's
    tracer: its phase table, ``--perf`` and ``--journey`` (whose hop sums
    reconcile with the wall clock)."""
    from fasttalk_tpu_torch.observability.export import jsonl_dump
    from fasttalk_tpu_torch.observability.trace import get_tracer

    engine = _chat_engine("torch")
    engine.start()
    server, _ = _server_and_monitor("torch", engine)

    async def run():
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            # Three decode calls of 8 steps: a call's decode_step spans are
            # recorded after its tokens, so the call that ends a request
            # may record them after the server has finished the trace (as
            # in the JAX engine); the earlier calls' always land.
            await _session(client, PROMPTS[0], journey=True, max_tokens=24,
                           ignore_eos=True, **GREEDY)
        finally:
            await client.close()

    try:
        asyncio.run(asyncio.wait_for(run(), 120))
    finally:
        engine.shutdown()
    tracer = get_tracer()
    dump = tmp_path / "dump.jsonl"
    dump.write_text(jsonl_dump(tracer, tracer.completed(), tracer.steps()))
    script = os.path.join(REPO, "scripts", "trace_report.py")
    for flags in ([], ["--perf"], ["--journey"]):
        r = subprocess.run([sys.executable, script, str(dump), *flags],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, (flags, r.stdout, r.stderr)
        if not flags:
            for phase in ("queue_wait", "prefill", "decode_step", "decode",
                          "detokenize", "ws_send"):
                assert phase in r.stdout, phase
    assert "all journeys reconcile" in r.stdout


# ---------------------------------------------------------------------
# Program keys, the watchdog, the SLO gate
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kv", [{}, {"kv_layout": "paged"},
                                {"kv_layout": "paged", "kv_quant": "int8"}])
def test_program_keys_are_the_jax_packages(kv):
    """The perf ledger's program keys name the same call identically: the
    key function, and the engines' decode and prefill keys per tier."""
    from fasttalk_tpu.observability.perf import program_key as jax_key
    from fasttalk_tpu_torch.observability.perf import program_key

    attrs = {"kv_len": 512, "steps": 8, "kv_quant": "int8", "group": 16}
    assert program_key("decode", **attrs) == jax_key("decode", **attrs)
    jeng, teng = _engine("jax", **kv), _engine("torch", **kv)
    for st_on in (False, True):
        assert teng._decode_program(512, 8, st_on) == \
            jeng._decode_program(512, 8, st_on)
    for start, bucket in ((0, 64), (200, 32)):
        assert teng._prefill_program(start, bucket) == \
            jeng._prefill_program(start, bucket)
    assert teng._kvq_attrs == jeng._kvq_attrs


class _StalledFake:
    """Makes the JAX package's FakeEngine stream end as a watchdog
    termination does: one token, then the ``stalled`` terminal error."""

    @staticmethod
    def make():
        from fasttalk_tpu.engine.fake import FakeEngine

        class Fake(FakeEngine):
            async def generate(self, request_id, session_id, messages,
                               params):
                yield {"type": "token", "text": "hi"}
                yield {"type": "error", "code": "stalled",
                       "error": "no forward progress for 61s; terminated "
                                "by the stall watchdog"}
        return Fake()


def test_watchdog_force_fails_a_stalled_request_with_the_jax_frame(
        monkeypatch):
    """A request that stops making progress is ended by the port's
    watchdog through ``force_fail``: the client gets the JAX server's
    ``stalled`` frame, the SLO counts an error, and the slot frees."""
    from fasttalk_tpu.serving.server import WebSocketLLMServer as JaxServer
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.observability.slo import get_slo
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("LLM_PROVIDER", "fake")
    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    fake = _StalledFake.make()
    fake.start()
    jax_server = JaxServer(JaxConfig(), fake)
    engine = _chat_engine("torch")
    consume = engine._consume_token

    def slow(req, tok):  # a token every 50 ms: the request stays running
        time.sleep(0.05)
        consume(req, tok)

    engine._consume_token = slow
    engine.start()
    server = WebSocketLLMServer(Config(max_model_len=512,
                                       default_context_window=512), engine)

    async def stalled_frame(srv, drill):
        client = TestClient(TestServer(srv.app))
        await client.start_server()
        try:
            ws = await client.ws_connect("/ws/llm")
            await ws.receive(timeout=60)
            await ws.send_json({"type": "start_session", "config": {
                "max_tokens": 200, "ignore_eos": True}})
            await ws.receive(timeout=60)
            await ws.send_json({"type": "user_message", "text": "hello"})
            while True:
                m = json.loads((await ws.receive(timeout=60)).data)
                if m["type"] == "token" and drill is not None:
                    drill()
                    drill = None
                if m["type"] != "token":
                    return m
        finally:
            await client.close()

    def drill():
        # The watchdog's pass with its clock 100 s ahead: past the cancel
        # threshold (60 s by default) for the running request.
        status = server.watchdog.check(now=time.monotonic() + 100.0)
        # Terminated at once: it is not left listed as stalled.
        assert status["token_stalled"] == []

    try:
        jax_frame = asyncio.run(stalled_frame(jax_server, None))
        frame = asyncio.run(stalled_frame(server, drill))
        deadline = time.monotonic() + 30
        while engine.pending_requests() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.pending_requests() == 0
    finally:
        engine.shutdown()
    assert frame["type"] == jax_frame["type"] == "error"
    assert set(frame["error"]) == set(jax_frame["error"])
    assert {k: v for k, v in frame["error"].items() if k != "message"} == \
        {k: v for k, v in jax_frame["error"].items() if k != "message"} == \
        {"code": "stalled", "severity": "high", "recoverable": True}
    assert "terminated by the stall watchdog" in frame["error"]["message"]
    totals = get_slo().snapshot()["classes"]["interactive"]["totals"]
    assert totals["errors"] == 1


def test_an_slo_page_sheds_bulk_in_both():
    """With the interactive class page-burning, both engines shed a bulk
    submission at admission (reason ``slo_burn``) and admit interactive."""
    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.observability.slo import get_slo as jax_slo
    from fasttalk_tpu.utils.errors import AdmissionRejected as JaxRejected
    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.observability.slo import get_slo
    from fasttalk_tpu_torch.utils.errors import AdmissionRejected

    async def first_event(engine, params_cls, priority):
        stream = engine.generate("r-" + priority, "s-" + priority,
                                 [{"role": "user", "content": "hi"}],
                                 params_cls(max_tokens=1, priority=priority))
        try:
            return (await stream.__anext__())["type"]
        finally:
            await stream.aclose()

    out = {}
    for pkg, slo, params_cls, rejected in (
            ("jax", jax_slo(), JaxParams, JaxRejected),
            ("torch", get_slo(), GenerationParams, AdmissionRejected)):
        for _ in range(40):
            slo.record_request("interactive", ok=False, ttft_ms=None,
                               queue_wait_ms=None, max_gap_ms=None)
        assert slo.alert_summary()["interactive"] == "page"
        engine = _engine(pkg)
        engine.start()
        try:
            with pytest.raises(rejected) as shed:
                asyncio.run(first_event(engine, params_cls, "bulk"))
            kind = asyncio.run(first_event(engine, params_cls,
                                           "interactive"))
        finally:
            engine.shutdown()
        out[pkg] = (shed.value.to_dict()["details"]["reason"], kind)
    assert out["torch"] == out["jax"] == ("slo_burn", "token")


# ---------------------------------------------------------------------
# Queue C 1 and 3 through both servers
# ---------------------------------------------------------------------

def _fake_jax_server(monkeypatch, **cfg):
    from fasttalk_tpu.engine.fake import FakeEngine
    from fasttalk_tpu.serving.server import WebSocketLLMServer
    from fasttalk_tpu.utils.config import Config

    monkeypatch.setenv("LLM_PROVIDER", "fake")
    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    for k, v in cfg.items():
        monkeypatch.setenv(k, str(v))
    engine = FakeEngine()
    engine.start()
    return WebSocketLLMServer(Config(), engine), engine


@pytest.fixture(scope="module")
def tiny():
    eng = _engine("torch")
    eng.start()
    yield eng
    eng.shutdown()


def _port_server(monkeypatch, engine, **cfg):
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in cfg.items():
        monkeypatch.setenv(k, str(v))
    return WebSocketLLMServer(Config(max_model_len=256,
                                     default_context_window=256), engine)


def test_idle_sessions_are_closed_by_housekeeping_in_both(monkeypatch,
                                                          tiny):
    """Queue C 1: a session idle past ``SESSION_TIMEOUT`` loses its
    conversation and its connection at the next housekeeping pass, in
    both servers. The JAX pass runs under a zero-length sleep; the port's
    is ``housekeep_once`` (its period is a constructor argument)."""
    jax_server, _ = _fake_jax_server(monkeypatch, SESSION_TIMEOUT=5)
    port_server = _port_server(monkeypatch, tiny, SESSION_TIMEOUT=5)

    async def one_pass(server, recv):
        """Run one housekeeping pass while the client reads its close."""
        if hasattr(server, "housekeep_once"):
            await server.housekeep_once()
            return await recv
        import fasttalk_tpu.serving.server as jax_mod

        real_sleep = asyncio.sleep
        calls = []

        async def sleep_once(s):  # the first period elapses at once
            calls.append(s)
            await real_sleep(0 if len(calls) == 1 else 3600)

        proxy = types.ModuleType("asyncio")
        proxy.__dict__.update(asyncio.__dict__)
        proxy.sleep = sleep_once
        monkeypatch.setattr(jax_mod, "asyncio", proxy)
        task = asyncio.get_running_loop().create_task(server._housekeep())
        try:
            return await recv
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            monkeypatch.setattr(jax_mod, "asyncio", asyncio)

    async def drive(server):
        conns = getattr(server, "connection_manager", None) \
            or server.connections
        convs = getattr(server, "conversation_manager", None) \
            or server.conversations
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            ws = await client.ws_connect("/ws/llm")
            sid = json.loads((await ws.receive(timeout=30)).data)[
                "session_id"]
            await ws.send_json({"type": "start_session", "config": {}})
            await ws.receive(timeout=30)
            before = (conns.get_active_count(), convs.get_session_count())
            conns.get_connection(sid).last_activity -= 60
            convs.get(sid).last_activity -= 60
            recv = asyncio.ensure_future(ws.receive(timeout=30))
            closed = (await one_pass(server, recv)).type
            return before, closed, convs.get_session_count()
        finally:
            await client.close()

    from aiohttp import WSMsgType

    jax_res = asyncio.run(drive(jax_server))
    port_res = asyncio.run(drive(port_server))
    assert port_res == jax_res == ((1, 1), WSMsgType.CLOSE, 0)


def test_a_dead_engine_reads_degraded_in_both(monkeypatch):
    """Queue C 3: ``/health`` of a server whose engine is not running is
    503 with status ``degraded`` (the port said ``unhealthy``) and the
    same keys, ``agent_enabled`` among them (both engines built, neither
    started)."""
    from fasttalk_tpu.serving.server import WebSocketLLMServer as JaxServer
    from fasttalk_tpu.utils.config import Config as JaxConfig

    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    jax_server = JaxServer(JaxConfig(), _engine("jax"))
    port_server = _port_server(monkeypatch, _engine("torch"))

    async def health(server):
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            r = await client.get("/health")
            return r.status, await r.json()
        finally:
            await client.close()

    (js, jb), (ps, pb) = (asyncio.run(health(s))
                          for s in (jax_server, port_server))
    assert ps == js == 503
    assert pb["status"] == jb["status"] == "degraded"
    assert set(pb) == set(jb) and pb["agent_enabled"] is False


def test_max_connections_refusal_carries_the_retry_hint(monkeypatch, tiny):
    """Queue C 3: at ``LLM_MAX_CONNECTIONS`` both servers refuse with the
    connection manager's ``retry_after_hint`` (2 s with every connection
    idle), not a constant, and close with 1013."""
    jax_server, _ = _fake_jax_server(monkeypatch, LLM_MAX_CONNECTIONS=1)
    port_server = _port_server(monkeypatch, tiny, LLM_MAX_CONNECTIONS=1)

    async def refused(server):
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            first = await client.ws_connect("/ws/llm")
            await first.receive(timeout=30)
            second = await client.ws_connect("/ws/llm")
            frame = json.loads((await second.receive(timeout=30)).data)
            close = await second.receive(timeout=30)
            return frame, close.data
        finally:
            await client.close()

    (jf, jc), (pf, pc) = (asyncio.run(refused(s))
                          for s in (jax_server, port_server))
    assert pf == jf
    assert pf["error"]["code"] == "max_connections"
    assert pf["error"]["retry_after"] == 2.0
    assert pc == jc == 1013


# ---------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------

OBS_FIELDS = (
    "monitoring_port", "monitoring_host", "slo_ttft_p95_ms",
    "slo_inter_token_p99_ms", "slo_queue_wait_p95_ms", "slo_error_rate",
    "slo_page_burn", "slo_warn_burn", "slo_shed_bulk_on_page",
    "watchdog_token_stall_s", "watchdog_step_stall_s",
    "watchdog_cancel_stall_s", "watchdog_interval_s",
    "watchdog_loop_lag_ms", "metrics_window_s", "perf_window_s",
    "perf_idle_gap_ms", "perf_peak_tflops", "perf_peak_hbm_gbps",
    "prof_enabled", "prof_hz", "prof_max_stacks", "flight_enabled",
    "flight_max_bundles", "flight_min_interval_s", "flight_autoprof_s",
    "flight_recompile_burst", "flight_recompile_window_s",
    "flight_events_tail", "journey_enabled", "journey_tol")


def test_observability_settings_have_the_jax_defaults(monkeypatch):
    """With no environment, every observability setting has the JAX
    Config's value (``FLIGHT_DIR`` is the port's own; see below)."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.delenv("PROF_ENABLED")
    port, ref = Config(), JaxConfig(llm_provider="tpu")
    assert {f: getattr(port, f) for f in OBS_FIELDS} == \
        {f: getattr(ref, f) for f in OBS_FIELDS}


@pytest.mark.parametrize("env,message", [
    ({"SLO_PAGE_BURN": "0"}, "slo_page_burn must be > 0"),
    ({"SLO_ERROR_RATE": "1.5"}, "slo_error_rate must be in (0, 1]"),
    ({"WATCHDOG_TOKEN_STALL_S": "40", "WATCHDOG_CANCEL_STALL_S": "20"},
     "watchdog_cancel_stall_s must be >= watchdog_token_stall_s"),
    ({"PERF_PEAK_TFLOPS": "-1"}, "perf_peak_tflops must be >= 0"),
    ({"PROF_HZ": "5000"}, "prof_hz must be in (0, 1000]"),
    ({"FLIGHT_MAX_BUNDLES": "0"}, "flight_max_bundles must be >= 1"),
    ({"FLIGHT_RECOMPILE_BURST": "1"}, "flight_recompile_burst must be >= 2"),
    ({"JOURNEY_TOL": "1.5"}, "journey_tol must be in (0, 1)"),
    ({"LLM_PORT": "9000", "LLM_MONITORING_PORT": "9000"},
     "port and monitoring_port must differ"),
])
def test_bad_observability_settings_fail_as_in_jax(monkeypatch, env,
                                                   message):
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cls, kw in ((Config, {}), (JaxConfig, {"llm_provider": "tpu"})):
        with pytest.raises(ValueError, match=re.escape(message)):
            cls(**kw)


# ---------------------------------------------------------------------
# The port's own: directories, bundles, threads
# ---------------------------------------------------------------------

def test_flight_and_trace_directories_are_the_ports_own(monkeypatch):
    """Unset, ``FLIGHT_DIR`` and ``PROFILER_TRACE_DIR`` default to the
    port's own directories, never the JAX package's."""
    from fasttalk_tpu.observability.flight import DEFAULT_DIR as JAX_FLIGHT
    from fasttalk_tpu_torch.monitoring import monitor
    from fasttalk_tpu_torch.observability.flight import FlightRecorder
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.delenv("FLIGHT_DIR")
    monkeypatch.delenv("PROFILER_TRACE_DIR")
    assert FlightRecorder().base_dir == Config().flight_dir \
        == "/tmp/fasttalk-tpu-torch-flight" != JAX_FLIGHT
    assert monitor.DEFAULT_TRACE_DIR == "/tmp/fasttalk-tpu-torch-trace"
    src = open(os.path.join(REPO, "fasttalk_tpu", "monitoring",
                            "monitor.py")).read()
    assert '"/tmp/fasttalk-tpu-trace"' in src


def test_bundle_and_profiler_trace_land_under_the_set_directories(
        monkeypatch, tmp_path, tiny):
    """``POST /debug/bundle`` writes a bundle under ``FLIGHT_DIR`` with a
    ``cuda_trace/`` Chrome trace (``FLIGHT_AUTOPROF_S`` > 0), and
    ``/profiler/start`` + ``/profiler/stop`` a Chrome trace under
    ``PROFILER_TRACE_DIR``; a path outside it is refused."""
    from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app
    from fasttalk_tpu_torch.observability.flight import get_flight

    monkeypatch.setenv("FLIGHT_AUTOPROF_S", "0.2")
    server = _port_server(monkeypatch, tiny)
    monitor = build_monitoring_app(ready_check=tiny.check_connection,
                                   sched_info=tiny.scheduler_debug)

    async def run():
        client = TestClient(TestServer(server.app))
        mon = TestClient(TestServer(monitor))
        await client.start_server()
        await mon.start_server()
        try:
            assert (await mon.post("/profiler/start",
                                   json={"log_dir": "/etc"})).status == 400
            r = await mon.post("/profiler/start", json={"log_dir": "p12"})
            assert r.status == 200
            await _session(client, "hi", max_tokens=4, **GREEDY)
            stop = await (await mon.post("/profiler/stop")).json()
            bundle = await (await mon.post("/debug/bundle")).json()
            return stop, bundle
        finally:
            await mon.close()
            await client.close()

    stop, bundle = asyncio.run(run())
    assert stop["trace"] == str(tmp_path / "trace" / "p12" / "trace.json")
    assert "traceEvents" in json.load(open(stop["trace"]))
    assert bundle["dir"].startswith(str(tmp_path / "flight"))
    flight = get_flight()
    deadline = time.monotonic() + 60
    while flight.bundles_written < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    manifest = json.load(open(os.path.join(bundle["dir"], "manifest.json")))
    assert "errors" not in manifest, manifest
    trace = os.path.join(bundle["dir"], "cuda_trace", "trace.json")
    assert "traceEvents" in json.load(open(trace))


def test_no_port_thread_outlives_a_servers_cleanup(monkeypatch, tiny):
    """With the host profiler on, the server's sampler thread and the
    monitoring app's profiler worker run while serving and are gone after
    the apps' cleanup: the process's threads are those from before."""
    from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app

    monkeypatch.setenv("PROF_ENABLED", "true")
    before = set(threading.enumerate())
    server = _port_server(monkeypatch, tiny)
    monitor = build_monitoring_app()

    async def run():
        client = TestClient(TestServer(server.app))
        mon = TestClient(TestServer(monitor))
        await client.start_server()
        await mon.start_server()
        try:
            await (await mon.post("/profiler/start")).json()
            await _session(client, "hi", max_tokens=4, **GREEDY)
            await (await mon.post("/profiler/stop")).json()
            return {t.name for t in threading.enumerate()}
        finally:
            await mon.close()
            await client.close()

    during = asyncio.run(run())
    assert "prof-sampler" in during
    assert any(n.startswith("monitor-profiler") for n in during)
    after = set(threading.enumerate())
    assert {t for t in after - before if t.is_alive()} == set(), \
        [t.name for t in after - before]


if __name__ == "__main__":
    print(json.dumps(_drive(sys.argv[1], sys.argv[2])))
