"""The port's multi-rank SPMD serving held against the JAX package.

Across processes (tests/_torch_ranks.py, two gloo ranks each, tinychat in
float32): a leader publishes every device call and a follower,
``python -m fasttalk_tpu_torch websocket`` with ``TPU_SPMD_ROLE=follower``,
replays them on its shards. The leader's greedy replies must equal the
JAX package's single-process ones, token for token (the trained
checkpoint; in the pattern of tests/test_spmd_serving.py):

- tp = 2 through the port's launcher and the WebSocket protocol, against
  the JAX launcher's replies to the same turns;
- sp = 2 with a fresh prompt of more than one rank's KV shard, which
  prefills through ring attention, and decodes over the sharded cache;
- dp = 2 with sessions on both ranks' slots.

In process: the five ``TestSpmdChaos`` drills of tests/test_chaos.py
against the port's ``CallBroadcaster`` and ``_recv`` with raw sockets; a
dead follower ends every in-flight request of a leader engine with one
error frame and brings the launcher's gateway down; the follower replay
runs the engine's device call of each kind; and every mesh refusal of
the Config and the engine carries the JAX message.
"""

import asyncio
import json
import os
import shutil
import socket
import sys
import threading
import time

import pytest
import torch

from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.resilience import failpoints as fp
from tests._port_isolation import port_isolation  # noqa: F401
from tests._torch_ranks import (ASSETS, GREEDY, free_ports, spawn,
                                ws_turns)

BASE_ENV = {
    "LLM_PROVIDER": "tpu", "LLM_MODEL": "tinychat", "WEIGHT_QUANT": "off",
    "TPU_DTYPE": "float32", "TPU_DECODE_SLOTS": "4",
    "TPU_MAX_MODEL_LEN": "512", "DEFAULT_CONTEXT_WINDOW": "512",
    "TPU_DECODE_STEPS": "8", "TPU_SPEC_DECODE": "off", "TPU_WARMUP": "off",
    "ENABLE_PYDANTIC_AI": "false", "TPU_SHARED_PREFIX": "false",
    "KV_HOST_BUDGET_MB": "0", "PROF_ENABLED": "false",
    "LLM_HOST": "127.0.0.1", "LLM_MONITORING_HOST": "127.0.0.1",
}
# About 320 tinychat tokens: past one rank's KV shard at sp = 2 (256 of
# TPU_MAX_MODEL_LEN=512), so the fresh prompt takes ring prefill.
LONG = "tell me a long story about a cat and a dog in a garden. " * 12


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """A copy of the tinychat checkpoint: the ranks' prepared-weight
    caches land beside it, not in the repository."""
    root = tmp_path_factory.mktemp("assets")
    shutil.copytree(os.path.join(ASSETS, "tinychat"), root / "tinychat")
    return str(root)


def _cluster(tmp_path, model_path, mesh: dict, via: str, work) -> dict:
    """Run a leader (rank 0, ``SERVE_VIA=via``) and a follower (rank 1,
    the port's CLI) over ``mesh``; returns the leader's result and the
    follower's count of replayed calls."""
    spmd, ws, mon = free_ports(3)
    out = str(tmp_path)
    with open(os.path.join(out, "work.json"), "w", encoding="utf-8") as f:
        json.dump(work, f)
    env = {**BASE_ENV, "MODEL_PATH": model_path,
           "TPU_SPMD_ADDR": f"127.0.0.1:{spmd}", "TPU_SPMD_FOLLOWERS": "1",
           "LLM_PORT": str(ws), "LLM_MONITORING_PORT": str(mon),
           "FLIGHT_DIR": os.path.join(out, "flight"), "SERVE_VIA": via,
           **{f"TPU_{k.upper()}_SIZE": str(v) for k, v in mesh.items()}}
    logs = spawn(
        "serve", 2, out, timeout=150, env=env,
        rank_env=lambda r: {"TPU_SPMD_ROLE": "leader" if r == 0
                            else "follower"},
        argv=lambda r: None if r == 0 else [
            sys.executable, "-m", "fasttalk_tpu_torch", "websocket",
            "--device", "cpu"])
    with open(os.path.join(out, "leader.json"), encoding="utf-8") as f:
        result = json.load(f)
    marker = "spmd follower replayed "
    line = next(ln for ln in logs[1].splitlines() if marker in ln)
    result["replayed"] = int(line.split(marker)[1].split()[0])
    return result


def _jax_engine_replies(work) -> list[str]:
    """The JAX engine's greedy replies, one session at a time, on one
    process without a mesh (float32, the cluster's settings)."""
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
        async def one(i, msgs):
            text = ""
            async for ev in eng.generate(
                    f"j{i}", f"js{i}", msgs,
                    GenerationParams(max_tokens=24, **GREEDY)):
                if ev["type"] == "token":
                    text += ev["text"]
                elif ev["type"] == "error":
                    raise RuntimeError(ev)
            return text

        async def run():
            return [await one(i, m) for i, m in enumerate(work)]
        return asyncio.run(run())
    finally:
        eng.shutdown()


def test_tp2_launcher_leader_and_cli_follower_serve_jax_replies(
        tmp_path, model_path, monkeypatch):
    from aiohttp.test_utils import TestClient, TestServer

    from fasttalk_tpu.serving.launcher import ServerLauncher as JaxLauncher
    from fasttalk_tpu.utils.config import Config as JaxConfig

    turns = [["hello", "what did i just say?"], ["tell me about dogs."]]
    got = _cluster(tmp_path, model_path, {"tp": 2}, "launcher", turns)
    ws, mon = free_ports(2)
    for k, v in {**BASE_ENV, "MODEL_PATH": model_path,
                 "LLM_PORT": str(ws), "LLM_MONITORING_PORT": str(mon),
                 "FLIGHT_DIR": str(tmp_path / "jflight")}.items():
        monkeypatch.setenv(k, v)
    launcher = JaxLauncher(JaxConfig())

    async def jax_side():
        launcher.verify_backend()
        client = TestClient(TestServer(launcher.server.app))
        await client.start_server()
        try:
            return await ws_turns(lambda: client.ws_connect("/ws/llm"),
                                  turns, GREEDY)
        finally:
            await client.close()
            launcher.engine.shutdown()

    want = asyncio.run(asyncio.wait_for(jax_side(), 120))
    assert got["replies"] == want
    assert all(r for session in want for r in session)
    assert got["decode_calls"] > 0
    # Each reply: patches, a prefill and decode calls, all replayed.
    assert got["replayed"] >= 3 * got["decode_calls"] // 2


@pytest.mark.parametrize("mesh,work", [
    ({"sp": 2}, [[{"role": "user", "content": LONG}],
                 [{"role": "user", "content": "hello"}]]),
    ({"dp": 2}, [[{"role": "user", "content": "hello"}],
                 [{"role": "user", "content": "what is your name?"}],
                 [{"role": "user", "content": "tell me about cats."}]]),
], ids=["sp2", "dp2"])
def test_engine_leader_and_follower_give_jax_greedy_replies(
        tmp_path, model_path, mesh, work):
    got = _cluster(tmp_path, model_path, mesh, "engine", work)
    want = _jax_engine_replies(work)
    assert got["replies"] == want
    assert got["mesh"] == {"dp": 1, "sp": 1, "tp": 1, **mesh}
    if "sp" in mesh:
        # The long fresh prompt prefilled through ring attention.
        assert got["ring_prefill_calls"] == 1
    assert got["replayed"] > got["decode_calls"] > 0


# ------------------------------------------------------------ in process


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _leader_with_follower(hb_interval_s=0.05):
    """CallBroadcaster + a raw-socket follower the test controls."""
    from fasttalk_tpu_torch.parallel.spmd_serving import CallBroadcaster

    (port,) = free_ports(1)
    box = {}

    def connect():
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                box["sock"] = socket.create_connection(("127.0.0.1", port),
                                                       timeout=1)
                return
            except OSError:
                time.sleep(0.02)

    t = threading.Thread(target=connect, daemon=True)
    t.start()
    sink = CallBroadcaster("127.0.0.1", port, n_followers=1,
                           hb_interval_s=hb_interval_s)
    t.join(timeout=10)
    assert "sock" in box
    return sink, box["sock"]


class TestSpmdChaos:
    """tests/test_chaos.py ``TestSpmdChaos`` against the port."""

    def test_follower_death_is_fatal_within_deadline(self):
        sink, follower = _leader_with_follower(hb_interval_s=0.05)
        try:
            sink("decode", {"kv_len": 512, "steps": 8})
            follower.close()  # the follower dies mid-decode
            t0 = time.monotonic()
            assert _wait(lambda: sink.dead_reason is not None, 5.0), \
                "leader never detected the dead follower"
            assert time.monotonic() - t0 < 5.0
            with pytest.raises(RuntimeError, match="cluster is dead"):
                sink("decode", {"kv_len": 512, "steps": 8})
            kinds = [e["kind"] for e in get_events().recent(50)]
            assert "spmd_cluster_dead" in kinds
        finally:
            sink.close()

    def test_send_failpoint_aborts_surviving_followers(self):
        from fasttalk_tpu_torch.parallel.spmd_serving import _recv

        sink, follower = _leader_with_follower(hb_interval_s=0.0)
        try:
            kind, hello = _recv(follower, deadline_s=5.0)
            assert kind == "hello" and hello["hb_interval_s"] == 0.0
            fp.activate("spmd.send=error;count=1")
            sink("patch", {"packed": None})
            assert _wait(lambda: sink.dead_reason is not None, 5.0)
            kind, payload = _recv(follower, deadline_s=5.0)
            assert kind == "abort"
            assert "fault injected" in payload["reason"]
        finally:
            fp.clear()
            sink.close()
            follower.close()

    def test_heartbeats_flow_while_engine_idle(self):
        from fasttalk_tpu_torch.parallel.spmd_serving import _recv

        sink, follower = _leader_with_follower(hb_interval_s=0.05)
        try:
            kind, hello = _recv(follower, deadline_s=5.0)
            assert kind == "hello"
            assert hello["hb_interval_s"] == pytest.approx(0.05)
            kind, _ = _recv(follower, deadline_s=5.0)
            assert kind == "hb"
        finally:
            sink.close()
            follower.close()

    def test_follower_recv_deadline_detects_silent_leader(self):
        from fasttalk_tpu_torch.parallel.spmd_serving import _recv

        a, b = socket.socketpair()
        try:
            t0 = time.monotonic()
            with pytest.raises(ConnectionError, match="heartbeat deadline"):
                _recv(a, deadline_s=0.3)
            assert time.monotonic() - t0 < 2.0
        finally:
            a.close()
            b.close()

    def test_recv_failpoint_injects_peer_failure(self):
        from fasttalk_tpu_torch.parallel.spmd_serving import _recv

        a, b = socket.socketpair()
        try:
            fp.activate("spmd.recv=error;count=1")
            with pytest.raises(ConnectionError):
                _recv(a, deadline_s=1.0)
        finally:
            fp.clear()
            a.close()
            b.close()


def _tiny_engine(**kw):
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.llama import init_params

    cfg = get_model_config("test-tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    return TorchEngine(cfg, params, ByteTokenizer(), device="cpu",
                       num_slots=4, max_len=512, dtype=torch.float32,
                       steps_per_call=4, spec_decode="off", **kw)


def test_dead_follower_ends_each_inflight_request_with_one_error():
    """A leader whose follower dies mid-decode: the next publish raises,
    the engine thread ends every in-flight request with exactly one error
    frame, and the engine reports itself down."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    eng = _tiny_engine()
    sink, follower = _leader_with_follower(hb_interval_s=0.05)
    eng.call_sink = sink
    eng.start()
    try:
        async def stream(i):
            frames = []
            async for ev in eng.generate(
                    f"r{i}", f"s{i}", [{"role": "user", "content": "hi"}],
                    GenerationParams(max_tokens=400, ignore_eos=True,
                                     **GREEDY)):
                frames.append(ev["type"])
                if len(frames) == 2 and i == 0:
                    follower.close()
            return frames

        async def run():
            return await asyncio.gather(*(stream(i) for i in range(2)))

        frames = asyncio.run(asyncio.wait_for(run(), 60))
        for fr in frames:
            assert fr[-1] == "error" and fr.count("error") == 1, fr
            assert "done" not in fr
        assert sink.dead_reason is not None
        assert _wait(lambda: not eng.check_connection(), 10)
        assert eng.restart() is False   # a cluster restart, not in place
    finally:
        eng.shutdown()
        sink.close()


def test_launcher_shuts_the_gateway_down_on_a_dead_cluster(monkeypatch):
    from fasttalk_tpu_torch.engine.fake import FakeEngine
    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    engine = FakeEngine()
    engine.start()
    launcher = ServerLauncher(Config(), engine=engine, device="cpu")

    class Sink:
        dead_reason = None

    launcher._spmd_sink = Sink()

    async def run():
        task = asyncio.ensure_future(launcher._watchdog(0.02))
        await asyncio.sleep(0.1)
        assert not launcher._stop.is_set()
        Sink.dead_reason = "follower send failed: reset"
        await asyncio.wait_for(task, 5)
        return launcher._stop.is_set()

    assert asyncio.run(run())


def test_follower_replays_each_call_kind_on_its_engine():
    """``follower_loop`` runs the engine's ``_dc_<kind>`` with the
    leader's arguments for every published kind, skips the hello and the
    heartbeats, and returns the count at the stop frame; an unknown kind
    is an error."""
    from fasttalk_tpu_torch.parallel.spmd_serving import (CALL_KINDS, _send,
                                                          follower_loop)

    seen = []

    class Engine:
        def __getattr__(self, name):
            assert name.startswith("_dc_")
            return lambda **p: seen.append((name[4:], p))

    (port,) = free_ports(1)
    srv = socket.create_server(("127.0.0.1", port))
    result = {}

    def follow():
        try:
            result["n"] = follower_loop(Engine(), "127.0.0.1", port,
                                        connect_timeout_s=10)
        except Exception as e:  # surfaced below
            result["error"] = e

    t = threading.Thread(target=follow, daemon=True)
    t.start()
    conn, _ = srv.accept()
    _send(conn, ("hello", {"hb_interval_s": 0.0}))
    kinds = sorted(CALL_KINDS)
    for i, kind in enumerate(kinds):
        _send(conn, ("hb", {}))
        _send(conn, (kind, {"i": i}))
    _send(conn, ("stop", {}))
    t.join(10)
    conn.close()
    srv.close()
    assert result == {"n": len(kinds)}
    assert seen == [(k, {"i": i}) for i, k in enumerate(kinds)]
    assert kinds == sorted(["decode", "spec", "batched_prefill", "prefill",
                            "ring_prefill", "sample_place", "prefix_copy",
                            "patch", "hist_patch"])


MESH = {"TPU_TP_SIZE": "2", "TPU_COORDINATOR_ADDR": "127.0.0.1:1",
        "TPU_NUM_PROCESSES": "2", "TPU_SPMD_ROLE": "leader"}


@pytest.mark.parametrize("env", [
    {"WEIGHT_QUANT": "int4"},
    {"KV_QUANT": "int8", "TPU_SPEC_DECODE": "off"},
    {"KV_LAYOUT": "paged"},
    {"STRUCTURED_MODE": "on"},
    {"TPU_SPMD_ROLE": "follower", "WEIGHT_QUANT": "int4"},
    {"ROUTER_ENABLED": "true"},
    {"TPU_SPMD_ROLE": "follower", "KV_LAYOUT": "paged"},
    {"SPMD_HB_INTERVAL_S": "0"},
    {"SPMD_HB_TIMEOUT_S": "1", "SPMD_HB_INTERVAL_S": "2"},
    {"TPU_SPMD_ROLE": "boss"},
    {"TPU_SPMD_ROLE": "leader", "TPU_SPMD_ADDR": "nowhere"},
], ids=["int4", "int8kv", "paged", "structured", "spmd-int4",
        "spmd-router", "spmd-paged", "hb-off", "hb-short", "role",
        "addr"])
def test_config_refuses_mesh_incompatibilities_with_jax_messages(
        monkeypatch, env):
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in {**MESH, **env}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as want:
        JaxConfig()
    with pytest.raises(ValueError) as got:
        Config()
    # Every mesh or SPMD reason of the port's message is one of JAX's,
    # word for word (JAX joins its reasons on one line).
    lines = [ln.strip() for ln in str(got.value).splitlines()[1:]
             if "spmd" in ln.lower() or "single-device" in ln]
    assert lines
    for ln in lines:
        assert ln in str(want.value)


def test_config_refuses_a_mesh_without_a_process_group(monkeypatch):
    """A mesh needs one process per device and the leader/follower roles;
    with both, the settings take JAX's defaults."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for name in ("TPU_COORDINATOR_ADDR", "TPU_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    for env in ({"TPU_TP_SIZE": "2"}, {"TPU_DP_SIZE": "2"},
                {"TPU_SP_SIZE": "2"}, {"TPU_SPMD_ROLE": "follower"},
                # a process group but no role: every rank would serve
                {**MESH, "TPU_SPMD_ROLE": "off"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            JaxConfig()   # one JAX process drives every local device
            with pytest.raises(ValueError,
                               match="one process per device") as err:
                Config()
            assert "TPU_COORDINATOR_ADDR" in str(err.value)
    for k, v in MESH.items():
        monkeypatch.setenv(k, v)
    cfg = Config()
    assert (cfg.tp_size, cfg.spmd_role, cfg.spmd_addr,
            cfg.spmd_followers, cfg.spmd_hb_interval_s,
            cfg.spmd_hb_timeout_s) == (2, "leader", "127.0.0.1:8890", 1,
                                       2.0, 8.0)


@pytest.mark.parametrize("kind", ["int4", "kv_int8", "paged", "structured"])
def test_engine_refuses_mesh_incompatibilities_with_jax_messages(kind):
    """The engine's own checks (library callers skip Config) name the
    same reasons as the JAX engine's; "auto" structured decoding is
    unavailable on a mesh with JAX's reason, and shared prefixes and the
    host KV pool are off."""
    import jax

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from fasttalk_tpu.models import get_model_config as jax_cfg
    from fasttalk_tpu.models import init_params as jax_init
    from fasttalk_tpu.parallel.mesh import make_mesh as jax_mesh
    from fasttalk_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from fasttalk_tpu_torch.quantization.int4 import quantize_params_int4

    jkw, tkw = {}, {}
    if kind == "int4":
        jkw = {"weight_quant": "int4", "weight_quant_group": 16}
    elif kind == "kv_int8":
        jkw = tkw = {"kv_quant": "int8"}
    elif kind == "paged":
        jkw = tkw = {"kv_layout": "paged"}
    else:
        jkw = tkw = {"structured": "on"}
    with pytest.raises(ValueError) as want:
        TPUEngine(jax_cfg("test-tiny"), jax_init(jax_cfg("test-tiny"),
                                                 jax.random.PRNGKey(0)),
                  JaxBytes(), num_slots=4, max_len=256, spec_decode="off",
                  mesh=jax_mesh(tp=2), **jkw)
    mesh = Mesh(MeshSpec(tp=2), 0)
    eng = None
    if kind == "int4":
        from fasttalk_tpu_torch.engine.engine import TorchEngine
        from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
        from fasttalk_tpu_torch.models.configs import get_model_config
        from fasttalk_tpu_torch.models.llama import init_params

        cfg = get_model_config("test-tiny")
        params = quantize_params_int4(init_params(
            cfg, torch.Generator().manual_seed(0), torch.float32, "cpu"),
            group=16)
        with pytest.raises(ValueError) as got:
            TorchEngine(cfg, params, ByteTokenizer(), device="cpu",
                        num_slots=4, max_len=256, spec_decode="off",
                        mesh=mesh)
    else:
        with pytest.raises(ValueError) as got:
            _tiny_engine(mesh=mesh, **tkw)
        eng = _tiny_engine(mesh=mesh)
    assert str(got.value) == str(want.value)
    if eng is not None:
        assert eng.structured_reason.startswith(
            "structured decoding is single-device only")
        assert not eng.shared_prefix and not eng._kv_pool.enabled
        assert eng.get_model_info()["mesh"] == {"dp": 1, "sp": 1, "tp": 2}
        assert eng.cache.k.shape[3] == 1  # its one of test-tiny's 2 KV heads
