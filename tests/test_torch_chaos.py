"""The chaos drills of tests/test_chaos.py that are not SPMD, run against
``fasttalk_tpu_torch`` on the CPU.

The port's failpoints (resilience/failpoints.py, a copy of the JAX
package's) are injected at the engine's seams (``engine.loop.tick``,
``engine.prefill.dispatch``, ``engine.decode.dispatch``,
``engine.retire.fetch``), the KV tier's, the remote providers', the
structured compiler's and the WebSocket server's, and the global recovery
invariants are the JAX suite's: every request ends with exactly one
terminal event, no caller awaits forever, the supervisor and the watchdog
engage within their deadlines, KV byte accounting stays exact across
crash, park and restart, and metrics stay Prometheus-valid mid-incident.
The engine is test-tiny with random weights and the byte tokenizer;
``ignore_eos`` keeps a generation running where a drill needs one.
The port's failpoint registry is cleared on both sides of every test
(tests/_port_isolation.py).
"""

import asyncio
import importlib.util
import json
import os
import threading
import time

import pytest
import torch

from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import init_params
from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.resilience import failpoints as fp
from fasttalk_tpu_torch.utils.metrics import get_metrics
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)

MSG_A = [{"role": "user", "content":
          "a reasonably long first-turn message for chaos session A"}]
FILLER_B = [{"role": "user", "content": "filler session B text"}]
FILLER_C = [{"role": "user", "content": "filler session C text"}]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _make_engine(**kw) -> TorchEngine:
    params = init_params(TINY, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    opts = dict(num_slots=2, max_len=256, prefill_chunk=64,
                dtype=torch.float32, steps_per_call=8,
                kv_host_budget_mb=64.0, kv_park_ttl_s=600.0,
                kv_park_idle_s=0.0, kv_restore_min_tokens=8)
    opts.update(kw)
    eng = TorchEngine(TINY, params, ByteTokenizer(), device="cpu", **opts)
    eng.start()
    return eng


def _pin_policy(eng, copy_bps=1e9, prefill_tps=1e3):
    """Fixed measurements: a restore always beats the prefill here."""
    pol = eng._kv_policy
    pol.note_copy = lambda *a: None
    pol.note_prefill = lambda *a: None
    pol._copy_bps, pol._prefill_tps = copy_bps, prefill_tps


@pytest.fixture(scope="module")
def eng():
    e = _make_engine()
    _pin_policy(e)
    yield e
    fp.clear()
    e.shutdown()


def _revived(e) -> bool:
    """Crash drills kill the module engine's thread; every drill begins
    from a running engine."""
    return e.check_connection() or e.restart()


def _collect(eng, rid, sid, msgs, max_tokens=8, **params):
    async def run():
        out = []
        async for ev in eng.generate(
                rid, sid, msgs,
                GenerationParams(max_tokens=max_tokens,
                                 **{**GREEDY, **params})):
            out.append(ev)
        return out
    return asyncio.run(run())


def _spawn_collect(eng, rid, sid, msgs, **kw):
    box = {}

    def run():
        try:
            box["events"] = _collect(eng, rid, sid, msgs, **kw)
        except Exception as e:  # surfaced by the joining test
            box["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _terminals(events):
    return [e for e in events if e["type"] in ("done", "error", "cancelled")]


def _assert_one_terminal(events, type_=None, code=None):
    terms = _terminals(events)
    assert len(terms) == 1, f"expected exactly one terminal: {events}"
    if type_ is not None:
        assert terms[0]["type"] == type_, terms[0]
    if code is not None:
        assert terms[0].get("code") == code, terms[0]
    assert events[-1] is terms[0]   # nothing streams after a terminal


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------
# Failpoint machinery and its setting
# ---------------------------------------------------------------------

def test_port_seams_are_the_jax_catalog():
    """Every engine and serving seam the port fires is a catalogued point
    of the JAX package's registry, with the same catalog."""
    from fasttalk_tpu.resilience import failpoints as jfp

    assert fp.CATALOG == jfp.CATALOG
    src = ""
    for rel in ("engine/engine.py", "serving/server.py", "engine/remote.py",
                "kvcache/offload.py", "kvcache/blocks.py"):
        src += open(os.path.join(REPO, "fasttalk_tpu_torch", rel)).read()
    for point in ("engine.loop.tick", "engine.prefill.dispatch",
                  "engine.decode.dispatch", "engine.retire.fetch",
                  "kv.restore.dispatch", "serving.ws.send",
                  "remote.connect", "remote.stream"):
        assert f'"{point}"' in src, point


@pytest.mark.parametrize("spec,message", [
    ("nope=error", "unknown failpoint"),
    ("engine.loop.tick=explode", "unknown action"),
    ("engine.loop.tick=delay_ms", "requires an argument")])
def test_config_validates_fault_points_as_jax_does(monkeypatch, spec,
                                                   message):
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("FAULT_POINTS", spec)
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(llm_provider="tpu")
    with pytest.raises(ValueError) as port_err:
        Config()
    assert message in str(jax_err.value) and message in str(port_err.value)
    monkeypatch.setenv("FAULT_POINTS", "engine.loop.tick=delay_ms:1;p=0.5")
    assert Config().fault_points


def test_fire_counts_reach_the_ports_metrics_and_events():
    fp.activate("kv.park.copy=corrupt;count=1")
    assert fp.fire("kv.park.copy", session_id="s") == "corrupt"
    assert get_metrics().counter("fault_injected_total").value >= 1
    assert "fault_injection" in [e["kind"] for e in get_events().recent(50)]


# ---------------------------------------------------------------------
# Engine chaos: crash, scoped error, slowness, hang
# ---------------------------------------------------------------------

class TestEngineChaos:
    def test_decode_dispatch_error_exactly_one_terminal_then_restart(
            self, eng):
        assert _revived(eng)
        fp.activate("engine.decode.dispatch=error;count=1")
        events = _collect(eng, "cd1", "CD1", MSG_A, max_tokens=8)
        _assert_one_terminal(events, "error", code="internal_error")
        fp.clear()
        assert _wait(lambda: not eng.check_connection(), 5.0)
        assert eng.restart()
        events = _collect(eng, "cd2", "CD2", MSG_A, max_tokens=4)
        _assert_one_terminal(events, "done")

    def test_crash_thread_ends_requests_with_the_crash_reason(self, eng):
        """``crash_thread`` raises a BaseException: ``_run`` catches it as
        the JAX loop does, so the request ends with the crash's reason,
        not "engine shut down"."""
        assert _revived(eng)
        fp.activate("engine.decode.dispatch=crash_thread;count=1")
        events = _collect(eng, "ct1", "CT1", MSG_A, max_tokens=8)
        _assert_one_terminal(events, "error", code="internal_error")
        assert events[-1]["error"].startswith("engine crashed:"), events[-1]
        assert "engine.decode.dispatch" in events[-1]["error"]
        fp.clear()
        assert _wait(lambda: not eng.check_connection(), 5.0)
        assert eng.restart()

    def test_prefill_dispatch_error_scoped_to_request(self, eng):
        assert _revived(eng)
        fp.activate("engine.prefill.dispatch=error;count=1")
        events = _collect(eng, "pf1", "PF1", MSG_A, max_tokens=4)
        _assert_one_terminal(events, "error")
        assert eng.check_connection()   # scoped: no crash
        events = _collect(eng, "pf2", "PF2", MSG_A, max_tokens=4)
        _assert_one_terminal(events, "done")

    def test_chunked_prefill_dispatch_error_scoped_to_request(self, eng):
        """A prompt longer than the chunk takes the chunked path, whose
        seam is scoped to its request too."""
        assert _revived(eng)
        fp.activate("engine.prefill.dispatch=error;count=1")
        long_msg = [{"role": "user", "content": "x" * 150}]
        events = _collect(eng, "pc1", "PC1", long_msg, max_tokens=4)
        _assert_one_terminal(events, "error")
        assert eng.check_connection()
        fp.clear()
        _assert_one_terminal(
            _collect(eng, "pc2", "PC2", long_msg, max_tokens=4), "done")

    def test_decode_dispatch_delay_still_completes(self, eng):
        assert _revived(eng)
        fp.activate("engine.decode.dispatch=delay_ms:40;count=3")
        events = _collect(eng, "dl1", "DL1", MSG_A, max_tokens=6)
        _assert_one_terminal(events, "done")
        assert fp.describe()["rules"][0]["fired"] >= 1

    def test_retire_fetch_hang_watchdog_terminates_within_deadline(
            self, eng):
        from fasttalk_tpu_torch.observability.watchdog import Watchdog

        assert _revived(eng)
        wd = Watchdog(token_stall_s=0.3, step_stall_s=0.3,
                      cancel_stall_s=0.3, interval_s=0.05)
        wd.bind_engine(eng)
        fp.activate("engine.retire.fetch=hang")
        t, box = _spawn_collect(eng, "hg1", "HG1", MSG_A, max_tokens=32,
                                ignore_eos=True)
        try:
            assert _wait(lambda: (eng.heartbeat_age() or 0) > 0.4, 10.0)
            t0 = time.monotonic()

            def tick():
                status = wd.check()
                assert status["step_stalled"] or not t.is_alive()
                return not t.is_alive()

            assert _wait(tick, 5.0), \
                "watchdog never unblocked the stalled caller"
            assert time.monotonic() - t0 < 5.0
            assert get_metrics().counter(
                "watchdog_cancelled_total").value >= 1
        finally:
            fp.clear()  # release the hang
        t.join(timeout=15)
        assert not t.is_alive(), "caller awaited forever"
        _assert_one_terminal(box["events"], "error", code="stalled")
        assert _wait(eng.check_connection, 5.0)
        _assert_one_terminal(_collect(eng, "hg2", "HG2", MSG_A,
                                      max_tokens=4), "done")

    def test_shutdown_timeout_logs_stuck_stack(self):
        e = _make_engine(num_slots=1, kv_host_budget_mb=0.0)
        try:
            fp.activate("engine.loop.tick=hang")
            assert _wait(lambda: (e.heartbeat_age() or 0) > 0.2, 10.0)
            t0 = time.monotonic()
            e.shutdown(timeout_s=0.3)   # times out against the hang
            # One wait for the thread, not a wait and then a join.
            assert time.monotonic() - t0 < 0.55
            evs = get_events().recent(50, kind="engine_shutdown_stuck")
            assert evs and evs[0]["severity"] == "critical"
            assert "fire" in evs[0]["attrs"].get("stack", "")
        finally:
            fp.clear()  # release so the thread can exit
            e.shutdown(timeout_s=5)
        assert _wait(lambda: not e._thread.is_alive(), 5.0)


# ---------------------------------------------------------------------
# The supervisor's restart path, end to end
# ---------------------------------------------------------------------

class TestSupervisorRestartE2E:
    def test_crash_park_restart_queue_survival(self, eng):
        assert _revived(eng)
        restarts_before = len(get_events().recent(100, kind="engine_restart"))
        # 1. Session A decodes, then two fillers on the 2-slot engine evict
        #    it: its KV parks to the host pool.
        first = _collect(eng, "sv1", "SVA", MSG_A)
        r1 = "".join(e.get("text", "") for e in first if e["type"] == "token")
        _collect(eng, "svb", "SVB", FILLER_B)
        _collect(eng, "svc", "SVC", FILLER_C)
        assert _wait(lambda: eng._kv_pool.parked_len("SVA") > 0), \
            "eviction never parked session SVA"
        assert eng._kv_pool.stats()["bytes"] > 0
        # 2. A long generation is mid-decode when the thread is killed.
        t, box = _spawn_collect(eng, "svg", "SVG", FILLER_B, max_tokens=400,
                                ignore_eos=True)
        assert _wait(lambda: len(eng._running) > 0, 10.0)
        fp.activate("engine.loop.tick=crash_thread;count=1")
        assert _wait(lambda: not eng.check_connection(), 10.0)
        t.join(timeout=15)
        assert not t.is_alive(), "in-flight caller awaited forever"
        _assert_one_terminal(box["events"], "error", code="internal_error")
        # 3. A submission in the crash race window (its connection check
        #    passed before the thread died) survives and is served after
        #    the restart.
        fp.clear()
        eng.check_connection = lambda: True
        try:
            tq, boxq = _spawn_collect(eng, "svq", "SVQ", FILLER_C,
                                      max_tokens=4)
            assert _wait(lambda: "svq" in eng._by_id, 10.0)
        finally:
            del eng.__dict__["check_connection"]
        # 4. The supervised restart: device state rebuilt, the same command
        #    queue, the parked host KV kept.
        assert eng.restart()
        restart_evs = get_events().recent(100, kind="engine_restart")
        assert len(restart_evs) > restarts_before
        assert restart_evs[0]["attrs"]["parked_sessions"] >= 1
        tq.join(timeout=30)
        assert not tq.is_alive(), "queued-during-outage caller hung"
        _assert_one_terminal(boxq["events"], "done")
        # 5. A's follow-up restores from the kept entry, which the restore
        #    consumes: the byte accounting stays exact.
        restored_before = eng.get_stats()["kv_host"]["restored_total"]
        msg2 = MSG_A + [{"role": "assistant", "content": r1},
                        {"role": "user", "content": "follow-up turn"}]
        _assert_one_terminal(_collect(eng, "sv2", "SVA", msg2), "done")
        st = eng.get_stats()["kv_host"]
        assert st["restored_total"] > restored_before
        assert eng._kv_pool.parked_len("SVA") == 0
        assert st["sessions"] == len(eng._kv_pool)


class _CrashyEngine:
    """Engine stub for the launcher's supervisor: dead until ``restart()``
    succeeds; restart outcomes are scripted (tests/test_chaos.py)."""

    def __init__(self, outcomes):
        self.outcomes = list(outcomes)
        self.alive = True
        self.restarts = 0

    def check_connection(self):
        return self.alive

    def restart(self):
        self.restarts += 1
        ok = self.outcomes.pop(0) if self.outcomes else False
        self.alive = ok
        return ok

    def get_model_info(self):
        return {"model": "crashy"}


def _launchers(monkeypatch, engine, **cfg_over):
    """The port's launcher and the JAX package's over the same stub."""
    from fasttalk_tpu.serving.launcher import ServerLauncher as JaxLauncher
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.utils.config import Config

    monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
    out = []
    for launcher_cls, cfg in ((ServerLauncher, Config()),
                              (JaxLauncher, JaxConfig(llm_provider="tpu"))):
        for k, v in cfg_over.items():
            setattr(cfg, k, v)
        out.append(launcher_cls(cfg, engine=engine))
    return out


class TestLauncherSupervisor:
    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    async def test_restart_increments_counter(self, monkeypatch, pkg):
        engine = _CrashyEngine([True])
        launcher = _launchers(monkeypatch, engine,
                              supervisor_backoff_s=0.01)[pkg == "jax"]
        task = asyncio.create_task(launcher._watchdog(interval=0.02))
        engine.alive = False
        for _ in range(200):
            await asyncio.sleep(0.02)
            if engine.alive:
                break
        task.cancel()
        assert engine.restarts == 1
        assert launcher._m_restarts.value == 1
        assert launcher.supervisor_info()["state"] == "ok"
        assert launcher._ready()

    @pytest.mark.parametrize("pkg", ["torch", "jax"])
    async def test_restart_storm_exhausts_budget_and_marks_dead(
            self, monkeypatch, pkg):
        engine = _CrashyEngine([])  # every restart fails
        launcher = _launchers(monkeypatch, engine,
                              supervisor_max_restarts=2,
                              supervisor_window_s=300.0,
                              supervisor_backoff_s=0.01)[pkg == "jax"]
        task = asyncio.create_task(launcher._watchdog(interval=0.02))
        engine.alive = False
        for _ in range(300):
            await asyncio.sleep(0.02)
            if launcher.restart_budget.exhausted:
                break
        await asyncio.sleep(0.2)   # no attempt after exhaustion
        task.cancel()
        assert launcher.restart_budget.exhausted
        assert engine.restarts == 2
        assert launcher.supervisor_info()["state"] == "exhausted"
        assert not launcher._ready()
        if pkg == "torch":
            kinds = [e["kind"] for e in get_events().recent(50)]
            assert "supervisor_exhausted" in kinds

    def test_restart_budget_is_the_jax_one(self):
        """The same attempts on the same clock give the same backoffs,
        states and exhaustion in both packages."""
        from fasttalk_tpu.serving.launcher import RestartBudget as JaxBudget
        from fasttalk_tpu_torch.serving.launcher import RestartBudget

        def trace(cls):
            now = [0.0]
            b = cls(max_restarts=3, window_s=10.0, backoff_s=1.5,
                    backoff_cap_s=5.0, clock=lambda: now[0])
            out = []
            for step in range(8):
                now[0] = step * 3.0
                ok = b.allow()
                out.append((ok, b.note_attempt() if ok else None, b.state()))
            return out
        assert trace(RestartBudget) == trace(JaxBudget)

    async def test_health_endpoint_reports_supervisor_dead(self):
        from aiohttp.test_utils import TestClient, TestServer

        from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app

        app = build_monitoring_app(
            ready_check=lambda: False,
            supervisor_info=lambda: {"state": "exhausted",
                                     "restarts_in_window": 5})
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            body = await (await client.get("/health")).json()
            assert body["status"] == "dead"
            assert body["supervisor"]["state"] == "exhausted"
            assert any("restart budget exhausted" in w
                       for w in body["warnings"])
            assert (await client.get("/health/ready")).status == 503
        finally:
            await client.close()


# ---------------------------------------------------------------------
# KV tier chaos: byte accounting stays exact
# ---------------------------------------------------------------------

class TestKVChaos:
    def test_park_copy_error_loses_snapshot_not_accounting(self):
        e = _make_engine()
        try:
            fp.activate("kv.park.copy=error")
            _collect(e, "k1", "KA", MSG_A)
            _collect(e, "k2", "KB", FILLER_B)
            _collect(e, "k3", "KC", FILLER_C)  # evicts KA -> park fails
            assert _wait(lambda: fp.describe()["rules"][0]["fired"] > 0)
            time.sleep(0.2)
            st = e.get_stats()["kv_host"]
            assert st["sessions"] == 0 and st["bytes"] == 0
            assert e.check_connection()
            fp.clear()
            _assert_one_terminal(_collect(e, "k4", "KA", MSG_A), "done")
        finally:
            fp.clear()
            e.shutdown()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_park_copy_crash_kills_then_resurrects_copy_thread(self):
        e = _make_engine()
        try:
            fp.activate("kv.park.copy=crash_thread;count=1")
            _collect(e, "c1", "CA", MSG_A)
            _collect(e, "c2", "CB", FILLER_B)
            _collect(e, "c3", "CC", FILLER_C)  # evict CA: thread dies
            assert _wait(lambda: fp.describe()["rules"][0]["fired"] > 0)
            assert _wait(lambda: not e._kv_offload._thread.is_alive(), 5.0)
            fp.clear()
            _collect(e, "c4", "CA", MSG_A)
            _collect(e, "c5", "CD", FILLER_C)
            assert _wait(lambda: len(e._kv_pool) > 0, 10.0)
        finally:
            fp.clear()
            e.shutdown()

    def test_restore_dispatch_error_falls_back_to_prefill(self):
        e = _make_engine()
        _pin_policy(e)
        try:
            first = _collect(e, "r1", "RA", MSG_A)
            r1 = "".join(x.get("text", "") for x in first
                         if x["type"] == "token")
            _collect(e, "r2", "RB", FILLER_B)
            _collect(e, "r3", "RC", FILLER_C)
            assert _wait(lambda: e._kv_pool.parked_len("RA") > 0)
            fp.activate("kv.restore.dispatch=error;count=1")
            msg2 = MSG_A + [{"role": "assistant", "content": r1},
                            {"role": "user", "content": "again"}]
            _assert_one_terminal(_collect(e, "r4", "RA", msg2), "done")
            assert e.check_connection()
            st = e.get_stats()["kv_host"]
            assert st["restored_total"] == 0
            assert e._kv_pool.parked_len("RA") == 0
            assert st["sessions"] == len(e._kv_pool)
        finally:
            fp.clear()
            e.shutdown()

    def test_prestage_error_restore_still_works(self):
        e = _make_engine()
        _pin_policy(e)
        try:
            fp.activate("kv.prestage.copy=error")
            first = _collect(e, "p1", "PA", MSG_A)
            r1 = "".join(x.get("text", "") for x in first
                         if x["type"] == "token")
            _collect(e, "p2", "PB", FILLER_B)
            _collect(e, "p3", "PC", FILLER_C)
            assert _wait(lambda: e._kv_pool.parked_len("PA") > 0)
            msg2 = MSG_A + [{"role": "assistant", "content": r1},
                            {"role": "user", "content": "back again"}]
            _assert_one_terminal(_collect(e, "p4", "PA", msg2), "done")
            assert e.get_stats()["kv_host"]["restored_total"] >= 1
        finally:
            fp.clear()
            e.shutdown()

    def test_block_alloc_exhaustion_sheds_with_exact_accounting(self):
        e = _make_engine(kv_layout="paged", kv_block_size=16)
        try:
            alloc = e._kv_blocks
            fp.activate("kv.block_alloc=error;count=1")
            events = _collect(e, "ba1", "BA", MSG_A)
            _assert_one_terminal(events, "error", code="kv_blocks_exhausted")
            assert events[-1]["retry_after"] > 0
            assert fp.describe()["rules"][0]["fired"] == 1
            assert _wait(lambda: alloc.in_use() == 0), alloc.stats()
            alloc.check_leaks()
            assert e.check_connection()
            fp.clear()
            _assert_one_terminal(_collect(e, "ba2", "BA", MSG_A), "done")
            assert alloc.in_use() > 0
            alloc.check_leaks()
        finally:
            fp.clear()
            e.shutdown()

    def test_paged_restart_rebuilds_pool_and_tree(self):
        """A crash on the paged radix tier: ``restart()`` gives a fresh
        allocator and an empty tree over the fresh pool, and the next
        request allocates and donates blocks normally."""
        e = _make_engine(kv_layout="paged", kv_block_size=16,
                         kv_pool_blocks=24, kv_radix=True,
                         kv_host_budget_mb=0.0)
        try:
            _assert_one_terminal(_collect(e, "pr1", "PR", MSG_A), "done")
            e.release_session("PR")
            assert _wait(lambda: e._kv_radix.stats()["blocks"] > 0)
            old_alloc, old_tree = e._kv_blocks, e._kv_radix
            fp.activate("engine.decode.dispatch=crash_thread;count=1")
            _assert_one_terminal(_collect(e, "pr2", "PS", FILLER_B),
                                 "error", code="internal_error")
            fp.clear()
            assert _wait(lambda: not e.check_connection(), 5.0)
            assert e.restart()
            assert e._kv_blocks is not old_alloc
            assert e._kv_radix is not old_tree
            assert e._kv_radix.stats()["blocks"] == 0
            assert e._kv_blocks.in_use() == 0
            _assert_one_terminal(_collect(e, "pr3", "PR", MSG_A), "done")
            e._kv_blocks.check_leaks()
            e._kv_radix.check_integrity()
        finally:
            fp.clear()
            e.shutdown()


# ---------------------------------------------------------------------
# WebSocket serving chaos
# ---------------------------------------------------------------------

class TestWSChaos:
    async def _setup(self, monkeypatch):
        from aiohttp.test_utils import TestClient, TestServer

        from fasttalk_tpu_torch.engine.fake import FakeEngine
        from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
        from fasttalk_tpu_torch.utils.config import Config

        monkeypatch.setenv("LLM_PROVIDER", "fake")
        monkeypatch.setenv("ENABLE_PYDANTIC_AI", "false")
        engine = FakeEngine(delay_s=0.001)
        engine.start()
        server = WebSocketLLMServer(Config(), engine)
        client = TestClient(TestServer(server.app))
        await client.start_server()
        return engine, server, client

    async def test_ws_send_error_does_not_kill_the_server(self, monkeypatch):
        _, server, client = await self._setup(monkeypatch)
        try:
            ws = await client.ws_connect("/ws/llm")
            started = json.loads((await ws.receive()).data)
            assert started["type"] == "session_started"
            assert started["provider"] == "fake"
            fp.activate("serving.ws.send=error;count=1")
            await ws.send_json({"type": "user_message", "text": "hi"})
            saw_terminal = False
            for _ in range(200):
                msg = await asyncio.wait_for(ws.receive(), timeout=10)
                if msg.data is None:
                    break
                try:
                    obj = json.loads(msg.data)
                except (TypeError, ValueError):
                    continue
                if obj["type"] in ("error", "response_complete"):
                    saw_terminal = True
                    break
            assert saw_terminal
            fp.clear()
            ws2 = await client.ws_connect("/ws/llm")
            assert json.loads((await ws2.receive()).data)[
                "type"] == "session_started"
            await ws2.send_json({"type": "user_message", "text": "yo"})
            done = False
            for _ in range(200):
                obj = json.loads((await asyncio.wait_for(
                    ws2.receive(), timeout=10)).data)
                if obj["type"] == "response_complete":
                    done = True
                    break
            assert done
            await ws2.close()
            await ws.close()
        finally:
            fp.clear()
            await client.close()

    async def test_ws_send_corrupt_delivers_garbage_then_recovers(
            self, monkeypatch):
        _, server, client = await self._setup(monkeypatch)
        try:
            ws = await client.ws_connect("/ws/llm")
            await ws.receive()  # session_started
            fp.activate("serving.ws.send=corrupt;count=1")
            await ws.send_json({"type": "user_message", "text": "hi"})
            saw_garbage = saw_complete = False
            for _ in range(300):
                msg = await asyncio.wait_for(ws.receive(), timeout=10)
                if msg.data is None:
                    break
                try:
                    obj = json.loads(msg.data)
                except (TypeError, ValueError):
                    saw_garbage = True
                    continue
                if obj["type"] == "response_complete":
                    saw_complete = True
                    break
            assert saw_garbage and saw_complete
            await ws.close()
        finally:
            fp.clear()
            await client.close()


# ---------------------------------------------------------------------
# Structured compile and cross-cutting invariants
# ---------------------------------------------------------------------

class TestStructuredChaos:
    def test_compile_fault_is_client_shape_error(self, eng):
        from fasttalk_tpu_torch.utils.errors import (ErrorCategory,
                                                     LLMServiceError)

        assert _revived(eng)
        fp.activate("structured.compile=error;count=1")
        with pytest.raises(LLMServiceError) as ei:
            _collect(eng, "st1", "ST1", MSG_A, max_tokens=4,
                     structured={"kind": "regex", "regex": "ab+a"})
        assert ei.value.category == ErrorCategory.VALIDATION
        assert eng.check_connection()
        fp.clear()
        _assert_one_terminal(_collect(
            eng, "st2", "ST2", MSG_A, max_tokens=6,
            structured={"kind": "regex", "regex": "ab+a"}))


class TestMidIncidentInvariants:
    def test_metrics_prometheus_valid_mid_incident(self, eng):
        assert _revived(eng)
        fp.activate("kv.park.copy=error,engine.prefill.dispatch="
                    "error;count=1")
        _assert_one_terminal(_collect(eng, "mi1", "MI1", MSG_A,
                                      max_tokens=4), "error")
        fp.clear()
        spec = importlib.util.spec_from_file_location(
            "check_prometheus",
            os.path.join(REPO, "scripts", "check_prometheus.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        text = get_metrics().prometheus()
        assert "fault_injected_total" in text
        problems = mod.validate(text)
        assert not problems, problems


class TestFaultHttpEndpoint:
    async def _client(self, fault_http):
        from aiohttp.test_utils import TestClient, TestServer

        from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app

        client = TestClient(TestServer(
            build_monitoring_app(fault_http=fault_http)))
        await client.start_server()
        return client

    async def test_post_disabled_by_default(self):
        client = await self._client(fault_http=False)
        try:
            resp = await client.post("/debug/fault", json={
                "spec": "engine.loop.tick=error"})
            assert resp.status == 403
            assert not fp.enabled
            body = await (await client.get("/debug/fault")).json()
            assert "engine.loop.tick" in body["catalog"]
        finally:
            await client.close()

    async def test_arm_inspect_clear_roundtrip(self):
        client = await self._client(fault_http=True)
        try:
            resp = await client.post("/debug/fault", json={
                "spec": "kv.park.copy=delay_ms:5;count=3"})
            assert resp.status == 200
            assert fp.enabled
            body = await (await client.get("/debug/fault")).json()
            assert body["rules"][0]["point"] == "kv.park.copy"
            health = await (await client.get("/health")).json()
            assert health["fault_injection"]["active_points"] == [
                "kv.park.copy"]
            assert any("Fault injection" in w for w in health["warnings"])
            resp = await client.post("/debug/fault", json={
                "spec": "nope=error"})
            assert resp.status == 400
            assert "unknown failpoint" in (await resp.json())["error"]
            assert fp.enabled
            resp = await client.post("/debug/fault", json={"clear": True})
            assert resp.status == 200
            assert not fp.enabled
        finally:
            await client.close()
