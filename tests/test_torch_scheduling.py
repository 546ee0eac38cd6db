"""Admission control in fasttalk_tpu_torch: the scheduler and the engine.

``scheduling/scheduler.py`` is a copy of the JAX package's, so the two are
driven through one submit / pop / requeue / cancel / age / expire / shed /
drain sequence on one fake clock and must agree on every admission, every
shed (reason and ``retry_after``), every expiry, the stats and the queue
snapshot. At engine level (``TorchEngine(device="cpu")`` on test-tiny, one
slot): interactive requests admit before bulk ones, a request past its
queue deadline ends with a ``deadline_expired`` terminal event (with
``retry_after``) without touching a slot, and a full queue sheds: the
engine raises ``AdmissionRejected`` and the WebSocket client gets JAX's
``rate_limit_error`` frame while the breaker stays closed.
"""

import asyncio
import json
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from fasttalk_tpu.scheduling.scheduler import RequestScheduler as JaxSched
from fasttalk_tpu.utils.errors import AdmissionRejected as JaxRejected
from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import init_params
from fasttalk_tpu_torch.scheduling.scheduler import \
    RequestScheduler as TorchSched
from fasttalk_tpu_torch.utils.errors import AdmissionRejected
from fasttalk_tpu_torch.utils.metrics import reset_metrics
from tests._port_isolation import port_isolation  # noqa: F401,E402

TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _drive(sched_cls, rejected_cls):
    """One scripted sequence; returns everything observable."""
    clock = _Clock()
    s = sched_cls(queue_bound=4, default_deadline_s=10.0, bulk_aging_s=2.0,
                  slots=2, clock=clock)
    log = []

    def submit(rid, sid, **kw):
        try:
            s.submit(rid, sid, **kw)
            log.append(("queued", rid))
        except rejected_cls as e:
            log.append(("shed", rid, e.to_dict()["details"]["reason"],
                        round(e.retry_after, 6)))

    def pop(busy=frozenset()):
        e = s.pop(set(busy))
        log.append(("pop", None if e is None else e.request_id))
        return e

    submit("a1", "A")
    submit("a2", "A")
    submit("b1", "B", priority="bulk")
    submit("c1", "C")
    submit("d1", "D")                     # over the bound of 4
    pop()                                 # a1 (interactive, A first)
    pop(busy={"C"})                       # a2? no: A rotated; C busy
    e = pop()
    s.requeue_front(e)                    # no slot this turn
    log.append(("snapshot", [(x["request_id"], x["position"])
                             for x in s.snapshot()]))
    s.cancel("c1")
    clock.t += 3.0                        # b1 ages past 2 s
    pop()                                 # bulk first after aging
    s.note_service_time(4.0)
    s.note_service_time(2.0)
    submit("e1", "E", deadline_s=0.5)     # estimated wait past 0.5 s
    submit("f1", "F", deadline_s=1.0)
    submit("g1", "G", priority="bulk")
    clock.t += 1.5
    log.append(("expired", sorted(x.request_id
                                  for x in s.take_expired())))
    log.append(("stats", s.stats()))
    s.begin_drain()
    submit("h1", "H")
    log.append(("state", s.overload_state()))
    while pop() is not None:
        pass
    log.append(("stats", s.stats()))
    return log


def test_scheduler_makes_the_jax_decisions():
    # The stats carry process-wide shed counts. tests/conftest.py empties the
    # JAX package's registry before each test; the port's is emptied here,
    # or a shed counted by an earlier test in this process shows on the
    # port's side only.
    reset_metrics()
    port = _drive(TorchSched, AdmissionRejected)
    ref = _drive(JaxSched, JaxRejected)
    assert port == ref
    kinds = {x[0] for x in port}
    assert {"shed", "pop", "expired", "snapshot"} <= kinds
    sheds = [x for x in port if x[0] == "shed"]
    assert [x[2] for x in sheds] == ["queue_full", "wait_too_long",
                                     "draining"]


def _engine(**kw) -> TorchEngine:
    params = init_params(TINY, torch.Generator().manual_seed(2),
                         torch.float32, "cpu")
    opts = dict(num_slots=1, max_len=512, prefill_chunk=64,
                dtype=torch.float32, steps_per_call=4)
    opts.update(kw)
    eng = TorchEngine(TINY, params, ByteTokenizer(), device="cpu", **opts)
    eng.start()
    return eng


async def _collect(eng, rid, sid, order, max_tokens=8, **kw):
    events = []
    try:
        async for ev in eng.generate(
                rid, sid, [{"role": "user", "content": f"hi {rid}"}],
                GenerationParams(max_tokens=max_tokens, **{**GREEDY, **kw})):
            if rid not in order:  # first event: its prefill has run
                order.append(rid)
            events.append(ev)
    except AdmissionRejected as e:
        events.append({"type": "shed", "error": e})
    return events


async def _wait_until(cond, timeout=30.0):
    t0 = asyncio.get_running_loop().time()
    while not cond():
        assert asyncio.get_running_loop().time() - t0 < timeout
        await asyncio.sleep(0.005)


def test_interactive_admits_before_bulk():
    """One slot, held by a long generation: a bulk request queued first
    and an interactive one queued after it; the interactive one starts
    first when the slot frees (the holder is cancelled)."""
    eng = _engine()

    async def run():
        order = []
        hold = asyncio.create_task(_collect(eng, "hold", "s0", order, 450,
                                            ignore_eos=True))
        await _wait_until(lambda: "hold" in order)
        bulk = asyncio.create_task(_collect(eng, "bulk", "s1", order,
                                            priority="bulk"))
        await _wait_until(lambda: len(eng._sched) == 1)
        inter = asyncio.create_task(_collect(eng, "inter", "s2", order))
        await _wait_until(lambda: len(eng._sched) == 2)
        queued = eng.scheduler_debug()["queued"]
        pending = eng.pending_requests()
        eng.cancel("hold")
        outs = await asyncio.gather(hold, bulk, inter)
        return order, outs, queued, pending
    try:
        order, outs, queued, pending = asyncio.run(
            asyncio.wait_for(run(), 120))
    finally:
        eng.shutdown()
    # While queued: the scheduler lists interactive ahead of bulk, and all
    # three requests are pending.
    assert [(q["request_id"], q["priority"], q["position"])
            for q in queued] == [("inter", "interactive", 0),
                                 ("bulk", "bulk", 1)]
    assert pending == 3
    assert order == ["hold", "inter", "bulk"]
    assert outs[0][-1]["type"] == "cancelled"
    assert all(o[-1]["type"] == "done" for o in outs[1:])


def test_expired_deadline_ends_before_prefill():
    """A queued request whose deadline passes (the scheduler's clock is
    moved on) ends with a ``deadline_expired`` terminal event carrying
    ``retry_after`` and never takes the slot or a prefill."""
    eng = _engine()

    async def run():
        order = []
        hold = asyncio.create_task(_collect(eng, "hold", "s0", order, 450,
                                            ignore_eos=True))
        await _wait_until(lambda: "hold" in order)
        late = asyncio.create_task(_collect(eng, "late", "s1", order,
                                            deadline_s=5.0))
        await _wait_until(lambda: len(eng._sched) == 1)
        rows = eng.batched_prefill_rows
        eng._sched._clock = lambda: time.monotonic() + 100.0
        ev = await late
        expired_while_held = not hold.done()
        eng.cancel("hold")
        await hold
        return ev, rows, expired_while_held
    try:
        ev, rows, held = asyncio.run(asyncio.wait_for(run(), 120))
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert held
    assert len(ev) == 1 and ev[0]["type"] == "error"
    assert ev[0]["code"] == "deadline_expired" and ev[0]["retry_after"] >= 1.0
    assert stats["batched_prefill_rows"] == rows
    assert eng.slots.lookup("s1") is None
    assert stats["scheduler"]["expired_total"] >= 1


def test_full_queue_sheds_as_a_rate_limit_frame():
    """SCHED_QUEUE_BOUND=1 on one slot: a running generation, one queued
    request, and a third submission that sheds: ``generate`` raises
    ``AdmissionRejected`` with ``retry_after`` and the reason, and the port's
    server sends JAX's ``rate_limit_error`` frame, breaker closed."""
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    eng = _engine(queue_bound=1)
    server = WebSocketLLMServer(
        Config(model_name="test-tiny", model_path="", max_model_len=512,
               default_context_window=512), eng)

    async def run():
        order = []
        hold = asyncio.create_task(_collect(eng, "hold", "s0", order, 450,
                                            ignore_eos=True))
        await _wait_until(lambda: "hold" in order)
        queued = asyncio.create_task(_collect(eng, "q", "s1", order))
        await _wait_until(lambda: len(eng._sched) == 1)
        direct = await _collect(eng, "x", "s2", order)
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            ws = await client.ws_connect("/ws/llm")
            await ws.receive()
            await ws.send_json({"type": "start_session",
                                "config": {"max_tokens": 4}})
            await ws.receive()
            await ws.send_json({"type": "user_message", "text": "hi"})
            frame = json.loads((await ws.receive(timeout=60)).data)
            await ws.close()
        finally:
            await client.close()
        eng.cancel("hold")
        await asyncio.gather(hold, queued)
        return direct, frame
    try:
        direct, frame = asyncio.run(asyncio.wait_for(run(), 120))
    finally:
        eng.shutdown()
    shed = direct[-1]
    assert shed["type"] == "shed"
    assert shed["error"].retry_after >= 1.0
    assert shed["error"].to_dict()["details"]["reason"] == "queue_full"
    assert frame["type"] == "error"
    err = frame["error"]
    assert err["code"] == "rate_limit_error" and err["retry_after"] >= 1.0
    assert err["details"]["reason"] == "queue_full"
    assert server.breaker.to_dict() == {"state": "closed", "failures": 0}
    assert eng.get_stats()["scheduler"]["shed_total"] >= 2
