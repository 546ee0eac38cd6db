"""The fleet router of fasttalk_tpu_torch held against the JAX package's
over fake engines, and the KV migration wire form across the packages.

- Protocol parity: the same scripted scenarios run through JAX's
  ``FleetRouter`` over fakes built on JAX's ``FakeEngine`` and
  ``HostKVPool``, and through the port's over the port's. The event
  sequences, the router's counters and ``fleet_stats()`` must be equal:
  placement with tie rotation, affinity across turns, a death before the
  first token (a silent re-route) and one mid-decode (one ``resumed``,
  the parked entry migrated to the survivor), drain with a busy stream
  finishing in place, shedding with ``retry_after`` when no replica is
  left, the disaggregated handoff and its fallback, and the elastic
  scaler up and down.
- The wire form: a parked entry with bf16 rows and one with int8 rows and
  scales, serialized in one package and deserialized in the other, in
  both directions, bit-equal; truncated and corrupt payloads are refused
  and both pools stay untouched.

The tests follow tests/test_router.py, tests/test_fleet_fabric.py and
tests/test_disagg.py; they need no model and run in a few seconds.
"""

import asyncio
import importlib
import time
from dataclasses import replace
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

from tests._port_isolation import port_isolation  # noqa: F401

GREEDY = dict(temperature=0.0, top_k=1)
REPLY = "alpha beta gamma delta epsilon zeta eta theta"
SHORT = [{"role": "user", "content": "hi"}]
LONG = [{"role": "user", "content": "word " * 160}]
PKGS = {"jax": "fasttalk_tpu", "torch": "fasttalk_tpu_torch"}


def _ns(pkg: str) -> SimpleNamespace:
    """The modules of one package the scenarios drive."""
    root = PKGS[pkg]

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    ns = SimpleNamespace(
        pkg=pkg, router=mod("router"), engine=mod("engine.engine"),
        fake=mod("engine.fake"), errors=mod("utils.errors"),
        hostpool=mod("kvcache.hostpool"), fp=mod("resilience.failpoints"),
        migrate=mod("router.migrate"))
    ns.Engine = _engine_cls(ns)
    return ns


def _arrays(pkg: str, n_tokens: int, seed: int, quantized: bool,
            layers=2, kv_heads=2, head_dim=4):
    """(k, v, k_scale, v_scale) of a parked entry: numpy for the JAX
    package, CPU torch tensors for the port, the same values."""
    rng = np.random.default_rng(seed)
    bucket = max(16, 1 << (n_tokens - 1).bit_length())
    shape = (layers, bucket, kv_heads, head_dim)
    if quantized:
        arrs = [rng.integers(-127, 127, shape, dtype=np.int8),
                rng.integers(-127, 127, shape, dtype=np.int8),
                rng.random((layers, bucket, 1), np.float32),
                rng.random((layers, bucket, 1), np.float32)]
    else:
        arrs = [rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32), None, None]
    if pkg == "torch":
        arrs = [None if a is None else torch.from_numpy(a) for a in arrs]
    return bucket, arrs


def _entry(ns, sid: str, n_tokens: int = 64, quantized: bool = False):
    bucket, (k, v, ks, vs) = _arrays(ns.pkg, n_tokens, len(sid) * 7919,
                                     quantized)
    nbytes = sum(int(np.asarray(a).nbytes) if ns.pkg == "jax"
                 else a.numel() * a.element_size()
                 for a in (k, v, ks, vs) if a is not None)
    return ns.hostpool.ParkedKV(
        session_id=sid, tokens=list(range(n_tokens)), kept=n_tokens,
        bucket=bucket, k=k, v=v, k_scale=ks, v_scale=vs, nbytes=nbytes)


def _engine_cls(ns):
    """A fake replica of one package: the package's ``FakeEngine`` with a
    real ``HostKVPool`` speaking the migration seam, a settable queue
    depth, deaths before the first token or after N tokens, and the
    disaggregated contract (a ``prefill_only`` request parks an entry and
    ends ``prefill_parked``; a prefill-role engine refuses decode
    streams), as the JAX package's test fakes do."""
    errors = ns.errors

    class FleetFake(ns.fake.FakeEngine):
        def __init__(self, delay_s: float = 0.0):
            super().__init__(reply=REPLY, n_repeats=1, delay_s=delay_s)
            self.pool = ns.hostpool.HostKVPool(budget_mb=16.0)
            self.dead = False
            self.die_before_first = False
            self.die_after_tokens = None
            self.waiting = 0
            self.prefill_requests: list[str] = []

        def kill(self):
            self.dead = True
            self._started = False

        def check_connection(self):
            return not self.dead and super().check_connection()

        def get_stats(self):
            stats = super().get_stats()
            stats["waiting"] = self.waiting
            return stats

        def export_parked_kv(self, session_id):
            entry = self.pool.get(session_id)
            return None if entry is None else ns.hostpool.strip_device(entry)

        def parked_kv_info(self, session_id):
            entry = self.pool.get(session_id)
            return None if entry is None else (entry.kept, entry.nbytes)

        def import_parked_kv(self, entry):
            if ns.hostpool.entry_problem(entry) is not None:
                return False
            self.pool.revive(entry.session_id)
            return self.pool.put(ns.hostpool.strip_device(entry))

        def drop_parked_kv(self, session_id):
            return self.pool.purge(session_id)

        def release_session(self, session_id):
            super().release_session(session_id)
            self.pool.purge(session_id)

        async def generate(self, request_id, session_id, messages, params):
            self.requests_seen.append({"request_id": request_id,
                                       "session_id": session_id})
            if params.prefill_only:
                self.prefill_requests.append(request_id)
                self.pool.revive(session_id)
                self.pool.put(_entry(ns, session_id))
                yield {"type": "done", "finish_reason": "prefill_parked",
                       "stats": {"ttft_ms": 3.0, "prefill_tokens": 64}}
                return
            if self.role == "prefill":
                raise errors.LLMServiceError(
                    "replica role is 'prefill': decode streams are "
                    "rejected", category=errors.ErrorCategory.VALIDATION,
                    recoverable=False)
            if self.dead or self.die_before_first:
                self.kill()
                raise errors.LLMServiceError(
                    "replica down (pre-first-token)",
                    category=errors.ErrorCategory.CONNECTION)
            words = self.reply.split(" ")
            n = 0
            self._active.add(request_id)
            try:
                for i, w in enumerate(words):
                    if self.dead or (self.die_after_tokens is not None
                                     and n >= self.die_after_tokens):
                        self.kill()
                        raise errors.LLMServiceError(
                            "replica died mid-stream",
                            category=errors.ErrorCategory.CONNECTION)
                    if request_id in self._cancelled:
                        yield {"type": "cancelled",
                               "finish_reason": "cancelled", "stats": {}}
                        return
                    if n >= params.max_tokens:
                        break
                    await asyncio.sleep(self.delay_s)
                    n += 1
                    yield {"type": "token",
                           "text": w + (" " if i < len(words) - 1 else "")}
                # Idle before the terminal event: a consumer may stop
                # iterating at it, and the scaler reads `running`.
                self._active.discard(request_id)
                yield {"type": "done", "finish_reason": "stop",
                       "stats": {"tokens_generated": n,
                                 "processing_time_ms": 1.0,
                                 "tokens_per_second": 100.0,
                                 "ttft_ms": 1.0, "prompt_tokens": 5}}
            finally:
                self._active.discard(request_id)
                self._cancelled.discard(request_id)

    return FleetFake


def _fleet(ns, n=2, roles=None, clock=None, **router_kw):
    engines = [ns.Engine() for _ in range(n)]
    roles = roles or ["mixed"] * n
    handles = [ns.router.ReplicaHandle(f"r{i}", e, role=roles[i],
                                       dead_probes=1)
               for i, e in enumerate(engines)]
    kw = dict(probe_interval_s=0, failover_retries=2, migrate_timeout_s=2.0,
              disagg_prefill_min_tokens=64)
    kw.update(router_kw)
    if clock is not None:
        kw["clock"] = clock
        for h in handles:
            h._clock = clock
    router = ns.router.FleetRouter(handles, **kw)
    router.start()
    # Deterministic pricing: a fast wire makes migration the cheap way.
    router.kv_policy.note_migrate(64 * 1024 * 1024, 0.01)
    return router, engines, handles


async def _collect(ns, router, rid, sid, messages=SHORT, max_tokens=64):
    events = []
    async for ev in router.generate(
            rid, sid, messages,
            ns.engine.GenerationParams(max_tokens=max_tokens, **GREEDY)):
        events.append(ev)
    return events


def _view(router) -> dict:
    """``fleet_stats()`` without what the host clock decides (probe
    stamps, the migration EMAs)."""
    fs = router.fleet_stats()
    for r in fs["replicas"]:
        r.pop("last_probe_at", None)
    fs["migration"].pop("policy", None)
    return fs


def _pools(engines) -> list[tuple[int, int]]:
    return [(e.pool.stats()["sessions"], e.pool.stats()["bytes"])
            for e in engines]


# ---------------------------------------------------------------------
# Scenarios: each returns what the two packages must agree on
# ---------------------------------------------------------------------

async def _placement_and_affinity(ns):
    router, engines, _ = _fleet(ns)
    try:
        turns = []
        for turn in range(2):
            for i in range(4):
                evs = await _collect(ns, router, f"q{i}-{turn}", f"s{i}")
                turns.append((router.affinity.get(f"s{i}"), evs))
        return {"turns": turns,
                "seen": [len(e.requests_seen) for e in engines],
                "fleet": _view(router)}
    finally:
        router.shutdown()


async def _death_before_first_token(ns):
    router, engines, handles = _fleet(ns)
    try:
        router.affinity.set("s1", "r0")
        engines[0].die_before_first = True
        evs = await _collect(ns, router, "q1", "s1")
        return {"events": evs, "states": [h.state for h in handles],
                "seen": [len(e.requests_seen) for e in engines],
                "fleet": _view(router)}
    finally:
        router.shutdown()


async def _death_mid_decode(ns):
    router, engines, handles = _fleet(ns)
    try:
        # The dying replica holds the session's parked entry: the failover
        # migrates it to the survivor before the resume re-dispatches.
        engines[0].pool.put(_entry(ns, "s1", n_tokens=128))
        router.affinity.set("s1", "r0")
        engines[0].die_after_tokens = 3
        evs = await _collect(ns, router, "q1", "s1")
        return {"events": evs, "states": [h.state for h in handles],
                "affinity": router.affinity.get("s1"),
                "pools": _pools(engines), "fleet": _view(router)}
    finally:
        router.shutdown()


async def _drain_with_busy_stream(ns):
    router, engines, _ = _fleet(ns)
    engines[0].delay_s = 0.01
    try:
        engines[0].pool.put(_entry(ns, "s-idle", n_tokens=128))
        router.affinity.set("s-idle", "r0")
        router.affinity.set("s-busy", "r0")
        busy: list[dict] = []

        async def run():
            busy.extend(await _collect(ns, router, "q-busy", "s-busy"))

        task = asyncio.ensure_future(run())
        for _ in range(400):
            if router._routes.get("q-busy"):
                break
            await asyncio.sleep(0.005)
        summary = router.drain_replica("r0")
        fresh = await _collect(ns, router, "q-new", "s-new")
        await task
        return {"summary": summary, "busy": busy, "fresh": fresh,
                "affinity": {s: router.affinity.get(s)
                             for s in ("s-idle", "s-busy", "s-new")},
                "pools": _pools(engines), "fleet": _view(router)}
    finally:
        router.shutdown()


async def _shed_when_no_replica_is_left(ns):
    router, engines, handles = _fleet(ns)
    try:
        for e in engines:
            e.die_before_first = True
        try:
            await _collect(ns, router, "q1", "s1")
        except ns.errors.AdmissionRejected as e:
            shed = (type(e).__name__, e.retry_after, str(e))
        return {"shed": shed, "states": [h.state for h in handles],
                "fleet": _view(router)}
    finally:
        router.shutdown()


async def _disagg_handoff(ns):
    router, engines, _ = _fleet(ns, roles=["prefill", "decode"])
    try:
        long_evs = await _collect(ns, router, "q-long", "s-long", LONG, 16)
        short_evs = await _collect(ns, router, "q-short", "s-short", SHORT,
                                   16)
        return {"long": long_evs, "short": short_evs,
                "prefill_requests": [e.prefill_requests for e in engines],
                "affinity": router.affinity.get("s-long"),
                "pools": _pools(engines), "fleet": _view(router)}
    finally:
        router.shutdown()


async def _disagg_fallback(ns):
    router, engines, _ = _fleet(ns, roles=["prefill", "decode"])
    ns.fp.activate("router.handoff=error;count=1")
    try:
        evs = await _collect(ns, router, "q-long", "s-long", LONG, 16)
        return {"events": evs, "affinity": router.affinity.get("s-long"),
                "seen": [len(e.requests_seen) for e in engines],
                "fleet": _view(router)}
    finally:
        ns.fp.clear()
        router.shutdown()


async def _scaler_up_and_down(ns):
    now = [0.0]
    router, engines, _ = _fleet(ns, n=1, clock=lambda: now[0])
    built = []

    def build_replica(replica_id, role="mixed"):
        e = ns.Engine()
        built.append(e)
        return ns.router.ReplicaHandle(replica_id, e, role=role)

    scaler = ns.router.ElasticScaler(
        router, build_replica, min_replicas=1, max_replicas=2,
        up_queue_depth=4, down_idle_s=10.0, check_interval_s=1.0,
        clock=lambda: now[0])
    try:
        decisions = []
        engines[0].waiting = 10
        decisions.append(scaler.check_once())
        decisions.append(scaler.check_once())       # at the cap: hold
        ids_up = [h.replica_id for h in router.replicas]
        started = built[0].check_connection()
        router.probe_once()     # r0's queue shows: the new replica wins
        evs = await _collect(ns, router, "q-new", "s-new")
        placed = router.affinity.get("s-new")
        engines[0].waiting = 0
        router.probe_once()     # both idle again
        decisions.append(scaler.check_once())       # arms the idle clock
        now[0] = 11.0
        decisions.append(scaler.check_once())       # drain, then reap
        return {"decisions": decisions, "ids_up": ids_up, "events": evs,
                "placed": placed, "started": started,
                "ids_down": [h.replica_id for h in router.replicas],
                "stats": scaler.stats(), "fleet": _view(router)}
    finally:
        router.shutdown()


SCENARIOS = {
    "placement_and_affinity": _placement_and_affinity,
    "death_before_first_token": _death_before_first_token,
    "death_mid_decode": _death_mid_decode,
    "drain_with_busy_stream": _drain_with_busy_stream,
    "shed_when_no_replica_is_left": _shed_when_no_replica_is_left,
    "disagg_handoff": _disagg_handoff,
    "disagg_fallback": _disagg_fallback,
    "scaler_up_and_down": _scaler_up_and_down,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_router_protocol_equals_jax(scenario):
    got = {pkg: asyncio.run(SCENARIOS[scenario](_ns(pkg))) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    out = got["torch"]
    # What each scenario is about, beyond the two packages agreeing.
    if scenario == "placement_and_affinity":
        assert sorted(out["seen"]) == [4, 4]          # the tie rotates
        assert [a for a, _ in out["turns"][:4]] \
            == [a for a, _ in out["turns"][4:]]       # turns stay affine
        assert out["fleet"]["counters"]["affinity_hits"] == 4
    elif scenario == "death_before_first_token":
        types = [e["type"] for e in out["events"]]
        assert "resumed" not in types and types[-1] == "done"
    elif scenario == "death_mid_decode":
        types = [e["type"] for e in out["events"]]
        assert types.count("resumed") == 1 and "error" not in types
        assert "".join(e.get("text", "") for e in out["events"]) == REPLY
        assert out["pools"][0] == (0, 0) and out["pools"][1][0] == 1
        assert out["fleet"]["counters"]["migrations"] == 1
    elif scenario == "drain_with_busy_stream":
        assert out["busy"][-1]["type"] == "done"
        assert "resumed" not in [e["type"] for e in out["busy"]]
        assert out["summary"]["migrated_kv"] == 1
        assert out["affinity"]["s-idle"] == "r1"
    elif scenario == "shed_when_no_replica_is_left":
        assert out["shed"][0] == "AdmissionRejected"
        assert out["shed"][1] >= 1
    elif scenario == "disagg_handoff":
        assert [e["type"] for e in out["long"]].count("done") == 1
        assert out["prefill_requests"] == [["q-long.prefill"], []]
        assert out["fleet"]["disagg"]["handoffs"] == 1
        assert out["affinity"] == "r1"
    elif scenario == "disagg_fallback":
        types = [e["type"] for e in out["events"]]
        assert types[-1] == "done" and "error" not in types
        assert out["fleet"]["disagg"]["fallbacks"] == 1
    elif scenario == "scaler_up_and_down":
        assert [d["decision"] for d in out["decisions"]] \
            == ["up", "hold", "hold", "down_draining"]
        assert out["ids_up"] == ["r0", "elastic-1"]
        assert out["placed"] == "elastic-1" and out["started"]
        assert out["ids_down"] == ["elastic-1"]
        assert out["stats"]["scale_ups"] == out["stats"]["scale_downs"] == 1


# ---------------------------------------------------------------------
# The wire form across the packages
# ---------------------------------------------------------------------

def _bf16_entry(pkg: str, sid: str = "s-bf16", n_tokens: int = 40):
    """bf16 rows with the same bits in both packages: an ml_dtypes array
    for the JAX package, a torch.bfloat16 tensor for the port."""
    rng = np.random.default_rng(7)
    bucket = 64
    bits = [rng.integers(-2**15, 2**15, (2, bucket, 2, 4), dtype=np.int64)
            .astype(np.int16) for _ in range(2)]
    # Keep them finite bf16 values: clear the exponent's top bit.
    bits = [(b & np.int16(~0x4000)).astype(np.int16) for b in bits]
    if pkg == "jax":
        from fasttalk_tpu.kvcache.hostpool import ParkedKV

        k, v = (b.view(ml_dtypes.bfloat16) for b in bits)
        nbytes = k.nbytes + v.nbytes
    else:
        from fasttalk_tpu_torch.kvcache.hostpool import ParkedKV

        k, v = (torch.from_numpy(b).view(torch.bfloat16) for b in bits)
        nbytes = 2 * k.numel() * 2
    return ParkedKV(session_id=sid, tokens=list(range(n_tokens)),
                    kept=n_tokens, bucket=bucket, k=k, v=v, nbytes=nbytes)


def _int8_entry(pkg: str):
    return _entry(_ns(pkg), "s-int8", n_tokens=40, quantized=True)


def _bits(arr) -> np.ndarray:
    """The raw bytes of a host row array of either package."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            arr = arr.view(torch.int16)
        return arr.numpy().view(np.uint8)
    return np.ascontiguousarray(arr).view(np.uint8)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_wire_form_crosses_the_packages_bit_equal(direction, tier):
    from fasttalk_tpu.router import migrate as jmig
    from fasttalk_tpu_torch.router import migrate as tmig

    src_pkg, (ser, de) = (("torch", (tmig, jmig))
                          if direction == "torch_to_jax"
                          else ("jax", (jmig, tmig)))
    entry = (_bf16_entry if tier == "bf16" else _int8_entry)(src_pkg)
    data = ser.serialize_parked(entry)
    # Byte for byte the same wire form in both packages.
    other = (_bf16_entry if tier == "bf16" else _int8_entry)(
        "jax" if src_pkg == "torch" else "torch")
    assert data == de.serialize_parked(other)
    out = de.deserialize_parked(data)
    assert (out.session_id, out.tokens, out.kept, out.bucket, out.nbytes) \
        == (entry.session_id, entry.tokens, entry.kept, entry.bucket,
            entry.nbytes)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(entry, name), getattr(out, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(_bits(a), _bits(b))
    if direction == "jax_to_torch":
        want = torch.bfloat16 if tier == "bf16" else torch.int8
        assert out.k.dtype == want
    else:
        want = "bfloat16" if tier == "bf16" else "int8"
        assert out.k.dtype.name == want


@pytest.mark.parametrize("pkg", list(PKGS))
def test_truncated_and_corrupt_payloads_leave_both_pools_untouched(pkg):
    """Every malformed payload is refused by the port's deserializer (as
    by the JAX package's) before any pool is touched; an in-process
    ``router.migrate_recv=corrupt`` transfer is refused by the target and
    leaves the source's entry in place, bytes exact."""
    from fasttalk_tpu.router import migrate as jmig
    from fasttalk_tpu_torch.router import migrate as tmig

    data = tmig.serialize_parked(_bf16_entry("torch"))
    hdr_end = 5 + 4 + int.from_bytes(data[5:9], "little")
    bad_dtype = data.replace(b'"bfloat16"', b'"bfloat17"')
    bad = [b"not an entry", data[:len(data) // 2], data[:hdr_end - 3],
           data[:-1], bad_dtype, b"FTKV1" + b"\xff\xff\xff\x7f{}"]
    for blob in bad:
        for mod in (jmig, tmig):
            with pytest.raises(ValueError):
                mod.deserialize_parked(blob)

    ns = _ns(pkg)
    router, engines, handles = _fleet(ns)
    try:
        entry = _entry(ns, "s-c", n_tokens=128)
        engines[0].pool.put(entry)
        before = _pools(engines)
        ns.fp.activate("router.migrate_recv=corrupt;count=1")
        ok, nbytes, reason, kept = ns.migrate.transfer(
            handles[0], handles[1], "s-c")
        assert (ok, nbytes, kept) == (False, 0, 0)
        assert "corrupt entry refused" in reason
        assert _pools(engines) == before == [(1, entry.nbytes), (0, 0)]
        ns.fp.clear()
        # A refused import of an incoherent entry leaves the target empty.
        bad_entry = replace(entry, tokens=entry.tokens[:-1])
        assert not engines[1].import_parked_kv(bad_entry)
        assert _pools(engines) == before
    finally:
        ns.fp.clear()
        router.shutdown()


def test_router_modules_import_no_jax_and_no_ml_dtypes():
    """The port's router, its wire form and the fleet flight recorder
    import neither JAX nor ``ml_dtypes`` nor anything of the JAX package
    (the package-wide scan lives in tests/test_torch_engine.py)."""
    import ast
    import os

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "fasttalk_tpu_torch")
    files = [os.path.join(root, "router", f) for f in
             ("__init__.py", "replica.py", "policy.py", "migrate.py",
              "disagg.py", "router.py", "elastic.py")]
    files.append(os.path.join(root, "observability", "fleetflight.py"))
    for path in files:
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "ml_dtypes",
                                   "fasttalk_tpu"), (path, n)


def test_fleet_flight_recorder_bundles_a_failover_burst(tmp_path):
    """The port's fleet flight recorder writes one bundle for a burst of
    failovers, with the same sections as the JAX package's."""
    bundles = {}
    for pkg in PKGS:
        ns = _ns(pkg)
        ff = importlib.import_module(
            f"{PKGS[pkg]}.observability.fleetflight")
        events = importlib.import_module(f"{PKGS[pkg]}.observability.events")
        router, engines, _ = _fleet(ns)
        try:
            rec = ff.FleetFlightRecorder(
                router, enabled=True, base_dir=str(tmp_path / pkg),
                max_bundles=2, min_interval_s=0.0, failover_burst=2,
                window_s=60.0, inline=True)
            log = events.EventLog()
            rec.install(log)
            for i in range(2):
                log.emit("router_failover", severity="warning",
                         replica="r0", request=f"q{i}")
            rec.uninstall()
            assert rec.bundles_written == 1
            (bundle,) = list((tmp_path / pkg).iterdir())
            bundles[pkg] = sorted(
                str(p.relative_to(bundle)) for p in bundle.rglob("*")
                if p.is_file())
        finally:
            router.shutdown()
    assert bundles["torch"] == bundles["jax"]
    assert "manifest.json" in bundles["torch"]
    assert "router.json" in bundles["torch"]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_scaled_up_replica_builds_off_the_caller(pkg):
    """A scale-up runs the build function on the scaler's own thread, not
    on the caller's (the serving event loop keeps running while a replica
    is built)."""
    ns = _ns(pkg)
    router, _, _ = _fleet(ns, n=1)
    threads = []

    def build_replica(replica_id, role="mixed"):
        import threading

        threads.append(threading.current_thread().name)
        return ns.router.ReplicaHandle(replica_id, ns.Engine(), role=role)

    scaler = ns.router.ElasticScaler(
        router, build_replica, min_replicas=2, max_replicas=2,
        check_interval_s=0.01)
    try:
        scaler.start()
        deadline = time.monotonic() + 5.0
        while len(router.replicas) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(router.replicas) == 2
        assert threads == ["router-elastic"]
    finally:
        scaler.stop()
        router.shutdown()
