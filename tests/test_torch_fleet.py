"""The engine seams of the fleet router and the router-backed serving
surface of fasttalk_tpu_torch, held against the JAX package on the CPU.

- A parked entry moves between a JAX ``TPUEngine`` and a port
  ``TorchEngine`` carrying the same weights (``from_jax_params``) in both
  directions, through the ``/kv/parked`` wire form: trained tinychat,
  greedy, dense and paged. The next turn restores (``restored_total``
  moves) and gives the same tokens as the engine's own restored turn.
- ``import_parked_kv`` accepts and refuses what the JAX engine's does
  (int8 entry into a float cache, wrong ``num_kv_heads``, ``kept`` past
  ``max_len``, a row dtype of another tier, float rows into an int8
  cache), fits the rows to the layout with the same byte count, and
  copies them instead of aliasing the source's.
- ``prefill_only`` ends ``prefill_parked`` with the JAX engine's parked
  token count; a ``prefill`` replica refuses a decode stream, and
  ``prefill_only`` without a host pool is refused, with JAX's messages;
  an imported prefix is donated to the radix tree on restore with the
  JAX engine's tree and allocator counts, and a second session hits it.
- Two test-tiny replicas behind ``ServerLauncher`` with ``ROUTER_ENABLED``
  give the JAX launcher's ``/fleet``, ``/health`` fleet block, ``resumed``
  WS frame (a replica shut down mid-stream), ``/fleet/metrics`` router
  families and ``/kv/parked`` status codes.
- On the card (``gpu``, skipped here): a migrated entry's restore equals
  its never-migrated control.
"""

import asyncio
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer, load_tokenizer
from fasttalk_tpu_torch.kvcache.hostpool import ParkedKV
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import init_params
from tests._port_isolation import port_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
CKPT = os.path.join(ASSETS, "tinychat")
TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
MSG1 = [{"role": "user", "content": "my name is Ada."}]
FILLERS = ([{"role": "user", "content": "what color is the sky?"}],
           [{"role": "user", "content": "tell me about cats."}])
FOLLOW = "what is my name?"
COMMON = dict(num_slots=2, max_len=512, steps_per_call=8, spec_decode="off",
              shared_prefix=False, kv_park_ttl_s=600.0, kv_park_idle_s=0.0,
              kv_restore_min_tokens=8)


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


def _run(eng, params_cls, rid, sid, msgs, max_tokens=16, **kw):
    """The events of one greedy generation."""
    async def go():
        return [ev async for ev in eng.generate(rid, sid, msgs, params_cls(
            max_tokens=max_tokens, **GREEDY, **kw))]
    return asyncio.run(go())


def _text(events):
    return "".join(e["text"] for e in events if e["type"] == "token")


def _tinychat_pair(**kw):
    """(JAX TPUEngine, JAX GenerationParams, port TorchEngine): trained
    tinychat, float32 on the CPU, the port's weights carried over from the
    JAX engine's pytree."""
    import jax
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer as jax_tok
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.loader import load_params as jax_load
    from fasttalk_tpu_torch.models.loader import from_jax_params

    opts = dict(COMMON, **kw)
    jcfg = jax_cfg("tinychat", ASSETS)
    jparams = jax_load(jcfg, CKPT, jnp.float32)
    jeng = TPUEngine(jcfg, jparams, jax_tok(ASSETS, "tinychat",
                                            template=jcfg.chat_template),
                     dtype=jnp.float32, **opts)
    cfg = get_model_config("tinychat", ASSETS)
    teng = TorchEngine(cfg, from_jax_params(jax.tree.map(np.asarray,
                                                         jparams), "cpu"),
                       load_tokenizer(ASSETS, "tinychat",
                                      template=cfg.chat_template),
                       device="cpu", dtype=torch.float32, **opts)
    return jeng, JaxParams, teng


def _park(eng, params_cls, sid):
    """Session ``sid``'s first turn, then two fillers evict and park it.
    Returns the first turn's text."""
    reply = _text(_run(eng, params_cls, f"{sid}-1", sid, MSG1, 24))
    for i, msgs in enumerate(FILLERS):
        _run(eng, params_cls, f"{sid}-f{i}", f"{sid}-F{i}", msgs, 8)
    assert _wait(lambda: eng._kv_pool.parked_len(sid) > 0), sid
    return reply


# ---------------------------------------------------------------------
# A parked entry between the packages (trained tinychat, greedy)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_parked_entry_moves_between_the_packages_and_restores(layout):
    """Session A parks on the JAX engine and B on the port's (the same
    first turn); A's entry crosses to the port and B's to JAX through the
    wire form. Every second turn (A and B, on both engines) restores and
    gives the same tokens; the moved entries keep kept and bytes."""
    from fasttalk_tpu.router import migrate as jmig
    from fasttalk_tpu_torch.router import migrate as tmig

    jeng, jparams, teng = _tinychat_pair(kv_layout=layout,
                                         kv_host_budget_mb=64.0)
    engines = {"jax": (jeng, jparams), "torch": (teng, GenerationParams)}
    try:
        for eng, _ in engines.values():
            _pin_policy(eng)
            eng.start()
        first = {"jax": _park(jeng, jparams, "A"),
                 "torch": _park(teng, GenerationParams, "B")}
        assert first["jax"] == first["torch"] and first["jax"]
        to_port = tmig.deserialize_parked(jmig.serialize_parked(
            jeng.export_parked_kv("A")))
        to_jax = jmig.deserialize_parked(tmig.serialize_parked(
            teng.export_parked_kv("B")))
        assert teng.import_parked_kv(to_port)
        assert jeng.import_parked_kv(to_jax)
        assert teng.parked_kv_info("A") == jeng.parked_kv_info("A")
        assert jeng.parked_kv_info("B") == teng.parked_kv_info("B")
        imported = teng._kv_pool.get("A")
        assert imported.imported and imported.k.dtype == torch.float32
        follow = MSG1 + [{"role": "assistant", "content": first["jax"]},
                         {"role": "user", "content": FOLLOW}]
        texts = {}
        for pkg, (eng, params_cls) in engines.items():
            restored = eng.get_stats()["kv_host"]["restored_total"]
            for sid in ("A", "B"):
                evs = _run(eng, params_cls, f"{sid}-2", sid, follow, 24)
                assert evs[-1]["type"] == "done", evs[-1]
                assert evs[-1]["stats"]["prefill_tokens"] < \
                    evs[-1]["stats"]["prompt_tokens"]
                texts[(pkg, sid)] = _text(evs)
            assert eng.get_stats()["kv_host"]["restored_total"] \
                == restored + 2, pkg
        assert len(set(texts.values())) == 1 and texts[("jax", "A")], texts
    finally:
        for eng, _ in engines.values():
            eng.shutdown()


# ---------------------------------------------------------------------
# import_parked_kv against the JAX engine's (test-tiny, synthetic entries)
# ---------------------------------------------------------------------

def _tiny_pair(**kw):
    """(JAX TPUEngine, port TorchEngine) of test-tiny, float32, not
    started: ``import_parked_kv`` touches only the host pool."""
    import jax
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.llama import init_params as jax_init

    opts = dict(num_slots=2, max_len=256, kv_host_budget_mb=16.0,
                spec_decode="off", kv_park_idle_s=0.0)
    opts.update(kw)
    jcfg = jax_cfg("test-tiny")
    jeng = TPUEngine(jcfg, jax_init(jcfg, jax.random.PRNGKey(0)),
                     JaxBytes(), dtype=jnp.float32, **opts)
    teng = TorchEngine(TINY, init_params(TINY, torch.Generator()
                                         .manual_seed(0), torch.float32,
                                         "cpu"),
                       ByteTokenizer(), device="cpu", dtype=torch.float32,
                       **opts)
    return jeng, teng


def _synthetic(pkg, kept=40, rows=64, layers=None, kv_heads=None,
               dtype="float32", quantized=False, granule=1):
    """A parked entry for test-tiny's geometry (or the given one): numpy
    arrays for the JAX package, torch tensors for the port, equal values."""
    from fasttalk_tpu.kvcache.hostpool import ParkedKV as JaxParked

    rng = np.random.default_rng(kept + rows)
    shape = (layers or TINY.num_layers, rows, kv_heads or TINY.num_kv_heads,
             TINY.head_dim)
    scales = None
    if quantized:
        k = rng.integers(-127, 127, shape, dtype=np.int8)
        v = rng.integers(-127, 127, shape, dtype=np.int8)
        scales = [rng.random((shape[0], rows, granule), np.float32)
                  for _ in range(2)]
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    arrs = [k, v] + (scales or [None, None])
    if dtype == "bfloat16":
        import ml_dtypes

        arrs[:2] = [a.astype(ml_dtypes.bfloat16) for a in arrs[:2]]
    nbytes = sum(a.nbytes for a in arrs if a is not None)
    if pkg == "torch":
        def t(a):
            if a is None:
                return None
            if a.dtype.name == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            return torch.from_numpy(a)
        arrs = [t(a) for a in arrs]
        cls = ParkedKV
    else:
        cls = JaxParked
    return cls(session_id="S", tokens=list(range(kept)), kept=kept,
               bucket=rows, k=arrs[0], v=arrs[1], k_scale=arrs[2],
               v_scale=arrs[3], nbytes=nbytes)


IMPORT_CASES = {
    # name: (engine options, entry options, accepted)
    "dense": ({}, {}, True),
    "dense_pads_to_the_bucket": ({}, dict(kept=40, rows=48), True),
    "paged_trims_to_blocks": (dict(kv_layout="paged"), {}, True),
    "int8_into_a_float_cache": ({}, dict(quantized=True), False),
    "wrong_num_kv_heads": ({}, dict(kv_heads=TINY.num_kv_heads + 1), False),
    "wrong_num_layers": ({}, dict(layers=TINY.num_layers + 3), False),
    "kept_past_max_len": ({}, dict(kept=600, rows=1024), False),
    "bf16_rows_into_a_float32_cache": ({}, dict(dtype="bfloat16"), False),
    "float_rows_into_an_int8_cache": (dict(kv_quant="int8"), {}, False),
    "int8_rows_into_an_int8_cache": (dict(kv_quant="int8"),
                                     dict(quantized=True), True),
}


@pytest.mark.parametrize("case", list(IMPORT_CASES))
def test_import_accepts_and_refuses_what_jax_does(case):
    eng_kw, entry_kw, accepted = IMPORT_CASES[case]
    jeng, teng = _tiny_pair(**eng_kw)
    try:
        jentry = _synthetic("jax", **entry_kw)
        tentry = _synthetic("torch", **entry_kw)
        assert jeng.import_parked_kv(jentry) is accepted
        assert teng.import_parked_kv(tentry) is accepted
        if not accepted:
            assert teng._kv_pool.stats()["sessions"] == 0
            assert teng._kv_pool.stats()["bytes"] == 0
            return
        got, want = teng._kv_pool.get("S"), jeng._kv_pool.get("S")
        assert (got.kept, got.bucket, got.nbytes, got.imported) \
            == (want.kept, want.bucket, want.nbytes, want.imported)
        assert teng._kv_pool.stats()["bytes"] \
            == jeng._kv_pool.stats()["bytes"]
        assert tuple(got.k.shape) == tuple(np.asarray(want.k).shape)
        # The rows are the pool's own: the source's tensors are not
        # aliased, and the trusted rows are the entry's.
        assert got.k.data_ptr() != tentry.k.data_ptr()
        n = min(got.k.shape[1], tentry.k.shape[1])
        assert torch.equal(got.k[:, :n], tentry.k[:, :n])
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    finally:
        jeng.shutdown()
        teng.shutdown()


# ---------------------------------------------------------------------
# prefill_only, roles and the radix donation (trained tinychat)
# ---------------------------------------------------------------------

def test_prefill_only_parks_the_prompt_as_jax_does():
    """A ``prefill_only`` request ends ``prefill_parked`` with no token and
    parks the prompt's rows (the same kept tokens and bytes as the JAX
    engine's); a prefill-role engine refuses a decode stream and an engine
    without a pool refuses ``prefill_only``, with the JAX messages."""
    from fasttalk_tpu.utils.errors import LLMServiceError as JaxError
    from fasttalk_tpu_torch.utils.errors import LLMServiceError

    jeng, jparams, teng = _tinychat_pair(kv_host_budget_mb=64.0)
    nopool_j, _, nopool_t = _tinychat_pair(kv_host_budget_mb=0.0)
    engines = {"jax": (jeng, jparams, nopool_j, JaxError),
               "torch": (teng, GenerationParams, nopool_t, LLMServiceError)}
    got = {}
    try:
        for pkg, (eng, params_cls, nopool, err_cls) in engines.items():
            for e in (eng, nopool):
                e.start()
            evs = _run(eng, params_cls, "p1", "P", MSG1, prefill_only=True)
            assert [e["type"] for e in evs] == ["done"], evs
            assert evs[-1]["finish_reason"] == "prefill_parked"
            assert _wait(lambda: eng.parked_kv_info("P") is not None)
            eng.role = "prefill"
            with pytest.raises(err_cls) as decode:
                _run(eng, params_cls, "p2", "Q", MSG1)
            with pytest.raises(err_cls) as no_pool:
                _run(nopool, params_cls, "p3", "R", MSG1, prefill_only=True)
            got[pkg] = (evs[-1]["stats"]["prompt_tokens"],
                        eng.parked_kv_info("P"), str(decode.value),
                        decode.value.category.value, str(no_pool.value),
                        no_pool.value.category.value)
    finally:
        for eng, _, nopool, _ in engines.values():
            eng.shutdown()
            nopool.shutdown()
    assert got["torch"] == got["jax"]
    assert got["torch"][1][0] == got["torch"][0]   # every prompt row kept


def test_imported_prefix_is_donated_to_the_radix_tree_as_jax_does():
    """The disaggregated handoff in one package at a time: a prefill-role
    engine runs ``prefill_only`` of a long prompt, its parked entry moves
    to a paged radix engine, whose turn restores it and donates its blocks
    to the tree; a second session with the same prompt then hits it. The
    tree's and the allocator's counts equal the JAX engines'."""
    long_msg = [{"role": "user", "content": " ".join(
        f"fact {i}: the lighthouse keeper counts ship {i}." for i in
        range(12))}]
    radix = dict(kv_layout="paged", kv_radix=True, kv_host_budget_mb=64.0)
    pre_j, jparams, pre_t = _tinychat_pair(**radix)
    dec_j, _, dec_t = _tinychat_pair(**radix)
    pairs = {"jax": (pre_j, dec_j, jparams),
             "torch": (pre_t, dec_t, GenerationParams)}
    got = {}
    try:
        for pkg, (pre, dec, params_cls) in pairs.items():
            for e in (pre, dec):
                _pin_policy(e)
                e.start()
            pre.role = "prefill"
            evs = _run(pre, params_cls, "h1", "H", long_msg,
                       prefill_only=True)
            assert evs[-1]["finish_reason"] == "prefill_parked"
            assert _wait(lambda: pre.parked_kv_info("H") is not None)
            assert dec.import_parked_kv(pre.export_parked_kv("H"))
            assert dec._kv_pool.get("H").imported
            before = dec.get_stats()
            first = _run(dec, params_cls, "h2", "H", long_msg, 16)
            mid = dec.get_stats()
            second = _run(dec, params_cls, "h3", "H2", long_msg, 16)
            after = dec.get_stats()
            got[pkg] = {
                "texts": (_text(first), _text(second)),
                "restored": mid["kv_host"]["restored_total"]
                - before["kv_host"]["restored_total"],
                "inserted": mid["kv_radix"]["inserted_blocks"]
                - before["kv_radix"]["inserted_blocks"],
                "hit_tokens": after["kv_radix"]["hit_tokens"]
                - mid["kv_radix"]["hit_tokens"],
                "tree": {k: after["kv_radix"][k] for k in
                         ("nodes", "blocks", "hits", "inserted_blocks")},
                "blocks": {k: after["kv_blocks"][k] for k in
                           ("in_use", "free", "aliased")
                           if k in after["kv_blocks"]},
                "prefill": (first[-1]["stats"]["prefill_tokens"],
                            second[-1]["stats"]["prefill_tokens"])}
            dec._kv_radix.check_integrity()
    finally:
        for pre, dec, _ in pairs.values():
            pre.shutdown()
            dec.shutdown()
    assert got["torch"] == got["jax"]
    assert got["torch"]["restored"] == 1
    assert got["torch"]["inserted"] > 0 and got["torch"]["hit_tokens"] > 0


# ---------------------------------------------------------------------
# The router-backed serving surface (test-tiny behind ServerLauncher)
# ---------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _runs(types: list[str]) -> list[str]:
    """Frame types with repeats collapsed (token, token -> token)."""
    out: list[str] = []
    for t in types:
        if not out or out[-1] != t:
            out.append(t)
    return out


async def _fleet_surface(launcher, entry_bytes: bytes) -> dict:
    """Drive one launcher's server: /fleet, /health, two WS streams with
    the first one's replica shut down mid-stream, /fleet/metrics and the
    /kv/parked status codes."""
    from aiohttp.test_utils import TestClient, TestServer

    router = launcher.engine
    launcher.verify_backend()
    client = TestClient(TestServer(launcher.server.app))
    await client.start_server()
    out: dict = {}
    try:
        fleet0 = await (await client.get("/fleet")).json()
        out["fleet_before"] = [
            {k: r[k] for k in ("replica_id", "role", "state", "draining",
                               "drain_error", "placements", "failovers")}
            for r in fleet0["replicas"]]
        out["health_before"] = (await (await client.get(
            "/health")).json())["fleet"]
        frames: list[list[dict]] = [[], []]
        sockets = []
        for i in range(2):
            ws = await client.ws_connect("/ws/llm")
            assert json.loads((await ws.receive()).data)["type"] \
                == "session_started"
            await ws.send_json({"type": "start_session", "config": {
                "max_tokens": 300, "ignore_eos": True, **GREEDY}})
            await ws.receive()
            sockets.append(ws)

        async def pump(i):
            await sockets[i].send_json({"type": "user_message",
                                        "text": f"stream {i}"})
            while True:
                f = json.loads((await sockets[i].receive(timeout=60)).data)
                frames[i].append(f)
                if f["type"] in ("response_complete", "error"):
                    return

        tasks = [asyncio.ensure_future(pump(0))]
        # The kill lands at one fixed point in both packages' runs: once
        # stream 0 has its first token and the router its route, and with
        # the event loop held until the engine is down. The router then
        # handles the aborted stream against a backend that is already
        # unreachable, so the replica is marked dead on that failure in
        # every run (shutting down from an executor let a loaded run see
        # the backend still up and leave the replica alive).
        deadline = time.monotonic() + 120
        while not (any(f["type"] == "token" for f in frames[0])
                   and router._routes):
            assert time.monotonic() < deadline, "stream 0 never started"
            await asyncio.sleep(0.005)
        victim = next(h for _, h in router._routes.values())
        victim.engine.shutdown()
        tasks.append(asyncio.ensure_future(pump(1)))
        await asyncio.gather(*tasks)
        out["frames"] = [_runs([f["type"] for f in fr]) for fr in frames]
        out["resumed"] = [{k: v for k, v in f.items()}
                          for fr in frames for f in fr
                          if f["type"] == "resumed"]
        out["killed"] = victim.replica_id
        health = await client.get("/health")
        out["health_after"] = (health.status,
                               (await health.json()).get("status"))
        router.probe_once()
        fleet = (await (await client.get("/health")).json())["fleet"]
        out["health_fleet"] = {k: fleet[k] for k in (
            "replicas", "available", "dead", "draining", "placements",
            "failovers", "resumes", "sheds", "migrations")}
        text = await (await client.get("/fleet/metrics")).text()
        out["router_families"] = sorted(
            line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE router_"))
        out["router_label"] = 'replica="router"' in text
        codes = {}
        for name, method, path, kw in (
                ("get", "get", "/kv/parked/nobody", {}),
                ("meta", "get", "/kv/parked/nobody?meta=1", {}),
                ("garbage", "post", "/kv/parked/x", {"data": b"garbage"}),
                ("other_session", "post", "/kv/parked/y",
                 {"data": entry_bytes}),
                ("refused", "post", "/kv/parked/x", {"data": entry_bytes}),
                ("delete", "delete", "/kv/parked/nobody", {})):
            codes[name] = (await getattr(client, method)(path, **kw)).status
        out["kv_codes"] = codes
        for ws in sockets:
            await ws.close()
    finally:
        await client.close()
        router.shutdown()
    return out


def _forget_router_families(registry) -> None:
    """Drop the ``router_*`` registrations that earlier tests of this
    process left in a package's process-wide registry: its reset zeroes
    every metric but keeps it registered, so an ``ElasticScaler`` built
    by another test file on the same worker (tests/test_disagg.py,
    tests/test_fleet_fabric.py) leaves ``router_scale_*`` behind in one
    package's ``/fleet/metrics`` and not the other's. Router metrics
    belong to router and scaler instances (none is cached by a module),
    so each launcher built here registers its own afresh."""
    with registry._lock:
        for name in [n for n in registry._metrics
                     if n.startswith("router_")]:
            del registry._metrics[name]


def test_fleet_launchers_serve_the_same_surface_as_jax(monkeypatch,
                                                       tmp_path):
    from fasttalk_tpu.serving.launcher import ServerLauncher as JaxLauncher
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.router.migrate import serialize_parked
    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in {"LLM_MODEL": "test-tiny", "MODEL_PATH": "",
                 "WEIGHT_QUANT": "off", "TPU_DTYPE": "float32",
                 "TPU_DECODE_SLOTS": "2", "TPU_MAX_MODEL_LEN": "512",
                 "DEFAULT_CONTEXT_WINDOW": "512", "TPU_DECODE_STEPS": "4",
                 "TPU_SPEC_DECODE": "off", "TPU_WARMUP": "off",
                 "ENABLE_PYDANTIC_AI": "false", "ROUTER_ENABLED": "true",
                 "FLEET_REPLICAS": "2", "ROUTER_PROBE_INTERVAL_S": "0",
                 "KV_MIGRATE_HTTP": "true", "KV_HOST_BUDGET_MB": "16",
                 "FLEET_FLIGHT_DIR": str(tmp_path / "fleet"),
                 "LLM_HOST": "127.0.0.1", "LLM_MONITORING_HOST": "127.0.0.1",
                 "LLM_PORT": str(_free_port()),
                 "LLM_MONITORING_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    entry = serialize_parked(_synthetic("torch"))
    entry = entry.replace(b'"session_id": "S"', b'"session_id": "x"')
    from fasttalk_tpu.utils.metrics import get_metrics as jax_metrics
    from fasttalk_tpu_torch.utils.metrics import get_metrics

    got = {}
    for pkg, registry, launcher in (
            ("jax", jax_metrics, lambda: JaxLauncher(JaxConfig())),
            ("torch", get_metrics,
             lambda: ServerLauncher(Config(), device="cpu"))):
        _forget_router_families(registry())
        lau = launcher()
        assert type(lau.engine).__name__ == "FleetRouter"
        assert lau.agent is None
        got[pkg] = asyncio.run(asyncio.wait_for(
            _fleet_surface(lau, entry), 240))
    assert got["torch"] == got["jax"]
    out = got["torch"]
    assert out["frames"] == [["token", "resumed", "token",
                              "response_complete"],
                             ["token", "response_complete"]]
    assert out["health_after"] == (200, "degraded")
    assert out["health_fleet"]["dead"] == 1
    assert "router_resumes_total" in out["router_families"]
    assert out["kv_codes"] == {"get": 404, "meta": 404, "garbage": 400,
                               "other_session": 400, "refused": 409,
                               "delete": 404}


def test_cli_websocket_builds_a_fleet_with_the_agent_over_it(monkeypatch):
    """``ROUTER_ENABLED=true FLEET_REPLICAS=2 python -m fasttalk_tpu_torch
    websocket`` serves through a FleetRouter of two TorchEngines, the
    agent built over the router as in the JAX package (its start is
    stubbed here)."""
    from fasttalk_tpu_torch import __main__ as cli
    from fasttalk_tpu_torch.agents.voice_agent import VoiceAgent
    from fasttalk_tpu_torch.router import FleetRouter
    from fasttalk_tpu_torch.serving import launcher as launcher_mod

    for k in ("ENABLE_PYDANTIC_AI", "ENABLE_TOOLS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in {"LLM_MODEL": "test-tiny", "MODEL_PATH": "",
                 "WEB_SEARCH_BACKEND": "offline", "TPU_DECODE_SLOTS": "2",
                 "TPU_MAX_MODEL_LEN": "256", "ROUTER_ENABLED": "true",
                 "FLEET_REPLICAS": "2", "FLEET_SCALE_MAX": "3"}.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(launcher_mod.ServerLauncher, "start",
                        lambda self: seen.append(self))
    assert cli.main(["websocket", "--device", "cpu"]) == 0
    (launcher,) = seen
    router = launcher.engine
    try:
        assert isinstance(router, FleetRouter)
        assert [type(h.engine).__name__ for h in router.replicas] \
            == ["TorchEngine", "TorchEngine"]
        assert [h.replica_id for h in router.replicas] \
            == ["inproc-0", "inproc-1"]
        assert isinstance(launcher.agent, VoiceAgent)
        assert launcher.agent.engine is router
        assert launcher.server.fleet_flight is not None
        assert launcher.scaler is not None and launcher.scaler.max_replicas \
            == 3
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------

@pytest.mark.gpu
def test_migrated_entry_restores_on_the_card_as_its_control():
    """Trained tinychat, bf16 on the card, dense and paged: a session's
    entry parked on one engine moves to another through the wire form
    (into the target's pinned rows) and its next turn there restores and
    equals the never-migrated turn of a third engine, token for token."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest "
                    "tests/test_torch_fleet.py -m gpu --noconftest` on the "
                    "GPU machine")
    from fasttalk_tpu_torch.models.loader import load_params
    from fasttalk_tpu_torch.router.migrate import (deserialize_parked,
                                                   serialize_parked)

    cfg = get_model_config("tinychat", ASSETS)
    params = load_params(cfg, CKPT, torch.bfloat16, "cuda")
    tok = load_tokenizer(ASSETS, "tinychat", template=cfg.chat_template)
    follow = None
    for layout in ("dense", "paged"):
        def engine(budget):
            return TorchEngine(cfg, params, tok, device="cuda",
                               dtype=torch.bfloat16, kv_layout=layout,
                               kv_host_budget_mb=budget, **COMMON)
        src, dst, ctl = engine(64.0), engine(64.0), engine(0.0)
        try:
            for e in (src, dst, ctl):
                if e._kv_pool.enabled:
                    _pin_policy(e)
                e.start()
            reply = _park(src, GenerationParams, "A")
            ctl_reply = _text(_run(ctl, GenerationParams, "c1", "A", MSG1,
                                   24))
            assert ctl_reply == reply
            entry = deserialize_parked(serialize_parked(
                src.export_parked_kv("A")))
            assert dst.import_parked_kv(entry)
            assert dst._kv_pool.get("A").k.is_pinned()
            follow = MSG1 + [{"role": "assistant", "content": reply},
                             {"role": "user", "content": FOLLOW}]
            got = _run(dst, GenerationParams, "a2", "A", follow, 24)
            want = _run(ctl, GenerationParams, "c2", "A", follow, 24)
            assert dst.get_stats()["kv_host"]["restored_total"] == 1
            assert got[-1]["type"] == want[-1]["type"] == "done"
            assert _text(got) == _text(want) and _text(got), layout
        finally:
            for e in (src, dst, ctl):
                e.shutdown()
