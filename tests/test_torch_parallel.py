"""The port's mesh, sharding, collectives and ring attention held against
the JAX package's ``fasttalk_tpu/parallel`` on the CPU.

In process: ``MeshSpec`` / ``best_mesh_shape``, the rank-to-coordinate
layout of the mesh, every ``validate_*`` message, and each leaf's local
shard, bit for bit equal to the JAX array's addressable shard at the same
mesh coordinates (JAX's 8 host CPU devices, tests/conftest.py); the
sharded random init and loader give the bytes of quantizing the whole
model and cutting it; the prepared cache keys its shards by mesh and rank.

Across processes: one 4-rank gloo world (tests/_torch_ranks.py
``model``) computes tp = 2 and dp = 2 x tp = 2 prefill and decode logits
of test-tiny (the JAX init) and tinychat (the JAX load), float32 and the
JAX int8 quantization, cut to each rank's shards, and the ring and sharded decode attention at
sp = 4 and dp = 2 x sp = 2. Logits are held to the JAX mesh forward to
2e-3 (absolute and relative), the tolerance of the JAX package's own
mesh-against-single-device tests (tests/test_parallel.py); attention to
1e-5. Every tp (and sp) peer must hold the same bits. tinychat int8 with
bf16 activations at tp = 2 is held to the port's own single rank: the
same greedy tokens, logits within a quarter of one bf16 step.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fasttalk_tpu.models import llama as jllama
from fasttalk_tpu.models.configs import get_model_config as jax_model_config
from fasttalk_tpu.ops.quant import quantize_params as jax_quantize_params
from fasttalk_tpu.parallel import mesh as jmesh
from fasttalk_tpu.parallel import sharding as jsharding
from fasttalk_tpu_torch.models.loader import from_jax_params
from fasttalk_tpu_torch.parallel import mesh as tmesh
from fasttalk_tpu_torch.parallel import sharding as tsharding
from tests._torch_ranks import ASSETS, spawn

LOGIT_TOL = 2e-3   # atol and rtol: the JAX mesh tests' own tolerance
ATTN_TOL = 1e-5
# tp = 2 against one rank, bf16 activations: a quarter of one bf16 step at
# logits in [8, 16).
TP_ROUNDING_TOL = 1 / 64


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# ------------------------------------------------------------ in process


@pytest.mark.parametrize("n,kw", [(1, {}), (2, {}), (4, {}), (8, {}),
                                  (16, {}), (16, {"want_sp": True}),
                                  (4, {"model_kv_heads": 2}),
                                  (12, {"want_sp": True})])
def test_best_mesh_shape_matches_jax(n, kw):
    want = jmesh.best_mesh_shape(n, **kw)
    got = tmesh.best_mesh_shape(n, **kw)
    assert (got.dp, got.sp, got.tp) == (want.dp, want.sp, want.tp)
    assert got.size == want.size and tmesh.AXES == jmesh.AXES


def test_mesh_coordinates_and_size_check_match_jax():
    """Rank r sits where JAX's mesh puts device r, and a mesh larger than
    the world fails with JAX's message."""
    for dp, sp, tp in ((2, 1, 2), (1, 2, 2), (2, 2, 2), (1, 4, 1)):
        jm = jmesh.make_mesh(dp=dp, sp=sp, tp=tp)
        spec = tmesh.MeshSpec(dp=dp, sp=sp, tp=tp)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for rank in range(spec.size):
            m = tmesh.Mesh(spec, rank)
            assert ids[m.coords["dp"], m.coords["sp"], m.coords["tp"]] \
                == jax.devices()[rank].id
            assert m.shape == dict(jm.shape)
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(tp=2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(tp=2)   # no process group: a world of one rank
    assert str(got.value) == str(want.value)


def test_backend_follows_every_ranks_card():
    """The backend comes from the cards of the whole world (exchanged at
    the rendezvous), never from an environment count: nccl when every
    rank has a card of its own, across hosts too; gloo when a rank is on
    the CPU or two ranks share a card."""
    from fasttalk_tpu_torch.parallel.distributed import choose_backend

    two_hosts = [f"GPU-host{h}-card{c}" for h in range(2) for c in range(8)]
    assert choose_backend(two_hosts) == (
        "nccl", "each of the 16 ranks has a card of its own")
    assert choose_backend(["GPU-a", "GPU-a"]) == (
        "gloo", "ranks 0 and 1 share card GPU-a")
    assert choose_backend(two_hosts[:3] + [two_hosts[1]])[0] == "gloo"
    assert choose_backend([None, None]) == ("gloo", "ranks [0, 1] have no "
                                            "card")
    assert choose_backend(["GPU-a", None])[0] == "gloo"


def test_maybe_initialize_and_process_info_follow_jax(monkeypatch):
    """No coordinator configured: nothing starts and ``process_info`` has
    JAX's keys for one process. Configured, a rendezvous that fails is
    fatal; one that succeeds brings the group up (a world of one rank
    here, gloo on the CPU) and a mesh over it."""
    import torch.distributed as dist

    from fasttalk_tpu.parallel import distributed as jdist
    from fasttalk_tpu_torch.parallel import distributed as tdist
    from tests._torch_ranks import free_ports

    for name in ("TPU_COORDINATOR_ADDR", "TPU_NUM_PROCESSES",
                 "TPU_PROCESS_ID", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.maybe_initialize() is False
    info = tdist.process_info()
    assert info.keys() == jdist.process_info().keys()
    assert info == {"process_index": 0, "process_count": 1,
                    "global_device_count": 1, "local_device_count": 1,
                    "initialized": False}
    assert tdist.rank_device() == torch.device("cpu") \
        and tdist.card_id(tdist.rank_device()) is None
    import socket

    with socket.socket() as busy:   # the coordinator's port is taken
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        monkeypatch.setenv("TPU_COORDINATOR_ADDR",
                           f"127.0.0.1:{busy.getsockname()[1]}")
        monkeypatch.setenv("TPU_NUM_PROCESSES", "2")
        monkeypatch.setenv("TPU_PROCESS_ID", "0")
        with pytest.raises(Exception):
            tdist.maybe_initialize()
    assert not dist.is_initialized()
    (port,) = free_ports(1)
    monkeypatch.setenv("TPU_COORDINATOR_ADDR", f"127.0.0.1:{port}")
    monkeypatch.setenv("TPU_NUM_PROCESSES", "1")
    try:
        assert tdist.maybe_initialize() is True
        assert tdist.process_info()["initialized"] is True
        mesh = tmesh.make_mesh()
        assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1}
        assert mesh.backend == "gloo"
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            tmesh.make_mesh(dp=2)
    finally:
        tdist.shutdown()
    assert not dist.is_initialized()


VALIDATE_CASES = [
    ("tp", dict(tp=16, num_kv_heads=8, num_heads=32, hidden=2048,
                intermediate=8192)),
    ("tp", dict(tp=3, num_kv_heads=6, num_heads=24, hidden=2048,
                intermediate=8192)),
    ("tp", dict(tp=4, num_kv_heads=8, num_heads=32, hidden=2048,
                intermediate=8192, vocab=1001)),
    ("tp", dict(tp=4, num_kv_heads=8, num_heads=32, hidden=2048,
                intermediate=8192)),
    ("int4", dict(tp=4, q_dim=2048, intermediate=8192, group=128)),
    ("int4", dict(tp=8, q_dim=24, intermediate=8192, group=4)),
    ("int4", dict(tp=4, q_dim=1024, intermediate=8192, group=512)),
    ("mesh", dict(dp=3, sp=1, tp=2)),
    ("mesh", dict(dp=1, sp=3, tp=2)),
    ("mesh", dict(dp=1, sp=1, tp=3)),
    ("mesh", dict(dp=2, sp=2, tp=2)),
]


@pytest.mark.parametrize("kind,kw", VALIDATE_CASES)
def test_validate_messages_match_jax(kind, kw):
    def run(mod, mesh_of):
        try:
            if kind == "tp":
                kw2 = dict(kw)
                mod.validate_tp(kw2.pop("tp"), **kw2)
            elif kind == "int4":
                kw2 = dict(kw)
                mod.validate_int4_tp(kw2.pop("tp"), **kw2)
            else:
                mod.validate_mesh(mesh_of(), num_kv_heads=8, num_heads=32,
                                  hidden=2048, intermediate=8192,
                                  vocab=128256, num_slots=8, max_len=2048)
        except ValueError as e:
            return str(e)
        return None

    want = run(jsharding, lambda: jmesh.make_mesh(**kw))
    got = run(tsharding, lambda: tmesh.Mesh(tmesh.MeshSpec(**kw), 0))
    assert got == want


@functools.lru_cache(maxsize=None)
def _jax_params(name, quant):
    cfg = jax_model_config(name, ASSETS)
    if name == "tinychat":
        from fasttalk_tpu.models.loader import load_params

        params = load_params(cfg, os.path.join(ASSETS, "tinychat"),
                             jnp.float32)
    else:
        params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    if quant == "int8":
        params = jax_quantize_params(params)
    elif quant == "int4":
        from fasttalk_tpu.quantization.int4 import quantize_params_int4

        params = quantize_params_int4(params, group=16)
    return cfg, params


@pytest.mark.parametrize("quant", ["f32", "int8", "int4"])
@pytest.mark.parametrize("dp,sp,tp", [(1, 1, 2), (2, 1, 2), (1, 2, 2)])
def test_local_shards_equal_jax_addressable_shards(quant, dp, sp, tp):
    _, params = _jax_params("test-tiny", quant)
    jm = jmesh.make_mesh(dp=dp, sp=sp, tp=tp)
    sharded = jsharding.shard_params(params, jm)
    full = from_jax_params(jax.tree.map(np.asarray, params), "cpu")
    spec = tmesh.MeshSpec(dp=dp, sp=sp, tp=tp)
    jleaves = dict(_leaves(sharded))
    for rank in range(spec.size):
        mine = dict(_leaves(tsharding.shard_params(
            full, tmesh.Mesh(spec, rank))))
        assert mine.keys() == jleaves.keys()
        dev = jax.devices()[rank]
        for key, arr in jleaves.items():
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            want = np.asarray(shard.data)
            got = mine[key]
            if got.dtype == torch.bfloat16:
                got = got.view(torch.int16)
                want = want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)


@pytest.mark.parametrize("dp,sp,tp", [(2, 1, 2), (1, 2, 2), (2, 2, 1)])
def test_cache_local_shape_matches_jax_shard(dp, sp, tp):
    cfg = jax_model_config("test-tiny")
    jm = jmesh.make_mesh(dp=dp, sp=sp, tp=tp)
    cache = jsharding.shard_cache(jllama.init_cache(cfg, 4, 64, jnp.float32),
                                  jm)
    want = cache.k.addressable_shards[0].data.shape
    got = tsharding.cache_local_shape(cfg.num_layers, 4, 64,
                                      cfg.num_kv_heads, cfg.head_dim,
                                      tmesh.Mesh(tmesh.MeshSpec(
                                          dp=dp, sp=sp, tp=tp), 0))
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sharded_init_equals_cutting_the_whole_init(quant):
    """Each rank draws, quantizes and cuts one layer at a time: its shard
    holds the bytes of quantizing the whole model, then cutting it (the
    JAX package's quantize-after-shard equals quantize-before)."""
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import init_params_device

    cfg = get_model_config("test-tiny")
    whole = init_params_device(cfg, torch.float32, "cpu", quantize=quant,
                               seed=3, rows_per_chunk=100)
    spec = tmesh.MeshSpec(dp=1, sp=1, tp=2)
    for rank in range(2):
        mesh = tmesh.Mesh(spec, rank)
        local = dict(_leaves(init_params_device(
            cfg, torch.float32, "cpu", quantize=quant, seed=3,
            rows_per_chunk=100, mesh=mesh)))
        cut = dict(_leaves(tsharding.shard_params(whole, mesh)))
        assert local.keys() == cut.keys()
        for key, t in cut.items():
            assert local[key].dtype == t.dtype and torch.equal(local[key], t), \
                key


def test_sharded_loader_equals_jax_shards_and_the_whole_load():
    """The tinychat checkpoint loaded straight into float32 shards equals
    the JAX load's addressable shards, bit for bit; loaded into int8
    shards it equals the port's whole int8 load cut at the same
    coordinates (the whole int8 load is held to JAX's by the int8 tests,
    up to the pinned one-ulp difference of jitted JAX scales)."""
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params

    _, params = _jax_params("tinychat", "f32")
    jm = jmesh.make_mesh(tp=2)
    jleaves = dict(_leaves(jsharding.shard_params(params, jm)))
    cfg = get_model_config("tinychat", ASSETS)
    ckpt = os.path.join(ASSETS, "tinychat")
    whole8 = load_params(cfg, ckpt, torch.float32, "cpu", quantize="int8")
    for rank in range(2):
        mesh = tmesh.Mesh(tmesh.MeshSpec(tp=2), rank)
        mine = dict(_leaves(load_params(cfg, ckpt, torch.float32, "cpu",
                                        mesh=mesh)))
        dev = jax.devices()[rank]
        for key, arr in jleaves.items():
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(mine[key].numpy(),
                                          np.asarray(shard.data),
                                          err_msg=key)
        mine8 = dict(_leaves(load_params(cfg, ckpt, torch.float32, "cpu",
                                         quantize="int8", mesh=mesh)))
        for key, t in _leaves(tsharding.shard_params(whole8, mesh)):
            assert torch.equal(mine8[key], t), key


def test_prepared_cache_round_trip_sharded(tmp_path):
    """Each rank's shards restore from a cache keyed by the mesh and the
    rank; another mesh shape or rank is another cache (JAX
    ``test_prepared_cache_roundtrip_sharded``)."""
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import init_params_device
    from fasttalk_tpu_torch.models.prepared_cache import (cache_meta,
                                                          load_prepared,
                                                          save_prepared)

    cfg = get_model_config("test-tiny")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model.safetensors").write_bytes(b"x")
    spec = tmesh.MeshSpec(tp=2)
    for rank in range(2):
        mesh = tmesh.Mesh(spec, rank)
        params = init_params_device(cfg, torch.float32, "cpu",
                                    quantize="int8", mesh=mesh)
        meta = cache_meta(cfg, torch.float32, "int8", str(ckpt), mesh=mesh)
        assert meta["mesh"] == {"dp": 1, "sp": 1, "tp": 2, "rank": rank}
        assert save_prepared(params, str(tmp_path), meta, block=True)
    for rank in range(2):
        mesh = tmesh.Mesh(spec, rank)
        back = load_prepared(cfg, str(tmp_path), torch.float32, "int8",
                             str(ckpt), device="cpu", mesh=mesh)
        want = init_params_device(cfg, torch.float32, "cpu",
                                  quantize="int8", mesh=mesh)
        assert back["layers"]["wq"]["q"].shape[-1] == cfg.q_dim // 2
        for key, t in _leaves(want):
            got = dict(_leaves(back))[key]
            assert torch.equal(got, t), key
    assert load_prepared(cfg, str(tmp_path), torch.float32, "int8",
                         str(ckpt), device="cpu",
                         mesh=tmesh.Mesh(tmesh.MeshSpec(tp=4), 0)) is None
    assert load_prepared(cfg, str(tmp_path), torch.float32, "int8",
                         str(ckpt), device="cpu") is None


# ------------------------------------------------------- the 4-rank world

MODELS = ("tiny", "chat")


def _inputs():
    rs = np.random.RandomState(7)
    flat = {}
    for model, name in (("tiny", "test-tiny"), ("chat", "tinychat")):
        for quant in ("f32", "int8"):
            _, params = _jax_params(name, quant)
            flat.update({f"{model}/{quant}/{k}": np.asarray(v)
                         for k, v in _leaves(params)})
    cfg = jax_model_config("test-tiny")
    chat = jax_model_config("tinychat", ASSETS)
    return {
        **flat,
        "tiny_tokens": rs.randint(0, cfg.vocab_size, (4, 16)).astype(np.int64),
        "tiny_dec": rs.randint(0, cfg.vocab_size, (4,)).astype(np.int64),
        "chat_tokens": rs.randint(0, chat.vocab_size,
                                  (4, 16)).astype(np.int64),
        "chat_dec": rs.randint(0, chat.vocab_size, (4,)).astype(np.int64),
        "ring_q": rs.randn(2, 64, 4, 16).astype(np.float32),
        "ring_k": rs.randn(2, 64, 2, 16).astype(np.float32),
        "ring_v": rs.randn(2, 64, 2, 16).astype(np.float32),
        "ring_pos": np.broadcast_to(np.arange(64), (2, 64)).astype(np.int64),
        "dec_q": rs.randn(2, 3, 4, 16).astype(np.float32),
        "dec_k": rs.randn(2, 64, 2, 16).astype(np.float32),
        "dec_v": rs.randn(2, 64, 2, 16).astype(np.float32),
        "dec_pos": np.array([[30, 31, 32], [50, 51, 52]], np.int64),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 4-rank gloo world that runs every sharded computation of this
    file; its inputs and each rank's outputs."""
    out = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs()
    np.savez(os.path.join(out, "inputs.npz"), **inp)
    spawn("model", 4, out, timeout=150)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(4)]
    return inp, ranks


def _jax_logits(model, quant, dp, tp, inp):
    """JAX mesh prefill and one decode step over the same tokens."""
    name = "test-tiny" if model == "tiny" else "tinychat"
    cfg, params = _jax_params(name, quant)
    m = jmesh.make_mesh(dp=dp, tp=tp)
    params = jsharding.shard_params(params, m)
    toks = jnp.asarray(inp[f"{model}_tokens"], jnp.int32)
    b, t = toks.shape
    cache = jsharding.shard_cache(jllama.init_cache(cfg, b, 64, jnp.float32),
                                  m)
    logits, cache = jllama.forward(
        params, cfg, toks, jnp.broadcast_to(jnp.arange(t)[None], (b, t)),
        cache, jnp.zeros((b,), jnp.int32))
    step, cache = jllama.forward(
        params, cfg, jnp.asarray(inp[f"{model}_dec"], jnp.int32)[:, None],
        jnp.full((b, 1), t, jnp.int32), cache, jnp.full((b,), t, jnp.int32))
    return np.asarray(logits), np.asarray(step[:, 0]), np.asarray(cache.k)


@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mname,dp,tp", [("tp2", 1, 2), ("dp2tp2", 2, 2)])
def test_sharded_forward_matches_jax_mesh_forward(world, mname, dp, tp,
                                                  model, quant):
    inp, ranks = world
    prefill, decode, cache_k = _jax_logits(model, quant, dp, tp, inp)
    key = f"{mname}/{model}/{quant}"
    b = prefill.shape[0] // dp
    kv = cache_k.shape[3] // tp
    for rank in range(dp * tp):
        d, t = divmod(rank, tp)
        rows = slice(d * b, (d + 1) * b)
        got = ranks[rank]
        # Every tp peer holds the same bits (sums in a fixed rank order).
        peer = ranks[d * tp]
        np.testing.assert_array_equal(got[f"{key}/prefill"],
                                      peer[f"{key}/prefill"])
        np.testing.assert_allclose(got[f"{key}/prefill"], prefill[rows],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_allclose(got[f"{key}/decode"], decode[rows],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        # This rank's KV heads of its slots, prefill and decode rows.
        np.testing.assert_allclose(
            got[f"{key}/cache_k"],
            cache_k[:, rows, :, t * kv:(t + 1) * kv],
            atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("kind", ["ring", "decode"])
@pytest.mark.parametrize("mname,dp,sp", [("sp4", 1, 4), ("dp2sp2", 2, 2)])
def test_sequence_sharded_attention_matches_jax(world, kind, mname, dp, sp):
    from fasttalk_tpu.parallel.ring_attention import (
        decode_attention_sharded, ring_attention_sharded)

    inp, ranks = world
    m = jmesh.make_mesh(dp=dp, sp=sp)
    if kind == "ring":
        want = np.asarray(ring_attention_sharded(
            inp["ring_q"], inp["ring_k"], inp["ring_v"],
            inp["ring_pos"].astype(np.int32), m))
        c = want.shape[1] // sp
        for rank in range(4):
            i = rank % sp
            np.testing.assert_allclose(ranks[rank][f"{mname}/ring"],
                                       want[:, i * c:(i + 1) * c],
                                       atol=ATTN_TOL, rtol=ATTN_TOL)
    else:
        want = np.asarray(decode_attention_sharded(
            inp["dec_q"], inp["dec_k"], inp["dec_v"],
            inp["dec_pos"].astype(np.int32), m))
        for rank in range(4):
            got = ranks[rank][f"{mname}/decode"]
            np.testing.assert_array_equal(got, ranks[0][f"{mname}/decode"])
            np.testing.assert_allclose(got, want, atol=ATTN_TOL,
                                       rtol=ATTN_TOL)


def test_every_rank_ran_its_collectives(world):
    _, ranks = world
    calls = [int(r["collective_calls"]) for r in ranks]
    assert all(c > 0 for c in calls)
    # The ranks outside the tp = 2 mesh ran fewer.
    assert calls[0] == calls[1] and calls[2] == calls[3] < calls[0]


def test_tp_layout_rounds_where_one_rank_does(world):
    """tinychat int8 with bf16 activations, as served: tp = 2 sums its
    shards' float32 partial products and rounds once, where one rank
    rounds its whole product, so its logits are one rank's but for the
    order of float32 additions."""
    _, ranks = world
    for part in ("prefill", "decode"):
        want = ranks[0][f"single/chat/int8bf16/{part}"]
        assert 8 <= np.abs(want).max() < 16
        for rank in (0, 1):
            got = ranks[rank][f"tp2/chat/int8bf16/{part}"]
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            # A quarter of one bf16 step at these logits (1/16 in [8, 16)):
            # a flip of one rounding deep in the model moves a logit far
            # less; bf16 partial sums, rounded twice, measured 0.16 here.
            np.testing.assert_allclose(got, want, atol=TP_ROUNDING_TOL,
                                       rtol=0)

