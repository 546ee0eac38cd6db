"""fasttalk_tpu_torch's int4 weight tier (WEIGHT_QUANT=int4) held against
the JAX package's, on the CPU.

- Format: ``unpack_int4`` of all 256 byte values and ``pack_int4`` round
  trips are bit-equal to JAX; the torch idiom they rest on (a uint8 tensor
  viewed as int8, arithmetic ``>>``) is pinned.
- Quantization: ``quantize_math_group`` and ``quantize_group`` are
  bit-equal to eager JAX and to the numpy twin JAX's loader uses. Against
  the jitted ``quantize_params_int4`` scales may differ by one float32 ulp
  and codes by one step: under ``jax.jit`` XLA rewrites ``max / 7`` into
  ``max * (1/7)``, as it does ``/ 127`` for the int8 tier.
- Kernel: ``int4_matmul_plain`` against JAX's ``int4_matmul`` (Pallas,
  interpret mode) and ``ops.quant.matmul``: float32 x to rtol/atol 1e-5;
  bfloat16 x to one bf16 step (2^-7 of each output's magnitude), the only
  difference being the f32 summation order before the single rounding
  (at M = 1 against the exact sum: JAX's interpret-mode kernel does not
  accumulate that bf16 dot in f32).
- Model: test-tiny with JAX's int4 params carried by ``from_jax_params``,
  prefill (blockwise) and decode logits within 1e-4 of the logit range on
  the float KV cache, 2e-3 on the paged int8 pool (JAX's jitted
  ``kv_quantize`` may move a row by one int8 step).
- Engine: ``TorchEngine(device="cpu")`` and ``TPUEngine`` with
  WEIGHT_QUANT=int4 on the trained tinychat checkpoint (both loaders
  quantize host-side to the same bytes), 1 and 4 sessions: the same
  greedy text; ``/models`` reports int4, the tier the params carry.
- Factory and config: ``weight_bytes_by_tier`` equals JAX's for every model
  and tier and the resident bytes of random init; the Config named errors,
  including the WEIGHT_QUANT / TPU_QUANTIZE conflict both packages reject.
- AWQ: on test-tiny the port picks the same per-layer alpha and clip as
  JAX and the same codes; it is no worse than data-free on its objective.
- Prepared cache: bit-exact round trip, mismatched metas ignored, and a
  cache written by ``python -m fasttalk_tpu_torch quantize`` restored by
  ``build_engine``.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fasttalk_tpu.models import llama as jllama
from fasttalk_tpu.models.configs import get_model_config as jax_model_config
from fasttalk_tpu.quantization import int4 as j4
from fasttalk_tpu_torch.models import llama as tllama
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.loader import from_jax_params
from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul, int4_matmul_plain
from fasttalk_tpu_torch.quantization import int4 as t4
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
CKPT = os.path.join(ASSETS, "tinychat")
REL_TOL = 1e-4  # of the logit range, float32 on both sides
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# ------------------------------------------------------------- format


def test_unpack_all_256_bytes_and_pack_round_trip_equal_jax():
    b = np.arange(256, dtype=np.uint8).reshape(2, 128)
    want = np.asarray(j4.unpack_int4(jnp.asarray(b)))
    got = t4.unpack_int4(torch.from_numpy(b))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # The idiom underneath: viewing uint8 as int8 wraps as astype does, and
    # int8 >> is arithmetic, for every byte.
    v = torch.from_numpy(b).view(torch.int8)
    np.testing.assert_array_equal(v.numpy(), b.astype(np.int8))
    np.testing.assert_array_equal(((v << 4) >> 4).numpy(),
                                  ((b.astype(np.int8) << 4) >> 4))
    np.testing.assert_array_equal((v >> 4).numpy(), b.astype(np.int8) >> 4)
    # Every code survives a round trip; packing matches JAX byte for byte.
    q = np.random.default_rng(0).integers(-8, 8, (3, 64, 24)).astype(np.int8)
    packed = t4.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 32, 24)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j4.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(t4.unpack_int4(packed).numpy(), q)
    assert int(t4.pack_int4(torch.tensor([[1], [-2]], dtype=torch.int8))) \
        == (0xE << 4) | 0x1


@pytest.mark.parametrize("group", [2, 32, 128])
def test_group_quantization_is_bit_exact_to_eager_jax(group):
    w = (np.random.default_rng(group).standard_normal((2, 256, 96))
         * 3.0).astype(np.float32)
    w[0, :group, :3] = 0.0  # all-zero groups
    qj, sj = j4.quantize_math_group(jnp.asarray(w), group)
    qt, st = t4.quantize_math_group(torch.from_numpy(w), group)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    leaf = t4.quantize_group(torch.from_numpy(w), group)
    # The port's checkpoint load quantizes with this function; JAX's uses
    # its numpy twin. Both give the same bytes.
    q4n, sn = j4._np_quantize_group(w, group)
    np.testing.assert_array_equal(leaf["q4"].numpy(), q4n)
    np.testing.assert_array_equal(leaf["s"].numpy(), sn)
    assert t4.group_size_of(leaf) == group
    np.testing.assert_array_equal(
        t4.dequantize_int4(leaf).numpy(),
        np.asarray(j4.dequantize_int4(j4.quantize_group(jnp.asarray(w),
                                                        group))))


def test_quantize_params_int4_matches_jitted_jax_to_one_ulp():
    cfg = jax_model_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = from_jax_params(_np(params), "cpu")
    want = dict(_leaves(_np(j4.quantize_params_int4(params, 32))))
    got = dict(_leaves(t4.quantize_params_int4(tparams, 32)))
    assert want.keys() == got.keys()
    assert t4.is_int4(t4.quantize_params_int4(tparams, 32))
    assert not t4.is_int4(tparams)
    for path, a in want.items():
        t = got[path].numpy()
        assert t.dtype == a.dtype and t.shape == a.shape, path
        if path.endswith("/s"):
            # One float32 ulp: XLA's max * (1/7) against max / 7.
            ulp = np.spacing(np.abs(a).astype(np.float32))
            assert (np.abs(t - a) <= ulp).all(), path
        elif path.endswith("/q4"):
            qa = np.asarray(j4.unpack_int4(jnp.asarray(a))).astype(int)
            qt = t4.unpack_int4(torch.from_numpy(t)).numpy().astype(int)
            assert np.abs(qa - qt).max() <= 1, path
        elif a.dtype == np.int8:
            assert np.abs(t.astype(int) - a.astype(int)).max() <= 1, path
        else:
            np.testing.assert_array_equal(t, a, err_msg=path)


@pytest.mark.parametrize("group", [3, 0, 48, 32, 64, 128])
def test_validate_group_names_the_same_errors_as_jax(group):
    jcfg, tcfg = jax_model_config("test-tiny"), get_model_config("test-tiny")
    try:
        j4.validate_group(jcfg, group)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        t4.validate_group(tcfg, group)
    else:
        with pytest.raises(ValueError) as err:
            t4.validate_group(tcfg, group)
        assert str(err.value) == want


# ------------------------------------------------------------- kernel


@pytest.mark.parametrize("group,k", [(64, 256), (128, 256), (64, 512),
                                     (128, 1024)])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_int4_matmul_plain_matches_the_jax_kernel(group, k, m):
    """The plain version (what a CPU tensor runs, and what the CUDA kernel
    is held to on the card) against JAX's Pallas ``int4_matmul`` in
    interpret mode and JAX's XLA dequant path ``ops.quant.matmul``."""
    from fasttalk_tpu.ops.pallas_int8 import int4_matmul as jax_int4_matmul
    from fasttalk_tpu.ops.quant import matmul as jax_matmul

    rng = np.random.default_rng(m * k + group)
    n = 256
    # Weights at the model's init scale (fan_in ** -0.5): outputs of order
    # one, where float32 sums in another order stay within 1e-5.
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    w4 = j4.quantize_group(jnp.asarray(w), group)
    q4, s = np.array(w4["q4"]), np.array(w4["s"])
    x = rng.standard_normal((m, k)).astype(np.float32)
    tq4, ts = torch.from_numpy(q4), torch.from_numpy(s)
    got = int4_matmul_plain(torch.from_numpy(x), tq4, ts).numpy()
    for ref in (jax_int4_matmul(jnp.asarray(x), w4["q4"], w4["s"],
                                interpret=True),
                jax_matmul(jnp.asarray(x)[:, None], w4)[:, 0]):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    xf = np.asarray(xb.astype(jnp.float32))
    gotb = int4_matmul_plain(torch.from_numpy(xf).to(torch.bfloat16), tq4,
                             ts).float().numpy()
    refs = [jax_matmul(xb[:, None], w4)[:, 0]]
    if m > 1:
        # At M = 1 the interpret-mode Pallas kernel's bf16 dot is off the
        # exact sum by up to tens of bf16 steps (it does not accumulate in
        # f32 there); the plain version is held to the exact sum instead.
        refs.append(jax_int4_matmul(xb, w4["q4"], w4["s"], interpret=True))
    wb = np.asarray(j4.unpack_int4(w4["q4"])).astype(np.float32) * np.repeat(
        np.asarray(w4["s"].astype(jnp.bfloat16).astype(jnp.float32)), group,
        0)
    exact = xf.astype(np.float64) @ np.asarray(
        jnp.asarray(wb).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    refs.append(exact)
    # One bf16 step of the output, plus what float32 sums in another order
    # may differ by (K ulps of the sum of |terms|).
    slack = 2.0 ** -24 * k * (np.abs(xf) @ np.abs(wb))
    for ref in refs:
        ref = np.asarray(ref, np.float32)
        step = 2.0 ** -7 * np.maximum(np.abs(ref), np.abs(gotb)) + slack
        assert (np.abs(gotb - ref) <= step).all(), \
            float(np.abs(gotb - ref).max())


def test_quant_matmul_runs_the_plain_dequant_product_on_the_cpu():
    """ops.quant.matmul with an int4 leaf: on the CPU, decode (T=1) and
    prefill (T>1) both take the dequantized product and no kernel launch
    is counted."""
    from fasttalk_tpu_torch.ops.quant import matmul

    g = torch.Generator().manual_seed(3)
    w4 = t4.quantize_group(torch.randn((128, 48), generator=g), 32)
    ref_w = t4.dequantize_int4(w4)
    before = int4_matmul.launches
    for t in (1, 5):
        x = torch.randn((3, t, 128), generator=g)
        torch.testing.assert_close(matmul(x, w4), x @ ref_w, rtol=0, atol=0)
        torch.testing.assert_close(
            matmul(x, w4)[:, 0], int4_matmul(x[:, 0].contiguous(),
                                             w4["q4"], w4["s"]),
            rtol=1e-6, atol=1e-6)
    assert int4_matmul.launches == before


# ------------------------------------------------------------- model


def _tiny_int4(seed):
    cfg = jax_model_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    return cfg, j4.quantize_params_int4(params, 32)


def test_from_jax_params_carries_int4_leaves_bit_for_bit():
    _, p4 = _tiny_int4(0)
    src = dict(_leaves(_np(p4)))
    got = dict(_leaves(from_jax_params(_np(p4), "cpu")))
    assert src.keys() == got.keys()
    for path, a in src.items():
        assert str(got[path].dtype).replace("torch.", "") == a.dtype.name
        np.testing.assert_array_equal(got[path].numpy(), a, err_msg=path)
    assert got["/layers/wq/q4"].dtype == torch.uint8


def test_tiny_int4_prefill_and_decode_logits_match_jax():
    """Random test-tiny weights quantized by JAX to int4 (group 32): prefill
    (blockwise) and eight decode steps on a shared random token stream,
    float KV cache; logits within 1e-4 of the logit range."""
    jcfg, p4 = _tiny_int4(1)
    tcfg = get_model_config("test-tiny")
    tparams = from_jax_params(_np(p4), "cpu")
    b, t, s = 2, 12, 512
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jcache = jllama.init_cache(jcfg, b, s, jnp.float32)
    tcache = tllama.init_cache(tcfg, b, s, torch.float32, "cpu")
    jl, jcache = jllama.forward(p4, jcfg, jnp.asarray(prompt),
                                jnp.asarray(pos), jcache,
                                jnp.zeros((b,), jnp.int32), blockwise=True)
    tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(prompt).long(),
                           torch.from_numpy(pos).long(), tcache,
                           torch.zeros((b,), dtype=torch.long),
                           blockwise=True)
    outs = [(np.asarray(jl), tl.numpy())]
    fn = jax.jit(lambda p, **kw: jllama.forward_decode(
        p, jcfg, attn_len=s, pallas_int4=True, **kw))
    rng = np.random.default_rng(3)
    mask = np.ones((b,), bool)
    for i in range(8):
        tok = rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
        p = np.full((b,), t + i, np.int32)
        jl, jcache = fn(p4, cur=jnp.asarray(tok), positions=jnp.asarray(p),
                        cache=jcache, write_mask=jnp.asarray(mask))
        tl, _ = tllama.forward_decode(tparams, tcfg,
                                      torch.from_numpy(tok).long(),
                                      torch.from_numpy(p).long(), tcache,
                                      torch.from_numpy(mask), attn_len=s)
        outs.append((np.asarray(jl), tl.numpy()))
    for step, (jl, tl) in enumerate(outs):
        span = float(np.ptp(jl))
        assert float(np.abs(jl - tl).max()) <= REL_TOL * span, step


def test_tiny_int4_paged_int8_decode_logits_match_jax():
    """int4 weights on the paged int8 KV pool: both packages prefill the
    same dense int8 rows, which are scattered into pools through shuffled
    tables (the port's pool has its extra sink block); decode T = 1 and a
    T = 4 block with one slot masked on alternate steps. Tolerance 2e-3 of
    the logit range: JAX's jitted kv_quantize may differ by one scale ulp,
    which can move a fresh row by one int8 step."""
    jcfg, p4 = _tiny_int4(3)
    tcfg = get_model_config("test-tiny")
    tparams = from_jax_params(_np(p4), "cpu")
    b, t0, bs, nb, blocks = 3, 10, 16, 8, 30
    tables = np.random.default_rng(4).permutation(blocks)[:b * nb].reshape(
        b, nb).astype(np.int32)
    from fasttalk_tpu.ops.attention import paged_gather_indices

    idx = np.asarray(paged_gather_indices(jnp.asarray(tables), bs))
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (b, t0)).astype(np.int32)
    jdense = jllama.init_cache(jcfg, b, nb * bs, jnp.float32, quantized=True,
                               scale_granule=1)
    _, jdense = jllama.forward(p4, jcfg, jnp.asarray(prompt),
                               jnp.asarray(np.tile(np.arange(t0), (b, 1))),
                               jdense, jnp.zeros((b,), jnp.int32),
                               blockwise=True)

    def pool(sink):
        out = []
        for a in (np.asarray(x) for x in jdense):
            p = np.zeros((a.shape[0], (blocks + sink) * bs) + a.shape[3:],
                         a.dtype)
            for i in range(b):
                p[:, idx[i]] = a[:, i]
            out.append(p)
        return out
    jcache = jllama.KVCache(*(jnp.asarray(a) for a in pool(False)))
    tcache = tllama.KVCache(*(torch.from_numpy(a) for a in pool(True)))
    fn = jax.jit(lambda p, **kw: jllama.forward_decode_multi(
        p, jcfg, attn_len=nb * bs, block_size=bs, pallas_paged=True,
        pallas_int4=True, **kw))
    rng = np.random.default_rng(6)
    pos = t0
    for step, t in enumerate((1, 1, 4, 1)):
        toks = rng.integers(0, jcfg.vocab_size, (b, t)).astype(np.int32)
        mask = np.array([True, step % 2 == 0, True])
        p = np.full((b,), pos, np.int32)
        jl, jcache = fn(p4, tokens=jnp.asarray(toks),
                        positions=jnp.asarray(p), cache=jcache,
                        write_mask=jnp.asarray(mask),
                        block_table=jnp.asarray(tables))
        tl, _ = tllama.forward_decode_multi(
            tparams, tcfg, torch.from_numpy(toks).long(),
            torch.from_numpy(p).long(), tcache, torch.from_numpy(mask),
            attn_len=nb * bs, block_table=torch.from_numpy(tables),
            block_size=bs)
        jl, tl = np.asarray(jl), tl.numpy()
        span = float(np.ptp(jl))
        assert float(np.abs(jl - tl)[mask].max()) <= 2e-3 * span, step
        pos += t


@pytest.mark.parametrize("seed", [0, 1])
def test_init_params_device_int4_has_the_jax_layout(seed):
    """Random int4 init: the leaves of JAX's int4 init (names, shapes,
    dtypes), each layer's codes and scales those of quantizing the same f32
    slice, and the f32 slices those of the other tiers."""
    from fasttalk_tpu.models.loader import init_params_device as jinit
    from fasttalk_tpu_torch.models.loader import init_params_device

    jcfg, tcfg = jax_model_config("test-tiny"), get_model_config("test-tiny")
    ref = dict(_leaves(jax.eval_shape(lambda: jinit(
        jcfg, jnp.bfloat16, quantize="int4", weight_quant_group=32))))
    got = init_params_device(tcfg, torch.bfloat16, "cpu", quantize="int4",
                             seed=seed, weight_quant_group=32)
    flat = dict(_leaves(got))
    assert ref.keys() == flat.keys()
    for path, sds in ref.items():
        assert tuple(flat[path].shape) == sds.shape, path
        assert str(flat[path].dtype).replace("torch.", "") == \
            sds.dtype.name, path
    plain = init_params_device(tcfg, torch.float32, "cpu", quantize="none",
                               seed=seed)
    for name in t4.INT4_LEAVES:
        want = t4.quantize_group(plain["layers"][name][1], 32)
        assert torch.equal(got["layers"][name]["q4"][1], want["q4"]), name
        assert torch.equal(got["layers"][name]["s"][1], want["s"]), name
    int8 = init_params_device(tcfg, torch.bfloat16, "cpu", quantize="int8",
                              seed=seed)
    assert torch.equal(got["embed"]["q"], int8["embed"]["q"])


# ------------------------------------------------------------- engine

PROMPTS = [
    ("sky", [{"role": "user", "content": "what color is the sky?"}], 48),
    ("alice", [{"role": "user", "content": "my name is Alice."},
               {"role": "assistant", "content": "Nice to meet you, Alice!"},
               {"role": "user", "content": "what is my name?"}], 24),
    ("math", [{"role": "user", "content": "what is three plus four?"}], 24),
    ("opp", [{"role": "user", "content": "what is the opposite of hot?"}], 24),
]


async def _collect(engine, params_cls, rid, messages, max_tokens):
    params = params_cls(max_tokens=max_tokens, **GREEDY)
    text, final = "", {}
    async for ev in engine.generate(rid, f"s-{rid}", messages, params):
        if ev["type"] == "token":
            text += ev["text"]
        else:
            final = ev
    return text, final


@pytest.fixture(scope="module")
def jax_int4_texts():
    """Greedy replies of the JAX engine with WEIGHT_QUANT=int4 (float32),
    weights quantized host-side by ``quantizing_put_int4`` at load."""
    from fasttalk_tpu.engine.engine import GenerationParams, TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer
    from fasttalk_tpu.models.loader import load_params

    cfg = jax_model_config("tinychat", ASSETS)
    put = lambda a, path: jax.device_put(jnp.asarray(a, jnp.float32))  # noqa
    raw = lambda a, path: jax.device_put(jnp.asarray(a))  # noqa: E731
    params = load_params(cfg, CKPT, jnp.float32,
                         j4.quantizing_put_int4(put, raw, 128))
    assert j4.is_int4(params)
    eng = TPUEngine(cfg, params, load_tokenizer(ASSETS, "tinychat",
                                                template=cfg.chat_template),
                    num_slots=4, max_len=512, dtype=jnp.float32,
                    steps_per_call=8, spec_decode="off", shared_prefix=False,
                    weight_quant="int4", weight_quant_group=128)
    eng.start()
    try:
        async def run():
            return {rid: await _collect(eng, GenerationParams, rid, msgs, n)
                    for rid, msgs, n in PROMPTS}
        return asyncio.run(run())
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def torch_int4_engine():
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.loader import load_params

    cfg = get_model_config("tinychat", ASSETS)
    eng = TorchEngine(cfg, load_params(cfg, CKPT, torch.float32, "cpu",
                                       quantize="int4",
                                       weight_quant_group=128),
                      load_tokenizer(ASSETS, "tinychat",
                                     template=cfg.chat_template),
                      device="cpu", num_slots=4, max_len=512,
                      dtype=torch.float32, steps_per_call=8)
    eng.start()
    try:
        yield eng
    finally:
        eng.shutdown()


def test_int4_engine_one_session_at_a_time_matches_jax_engine(
        torch_int4_engine, jax_int4_texts):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        return {rid: await _collect(torch_int4_engine, GenerationParams, rid,
                                    msgs, n) for rid, msgs, n in PROMPTS}
    got = asyncio.run(run())
    for rid, (text, final) in got.items():
        assert text == jax_int4_texts[rid][0], rid
        assert final["finish_reason"] == \
            jax_int4_texts[rid][1]["finish_reason"]
        assert final["stats"]["tokens_generated"] == \
            jax_int4_texts[rid][1]["stats"]["tokens_generated"]
    assert "blue" in got["sky"][0].lower()


def test_int4_engine_four_concurrent_sessions_match_jax_engine(
        torch_int4_engine, jax_int4_texts):
    from fasttalk_tpu_torch.engine.engine import GenerationParams

    async def run():
        return await asyncio.gather(*(
            _collect(torch_int4_engine, GenerationParams, f"c-{rid}", msgs, n)
            for rid, msgs, n in PROMPTS))
    got = asyncio.run(run())
    for (rid, _, _), (text, final) in zip(PROMPTS, got):
        assert text == jax_int4_texts[rid][0], rid
        assert final["type"] == "done"


def test_models_endpoint_reports_int4(torch_int4_engine):
    import aiohttp
    from aiohttp import web

    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    async def run():
        server = WebSocketLLMServer(
            Config(model_name="tinychat", model_path=ASSETS,
                   weight_quant="int4", max_model_len=512,
                   default_context_window=512), torch_int4_engine)
        runner = web.AppRunner(server.app)
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
            async with aiohttp.ClientSession() as http:
                async with http.get(f"http://127.0.0.1:{port}/models") as r:
                    return await r.json()
        finally:
            await runner.cleanup()

    info = asyncio.run(asyncio.wait_for(run(), 60))
    assert info["weight_quant"] == "int4"
    assert torch_int4_engine.get_model_info()["weight_quant"] == "int4"
    assert torch_int4_engine.weight_quant_group == 128


def test_engine_checks_the_weight_tier():
    """The engine reads its tier and int4 group from the params' leaves
    and rejects int4 leaves whose group cannot fit the model."""
    from fasttalk_tpu_torch.engine.engine import TorchEngine
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
    from fasttalk_tpu_torch.models.loader import init_params_device

    cfg = get_model_config("test-tiny")

    def engine(params):
        return TorchEngine(cfg, params, ByteTokenizer(), device="cpu",
                           num_slots=2, max_len=512)

    for tier, group in (("none", None), ("int8", None), ("int4", 32),
                        ("int4", 64)):
        params = init_params_device(cfg, torch.float32, "cpu", quantize=tier,
                                    weight_quant_group=group or 128)
        eng = engine(params)
        assert eng.get_model_info()["weight_quant"] == \
            {"none": "off"}.get(tier, tier)
        assert eng.weight_quant_group == group
    # wq's scales as if its group were 3 (64 rows / 21 scale rows): odd.
    bad = init_params_device(cfg, torch.float32, "cpu", quantize="int4",
                             weight_quant_group=32)
    wq = bad["layers"]["wq"]
    bad["layers"]["wq"] = {"q4": wq["q4"],
                           "s": wq["s"][:, :1].repeat(1, 21, 1)}
    with pytest.raises(ValueError, match="even integer"):
        engine(bad)


# ------------------------------------------------------------- factory, config


@pytest.mark.parametrize("dsize", [2, 4])
def test_weight_bytes_by_tier_equals_jax_for_every_model(dsize):
    from fasttalk_tpu.engine.factory import weight_bytes_by_tier as jax_wb
    from fasttalk_tpu.models.configs import list_models as jax_models
    from fasttalk_tpu_torch.engine.factory import weight_bytes_by_tier
    from fasttalk_tpu_torch.models.configs import list_models

    assert list_models() == jax_models() and len(list_models()) > 5
    for name in list_models():
        for group in (32, 128):
            assert weight_bytes_by_tier(get_model_config(name), dsize,
                                        group) == \
                jax_wb(jax_model_config(name), dsize, tp=1, group=group), name


def test_weight_bytes_by_tier_equals_resident_bytes_of_random_init():
    from fasttalk_tpu_torch.engine.factory import weight_bytes_by_tier
    from fasttalk_tpu_torch.models.loader import init_params_device

    for name in ("test-tiny", "test-tiny-qwen"):
        m = get_model_config(name)
        tiers = weight_bytes_by_tier(m, 2, 32)
        for tier in ("off", "int8", "int4"):
            p = init_params_device(m, torch.bfloat16, "cpu", quantize=tier,
                                   weight_quant_group=32)
            resident = sum(t.numel() * t.element_size()
                           for _, t in _leaves(p))
            assert resident == tiers[tier], (name, tier)


@pytest.mark.parametrize("env,ok", [
    ({"WEIGHT_QUANT": "off", "TPU_QUANTIZE": "int8"}, False),
    ({"WEIGHT_QUANT": "int4", "TPU_QUANTIZE": "int8"}, False),
    ({"WEIGHT_QUANT": "int8", "TPU_QUANTIZE": "int4"}, False),
    ({"WEIGHT_QUANT": "int8", "TPU_QUANTIZE": "none"}, "int8"),
    ({"WEIGHT_QUANT": "int4", "TPU_QUANTIZE": "int4"}, "int4"),
    ({"TPU_QUANTIZE": "int4"}, "int4"),
    ({"TPU_QUANTIZE": "int8"}, "int8"),
    ({}, "off")])
def test_weight_quant_and_legacy_alias_resolve_as_in_jax(monkeypatch, env,
                                                          ok):
    """The two tier variables: an unset WEIGHT_QUANT takes TPU_QUANTIZE, a
    set one is authoritative, and two different tiers are a named startup
    error in both packages."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k in ("WEIGHT_QUANT", "TPU_QUANTIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if ok is False:
        for cls, kw in ((Config, {}), (JaxConfig, {"llm_provider": "tpu"})):
            with pytest.raises(ValueError, match="conflicts with legacy "
                               "TPU_QUANTIZE"):
                cls(**kw)
    else:
        assert Config().weight_quant == ok
        assert JaxConfig(llm_provider="tpu").weight_quant == ok


@pytest.mark.parametrize("env,match", [
    ({"TPU_USE_PALLAS_INT4": "true"}, "requires WEIGHT_QUANT=int4"),
    ({"WEIGHT_QUANT": "int4", "WEIGHT_QUANT_GROUP": "3"}, "even integer"),
    ({"WEIGHT_QUANT": "int4", "WEIGHT_QUANT_CALIB": "/nonexistent/p.txt"},
     "WEIGHT_QUANT_CALIB must be"),
    ({"WEIGHT_QUANT": "int5"}, "WEIGHT_QUANT must be off|int8|int4")])
def test_config_names_the_int4_errors(monkeypatch, env, match):
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        Config()
    with pytest.raises(ValueError, match=match):
        JaxConfig(llm_provider="tpu")


def test_config_composes_int4_with_the_kv_tiers(monkeypatch, tmp_path):
    from fasttalk_tpu_torch.utils.config import Config

    calib = tmp_path / "calib.txt"
    calib.write_text("hello there\n")
    for k, v in {"WEIGHT_QUANT": "int4", "WEIGHT_QUANT_GROUP": "64",
                 "KV_QUANT": "int8", "KV_LAYOUT": "paged",
                 "TPU_SPEC_DECODE": "off",
                 "TPU_USE_PALLAS_INT4": "true",
                 "WEIGHT_QUANT_CALIB": str(calib)}.items():
        monkeypatch.setenv(k, v)
    cfg = Config()
    assert (cfg.weight_quant, cfg.weight_quant_group, cfg.kv_quant,
            cfg.kv_layout, cfg.use_pallas_int4) == \
        ("int4", 64, "int8", "paged", True)


def test_memory_budget_prices_the_int4_tier(monkeypatch):
    from fasttalk_tpu_torch.engine.factory import (check_hbm_budget,
                                                   weight_bytes_by_tier)
    from fasttalk_tpu_torch.utils.config import Config

    m = get_model_config("llama3.2:1b")
    gib = 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, 12 * gib))
    card = torch.device("cuda")
    acct = check_hbm_budget(m, Config(weight_quant="int4", decode_slots=4,
                                      max_model_len=2048), 2, card)
    assert acct["weight_bytes"] == weight_bytes_by_tier(m, 2, 128)["int4"]
    with pytest.raises(ValueError, match="WEIGHT_QUANT=int4") as err:
        check_hbm_budget(m, Config(weight_quant="int8", decode_slots=16,
                                   max_model_len=131072), 2, card)
    assert "int4+scales=" in str(err.value)


# ------------------------------------------------------------- AWQ


def _awq_inputs():
    cfg = jax_model_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return cfg, params, tokens


def test_awq_picks_the_same_scales_and_codes_as_jax():
    """The same per-layer alpha_attn, alpha_mlp, clip_wo and clip_w_down as
    the JAX search on the same numpy-made calibration tokens; at least
    99.9% of the int4 codes equal and the rest one step apart (the fold
    scale goes through exp(mean(log)), summed in another order); norms and
    scales to float32 rounding."""
    from fasttalk_tpu.quantization.awq import quantize_params_awq as jawq
    from fasttalk_tpu_torch.quantization.awq import quantize_params_awq

    cfg, params, tokens = _awq_inputs()
    jq, jman = jawq(params, cfg, jnp.asarray(tokens), 32)
    tq, tman = quantize_params_awq(from_jax_params(_np(params), "cpu"),
                                   get_model_config("test-tiny"),
                                   torch.from_numpy(tokens), 32)
    assert tman == jman
    # Not the data-free identity everywhere: the search had choices to make.
    assert any(layer["alpha_attn"] > 0 or layer["clip_wo"] < 1
               for layer in tman["layers"])
    want = dict(_leaves(_np(jq)))
    got = dict(_leaves(tq))
    assert want.keys() == got.keys()
    for path, a in want.items():
        t = got[path].numpy()
        if path.endswith("/q4"):
            qa = np.asarray(j4.unpack_int4(jnp.asarray(a))).astype(int)
            qt = t4.unpack_int4(torch.from_numpy(t)).numpy().astype(int)
            assert (qa == qt).mean() >= 0.999, path
            assert np.abs(qa - qt).max() <= 1, path
        elif a.dtype == np.int8:
            assert np.abs(t.astype(int) - a.astype(int)).max() <= 1, path
        else:
            np.testing.assert_allclose(t, a, rtol=1e-5, atol=1e-7,
                                       err_msg=path)


def test_awq_is_no_worse_than_data_free_on_its_calibration_batch():
    from fasttalk_tpu_torch.quantization.awq import (dequant_error,
                                                     quantize_params_awq)

    cfg = get_model_config("test-tiny")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(2))
    qa, _ = quantize_params_awq(params, cfg, toks, 32)
    qd = t4.quantize_params_int4(params, 32)
    pos = torch.arange(32)[None].expand(2, 32)

    def logits(p):
        cache = tllama.init_cache(cfg, 2, 64, torch.float32, "cpu")
        out, _ = tllama.forward(p, cfg, toks, pos, cache,
                                torch.zeros(2, dtype=torch.long))
        return out

    ref = logits(params)
    mse_awq = float(((logits(qa) - ref) ** 2).mean())
    mse_free = float(((logits(qd) - ref) ** 2).mean())
    assert mse_awq <= mse_free * 1.05  # float-evaluation slack
    assert dequant_error(qd["layers"]["wo"], params["layers"]["wo"]) > 0


def test_calibration_tokens_match_jax():
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from fasttalk_tpu.quantization.awq import calibration_tokens as jcal
    from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
    from fasttalk_tpu_torch.quantization.awq import calibration_tokens

    got = calibration_tokens(ByteTokenizer(), n_samples=3, seq_len=64, seed=1)
    want = np.asarray(jcal(JaxBytes(), n_samples=3, seq_len=64, seed=1))
    assert got.shape == (3, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="need at least"):
        calibration_tokens(ByteTokenizer(), n_samples=1, seq_len=10 ** 7)


# ------------------------------------------------------------- prepared cache


def test_prepared_cache_round_trip_and_meta_mismatches(tmp_path):
    from fasttalk_tpu_torch.models.loader import init_params_device
    from fasttalk_tpu_torch.models.prepared_cache import (cache_dir,
                                                          cache_meta,
                                                          load_prepared,
                                                          save_prepared,
                                                          transform_version)

    cfg = get_model_config("test-tiny")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model.safetensors").write_bytes(b"x" * 10)
    params = init_params_device(cfg, torch.bfloat16, "cpu", quantize="int4",
                                weight_quant_group=32, seed=5)
    meta = cache_meta(cfg, torch.bfloat16, "int4", str(ckpt), group=32)
    assert meta["group"] == 32
    assert "group" not in cache_meta(cfg, torch.bfloat16, "int8", str(ckpt))
    path = save_prepared(params, str(tmp_path), meta)
    assert path == cache_dir(str(tmp_path), meta)
    assert path.endswith(os.path.join(".prepared_torch",
                                      "test-tiny-bfloat16-int4-g32"))
    back = load_prepared(cfg, str(tmp_path), torch.bfloat16, "int4",
                         str(ckpt), group=32, device="cpu")
    want, got = dict(_leaves(params)), dict(_leaves(back))
    assert want.keys() == got.keys()
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    # A second write replaces the first in place.
    assert save_prepared(params, str(tmp_path), meta) == path
    assert sorted(os.listdir(os.path.dirname(path))) == [
        os.path.basename(path)]
    # Another group, dtype or tier is another cache; a changed source
    # checkpoint invalidates it; a meta that disagrees is ignored.
    for kw in (dict(dtype=torch.bfloat16, quantize="int4", group=64),
               dict(dtype=torch.float32, quantize="int4", group=32),
               dict(dtype=torch.bfloat16, quantize="int8", group=32)):
        assert load_prepared(cfg, str(tmp_path), kw["dtype"], kw["quantize"],
                             str(ckpt), group=kw["group"],
                             device="cpu") is None
    (ckpt / "model.safetensors").write_bytes(b"y" * 11)
    assert load_prepared(cfg, str(tmp_path), torch.bfloat16, "int4",
                         str(ckpt), group=32, device="cpu") is None
    # With the new source's meta: another model's or another version of the
    # loading and quantization code's is ignored, its own is read.
    meta = cache_meta(cfg, torch.bfloat16, "int4", str(ckpt), group=32)
    assert meta["code"] == transform_version() and len(meta["code"]) == 16
    for have, found in ((dict(meta, model="other"), False),
                        (dict(meta, code="0" * 16), False), (meta, True)):
        with open(os.path.join(path, "fasttalk_meta.json"), "w") as f:
            json.dump(have, f)
        back = load_prepared(cfg, str(tmp_path), torch.bfloat16, "int4",
                             str(ckpt), group=32, device="cpu")
        assert (back is not None) == found, have


def _leaf(params, key):
    for part in key.split("/"):
        params = params[part]
    return params


def test_quantize_command_writes_the_cache_build_engine_restores(
        tmp_path, monkeypatch):
    """``python -m fasttalk_tpu_torch quantize`` (AWQ on a few samples of
    the WEIGHT_QUANT_CALIB file) writes the int4 cache and its manifest;
    build_engine with WEIGHT_QUANT=int4 and the same group and dtype
    restores exactly those weights and serves the trained checkpoint's
    answer. With the cache bypassed it quantizes the checkpoint itself and
    leaves the cache alone."""
    from safetensors.torch import load_file

    from fasttalk_tpu_torch.__main__ import main
    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.models.loader import load_params
    from fasttalk_tpu_torch.models.prepared_cache import (cache_dir,
                                                          cache_meta)
    from fasttalk_tpu_torch.training.corpus import corpus_texts
    from fasttalk_tpu_torch.utils.config import Config

    os.symlink(CKPT, tmp_path / "tinychat")
    calib = tmp_path / "calib.txt"
    calib.write_text("\n".join(corpus_texts(8, 0)) + "\n", encoding="utf-8")
    monkeypatch.setenv("WEIGHT_QUANT_CALIB", str(calib))
    assert main(["quantize", "--model", "tinychat", "--model-path",
                 str(tmp_path), "--calib-samples", "2", "--seq-len", "64",
                 "--dtype", "float32", "--device", "cpu"]) == 0
    cfg = get_model_config("tinychat", str(tmp_path))
    path = cache_dir(str(tmp_path), cache_meta(
        cfg, torch.float32, "int4", str(tmp_path / "tinychat"), group=128))
    with open(os.path.join(path, "quantize_manifest.json")) as f:
        manifest = json.load(f)
    assert (manifest["mode"], manifest["calib"]) == ("awq", str(calib))
    assert len(manifest["layers"]) == cfg.num_layers
    tensors = os.path.join(path, "params.safetensors")
    cached, written = load_file(tensors), os.stat(tensors).st_mtime_ns
    config = Config(model_name="tinychat", model_path=str(tmp_path),
                    weight_quant="int4", dtype="float32", decode_slots=2,
                    max_model_len=512, default_context_window=512)
    direct = build_engine(config, device="cpu", prepared_cache=False)
    loaded = load_params(cfg, str(tmp_path / "tinychat"), torch.float32,
                         "cpu", quantize="int4")
    for key in cached:
        assert torch.equal(_leaf(direct.params, key), _leaf(loaded, key)), key
    assert os.stat(tensors).st_mtime_ns == written
    eng = build_engine(config, device="cpu")
    for key, t in cached.items():
        assert torch.equal(_leaf(eng.params, key), t), key
    eng.start()
    try:
        text, final = asyncio.run(asyncio.wait_for(_collect(
            eng, GenerationParams, "sky", PROMPTS[0][1], 24), 60))
    finally:
        eng.shutdown()
    assert final["type"] == "done" and text
