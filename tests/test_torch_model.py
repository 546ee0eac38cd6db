"""fasttalk_tpu_torch's Llama forward held against the JAX package's.

The JAX parameters carry across with ``from_jax_params`` (bit for bit),
then the same tokens go through ``forward`` (prefill) and
``forward_decode`` (decode) of both packages on the CPU in float32. On
random ``test-tiny`` weights logits agree to 1e-4 of the logit range (the
two differ only in summation order); on the trained tinychat checkpoint
the greedy token streams are equal.
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
from fasttalk_tpu.models.loader import load_params as jax_load_params
from fasttalk_tpu.ops.quant import quantize_params as jax_quantize_params
from fasttalk_tpu_torch.models import llama as tllama
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.loader import from_jax_params, load_params

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fasttalk_tpu", "assets")
CKPT = os.path.join(ASSETS, "tinychat")
REL_TOL = 1e-4  # of the logit range, float32 on both sides


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("quantized", [False, True])
def test_from_jax_params_is_bit_exact(quantized):
    cfg = jax_model_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    if quantized:
        params = jax_quantize_params(params)
    src = dict(_leaves(_numpy_tree(params)))
    got = dict(_leaves(from_jax_params(_numpy_tree(params), "cpu")))
    assert src.keys() == got.keys()
    for path, a in src.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, path
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=path)


@functools.lru_cache(maxsize=None)
def _jax_decode(cfg, attn_len, pallas):
    return jax.jit(functools.partial(
        jllama.forward_decode, cfg=cfg, attn_len=attn_len,
        pallas_int8=pallas, pallas_dense=pallas))


def _run_both(jparams, jcfg, tcfg, prompt, steps, max_len=512,
              pallas=False, greedy=True, seed=0):
    """Prefill ``prompt`` [B, T] then ``steps`` decode steps through both
    packages; returns per-step (jax logits, torch logits) and both token
    streams. Decode feeds each package its own greedy token, or with
    ``greedy=False`` a shared random token stream."""
    b, t = prompt.shape
    tparams = from_jax_params(_numpy_tree(jparams), "cpu")
    jcache = jllama.init_cache(jcfg, b, max_len, jnp.float32)
    tcache = tllama.init_cache(tcfg, b, max_len, torch.float32, "cpu")
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(prompt),
                                jnp.asarray(pos), jcache,
                                jnp.zeros((b,), jnp.int32), blockwise=True)
    tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(prompt).long(),
                           torch.from_numpy(pos).long(), tcache,
                           torch.zeros((b,), dtype=torch.long), blockwise=True)
    out = [(np.asarray(jl), tl.numpy())]
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    ttok = tl[:, -1].argmax(-1).numpy().astype(np.int32)
    jstream, tstream = [jtok], [ttok]
    rng = np.random.default_rng(seed)
    mask = np.ones((b,), bool)
    fn = _jax_decode(jcfg, max_len, pallas)
    for i in range(steps):
        if not greedy:
            jtok = ttok = rng.integers(0, jcfg.vocab_size, (b,)).astype(
                np.int32)
        p = np.full((b,), t + i, np.int32)
        jl, jcache = fn(jparams, cur=jnp.asarray(jtok),
                        positions=jnp.asarray(p), cache=jcache,
                        write_mask=jnp.asarray(mask))
        tl, _ = tllama.forward_decode(tparams, tcfg,
                                      torch.from_numpy(ttok).long(),
                                      torch.from_numpy(p).long(), tcache,
                                      torch.from_numpy(mask),
                                      attn_len=max_len)
        out.append((np.asarray(jl), tl.numpy()))
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        ttok = tl.argmax(-1).numpy().astype(np.int32)
        jstream.append(jtok)
        tstream.append(ttok)
    return out, np.stack(jstream, 1), np.stack(tstream, 1)


@pytest.mark.parametrize("quantized", [False, True])
def test_tiny_random_prefill_and_decode_logits_match_jax(quantized):
    """Random test-tiny weights (float32 leaves, and int8 leaves through
    the Pallas kernels in interpret mode): prefill logits and eight decode
    steps of logits within 1e-4 of the logit range."""
    jcfg, tcfg = jax_model_config("test-tiny"), get_model_config("test-tiny")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    if quantized:
        params = jax_quantize_params(params)
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    out, _, _ = _run_both(params, jcfg, tcfg, prompt, steps=8,
                          pallas=quantized, greedy=False)
    for step, (jl, tl) in enumerate(out):
        span = float(np.ptp(jl))
        err = float(np.abs(jl - tl).max())
        assert err <= REL_TOL * span, (step, err, span)


@pytest.mark.parametrize("quantized", [False, True])
def test_tinychat_greedy_tokens_equal_jax(quantized):
    """The trained checkpoint: greedy streams over 32 decode steps are
    token-for-token equal (float32 weights, and int8 weights through the
    kernels' plain versions vs the Pallas kernels in interpret mode)."""
    jcfg = jax_model_config("tinychat", ASSETS)
    tcfg = get_model_config("tinychat", ASSETS)
    params = jax_load_params(jcfg, CKPT, dtype=jnp.float32)
    if quantized:
        params = jax_quantize_params(params)
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer

    tok = load_tokenizer(ASSETS, "tinychat", template=tcfg.chat_template)
    prompt = np.array([tok.apply_chat_template(
        [{"role": "user", "content": "what color is the sky?"}])], np.int32)
    _, jstream, tstream = _run_both(params, jcfg, tcfg, prompt, steps=32,
                                    pallas=quantized)
    np.testing.assert_array_equal(tstream, jstream)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-qwen"])
def test_init_params_has_the_jax_layout(name):
    """Random init gives the JAX package's leaves: names, shapes, dtypes."""
    jcfg, tcfg = jax_model_config(name), get_model_config(name)
    ref = dict(_leaves(jax.eval_shape(
        lambda: jllama.init_params(jcfg, jax.random.PRNGKey(0),
                                   jnp.bfloat16))))
    got = dict(_leaves(tllama.init_params(
        tcfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")))
    assert ref.keys() == got.keys()
    for path, sds in ref.items():
        assert tuple(got[path].shape) == sds.shape, path
        assert got[path].dtype == torch.bfloat16, path


@pytest.mark.parametrize("quantize", [False, True])
def test_init_params_device_has_the_jax_layout(quantize):
    """Weight-free random init on a device: the JAX layout of plain or
    int8 leaves (``quantize_params`` output), values finite."""
    from fasttalk_tpu_torch.models.loader import init_params_device

    jcfg, tcfg = jax_model_config("test-tiny"), get_model_config("test-tiny")

    def ref_fn():
        p = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        return jax_quantize_params(p) if quantize else p
    ref = dict(_leaves(jax.eval_shape(ref_fn)))
    got = dict(_leaves(init_params_device(tcfg, torch.float32, "cpu",
                                          quantize=quantize, seed=3)))
    assert ref.keys() == got.keys()
    for path, sds in ref.items():
        assert tuple(got[path].shape) == sds.shape, path
        assert str(got[path].dtype).replace("torch.", "") == \
            sds.dtype.name, path
        assert torch.isfinite(got[path].float()).all(), path


def test_load_params_matches_jax_loader():
    jcfg = jax_model_config("tinychat", ASSETS)
    tcfg = get_model_config("tinychat", ASSETS)
    ref = _numpy_tree(jax_load_params(jcfg, CKPT, dtype=jnp.float32))
    got = load_params(tcfg, CKPT, torch.float32, "cpu")
    for path, a in _leaves(ref):
        t = dict(_leaves(got))[path]
        np.testing.assert_array_equal(t.numpy(), a, err_msg=path)


def _pool_from_dense(dense: list, idx: np.ndarray, blocks: int, bs: int,
                     sink: bool) -> list:
    """Scatter each slot's dense rows [L, B, S, ...] into a pool
    [L, P, ...] through the flat indices idx [B, S]; ``sink`` adds the
    port's extra masked-write block at the end."""
    out = []
    for a in dense:
        if a is None:
            out.append(None)
            continue
        pool = np.zeros((a.shape[0], (blocks + sink) * bs) + a.shape[3:],
                        a.dtype)
        for i in range(a.shape[1]):
            pool[:, idx[i]] = a[:, i]
        out.append(pool)
    return out


@functools.lru_cache(maxsize=None)
def _jax_paged_decode(cfg, attn_len, bs):
    return jax.jit(functools.partial(
        jllama.forward_decode_multi, cfg=cfg, attn_len=attn_len,
        block_size=bs, pallas_paged=True))


@pytest.mark.parametrize("granule", ["none", "token", "head"])
def test_paged_decode_logits_match_jax(granule):
    """forward_decode_multi over a paged pool with scrambled tables (bf16
    tier in float32, and int8 rows at both scale granules) against the JAX
    package's paged decode through its Pallas block walk in interpret mode.
    Both pools start from the same prefilled rows; decode feeds a shared
    random token stream with one slot masked on alternate steps, T = 1 and
    a T = 4 block. Tolerance: 1e-4 of the logit range for the float tier.
    The int8 tier gets 2e-3: JAX's jitted kv_quantize may compute its scale
    as amax * (1/127), one float32 ulp off the port's amax / 127, which can
    move a freshly written row by one int8 step."""
    jcfg, tcfg = jax_model_config("test-tiny"), get_model_config("test-tiny")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tparams = from_jax_params(_numpy_tree(params), "cpu")
    kvq = granule != "none"
    g = jcfg.num_kv_heads if granule == "head" else 1
    b, t0, bs, nb, blocks = 3, 10, 16, 8, 30
    tables = np.random.default_rng(4).permutation(blocks)[:b * nb].reshape(
        b, nb).astype(np.int32)
    idx = np.asarray(jatt_paged(tables, bs))
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (b, t0)).astype(np.int32)
    jdense = jllama.init_cache(jcfg, b, nb * bs, jnp.float32, quantized=kvq,
                               scale_granule=g)
    _, jdense = jllama.forward(params, jcfg, jnp.asarray(prompt),
                               jnp.asarray(np.tile(np.arange(t0), (b, 1))),
                               jdense, jnp.zeros((b,), jnp.int32),
                               blockwise=True)
    dense = [None if a is None else np.asarray(a) for a in jdense]
    jcache = jllama.KVCache(*(None if a is None else jnp.asarray(a) for a in
                              _pool_from_dense(dense, idx, blocks, bs, False)))
    tcache = tllama.KVCache(*(None if a is None else torch.from_numpy(a) for a
                              in _pool_from_dense(dense, idx, blocks, bs,
                                                  True)))
    rng = np.random.default_rng(6)
    tol = (2e-3 if kvq else REL_TOL)
    pos = t0
    for step, t in enumerate((1, 1, 4, 1)):
        toks = rng.integers(0, jcfg.vocab_size, (b, t)).astype(np.int32)
        mask = np.array([True, step % 2 == 0, True])
        p = np.full((b,), pos, np.int32)
        jl, jcache = _jax_paged_decode(jcfg, nb * bs, bs)(
            params, tokens=jnp.asarray(toks), positions=jnp.asarray(p),
            cache=jcache, write_mask=jnp.asarray(mask),
            block_table=jnp.asarray(tables))
        tl, _ = tllama.forward_decode_multi(
            tparams, tcfg, torch.from_numpy(toks).long(),
            torch.from_numpy(p).long(), tcache, torch.from_numpy(mask),
            attn_len=nb * bs, block_table=torch.from_numpy(tables),
            block_size=bs)
        jl, tl = np.asarray(jl), tl.numpy()
        span = float(np.ptp(jl))
        err = float(np.abs(jl - tl)[mask].max())
        assert err <= tol * span, (step, err, span)
        pos += t
    # The rows the tables reach agree (masked rows wrote nothing there):
    # float rows to 1e-5, int8 rows to one step, scales to a few ulps.
    live = idx.reshape(-1)
    for name, a_j, a_t in zip(("k", "v", "k_scale", "v_scale"), jcache,
                              tcache):
        if a_j is not None:
            tol = (dict(rtol=0, atol=1) if name in ("k", "v") and kvq
                   else dict(rtol=1e-6, atol=1e-5))
            np.testing.assert_allclose(a_t.numpy()[:, live].astype(np.float64),
                                       np.asarray(a_j)[:, live], **tol,
                                       err_msg=name)


def jatt_paged(tables, bs):
    from fasttalk_tpu.ops.attention import paged_gather_indices

    return paged_gather_indices(jnp.asarray(tables), bs)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_equals_dense_decode_exactly(quantized):
    """The port's paged tier against its own dense tier in bf16: the same
    rows gathered in logical order give the same logits bit for bit."""
    cfg = get_model_config("test-tiny")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(7),
                                torch.bfloat16, "cpu")
    b, t0, bs, nb, blocks = 3, 12, 16, 8, 40
    s = nb * bs
    dense = tllama.init_cache(cfg, b, s, torch.bfloat16, "cpu",
                              quantized=quantized)
    paged = tllama.init_paged_cache(cfg, blocks, bs, torch.bfloat16, "cpu",
                                    quantized=quantized)
    tables = torch.from_numpy(np.random.default_rng(8).permutation(
        blocks)[:b * nb].reshape(b, nb).astype(np.int32))
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (b, t0)))
    lg, _ = tllama.forward(params, cfg, prompt,
                           torch.arange(t0)[None].expand(b, t0), dense,
                           torch.zeros(b, dtype=torch.long), blockwise=True)
    idx = jatt_paged(tables.numpy(), bs)
    idx = torch.from_numpy(np.array(idx)).long()
    for dst, src in zip(paged, dense):
        if dst is not None:
            for i in range(b):
                dst[:, idx[i]] = src[:, i]
    cur = lg[:, -1].argmax(-1)
    mask = torch.tensor([True, False, True])
    for step in range(4):
        p = torch.full((b,), t0 + step)
        ld, _ = tllama.forward_decode(params, cfg, cur, p, dense, mask,
                                      attn_len=s)
        lp, _ = tllama.forward_decode(params, cfg, cur, p, paged, mask,
                                      attn_len=s, block_table=tables,
                                      block_size=bs)
        assert torch.equal(ld, lp), step
        cur = ld.argmax(-1)


@pytest.mark.parametrize("granule", ["token", "head"])
def test_int8_kv_prefill_and_decode_logits_match_jax(granule):
    """The dense int8 KV tier end to end on random test-tiny weights: each
    package prefills its own int8 cache (quantize on write, dequantized
    attention read) and decodes eight steps on a shared random token
    stream. Tolerance 2e-3 of the logit range: the same one-ulp scale
    allowance as the paged test (JAX's decode is jitted)."""
    jcfg, tcfg = jax_model_config("test-tiny"), get_model_config("test-tiny")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(9), jnp.float32)
    tparams = from_jax_params(_numpy_tree(params), "cpu")
    g = jcfg.num_kv_heads if granule == "head" else 1
    b, t, s = 2, 12, 512
    prompt = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    jcache = jllama.init_cache(jcfg, b, s, jnp.float32, quantized=True,
                               scale_granule=g)
    tcache = tllama.init_cache(tcfg, b, s, torch.float32, "cpu",
                               quantized=True, scale_granule=g)
    jl, jcache = jllama.forward(params, jcfg, jnp.asarray(prompt),
                                jnp.asarray(pos), jcache,
                                jnp.zeros((b,), jnp.int32), blockwise=True)
    tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(prompt).long(),
                           torch.from_numpy(pos).long(), tcache,
                           torch.zeros((b,), dtype=torch.long),
                           blockwise=True)
    outs = [(np.asarray(jl), tl.numpy())]
    np.testing.assert_array_equal(tcache.k.numpy()[:, :, :t],
                                  np.asarray(jcache.k)[:, :, :t])
    rng = np.random.default_rng(11)
    fn = _jax_decode(jcfg, s, True)
    mask = np.ones((b,), bool)
    for i in range(8):
        tok = rng.integers(0, jcfg.vocab_size, (b,)).astype(np.int32)
        p = np.full((b,), t + i, np.int32)
        jl, jcache = fn(params, cur=jnp.asarray(tok), positions=jnp.asarray(p),
                        cache=jcache, write_mask=jnp.asarray(mask))
        tl, _ = tllama.forward_decode(tparams, tcfg,
                                      torch.from_numpy(tok).long(),
                                      torch.from_numpy(p).long(), tcache,
                                      torch.from_numpy(mask), attn_len=s)
        outs.append((np.asarray(jl), tl.numpy()))
    for step, (jl, tl) in enumerate(outs):
        span = float(np.ptp(jl))
        assert float(np.abs(jl - tl).max()) <= 2e-3 * span, step

