"""fasttalk_tpu_torch ops held against the JAX package's ops on the CPU.

Inputs come from a numpy seed and go through both packages in float32.
The JAX Pallas kernels run in interpret mode, as tests/test_pallas_int8.py
and tests/test_pallas_attention.py run them; the port's kernel wrappers
run their plain versions because the tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fasttalk_tpu.models.configs import get_model_config as jax_model_config
from fasttalk_tpu.models.llama import rms_norm as jax_rms_norm
from fasttalk_tpu.ops import attention as jatt
from fasttalk_tpu.ops import kv_quant as jkvq
from fasttalk_tpu.ops import quant as jquant
from fasttalk_tpu.ops import rope as jrope
from fasttalk_tpu.ops import sampling as jsamp
from fasttalk_tpu.ops.pallas_attention import decode_attend as jax_decode_attend
from fasttalk_tpu.ops.pallas_attention import \
    decode_attend_paged as jax_decode_attend_paged
from fasttalk_tpu.ops.pallas_int8 import int8_matmul as jax_int8_matmul
from fasttalk_tpu.ops.pallas_int8 import int8_matmul_t as jax_int8_matmul_t
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import rms_norm
from fasttalk_tpu_torch.ops import attention as tatt
from fasttalk_tpu_torch.ops import kv_quant as tkvq
from fasttalk_tpu_torch.ops import quant as tquant
from fasttalk_tpu_torch.ops import rope as trope
from fasttalk_tpu_torch.ops import sampling as tsamp
from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                   decode_attend_paged)
from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t

# float32 on both sides: differences come from summation order only.
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_rope_frequencies_with_llama32_scaling_are_identical():
    for name in ("llama3.2:1b", "test-tiny"):
        jc, tc = jax_model_config(name), get_model_config(name)
        np.testing.assert_array_equal(
            jrope.rope_frequencies(jc.head_dim, jc.rope_theta, jc.rope_scaling),
            trope.rope_frequencies(tc.head_dim, tc.rope_theta, tc.rope_scaling))


def test_apply_rope_matches_jax():
    cfg = get_model_config("llama3.2:1b")
    inv = trope.rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    x = _rng(1).standard_normal((2, 5, 4, cfg.head_dim)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [100, 900, 5000, 8191, 20000]], np.int32)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv))
    got = trope.apply_rope(_t(x), _t(pos).long(), _t(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_rms_norm_matches_jax():
    x = _rng(2).standard_normal((3, 7, 64)).astype(np.float32)
    w = _rng(3).standard_normal((64,)).astype(np.float32)
    ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(rms_norm(_t(x), _t(w), 1e-5).numpy(),
                               np.asarray(ref), **TOL)


def _qkv(seed, b, t, nq, nkv, d, s):
    r = _rng(seed)
    return (r.standard_normal((b, t, nq, d)).astype(np.float32),
            r.standard_normal((b, s, nkv, d)).astype(np.float32),
            r.standard_normal((b, s, nkv, d)).astype(np.float32))


@pytest.mark.parametrize("blockwise", [False, True])
def test_attend_matches_jax(blockwise):
    q, k, v = _qkv(4, 2, 6, 4, 2, 16, 1024)
    pos = np.array([[0, 1, 2, 3, 4, 5], [600, 601, 602, 603, 604, 605]],
                   np.int32)
    jf, tf = ((jatt.attend_blockwise, tatt.attend_blockwise) if blockwise
              else (jatt.attend, tatt.attend))
    ref = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    got = tf(_t(q), _t(k), _t(v), _t(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_quantize_math_is_bit_exact():
    w = _rng(5).standard_normal((3, 64, 96)).astype(np.float32)
    # Values exactly halfway between two int8 steps exercise round-half-even.
    w[0, :, 0] = np.arange(64, dtype=np.float32) - 31.5
    qj, sj = jquant.quantize_math_out(jnp.asarray(w))
    qt, st = tquant.quantize_math_out(_t(w))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    qj, sj = jquant.quantize_math_row(jnp.asarray(w[0]))
    qt, st = tquant.quantize_math_row(_t(w[0]))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_params_is_bit_exact():
    r = _rng(6)
    p = {"embed": r.standard_normal((384, 64)).astype(np.float32),
         "final_norm": np.ones((64,), np.float32),
         "lm_head": r.standard_normal((64, 384)).astype(np.float32),
         "layers": {"wq": r.standard_normal((2, 64, 64)).astype(np.float32),
                    "attn_norm": np.ones((2, 64), np.float32)}}
    qj = jax.tree.map(np.asarray, jquant.quantize_params(
        jax.tree.map(jnp.asarray, p)))
    qt = tquant.quantize_params(jax.tree.map(_t, p))
    for path in (("embed", "q"), ("embed", "s"), ("lm_head", "qt"),
                 ("lm_head", "s"), ("layers", "wq", "q"),
                 ("layers", "wq", "s"), ("layers", "attn_norm")):
        a, b = qj, qt
        for key in path:
            a, b = a[key], b[key]
        if path[-1] == "s":
            # Under jit XLA turns ``max / 127`` into ``max * (1 / 127)``:
            # the scales may differ by one float32 ulp, the int8 values
            # may not.
            np.testing.assert_allclose(b.numpy(), a, rtol=1.2e-7, atol=0)
        else:
            np.testing.assert_array_equal(b.numpy(), a)


def _quantized(seed, k, n):
    w = _rng(seed).standard_normal((k, n)).astype(np.float32)
    q, s = jquant.quantize_math_out(jnp.asarray(w))
    return np.asarray(q), np.asarray(s)


def test_int8_matmul_plain_matches_pallas_kernel():
    x = _rng(7).standard_normal((16, 256)).astype(np.float32)
    q, s = _quantized(8, 256, 384)
    ref = jax_int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                          interpret=True)
    np.testing.assert_allclose(int8_matmul(_t(x), _t(q), _t(s)).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_int8_matmul_t_plain_matches_pallas_kernel():
    x = _rng(9).standard_normal((4, 256)).astype(np.float32)
    emb = _rng(10).standard_normal((512, 256)).astype(np.float32)
    q, s = jquant.quantize_math_row(jnp.asarray(emb))
    ref = jax_int8_matmul_t(jnp.asarray(x), q, s, interpret=True)
    got = int8_matmul_t(_t(x), _t(np.asarray(q)), _t(np.asarray(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("t", [1, 3, 8])
def test_decode_attend_plain_matches_pallas_kernel(t):
    b, s, nq, nkv, d = 4, 256, 8, 2, 32
    q, k, v = _qkv(11, b, t, nq, nkv, d, s)
    lengths = np.array([t, 127, 129, 256], np.int32)
    qin = q[:, 0] if t == 1 else q
    ref = jax_decode_attend(jnp.asarray(qin), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), interpret=True)
    got = decode_attend(_t(qin), _t(k), _t(v), _t(lengths))
    assert got.shape == qin.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _kv_int8(seed, shape, g, mult=1.0):
    """K/V rows quantized by the JAX package (numpy out)."""
    x = _rng(seed).standard_normal(shape).astype(np.float32) * mult
    q, s = jkvq.kv_quantize(jnp.asarray(x), g)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("granule", ["token", "head"])
@pytest.mark.parametrize("t", [1, 4, 8])
def test_decode_attend_int8_plain_matches_pallas_kernel(granule, t):
    """Int8 rows + [B, S, G] scales: the plain version against the Pallas
    kernel's fused-dequant tier in interpret mode (both dequantize in f32
    before the dot products)."""
    b, s, nq, nkv, d = 4, 256, 8, 2, 32
    g = tkvq.granule_dim(granule, nkv)
    q = _rng(20).standard_normal((b, t, nq, d)).astype(np.float32)
    k, ks = _kv_int8(21, (b, s, nkv, d), g, 2.0)
    v, vs = _kv_int8(22, (b, s, nkv, d), g, 0.5)
    lengths = np.array([t, 128, 129, 256], np.int32)
    qin = q[:, 0] if t == 1 else q
    ref = jax_decode_attend(jnp.asarray(qin), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs), interpret=True)
    got = decode_attend(_t(qin), _t(k), _t(v), _t(lengths), k_scale=_t(ks),
                        v_scale=_t(vs))
    assert got.shape == qin.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [1, 4, 8])
def test_decode_attend_paged_plain_matches_pallas_kernel(int8, t):
    """The paged block walk over scrambled tables (distinct shuffled pool
    blocks per slot), lengths straddling block edges, bf16-tier f32 rows
    and int8 rows with head-granule pool scales [P, G]."""
    b, nq, nkv, d, bs, nb, pool_blocks = 4, 8, 2, 32, 16, 8, 40
    perm = _rng(23).permutation(pool_blocks)[:b * nb]
    tables = perm.reshape(b, nb).astype(np.int32)
    q = _rng(24).standard_normal((b, t, nq, d)).astype(np.float32)
    shape = (pool_blocks * bs, nkv, d)
    if int8:
        (k, ks), (v, vs) = _kv_int8(25, shape, nkv, 3.0), _kv_int8(26, shape,
                                                                   nkv)
    else:
        k = _rng(25).standard_normal(shape).astype(np.float32)
        v = _rng(26).standard_normal(shape).astype(np.float32)
        ks = vs = None
    lengths = np.array([t, 16, 17, 128], np.int32)
    qin = q[:, 0] if t == 1 else q
    opt = (lambda a, f: None if a is None else f(a))  # noqa: E731
    ref = jax_decode_attend_paged(
        jnp.asarray(qin), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), jnp.asarray(tables), block_size=bs,
        k_scale=opt(ks, jnp.asarray), v_scale=opt(vs, jnp.asarray),
        interpret=True)
    got = decode_attend_paged(_t(qin), _t(k), _t(v), _t(lengths), _t(tables),
                              block_size=bs, k_scale=opt(ks, _t),
                              v_scale=opt(vs, _t))
    assert got.shape == qin.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_paged_gather_indices_and_rows_match_jax():
    tables = _rng(27).permutation(12)[:8].reshape(2, 4).astype(np.int32)
    ref = jatt.paged_gather_indices(jnp.asarray(tables), 16)
    got = tatt.paged_gather_indices(_t(tables), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pool = _rng(28).standard_normal((12 * 16, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tatt.gather_paged_rows(_t(pool), got).numpy(),
        np.asarray(jatt.gather_paged_rows(jnp.asarray(pool), ref)))


@pytest.mark.parametrize("tlen", [1, 4])
def test_quant_matmul_and_head_match_jax(tlen):
    """T=1 takes the kernel path on both sides (Pallas interpret / the plain
    version); T>1 is the dequant matmul on both sides."""
    x = _rng(12).standard_normal((2, tlen, 128)).astype(np.float32)
    q, s = _quantized(13, 128, 256)
    leaf_j, leaf_t = {"q": jnp.asarray(q), "s": jnp.asarray(s)}, \
        {"q": _t(q), "s": _t(s)}
    ref = jquant.matmul(jnp.asarray(x), leaf_j, pallas_ok=True)
    np.testing.assert_allclose(tquant.matmul(_t(x), leaf_t).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    emb = _rng(14).standard_normal((256, 128)).astype(np.float32)
    eq, es = jquant.quantize_math_row(jnp.asarray(emb))
    ej, et = {"q": eq, "s": es}, {"q": _t(np.asarray(eq)),
                                  "s": _t(np.asarray(es))}
    ref = jquant.matmul_tied(jnp.asarray(x), ej, pallas_ok=True)
    np.testing.assert_allclose(tquant.matmul_tied(_t(x), et).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    toks = np.array([[0, 5, 255]], np.int32)
    np.testing.assert_array_equal(
        tquant.embed_lookup(et, _t(toks).long(), torch.float32).numpy(),
        np.asarray(jquant.embed_lookup(ej, jnp.asarray(toks), jnp.float32)))


def test_penalties_match_jax():
    r = _rng(15)
    logits = r.standard_normal((3, 50)).astype(np.float32)
    counts = r.integers(0, 3, (3, 50)).astype(np.int32)
    rep = np.array([1.0, 1.3, 0.8], np.float32)
    pres = np.array([0.0, 0.5, -0.2], np.float32)
    freq = np.array([0.0, 0.1, 0.3], np.float32)
    ref = jsamp.apply_penalties(*(jnp.asarray(a) for a in
                                  (logits, counts, rep, pres, freq)))
    got = tsamp.apply_penalties(*(_t(a) for a in
                                  (logits, counts, rep, pres, freq)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("method", ["exact", "fast"])
def test_greedy_sampling_matches_jax(method):
    logits = _rng(16).standard_normal((5, 1000)).astype(np.float32)
    zeros = np.zeros(5, np.float32)
    ref = jsamp.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                              jnp.asarray(zeros), jnp.zeros(5, jnp.int32),
                              jnp.ones(5), method=method)
    got = tsamp.sample_tokens(_t(logits), torch.Generator().manual_seed(0),
                              _t(zeros), torch.zeros(5, dtype=torch.long),
                              torch.ones(5), method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_top_k_top_p_sampling_matches_jax_in_distribution():
    """Both packages sample the same temperature/top-k/top-p distribution:
    empirical frequencies over 4000 draws each sit within 0.03 of the
    analytic distribution (about 4 standard errors)."""
    n, temp, top_k, top_p = 4000, 0.8, 4, 0.9
    row = np.array([2.0, 1.6, 1.2, 0.9, 0.5, -1.0, -3.0, 0.0], np.float32)
    scaled = row / temp
    order = np.argsort(-scaled)
    kept = order[:top_k]
    p = np.exp(scaled[kept] - scaled[kept].max())
    p /= p.sum()
    cum = np.cumsum(p)
    keep = (cum - p) < top_p
    expect = np.zeros_like(row)
    expect[kept[keep]] = p[keep] / p[keep].sum()

    logits = np.tile(row, (n, 1))
    args = (np.full(n, temp, np.float32), np.full(n, top_k, np.int32),
            np.full(n, top_p, np.float32))
    ref = np.asarray(jsamp.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(3),
        *(jnp.asarray(a) for a in args), max_candidates=8))
    got = tsamp.sample_tokens(_t(logits), torch.Generator().manual_seed(3),
                              _t(args[0]), _t(args[1]).long(), _t(args[2]),
                              max_candidates=8).numpy()
    for draws in (ref, got):
        freq = np.bincount(draws, minlength=row.size) / n
        np.testing.assert_allclose(freq, expect, atol=0.03)
        assert set(np.unique(draws)) <= set(kept[keep])
