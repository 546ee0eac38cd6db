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
