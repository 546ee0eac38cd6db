"""The port's weight loading held against the JAX package and transformers.

- ``load_params`` on a random-init ``LlamaForCausalLM`` checkpoint gives
  the transformers logits (the JAX package's ``TestHFGoldenParity``,
  tests/test_model_numerics.py:257, at its tolerance).
- A ``cfg.quantize`` assigned after ``Config()`` picks the weight tier in
  both factories alike (JAX ``_effective_weight_quant``).
- The prepared-weight cache is written on a ``prepared-cache-save``
  thread: ``build_engine`` returns before the write ends, a reader never
  sees a half-written cache, and the next build restores the finished one.
"""

import threading

import numpy as np
import pytest
import torch

from tests._port_isolation import port_isolation  # noqa: F401

HF_TOL = 2e-3  # rtol and atol of the JAX package's HF parity test


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _hf_checkpoint(path, seed: int = 0):
    """A random-init transformers Llama of test-tiny's shape, saved as a
    safetensors checkpoint (tied head: no ``lm_head.weight``)."""
    from safetensors.torch import save_file
    from transformers import LlamaConfig, LlamaForCausalLM

    from fasttalk_tpu_torch.models.configs import get_model_config

    tiny = get_model_config("test-tiny")
    hf_cfg = LlamaConfig(
        vocab_size=tiny.vocab_size, hidden_size=tiny.hidden_size,
        intermediate_size=tiny.intermediate_size,
        num_hidden_layers=tiny.num_layers,
        num_attention_heads=tiny.num_heads,
        num_key_value_heads=tiny.num_kv_heads, head_dim=tiny.head_dim,
        rope_theta=tiny.rope_theta, rms_norm_eps=tiny.rms_eps,
        tie_word_embeddings=True, max_position_embeddings=tiny.max_position,
        attention_bias=False, mlp_bias=False)
    torch.manual_seed(seed)
    model = LlamaForCausalLM(hf_cfg).eval()
    path.mkdir(parents=True, exist_ok=True)
    state = {k: v.contiguous() for k, v in model.state_dict().items()
             if k != "lm_head.weight"}
    save_file(state, str(path / "model.safetensors"))
    return tiny, model


def test_loader_logits_match_transformers_llama(tmp_path):
    from fasttalk_tpu_torch.models import llama
    from fasttalk_tpu_torch.models.loader import load_params

    tiny, hf_model = _hf_checkpoint(tmp_path / "test-tiny")
    params = load_params(tiny, str(tmp_path / "test-tiny"),
                         dtype=torch.float32, device="cpu")
    t = 12
    tokens = np.random.RandomState(42).randint(0, tiny.vocab_size, (1, t))
    with torch.no_grad():
        want = hf_model(torch.tensor(tokens)).logits.numpy()
    cache = llama.init_cache(tiny, 1, 32, torch.float32, "cpu")
    got, _ = llama.forward(params, tiny, torch.tensor(tokens),
                           torch.arange(t)[None], cache,
                           torch.zeros(1, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, rtol=HF_TOL, atol=HF_TOL)


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)


@pytest.mark.parametrize("legacy", ["int8", "none"])
def test_quantize_assigned_after_config_picks_the_same_tier_as_jax(
        monkeypatch, legacy):
    from fasttalk_tpu.engine.factory import build_engine as jax_build
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in {"LLM_MODEL": "test-tiny", "MODEL_PATH": "",
                 "TPU_DECODE_SLOTS": "2", "TPU_MAX_MODEL_LEN": "256",
                 "TPU_WARMUP": "off", "TPU_SPEC_DECODE": "off",
                 "TPU_DTYPE": "float32"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("WEIGHT_QUANT", raising=False)
    monkeypatch.delenv("TPU_QUANTIZE", raising=False)
    got = {}
    for pkg, cfg, build in (
            ("jax", JaxConfig(), jax_build),
            ("torch", Config(), lambda c: build_engine(c, device="cpu"))):
        assert cfg.weight_quant == "off"
        cfg.quantize = legacy  # after construction: __post_init__ is past
        eng = build(cfg)
        got[pkg] = (eng.weight_quant, _tree_nbytes(eng.params))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("int8" if legacy == "int8" else "off")


def test_prepared_cache_write_finishes_off_the_startup_path(monkeypatch,
                                                            tmp_path):
    import safetensors.torch

    from fasttalk_tpu_torch.engine import factory
    from fasttalk_tpu_torch.models.prepared_cache import (cache_dir,
                                                          cache_meta,
                                                          load_prepared)
    from fasttalk_tpu_torch.utils.config import Config

    ckpt = tmp_path / "model"
    tiny, _ = _hf_checkpoint(ckpt, seed=3)
    for k, v in {"LLM_MODEL": "test-tiny", "MODEL_PATH": str(ckpt),
                 "WEIGHT_QUANT": "int8", "TPU_DECODE_SLOTS": "2",
                 "TPU_MAX_MODEL_LEN": "256", "TPU_WARMUP": "off",
                 "TPU_SPEC_DECODE": "off", "TPU_DTYPE": "float32"}.items():
        monkeypatch.setenv(k, v)
    release, written = threading.Event(), threading.Event()
    real_save = safetensors.torch.save_file

    def slow_save(tensors, filename, *a, **kw):
        # The tensors land in the temporary directory, then the write
        # waits: the cache is half written for as long as the test likes.
        real_save(tensors, filename, *a, **kw)
        written.set()
        assert release.wait(60), "the test never released the write"

    monkeypatch.setattr(safetensors.torch, "save_file", slow_save)
    cfg = Config()
    first = factory.build_engine(cfg, device="cpu")
    assert first.weight_quant == "int8"
    saver = [t for t in threading.enumerate()
             if t.name == "prepared-cache-save"]
    assert len(saver) == 1 and not saver[0].daemon
    assert written.wait(60)
    meta = cache_meta(tiny, torch.float32, "int8", str(ckpt))
    path = cache_dir(str(ckpt), meta)
    # Half written: the tensors exist in a temporary directory only, and
    # neither a reader nor the cache directory sees them.
    assert load_prepared(tiny, str(ckpt), torch.float32, "int8", str(ckpt),
                         device="cpu") is None
    assert not (tmp_path / "model" / ".prepared_torch").joinpath(
        path.rsplit("/", 1)[-1]).exists()
    release.set()
    saver[0].join(60)
    assert not saver[0].is_alive()

    def no_load(*a, **kw):
        raise AssertionError("the second build must restore the cache")

    monkeypatch.setattr(factory, "load_params", no_load)
    second = factory.build_engine(cfg, device="cpu")
    for name in ("wq", "w_down"):
        for leaf in ("q", "s"):
            assert torch.equal(second.params["layers"][name][leaf],
                               first.params["layers"][name][leaf])
    assert torch.equal(second.params["embed"]["q"], first.params["embed"]["q"])
