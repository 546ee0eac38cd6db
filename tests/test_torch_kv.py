"""fasttalk_tpu_torch's KV-tier plumbing held against the JAX package.

The int8 row quantization (bit for bit against eager JAX), the paged
tier's block allocator (the JAX allocator's discipline: all-or-nothing
``ensure``, ``truncate``, ``release``, the ``check_leaks`` invariant), the
seven KV settings of ``Config`` (names, defaults and the JAX Config's own
rejection messages), the memory budget check of the factory, and the shed
error the serving layer sends.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fasttalk_tpu.kvcache.blocks import BlockAllocator as JaxAllocator
from fasttalk_tpu.ops import kv_quant as jkvq
from fasttalk_tpu.utils.errors import AdmissionRejected as JaxRejected
from fasttalk_tpu_torch.kvcache.blocks import (BlockAllocator, BlockExhausted,
                                               blocks_for)
from fasttalk_tpu_torch.ops import kv_quant as tkvq
from fasttalk_tpu_torch.utils.errors import (ENGINE_SHED_CODES,
                                             AdmissionRejected)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("granule", ["token", "head"])
def test_kv_quantize_is_bit_exact_to_eager_jax(granule):
    """Eager JAX (no jit): the int8 rows and the f32 scales are equal bit
    for bit, round half to even included, and so are the dequantized rows.
    (Under jax.jit XLA may rewrite ``amax / 127`` as ``amax * (1/127)``,
    one float32 ulp of the scale; the jitted model paths are held with a
    logit tolerance in tests/test_torch_model.py.)"""
    x = np.random.default_rng(29).standard_normal((3, 5, 4, 16)) * 3.0
    x = x.astype(np.float32)
    x[0, 0, 0, :] = 0.0                                # an all-zero head row
    x[0, 0] = 0.0 if granule == "token" else x[0, 0]   # an all-zero row
    # Values that land exactly halfway between two int8 steps.
    x[1, 1, :, 0] = 127.0
    x[1, 1, :, 1:9] = np.arange(8, dtype=np.float32) - 3.5
    g = 4 if granule == "head" else 1
    assert tkvq.granule_dim(granule, 4) == g == jkvq.granule_dim(granule, 4)
    qj, sj = jkvq.kv_quantize(jnp.asarray(x), g)
    qt, st = tkvq.kv_quantize(_t(x), g)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tkvq.kv_dequantize(qt, st, torch.float32).numpy(),
        np.asarray(jkvq.kv_dequantize(qj, sj, jnp.float32)))
    with pytest.raises(ValueError, match="KV_QUANT_GRANULE"):
        tkvq.granule_dim("block", 4)


def test_blocks_for_and_a_mirrored_allocator_history():
    """The same ensure/truncate/release history on both allocators gives
    the same tables and free counts; refusal is all or nothing."""
    assert [blocks_for(n, 16) for n in (0, 1, 16, 17, -3)] == [0, 1, 1, 2, 0]
    ours, ref = BlockAllocator(10, 16, 3), JaxAllocator(10, 16, 3)
    history = [("ensure", 0, 40), ("ensure", 1, 17), ("ensure", 2, 16),
               ("ensure", 0, 200), ("truncate", 0, 20), ("ensure", 1, 90),
               ("release", 2, 0), ("ensure", 2, 64), ("ensure", 0, 33)]
    for op, slot, n in history:
        if op == "ensure":
            assert ours.ensure(slot, n) == ref.ensure(slot, n), (op, slot, n)
        elif op == "truncate":
            assert ours.truncate(slot, n) == ref.truncate(slot, n)
        else:
            ours.release(slot)
            ref.release(slot)
        for s in range(3):
            assert ours.table(s) == ref.table(s), (op, slot, n, s)
        assert ours.available() == ref.available()
        ours.check_leaks()
    assert not ours.ensure(0, 16 * 11)            # more than the pool holds
    assert ours.table(0) == ref.table(0)          # nothing taken
    stats = ours.stats(used_tokens=50)
    assert stats["in_use"] == ours.in_use() == 10 - ours.available()
    assert stats["tables"] == [len(ours.table(s)) for s in range(3)]


def test_allocator_refuses_bad_sizes_and_double_frees():
    with pytest.raises(ValueError, match="power of two"):
        BlockAllocator(8, 12, 2)
    with pytest.raises(ValueError, match="num_blocks"):
        BlockAllocator(0, 16, 2)
    a = BlockAllocator(4, 16, 2)
    with pytest.raises(BlockExhausted, match="need 5 blocks"):
        a._take(5)
    a.ensure(0, 16)
    blk = a.table(0)[0]
    a.release(0)
    with pytest.raises(AssertionError, match="double free"):
        a._drop(blk)


def test_shed_error_matches_the_jax_wire_dict():
    event = {"type": "error", "error": "KV block pool exhausted",
             "code": "kv_blocks_exhausted", "retry_after": 1.5}
    assert "kv_blocks_exhausted" in ENGINE_SHED_CODES
    assert AdmissionRejected.from_shed_event(event).to_dict() == \
        JaxRejected.from_shed_event(event).to_dict()


def test_config_takes_the_kv_tier_settings(monkeypatch):
    """The seven KV settings under the JAX package's names and defaults."""
    from fasttalk_tpu_torch.utils.config import Config

    cfg = Config()
    assert (cfg.kv_layout, cfg.kv_quant, cfg.kv_block_size,
            cfg.kv_pool_blocks, cfg.kv_reserve_policy, cfg.kv_reserve_tokens,
            cfg.kv_quant_granule) == ("dense", "none", 16, 0, "fixed", 128,
                                      "token")
    # Int8 KV needs speculative decoding off (the JAX default is auto).
    for k, v in {"KV_LAYOUT": "paged", "KV_QUANT": "int8",
                 "TPU_SPEC_DECODE": "off",
                 "KV_BLOCK_SIZE": "32", "KV_POOL_BLOCKS": "100",
                 "KV_RESERVE_POLICY": "max_tokens", "KV_RESERVE_TOKENS": "7",
                 "KV_QUANT_GRANULE": "head"}.items():
        monkeypatch.setenv(k, v)
    cfg = Config()
    assert (cfg.kv_layout, cfg.kv_quant, cfg.kv_block_size,
            cfg.kv_pool_blocks, cfg.kv_reserve_policy, cfg.kv_reserve_tokens,
            cfg.kv_quant_granule) == ("paged", "int8", 32, 100, "max_tokens",
                                      7, "head")


@pytest.mark.parametrize("env", [
    {"KV_QUANT": "fp8"}, {"KV_QUANT_GRANULE": "block"},
    {"KV_LAYOUT": "sparse"}, {"KV_BLOCK_SIZE": "12"},
    {"KV_BLOCK_SIZE": "1024"}, {"KV_POOL_BLOCKS": "-1"},
    {"KV_RESERVE_POLICY": "greedy"}, {"KV_RESERVE_TOKENS": "-5"},
    {"KV_LAYOUT": "paged", "KV_BLOCK_SIZE": "512",
     "TPU_MAX_MODEL_LEN": "256"}])
def test_config_rejects_bad_kv_settings_as_jax_does(monkeypatch, env):
    """Each bad value fails at startup with the JAX Config's own message."""
    from fasttalk_tpu.utils.config import Config as JaxConfig
    from fasttalk_tpu_torch.utils.config import Config

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as jax_err:
        JaxConfig()
    with pytest.raises(ValueError) as port_err:
        Config()
    want = str(jax_err.value).split(": ", 1)[1].split("; ")
    assert want and all(line in str(port_err.value) for line in want), \
        (want, str(port_err.value))


def test_memory_budget_names_the_kv_remedies(monkeypatch):
    """The budget check on a card (its memory size faked): the dense layout
    over budget names KV_LAYOUT=paged and KV_QUANT=int8; KV_POOL_BLOCKS=0
    shrinks the pool to what the budget holds; weights are accounted as
    the JAX package accounts them. On the CPU the budget is skipped."""
    from fasttalk_tpu.engine.factory import \
        weight_bytes_by_tier as jax_weight_bytes_by_tier
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu_torch.engine.factory import (check_hbm_budget,
                                                   weight_bytes_by_tier)
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.utils.config import Config

    m = get_model_config("llama3.2:1b")
    tiers = jax_weight_bytes_by_tier(jax_cfg("llama3.2:1b"), 2)
    assert weight_bytes_by_tier(m, 2)["off"] == tiers["off"]
    assert weight_bytes_by_tier(m, 2)["int8"] == tiers["int8"]
    cpu = torch.device("cpu")
    acct = check_hbm_budget(m, Config(), 2, cpu)
    assert acct["limit_bytes"] is None
    gib = 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, 12 * gib))
    card = torch.device("cuda")
    big = dict(decode_slots=16, max_model_len=131072, weight_quant="int8")
    with pytest.raises(ValueError, match="KV_LAYOUT=paged") as err:
        check_hbm_budget(m, Config(**big), 2, card)
    assert "KV_QUANT=int8" in str(err.value)
    acct = check_hbm_budget(m, Config(**big, kv_layout="paged"), 2, card)
    row = 2 * m.num_kv_heads * m.head_dim * 2 * m.num_layers
    wbytes = weight_bytes_by_tier(m, 2)["int8"]
    assert acct["kv_pool_blocks"] == int((12 * gib * 0.9 - wbytes)
                                         // (16 * row))
    with pytest.raises(ValueError, match="Lower KV_POOL_BLOCKS"):
        check_hbm_budget(m, Config(**big, kv_layout="paged",
                                   kv_pool_blocks=10 ** 6), 2, card)

