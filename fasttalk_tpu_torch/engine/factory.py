"""Engine construction from the serving Config.

Counterpart of ``fasttalk_tpu/engine/factory.py::build_engine`` (:224)
for the port's slice: resolve the model config, check weights and KV cache
against the card's memory budget (``check_hbm_budget``, :84), load the
checkpoint under MODEL_PATH (or random-initialise on the device when there
is none), quantize the matmul weights and the embedding to int8 when
WEIGHT_QUANT asks for it, load the tokenizer, and build the
``TorchEngine`` with the KV tier settings.
"""

from __future__ import annotations

import os

import torch

from fasttalk_tpu_torch.engine.engine import TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import HFTokenizer, load_tokenizer
from fasttalk_tpu_torch.models.configs import ModelConfig, get_model_config
from fasttalk_tpu_torch.models.loader import (find_checkpoint_dir,
                                              init_params_device, load_params)
from fasttalk_tpu_torch.ops.kv_quant import granule_dim
from fasttalk_tpu_torch.utils.config import Config, resolve_device
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("engine.factory")

# The 32k BPE the JAX package bundles for weight-free serving. It is a
# data file, read in place (no copy is kept in this package).
BENCH_TOKENIZER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "fasttalk_tpu", "assets", "bench_tokenizer.json")


def weight_bytes(m: ModelConfig, dsize: int, int8: bool) -> int:
    """Device bytes of the weights: int8 matmuls and embedding with f32
    scales, or everything in the serving dtype (norm scales always are)."""
    norm_params = (2 * m.num_layers + 1) * m.hidden_size
    if not int8:
        return m.param_count() * dsize
    matmul = m.num_layers * (m.hidden_size * m.q_dim
                             + 2 * m.hidden_size * m.kv_dim
                             + m.q_dim * m.hidden_size
                             + 3 * m.hidden_size * m.intermediate_size)
    scales = m.num_layers * (m.q_dim + 2 * m.kv_dim + 2 * m.hidden_size
                             + 2 * m.intermediate_size)
    tables = 1 if m.tie_embeddings else 2
    table = tables * m.hidden_size * m.vocab_size
    other = m.param_count() - matmul - table - norm_params  # qkv biases
    return (matmul + table + (scales + tables * m.vocab_size) * 4
            + (other + norm_params) * dsize)


def check_hbm_budget(m: ModelConfig, cfg: Config, dsize: int,
                     device: torch.device) -> dict:
    """Account weights + KV cache against the card's memory before any
    allocation, so bad TPU_DECODE_SLOTS / TPU_MAX_MODEL_LEN / KV settings
    fail with a named message instead of an out-of-memory error mid-load.

    KV rows cost int8 bytes plus f32 scales on the int8 tier. The paged
    tier is priced by pool blocks; ``KV_POOL_BLOCKS=0`` asks for the
    dense-equivalent pool and shrinks it to what the budget holds (floored
    at one TPU_MAX_MODEL_LEN context). Returns the accounting (bytes);
    raises ValueError over budget. Skips the budget on the CPU."""
    if cfg.kv_quant == "int8":
        g = granule_dim(cfg.kv_quant_granule, m.num_kv_heads)
        row = 2 * (m.num_kv_heads * m.head_dim + g * 4)
    else:
        row = 2 * m.num_kv_heads * m.head_dim * dsize
    row *= m.num_layers  # one token's K/V rows over all layers
    wbytes = weight_bytes(m, dsize, cfg.weight_quant == "int8")
    dense_rows = cfg.decode_slots * cfg.max_model_len
    paged = cfg.kv_layout == "paged"
    bs = cfg.kv_block_size
    pool_blocks = (cfg.kv_pool_blocks or dense_rows // bs) if paged else 0
    kv = pool_blocks * bs * row if paged else dense_rows * row
    limit = (torch.cuda.mem_get_info(device)[1] if device.type == "cuda"
             else None)
    acct = {"weight_bytes": wbytes, "kv_cache_bytes": kv,
            "limit_bytes": limit, "kv_pool_blocks": pool_blocks}
    if not limit:
        return acct
    budget = limit * cfg.hbm_util
    block_bytes = bs * row
    fit_blocks = max(0, int((budget - wbytes) // block_bytes))
    if paged and not cfg.kv_pool_blocks:
        floor = -(-cfg.max_model_len // bs)
        if fit_blocks < floor:
            raise ValueError(
                f"KV_LAYOUT=paged: the memory budget holds only "
                f"{fit_blocks} KV blocks of {bs} tokens after "
                f"{wbytes / 2**30:.2f} GiB of weights, below the {floor} "
                f"blocks one TPU_MAX_MODEL_LEN={cfg.max_model_len} context "
                "needs. Lower TPU_MAX_MODEL_LEN, enable KV_QUANT=int8, or "
                "raise TPU_HBM_UTILIZATION.")
        pool_blocks = min(pool_blocks, fit_blocks)
        acct["kv_pool_blocks"] = pool_blocks
        acct["kv_cache_bytes"] = kv = pool_blocks * block_bytes
    need = wbytes + kv
    if need > budget:
        if paged:
            remedy = (f"Lower KV_POOL_BLOCKS ({pool_blocks}; 0 = fit to the "
                      f"budget), KV_BLOCK_SIZE ({bs}) or TPU_MAX_MODEL_LEN "
                      f"({cfg.max_model_len}); enable KV_QUANT=int8 or "
                      "WEIGHT_QUANT=int8; or raise TPU_HBM_UTILIZATION.")
        else:
            remedy = (f"The dense layout preallocates every slot at its "
                      f"whole context: TPU_DECODE_SLOTS={cfg.decode_slots} x "
                      f"TPU_MAX_MODEL_LEN={cfg.max_model_len} = {dense_rows} "
                      f"KV rows ({dense_rows // bs} blocks of {bs} tokens), "
                      f"but the budget holds only {fit_blocks} blocks after "
                      "the weights. Set KV_LAYOUT=paged to admit by blocks in "
                      f"use (KV_BLOCK_SIZE={bs}), enable KV_QUANT=int8 or "
                      "WEIGHT_QUANT=int8, lower TPU_DECODE_SLOTS / "
                      "TPU_MAX_MODEL_LEN, or raise TPU_HBM_UTILIZATION.")
        raise ValueError(
            f"Model + KV cache need {need / 2**30:.2f} GiB but the memory "
            f"budget is {budget / 2**30:.2f} GiB ({limit / 2**30:.2f} GiB x "
            f"TPU_HBM_UTILIZATION={cfg.hbm_util}). {remedy}")
    return acct


def build_engine(cfg: Config, device: str | torch.device | None = None,
                 seed: int = 0) -> TorchEngine:
    dev = resolve_device(device)
    model_cfg = get_model_config(cfg.model_name, cfg.model_path)
    dtype = cfg.torch_dtype
    int8 = cfg.weight_quant == "int8"
    acct = check_hbm_budget(model_cfg, cfg, torch.finfo(dtype).bits // 8, dev)
    ckpt = find_checkpoint_dir(cfg.model_path, model_cfg.name) \
        if cfg.model_path else None
    if ckpt:
        params = load_params(model_cfg, ckpt, dtype, dev, quantize=int8)
    else:
        log.warning(f"No checkpoint for {model_cfg.name!r} under "
                    f"{cfg.model_path!r}; using random-initialised weights")
        params = init_params_device(model_cfg, dtype, dev, quantize=int8,
                                    seed=seed)
    tokenizer = load_tokenizer(cfg.model_path, cfg.model_name,
                               template=model_cfg.chat_template)
    if not ckpt and getattr(tokenizer, "vocab_size", 0) <= 512 \
            and os.path.isfile(BENCH_TOKENIZER):
        # Weight-free serving only: the byte fallback would inflate an
        # English prompt ~6x; prefer the bundled real BPE when the model
        # vocabulary can hold it.
        cand = HFTokenizer(BENCH_TOKENIZER, template=model_cfg.chat_template)
        if cand.vocab_size <= model_cfg.vocab_size:
            tokenizer = cand
    log.info(f"Building torch engine: model={model_cfg.name} "
             f"({model_cfg.param_count() / 1e9:.2f}B params, weights "
             f"{'loaded' if ckpt else 'random-init'}), device={dev}, "
             f"slots={cfg.decode_slots}, max_len={cfg.max_model_len}, "
             f"dtype={cfg.dtype}, weight_quant={cfg.weight_quant}, "
             f"kv_layout={cfg.kv_layout}, kv_quant={cfg.kv_quant}, "
             f"kv_cache={acct['kv_cache_bytes'] / 2**30:.3f} GiB")
    return TorchEngine(
        model_cfg, params, tokenizer, device=dev,
        num_slots=cfg.decode_slots, max_len=cfg.max_model_len,
        prefill_chunk=cfg.prefill_chunk, dtype=dtype, seed=seed,
        context_window=min(cfg.default_context_window, cfg.max_model_len),
        steps_per_call=cfg.decode_steps_per_call,
        pipeline_depth=cfg.pipeline_depth,
        kv_quant=cfg.kv_quant, kv_quant_granule=cfg.kv_quant_granule,
        kv_layout=cfg.kv_layout, kv_block_size=cfg.kv_block_size,
        kv_pool_blocks=acct["kv_pool_blocks"],
        kv_reserve_policy=cfg.kv_reserve_policy,
        kv_reserve_tokens=cfg.kv_reserve_tokens)
