"""Engine construction from the serving Config.

Counterpart of ``fasttalk_tpu/engine/factory.py::build_engine`` (:224)
for the port's slice: resolve the model config, check weights and KV cache
against the card's memory budget (``check_hbm_budget``, :84), restore the
prepared-weight cache of the checkpoint under MODEL_PATH or load the
checkpoint and write that cache (or random-initialise on the device when
there is no checkpoint), quantize to the WEIGHT_QUANT tier (int8, or int4
group-wise for the seven layer matmuls), load the tokenizer, and build the
``TorchEngine`` with the weight and KV tier settings, the sampling method,
speculative decoding, shared-prefix reuse and the admission scheduler's
settings (``fasttalk_tpu/engine/factory.py`` :395-402).

A mesh (``TPU_TP_SIZE``/``TPU_DP_SIZE``/``TPU_SP_SIZE``, parallel/) is built
after the process group comes up, as the JAX factory does (:258-283):
``maybe_initialize`` then ``make_mesh``; the rank's device is its own card
(``rank_device``) unless the caller names one, the budget is priced per
rank, the weights are loaded or drawn straight into the rank's shards and
the prepared cache is keyed by the mesh and the rank.

``LLM_PROVIDER`` selects the backend as the JAX factory does (:224-250):
``tpu`` is this in-tree engine, ``fake`` the in-memory ``FakeEngine``,
``vllm``/``openai`` and ``ollama`` the HTTP passthrough engines of
engine/remote.py, which need no device.
"""

from __future__ import annotations

import os

import torch

from fasttalk_tpu_torch.engine.engine import EngineBase, TorchEngine
from fasttalk_tpu_torch.engine.fake import FakeEngine
from fasttalk_tpu_torch.engine.tokenizer import HFTokenizer, load_tokenizer
from fasttalk_tpu_torch.models.configs import ModelConfig, get_model_config
from fasttalk_tpu_torch.models.loader import (find_checkpoint_dir,
                                              init_params_device, load_params)
from fasttalk_tpu_torch.models.prepared_cache import (cache_meta,
                                                      load_prepared,
                                                      save_prepared)
from fasttalk_tpu_torch.ops.kv_quant import granule_dim
from fasttalk_tpu_torch.quantization.int4 import validate_group
from fasttalk_tpu_torch.utils.config import Config, resolve_device
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("engine.factory")

# The 32k BPE the JAX package bundles for weight-free serving. It is a
# data file, read in place (no copy is kept in this package).
BENCH_TOKENIZER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "fasttalk_tpu", "assets", "bench_tokenizer.json")


def weight_bytes_by_tier(m: ModelConfig, dsize: int,
                         group: int = 128) -> dict[str, int]:
    """Device bytes of the weights for each WEIGHT_QUANT tier, the one place
    the weight-footprint math lives (budget check, over-budget remedies,
    tests). A copy of ``fasttalk_tpu/engine/factory.py::weight_bytes_by_tier``
    (:29-68) on one device: norm scales stay in the serving dtype; int8
    matmuls and the embedding carry f32 scales per output channel / row;
    int4 packs two matmul weights a byte with one f32 scale per (group x
    out-channel), the embedding (and an untied lm_head) staying int8."""
    norm_params = (2 * m.num_layers + 1) * m.hidden_size
    # The seven stacked layer matmuls (quantization/int4.py INT4_LEAVES).
    matmul_per_layer = (m.hidden_size * m.q_dim
                        + 2 * m.hidden_size * m.kv_dim
                        + m.q_dim * m.hidden_size
                        + 3 * m.hidden_size * m.intermediate_size)
    scales_per_layer = (m.q_dim + 2 * m.kv_dim + m.hidden_size
                        + 2 * m.intermediate_size + m.hidden_size)
    matmul = m.num_layers * matmul_per_layer
    scales8 = m.num_layers * scales_per_layer
    table = m.hidden_size * m.vocab_size
    tscales = m.vocab_size
    if not m.tie_embeddings:
        table += m.hidden_size * m.vocab_size
        tscales += m.vocab_size
    other = m.param_count() - matmul - table - norm_params  # qkv biases
    return {
        "off": m.param_count() * dsize,
        "int8": (matmul + table + other * dsize + (scales8 + tscales) * 4
                 + norm_params * dsize),
        "int4": (matmul // 2 + (matmul // group) * 4 + table + tscales * 4
                 + other * dsize + norm_params * dsize),
    }


def _effective_weight_quant(cfg: Config) -> str:
    """The weight tier the build runs (``fasttalk_tpu/engine/factory.py``
    :71). Config resolves WEIGHT_QUANT and the legacy TPU_QUANTIZE at
    construction, but a caller that assigns ``cfg.quantize`` afterwards
    bypasses that: the legacy attribute is honoured as the JAX factory
    honours it."""
    legacy = "off" if cfg.quantize in ("", "none", "off") else cfg.quantize
    if cfg.weight_quant == "off" and legacy != "off":
        return legacy
    return cfg.weight_quant


def check_hbm_budget(m: ModelConfig, cfg: Config, dsize: int,
                     device: torch.device, tp: int = 1,
                     kv_shards: int = 1) -> dict:
    """Account weights + KV cache against the card's memory before any
    allocation, so bad TPU_DECODE_SLOTS / TPU_MAX_MODEL_LEN / KV settings
    fail with a named message instead of an out-of-memory error mid-load.
    Weights are priced at the tier that runs (``weight_bytes_by_tier``);
    the over-budget remedies name WEIGHT_QUANT=int4 and print every tier's
    weight bytes, as ``fasttalk_tpu/engine/factory.py`` :186-215 does.

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
    tiers = weight_bytes_by_tier(m, dsize, cfg.weight_quant_group)
    tier = _effective_weight_quant(cfg)
    wbytes = tiers[tier]
    # One rank holds about 1/tp of the weights and 1/(dp*sp*tp) of the KV.
    wbytes //= max(1, tp)
    row //= max(1, kv_shards)
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
        tier_math = (f"Weight bytes by tier (WEIGHT_QUANT={tier}"
                     f"): off(bf16)={tiers['off'] / 2**30:.2f} GiB, "
                     f"int8={tiers['int8'] / 2**30:.2f} GiB, "
                     f"int4+scales={tiers['int4'] / 2**30:.2f} GiB "
                     f"(group={cfg.weight_quant_group}).")
        if paged:
            remedy = (f"Lower KV_POOL_BLOCKS ({pool_blocks}; 0 = fit to the "
                      f"budget), KV_BLOCK_SIZE ({bs}) or TPU_MAX_MODEL_LEN "
                      f"({cfg.max_model_len}); enable WEIGHT_QUANT=int4 / "
                      "KV_QUANT=int8; or raise TPU_HBM_UTILIZATION. "
                      + tier_math)
        else:
            remedy = (f"The dense layout preallocates every slot at its "
                      f"whole context: TPU_DECODE_SLOTS={cfg.decode_slots} x "
                      f"TPU_MAX_MODEL_LEN={cfg.max_model_len} = {dense_rows} "
                      f"KV rows ({dense_rows // bs} blocks of {bs} tokens), "
                      f"but the budget holds only {fit_blocks} blocks after "
                      "the weights. Set KV_LAYOUT=paged to admit by blocks in "
                      f"use (KV_BLOCK_SIZE={bs}), enable WEIGHT_QUANT=int4 "
                      "(or int8) / KV_QUANT=int8, lower TPU_DECODE_SLOTS / "
                      "TPU_MAX_MODEL_LEN, or raise TPU_HBM_UTILIZATION. "
                      + tier_math)
        raise ValueError(
            f"Model + KV cache need {need / 2**30:.2f} GiB but the memory "
            f"budget is {budget / 2**30:.2f} GiB ({limit / 2**30:.2f} GiB x "
            f"TPU_HBM_UTILIZATION={cfg.hbm_util}). {remedy}")
    return acct


def build_engine(cfg: Config, device: str | torch.device | None = None,
                 seed: int = 0, prepared_cache: bool = True) -> EngineBase:
    """The engine ``cfg`` describes. ``prepared_cache=False`` loads and
    quantizes the checkpoint itself, neither reading nor writing the
    prepared-weight cache (checks of the load path)."""
    if cfg.llm_provider == "fake":  # internal/testing
        return FakeEngine()
    if cfg.llm_provider in ("vllm", "openai"):
        # "openai" = any OpenAI-compatible HTTP backend; the wire protocol
        # is vLLM's.
        from fasttalk_tpu_torch.engine.remote import VLLMRemoteEngine

        return VLLMRemoteEngine(
            cfg.vllm_base_url, cfg.vllm_model, api_key=cfg.vllm_api_key,
            timeout_s=cfg.vllm_timeout, max_inflight=cfg.remote_max_inflight,
            admission_timeout_s=cfg.sched_default_deadline_s,
            connect_retries=cfg.remote_connect_retries)
    if cfg.llm_provider == "ollama":
        from fasttalk_tpu_torch.engine.remote import OllamaRemoteEngine

        return OllamaRemoteEngine(
            cfg.ollama_base_url, cfg.model_name,
            keep_alive=cfg.ollama_keep_alive, timeout_s=cfg.ollama_timeout,
            max_inflight=cfg.remote_max_inflight,
            admission_timeout_s=cfg.sched_default_deadline_s,
            connect_retries=cfg.remote_connect_retries)
    mesh = None
    if cfg.mesh_size > 1 or cfg.spmd_role != "off":
        # The process group first, then the mesh over its ranks (JAX
        # :258-283); each rank drives its own card.
        from fasttalk_tpu_torch.parallel.distributed import (maybe_initialize,
                                                             rank_device)
        from fasttalk_tpu_torch.parallel.mesh import make_mesh

        maybe_initialize()
        if device is None:
            device = rank_device()
        if cfg.mesh_size > 1:
            mesh = make_mesh(dp=cfg.dp_size, sp=cfg.sp_size, tp=cfg.tp_size)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        # A rank's own card becomes the process's current device.
        torch.cuda.set_device(dev)
    model_cfg = get_model_config(cfg.model_name, cfg.model_path)
    dtype = cfg.torch_dtype
    tier, group = _effective_weight_quant(cfg), cfg.weight_quant_group
    if tier == "int4":
        validate_group(model_cfg, group)
    acct = check_hbm_budget(model_cfg, cfg, torch.finfo(dtype).bits // 8, dev,
                            tp=cfg.tp_size if mesh else 1,
                            kv_shards=cfg.mesh_size if mesh else 1)
    ckpt = find_checkpoint_dir(cfg.model_path, model_cfg.name) \
        if cfg.model_path else None
    if ckpt:
        params = load_prepared(model_cfg, cfg.model_path, dtype, tier, ckpt,
                               group=group, device=dev, mesh=mesh) \
            if prepared_cache else None
        if params is None:
            params = load_params(model_cfg, ckpt, dtype, dev, quantize=tier,
                                 weight_quant_group=group, mesh=mesh)
            if tier == "int4":
                log.info(f"Quantized layer matmuls to int4 (group-wise "
                         f"symmetric, group={group}, data-free scales; "
                         "`python -m fasttalk_tpu_torch quantize` writes "
                         "AWQ-calibrated scales into the prepared cache "
                         "this load path reads)")
            # The next start restores the engine-ready weights; an AWQ
            # cache written by the quantize command has the same meta and
            # wins by already existing.
            if prepared_cache:
                save_prepared(params, cfg.model_path,
                              cache_meta(model_cfg, dtype, tier, ckpt,
                                         group=group, mesh=mesh))
    else:
        log.warning(f"No checkpoint for {model_cfg.name!r} under "
                    f"{cfg.model_path!r}; using random-initialised weights")
        params = init_params_device(model_cfg, dtype, dev, quantize=tier,
                                    seed=seed, weight_quant_group=group,
                                    mesh=mesh)
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
             f"dtype={cfg.dtype}, weight_quant={tier}"
             + (f" (group {group})" if tier == "int4" else "") + ", "
             f"kv_layout={cfg.kv_layout}, kv_quant={cfg.kv_quant}, "
             f"spec_decode={cfg.spec_decode}, "
             f"kv_radix={cfg.kv_radix_enabled}, "
             f"kv_host_budget_mb={cfg.kv_host_budget_mb}, "
             f"kv_cache={acct['kv_cache_bytes'] / 2**30:.3f} GiB"
             + (f", mesh={mesh.describe()}" if mesh is not None else ""))
    return TorchEngine(
        model_cfg, params, tokenizer, device=dev,
        num_slots=cfg.decode_slots, max_len=cfg.max_model_len,
        prefill_chunk=cfg.prefill_chunk, dtype=dtype, seed=seed,
        context_window=min(cfg.default_context_window, cfg.max_model_len),
        steps_per_call=cfg.decode_steps_per_call,
        pipeline_depth=cfg.pipeline_depth,
        sampling_method=cfg.sampling,
        spec_decode=cfg.spec_decode,
        spec_draft_len=cfg.spec_draft_len,
        spec_breakeven=cfg.spec_breakeven,
        shared_prefix=cfg.shared_prefix,
        queue_bound=cfg.sched_queue_bound,
        default_deadline_s=cfg.sched_default_deadline_s,
        bulk_aging_s=cfg.sched_bulk_aging_s,
        kv_quant=cfg.kv_quant, kv_quant_granule=cfg.kv_quant_granule,
        kv_layout=cfg.kv_layout, kv_block_size=cfg.kv_block_size,
        kv_pool_blocks=acct["kv_pool_blocks"],
        kv_reserve_policy=cfg.kv_reserve_policy,
        kv_reserve_tokens=cfg.kv_reserve_tokens,
        kv_host_budget_mb=cfg.kv_host_budget_mb,
        kv_park_ttl_s=cfg.kv_park_ttl_s,
        kv_park_idle_s=cfg.kv_park_idle_s,
        kv_restore_min_tokens=cfg.kv_restore_min_tokens,
        kv_radix=cfg.kv_radix_enabled,
        kv_radix_min_blocks=cfg.kv_radix_min_blocks,
        kv_radix_evict_policy=cfg.kv_radix_evict_policy,
        structured=cfg.structured_mode,
        structured_max_states=cfg.structured_max_states,
        structured_state_budget=cfg.structured_state_budget,
        structured_jf_min=cfg.structured_jf_min,
        structured_cache=cfg.structured_cache,
        structured_json_depth=cfg.structured_json_depth,
        mesh=mesh)
