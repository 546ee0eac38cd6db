"""Engine construction from the serving Config.

Counterpart of ``fasttalk_tpu/engine/factory.py::build_engine`` (:224)
for the port's slice: resolve the model config, load the checkpoint under
MODEL_PATH (or random-initialise on the device when there is none),
quantize the matmul weights and the embedding to int8 when WEIGHT_QUANT
asks for it, load the tokenizer, and build the ``TorchEngine``.
"""

from __future__ import annotations

import os

import torch

from fasttalk_tpu_torch.engine.engine import TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import HFTokenizer, load_tokenizer
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.loader import (find_checkpoint_dir,
                                              init_params_device, load_params)
from fasttalk_tpu_torch.utils.config import Config, resolve_device
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("engine.factory")

# The 32k BPE the JAX package bundles for weight-free serving. It is a
# data file, read in place (no copy is kept in this package).
BENCH_TOKENIZER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "fasttalk_tpu", "assets", "bench_tokenizer.json")


def build_engine(cfg: Config, device: str | torch.device | None = None,
                 seed: int = 0) -> TorchEngine:
    dev = resolve_device(device)
    model_cfg = get_model_config(cfg.model_name, cfg.model_path)
    dtype = cfg.torch_dtype
    int8 = cfg.weight_quant == "int8"
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
             f"dtype={cfg.dtype}, weight_quant={cfg.weight_quant}")
    return TorchEngine(
        model_cfg, params, tokenizer, device=dev,
        num_slots=cfg.decode_slots, max_len=cfg.max_model_len,
        prefill_chunk=cfg.prefill_chunk, dtype=dtype, seed=seed,
        context_window=min(cfg.default_context_window, cfg.max_model_len),
        steps_per_call=cfg.decode_steps_per_call,
        pipeline_depth=cfg.pipeline_depth)
