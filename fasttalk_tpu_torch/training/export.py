"""Export trained params as an HF-layout checkpoint directory.

Counterpart of ``fasttalk_tpu/training/export.py``: the exact inverse of
models/loader.py's mapping (HF Linear stores [out, in], the forward uses
[in, out]), so a directory written here loads and serves through the
standard path (``load_params``, ``config_from_hf``, the checkpoint's chat
template, its declared EOS) like any other HF checkpoint. Tensors are
written in bfloat16 through ``safetensors.torch``, as the JAX package
writes them.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from fasttalk_tpu_torch.models.configs import ModelConfig

# param leaf -> (HF name template, transpose back to [out, in])
_EXPORT_LAYER_MAP = {
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight",
                 False),
    "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
    "bq": ("model.layers.{i}.self_attn.q_proj.bias", False),
    "bk": ("model.layers.{i}.self_attn.k_proj.bias", False),
    "bv": ("model.layers.{i}.self_attn.v_proj.bias", False),
}


def export_checkpoint(params: Any, cfg: ModelConfig, out_dir: str, *,
                      chat_template: str | None = None,
                      eos_token: str | None = None,
                      bos_token: str | None = None,
                      tokenizer_json: str | None = None) -> str:
    """Write config.json + model.safetensors (bfloat16) from the port's
    float params (the whole model: stacked [L, in, out] layer leaves) and,
    when given, tokenizer.json / tokenizer_config.json with the chat
    template."""
    from safetensors.torch import save_file

    os.makedirs(out_dir, exist_ok=True)

    def t(x: torch.Tensor) -> torch.Tensor:
        # Through float32, as the JAX package converts; contiguous, as the
        # safetensors writer needs.
        return x.detach().to("cpu", torch.float32).to(
            torch.bfloat16).contiguous()

    tensors: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": t(params["embed"]),
        "model.norm.weight": t(params["final_norm"]),
    }
    for leaf, stacked in params["layers"].items():
        tmpl, transpose = _EXPORT_LAYER_MAP[leaf]
        for i in range(cfg.num_layers):
            w = stacked[i]
            tensors[tmpl.format(i=i)] = t(w.T if transpose else w)
    if not cfg.tie_embeddings:
        tensors["lm_head.weight"] = t(params["lm_head"].T)
    save_file(tensors, os.path.join(out_dir, "model.safetensors"))

    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "model_type": "llama",
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_eps,
            "tie_word_embeddings": cfg.tie_embeddings,
            "max_position_embeddings": cfg.max_position,
            "torch_dtype": "bfloat16",
        }, f, indent=1)

    if tokenizer_json is not None:
        dst = os.path.join(out_dir, "tokenizer.json")
        if os.path.abspath(tokenizer_json) != os.path.abspath(dst):
            with open(tokenizer_json, "rb") as src, open(dst, "wb") as d:
                d.write(src.read())
    if chat_template is not None:
        tok_cfg: dict[str, Any] = {"chat_template": chat_template}
        if eos_token:
            tok_cfg["eos_token"] = eos_token
        if bos_token:
            tok_cfg["bos_token"] = bos_token
        with open(os.path.join(out_dir, "tokenizer_config.json"),
                  "w") as f:
            json.dump(tok_cfg, f, indent=1)
    return out_dir
