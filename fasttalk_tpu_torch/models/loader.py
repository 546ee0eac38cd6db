"""Weights: HF safetensors checkpoints, random init on the device, and the
JAX package's parameter pytree, all into the stacked parameter dict.

Counterpart of ``fasttalk_tpu/models/loader.py``. The dict has the JAX
layout leaf for leaf: ``embed`` [V, D], ``final_norm`` [D], ``layers``
with [L, in, out] matmul weights (HF Linear stores [out, in], so they are
transposed on load), and int8 leaves ``{"q", "s"}`` or int4 leaves
``{"q4", "s"}`` (the seven layer matmuls; quantization/int4.py) after
quantization.

``quantize`` takes the WEIGHT_QUANT tier, "none"/"off" | "int8" | "int4",
or the legacy ``True``/``False`` (int8/none), as the JAX loader does
(``fasttalk_tpu/models/loader.py`` :166-168).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any

import numpy as np
import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.llama import Params
from fasttalk_tpu_torch.ops.quant import (QUANTIZED_LEAVES, quantize_math_out,
                                          quantize_math_row)
from fasttalk_tpu_torch.quantization.int4 import (INT4_LEAVES, pack_int4,
                                                  quantize_math_group,
                                                  quantizing_put_int4)
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("models.loader")

# HF parameter name templates -> (our leaf name, needs_transpose).
_LAYER_MAP = {
    "model.layers.{i}.input_layernorm.weight": ("attn_norm", False),
    "model.layers.{i}.self_attn.q_proj.weight": ("wq", True),
    "model.layers.{i}.self_attn.k_proj.weight": ("wk", True),
    "model.layers.{i}.self_attn.v_proj.weight": ("wv", True),
    "model.layers.{i}.self_attn.o_proj.weight": ("wo", True),
    "model.layers.{i}.post_attention_layernorm.weight": ("mlp_norm", False),
    "model.layers.{i}.mlp.gate_proj.weight": ("w_gate", True),
    "model.layers.{i}.mlp.up_proj.weight": ("w_up", True),
    "model.layers.{i}.mlp.down_proj.weight": ("w_down", True),
}
_BIAS_MAP = {
    "model.layers.{i}.self_attn.q_proj.bias": ("bq", False),
    "model.layers.{i}.self_attn.k_proj.bias": ("bk", False),
    "model.layers.{i}.self_attn.v_proj.bias": ("bv", False),
}


def weight_tier(quantize: bool | str) -> str:
    """The tier of a ``quantize`` argument: "none" | "int8" | "int4"."""
    tier = quantize if isinstance(quantize, str) else (
        "int8" if quantize else "none")
    tier = {"off": "none", "": "none"}.get(tier, tier)
    if tier not in ("none", "int8", "int4"):
        raise ValueError(f"weight tier must be none|off|int8|int4, "
                         f"got {quantize!r}")
    return tier


def find_checkpoint_dir(model_path: str, model_name: str) -> str | None:
    """Locate a safetensors checkpoint under MODEL_PATH for model_name."""
    candidates = [
        model_path,
        os.path.join(model_path, model_name.replace(":", "_")),
        os.path.join(model_path, model_name.replace(":", "-")),
        os.path.join(model_path,
                     model_name.replace(":", "_").replace("/", "_")),
        os.path.join(model_path, model_name),
    ]
    for c in candidates:
        if os.path.isdir(c) and any(f.endswith(".safetensors")
                                    for f in os.listdir(c)):
            return c
    return None


def _tensor_files(ckpt_dir: str) -> dict[str, str]:
    """Tensor name -> safetensors file (sharded index supported)."""
    from safetensors import safe_open

    index_path = os.path.join(ckpt_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path, encoding="utf-8") as f:
            return json.load(f)["weight_map"]
    out: dict[str, str] = {}
    for fname in sorted(os.listdir(ckpt_dir)):
        if fname.endswith(".safetensors"):
            with safe_open(os.path.join(ckpt_dir, fname),
                           framework="pt") as sf:
                for key in sf.keys():
                    out[key] = fname
    return out


def load_params(cfg: ModelConfig, ckpt_dir: str,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cuda",
                quantize: bool | str = False,
                weight_quant_group: int = 128) -> Params:
    """Load a HF Llama checkpoint into the stacked dict on ``device``.

    Tensors are read as float32; a quantized tier converts the matmul
    weights and the embedding on the host, tensor by tensor, before they
    are placed (the device never holds their full-precision copy): int8
    per output channel, or for "int4" the seven layer matmuls group-wise
    (``weight_quant_group`` rows per scale) with the embedding and lm_head
    in int8."""
    from safetensors import safe_open

    tier = weight_tier(quantize)
    quantize = tier != "none"

    name_to_file = _tensor_files(ckpt_dir)
    handles: dict[str, Any] = {}

    def get(name: str) -> torch.Tensor:
        fname = name_to_file[name]
        if fname not in handles:
            handles[fname] = safe_open(os.path.join(ckpt_dir, fname),
                                       framework="pt")
        return handles[fname].get_tensor(name).to(torch.float32)

    def put(t: torch.Tensor, name: str) -> Any:
        if quantize and name in QUANTIZED_LEAVES:
            q, s = quantize_math_out(t)
            return {"q": q.to(device), "s": s.to(device)}
        if quantize and name == "embed":
            q, s = quantize_math_row(t)
            return {"q": q.to(device), "s": s.to(device)}
        return t.to(dtype).to(device)

    if tier == "int4":
        put = quantizing_put_int4(put, lambda t: t.to(device),
                                  weight_quant_group)

    params: Params = {
        "embed": put(get("model.embed_tokens.weight"), "embed"),
        "final_norm": put(get("model.norm.weight"), "final_norm"),
        "layers": {},
    }
    layer_map = dict(_LAYER_MAP)
    if cfg.qkv_bias:
        layer_map.update(_BIAS_MAP)
    for tmpl, (name, transpose) in layer_map.items():
        stacked = []
        for i in range(cfg.num_layers):
            t = get(tmpl.format(i=i))
            stacked.append(t.T if transpose else t)
        params["layers"][name] = put(torch.stack(stacked), name)
    if not cfg.tie_embeddings:
        head = get("lm_head.weight")  # [V, D]
        if quantize:
            qt, s = quantize_math_row(head)
            params["lm_head"] = {"qt": qt.to(device), "s": s.to(device)}
        else:
            params["lm_head"] = head.T.to(dtype).to(device)
    handles.clear()
    log.info(f"Loaded checkpoint from {ckpt_dir}", model=cfg.name)
    return params


def _leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    shapes = {"wq": (n, d, cfg.q_dim), "wk": (n, d, cfg.kv_dim),
              "wv": (n, d, cfg.kv_dim), "wo": (n, cfg.q_dim, d),
              "w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d)}
    if cfg.qkv_bias:
        shapes.update({"bq": (n, cfg.q_dim), "bk": (n, cfg.kv_dim),
                       "bv": (n, cfg.kv_dim)})
    return shapes


def init_params_device(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                       device: torch.device | str = "cuda",
                       quantize: bool | str = True, seed: int = 0,
                       rows_per_chunk: int = 16384,
                       weight_quant_group: int = 128) -> Params:
    """Architecture-faithful random init generated on ``device``, one layer
    (or one block of embedding rows) at a time: with a quantized tier each
    f32 slice becomes int8 (or, for "int4", the seven layer matmuls become
    nibble-packed groups of ``weight_quant_group`` rows) before the next is
    drawn, so neither an f32 nor a bf16 copy of the whole model ever
    exists. Each leaf draws from its own generator seeded by ``seed`` and a
    CRC of its name; the f32 slices are the same whatever the tier."""
    tier = weight_tier(quantize)
    quantize = tier != "none"
    group = int(weight_quant_group)

    def gen(name: str) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(seed * 1_000_003 + (zlib.crc32(name.encode())
                                          & 0x7FFFFFFF))
        return g

    d, n = cfg.hidden_size, cfg.num_layers
    params: Params = {"layers": {}}
    for name, shape in _leaf_shapes(cfg).items():
        if name in ("bq", "bk", "bv"):
            params["layers"][name] = torch.zeros(shape, dtype=dtype,
                                                 device=device)
            continue
        g = gen(f"layers/{name}")
        scale = shape[-2] ** -0.5
        if tier == "int4" and name in INT4_LEAVES:
            q4 = torch.empty((n, shape[1] // 2, shape[2]), dtype=torch.uint8,
                             device=device)
            s = torch.empty((n, shape[1] // group, shape[2]),
                            dtype=torch.float32, device=device)
            for i in range(n):
                sl = torch.randn(shape[1:], generator=g, device=device) * scale
                q, s[i] = quantize_math_group(sl, group)
                q4[i] = pack_int4(q)
            params["layers"][name] = {"q4": q4, "s": s}
        elif quantize:
            q = torch.empty(shape, dtype=torch.int8, device=device)
            s = torch.empty((n, shape[-1]), dtype=torch.float32, device=device)
            for i in range(n):
                sl = torch.randn(shape[1:], generator=g, device=device) * scale
                q[i], s[i] = quantize_math_out(sl)
            params["layers"][name] = {"q": q, "s": s}
        else:
            w = torch.empty(shape, dtype=dtype, device=device)
            for i in range(n):
                w[i] = (torch.randn(shape[1:], generator=g, device=device)
                        * scale).to(dtype)
            params["layers"][name] = w
    for name in ("attn_norm", "mlp_norm"):
        params["layers"][name] = torch.ones((n, d), dtype=dtype, device=device)
    params["final_norm"] = torch.ones((d,), dtype=dtype, device=device)

    g = gen("embed")
    v = cfg.vocab_size
    if quantize:
        eq = torch.empty((v, d), dtype=torch.int8, device=device)
        es = torch.empty((v,), dtype=torch.float32, device=device)
    else:
        eq = torch.empty((v, d), dtype=dtype, device=device)
    for r0 in range(0, v, rows_per_chunk):
        r1 = min(v, r0 + rows_per_chunk)
        blk = torch.randn((r1 - r0, d), generator=g, device=device) * d ** -0.5
        if quantize:
            eq[r0:r1], es[r0:r1] = quantize_math_row(blk)
        else:
            eq[r0:r1] = blk.to(dtype)
    params["embed"] = {"q": eq, "s": es} if quantize else eq
    if not cfg.tie_embeddings:
        g = gen("lm_head")
        head = torch.randn((d, v), generator=g, device=device) * d ** -0.5
        if quantize:
            qt, s = quantize_math_row(head.T)
            params["lm_head"] = {"qt": qt.contiguous(), "s": s}
        else:
            params["lm_head"] = head.to(dtype)
    log.info(f"Random-initialised {cfg.name} on {device} "
             f"({tier if quantize else dtype})")
    return params


def _to_torch(a: Any, device: torch.device | str) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: carry the bits across
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_params(tree: Any, device: torch.device | str = "cuda") -> Any:
    """The JAX package's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's dict, leaf for
    leaf and bit for bit: same names, shapes, dtypes and values (int4
    ``q4`` leaves stay ``torch.uint8``)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _to_torch(tree, device)
