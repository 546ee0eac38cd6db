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

Given a ``mesh`` (parallel/mesh.py), ``load_params`` and
``init_params_device`` place each leaf straight into this rank's shard
(parallel/sharding.py): a leaf, or one layer of it, is read or drawn
whole, quantized whole, then cut, so the shard holds the same bytes as
quantizing the whole model and cutting it afterwards (the JAX package's
``param_put``; ``test_quantize_after_shard_matches_quantize_before``).
Only one leaf's (one layer's) full copy exists at a time.
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
from fasttalk_tpu_torch.parallel.sharding import shard_named
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
                weight_quant_group: int = 128, mesh: Any = None) -> Params:
    """Load a HF Llama checkpoint into the stacked dict on ``device``
    (with a ``mesh``, this rank's shards of it).

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
        if mesh is not None:
            raise ValueError("the int4 tier is single-device only")
        put = quantizing_put_int4(put, lambda t: t.to(device),
                                  weight_quant_group)
    whole_put = put

    def put(t: torch.Tensor, name: str) -> Any:  # noqa: F811
        return shard_named(whole_put(t, name), name, mesh)

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
            params["lm_head"] = shard_named(
                {"qt": qt.to(device), "s": s.to(device)}, "lm_head", mesh)
        else:
            params["lm_head"] = shard_named(head.T.to(dtype).to(device),
                                            "lm_head", mesh)
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
                       weight_quant_group: int = 128,
                       mesh: Any = None) -> Params:
    """Architecture-faithful random init generated on ``device``, one layer
    (or one block of embedding rows) at a time: with a quantized tier each
    f32 slice becomes int8 (or, for "int4", the seven layer matmuls become
    nibble-packed groups of ``weight_quant_group`` rows) before the next is
    drawn, so neither an f32 nor a bf16 copy of the whole model ever
    exists. Each leaf draws from its own generator seeded by ``seed`` and a
    CRC of its name; the f32 slices are the same whatever the tier. With a
    ``mesh`` each quantized slice is cut to this rank's shard before the
    next is drawn: every rank draws the same numbers, and a shard holds the
    bytes of the same slice of the single-device init."""
    tier = weight_tier(quantize)
    quantize = tier != "none"
    group = int(weight_quant_group)
    if tier == "int4" and mesh is not None:
        raise ValueError("the int4 tier is single-device only")

    def cut(t: torch.Tensor, name: str, parent: str = "",
            stacked: bool = False) -> torch.Tensor:
        from fasttalk_tpu_torch.parallel.sharding import shard_leaf

        return t if mesh is None else shard_leaf(t, name, parent, mesh,
                                                 stacked)

    def local_shape(shape: tuple, name: str, parent: str = "") -> tuple:
        if mesh is None:
            return tuple(shape)
        from fasttalk_tpu_torch.parallel.sharding import (_spec_for,
                                                          local_slices)

        idx = local_slices(_spec_for(name, len(shape), shape, parent),
                           shape, mesh)
        return tuple(len(range(*i.indices(d))) for i, d in zip(idx, shape))

    def gen(name: str) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(seed * 1_000_003 + (zlib.crc32(name.encode())
                                          & 0x7FFFFFFF))
        return g

    d, n = cfg.hidden_size, cfg.num_layers
    params: Params = {"layers": {}}
    for name, shape in _leaf_shapes(cfg).items():
        if name in ("bq", "bk", "bv"):
            params["layers"][name] = torch.zeros(local_shape(shape, name),
                                                 dtype=dtype, device=device)
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
            q = torch.empty(local_shape(shape, "q", name), dtype=torch.int8,
                            device=device)
            s = torch.empty(local_shape((n, shape[-1]), "s", name),
                            dtype=torch.float32, device=device)
            for i in range(n):
                sl = torch.randn(shape[1:], generator=g, device=device) * scale
                qi, si = quantize_math_out(sl)
                q[i], s[i] = cut(qi, "q", name), cut(si, "s", name)
            params["layers"][name] = {"q": q, "s": s}
        else:
            w = torch.empty(local_shape(shape, name), dtype=dtype,
                            device=device)
            for i in range(n):
                w[i] = cut((torch.randn(shape[1:], generator=g, device=device)
                            * scale).to(dtype), name)
            params["layers"][name] = w
    for name in ("attn_norm", "mlp_norm"):
        params["layers"][name] = torch.ones((n, d), dtype=dtype, device=device)
    params["final_norm"] = torch.ones((d,), dtype=dtype, device=device)

    g = gen("embed")
    v = cfg.vocab_size
    ed = local_shape((v, d), "embed")[1]
    if quantize:
        eq = torch.empty((v, ed), dtype=torch.int8, device=device)
        es = torch.empty((v,), dtype=torch.float32, device=device)
    else:
        eq = torch.empty((v, ed), dtype=dtype, device=device)
    for r0 in range(0, v, rows_per_chunk):
        r1 = min(v, r0 + rows_per_chunk)
        blk = torch.randn((r1 - r0, d), generator=g, device=device) * d ** -0.5
        if quantize:
            bq, es[r0:r1] = quantize_math_row(blk)
            eq[r0:r1] = cut(bq, "q", "embed", stacked=True)
        else:
            eq[r0:r1] = cut(blk.to(dtype), "embed", stacked=True)
    params["embed"] = {"q": eq, "s": es} if quantize else eq
    if not cfg.tie_embeddings:
        g = gen("lm_head")
        head = torch.randn((d, v), generator=g, device=device) * d ** -0.5
        if quantize:
            qt, s = quantize_math_row(head.T)
            params["lm_head"] = shard_named({"qt": qt.contiguous(), "s": s},
                                            "lm_head", mesh)
        else:
            params["lm_head"] = shard_named(head.to(dtype), "lm_head", mesh)
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
