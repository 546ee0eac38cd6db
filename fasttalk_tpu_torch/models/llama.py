"""Llama forward pass with an in-place KV cache, in PyTorch.

Counterpart of ``fasttalk_tpu/models/llama.py``. Same parameter layout:
per-layer weights stacked along a leading layer axis (``[L, in, out]``,
int8 leaves ``{"q", "s"}``), so the JAX package's pytree maps onto this
dict leaf for leaf (``models/loader.from_jax_params``). The JAX layer
``scan`` becomes a Python loop over the stacked weights, and the cache
[L, B, S, Kv, H] is updated in place (JAX threads it through donated
buffers instead). Norms, softmax and rope run in float32.

- ``forward`` serves prefill chunks (any T): per-row ``write_start``,
  optional ``write_mask`` and ``logits_indices``.
- ``forward_decode_multi`` / ``forward_decode`` serve decode: the block's
  K/V columns scatter into the cache (masked rows write nothing) and
  attention reads the ``attn_len`` slice through the hand-written
  ``decode_attend`` kernel (ops/cuda_attention.py).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.ops.attention import attend, attend_blockwise
from fasttalk_tpu_torch.ops.cuda_attention import decode_attend
from fasttalk_tpu_torch.ops.quant import embed_lookup, matmul_tied
from fasttalk_tpu_torch.ops.quant import matmul as qmm
from fasttalk_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Per-layer key/value cache: k, v each [L, B, S, num_kv_heads, head_dim]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda") -> KVCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str = "cuda") -> Params:
    """Random init with GPT-style scaled normals (tests and weight-free
    serving; checkpoints come from models/loader.py)."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    scale = d ** -0.5
    params: Params = {
        "embed": normal((cfg.vocab_size, d), scale),
        "layers": {
            "attn_norm": torch.ones((n, d), dtype=dtype, device=device),
            "wq": normal((n, d, cfg.q_dim), scale),
            "wk": normal((n, d, cfg.kv_dim), scale),
            "wv": normal((n, d, cfg.kv_dim), scale),
            "wo": normal((n, cfg.q_dim, d), scale / (2 * n) ** 0.5),
            "mlp_norm": torch.ones((n, d), dtype=dtype, device=device),
            "w_gate": normal((n, d, f), scale),
            "w_up": normal((n, d, f), scale),
            "w_down": normal((n, f, d), f ** -0.5 / (2 * n) ** 0.5),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                            ("bv", cfg.kv_dim)):
            params["layers"][name] = torch.zeros((n, width), dtype=dtype,
                                                 device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), scale)
    return params


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (normed * w.to(torch.float32)).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, scaling: Any,
              device: str) -> torch.Tensor:
    return torch.as_tensor(rope_frequencies(head_dim, theta, scaling),
                           device=device)


def _layer(params: Params, i: int) -> dict[str, Any]:
    """Layer ``i``'s slice of the stacked weights (views, no copies)."""
    out = {}
    for name, leaf in params["layers"].items():
        out[name] = ({key: t[i] for key, t in leaf.items()}
                     if isinstance(leaf, dict) else leaf[i])
    return out


def _write_rows(cache_layer: torch.Tensor, new: torch.Tensor,
                cols: torch.Tensor, mask: torch.Tensor | None) -> None:
    """cache_layer [B, S, ...][b, cols[b, t]] = new[b, t] in place; rows
    with ``mask`` False keep their contents (written back unchanged)."""
    b = cache_layer.shape[0]
    rows = torch.arange(b, device=cols.device)[:, None]
    cols = cols.clamp(0, cache_layer.shape[1] - 1)
    if mask is not None:
        cur = cache_layer[rows, cols]
        keep = mask.view(b, *([1] * (new.dim() - 1)))
        new = torch.where(keep, new.to(cache_layer.dtype), cur)
    cache_layer[rows, cols] = new.to(cache_layer.dtype)


def _mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    gate = torch.nn.functional.silu(qmm(h, lp["w_gate"]).to(torch.float32))
    up = qmm(h, lp["w_up"]).to(torch.float32)
    return x + qmm((gate * up).to(x.dtype), lp["w_down"])


def _qkv(h: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
         inv_freq: torch.Tensor) -> tuple[torch.Tensor, ...]:
    b, t = h.shape[:2]
    q, k, v = qmm(h, lp["wq"]), qmm(h, lp["wk"]), qmm(h, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    return (apply_rope(q, positions, inv_freq),
            apply_rope(k, positions, inv_freq), v)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if cfg.tie_embeddings:
        return matmul_tied(x, params["embed"]).to(torch.float32)
    return qmm(x, params["lm_head"]).to(torch.float32)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            write_start: torch.Tensor, *, blockwise: bool = False,
            write_mask: torch.Tensor | None = None,
            logits_indices: torch.Tensor | None = None,
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the transformer over ``tokens`` [B, T], updating ``cache`` in
    place (the caller may pass views of a larger cache).

    positions [B, T]: absolute position (RoPE phase and attention
    horizon) of each token. write_start [B]: cache index of each row's
    first written K/V. write_mask [B] (optional): rows with False leave
    the cache untouched. ``blockwise`` picks the flash-style attention.
    ``logits_indices`` [B] (optional): project the lm_head for one
    position per row (logits [B, 1, V]) — prefill only needs the last.
    Returns (float32 logits [B, T, V], cache).
    """
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(tokens.device))
    dtype = params["final_norm"].dtype
    x = embed_lookup(params["embed"], tokens, dtype)
    b, t = tokens.shape
    cols = write_start[:, None] + torch.arange(t, device=tokens.device)[None]
    attn_fn = attend_blockwise if blockwise else attend
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, positions, inv_freq)
        _write_rows(cache.k[i], k, cols, write_mask)
        _write_rows(cache.v[i], v, cols, write_mask)
        o = attn_fn(q, cache.k[i], cache.v[i], positions)
        x = x + qmm(o.reshape(b, t, cfg.q_dim), lp["wo"])
        x = _mlp(x, lp, cfg)
    if logits_indices is not None:
        x = x[torch.arange(b, device=x.device), logits_indices.long()][:, None]
    return _head(params, cfg, x), cache


def forward_decode_multi(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         cache: KVCache, write_mask: torch.Tensor, *,
                         attn_len: int) -> tuple[torch.Tensor, KVCache]:
    """Scatter-write decode over a short block: tokens [B, T] -> float32
    logits [B, T, V], cache updated in place.

    positions [B]: absolute position of tokens[:, 0] per slot (the block
    occupies positions..positions+T-1). write_mask [B]: rows with False
    write nothing. Attention reads the first ``attn_len`` cache rows of
    every slot through ``decode_attend`` with per-slot lengths
    ``positions + T`` (query t sees positions + t + 1 keys).
    """
    if attn_len > cache.max_len:
        raise ValueError(f"attn_len {attn_len} exceeds the cache length "
                         f"{cache.max_len}")
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(tokens.device))
    dtype = params["final_norm"].dtype
    x = embed_lookup(params["embed"], tokens, dtype)
    b, t = tokens.shape
    pos_mat = positions[:, None] + torch.arange(t, device=tokens.device)[None]
    lengths = (pos_mat[:, -1] + 1).to(torch.int32)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, pos_mat, inv_freq)
        _write_rows(cache.k[i], k, pos_mat, write_mask)
        _write_rows(cache.v[i], v, pos_mat, write_mask)
        o = decode_attend(q, cache.k[i][:, :attn_len], cache.v[i][:, :attn_len],
                          lengths)
        x = x + qmm(o.reshape(b, t, cfg.q_dim), lp["wo"])
        x = _mlp(x, lp, cfg)
    return _head(params, cfg, x), cache


def forward_decode(params: Params, cfg: ModelConfig, cur: torch.Tensor,
                   positions: torch.Tensor, cache: KVCache,
                   write_mask: torch.Tensor, *, attn_len: int,
                   ) -> tuple[torch.Tensor, KVCache]:
    """One decode step [B] -> logits [B, V], cache updated in place."""
    logits, cache = forward_decode_multi(params, cfg, cur[:, None], positions,
                                         cache, write_mask, attn_len=attn_len)
    return logits[:, 0], cache
