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
  ``decode_attend`` kernel, or, with a ``block_table``, the paged pool
  through ``decode_attend_paged`` (ops/cuda_attention.py); the layer
  matmuls and the lm_head take the block's B*T rows through the decode
  kernels (ops/quant.py), a T=1 step and a T=draft+1 verify block alike.

Two KV tiers compose with both layouts. The int8 tier (``KV_QUANT=int8``,
ops/kv_quant.py) stores int8 rows plus f32 row scales: fresh rows quantize
on write, the kernels dequantize after the load, the plain attention of
prefill reads a dequantized copy. The paged tier (``KV_LAYOUT=paged``)
keeps one flat row pool per layer, ``[L, P, Kv, H]``, that slots address
through host-managed block tables (kvcache/blocks.py).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.ops.attention import attend, attend_blockwise
from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                   decode_attend_paged)
from fasttalk_tpu_torch.ops.kv_quant import kv_dequantize, kv_quantize
from fasttalk_tpu_torch.ops.quant import embed_lookup, matmul_tied
from fasttalk_tpu_torch.ops.quant import matmul as qmm
from fasttalk_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Per-layer key/value cache: k, v each [L, B, S, num_kv_heads,
    head_dim] (dense), or the paged pool [L, P, num_kv_heads, head_dim].

    Int8 tier: k/v are int8 and ``k_scale``/``v_scale`` hold per-row f32
    scales [L, B, S, G] (dense) or [L, P, G] (paged), G = 1 (per token row)
    or num_kv_heads (per head row). ``None`` scales mean the full-precision
    cache.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _zeros_cache(shape: tuple, sshape: tuple, dtype: torch.dtype,
                 quantized: bool, device) -> KVCache:
    if quantized:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cuda", *,
               quantized: bool = False, scale_granule: int = 1) -> KVCache:
    """The dense cache; ``quantized`` allocates int8 rows + f32 scales with
    granule axis ``scale_granule`` (1 or num_kv_heads). Zero scales on the
    unwritten tail dequantize to the zeros the bf16 cache starts with."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return _zeros_cache(shape, shape[:3] + (scale_granule,), dtype,
                        quantized, device)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str = "cuda", *,
                     quantized: bool = False,
                     scale_granule: int = 1) -> KVCache:
    """The paged tier's pool: one flat row pool per layer,
    ``[L, (num_blocks + 1) * block_size, Kv, H]`` (scales ``[L, P, G]``),
    no slot axis. Blocks ``0..num_blocks-1`` are the allocator's; the last
    block is the write sink of masked decode rows (``forward_decode_multi``)
    and is never in a block table, so it is never attended."""
    p = (num_blocks + 1) * block_size
    shape = (cfg.num_layers, p, cfg.num_kv_heads, cfg.head_dim)
    return _zeros_cache(shape, (cfg.num_layers, p, scale_granule), dtype,
                        quantized, device)


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


def _mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig,
         decode: bool = False) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    gate = torch.nn.functional.silu(
        qmm(h, lp["w_gate"], decode).to(torch.float32))
    up = qmm(h, lp["w_up"], decode).to(torch.float32)
    return x + qmm((gate * up).to(x.dtype), lp["w_down"], decode)


def _qkv(h: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
         inv_freq: torch.Tensor,
         decode: bool = False) -> tuple[torch.Tensor, ...]:
    b, t = h.shape[:2]
    q, k, v = (qmm(h, lp["wq"], decode), qmm(h, lp["wk"], decode),
               qmm(h, lp["wv"], decode))
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    return (apply_rope(q, positions, inv_freq),
            apply_rope(k, positions, inv_freq), v)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor,
          decode: bool = False) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if cfg.tie_embeddings:
        return matmul_tied(x, params["embed"], decode).to(torch.float32)
    return qmm(x, params["lm_head"], decode).to(torch.float32)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            write_start: torch.Tensor, *, blockwise: bool = False,
            write_mask: torch.Tensor | None = None,
            logits_indices: torch.Tensor | None = None,
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the transformer over ``tokens`` [B, T], updating the dense
    ``cache`` in place (the caller may pass views of a larger cache, or a
    gathered copy of paged rows). On the int8 tier the fresh rows quantize
    before the write and attention reads the dequantized cache.

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
    kvq = cache.quantized
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, positions, inv_freq)
        if kvq:
            g = cache.k_scale.shape[-1]
            (k, sk), (v, sv) = kv_quantize(k, g), kv_quantize(v, g)
            _write_rows(cache.k_scale[i], sk, cols, write_mask)
            _write_rows(cache.v_scale[i], sv, cols, write_mask)
        _write_rows(cache.k[i], k, cols, write_mask)
        _write_rows(cache.v[i], v, cols, write_mask)
        if kvq:
            ak = kv_dequantize(cache.k[i], cache.k_scale[i], x.dtype)
            av = kv_dequantize(cache.v[i], cache.v_scale[i], x.dtype)
        else:
            ak, av = cache.k[i], cache.v[i]
        o = attn_fn(q, ak, av, positions)
        x = x + qmm(o.reshape(b, t, cfg.q_dim), lp["wo"])
        x = _mlp(x, lp, cfg)
    if logits_indices is not None:
        x = x[torch.arange(b, device=x.device), logits_indices.long()][:, None]
    return _head(params, cfg, x), cache


def forward_decode_multi(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         cache: KVCache, write_mask: torch.Tensor, *,
                         attn_len: int,
                         block_table: torch.Tensor | None = None,
                         block_size: int = 0,
                         ) -> tuple[torch.Tensor, KVCache]:
    """Scatter-write decode over a short block: tokens [B, T] -> float32
    logits [B, T, V], cache updated in place.

    positions [B]: absolute position of tokens[:, 0] per slot (the block
    occupies positions..positions+T-1). write_mask [B]: rows with False
    write nothing. Attention reads the first ``attn_len`` cache rows of
    every slot with per-slot lengths ``positions + T`` (query t sees
    positions + t + 1 keys), through ``decode_attend``.

    ``block_table`` [B, attn_len // block_size] (int32) selects the paged
    tier: the cache is the pool of ``init_paged_cache``, a write lands at
    pool row ``table[b, pos // bs] * bs + pos % bs``, and attention walks
    the table through ``decode_attend_paged``. Every written position of
    an unmasked row must have its block in the table; masked rows write
    into the pool's sink block (a masked slot's table entry may name
    another slot's block, and two writers to one row in one scatter give
    an undefined result).
    """
    paged = block_table is not None
    if paged:
        if block_table.shape[1] * block_size != attn_len:
            raise ValueError("the block table must cover exactly the "
                             f"attn_len {attn_len} bucket")
    elif attn_len > cache.max_len:
        raise ValueError(f"attn_len {attn_len} exceeds the cache length "
                         f"{cache.max_len}")
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(tokens.device))
    dtype = params["final_norm"].dtype
    x = embed_lookup(params["embed"], tokens, dtype)
    b, t = tokens.shape
    pos_mat = positions[:, None] + torch.arange(t, device=tokens.device)[None]
    lengths = (pos_mat[:, -1] + 1).to(torch.int32)
    kvq = cache.quantized
    if paged:
        blk = (pos_mat // block_size).clamp(max=block_table.shape[1] - 1)
        flat = (block_table.long().gather(1, blk) * block_size
                + pos_mat % block_size)
        sink = (cache.k.shape[1] - block_size
                + (torch.arange(b * t, device=tokens.device).view(b, t)
                   % block_size))
        write_rows = torch.where(write_mask[:, None], flat, sink)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, pos_mat, inv_freq, decode=True)
        sk = sv = None
        if kvq:
            g = cache.k_scale.shape[-1]
            (k, sk), (v, sv) = kv_quantize(k, g), kv_quantize(v, g)
        if paged:
            cache.k[i][write_rows] = k.to(cache.k.dtype)
            cache.v[i][write_rows] = v.to(cache.v.dtype)
            if kvq:
                cache.k_scale[i][write_rows] = sk
                cache.v_scale[i][write_rows] = sv
            o = decode_attend_paged(
                q, cache.k[i], cache.v[i], lengths, block_table,
                block_size=block_size,
                k_scale=cache.k_scale[i] if kvq else None,
                v_scale=cache.v_scale[i] if kvq else None)
        else:
            _write_rows(cache.k[i], k, pos_mat, write_mask)
            _write_rows(cache.v[i], v, pos_mat, write_mask)
            if kvq:
                _write_rows(cache.k_scale[i], sk, pos_mat, write_mask)
                _write_rows(cache.v_scale[i], sv, pos_mat, write_mask)
            o = decode_attend(
                q, cache.k[i][:, :attn_len], cache.v[i][:, :attn_len],
                lengths,
                k_scale=cache.k_scale[i][:, :attn_len] if kvq else None,
                v_scale=cache.v_scale[i][:, :attn_len] if kvq else None)
        x = x + qmm(o.reshape(b, t, cfg.q_dim), lp["wo"], decode=True)
        x = _mlp(x, lp, cfg, decode=True)
    return _head(params, cfg, x, decode=True), cache


def forward_decode(params: Params, cfg: ModelConfig, cur: torch.Tensor,
                   positions: torch.Tensor, cache: KVCache,
                   write_mask: torch.Tensor, *, attn_len: int,
                   block_table: torch.Tensor | None = None,
                   block_size: int = 0) -> tuple[torch.Tensor, KVCache]:
    """One decode step [B] -> logits [B, V], cache updated in place."""
    logits, cache = forward_decode_multi(params, cfg, cur[:, None], positions,
                                         cache, write_mask, attn_len=attn_len,
                                         block_table=block_table,
                                         block_size=block_size)
    return logits[:, 0], cache
