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

On a mesh (``mesh``, parallel/mesh.py) each rank holds its shards
(parallel/sharding.py) and the model sees local widths: its heads, its FFN
columns, its KV heads, read from the leaves' shapes. The column-parallel
wq/wk/wv/w_gate/w_up need no collective; the partial outputs of the
row-parallel wo and w_down are summed over "tp" before the residual add;
the embedding, sharded on its hidden axis, is gathered over "tp" after the
lookup, and the tied head's partial logits are summed over "tp" (the row
scale is replicated, so the sum is the full product). The partials are
float32 and the sum is rounded once (ops/quant.py ``row_parallel``), where
one rank rounds its whole product: a tp layout's activations equal one
rank's but for the order of float32 additions. On "sp" the decode
cache is this rank's sequence shard: a row is written only by the rank
that holds its position, and attention folds the shard and combines the
softmax statistics over "sp" (parallel/ring_attention.py).
``forward_ring`` is the ring prefill of a fresh prompt.

Training differentiates ``forward`` without a cache (parallel/train.py).
The collectives carry their backwards (parallel/collectives.py): the
replicated input of every column-parallel product (wq/wk/wv, w_gate/w_up,
the head) sums its gradient over "tp", the row-parallel sums pass theirs
through, the embedding's gather hands each rank its slice. Without grad
these are the serving path's own calls.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.ops.attention import attend, attend_blockwise
from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                   decode_attend_paged)
from fasttalk_tpu_torch.ops.kv_quant import kv_dequantize, kv_quantize
from fasttalk_tpu_torch.ops.quant import (embed_lookup, matmul_tied,
                                          row_parallel)
from fasttalk_tpu_torch.ops.quant import matmul as qmm
from fasttalk_tpu_torch.ops.rope import apply_rope, rope_frequencies
from fasttalk_tpu_torch.parallel import collectives
from fasttalk_tpu_torch.parallel.mesh import Mesh

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
    with ``mask`` False ([B], or [B, T] per element) keep their contents
    (written back unchanged)."""
    b = cache_layer.shape[0]
    rows = torch.arange(b, device=cols.device)[:, None]
    cols = cols.clamp(0, cache_layer.shape[1] - 1)
    if mask is not None:
        cur = cache_layer[rows, cols]
        keep = mask.view(*mask.shape, *([1] * (new.dim() - mask.dim())))
        new = torch.where(keep, new.to(cache_layer.dtype), cur)
    cache_layer[rows, cols] = new.to(cache_layer.dtype)


def _tp(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.shape["tp"] > 1


def _row_parallel(x: torch.Tensor, w, mesh: Mesh | None,
                  decode: bool = False, tied: bool = False) -> torch.Tensor:
    """A row-parallel matmul (``wo``, ``w_down``, the tied head): on a "tp"
    mesh the float32 partial products of the shards summed over "tp" and
    rounded once (``row_parallel``), so the layout rounds where one rank
    does; off a mesh the plain product."""
    if not _tp(mesh):
        return matmul_tied(x, w, decode) if tied else qmm(x, w, decode)
    return row_parallel(
        x, w, lambda p: collectives.all_reduce_sum(p, mesh, "tp"), decode,
        tied=tied)


def _embed(params: Params, tokens: torch.Tensor, dtype: torch.dtype,
           mesh: Mesh | None) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens, dtype)
    return collectives.all_gather(x, mesh, "tp", dim=-1) if _tp(mesh) else x


def _column_input(h: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The replicated input of the column-parallel products: on a "tp"
    mesh its gradient sums every rank's (identity without grad)."""
    return collectives.replicated_input(h, mesh, "tp") if _tp(mesh) else h


def _mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig,
         decode: bool = False, mesh: Mesh | None = None) -> torch.Tensor:
    h = _column_input(rms_norm(x, lp["mlp_norm"], cfg.rms_eps), mesh)
    gate = torch.nn.functional.silu(
        qmm(h, lp["w_gate"], decode).to(torch.float32))
    up = qmm(h, lp["w_up"], decode).to(torch.float32)
    return x + _row_parallel((gate * up).to(x.dtype), lp["w_down"], mesh,
                             decode)


def _qkv(h: torch.Tensor, lp: dict, cfg: ModelConfig, positions: torch.Tensor,
         inv_freq: torch.Tensor, decode: bool = False,
         mesh: Mesh | None = None) -> tuple[torch.Tensor, ...]:
    b, t = h.shape[:2]
    h = _column_input(h, mesh)
    q, k, v = (qmm(h, lp["wq"], decode), qmm(h, lp["wk"], decode),
               qmm(h, lp["wv"], decode))
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    # Head counts from the widths: a "tp" shard holds its own heads.
    q = q.reshape(b, t, -1, cfg.head_dim)
    k = k.reshape(b, t, -1, cfg.head_dim)
    v = v.reshape(b, t, -1, cfg.head_dim)
    return (apply_rope(q, positions, inv_freq),
            apply_rope(k, positions, inv_freq), v)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor,
          decode: bool = False, mesh: Mesh | None = None) -> torch.Tensor:
    x = _column_input(rms_norm(x, params["final_norm"], cfg.rms_eps), mesh)
    if cfg.tie_embeddings:
        if _tp(mesh):
            # The table is sharded on D: this rank's columns of x against
            # its columns of the table give partial logits.
            d = x.shape[-1] // mesh.shape["tp"]
            i = mesh.coords["tp"]
            xs = x[..., i * d:(i + 1) * d].contiguous()
            return _row_parallel(xs, params["embed"], mesh, decode,
                                 tied=True).to(torch.float32)
        return matmul_tied(x, params["embed"], decode).to(torch.float32)
    logits = qmm(x, params["lm_head"], decode).to(torch.float32)
    # An untied head is column-parallel over the vocabulary.
    return collectives.all_gather(logits, mesh, "tp", dim=-1) \
        if _tp(mesh) else logits


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache | None,
            write_start: torch.Tensor | None, *, blockwise: bool = False,
            write_mask: torch.Tensor | None = None,
            logits_indices: torch.Tensor | None = None,
            mesh: Mesh | None = None,
            attn_override: Callable | None = None,
            ) -> tuple[torch.Tensor, KVCache | None]:
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
    ``mesh``: the params and cache are this rank's "tp" shards (the cache
    holds whole sequences: an "sp" caller gathers them first).

    ``cache=None`` (training, ``greedy_generate``): attention reads the
    block's own K/V and nothing is written. ``attn_override`` (JAX
    ``attn_override``): ``fn(q, k, v, positions) -> o`` over the block's
    fresh q/k/v replaces the attention, and the cache is neither written
    nor read (the gathered and ring attention of parallel/train.py over an
    "sp"-sharded sequence). A gradient survives only these routes: each
    layer's cache write bumps the version of the one buffer every layer's
    view shares, which invalidates what earlier layers saved for backward.
    Returns (float32 logits [B, T, V], cache).
    """
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(tokens.device))
    dtype = params["final_norm"].dtype
    x = _embed(params, tokens, dtype, mesh)
    b, t = tokens.shape
    attn_fn = attend_blockwise if blockwise else attend
    fresh = cache is None or attn_override is not None
    if not fresh:
        cols = write_start[:, None] \
            + torch.arange(t, device=tokens.device)[None]
    kvq = not fresh and cache.quantized
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, positions, inv_freq, mesh=mesh)
        if fresh:
            o = (attn_override or attn_fn)(q, k, v, positions)
        else:
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
        x = x + _row_parallel(o.reshape(b, t, -1), lp["wo"], mesh)
        x = _mlp(x, lp, cfg, mesh=mesh)
    if logits_indices is not None:
        x = x[torch.arange(b, device=x.device), logits_indices.long()][:, None]
    return _head(params, cfg, x, mesh=mesh), cache


def forward_decode_multi(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         cache: KVCache, write_mask: torch.Tensor, *,
                         attn_len: int,
                         block_table: torch.Tensor | None = None,
                         block_size: int = 0,
                         mesh: Mesh | None = None,
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

    ``mesh``: the params are this rank's "tp" shards and the dense cache
    its shard; with "sp" > 1 the cache holds the rank's sequence shard,
    ``attn_len`` is the full cache length, a position is written by the
    rank that holds it, and attention is ``decode_attention_sharded``.
    """
    paged = block_table is not None
    sp = mesh is not None and mesh.shape["sp"] > 1
    if sp and (paged or cache.quantized):
        raise ValueError("an sp-sharded cache is dense bf16 only")
    if paged:
        if block_table.shape[1] * block_size != attn_len:
            raise ValueError("the block table must cover exactly the "
                             f"attn_len {attn_len} bucket")
    elif attn_len > cache.max_len * (mesh.shape["sp"] if sp else 1):
        raise ValueError(f"attn_len {attn_len} exceeds the cache length "
                         f"{cache.max_len}")
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(tokens.device))
    dtype = params["final_norm"].dtype
    x = _embed(params, tokens, dtype, mesh)
    b, t = tokens.shape
    pos_mat = positions[:, None] + torch.arange(t, device=tokens.device)[None]
    lengths = (pos_mat[:, -1] + 1).to(torch.int32)
    if sp:
        # This rank holds positions [lo, lo + local): only it writes them.
        local = cache.max_len
        lo = mesh.coords["sp"] * local
        write_cols = pos_mat - lo
        write_keep = write_mask[:, None] & (write_cols >= 0) \
            & (write_cols < local)
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
        q, k, v = _qkv(h, lp, cfg, pos_mat, inv_freq, decode=True,
                       mesh=mesh)
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
        elif sp:
            from fasttalk_tpu_torch.parallel.ring_attention import \
                decode_attention_sharded

            _write_rows(cache.k[i], k, write_cols, write_keep)
            _write_rows(cache.v[i], v, write_cols, write_keep)
            o = decode_attention_sharded(q, cache.k[i], cache.v[i], pos_mat,
                                         mesh)
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
        x = x + _row_parallel(o.reshape(b, t, -1), lp["wo"], mesh,
                              decode=True)
        x = _mlp(x, lp, cfg, decode=True, mesh=mesh)
    return _head(params, cfg, x, decode=True, mesh=mesh), cache


def forward_decode(params: Params, cfg: ModelConfig, cur: torch.Tensor,
                   positions: torch.Tensor, cache: KVCache,
                   write_mask: torch.Tensor, *, attn_len: int,
                   block_table: torch.Tensor | None = None,
                   block_size: int = 0,
                   mesh: Mesh | None = None) -> tuple[torch.Tensor, KVCache]:
    """One decode step [B] -> logits [B, V], cache updated in place."""
    logits, cache = forward_decode_multi(params, cfg, cur[:, None], positions,
                                         cache, write_mask, attn_len=attn_len,
                                         block_table=block_table,
                                         block_size=block_size, mesh=mesh)
    return logits[:, 0], cache


def forward_ring(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: KVCache, mesh: Mesh, last_index: int,
                 ) -> torch.Tensor:
    """Ring prefill of one fresh prompt (JAX ``_get_ring_prefill_fn``,
    fasttalk_tpu/engine/engine.py:3624): ``tokens`` [1, bucket] is the
    whole (padded) prompt; this rank runs the model over its contiguous
    chunk of ``bucket / sp`` positions, attention through
    ``ring_attention_sharded``, so per-rank attention memory is
    O(bucket / sp). Every K/V chunk visits every rank on the ring, and a
    rank writes the positions its cache shard holds from the chunks as
    they pass (``cache`` is this rank's [L, 1, S/sp, Kv/tp, H] view of the
    slot): no rank holds more than one chunk of K/V at a time. Returns
    the float32 logits [V] at ``last_index``, the same on every rank."""
    from fasttalk_tpu_torch.parallel.ring_attention import \
        ring_attention_sharded

    sp = mesh.shape["sp"]
    bucket = tokens.shape[1]
    chunk = bucket // sp
    i0 = mesh.coords["sp"] * chunk
    dev = tokens.device
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                         str(dev))
    dtype = params["final_norm"].dtype
    positions = torch.arange(i0, i0 + chunk, device=dev)[None]
    x = _embed(params, tokens[:, i0:i0 + chunk], dtype, mesh)
    local = cache.max_len
    lo = mesh.coords["sp"] * local
    for i in range(cfg.num_layers):
        lp = _layer(params, i)

        def write(src: int, k: torch.Tensor, v: torch.Tensor,
                  i: int = i) -> None:
            # Chunk src holds positions [src * chunk, (src + 1) * chunk);
            # this rank's shard holds [lo, lo + local).
            c0 = src * chunk
            w0, w1 = max(lo, c0), min(lo + local, c0 + chunk)
            if w1 > w0:
                cache.k[i][:, w0 - lo:w1 - lo] = k[:, w0 - c0:w1 - c0].to(
                    cache.k.dtype)
                cache.v[i][:, w0 - lo:w1 - lo] = v[:, w0 - c0:w1 - c0].to(
                    cache.v.dtype)

        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, positions, inv_freq, mesh=mesh)
        o = ring_attention_sharded(q, k.contiguous(), v.contiguous(),
                                   positions, mesh, on_block=write)
        x = x + _row_parallel(o.reshape(1, chunk, -1), lp["wo"], mesh)
        x = _mlp(x, lp, cfg, mesh=mesh)
    # The last real position's hidden row, from the rank whose chunk holds
    # it (the others add zeros), then the head on every rank.
    row = torch.zeros_like(x[:, 0])
    if i0 <= last_index < i0 + chunk:
        row = x[:, last_index - i0]
    row = collectives.all_reduce_sum(row.contiguous(), mesh, "sp")
    return _head(params, cfg, row[:, None], mesh=mesh)[0, 0]
