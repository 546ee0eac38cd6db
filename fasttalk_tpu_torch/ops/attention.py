"""Grouped-query attention over a preallocated KV cache, in plain torch.

Counterpart of ``fasttalk_tpu/ops/attention.py``. The JAX package
computes these two in XLA, not in a Pallas kernel, so plain torch is
their port:

- ``attend`` — direct full-softmax attention (any T).
- ``attend_blockwise`` — flash-style online-softmax loop over key
  blocks, used for prefill chunks: the score tensor stays
  [B, T, heads, block] whatever the cache length.

Both mask by absolute position: key j is visible to the query at
absolute position p iff j <= p, which enforces causality within a chunk
and hides the unwritten cache tail. Decode attention over the dense
cache and over the paged block pool is the hand-written kernel in
``ops/cuda_attention.py``; ``paged_gather_indices`` and
``gather_paged_rows`` are the plain paged read its plain version and the
paged prefill use.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def paged_gather_indices(block_table: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """Flat pool-row indices for a paged read: ``block_table`` [B, nb]
    (pool block id of each slot's logical block) -> [B, nb * block_size],
    the pool row of every logical position per slot, in position order.
    Unallocated entries may hold any in-range id (conventionally 0): their
    rows sit beyond every query's position mask."""
    b, nb = block_table.shape
    idx = (block_table[:, :, None] * block_size
           + torch.arange(block_size, dtype=block_table.dtype,
                          device=block_table.device)[None, None, :])
    return idx.reshape(b, nb * block_size)


def gather_paged_rows(pool_rows: torch.Tensor,
                      flat_idx: torch.Tensor) -> torch.Tensor:
    """One layer's paged rows: pool [P, ...] x indices [B, S] ->
    [B, S, ...]."""
    return pool_rows[flat_idx.long()]


def _split_gqa(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """[B, T, Nq, D] -> [B, T, Nkv, G, D]."""
    b, t, nq, d = q.shape
    return q.reshape(b, t, num_kv_heads, nq // num_kv_heads, d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_positions: torch.Tensor) -> torch.Tensor:
    """Full-softmax GQA. q [B,T,Nq,D]; k,v [B,S,Nkv,D]; q_positions [B,T]."""
    nkv = k.shape[2]
    scale = q.shape[-1] ** -0.5
    qg = _split_gqa(q, nkv).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->btkgs", qg,
                          k.to(torch.float32)) * scale
    key_pos = torch.arange(k.shape[1], device=k.device)
    hidden = key_pos[None, None, :] > q_positions[:, :, None]  # [B,T,S]
    scores = scores.masked_fill(hidden[:, :, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", probs.to(v.dtype), v)
    b, t = q.shape[:2]
    return out.reshape(b, t, q.shape[2], q.shape[3])


def online_softmax_fold(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, key_pos: torch.Tensor,
                        carry: tuple) -> tuple:
    """Fold one K/V block into the online-softmax state (JAX
    ``online_softmax_fold``), shared by the ring and the sharded decode
    attention of parallel/ring_attention.py.

    qg [B, Tq, K, G, D] float32; k/v [B, Tk, K, D] any dtype;
    q_positions [B, Tq] and key_pos [Tk] absolute positions;
    carry = (m [B,Tq,K,G], l [B,Tq,K,G], acc [B,Tq,K,G,D]), float32."""
    m, l, acc = carry
    scale = qg.shape[-1] ** -0.5
    scores = torch.einsum("btkgd,bskd->btkgs", qg,
                          k.to(torch.float32)) * scale
    mask = key_pos[None, None, :] <= q_positions[:, :, None]
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    # The running max only keeps the exponentials in range: the result
    # does not depend on it, so it carries no gradient.
    m_new = torch.maximum(m, scores.detach().amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction[..., None] + torch.einsum(
        "btkgs,bskd->btkgd", p, v.to(torch.float32))
    return m_new, l_new, acc_new


def fold_init(b: int, t: int, nkv: int, g: int, d: int,
              device: torch.device | str) -> tuple:
    """The initial (m, l, acc) of ``online_softmax_fold``."""
    return (torch.full((b, t, nkv, g), _NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, t, nkv, g), dtype=torch.float32, device=device),
            torch.zeros((b, t, nkv, g, d), dtype=torch.float32,
                        device=device))


def fold_finish(carry: tuple, out_dtype: torch.dtype) -> torch.Tensor:
    """The folded state normalised into the [B, T, Nq, D] output."""
    _, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    b, t, nkv, g, d = acc.shape
    return out.reshape(b, t, nkv * g, d).to(out_dtype)


def attend_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, block_size: int = 512,
                     ) -> torch.Tensor:
    """Online-softmax GQA over key blocks (flash-attention recurrence),
    state (m, l, acc) in float32. Block 0 always holds a visible key
    (position 0), so a later fully masked block folds in as zeros."""
    b, t, nq, d = q.shape
    s, nkv = k.shape[1], k.shape[2]
    block_size = min(block_size, s)
    if s % block_size:
        raise ValueError(f"cache length {s} not divisible by block {block_size}")
    g = nq // nkv
    scale = d ** -0.5
    qg = _split_gqa(q, nkv).to(torch.float32)
    m = torch.full((b, t, nkv, g), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, t, nkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t, nkv, g, d), dtype=torch.float32,
                      device=q.device)
    for off in range(0, s, block_size):
        kb = k[:, off:off + block_size].to(torch.float32)
        vb = v[:, off:off + block_size].to(torch.float32)
        key_pos = off + torch.arange(block_size, device=q.device)
        scores = torch.einsum("btkgd,bskd->btkgs", qg, kb) * scale
        mask = key_pos[None, None, :] <= q_positions[:, :, None]
        scores = torch.where(mask[:, :, None, None, :], scores,
                             torch.full_like(scores, _NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum(
            "btkgs,bskd->btkgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, t, nq, d).to(q.dtype)
