"""Attention over a sequence sharded on the "sp" mesh axis.

Counterpart of ``fasttalk_tpu/parallel/ring_attention.py``. Each function
is the per-rank body of the JAX ``shard_map`` (which is manual over "sp"
only): it takes this rank's shard and runs the "sp" collectives itself
(parallel/collectives.py). The JAX package computes both in plain ``jnp``
outside any Pallas kernel, and so does the port, in plain torch.

- ``ring_attention_sharded``: causal self-attention where each rank holds
  one contiguous chunk of Q/K/V; the K/V blocks and their positions
  rotate around the ring (``ring_shift``: send to the next rank, receive
  from the previous) while every rank folds each visiting block into its
  online-softmax state. Per-rank attention memory is O(T/sp).
- ``decode_attention_sharded``: cache-read attention where each rank holds
  one sequence shard of the KV cache: a local fold, then the max and the
  sums of the softmax statistics over "sp" (the flash-decoding combine).
  Traffic per step is the statistics, independent of the sequence length.
"""

from __future__ import annotations

from typing import Callable

import torch

from fasttalk_tpu_torch.ops.attention import (fold_finish, fold_init,
                                              online_softmax_fold)
from fasttalk_tpu_torch.parallel.collectives import (all_reduce_max,
                                                     all_reduce_sum,
                                                     ring_shift)
from fasttalk_tpu_torch.parallel.mesh import Mesh


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           positions: torch.Tensor, mesh: Mesh,
                           axis_name: str = "sp",
                           on_block: Callable[[int, torch.Tensor,
                                               torch.Tensor], None]
                           | None = None) -> torch.Tensor:
    """Causal GQA self-attention of this rank's sequence chunk.

    q [B, Tl, Nq, D], k/v [B, Tl, Nkv, D] and positions [B, Tl] (absolute;
    the same on every batch row) are this rank's chunk of a sequence split
    evenly over ``axis_name``; returns this rank's [B, Tl, Nq, D]. The
    blocks visit every rank once (``sp`` folds, ``sp - 1`` hops).
    ``on_block(src, k, v)`` sees each visiting block with the index along
    the axis of the rank whose chunk it is (ring prefill writes the rows
    its cache shard holds from them)."""
    sp = mesh.shape[axis_name]
    me = mesh.coords[axis_name]
    b, tl, nq, d = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, tl, nkv, g, d).to(torch.float32)
    carry = fold_init(b, tl, nkv, g, d, q.device)
    k_pos = positions[0].contiguous()
    for i in range(sp):
        if on_block is not None:
            on_block((me - i) % sp, k, v)
        carry = online_softmax_fold(qg, k, v, positions, k_pos, carry)
        if i + 1 < sp:
            k, v, k_pos = ring_shift((k, v, k_pos), mesh, axis_name)
    return fold_finish(carry, q.dtype)


def decode_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_positions: torch.Tensor,
                             mesh: Mesh, axis_name: str = "sp",
                             ) -> torch.Tensor:
    """Cache-read GQA attention with the cache sequence-sharded over
    ``axis_name``.

    q [B, T, Nq, D] and q_positions [B, T] are the same on every rank of
    the axis; k/v [B, S/sp, Nkv, D] are this rank's shard, holding the
    absolute key positions ``index * S/sp + [0, S/sp)``. A shard whose
    keys are all masked contributes exp(-inf) * 0 = 0."""
    b, t, nq, d = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, t, nkv, g, d).to(torch.float32)
    local_s = k.shape[1]
    key_pos = mesh.coords[axis_name] * local_s \
        + torch.arange(local_s, device=q.device)
    m, l, acc = online_softmax_fold(qg, k, v, q_positions, key_pos,
                                    fold_init(b, t, nkv, g, d, q.device))
    m_g = all_reduce_max(m, mesh, axis_name)
    corr = torch.exp(m - m_g)
    l_g = all_reduce_sum(l * corr, mesh, axis_name)
    acc_g = all_reduce_sum(acc * corr[..., None], mesh, axis_name)
    return fold_finish((m_g, l_g, acc_g), q.dtype)
