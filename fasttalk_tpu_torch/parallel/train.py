"""Sharded training over a ("dp", "sp", "tp") mesh.

Counterpart of ``fasttalk_tpu/parallel/train.py``. The model trained is the
one the engine serves (models/llama.py ``forward``), differentiated by
autograd without a KV cache. The JAX package leaves the collectives of the
backward to GSPMD; the port runs one rank per device, and each collective
of the forward carries its own backward (parallel/collectives.py):

- params are this rank's shards (parallel/sharding.py ``shard_params``);
  the column-parallel products' replicated input sums its gradient over
  "tp", the row-parallel sums pass theirs through, so every rank of a "tp"
  group ends the backward with the same gradient of each replicated leaf;
- the batch: every rank passes the whole ``tokens`` [B, T + 1] and takes
  its "dp" rows and its contiguous "sp" chunk of the T inputs and targets
  (JAX ``P("dp", "sp")``; a T that "sp" does not divide is padded at the
  end with masked targets, which causal attention never shows to a real
  position);
- the loss is the global mean: each rank's masked sum and count are
  summed over "sp" and "dp" before the division (JAX's ``loss_mask``
  form), and the sum's backward gives every rank the gradient of the
  whole loss; the parameter gradients are then summed over "sp" and "dp"
  in rank order, so replicated leaves stay bit-equal on every rank that
  holds them.

Attention over the "sp"-sharded sequence has JAX's two forms, picked by
the same predicate (``_ring_or_none``): the gathered form (each rank's K/V
gathered over "sp"; the backward hands each rank the sum of every rank's
gradient of its chunk) and ring attention (parallel/ring_attention.py;
the K/V blocks hop around the ring and their gradients hop back).

The optimizer is the port's ``optax.adamw`` (training/optim.py), and
``make_train_step`` updates the params and moments in place, where JAX
donates them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.llama import forward
from fasttalk_tpu_torch.ops.attention import attend
from fasttalk_tpu_torch.parallel import collectives
from fasttalk_tpu_torch.parallel.mesh import Mesh
from fasttalk_tpu_torch.parallel.sharding import shard_params

# The axes the batch is split over, in the order the sums run.
_BATCH_AXES = ("sp", "dp")


def _split(n: int, mesh: Mesh, axis: str) -> tuple[int, int]:
    """(start, width) of this rank's part of ``n`` along ``axis`` (``n``
    rounded up to a multiple of the axis size)."""
    w = -(-n // mesh.shape[axis])
    return mesh.coords[axis] * w, w


def _local_batch(tokens: torch.Tensor, loss_mask: torch.Tensor | None,
                 mesh: Mesh | None) -> tuple[torch.Tensor, ...]:
    """This rank's inputs, targets, positions and target weights."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    b, t = inputs.shape
    mask = (torch.ones((b, t), dtype=torch.float32, device=tokens.device)
            if loss_mask is None
            else loss_mask.to(device=tokens.device, dtype=torch.float32))
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    if mesh is None:
        return inputs, targets, positions, mask
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if b % dp:
        raise ValueError(f"dp={dp} does not divide the batch of {b} rows")
    r0, rows = _split(b, mesh, "dp")
    inputs, targets, mask = (x[r0:r0 + rows] for x in (inputs, targets,
                                                       mask))
    s0, width = _split(t, mesh, "sp")
    pad = width * sp - t
    if pad:
        inputs, targets, mask = (F.pad(x, (0, pad))
                                 for x in (inputs, targets, mask))
    positions = torch.arange(s0, s0 + width,
                             device=tokens.device)[None].expand(rows, width)
    return (inputs[:, s0:s0 + width], targets[:, s0:s0 + width], positions,
            mask[:, s0:s0 + width])


def gathered_override(mesh: Mesh) -> Callable:
    """The ``attn_override`` of the gathered form over "sp": every rank's
    K/V chunk gathered (the whole sequence, its index the position), then
    plain attention for this rank's queries. Each rank consumes the
    gathered K/V with its own queries, so the gather's backward sums every
    rank's gradient of this rank's chunk."""

    def attn(q, k, v, positions):
        k = collectives.all_gather(k.contiguous(), mesh, "sp", dim=1,
                                   varied=True)
        v = collectives.all_gather(v.contiguous(), mesh, "sp", dim=1,
                                   varied=True)
        return attend(q, k, v, positions)

    return attn


def ring_override(mesh: Mesh) -> Callable:
    """The ``attn_override`` that routes a train/eval forward through
    parallel/ring_attention.py (K/V rotating over the "sp" ring)."""
    from fasttalk_tpu_torch.parallel.ring_attention import \
        ring_attention_sharded

    def attn(q, k, v, positions):
        return ring_attention_sharded(q, k.contiguous(), v.contiguous(),
                                      positions, mesh)

    return attn


def _ring_or_none(mesh: Mesh | None, ring_min_seq: float,
                  seq_len: int) -> Callable | None:
    """Ring attention when the mesh has sp > 1, the sequence is long enough
    to be worth the hops and it splits evenly; else None (the gathered
    form). The one routing predicate of the train and eval steps."""
    sp = 1 if mesh is None else mesh.shape.get("sp", 1)
    if sp > 1 and seq_len >= ring_min_seq and seq_len % sp == 0:
        return ring_override(mesh)
    return None


def causal_lm_loss(params: Any, cfg: ModelConfig, tokens: torch.Tensor,
                   loss_mask: torch.Tensor | None = None,
                   attn_override: Callable | None = None, *,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """Next-token cross entropy over ``tokens`` [B, T] on float32 logits
    (optax's ``softmax_cross_entropy_with_integer_labels``): the mean, or
    with ``loss_mask`` [B, T-1] (1 = count) the masked sum over the mask's
    sum (at least 1). ``attn_override`` swaps the attention (ring
    attention over "sp", ``ring_override``).

    ``mesh``: ``params`` are this rank's shards and ``tokens`` the whole
    batch; every rank returns the loss of the whole batch, and its
    backward gives this rank's part of every gradient (parallel/train.py
    module notes). On sp > 1 without an override, the gathered form."""
    inputs, targets, positions, mask = _local_batch(tokens, loss_mask, mesh)
    if attn_override is None and mesh is not None and mesh.shape["sp"] > 1:
        attn_override = gathered_override(mesh)
    logits, _ = forward(params, cfg, inputs, positions, None, None,
                        attn_override=attn_override, mesh=mesh)
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1).long(), reduction="none")
    total = (losses.view(mask.shape) * mask).sum()
    count = mask.sum()
    if mesh is not None:
        for axis in _BATCH_AXES:
            total = collectives.all_reduce_sum(total, mesh, axis)
            count = collectives.all_reduce_sum(count, mesh, axis)
    if loss_mask is None:
        return total / count
    return total / torch.clamp(count, min=1.0)


def _leaves(tree: dict, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _replace(tree: dict, new: dict, path: tuple = ()) -> dict:
    return {k: _replace(v, new, path + (k,)) if isinstance(v, dict)
            else new[path + (k,)] for k, v in tree.items()}


def _float_leaves(params: dict) -> list[tuple[tuple, torch.Tensor]]:
    leaves = list(_leaves(params))
    for path, t in leaves:
        if not t.is_floating_point():
            raise ValueError(f"training needs float params: "
                             f"{'/'.join(path)} is {t.dtype}")
    return leaves


def value_and_grad(fn: Callable[[dict], torch.Tensor], params: dict,
                   ) -> tuple[torch.Tensor, dict]:
    """``fn(params)`` and its gradient, a dict keyed like ``params``'s
    leaves by path (``jax.value_and_grad`` for a loss of float params). The
    params themselves are left as they are: autograd runs on detached
    views of them."""
    leaves = _float_leaves(params)
    live = [t.detach().requires_grad_() for _, t in leaves]
    with torch.enable_grad():
        value = fn(_replace(params, {p: x for (p, _), x in
                                     zip(leaves, live)}))
        grads = torch.autograd.grad(value, live, allow_unused=True)
    return value.detach(), {
        p: torch.zeros_like(t) if g is None else g
        for (p, t), g in zip(leaves, grads)}


def sum_batch_grads(grads: dict, mesh: Mesh | None) -> dict:
    """Each gradient summed over "sp" and "dp" (the ranks that hold the
    same shard with other parts of the batch), in rank order: one flat
    collective per dtype and axis."""
    if mesh is None:
        return grads
    for axis in _BATCH_AXES:
        if mesh.shape[axis] == 1:
            continue
        by_dtype: dict[torch.dtype, list] = {}
        for p, g in grads.items():
            by_dtype.setdefault(g.dtype, []).append(p)
        for paths in by_dtype.values():
            flat = collectives.all_reduce_sum(
                torch.cat([grads[p].reshape(-1) for p in paths]), mesh, axis)
            for p, part in zip(paths, flat.split(
                    [grads[p].numel() for p in paths])):
                grads[p] = part.view(grads[p].shape)
    return grads


def _as_tokens(tokens: Any, params: dict) -> torch.Tensor:
    device = params["final_norm"].device
    return torch.as_tensor(tokens, device=device).long()


def make_train_step(cfg: ModelConfig, optimizer: Any, mesh: Mesh | None,
                    ring_min_seq: float = 4096) -> Callable:
    """The sharded train step: ``(params, opt_state, tokens) -> (params,
    opt_state, loss)``. ``params`` and ``opt_state`` (from
    ``init_sharded_training``) are updated in place and returned, as JAX
    donates them; ``tokens`` [B, T + 1] is the whole batch on every rank;
    ``loss`` is the step's loss before the update (a 0-d tensor).

    When the mesh has sp > 1 and the sequence length reaches
    ``ring_min_seq``, attention runs through ring attention instead of the
    gathered form: per-rank sequence memory drops from O(T) to O(T/sp).
    ``ring_min_seq=0`` forces the ring at any length that splits evenly."""

    def train_step(params, opt_state, tokens):
        tokens = _as_tokens(tokens, params)
        override = _ring_or_none(mesh, ring_min_seq, tokens.shape[1] - 1)
        loss, grads = value_and_grad(
            lambda p: causal_lm_loss(p, cfg, tokens, None, override,
                                     mesh=mesh), params)
        optimizer.update(sum_batch_grads(grads, mesh), opt_state, params)
        return params, opt_state, loss

    return train_step


def _owned(tree: dict, source: dict) -> dict:
    """``tree`` with every leaf that is still ``source``'s own tensor
    copied, so that updating it in place leaves the caller's params as
    they were."""
    return {k: _owned(v, source[k]) if isinstance(v, dict)
            else (v.detach().clone() if v is source[k] else v)
            for k, v in tree.items()}


def init_sharded_training(cfg: ModelConfig, params: Any, mesh: Mesh,
                          learning_rate: Any = 1e-4,
                          ) -> tuple[Any, Any, Any]:
    """Shard ``params`` (the whole model) onto this rank and build the
    matching optimizer state: ``(params, opt_state, optimizer)`` with
    ``optimizer`` the port's ``optax.adamw(learning_rate)``."""
    from fasttalk_tpu_torch.training.optim import adamw

    params = _owned(shard_params(params, mesh), params)
    _float_leaves(params)
    optimizer = adamw(learning_rate)
    return params, optimizer.init(params), optimizer


def eval_step(cfg: ModelConfig, mesh: Mesh | None,
              ring_min_seq: float = 4096) -> Callable:
    """The sharded eval loss: ``(params, tokens) -> loss``, with the train
    step's attention routing."""

    def step(params, tokens):
        tokens = _as_tokens(tokens, params)
        override = _ring_or_none(mesh, ring_min_seq, tokens.shape[1] - 1)
        with torch.no_grad():
            return causal_lm_loss(params, cfg, tokens, None, override,
                                  mesh=mesh)

    return step


__all__ = ["causal_lm_loss", "make_train_step", "init_sharded_training",
           "eval_step", "ring_override", "gathered_override",
           "value_and_grad", "sum_batch_grads"]
