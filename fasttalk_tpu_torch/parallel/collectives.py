"""The collectives of multi-rank serving over the mesh's process groups.

The JAX package writes none of these: GSPMD emits them from the sharding
rules. The port calls them by hand, each over one mesh axis:

- ``all_reduce_sum`` over ``tp``: the partial outputs of the row-parallel
  ``wo`` and ``w_down`` and the partial logits of the tied head;
- ``all_gather`` over ``tp``: the embedding, sharded on its hidden axis;
- ``all_reduce_max`` / ``all_reduce_sum`` over ``sp``: the statistics of
  the sharded softmax (parallel/ring_attention.py);
- ``ring_shift`` over ``sp``: the ring's send/recv
  (``batch_isend_irecv``);
- ``all_gather`` over ``dp``: the sampled tokens of each rank's slots.

Sums are taken in a fixed rank order: each rank gathers every part and
adds them from rank 0 up, so the result is the same on every rank and from
run to run (a greedy stream on a mesh must not depend on which reduction
algorithm the backend picked).

Gloo moves host tensors only. When a group's backend is gloo, a CUDA
tensor goes through a pinned host buffer and back; this is the one place
that happens, and ``stats()`` counts the staged bytes. NCCL takes the
device tensors directly.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch

from fasttalk_tpu_torch.parallel.mesh import Mesh

_lock = threading.Lock()
_stats = {"staged_bytes": 0, "staged_calls": 0, "calls": 0}


def stats() -> dict:
    """This process's counts: collective calls, and the calls and bytes
    staged through host memory for gloo (each direction counted)."""
    with _lock:
        return dict(_stats)


def _count(staged: int) -> None:
    with _lock:
        _stats["calls"] += 1
        if staged:
            _stats["staged_calls"] += 1
            _stats["staged_bytes"] += staged


def _group(mesh: Mesh, axis: str):
    group = mesh.groups.get(axis)
    if group is None and mesh.shape[axis] > 1:
        raise RuntimeError(f"mesh axis {axis!r} has size "
                           f"{mesh.shape[axis]} but no process group "
                           "(a Mesh built without groups runs no "
                           "collective)")
    return group


def _needs_staging(group, t: torch.Tensor) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(group, t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The tensor the backend moves, and the bytes staged for it."""
    t = t.contiguous()
    if not _needs_staging(group, t):
        return t, 0
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host, t.numel() * t.element_size()


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """``x`` of every rank along ``axis``, concatenated on ``dim`` in axis
    order (every rank's ``x`` has the same shape)."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    if n == 1:
        return x
    group = _group(mesh, axis)
    wire, staged = _to_wire(group, x)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(x.device)
        staged += out.numel() * out.element_size()
    _count(staged)
    return out


def _gather_parts(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    n = mesh.shape[axis]
    stacked = all_gather(x[None], mesh, axis, dim=0)
    return [stacked[i] for i in range(n)]


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x``, added in rank order
    (the same bits on every rank)."""
    if mesh.shape[axis] == 1:
        return x
    parts = _gather_parts(x, mesh, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def all_reduce_max(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The elementwise max over ``axis`` of every rank's ``x``."""
    if mesh.shape[axis] == 1:
        return x
    parts = _gather_parts(x, mesh, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh,
               axis: str = "sp") -> list[torch.Tensor]:
    """One hop of the ring: each rank sends ``tensors`` to the next rank
    along ``axis`` and returns the ones of the previous rank (JAX's
    ``ppermute`` with ``perm = [(i, (i + 1) % n)]``), through
    ``batch_isend_irecv``."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    if n == 1:
        return list(tensors)
    group = _group(mesh, axis)
    ranks = mesh.axis_ranks(axis)
    i = mesh.coords[axis]
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    wires, ops, outs, staged = [], [], [], 0
    for t in tensors:
        wire, s = _to_wire(group, t)
        staged += s
        recv = torch.empty_like(wire)
        wires.append(wire)
        outs.append(recv)
        ops.append(dist.P2POp(dist.isend, wire, nxt, group=group))
        ops.append(dist.P2POp(dist.irecv, recv, prv, group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = []
    for t, recv in zip(tensors, outs):
        if recv.device != t.device:
            staged += recv.numel() * recv.element_size()
            recv = recv.to(t.device)
        out.append(recv)
    _count(staged)
    return out
