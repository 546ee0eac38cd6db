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

Training differentiates through them (parallel/train.py), where GSPMD
derives each backward for the JAX package. Each function is a
``torch.autograd.Function`` whose forward is the plain collective, so
serving's calls under ``no_grad`` compute the same bits and record
nothing. The backwards follow how the training forward consumes each
output (Megatron's *f* and *g*):

- ``all_reduce_sum`` (the row-parallel sum, consumed replicated):
  identity;
- ``replicated_input`` (identity forward: the replicated input of a
  column-parallel product, each rank reading it for its own shard): the
  sum of the input gradients over the axis;
- ``all_gather`` consumed replicated (the embedding over "tp", the untied
  head's logits): this rank's slice of the gradient; consumed differently
  by each rank (``varied``: the K/V of the gathered "sp" attention, each
  rank with its own queries): a reduce-scatter, this rank's slice of the
  gradients' sum over the axis;
- ``ring_shift``: the reverse hop.

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


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
                dim: int = 0) -> torch.Tensor:
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
    stacked = _all_gather(x[None], mesh, axis, dim=0)
    return [stacked[i] for i in range(n)]


def _all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return x
    parts = _gather_parts(x, mesh, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _own_slice(g: torch.Tensor, mesh: Mesh, axis: str,
               dim: int) -> torch.Tensor:
    w = g.shape[dim] // mesh.shape[axis]
    return g.narrow(dim, mesh.coords[axis] * w, w).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, varied):
        ctx.mesh, ctx.axis, ctx.dim, ctx.varied = mesh, axis, dim, varied
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.varied:
            g = _all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axis)
        return (_own_slice(g, ctx.mesh, ctx.axis, ctx.dim),
                None, None, None, None)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
               varied: bool = False) -> torch.Tensor:
    """``x`` of every rank along ``axis``, concatenated on ``dim`` in axis
    order (every rank's ``x`` has the same shape). Its gradient is this
    rank's slice of the output's; with ``varied`` (each rank consumes the
    output its own way) the slice of the gradients' sum over ``axis``."""
    if mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim, varied)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x``, added in rank order
    (the same bits on every rank). The output is consumed replicated: its
    gradient passes through unchanged."""
    if mesh.shape[axis] == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axis)


def replicated_input(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` itself, entering a product sharded over ``axis``: its gradient
    is the sum over ``axis`` of every rank's (each rank's shard contributes
    its own part)."""
    if mesh.shape[axis] == 1:
        return x
    return _ReplicatedInput.apply(x, mesh, axis)


def all_reduce_max(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The elementwise max over ``axis`` of every rank's ``x``."""
    if mesh.shape[axis] == 1:
        return x
    parts = _gather_parts(x, mesh, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


def _ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
                hop: int) -> list[torch.Tensor]:
    import torch.distributed as dist

    n = mesh.shape[axis]
    group = _group(mesh, axis)
    ranks = mesh.axis_ranks(axis)
    i = mesh.coords[axis]
    nxt, prv = ranks[(i + hop) % n], ranks[(i - hop) % n]
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


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.floats = [i for i, t in enumerate(tensors)
                      if t.is_floating_point()]
        out = _ring_shift(tensors, mesh, axis, 1)
        ctx.mark_non_differentiable(*(o for i, o in enumerate(out)
                                      if i not in ctx.floats))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        # The gradient of what this rank received goes back to its sender.
        back = _ring_shift([grads[i].contiguous() for i in ctx.floats],
                           ctx.mesh, ctx.axis, -1)
        out: list = [None] * len(grads)
        for i, g in zip(ctx.floats, back):
            out[i] = g
        return (None, None, *out)


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh,
               axis: str = "sp") -> list[torch.Tensor]:
    """One hop of the ring: each rank sends ``tensors`` to the next rank
    along ``axis`` and returns the ones of the previous rank (JAX's
    ``ppermute`` with ``perm = [(i, (i + 1) % n)]``), through
    ``batch_isend_irecv``. The gradients of the floating-point tensors hop
    back to the previous rank."""
    if mesh.shape[axis] == 1:
        return list(tensors)
    return list(_RingShift.apply(mesh, axis, *tensors))
