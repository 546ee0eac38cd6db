"""The ("dp", "sp", "tp") mesh over the ranks of ``torch.distributed``.

Counterpart of ``fasttalk_tpu/parallel/mesh.py``. The axes keep their
meaning:

- ``"dp"``: data parallel over decode slots;
- ``"sp"``: sequence parallel over each slot's KV rows (ring prefill and
  the sharded decode attention ride it);
- ``"tp"``: tensor parallel over attention heads and FFN width.

The JAX package lays a mesh over devices and lets GSPMD emit the
collectives. The port runs one process (rank) per device, as
``torch.distributed`` and NCCL expect, so a mesh here is this rank's place
in the grid plus one process group per axis: the ranks that share this
rank's other two coordinates. Ranks are numbered row-major over
(dp, sp, tp), as the JAX package reshapes ``jax.devices()``, so the tp
peers of a rank are adjacent ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

AXES = ("dp", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp


def rank_of(spec: MeshSpec, dp: int, sp: int, tp: int) -> int:
    """The rank at mesh coordinates (dp, sp, tp)."""
    return (dp * spec.sp + sp) * spec.tp + tp


class Mesh:
    """One rank's view of the mesh: ``shape`` (axis -> size, as a JAX
    mesh's), this rank's ``coords`` (axis -> index) and, on a live mesh,
    ``groups`` (axis -> the process group of this rank's peers along the
    axis; None for an axis of size 1). Built without ``groups`` it only
    places shards (parallel/sharding.py) and runs no collective."""

    def __init__(self, spec: MeshSpec, rank: int,
                 groups: dict[str, Any] | None = None,
                 backend: str | None = None):
        if not 0 <= rank < spec.size:
            raise ValueError(f"rank {rank} is outside mesh {spec}")
        self.spec = spec
        self.rank = rank
        self.shape = {"dp": spec.dp, "sp": spec.sp, "tp": spec.tp}
        rest, tp = divmod(rank, spec.tp)
        dp, sp = divmod(rest, spec.sp)
        self.coords = {"dp": dp, "sp": sp, "tp": tp}
        self.groups = groups or {}
        self.backend = backend

    @property
    def size(self) -> int:
        return self.spec.size

    def axis_ranks(self, axis: str) -> list[int]:
        """The ranks of this rank's group along ``axis``, in axis order."""
        c = dict(self.coords)
        out = []
        for i in range(self.shape[axis]):
            c[axis] = i
            out.append(rank_of(self.spec, c["dp"], c["sp"], c["tp"]))
        return out

    def describe(self) -> dict:
        return {**self.shape, "rank": self.rank, "coords": dict(self.coords),
                "backend": self.backend}

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.spec.dp}, sp={self.spec.sp}, "
                f"tp={self.spec.tp}, rank={self.rank})")


def _axis_groups(spec: MeshSpec, axis: str) -> list[list[int]]:
    """Every group of ranks along ``axis`` (one per combination of the
    other two coordinates), in a fixed order."""
    others = [a for a in AXES if a != axis]
    sizes = {"dp": spec.dp, "sp": spec.sp, "tp": spec.tp}
    out = []
    for i in range(sizes[others[0]]):
        for j in range(sizes[others[1]]):
            ranks = []
            for k in range(sizes[axis]):
                c = {others[0]: i, others[1]: j, axis: k}
                ranks.append(rank_of(spec, c["dp"], c["sp"], c["tp"]))
            out.append(ranks)
    return out


def make_mesh(spec: MeshSpec | None = None, *, dp: int = 1, sp: int = 1,
              tp: int = 1) -> Mesh:
    """This rank's ("dp", "sp", "tp") mesh over the world's ranks, with one
    process group per axis. Needs the process group up
    (parallel/distributed.py ``maybe_initialize``) unless the mesh is one
    rank. Every rank of the world must call it (group creation is
    collective); the first ``spec.size`` ranks form the mesh."""
    import torch.distributed as dist

    if spec is None:
        spec = MeshSpec(dp=dp, sp=sp, tp=tp)
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if spec.size > world:
        raise ValueError(
            f"mesh {spec} needs {spec.size} devices, have {world}")
    groups: dict[str, Any] = {}
    for axis in AXES:
        mine = None
        for ranks in _axis_groups(spec, axis):
            if len(ranks) == 1:
                continue
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        groups[axis] = mine
    if rank >= spec.size:
        raise ValueError(f"rank {rank} is outside mesh {spec}: run "
                         f"{spec.size} ranks for it")
    return Mesh(spec, rank, groups,
                backend=dist.get_backend() if up else None)


def best_mesh_shape(n_devices: int, *, model_kv_heads: int = 8,
                    want_sp: bool = False) -> MeshSpec:
    """A sensible default mesh for ``n_devices`` (a copy of the JAX
    package's): tp up to the KV heads, the rest to dp, or split with sp for
    long-context work."""
    tp = 1
    while tp * 2 <= min(n_devices, model_kv_heads) and n_devices % (tp * 2) == 0:
        tp *= 2
    rest = n_devices // tp
    if want_sp and rest % 2 == 0:
        return MeshSpec(dp=rest // 2, sp=2, tp=tp)
    return MeshSpec(dp=rest, sp=1, tp=tp)
