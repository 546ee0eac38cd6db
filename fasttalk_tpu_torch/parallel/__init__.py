"""Multi-rank serving over ``torch.distributed``: meshes, sharding rules,
collectives, ring attention and the SPMD leader/follower protocol.

Counterpart of ``fasttalk_tpu/parallel/``. The JAX package lays a mesh
over devices and lets GSPMD emit the collectives; the port runs one rank
per device, cuts each tensor to the rank's shard and calls the
collectives itself:

- ``mesh``           — this rank's place in a ("dp", "sp", "tp") mesh and
                       one process group per axis;
- ``distributed``    — the process group from ``TPU_COORDINATOR_ADDR`` /
                       ``TPU_NUM_PROCESSES`` / ``TPU_PROCESS_ID``;
- ``sharding``       — the partition rules and the local shards of the
                       params and the KV cache;
- ``collectives``    — the sums, gathers and ring hops, staged through
                       pinned host memory on gloo;
- ``ring_attention`` — ring prefill and the sharded decode attention
                       over "sp";
- ``spmd_serving``   — the leader's call broadcaster and the follower's
                       replay loop.
"""

from fasttalk_tpu_torch.parallel.mesh import (AXES, Mesh, MeshSpec,
                                              best_mesh_shape, make_mesh)
from fasttalk_tpu_torch.parallel.sharding import (cache_local_shape,
                                                  cache_pspecs, shard_params)

__all__ = [
    "AXES", "Mesh", "MeshSpec", "make_mesh", "best_mesh_shape",
    "cache_pspecs", "cache_local_shape", "shard_params",
]
