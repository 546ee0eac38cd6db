"""The fleet router of the port: a copy of ``fasttalk_tpu/router/``
(``migrate.py`` rewritten for torch tensors), the same exports."""

from fasttalk_tpu_torch.router.disagg import (DisaggController, parse_roles,
                                              tier_stats)
from fasttalk_tpu_torch.router.elastic import ElasticScaler
from fasttalk_tpu_torch.router.migrate import (deserialize_parked,
                                               serialize_parked, transfer)
from fasttalk_tpu_torch.router.policy import AffinityMap, PlacementPolicy
from fasttalk_tpu_torch.router.replica import (RemoteReplicaHandle,
                                               ReplicaHandle)
from fasttalk_tpu_torch.router.router import FleetRouter, build_fleet

__all__ = [
    "AffinityMap", "PlacementPolicy", "ReplicaHandle",
    "RemoteReplicaHandle", "FleetRouter", "build_fleet",
    "ElasticScaler", "serialize_parked", "deserialize_parked",
    "transfer", "DisaggController", "parse_roles", "tier_stats",
]
