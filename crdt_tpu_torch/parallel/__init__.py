"""Process-group parallelism: sharded object axes, collective lattice
joins and host-level join scheduling.

The reference has no comm backend: replication is bytes the user
transports (SURVEY.md §2.3).  Every CvRDT merge is an associative,
commutative, idempotent join, so an N-replica global join is an
all-reduce with merge as the combiner: ``all_reduce(MAX)`` for the
clock-shaped types, an all-gather and a fold in canonical order for
ORSWOT state (whose reference merge is order-sensitive; see
:mod:`.collective`).  Objects shard over a mesh's ``objects`` dim;
replicas reduce over its ``replicas`` dim, one rank per replica; a set
too big for one member table shards over a ``members`` dim
(:mod:`.member_sharding`).
"""

from .collective import (
    all_reduce_clock_join,
    allgather_fleet_snapshots,
    allgather_join_gset,
    allgather_join_lww,
    allgather_join_map,
    allgather_join_mvreg,
    allgather_join_orswot,
    anti_entropy,
    fold_reduce_merge,
    gather_fold_orswot,
    tree_reduce_merge,
)
from .executor import JoinError, JoinExecutor, JoinStats, join_all
from .member_sharding import (
    member_sharded_merge, partition_dense, rebroadcast_clock, sharded_apply_add,
    unpartition_dense,
)
from .mesh import make_mesh, replicate, shard_batch
from .multihost import (
    global_batch_from_local,
    initialize,
    local_shard,
    make_multihost_mesh,
    topology,
)

__all__ = [
    "all_reduce_clock_join",
    "allgather_join_gset",
    "allgather_join_lww",
    "allgather_join_map",
    "allgather_join_mvreg",
    "allgather_join_orswot",
    "gather_fold_orswot",
    "anti_entropy",
    "fold_reduce_merge",
    "join_all",
    "JoinError",
    "JoinExecutor",
    "JoinStats",
    "make_mesh",
    "replicate",
    "shard_batch",
    "tree_reduce_merge",
    "initialize",
    "topology",
    "make_multihost_mesh",
    "global_batch_from_local",
    "local_shard",
    "member_sharded_merge",
    "partition_dense",
    "rebroadcast_clock",
    "sharded_apply_add",
    "unpartition_dense",
]
