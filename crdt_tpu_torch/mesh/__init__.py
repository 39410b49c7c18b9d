"""Mesh-sharded fleets: one logical replica in S shards over the ranks
of an ``objects`` mesh (the port of ``crdt_tpu/mesh/``).

* :mod:`.state` — :class:`MeshLayout` (subtree-granule shard bounds,
  priced by the placement planner) and :class:`ShardedBatch` (padded,
  each rank holding its shards);
* :mod:`.contracts` — the dispatch gate over the contract rows the mesh
  layer consumes, refusing with :class:`~crdt_tpu_torch.error.
  MeshContractError`;
* :mod:`.step` — the anti-entropy round per rank: shard-local merges
  (the merge kernel on the card), one digest ``all_gather``, the clock
  MAX and the member SUM;
* :mod:`.sync` — shard-subset repair: per-shard roots, the descent
  scoped to the diverged shards;
* :mod:`.durable` — per-shard snapshot generations tied by a fleet
  manifest.
"""

from .contracts import SHARDABLE_CLASSES, consumed_contracts, contract_map, require_shardable
from .durable import MeshSnapshotStore, shard_root_of
from .state import (
    MESH_AXIS, MESH_SIZES, MeshLayout, ShardedBatch, choose_layout, mesh_counts, shard_loads,
)
from .step import MeshStepResult, anti_entropy_step
from .sync import ShardSyncStats, diverged_shards, shard_roots, shard_subset_sync

__all__ = [
    "MESH_AXIS", "MESH_SIZES", "MeshLayout", "MeshSnapshotStore", "MeshStepResult",
    "ShardSyncStats", "SHARDABLE_CLASSES", "ShardedBatch", "anti_entropy_step", "choose_layout",
    "consumed_contracts", "contract_map", "diverged_shards", "mesh_counts", "require_shardable",
    "shard_loads", "shard_root_of", "shard_roots", "shard_subset_sync",
]
