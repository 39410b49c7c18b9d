"""Kill -9 survivable replicas (the port of the JAX package's ``durable``
package, writing the same files).

* :mod:`~crdt_tpu_torch.durable.snapshot`: the snapshot store, retained
  CRC'd generations of dense planes, intern tables, version vector, GC
  watermark, stability frontier and parked ops, written temp-fsync-rename
  and root-verified on load;
* :mod:`~crdt_tpu_torch.durable.wal`: op-frame write-ahead segments above
  the snapshot, fsync'd before the fold, torn tails cut loudly, segments a
  snapshot covers dropped;
* :mod:`~crdt_tpu_torch.durable.recover`: restore and bounded replay onto
  the card, after which a rejoining node catches up by delta sync;
* :class:`~crdt_tpu_torch.durable.manager.Durability`: the policy
  ``ClusterNode(durability=)`` takes.

Torn snapshot writes are injected by
:class:`~crdt_tpu_torch.cluster.faults.TornWriter`, crashes by
:func:`~crdt_tpu_torch.cluster.faults.crash_point`.
"""

from .manager import Durability  # noqa: F401
from .recover import RecoveredReplica, RecoveryReport, recover  # noqa: F401
from .snapshot import Snapshot, SnapshotStore  # noqa: F401
from .wal import WalWriter, replay_frames, split_frames  # noqa: F401

__all__ = [
    "Durability",
    "RecoveredReplica",
    "RecoveryReport",
    "Snapshot",
    "SnapshotStore",
    "WalWriter",
    "recover",
    "replay_frames",
    "split_frames",
]
