"""Crash recovery: snapshot restore, then bounded WAL replay (the port of
the JAX package's ``durable/recover.py``).

1. **Restore and self-verify.**  :meth:`~crdt_tpu_torch.durable.snapshot.
   SnapshotStore.load_latest` walks the retained generations newest
   first; each must pass the envelope checks and recompute to the
   digest-tree root recorded at save time, else recovery falls back past
   it, loudly.
2. **Bounded WAL replay.**  Every complete op frame from the snapshot's
   sequence on replays through :class:`~crdt_tpu_torch.oplog.OpApplier`
   (the path live writes take), after the snapshot's parked ops re-park.
   Replaying a frame the snapshot already holds is a no-op.
3. **Delta-sync catch-up.**  What the fleet did meanwhile, and what a torn
   WAL tail lost, arrives by the normal digest and delta session from the
   restored state: rejoining is a gossip round, so nothing here does it.

:func:`recover` runs steps 1 and 2 onto the card (``device="cuda"``, the
default) and returns what a caller needs to rebuild a
:class:`~crdt_tpu_torch.cluster.gossip.ClusterNode`; the
:class:`RecoveryReport` fields and the ``durable.recovery`` event carry
the audit trail.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np

from ..device import resolve_device
from ..error import CrdtError
from ..obs import events as obs_events
from .snapshot import SnapshotStore
from .wal import replay_frames

#: the layout under one node's durable directory
SNAPSHOT_SUBDIR = "snapshots"
WAL_SUBDIR = "wal"


@dataclasses.dataclass
class RecoveryReport:
    """What one recovery restored, replayed, and cost."""

    generation: int = 0
    wal_seq: int = 0              # replay started here (the snapshot's sequence)
    replayed_frames: int = 0
    replayed_ops: int = 0
    duplicate_ops: int = 0        # replayed ops the snapshot already held
    parked_ops: int = 0           # causally gapped ops parked at the end
    replayed_bytes: int = 0       # WAL bytes decoded during replay
    rejected_frames: int = 0      # replay stopped at a bad frame
    wall_s: float = 0.0
    node_id: str = ""


@dataclasses.dataclass
class RecoveredReplica:
    """A restored replica, ready to rejoin: the verified batch (on the
    requested device), its universe, the op applier carrying the ops still
    parked, the persisted version vector, GC watermark and
    stability-frontier clocks (seed a tracker with
    ``StabilityTracker.restore(frontier)``), and the audit report.
    ``snapshot_digests`` is the restored snapshot's digest vector before
    the replay; ``split_s`` the seconds of each step (the snapshot's
    read, CRC, decode, H2D and root verify, then ``replay``)."""

    batch: object
    universe: object
    applier: object
    vv: np.ndarray
    watermark: Optional[np.ndarray]
    report: RecoveryReport
    frontier: Optional[np.ndarray] = None
    snapshot_digests: Optional[np.ndarray] = None
    split_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def recover(dirpath, *, device="cuda") -> Optional[RecoveredReplica]:
    """Steps 1 and 2 against one node's durable directory (the
    ``<dir>/snapshots`` and ``<dir>/wal`` a
    :class:`~crdt_tpu_torch.durable.manager.Durability` writes), onto
    ``device``: raises :class:`~crdt_tpu_torch.error.DeviceUnavailableError`
    when that is ``"cuda"`` and no card is present.  None when no
    generation exists; :class:`~crdt_tpu_torch.error.DurabilityError` when
    every one is bad.  Replay stops loudly at a torn tail or an
    undecodable frame, never skipping one."""
    from ..oplog.apply import OpApplier
    from ..oplog.wire import decode_ops_frame

    dev = resolve_device(device)
    dirpath = os.fspath(dirpath)
    t0 = time.perf_counter()
    snap = SnapshotStore(os.path.join(dirpath, SNAPSHOT_SUBDIR)).load_latest(device=dev)
    if snap is None:
        return None
    t_replay = time.perf_counter()
    report = RecoveryReport(generation=snap.generation, wal_seq=snap.wal_seq,
                            node_id=snap.node_id)
    applier = OpApplier(snap.universe)
    batch = snap.batch
    if snap.parked is not None and len(snap.parked):
        # the parked ops re-enter the way they came: still-gapped ones park
        # again, ones whose predecessors the snapshot holds apply
        batch, rep = applier.apply_ops(batch, snap.parked)
        report.replayed_ops += rep.ops
        report.duplicate_ops += rep.duplicates
    num_actors = snap.universe.config.num_actors
    for seq, frame in replay_frames(os.path.join(dirpath, WAL_SUBDIR), from_seq=snap.wal_seq):
        try:
            ops = decode_ops_frame(frame, num_actors=num_actors)
        except (CrdtError, ValueError) as e:
            # in-frame corruption (the codec counted its reason): record
            # where the replay stopped and leave the rest to delta sync
            report.rejected_frames += 1
            obs_events.record("durable.wal_replay_rejected", seq=seq, error=str(e)[:200])
            break
        batch, rep = applier.apply_ops(batch, ops)
        report.replayed_frames += 1
        report.replayed_ops += rep.ops
        report.duplicate_ops += rep.duplicates
        report.replayed_bytes += len(frame)
    report.parked_ops = len(applier.parked)
    report.wall_s = time.perf_counter() - t0
    obs_events.record("durable.recovery", node=report.node_id, generation=report.generation,
                      replayed_frames=report.replayed_frames, replayed_ops=report.replayed_ops,
                      duplicates=report.duplicate_ops, parked=report.parked_ops,
                      wall_s=round(report.wall_s, 6))
    return RecoveredReplica(batch=batch, universe=snap.universe, applier=applier, vv=snap.vv,
                            watermark=snap.watermark, report=report, frontier=snap.frontier,
                            snapshot_digests=snap.digests,
                            split_s={**snap.split_s, "replay": time.perf_counter() - t_replay})
