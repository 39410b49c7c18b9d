"""Durability: the per-node policy object ``ClusterNode(durability=)``
takes (the port of the JAX package's ``durable/manager.py``).

One :class:`Durability` owns one node's durable directory::

    <dir>/snapshots/snap-<generation>-w<wal seq>.crdtsnap   retained generations
    <dir>/wal/wal-<first seq>.log                           op-frame segments

and wires them into the node's life:

* **ingest**: :meth:`Durability.wal_append` runs in the node's ingest
  critical section before the op enters the in-memory log, so a write
  acknowledged to its caller is on disk first;
* **checkpoint**: :meth:`Durability.checkpoint` runs at gossip-round end
  on its cadence (:meth:`Durability.due`) under the node's busy lock,
  never concurrent with a session and skipped, not queued, when one
  runs: it writes the next generation, rolls the WAL and drops the
  segments every retained generation covers;
* **recovery**: :func:`crdt_tpu_torch.durable.recover`, before any node
  exists.

The replay bound: the node captures ``wal_seq`` while no writer is
between its WAL append and its log append, so every frame below it is
in the log by the drain and folds into the snapshot, and every frame at
or above it replays.  Replaying a folded frame is a no-op, so ingest is
at least once, never at most once.  The JAX package's ``durable.*``
gauges and counters are :meth:`Durability.counts` and
:meth:`Durability.snapshot`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

from .recover import SNAPSHOT_SUBDIR, WAL_SUBDIR
from .snapshot import Snapshot, SnapshotStore, snapshot_counts
from .wal import WalWriter, torn_count


class Durability:
    """Snapshot and WAL policy for one cluster node.

    ``interval_rounds``: checkpoint every Nth gossip round.  ``retain``:
    generations kept.  ``fsync``: gate the disk syncs (leave it on
    outside benchmarks).  ``segment_bytes``: the WAL's roll size.
    ``writer``: the snapshot writer hook
    (:class:`~crdt_tpu_torch.cluster.faults.TornWriter` wraps it).
    ``last_snapshot`` keeps the newest checkpoint's metadata and digest
    vector but not its planes: the node's batch moves on, and a held
    batch would keep a whole replica alive on the card."""

    def __init__(self, dirpath, *, interval_rounds: int = 1, retain: int = 2,
                 fsync: bool = True, segment_bytes: int = 4 << 20, writer=None):
        if interval_rounds < 1:
            raise ValueError(f"interval_rounds {interval_rounds} < 1")
        self.dirpath = os.fspath(dirpath)
        self.interval_rounds = int(interval_rounds)
        self.store = SnapshotStore(os.path.join(self.dirpath, SNAPSHOT_SUBDIR), retain=retain,
                                   fsync=fsync, writer=writer)
        self.wal = WalWriter(os.path.join(self.dirpath, WAL_SUBDIR),
                             segment_bytes=segment_bytes, fsync=fsync)
        self.snapshots_written = 0
        self.last_snapshot: Optional[Snapshot] = None
        self._last_snapshot_monotonic: Optional[float] = None

    def wal_append(self, ops_or_frame) -> int:
        """Append one op batch, or an encoded op frame (the piggyback sink
        passes its bytes through), to the WAL.  Returns its sequence; once
        this returns the ops survive kill -9."""
        return self.wal.append(ops_or_frame)

    def due(self, round_no: int) -> bool:
        """Whether the round-end hook checkpoints this round."""
        return round_no % self.interval_rounds == 0

    @property
    def snapshot_age_s(self) -> Optional[float]:
        if self._last_snapshot_monotonic is None:
            return None
        return time.monotonic() - self._last_snapshot_monotonic

    def counts(self) -> dict:
        """Snapshots written by this manager, WAL frames, bytes and
        segments dropped by its writer, and the process's torn WAL tails,
        snapshot rejections by reason and fallbacks."""
        snap = snapshot_counts()
        return {"snapshots": self.snapshots_written, **{f"wal_{k}": v for k, v in
                                                       self.wal.counts().items()},
                "wal_torn": torn_count(), "snapshot_rejected": snap["rejected"],
                "snapshot_fallbacks": snap["fallbacks"]}

    def snapshot(self) -> dict:
        """The gauges' view now: the newest generation, its bytes and age,
        and the WAL's depth and pending bytes."""
        frames, nbytes = self.wal.pending()
        last = self.last_snapshot
        return {"generation": last.generation if last else 0,
                "snapshot_bytes": last.nbytes if last else 0,
                "snapshot_age_s": self.snapshot_age_s, "wal_depth": frames,
                "wal_pending_bytes": nbytes}

    def checkpoint(self, batch, universe, *, wal_seq: Optional[int] = None, watermark=None,
                   parked=None, frontier=None, node_id: str = "") -> Snapshot:
        """One checkpoint: write the next generation, roll the WAL, drop the
        segments below the oldest retained generation's sequence (not this
        one's: if this one turns out torn, recovery falls back a generation
        and needs that replay).  ``wal_seq`` is the bound the caller
        captured under its ingest lock (default: the head now, safe only
        without concurrent writers).  Returns the written
        :class:`Snapshot`; its ``split_s`` gains ``wal_roll_truncate``."""
        from ..cluster import faults as cluster_faults

        cluster_faults.crash_point("durable.checkpoint")
        if wal_seq is None:
            wal_seq = self.wal.head_seq
        snap = self.store.write(batch, universe, wal_seq=wal_seq, watermark=watermark,
                                parked=parked, frontier=frontier, node_id=node_id)
        t = time.perf_counter()
        self.wal.roll()
        self.wal.truncate_below(self.store.wal_floor())
        snap.split_s["wal_roll_truncate"] = time.perf_counter() - t
        self.snapshots_written += 1
        self.last_snapshot = dataclasses.replace(snap, batch=None)
        self._last_snapshot_monotonic = time.monotonic()
        return snap

    def close(self) -> None:
        self.wal.close()
