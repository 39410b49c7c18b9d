"""The cluster node and its gossip scheduler (the port of the JAX
package's ``cluster/gossip.py``, less the mesh's shard-subset repair).

:class:`ClusterNode` owns one replica's fleet batch: sessions it
initiates (:meth:`~ClusterNode.sync_with`) or accepts
(:meth:`~ClusterNode.accept`) run one at a time under its busy lock,
live writes enter through :meth:`~ClusterNode.submit_ops` and fold at
once or, mid-session, when the session ends (and ride the session's op
piggyback meanwhile), and reads run outside the lock against a batch
snapshot (:meth:`~ClusterNode.serve_reads`).  A durable node
(``durability=``, a :class:`~crdt_tpu_torch.durable.Durability`) appends
every ingested op batch to its WAL before the fold and checkpoints at
round end (:meth:`~ClusterNode.checkpoint`).

:class:`GossipScheduler` picks the peers of each round: never-synced
peers first, then by seconds since the last converged sync, ties toward
the one that diverged most (:meth:`~crdt_tpu_torch.obs.convergence.
ConvergenceTracker.urgency`); dead peers only every ``probe_dead_every``
rounds.  It runs up to ``fanout`` sessions at once, never two on one
endpoint, then refreshes the node's capacity, heat and stability planes,
runs GC when due, and then the node's checkpoint when due.  The JAX
package's ``cluster.*`` counters are :meth:`GossipScheduler.counts`, and
its ``cluster.gossip.*`` gauges the ``health`` dict of each
:class:`RoundReport`.

Each node has its own metrics registry (:attr:`ClusterNode.registry`):
at every read (a scrape of its exporter, a capture of its fleet
observatory) the node's counts, its trackers', its links' and its
scheduler's are published into it under the JAX package's names
(:mod:`~crdt_tpu_torch.obs.publish`).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..dtypes import as_counters, counters_to_numpy
from ..error import PeerUnavailableError, SyncProtocolError, TransportError
from ..obs import convergence as obs_convergence
from ..obs import events as obs_events
from ..obs import publish as obs_publish
from ..obs.metrics import Histogram, MetricsRegistry
from ..sync.session import SyncReport, SyncSession
from . import faults as faults_mod
from . import membership as membership_mod
from .transport import Transport

#: a dialer: PeerInfo -> connected Transport (PeerUnavailableError when
#: the peer cannot be reached)
Dialer = Callable[[membership_mod.PeerInfo], Transport]


def hello_dial(transport: Transport, node_id: str) -> None:
    """The initiator's half of the one-frame identity handshake: our node
    id, so that the acceptor labels its session with who dialed."""
    transport.send(node_id.encode("utf-8"))


def hello_accept(transport: Transport, timeout: Optional[float] = None) -> str:
    """The acceptor's half: the dialer's node id, decoded defensively (the
    session's own frames are what reject a broken peer)."""
    raw = transport.recv(timeout)
    return raw.decode("utf-8", errors="replace")[:64] or "peer"


class ClusterNode:
    """One replica's identity and fleet batch, with session serialization.

    Every session runs under the busy lock, so two sessions never
    read-modify-write the batch at once; the converged batch replaces the
    old one under the state lock.  A session that cannot start within
    ``busy_timeout_s`` raises :class:`~crdt_tpu_torch.error.
    PeerUnavailableError`: two nodes that dial each other at once degrade
    to one retried session, not a deadlock.  The lag, stability and heat
    trackers are private per node by default (the heat sketch on the
    batch's device); ``observatory`` is passed through to every session.
    ``registry`` is the :class:`~crdt_tpu_torch.obs.metrics.
    MetricsRegistry` the node publishes into at read time (a new one by
    default; pass the one its fleet observatory and exporter read).
    """

    def __init__(self, node_id: str, batch, universe, *, full_state_threshold: float = 0.5,
                 busy_timeout_s: float = 10.0, observatory=None, oplog=None,
                 capacity_tracker=None, gc=None, digest_tree: bool = False, durability=None,
                 applier=None, lag_tracker=None, stability_tracker=None, heat_tracker=None,
                 registry=None):
        from ..obs import heat as obs_heat
        from ..obs import latency as obs_latency
        from ..obs import stability as obs_stability

        self.node_id = node_id
        self.universe = universe
        self.full_state_threshold = full_state_threshold
        self.busy_timeout_s = busy_timeout_s
        self.lag_tracker = lag_tracker if lag_tracker is not None else obs_latency.LagTracker()
        self.stability = stability_tracker if stability_tracker is not None \
            else obs_stability.StabilityTracker()
        self.heat = heat_tracker if heat_tracker is not None \
            else obs_heat.HeatTracker(device=obs_stability._device_of(batch))
        self.digest_tree = bool(digest_tree)
        self.capacity_tracker = capacity_tracker
        self.gc = gc
        self.durability = durability
        self.observatory = observatory
        self._oplog = oplog
        self._applier = applier
        self._lock = threading.Lock()    # guards batch + last reports
        self._busy = threading.Lock()    # serializes whole sessions
        self._mint = threading.Lock()    # serializes dot minting
        # makes each (WAL append, log append) pair atomic against the
        # checkpoint's wal_seq capture: every frame below the captured
        # sequence is then in the log by the drain (the replay bound)
        self._ingest = threading.Lock()
        self._batch = batch
        self._last_report: Optional[SyncReport] = None
        self._last_gc_report = None
        self._serve_loop = None          # built by the first serve_reads
        self.links = obs_publish.LinkTally()
        self.registry = registry if registry is not None else MetricsRegistry()
        # a weak reference: the registry must not keep the node's fleet alive
        self.registry.add_source(obs_publish.node_source(weakref.ref(self)))

    @property
    def batch(self):
        with self._lock:
            return self._batch

    @property
    def last_report(self) -> Optional[SyncReport]:
        """The most recent converged session's report."""
        with self._lock:
            return self._last_report

    def digest(self) -> np.ndarray:
        """The canonical digest vector of the current fleet (``uint64[N]``),
        the convergence oracle compared across nodes."""
        from ..sync import digest as digest_mod

        return np.asarray(digest_mod.digest_of(self.batch, self.universe), dtype="u8")

    # -- the op-based write front-end -----------------------------------------------

    def _ensure_oplog(self):
        from ..oplog import OpApplier, OpLog

        # a benign create race: the assignments are idempotent
        if self._oplog is None:
            self._oplog = OpLog(self.universe)
        if self._applier is None:
            self._applier = OpApplier(self.universe)
        return self._oplog

    def submit_ops(self, ops) -> int:
        """Ingest live writes: an :class:`~crdt_tpu_torch.oplog.OpBatch` or
        an encoded op frame.  Returns how many ops are still pending (0:
        folded at once).  Never blocks on a running session; raises
        :class:`~crdt_tpu_torch.error.OpLogOverflowError` when the log
        fills faster than sessions drain it."""
        from ..oplog.records import OpBatch
        from ..oplog.wire import decode_ops_frame

        if isinstance(ops, (bytes, bytearray, memoryview)):
            ops = decode_ops_frame(bytes(ops), num_actors=self.universe.config.num_actors)
        if not isinstance(ops, OpBatch):
            raise TypeError(f"submit_ops wants an OpBatch or an encoded op frame, got "
                            f"{type(ops).__name__}")
        self._log_append(ops, ops)
        # write-to-visible lag starts here
        self.lag_tracker.record_ingest_batch(ops)
        self.try_drain()
        return len(self._oplog)

    def _log_append(self, ops, wal) -> None:
        """Queue ``ops`` in the op log; a durable node first appends ``wal``
        (the ops, or their frame's bytes) to its WAL, the pair atomic
        against the checkpoint's ``wal_seq`` capture.  A crash (or an
        overflow raise) after the append may replay ops the caller saw
        rejected; the batched apply dedups them."""
        log = self._ensure_oplog()
        if self.durability is None or not len(ops):
            log.append(ops)
            return
        with self._ingest:
            self.durability.wal_append(wal)
            log.append(ops)

    def write_clock(self) -> torch.Tensor:
        """The node's write view of the fleet clock: the batch clock joined
        with the dot of every op still queued in the log or parked in the
        applier, as a biased ``[N, A]`` tensor where the planes live (do
        not write it: with nothing pending it is the batch's own plane).
        The safe base for ``derive_add_ctx`` against a live node: deriving
        from the bare batch clock while writes are queued would mint their
        dots again."""
        from ..oplog.apply import _scatter_max
        from ..oplog.records import _DOTTED

        with self._lock:
            batch = self._batch
        clock = batch.clock
        pending = []
        if self._oplog is not None:
            pending.append(self._oplog.pending())
        if self._applier is not None and len(self._applier.parked):
            pending.append(self._applier.parked)
        for ops in pending:
            dotted = np.isin(ops.kind, _DOTTED)
            if dotted.any():
                lin = ops.obj[dotted] * clock.shape[1] + ops.actor[dotted]
                clock = _scatter_max(clock, torch.from_numpy(lin).to(clock.device),
                                     as_counters(ops.counter[dotted], clock.dtype, clock.device))
        return clock

    def submit_writes(self, obj, member, *, actor) -> int:
        """Mint dots for these adds against :meth:`write_clock` and
        :meth:`submit_ops` them, atomically against other minters.
        ``actor`` is the writer's dense actor index (scalar or per write).
        Returns the pending count."""
        from ..oplog.records import derive_add_ctx

        obj = np.asarray(obj, np.int64)
        actor = np.broadcast_to(np.asarray(actor, np.int32), obj.shape).copy()
        self._ensure_oplog()
        with self._mint:
            ops, _ = derive_add_ctx(self.write_clock(), obj, actor, member=member)
            return self.submit_ops(ops)

    def write_vv(self) -> np.ndarray:
        """The writer's ack version vector (``uint64[A]``): the pointwise
        max of :meth:`write_clock` over objects, the floor a
        read-your-writes request carries."""
        return counters_to_numpy(self.write_clock().amax(dim=0)).astype(np.uint64)

    def read_token(self) -> np.ndarray:
        """The node's current monotonic-reads token (the visible version
        vector)."""
        from ..serve.loop import visible_vv

        return visible_vv(self.batch)

    def try_drain(self) -> bool:
        """One non-blocking drain: fold pending ops if the busy lock is
        free, else return False at once."""
        if not self._busy.acquire(blocking=False):
            return False
        try:
            self._drain_ops_locked()
        finally:
            self._busy.release()
        return True

    def serve_reads(self, request):
        """Answer one :class:`~crdt_tpu_torch.serve.ReadRequest` under its
        consistency mode, outside the busy lock against a batch snapshot.
        Raises :class:`~crdt_tpu_torch.error.ConsistencyUnavailableError`
        on a terminal rejection."""
        return self.serve_loop().serve(request)

    def serve_loop(self):
        """The node's :class:`~crdt_tpu_torch.serve.loop.ServeLoop`, built
        at first use."""
        if self._serve_loop is None:
            from ..serve.loop import ServeLoop

            # a weak back-reference: a node <-> loop cycle would keep a
            # dropped node's fleet alive until the cyclic collector runs
            self._serve_loop = ServeLoop(weakref.proxy(self))
        return self._serve_loop

    def _drain_ops_locked(self) -> None:
        """Fold every queued op into the fleet; the caller holds ``_busy``,
        so the fold always sees the batch a concurrent session produced."""
        log = self._oplog
        if log is None:
            return
        parked = self._applier is not None and len(self._applier.parked)
        if len(log) == 0 and not parked:
            return
        # an empty drain still re-checks the parked ops: the session that
        # just ended may have brought the predecessor dots they wait for
        ops = log.drain()
        faults_mod.crash_point("oplog.fold")
        faults_mod.crash_point(f"oplog.fold.{self.node_id}")
        with self._lock:
            batch = self._batch
        clock = getattr(batch, "clock", None)
        if len(ops) and clock is not None:
            self.heat.record_writes(ops.obj, int(clock.shape[0]))
        batch, report = self._applier.apply_ops(batch, ops)
        with self._lock:
            self._batch = batch
        obs_events.record("oplog.drain", node=self.node_id, ops=report.ops,
                          applied=report.applied, duplicates=report.duplicates,
                          parked=report.still_parked)
        if report.applied and clock is not None:
            # peer writes that arrived by the op piggyback are visible now
            self.lag_tracker.observe_visibility(
                counters_to_numpy(batch.clock.amax(dim=0)).astype(np.uint64))

    def _op_outbox(self) -> bytes:
        """The session's piggyback source: everything queued while it ran
        (a copy; the local drain still folds it)."""
        from ..oplog.wire import encode_ops_frame

        return encode_ops_frame(self._oplog.pending())

    def _op_sink(self, frame: bytes) -> None:
        """The session's piggyback sink: peer ops queue like any other
        write and fold at the session's tail drain, WAL'd first on a
        durable node (the frame's bytes verbatim: the wire codec is the
        WAL's)."""
        from ..oplog.wire import decode_ops_frame

        frame = bytes(frame)
        self._log_append(decode_ops_frame(frame, num_actors=self.universe.config.num_actors),
                         frame)

    def _run_session(self, peer_label: str, transport: Transport) -> SyncReport:
        if not self._busy.acquire(timeout=self.busy_timeout_s):
            raise PeerUnavailableError(
                f"node {self.node_id}: busy with another session for "
                f">{self.busy_timeout_s:.1f}s, refusing session with {peer_label}")
        faults_mod.crash_point("cluster.session")
        faults_mod.crash_point(f"cluster.session.{self.node_id}")
        self.links.watch(transport)
        try:
            op_hooks = {}
            if self._oplog is not None:
                self._ensure_oplog()
                op_hooks = {"op_outbox": self._op_outbox, "op_sink": self._op_sink}
            session = SyncSession(
                self.batch, self.universe, peer=peer_label,
                full_state_threshold=self.full_state_threshold, observatory=self.observatory,
                digest_tree=self.digest_tree, lag_tracker=self.lag_tracker,
                stability=self.stability, heat=self.heat, **op_hooks)
            report = session.sync(transport)
            with self._lock:
                self._batch = session.batch
                self._last_report = report
            return report
        finally:
            try:
                # fold writes queued while the session ran, before the next
                # session's snapshot
                self._drain_ops_locked()
            finally:
                self._busy.release()

    @property
    def last_gc_report(self):
        """The most recent collection pass's :class:`~crdt_tpu_torch.gc.
        GcReport` (None until GC has run)."""
        with self._lock:
            return self._last_gc_report

    def collect_garbage(self, peers=None):
        """One causal-GC pass on the batch and the op buffers; None when no
        engine is configured or a session holds the busy lock (it retries
        next round).  ``peers`` is the roster the watermark accounts for."""
        if self.gc is None or not self._busy.acquire(blocking=False):
            return None
        try:
            with self._lock:
                batch = self._batch
            batch, report = self.gc.collect(batch, universe=self.universe, oplog=self._oplog,
                                            applier=self._applier, peers=peers)
            with self._lock:
                self._batch = batch
                self._last_gc_report = report
            return report
        finally:
            self._busy.release()

    @property
    def last_snapshot(self):
        """The newest checkpoint's :class:`~crdt_tpu_torch.durable.Snapshot`
        (without its planes; None until one ran)."""
        return self.durability.last_snapshot if self.durability is not None else None

    def checkpoint(self):
        """One durability checkpoint: capture the WAL's replay bound under
        the ingest lock, fold the pending ops, then snapshot the planes,
        the parked ops, the GC watermark and the stability frontier.
        Returns the :class:`~crdt_tpu_torch.durable.Snapshot` (its
        ``split_s`` with the ``drain`` seconds), or None without a
        durability manager or when a session holds the busy lock (it
        retries next round, as GC does)."""
        if self.durability is None or not self._busy.acquire(blocking=False):
            return None
        try:
            # capture before the drain: every frame below the sequence has
            # made its log append, so the drain folds it into the snapshot;
            # frames at or above it replay on recovery
            t = time.perf_counter()
            with self._ingest:
                wal_seq = self.durability.wal.head_seq
            self._drain_ops_locked()
            drain_s = time.perf_counter() - t
            with self._lock:
                batch = self._batch
                gc_report = self._last_gc_report
            parked = self._applier.parked if self._applier is not None \
                and len(self._applier.parked) else None
            watermark = gc_report.watermark.clock if gc_report is not None \
                and gc_report.watermark is not None else None
            frontier = self.stability.frontier_clock() if self.stability is not None else None
            faults_mod.crash_point(f"durable.checkpoint.{self.node_id}")
            snap = self.durability.checkpoint(batch, self.universe, wal_seq=wal_seq,
                                              watermark=watermark, parked=parked,
                                              frontier=frontier, node_id=self.node_id)
            snap.split_s["drain"] = drain_s
            return snap
        finally:
            self._busy.release()

    def observe_stability(self, peers=None):
        """Recompute the fleet frontier against ``peers`` (the whole roster,
        dead peers too) and run the sampled lattice auditor on its
        cadence, on a batch snapshot.  Returns the
        :class:`~crdt_tpu_torch.obs.stability.FrontierReport` (None for
        clockless batch types)."""
        if self.stability is None:
            return None
        with self._lock:
            batch = self._batch
        try:
            report = self.stability.frontier(batch, peers=peers)
        except TypeError:
            return None  # no clock plane for this batch type
        self.stability.maybe_audit(batch, self.universe, peers=peers)
        return report

    def sample_capacity(self) -> list:
        """Sample the dense planes and the op buffers into the capacity
        tracker (the node's, or the process-global one), and the card's
        allocator beside them.  Returns the occupancies sampled."""
        from ..obs import capacity as obs_capacity
        from ..obs.stability import _device_of

        trk = self.capacity_tracker if self.capacity_tracker is not None \
            else obs_capacity.capacity_tracker()
        batch = self.batch
        occs = []
        try:
            occs.append(trk.sample(batch))
        except TypeError:
            pass  # no occupancy for this batch type
        if self._oplog is not None:
            occs.append(trk.sample_oplog(self._oplog))
        if self._applier is not None:
            occs.append(trk.sample_gap_buffer(self._applier))
        if _device_of(batch).type == "cuda":  # a CPU device has no allocator statistics
            trk.sample_device_memory()
        return occs

    def sync_with(self, peer_id: str, transport: Transport) -> SyncReport:
        """Run the initiator's leg of one session against ``peer_id``."""
        return self._run_session(peer_id, transport)

    def accept(self, transport: Transport, peer_id: str = "peer") -> SyncReport:
        """Run the acceptor's leg of a session a peer dialed (the protocol
        is symmetric: the same state machine)."""
        return self._run_session(peer_id, transport)

    def sync_shard_subset(self, peer: "ClusterNode", layout):
        """Repair only the diverged shards of a sharded fleet against an
        in-process peer (:func:`crdt_tpu_torch.mesh.sync.shard_subset_sync`
        over ``layout``, a :class:`~crdt_tpu_torch.mesh.MeshLayout`),
        pulling those shards' diverged rows from the peer's batch.  Both
        busy locks are held, this node's first, each waited for at most
        its ``busy_timeout_s`` (then :class:`PeerUnavailableError`), so
        neither batch moves meanwhile.  The repaired rows feed this node's
        heat tracker.  Returns the :class:`~crdt_tpu_torch.mesh.
        ShardSyncStats`."""
        from ..mesh.sync import shard_subset_sync

        held = []
        try:
            for node, other in ((self, peer), (peer, self)):
                if not node._busy.acquire(timeout=node.busy_timeout_s):
                    raise PeerUnavailableError(
                        f"node {node.node_id}: busy with another session for "
                        f">{node.busy_timeout_s:.1f}s, refusing shard-subset sync with "
                        f"{other.node_id}")
                held.append(node._busy)
            merged, stats = shard_subset_sync(self.batch, peer.batch, layout, self.universe)
            with self._lock:
                self._batch = merged
            if stats.objects and self.heat is not None:
                self.heat.record_repair(stats.object_ids, layout.n)
            return stats
        finally:
            for lock in reversed(held):
                lock.release()


@dataclasses.dataclass
class RoundReport:
    """One gossip round's outcome per peer id.  ``reports`` holds each
    successful session's :class:`~crdt_tpu_torch.sync.SyncReport`;
    ``health`` the round's view the JAX package publishes as gauges:
    ``attempted``, ``ok``, ``failed``, ``skipped_busy``,
    ``fleet_divergence_max`` and ``eta_rounds``."""

    round_no: int
    ranked: List[str] = dataclasses.field(default_factory=list)
    ok: List[str] = dataclasses.field(default_factory=list)
    failed: Dict[str, str] = dataclasses.field(default_factory=dict)
    skipped_busy: List[str] = dataclasses.field(default_factory=list)
    reports: Dict[str, SyncReport] = dataclasses.field(default_factory=dict)
    health: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return len(self.ok) + len(self.failed)


class GossipScheduler:
    """Staleness-driven peer selection and concurrent session fan-out.

    ``dialer`` turns a :class:`~crdt_tpu_torch.cluster.membership.PeerInfo`
    into a connected transport (it owns transport policy, the scheduler
    owns peer policy); ``fanout`` bounds the sessions of a round; ``seed``
    jitters the interval of the background loop.  Drive it with
    :meth:`run_round`, or as a thread with :meth:`start`/:meth:`stop`."""

    def __init__(self, node: ClusterNode, membership: membership_mod.Membership,
                 dialer: Dialer, *, fanout: int = 2, interval_s: float = 1.0,
                 probe_dead_every: int = 4, session_timeout_s: float = 120.0, seed: int = 0,
                 tracker: Optional[obs_convergence.ConvergenceTracker] = None):
        if fanout < 1:
            raise ValueError(f"fanout {fanout} < 1")
        self.node = node
        self.membership = membership
        self.dialer = dialer
        self.fanout = fanout
        self.interval_s = interval_s
        self.probe_dead_every = max(1, probe_dead_every)
        self.session_timeout_s = session_timeout_s
        self._tracker = tracker or obs_convergence.tracker()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._peer_locks: Dict[str, threading.Lock] = {}
        self._round_no = 0
        self._counts = dict.fromkeys(("rounds", "sessions_ok", "sessions_failed",
                                      "sessions_skipped_busy"), 0)
        self._round_walls = Histogram()
        self._last_health: Optional[Dict[str, int]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        node.registry.add_source(obs_publish.scheduler_source(weakref.ref(self)))

    def counts(self) -> dict:
        """Rounds run, and sessions that succeeded, failed and were skipped
        because their endpoint was busy."""
        with self._lock:
            return dict(self._counts)

    def round_walls(self) -> Histogram:
        """The rounds' wall seconds (log2 buckets)."""
        with self._lock:
            return self._round_walls.copy()

    def last_health(self) -> Optional[Dict[str, int]]:
        """The last round's ``health`` (None before a round)."""
        with self._lock:
            return None if self._last_health is None else dict(self._last_health)

    def _tally(self, key: str) -> None:
        with self._lock:
            self._counts[key] += 1

    # -- peer selection ---------------------------------------------------------------

    def _endpoint_lock(self, peer_id: str) -> threading.Lock:
        with self._lock:
            lk = self._peer_locks.get(peer_id)
            if lk is None:
                lk = self._peer_locks[peer_id] = threading.Lock()
            return lk

    def rank_peers(self, round_no: int = 0) -> List[membership_mod.PeerInfo]:
        """The round's candidates, most in need first: alive and suspect
        peers always, dead ones on probe rounds (every
        ``probe_dead_every``-th)."""
        states = [membership_mod.ALIVE, membership_mod.SUSPECT]
        if round_no % self.probe_dead_every == 0:
            states.append(membership_mod.DEAD)
        return sorted(self.membership.peers(*states),
                      key=lambda p: self._tracker.urgency(p.peer_id), reverse=True)

    # -- one round --------------------------------------------------------------------

    def _session_leg(self, peer: membership_mod.PeerInfo, lock: threading.Lock,
                     report: RoundReport, results_lock: threading.Lock) -> None:
        try:
            try:
                transport = self.dialer(peer)
                try:
                    rep = self.node.sync_with(peer.peer_id, transport)
                finally:
                    transport.close()
            except (SyncProtocolError, TransportError) as e:
                self._tally("sessions_failed")
                self.membership.record_failure(peer.peer_id)
                obs_events.record("cluster.session", peer=peer.peer_id, outcome="failed",
                                  error=f"{type(e).__name__}: {e}"[:200])
                with results_lock:
                    report.failed[peer.peer_id] = type(e).__name__
            else:
                self._tally("sessions_ok")
                self.membership.record_success(peer.peer_id)
                obs_events.record("cluster.session", peer=peer.peer_id, outcome="ok")
                with results_lock:
                    report.ok.append(peer.peer_id)
                    report.reports[peer.peer_id] = rep
        finally:
            lock.release()

    def run_round(self) -> RoundReport:
        """Rank, pick ``fanout`` peers, run their sessions concurrently and
        record the outcomes; returns when every leg finished or the join
        deadline passed."""
        with self._lock:
            self._round_no += 1
            round_no = self._round_no
            self._counts["rounds"] += 1
        report = RoundReport(round_no=round_no)
        results_lock = threading.Lock()
        round_t0 = time.monotonic()
        ranked = self.rank_peers(round_no)
        report.ranked = [p.peer_id for p in ranked]
        legs: List[threading.Thread] = []
        for peer in ranked:
            if len(legs) >= self.fanout:
                break
            lk = self._endpoint_lock(peer.peer_id)
            if not lk.acquire(blocking=False):
                self._tally("sessions_skipped_busy")
                report.skipped_busy.append(peer.peer_id)
                continue
            t = threading.Thread(target=self._session_leg, args=(peer, lk, report, results_lock),
                                 name=f"gossip-{self.node.node_id}-{peer.peer_id}", daemon=True)
            legs.append(t)
            t.start()
        deadline = time.monotonic() + self.session_timeout_s
        for t in legs:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        obs_events.record("cluster.round", node=self.node.node_id, round=round_no,
                          ok=list(report.ok), failed=dict(report.failed),
                          skipped_busy=list(report.skipped_busy))
        report.health = self._round_health(report)
        self.node.lag_tracker.observe_round(converged=not report.failed,
                                            wall_s=time.monotonic() - round_t0)
        # the post-round state: occupancy, heat rates, then the frontier and
        # the auditor against the whole roster (dead peers too: quarantine,
        # not membership, decides exclusion), then GC when due
        self.node.sample_capacity()
        self.node.heat.publish()
        roster = [p.peer_id for p in self.membership.peers(
            membership_mod.ALIVE, membership_mod.SUSPECT, membership_mod.DEAD)]
        self.node.observe_stability(peers=roster)
        if self.node.gc is not None and self.node.gc.due(round_no):
            if self.node.collect_garbage(peers=roster) is not None:
                self.node.sample_capacity()
        # the checkpoint after GC, so it holds the settled planes and the
        # newest watermark; a session racing in defers it a round (the WAL
        # holds every write meanwhile)
        if self.node.durability is not None and self.node.durability.due(round_no):
            self.node.checkpoint()
        with self._lock:
            self._last_health = dict(report.health)
            self._round_walls.observe(time.monotonic() - round_t0)
        return report

    def _round_health(self, report: RoundReport) -> Dict[str, int]:
        """Peers attempted, ok, failed and skipped this round, the largest
        divergence still outstanding, and the rounds to converge at this
        fanout (0 once every peer's last digest exchange was clean)."""
        divergences = [0 if st.get("divergence_resolved", True) else st.get("divergence", 0)
                       for st in self._tracker.snapshot().values()]
        diverged_peers = sum(1 for d in divergences if d > 0)
        return {"attempted": report.attempted, "ok": len(report.ok),
                "failed": len(report.failed), "skipped_busy": len(report.skipped_busy),
                "fleet_divergence_max": max(divergences, default=0),
                "eta_rounds": -(-diverged_peers // self.fanout) if diverged_peers else 0}

    # -- the background loop ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.run_round()
            # jittered pause, so a fleet of schedulers does not phase-lock
            self._stop.wait(timeout=self.interval_s * (0.5 + self._rng.random()))

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name=f"gossip-{self.node.node_id}",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None
