"""SyncSession: the two-phase digest and delta anti-entropy protocol (the
port of the JAX package's ``sync/session.py``, protocol v4, byte for
byte).

One session reconciles one local fleet batch with one peer over an
ordered, reliable byte transport: a ``send(bytes)`` and ``recv() ->
bytes`` pair, or one object with ``send`` and ``recv`` (and, for the v4
streaming phases, ``window`` and ``negotiate_window``).  Both peers run
the same lock-step code, and every decision is a function of data both
sides already exchanged, so neither waits for a frame the other will not
send.

Phases::

    0. hello       one frame each way: trace proposals (both adopt the
                   min), the version spoken (both run at the min), the
                   capabilities (fleet snapshot, op piggyback, digest
                   tree, lag sidecar) and the ARQ window
    1. locate      the flat digest exchange (shipped eagerly with the
                   hello), or with ``digest_tree`` on both sides the
                   root comparison and subtree descent, lock-step or
                   (v4, window >= 2) speculative
    2. delta       only the diverged rows ship (chunked when streaming);
                   a FULL frame instead above ``full_state_threshold``
    3. verify      the canonical digests (or one root frame) again; a
                   mismatch retries with full state, which must converge
    4. piggybacks  fleet snapshot, op batch and lag sidecar, each only
                   when both hellos advertised it

The batch's planes stay where they live: digests come to the host as the
``uint64`` vectors frames carry, and the applier merges the diverged
rows with the merge kernel on a CUDA device (raising
:class:`~crdt_tpu_torch.error.KernelError` rather than falling back).
Each session writes its phase transitions to the flight recorder
(:mod:`~crdt_tpu_torch.obs.events`) under its session ID, feeds the
convergence, stability and heat trackers, and returns a
:class:`SyncReport` whose ``profile`` is its
:class:`~crdt_tpu_torch.obs.latency.SessionProfile`.  Counts the JAX
package keeps as counters are :func:`session_counts`.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Optional

import numpy as np

from ..dtypes import unbias_np
from ..error import SyncProtocolError, TransportError
from ..obs import convergence as obs_convergence
from ..obs import events as obs_events
from ..obs import heat as obs_heat
from ..obs import stability as obs_stability
from ..obs.latency import SessionProfile
from . import delta as delta_mod
from . import digest as digest_mod
from . import tree as tree_mod
from .delta import (
    BASELINE_VERSION, COMPAT_VERSIONS, DELTA_CHUNK_ROWS, FRAME_DELTA, FRAME_DELTA_CHUNK,
    FRAME_DIGEST, FRAME_FLEET, FRAME_FULL, FRAME_HELLO, FRAME_LAG, FRAME_OPS, FRAME_TREE,
    PROTOCOL_VERSION, OrswotDeltaApplier, decode_delta_chunk_payload, decode_delta_payload,
    decode_digest_payload, decode_fleet_payload, decode_frame, decode_full_payload,
    decode_hello_payload, decode_lag_payload, decode_ops_sync_payload, decode_tree_level_payload,
    decode_tree_root_payload, decode_tree_spec_payload, diverged_indices,
    encode_delta_chunk_frame, encode_delta_frame, encode_digest_frame, encode_fleet_frame,
    encode_full_frame, encode_hello_frame, encode_lag_frame, encode_ops_sync_frame,
    encode_tree_level_frame, encode_tree_root_frame, encode_tree_spec_frame, gather_blobs,
)

_COUNTS_LOCK = threading.Lock()
_COUNTS: dict = {}


def _tally(name: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def session_counts() -> dict:
    """Process-wide session counts: ``sessions``,
    ``errors``, ``digest_eager``, ``digest_collision``, ``tree_descents``,
    ``tree_fallback_{version,capability,cutover,collision}``,
    ``spec_blasts``, ``spec_hits``, ``spec_misses``, ``delta_chunked``,
    ``lag_fallback_capability`` and ``full_state_fallback_{requested,
    threshold,digest_collision}``."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


@dataclasses.dataclass
class SyncReport:
    """What one peer's side of a sync cost and concluded."""

    objects: int = 0
    diverged: int = 0              # rows phase 1 flagged
    converged: bool = False
    digest_rounds: int = 0         # digest (or root) exchanges
    full_state_fallback: bool = False
    delta_objects_sent: int = 0
    digest_bytes_sent: int = 0
    delta_bytes_sent: int = 0      # DELTA and DELTA_CHUNK frames
    full_bytes_sent: int = 0       # FULL frames
    hello_bytes_sent: int = 0
    fleet_bytes_sent: int = 0
    ops_bytes_sent: int = 0
    ops_sent: int = 0
    ops_received: int = 0
    bytes_received: int = 0
    trace_id: Optional[str] = None  # hello-negotiated, the same on both peers
    fleet_nodes: int = 0
    protocol_version: int = 0      # hello-negotiated
    tree_mode: bool = False
    tree_bytes_sent: int = 0
    tree_frames_sent: int = 0
    tree_levels: int = 0           # level (or spec) frames after the root
    subtrees_diverged: int = 0     # widest diverged internal frontier
    lag_bytes_sent: int = 0
    lag_entries_sent: int = 0
    lag_entries_received: int = 0
    streaming: bool = False        # v4 windowed streaming negotiated
    window: int = 0                # negotiated ARQ window (0: none)
    tree_round_trips: int = 0      # the root exchange, plus one per level or blast
    spec_hits: int = 0             # speculated blocks the walk used
    spec_misses: int = 0           # speculated blocks discarded
    delta_chunks_sent: int = 0
    profile: Optional[SessionProfile] = None

    @property
    def bytes_sent(self) -> int:
        return (self.digest_bytes_sent + self.delta_bytes_sent + self.full_bytes_sent
                + self.hello_bytes_sent + self.fleet_bytes_sent + self.ops_bytes_sent
                + self.tree_bytes_sent + self.lag_bytes_sent)

    def delta_ratio(self, full_state_bytes: int) -> Optional[float]:
        """Delta and full-state bytes shipped over a full-state exchange's
        bytes; None when that size is unknown."""
        if not full_state_bytes:
            return None
        return (self.delta_bytes_sent + self.full_bytes_sent) / full_state_bytes


_SENT_FIELD = {"digest": "digest_bytes_sent", "delta": "delta_bytes_sent",
               "hello": "hello_bytes_sent", "fleet": "fleet_bytes_sent",
               "tree": "tree_bytes_sent", "ops": "ops_bytes_sent", "lag": "lag_bytes_sent",
               "full": "full_bytes_sent"}


class SyncSession:
    """Reconcile ``batch`` with one peer; the converged fleet is
    ``session.batch`` after :meth:`sync` returns.

    ``full_state_threshold``: the diverged fraction above which phase 2
    ships full state.  ``full_state=True`` skips phase 1 and ships full
    state.  ``digest_fn`` overrides the phase-1 digest (and disables the
    tree); the verify always uses the canonical digest.  ``peer`` labels
    the tracker state, ``full_state_bytes`` is the reference of the
    tracked delta ratio.  ``observatory`` (``node_id``, ``encode()``,
    ``merge_frame()``), ``op_outbox``/``op_sink`` and ``lag_tracker``
    enable the piggybacks; ``capacity_tracker`` samples the converged
    batch; ``stability`` and ``heat`` default to the process-global
    trackers (heat: the one of the batch's device).
    ``protocol_version`` pins the version spoken."""

    def __init__(self, batch, universe, *, full_state_threshold: float = 0.5,
                 full_state: bool = False, digest_fn: Optional[Callable] = None,
                 peer: Optional[str] = None, full_state_bytes: Optional[int] = None,
                 observatory=None, op_outbox: Optional[Callable[[], bytes]] = None,
                 op_sink: Optional[Callable[[bytes], None]] = None, capacity_tracker=None,
                 digest_tree: bool = False, protocol_version: Optional[int] = None,
                 lag_tracker=None, stability=None, heat=None):
        if not 0.0 <= full_state_threshold <= 1.0:
            raise ValueError(f"full_state_threshold {full_state_threshold} not in [0, 1]")
        if protocol_version is not None and protocol_version not in COMPAT_VERSIONS:
            raise ValueError(f"protocol_version {protocol_version} not in "
                             f"{sorted(COMPAT_VERSIONS)}")
        self.batch = batch
        self.universe = universe
        self.full_state_threshold = full_state_threshold
        self.full_state = full_state
        self.peer = peer or "peer"
        self.full_state_bytes = full_state_bytes
        self.session_id = obs_events.new_session_id()
        self.trace_id: Optional[str] = None
        self.observatory = observatory
        self._op_outbox = op_outbox
        self._op_sink = op_sink
        self.capacity_tracker = capacity_tracker
        self.digest_tree = bool(digest_tree) and digest_fn is None
        self.speaks_version = PROTOCOL_VERSION if protocol_version is None \
            else int(protocol_version)
        if self.speaks_version < 3:
            self.digest_tree = False
        self.negotiated_version: Optional[int] = None
        self.lag_tracker = lag_tracker
        self.stability = stability
        self.heat = heat
        self._peer_fleet_obs = self._peer_oplog = False
        self._peer_digest_tree = self._peer_lag = False
        # a user digest only: a bound method of self stored on self would make
        # a reference cycle that keeps the session's fleet alive until the
        # cyclic collector runs
        self._user_digest_fn = digest_fn
        self._applier = OrswotDeltaApplier(universe)
        self._transport = None
        self._streaming = False
        self._eager_digest: Optional[np.ndarray] = None
        self._prof = SessionProfile()

    def _canonical_digest(self, batch) -> np.ndarray:
        return digest_mod.digest_of(batch, self.universe)

    def _plane(self):
        plane = next(iter(delta_mod._fields(self.batch).values()))
        while isinstance(plane, tuple):
            plane = plane[0]
        return plane

    def _n(self) -> int:
        return int(self._plane().shape[0])

    def _stability(self) -> obs_stability.StabilityTracker:
        return self.stability if self.stability is not None else obs_stability.tracker()

    def _heat(self) -> obs_heat.HeatTracker:
        return self.heat if self.heat is not None else obs_heat.tracker(self._plane().device)

    @property
    def _wire_version(self) -> int:
        return self.negotiated_version if self.negotiated_version is not None \
            else BASELINE_VERSION

    def _event(self, kind: str, **fields) -> None:
        if self.trace_id is not None and "trace" not in fields:
            fields["trace"] = self.trace_id
        obs_events.record(kind, session=self.session_id, peer=self.peer, **fields)

    # -- frame plumbing --------------------------------------------------------

    def _send(self, send, frame: bytes, report: SyncReport, leg: str) -> None:
        with self._prof.clock("network"):
            send(frame)
        self._prof.frames_sent += 1
        field = _SENT_FIELD[leg]
        setattr(report, field, getattr(report, field) + len(frame))
        if leg == "tree":
            report.tree_frames_sent += 1

    def _recv(self, recv, report: SyncReport) -> tuple[int, bytes]:
        try:
            with self._prof.clock("network"):
                frame = recv()
        except (ConnectionError, EOFError) as e:
            raise SyncProtocolError(f"peer closed the stream mid-session: {e}") from e
        if not isinstance(frame, (bytes, bytearray, memoryview)):
            raise SyncProtocolError(f"transport returned {type(frame).__name__}, not bytes")
        frame = bytes(frame)
        self._prof.frames_received += 1
        report.bytes_received += len(frame)
        with self._prof.clock("serialize"):
            return decode_frame(frame)

    def _expect(self, recv, report: SyncReport, ftype: int, what: str) -> bytes:
        got, payload = self._recv(recv, report)
        if got != ftype:
            raise SyncProtocolError(f"expected {what}, peer sent type {got:#04x}")
        return payload

    # -- phase helpers ---------------------------------------------------------

    def _digest_frame(self, digest_fn) -> tuple[np.ndarray, bytes]:
        with self._prof.clock("kernel"):
            mine = np.asarray(digest_fn(self.batch), dtype=np.uint64)
            vv = digest_mod.version_vector(self.batch)
        with self._prof.clock("serialize"):
            return mine, encode_digest_frame(mine, vv, version=self._wire_version)

    def _hello(self, send, recv, report: SyncReport) -> None:
        """Ship this side's hello (and, for a flat session, its phase-1
        digest at once: the first two frames are the same whatever the
        peer says), read the peer's and negotiate trace, version,
        capabilities and window."""
        node = self.observatory.node_id if self.observatory is not None \
            else f"proc-{obs_events._PROC_TAG}"
        proposal = self.session_id
        can_ops = self._op_outbox is not None and self._op_sink is not None
        advertised = int(self._transport.window) \
            if self._transport is not None and self.speaks_version >= 4 else 0
        self._send(send, encode_hello_frame(
            proposal, node, self.observatory is not None, oplog=can_ops,
            digest_tree=self.digest_tree, lag=self.lag_tracker is not None, window=advertised,
            ver=self.speaks_version), report, "hello")
        if not self.full_state and not self.digest_tree:
            mine, frame = self._digest_frame(self._user_digest_fn or self._canonical_digest)
            self._send(send, frame, report, "digest")
            self._eager_digest = mine
            _tally("digest_eager")
        ftype, payload = self._recv(recv, report)
        if ftype != FRAME_HELLO:
            raise SyncProtocolError(f"expected a hello frame, peer sent type {ftype:#04x} "
                                    "(pre-v2 peer?)")
        hello = decode_hello_payload(payload)
        self._peer_fleet_obs, self._peer_oplog = hello.fleet_obs, hello.oplog
        self._peer_digest_tree, self._peer_lag = hello.digest_tree, hello.lag
        self.negotiated_version = report.protocol_version = min(self.speaks_version, hello.ver)
        self.trace_id = report.trace_id = min(proposal, hello.trace)
        peer_window = hello.window if self.negotiated_version >= 4 else 0
        self._streaming = False
        window = 0
        if self._transport is not None:
            window = self._transport.negotiate_window(peer_window)
            self._streaming = self.negotiated_version >= 4 and advertised >= 2 \
                and peer_window >= 2
        report.streaming, report.window = self._streaming, window
        self._event("sync.hello", proposed=proposal, peer_node=hello.node,
                    peer_fleet_obs=self._peer_fleet_obs, peer_oplog=self._peer_oplog,
                    peer_digest_tree=self._peer_digest_tree, peer_lag=self._peer_lag,
                    negotiated_version=self.negotiated_version, peer_window=hello.window,
                    window=window, streaming=self._streaming)

    def _tree_session(self) -> bool:
        """Whether this session descends: both hellos' capability at a
        negotiated v3 or later; otherwise it says why and runs flat."""
        if not self.digest_tree:
            return False
        if self.negotiated_version is not None and self.negotiated_version < 3:
            _tally("tree_fallback_version")
            self._event("sync.tree_fallback", reason="version",
                        negotiated=self.negotiated_version)
            return False
        if not self._peer_digest_tree:
            _tally("tree_fallback_capability")
            self._event("sync.tree_fallback", reason="capability")
            return False
        return True

    def _fleet_exchange(self, send, recv, report: SyncReport) -> None:
        """Swap and merge fleet-observatory snapshots (both advertised)."""
        if self.observatory is None or not self._peer_fleet_obs:
            return
        with self._prof.clock("other"):
            mine = self.observatory.encode()
        self._send(send, encode_fleet_frame(mine, version=self._wire_version), report, "fleet")
        payload = self._expect(recv, report, FRAME_FLEET, "a fleet frame")
        with self._prof.clock("other"):
            merged = self.observatory.merge_frame(decode_fleet_payload(payload))
        report.fleet_nodes = len(merged.slices)
        self._event("sync.fleet_snapshot", nodes=report.fleet_nodes, bytes=len(mine))

    def _ops_exchange(self, send, recv, report: SyncReport) -> None:
        """Swap op batches (both advertised): an empty outbox still ships
        an empty op frame; the peer's goes to the sink."""
        if self._op_outbox is None or self._op_sink is None or not self._peer_oplog:
            return
        from ..oplog.records import OpBatch
        from ..oplog.wire import decode_ops_frame, encode_ops_frame, frame_op_count

        with self._prof.clock("other"):
            mine = self._op_outbox() or encode_ops_frame(OpBatch.empty())
            report.ops_sent = frame_op_count(mine)
        self._send(send, encode_ops_sync_frame(mine, version=self._wire_version), report, "ops")
        payload = self._expect(recv, report, FRAME_OPS, "an ops frame")
        with self._prof.clock("other"):
            theirs = decode_ops_sync_payload(payload)
            report.ops_received = len(decode_ops_frame(theirs))
            self._op_sink(theirs)
        if report.ops_sent or report.ops_received:
            self._event("sync.ops_piggyback", sent=report.ops_sent,
                        received=report.ops_received)

    def _lag_exchange(self, send, recv, report: SyncReport) -> None:
        """Swap lag sidecars (both advertised) and measure every peer
        write the converged batch's clock plane now witnesses."""
        if self.lag_tracker is None:
            return
        if not self._peer_lag:
            _tally("lag_fallback_capability")
            self._event("sync.lag_fallback", reason="capability")
            return
        with self._prof.clock("other"):
            entries = self.lag_tracker.export_entries()
            report.lag_entries_sent = len(entries)
            frame = encode_lag_frame(entries, self.lag_tracker.proc_tag,
                                     version=self._wire_version)
        self._send(send, frame, report, "lag")
        payload = self._expect(recv, report, FRAME_LAG, "a lag frame")
        with self._prof.clock("other"):
            proc, theirs = decode_lag_payload(payload)
            report.lag_entries_received = self.lag_tracker.ingest_sidecar(
                self.peer, theirs, origin_proc=proc)
            clock = getattr(self.batch, "clock", None)
            if clock is not None and clock.shape[0]:
                # the biased order is the unsigned one: one D2H of the max
                visible = unbias_np(clock.amax(dim=0).cpu().numpy())
                self.lag_tracker.observe_visibility(visible, peer=self.peer)
        if report.lag_entries_sent or report.lag_entries_received:
            self._event("sync.lag_sidecar", sent=report.lag_entries_sent,
                        received=report.lag_entries_received)

    def _exchange_digests(self, send, recv, report: SyncReport, digest_fn):
        eager, self._eager_digest = self._eager_digest, None
        if eager is not None:
            mine = eager  # phase 1 went out with the hello
        else:
            mine, frame = self._digest_frame(digest_fn)
            self._send(send, frame, report, "digest")
        payload = self._expect(recv, report, FRAME_DIGEST, "a digest frame")
        with self._prof.clock("serialize"):
            theirs, peer_vv = decode_digest_payload(payload)
        if peer_vv.size:
            obs_convergence.tracker().observe_version_vector(self.peer, peer_vv)
        report.digest_rounds += 1
        return mine, theirs

    # -- the digest-tree descent (v3) ------------------------------------------

    def _tree_root_exchange(self, send, recv, report: SyncReport):
        """Ship this side's root frame and check the peer's shape; returns
        ``(tree, peer_root, peer_children)``."""
        with self._prof.clock("kernel"):
            tree = digest_mod.digest_tree_of(self.batch, self.universe)
            vv = digest_mod.version_vector(self.batch)
        with self._prof.clock("serialize"):
            frame = encode_tree_root_frame(tree, vv, version=self._wire_version)
        self._send(send, frame, report, "tree")
        payload = self._expect(recv, report, FRAME_TREE, "a tree root frame")
        with self._prof.clock("serialize"):
            k, n, levels, root, children, peer_vv = decode_tree_root_payload(payload)
        if k != tree.k:
            raise SyncProtocolError(f"digest-tree fan-out mismatch: peer k={k}, local "
                                    f"k={tree.k}")
        if n != tree.n:
            raise SyncProtocolError(f"digest vector shape mismatch: peer fleet {n}, local "
                                    f"{tree.n} (peers must sync equal-sized fleets)")
        if levels != tree.num_levels:
            raise SyncProtocolError(f"digest-tree level mismatch: peer {levels}, local "
                                    f"{tree.num_levels}")
        expected = tree.level_size(tree.num_levels - 2) if tree.num_levels >= 2 else 0
        if children.shape[0] != expected:
            raise SyncProtocolError(f"tree root frame carries {children.shape[0]} children, "
                                    f"expected {expected}")
        if peer_vv.size:
            obs_convergence.tracker().observe_version_vector(self.peer, peer_vv)
        report.digest_rounds += 1
        return tree, root, children

    def _collided(self, level: int) -> None:
        _tally("tree_fallback_collision")
        self._event("sync.tree_fallback", reason="collision", level=level)

    def _cutover(self, level: int, subtrees: int) -> None:
        _tally("tree_fallback_cutover")
        self._event("sync.tree_fallback", reason="cutover", level=level, subtrees=subtrees)

    def _level_step(self, send, recv, report: SyncReport, tree, level: int, d: np.ndarray):
        """One lock-step level: ship the children of ``d`` (level
        ``level``), read the peer's, return the diverged children."""
        report.tree_levels += 1
        report.tree_round_trips += 1
        with self._prof.clock("kernel"):
            mine = tree.child_lanes(level - 1, d)
        with self._prof.clock("serialize"):
            frame = encode_tree_level_frame(level - 1, d, mine, version=self._wire_version)
        self._send(send, frame, report, "tree")
        payload = self._expect(recv, report, FRAME_TREE, "a tree level frame")
        with self._prof.clock("serialize"):
            plevel, pparents, planes = decode_tree_level_payload(payload)
        if plevel != level - 1 or not np.array_equal(pparents, d):
            raise SyncProtocolError(
                f"digest-tree descent out of lock-step: peer shipped level {plevel} "
                f"({pparents.shape[0]} parents), expected level {level - 1} "
                f"({d.shape[0]} parents)")
        with self._prof.clock("kernel"):
            return tree_mod.diverged_children(d, mine, planes, tree.level_size(level - 1))

    def _leaves(self, report: SyncReport, d: np.ndarray) -> Optional[np.ndarray]:
        if d.size == 0:
            self._collided(0)
            return None
        report.subtrees_diverged = max(report.subtrees_diverged, int(d.size))
        return np.sort(d).astype(np.int64)

    def _tree_locate_diverged(self, send, recv, report: SyncReport) -> Optional[np.ndarray]:
        """Phase 1 in tree mode: the diverged leaf ids (empty when the
        roots match), or None when both sides fall back to the flat
        exchange (the dense-divergence cutover, or a truncated-lane
        collision hiding every diverged child)."""
        _tally("tree_descents")
        tree, peer_root, peer_children = self._tree_root_exchange(send, recv, report)
        report.tree_mode = True
        report.tree_round_trips += 1
        if peer_root == tree.root:
            return np.zeros(0, dtype=np.int64)
        if tree.num_levels < 2:
            return np.arange(tree.n, dtype=np.int64)
        top = tree.num_levels - 2
        with self._prof.clock("kernel"):
            theirs_top = np.zeros(tree.k, dtype=np.uint32)
            theirs_top[:peer_children.shape[0]] = peer_children
            root = np.zeros(1, dtype=np.int64)
            d = tree_mod.diverged_children(root, tree.child_lanes(top, root), theirs_top,
                                           tree.level_size(top))
        # the cutover compares simulate_descent's cost with one flat frame
        flat_bytes = 8 * tree.n
        shipped = 8 + tree_mod.LANE_WIRE_BYTES * (tree_mod.root_frame_lanes(tree) - 1)
        if self._streaming and top > 0:
            return self._tree_descend_speculative(send, recv, report, tree, d, top,
                                                  flat_bytes, shipped)
        level = top
        while level > 0:
            if d.size == 0:
                self._collided(level)
                return None
            report.subtrees_diverged = max(report.subtrees_diverged, int(d.size))
            ship = d.size * tree.k * tree_mod.LANE_WIRE_BYTES + d.size * 8
            if shipped + ship > flat_bytes:
                self._cutover(level, int(d.size))
                return None
            shipped += ship
            d = self._level_step(send, recv, report, tree, level, d)
            level -= 1
        return self._leaves(report, d)

    def _tree_descend_speculative(self, send, recv, report: SyncReport, tree, d: np.ndarray,
                                  top: int, flat_bytes: int, shipped: int
                                  ) -> Optional[np.ndarray]:
        """The v4 streaming descent: ship SPEC frames for the k-ary
        expansion of the top diverged set down to the leaves (within the
        cutover budget) before reading any, then walk the peer's blast
        with the true frontier, discarding the blocks it does not need;
        lock-step levels finish what the budget cut short."""
        plan = []
        parents, level, budget = d, top, shipped
        while level > 0:
            ship = parents.size * tree.k * tree_mod.LANE_WIRE_BYTES + parents.size * 8
            if budget + ship > flat_bytes:
                break
            budget += ship
            plan.append((level - 1, parents))
            kids = (parents[:, None] * tree.k
                    + np.arange(tree.k, dtype=np.int64)[None, :]).reshape(-1)
            parents = kids[kids < tree.level_size(level - 1)]
            level -= 1
        if not plan:
            self._cutover(top, int(d.size))
            return None
        report.tree_round_trips += 1
        _tally("spec_blasts")
        for child_level, spec_parents in plan:
            with self._prof.clock("kernel"):
                lanes = tree.child_lanes(child_level, spec_parents)
            with self._prof.clock("serialize"):
                frame = encode_tree_spec_frame(child_level, spec_parents, lanes,
                                               version=self._wire_version)
            report.tree_levels += 1
            self._send(send, frame, report, "tree")
        collided_at: Optional[int] = None
        for child_level, spec_parents in plan:
            payload = self._expect(recv, report, FRAME_TREE, "a tree spec frame")
            with self._prof.clock("serialize"):
                plevel, pparents, planes = decode_tree_spec_payload(payload)
            if plevel != child_level or not np.array_equal(pparents, spec_parents):
                raise SyncProtocolError(
                    f"speculative descent out of lock-step: peer shipped spec level {plevel} "
                    f"({pparents.shape[0]} parents), expected level {child_level} "
                    f"({spec_parents.shape[0]} parents)")
            if collided_at is not None:
                # keep reading the peer's blast; every block is a discard
                report.spec_misses += int(spec_parents.size)
                _tally("spec_misses", int(spec_parents.size))
                continue
            pos = np.searchsorted(spec_parents, d)
            hits, misses = int(d.size), int(spec_parents.size) - int(d.size)
            report.spec_hits += hits
            report.spec_misses += misses
            _tally("spec_hits", hits)
            _tally("spec_misses", misses)
            theirs = planes.reshape(-1, tree.k)[pos].reshape(-1)
            with self._prof.clock("kernel"):
                mine = tree.child_lanes(child_level, d)
                d = tree_mod.diverged_children(d, mine, theirs, tree.level_size(child_level))
            if d.size == 0:
                collided_at = child_level
            else:
                report.subtrees_diverged = max(report.subtrees_diverged, int(d.size))
        if collided_at is not None:
            self._collided(collided_at)
            return None
        level = plan[-1][0]
        while level > 0:
            if d.size == 0:
                self._collided(level)
                return None
            d = self._level_step(send, recv, report, tree, level, d)
            level -= 1
        return self._leaves(report, d)

    def _tree_converged_check(self, send, recv, report: SyncReport) -> bool:
        """The tree-mode verify: one root frame each way."""
        tree, peer_root, _ = self._tree_root_exchange(send, recv, report)
        return peer_root == tree.root

    # -- the delta and full-state legs -----------------------------------------

    def _apply_rows(self, ids: np.ndarray, blobs) -> None:
        with self._prof.clock("kernel"):
            self.batch = delta_mod.apply_delta_rows(self.batch, ids, blobs, self.universe,
                                                    applier=self._applier)
        self._heat().record_repair(ids, self._n())

    def _delta_exchange_streaming(self, send, recv, report: SyncReport,
                                  diverged: np.ndarray) -> None:
        """The v4 streaming delta: the shared diverged set in
        :data:`DELTA_CHUNK_ROWS`-row chunks, all shipped before the first
        peer chunk is read and applied."""
        n, rows = report.objects, DELTA_CHUNK_ROWS
        count = (diverged.size + rows - 1) // rows
        _tally("delta_chunked")
        for i in range(count):
            ids = diverged[i * rows:(i + 1) * rows]
            with self._prof.clock("serialize"):
                blobs = gather_blobs(self.batch, ids, self.universe)
                frame = encode_delta_chunk_frame(n, i, count, ids, blobs,
                                                 version=self._wire_version)
            report.delta_objects_sent += len(blobs)
            report.delta_chunks_sent += 1
            self._send(send, frame, report, "delta")
        for i in range(count):
            payload = self._expect(recv, report, FRAME_DELTA_CHUNK, "a delta chunk frame")
            with self._prof.clock("serialize"):
                fleet_n, idx, total, ids, blobs = decode_delta_chunk_payload(payload)
            if fleet_n != n:
                raise SyncProtocolError(f"peer fleet size {fleet_n} != local {n}")
            if idx != i or total != count \
                    or not np.array_equal(ids, diverged[i * rows:(i + 1) * rows]):
                raise SyncProtocolError(f"delta chunk stream out of lock-step: peer shipped "
                                        f"chunk {idx}/{total}, expected {i}/{count}")
            self._apply_rows(ids, blobs)

    def _send_full(self, send, report: SyncReport) -> None:
        with self._prof.clock("serialize"):
            frame = encode_full_frame(self.batch.to_wire(self.universe),
                                      version=self._wire_version)
        self._send(send, frame, report, "full")

    def _apply_frame(self, ftype: int, payload: bytes) -> None:
        n = self._n()
        if ftype == FRAME_FULL:
            with self._prof.clock("serialize"):
                blobs = decode_full_payload(payload)
            if len(blobs) != n:
                raise SyncProtocolError(f"peer full state carries {len(blobs)} objects, "
                                        f"local fleet holds {n}")
            with self._prof.clock("kernel"):
                peer = type(self.batch).from_wire(blobs, self.universe,
                                                  device=self._plane().device)
                self.batch = self.batch.merge(peer)
        elif ftype == FRAME_DELTA:
            with self._prof.clock("serialize"):
                fleet_n, ids, blobs = decode_delta_payload(payload)
            if fleet_n != n:
                raise SyncProtocolError(f"peer fleet size {fleet_n} != local {n}")
            self._apply_rows(ids, blobs)
        else:
            raise SyncProtocolError(f"expected a delta/full frame, peer sent type {ftype:#04x}")

    def _full_exchange(self, send, recv, report: SyncReport) -> None:
        self._send_full(send, report)
        self._apply_frame(*self._recv(recv, report))

    # -- the protocol ----------------------------------------------------------

    def sync(self, send, recv: Optional[Callable[[], bytes]] = None) -> SyncReport:
        """Run the session to convergence (or raise) and return its
        :class:`SyncReport`; the reconciled fleet is ``self.batch``.
        ``send`` is a send callable with ``recv``, or a transport object
        alone.  A :class:`SyncProtocolError` or :class:`TransportError`
        leaves a ``sync.error`` event before it propagates."""
        self._transport = None
        self._streaming = False
        self._eager_digest = None
        if recv is None:
            transport = send
            send, recv = transport.send, transport.recv
            if hasattr(transport, "negotiate_window"):
                self._transport = transport
        self._prof = SessionProfile()
        self._prof.start()
        try:
            report = self._sync(send, recv)
            self._fleet_exchange(send, recv, report)
            self._ops_exchange(send, recv, report)
            self._lag_exchange(send, recv, report)
        except (SyncProtocolError, TransportError) as e:
            _tally("errors")
            self._event("sync.error", error=str(e)[:200])
            raise
        finally:
            self._prof.finish()
        report.profile = self._prof
        obs_convergence.tracker().observe_session(
            self.peer, converged=report.converged, rounds=report.digest_rounds,
            payload_bytes=report.delta_bytes_sent + report.full_bytes_sent,
            full_state_bytes=self.full_state_bytes or report.full_bytes_sent)
        if report.converged and report.diverged == 0 and not report.full_state_fallback:
            # a clean phase 1: both digests covered committed state, so it
            # is frontier evidence; a session that shipped rows only
            # resolves the aging (its evidence comes with the next re-sync)
            self._stability().observe_converged(self.peer, self.batch)
        elif report.converged:
            self._stability().resolve_all(self.peer)
        self._event("sync.phase", phase="converged", rounds=report.digest_rounds,
                    diverged=report.diverged, full_state_fallback=report.full_state_fallback)
        if self.capacity_tracker is not None:
            try:
                self.capacity_tracker.sample(self.batch)
            except TypeError:
                pass  # no occupancy for this batch type
        return report

    def _fallback(self, report: SyncReport, reason: str) -> None:
        report.full_state_fallback = True
        _tally(f"full_state_fallback_{reason}")
        self._event("sync.full_state_fallback", reason=reason)

    def _verify_full(self, send, recv, report: SyncReport, failure: str) -> SyncReport:
        mine, theirs = self._exchange_digests(send, recv, report, self._canonical_digest)
        report.converged = bool(np.array_equal(mine, theirs))
        if not report.converged:
            raise SyncProtocolError(failure)
        return report

    def _sync(self, send, recv) -> SyncReport:
        report = SyncReport(objects=self._n())
        _tally("sessions")
        self._hello(send, recv, report)
        self._event("sync.phase", phase="start", objects=report.objects,
                    mode="full_state" if self.full_state else "delta")
        if self.full_state:
            self._fallback(report, "requested")
            self._full_exchange(send, recv, report)
            self._event("sync.phase", phase="converged_check")
            return self._verify_full(send, recv, report, (
                "full-state exchange did not converge (digest vectors still differ — mixed "
                "digest modes?)"))

        # phase 1: the descent when both hellos negotiated it, else flat
        tree_phase = self._tree_session()
        diverged: Optional[np.ndarray] = None
        if tree_phase:
            self._event("sync.phase", phase="tree_descent")
            diverged = self._tree_locate_diverged(send, recv, report)
            if diverged is None:
                tree_phase = False
        if diverged is None:
            self._event("sync.phase", phase="digest_exchange")
            mine, theirs = self._exchange_digests(send, recv, report,
                                                  self._user_digest_fn or self._canonical_digest)
            diverged = diverged_indices(mine, theirs)
        report.diverged = int(diverged.size)
        obs_convergence.tracker().observe_divergence(self.peer, report.diverged,
                                                     report.objects)
        self._stability().observe_descent(self.peer, diverged.tolist(), report.objects)
        if report.tree_mode:
            obs_convergence.tracker().observe_tree(self.peer, report.subtrees_diverged)
        if diverged.size == 0 and self._user_digest_fn is None:
            report.converged = True  # phase 1 was the canonical verify
            return report

        # phase 2: the delta (or threshold full-state) exchange
        if diverged.size:
            n = report.objects
            if n and diverged.size / n > self.full_state_threshold:
                self._fallback(report, "threshold")
                self._event("sync.phase", phase="full_state_exchange",
                            diverged=report.diverged)
                self._full_exchange(send, recv, report)
            elif self._streaming:
                self._event("sync.phase", phase="delta_exchange", diverged=report.diverged,
                            streaming=True)
                self._delta_exchange_streaming(send, recv, report, diverged)
            else:
                self._event("sync.phase", phase="delta_exchange", diverged=report.diverged)
                with self._prof.clock("serialize"):
                    blobs = gather_blobs(self.batch, diverged, self.universe)
                    frame = encode_delta_frame(n, diverged, blobs, version=self._wire_version)
                report.delta_objects_sent = len(blobs)
                self._send(send, frame, report, "delta")
                self._apply_frame(*self._recv(recv, report))

        # phase 3: the canonical verify; a mismatch retries with full state
        self._event("sync.phase", phase="converged_check")
        mismatched = -1
        if tree_phase:
            converged = self._tree_converged_check(send, recv, report)
        else:
            mine, theirs = self._exchange_digests(send, recv, report, self._canonical_digest)
            converged = bool(np.array_equal(mine, theirs))
            mismatched = int(np.count_nonzero(mine != theirs))
        if converged:
            report.converged = True
            return report
        _tally("digest_collision")
        self._event("sync.digest_collision", mismatched=mismatched)
        self._fallback(report, "digest_collision")
        self._event("sync.phase", phase="full_state_retry")
        self._full_exchange(send, recv, report)
        return self._verify_full(send, recv, report, (
            "sync did not converge after full-state retry (digest vectors still differ — "
            "peers disagree on state or digest mode)"))


def queue_transport():
    """Two paired in-process endpoints, ``((send_a, recv_a), (send_b,
    recv_b))``, over unbounded queues; run each session in its own
    thread."""
    a_to_b: queue.Queue = queue.Queue()
    b_to_a: queue.Queue = queue.Queue()
    return ((a_to_b.put, lambda: b_to_a.get(timeout=120)),
            (b_to_a.put, lambda: a_to_b.get(timeout=120)))


def sync_pair(session_a: SyncSession, session_b: SyncSession) -> tuple[SyncReport, SyncReport]:
    """Run two sessions against each other in this process (peer B on a
    thread of its own) and return both reports; an exception of either
    side propagates."""
    (send_a, recv_a), (send_b, recv_b) = queue_transport()
    results: dict = {}

    def run_b():
        try:
            results["b"] = session_b.sync(send_b, recv_b)
        except BaseException as e:  # re-raised in the caller's thread
            results["b_err"] = e

    t = threading.Thread(target=run_b, name="sync-peer-b", daemon=True)
    t.start()
    try:
        results["a"] = session_a.sync(send_a, recv_a)
    finally:
        t.join(timeout=120)
    if "b_err" in results:
        raise results["b_err"]
    if t.is_alive():
        raise SyncProtocolError("peer session deadlocked (thread alive)")
    return results["a"], results["b"]
