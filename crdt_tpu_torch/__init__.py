"""crdt_tpu_torch — dense CRDT batches on PyTorch and CUDA.

A second package beside the JAX reference (``crdt_tpu``): dense ORSWOT
batches held on a CUDA device, the pairwise merge and the anti-entropy
folds; the flat types (``VClockBatch``, ``GCounterBatch``,
``PNCounterBatch``, ``GSetBatch``, ``LWWRegBatch``, ``MVRegBatch``) with
their wire legs and the counter and LWW op folds, as torch ops;
``MapBatch`` over value kernels (``MVRegKernel``, ``OrswotKernel``, a
nested ``MapKernel``), its nested sets merged by the merge kernel; hand-written CUDA kernels for the three hot paths (``csrc/``),
the wire leg — ``OrswotBatch.from_wire``/``to_wire`` through a host
C++ codec (``native/``) and :class:`PipelinedWireLoop`, which folds wire
blobs on the card — and the op path (``oplog/``, :class:`PipelinedOpLoop`):
op frames folded into the planes on the card; delta anti-entropy
(``sync/``: digests, digest trees, delta frames, :class:`OrswotDeltaApplier`
merging the diverged rows through the merge kernel, and :class:`SyncSession`
and :func:`sync_pair`, which run the protocol between two replicas), the
transports a session runs over, the peer roster and the gossiping node
(``cluster/``: :class:`TcpTransport`, the ARQ :class:`ResilientTransport`,
seeded fault injection, :class:`Membership`, :class:`ClusterNode` and
:class:`GossipScheduler`), durability (``durable/``: the snapshot
store, the write-ahead log, :func:`~crdt_tpu_torch.durable.recover` and
the ``Durability`` policy a node takes; ``utils/checkpoint.py`` writes
the JAX package's checkpoint bytes) and causal GC
(``gc/``: the fleet watermark, settle, repack, truncate, :class:`GcEngine`);
the read front-end (``serve/``: :func:`gather` and :class:`QueryEngine`,
``ReadCtx`` rows for every kind, consistency admission, the read frames
and the :class:`ServeLoop` a node answers them through) and its
observatories (``obs/``: :class:`StabilityTracker`, :class:`HeatTracker`,
:class:`CapacityTracker`, :func:`kernel_observatory`).
The scalar engine (``scalar/``) and the serde codec (``utils/serde.py``)
are the port's own copies.  Entry points take
``device=`` and default to ``"cuda"``; pass ``device="cpu"`` to run the
plain PyTorch versions.

Quick start::

    from crdt_tpu_torch import CrdtConfig, JoinExecutor, OrswotBatch, Universe

    uni = Universe.identity(CrdtConfig.gpu_default(num_actors=64, member_capacity=16))
    fleets = [OrswotBatch.from_numpy(*planes) for planes in replica_planes]
    joined = JoinExecutor().join_all(fleets)
    members = joined.value_sets(uni)

    # wire blobs in, fold on the card, wire blobs out
    res = PipelinedWireLoop(uni).run([[fleet.to_wire(uni) for fleet in fleets]])
    blobs = res["out_blobs"]

    # op frames in, folded into the fleet on the card
    from crdt_tpu_torch.oplog import derive_add_ctx, encode_ops_frame
    ops, _ = derive_add_ctx(fleet.clock, obj, actor, member=member)
    fleet, stats = PipelinedOpLoop(uni).run(fleet, [encode_ops_frame(ops)])

    # a read batch: ReadCtx rows of contains() probes and value() reads
    frame = gather(joined, obj, member=member)       # member -1: value()
    ctx = frame.read_ctx(0, uni)

    # reconcile two replicas: digests, the diverged rows both ways, verify
    a, b = SyncSession(replica_a, uni, peer="b"), SyncSession(replica_b, uni, peer="a")
    report_a, report_b = sync_pair(a, b)               # a.batch == b.batch

    # a node that takes writes and serves session-consistent reads
    node = ClusterNode("n0", replica, uni, digest_tree=True)
    node.submit_writes(obj, member, actor=1)
    frame = node.serve_reads(ReadRequest.reads(obj, member=member, mode="ryw",
                                               require=node.write_vv()))

    # or each side in its own process, over TCP with the ARQ
    report = SyncSession(replica, uni, peer="b").sync(ResilientTransport(TcpTransport(sock)))
"""

from .batch import (
    GCounterBatch, GSetBatch, LWWRegBatch, MapBatch, MapKernel, MVRegBatch, MVRegKernel,
    OrswotBatch, OrswotKernel, PipelinedOpLoop, PipelinedWireLoop, PNCounterBatch, VClockBatch,
)
from .cluster import ClusterNode, GossipScheduler, ResilientTransport, TcpTransport
from .config import CrdtConfig, MERGE_IMPLS
from .device import resolve_device
from .error import (
    CapacityOverflowError,
    CheckpointFormatError,
    ConflictingMarker,
    ConsistencyUnavailableError,
    CrdtError,
    DeviceUnavailableError,
    DurabilityError,
    KernelError,
    OpLogOverflowError,
    PeerUnavailableError,
    SyncProtocolError,
    SyncTimeoutError,
    TransportClosedError,
    TransportError,
    TransportFrameError,
    WireFormatError,
)
from .gc import FleetWatermark, GcEngine, GcPolicy, GcReport, WatermarkReport
from .obs import CapacityTracker, HeatTracker, StabilityTracker, kernel_observatory
from .parallel import JoinError, JoinExecutor, JoinStats, join_all
from .serve import QueryEngine, ReadRequest, ResultFrame, ServeLoop, gather
from .sync import (
    DigestTree, OrswotDeltaApplier, SyncReport, SyncSession, build_tree, digest_of,
    queue_transport, sync_pair, version_vector,
)
from .utils.interning import IdentityRegistry, Registry, Universe

__all__ = [
    "CapacityOverflowError",
    "CapacityTracker",
    "CheckpointFormatError",
    "ClusterNode",
    "ConflictingMarker",
    "ConsistencyUnavailableError",
    "CrdtConfig",
    "CrdtError",
    "DeviceUnavailableError",
    "DigestTree",
    "DurabilityError",
    "FleetWatermark",
    "GCounterBatch",
    "GcEngine",
    "GcPolicy",
    "GcReport",
    "GossipScheduler",
    "HeatTracker",
    "GSetBatch",
    "IdentityRegistry",
    "JoinError",
    "JoinExecutor",
    "JoinStats",
    "KernelError",
    "LWWRegBatch",
    "MERGE_IMPLS",
    "MapBatch",
    "MapKernel",
    "MVRegBatch",
    "MVRegKernel",
    "OpLogOverflowError",
    "OrswotBatch",
    "OrswotDeltaApplier",
    "OrswotKernel",
    "PeerUnavailableError",
    "PNCounterBatch",
    "PipelinedOpLoop",
    "PipelinedWireLoop",
    "QueryEngine",
    "ReadRequest",
    "Registry",
    "ResilientTransport",
    "ResultFrame",
    "ServeLoop",
    "StabilityTracker",
    "SyncProtocolError",
    "SyncReport",
    "SyncSession",
    "SyncTimeoutError",
    "TcpTransport",
    "TransportClosedError",
    "TransportError",
    "TransportFrameError",
    "Universe",
    "VClockBatch",
    "WatermarkReport",
    "WireFormatError",
    "build_tree",
    "digest_of",
    "gather",
    "join_all",
    "kernel_observatory",
    "queue_transport",
    "resolve_device",
    "sync_pair",
    "version_vector",
]
