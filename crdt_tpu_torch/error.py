"""Error types of the port.

Own copies of the JAX package's ``CrdtError``, ``ConflictingMarker``,
``CapacityOverflowError``, ``WireFormatError``, ``OpLogOverflowError``,
``SyncProtocolError``, ``TransportError`` (with its four subclasses
``SyncTimeoutError``, ``PeerUnavailableError``, ``TransportClosedError``
and ``TransportFrameError``), ``ConsistencyUnavailableError``,
``DurabilityError`` (with ``CheckpointFormatError``) and
``raise_for_overflow`` (the port
imports nothing of that package), plus the errors that only a
GPU build has: a missing card, a kernel or the host codec that does not
build, a launch that the CUDA runtime refuses.
"""

from __future__ import annotations


class CrdtError(Exception):
    """Base class for all CRDT errors."""


class ConflictingMarker(CrdtError):
    """A conflicting change witnessed by a marker/dot that already exists.

    Reference: `error.rs:9-13` — "Dot's are used exactly once for the
    lifetime of a CRDT".
    """

    def __str__(self) -> str:
        base = "Dot's are used exactly once for the lifetime of a CRDT"
        return f"{base}: {self.args[0]}" if self.args else base


class WireFormatError(CrdtError, ValueError):
    """A wire blob violated the binary grammar or the static capacities
    of the receiving fleet (actor outside the identity registry, more
    members than ``member_capacity``, ...).  Subclasses ``ValueError``,
    as the scalar codec's decode errors are ``ValueError``."""


class CapacityOverflowError(CrdtError, ValueError):
    """A batched join outgrew its padded slot capacity.

    Carries which axis overflowed so elastic recovery
    (:class:`crdt_tpu_torch.parallel.JoinExecutor`) grows only that axis.
    """

    def __init__(self, message: str, member: bool = True, deferred: bool = True):
        super().__init__(message)
        self.member = member
        self.deferred = deferred


class OpLogOverflowError(CrdtError):
    """A bounded op-log structure ran out of room: the op log
    (:class:`crdt_tpu_torch.oplog.OpLog`) hit its capacity, or the
    causal-gap park buffer (:class:`crdt_tpu_torch.oplog.OpApplier`)
    filled with adds whose predecessors never arrived.  Not a
    ``ValueError``: the caller must drain or shed load; the op itself
    was well formed."""


class SyncProtocolError(CrdtError):
    """A frame's envelope violated the protocol: version, type, length
    or CRC (:mod:`crdt_tpu_torch.oplog.wire`).  Not a ``ValueError``: a
    malformed peer frame is an I/O-boundary fault to drop, not a local
    programming error."""


class TransportError(CrdtError):
    """A transport leg (send, recv, connect) failed below the sync
    protocol: the frames were fine, moving them was not.  A protocol
    error means the peer misbehaved; a transport error means the network
    did."""


class SyncTimeoutError(TransportError):
    """A transport leg blew its deadline: the peer, or the path to it,
    went quiet mid-session (a receive deadline elapsed, or a frame went
    unacked for its whole send deadline)."""


class PeerUnavailableError(TransportError):
    """The peer cannot be reached: dial refused, link closed on the
    receive path, or the transport's retry budget ran dry."""


class TransportClosedError(TransportError):
    """The underlying byte channel closed (the peer hung up, an injected
    disconnect, a send that timed out partway through a frame)."""


class TransportFrameError(TransportError):
    """An ARQ envelope was malformed: truncated header, length or CRC
    mismatch, unknown kind.  The receiver treats it as loss."""


class MeshContractError(CrdtError, TypeError):
    """A kernel was dispatched onto an object mesh its sharding contract
    forbids: a ``host_only`` or ``replicated`` kernel, a mesh size outside
    the contract's ladder, or a kernel with no contract row
    (:mod:`crdt_tpu_torch.mesh.contracts`).  A ``TypeError``: the caller
    passed a kernel of the wrong kind for the mesh."""

    def __init__(self, message: str, *, kernel: str = "", sclass: str = ""):
        super().__init__(message)
        self.kernel = kernel
        self.sclass = sclass


class ConsistencyUnavailableError(CrdtError):
    """A session-consistency admission could not be satisfied: a
    read-your-writes or monotonic read parked past its deadline without
    the node's visible clock covering its floor, or a frontier read
    reached a node with no stability frontier yet
    (:mod:`crdt_tpu_torch.serve.consistency`).  ``mode`` and ``reason``
    say which, so a client can retry or downgrade the mode."""

    def __init__(self, message: str, *, mode: str = "", reason: str = ""):
        super().__init__(message)
        self.mode = mode
        self.reason = reason


class DurabilityError(CrdtError):
    """The durable-replica layer (:mod:`crdt_tpu_torch.durable`) could not
    produce or restore persistent state: every retained snapshot
    generation rejected, a WAL directory in an impossible shape.  Not a
    ``ValueError``: an unrecoverable store needs an operator (restore a
    backup, rejoin as a fresh replica); one malformed payload is a
    :class:`CheckpointFormatError`."""


class CheckpointFormatError(DurabilityError, ValueError):
    """One checkpoint or snapshot payload violated its binary format: a
    torn or truncated container, a CRC mismatch, a version skew, or
    restored planes whose digest-tree root disagrees with the one
    recorded at save time.  Recovery takes it as "this generation is
    bad" and falls back, loudly.  Subclasses ``ValueError``, the
    checkpoint loader's contract for a corrupt payload."""


class DeviceUnavailableError(CrdtError, RuntimeError):
    """A CUDA device was asked for and none is present."""


class KernelError(CrdtError, RuntimeError):
    """A CUDA kernel or the host wire codec did not build, or a kernel's
    launch returned an error.

    Deterministic by nature: the join executor never requeues it as a
    transient failure."""


def raise_for_overflow(overflow, context: str) -> None:
    """Reduce an ORSWOT overflow bitmap (``bool[..., 2]``: member and
    deferred flags in the last axis) and raise
    :class:`CapacityOverflowError` naming the overflowed axes.  One host
    sync; no-op when nothing overflowed."""
    flags = overflow.reshape(-1, 2).any(dim=0).tolist()
    m_over, d_over = bool(flags[0]), bool(flags[1])
    if not (m_over or d_over):
        return
    axes = "/".join(
        name
        for name, hit in (("member_capacity", m_over), ("deferred_capacity", d_over))
        if hit
    )
    raise CapacityOverflowError(
        f"Orswot capacity overflow in {context}: raise {axes}",
        member=m_over,
        deferred=d_over,
    )
