"""The cluster layer (the port of the JAX package's ``cluster`` package):
frame transports and the ARQ that hardens them
(:mod:`~crdt_tpu_torch.cluster.transport`), seeded fault, crash and
torn-write injection (:mod:`~crdt_tpu_torch.cluster.faults`), peer health
(:mod:`~crdt_tpu_torch.cluster.membership`), and the cluster node with
its gossip scheduler (:mod:`~crdt_tpu_torch.cluster.gossip`).  Failures
speak the :class:`~crdt_tpu_torch.error.TransportError` taxonomy; counts
are plain fields."""

from .faults import (  # noqa: F401
    CrashPlan, CrashState, FaultPlan, FaultyTransport, FlappingDialer, InjectedCrash,
    LatencyTransport, TornWriter, arm_crashes, crash_point, disarm_crashes, latency_pair,
)
from .gossip import (  # noqa: F401
    ClusterNode, GossipScheduler, RoundReport, hello_accept, hello_dial,
)
from .membership import ALIVE, DEAD, SUSPECT, Membership, PeerInfo  # noqa: F401
from .transport import (  # noqa: F401
    QueuePairTransport, ResilientTransport, RetryPolicy, TcpTransport, Transport, linger,
    queue_pair,
)

__all__ = [
    "ALIVE", "DEAD", "SUSPECT", "ClusterNode", "CrashPlan", "CrashState", "FaultPlan",
    "FaultyTransport", "FlappingDialer", "GossipScheduler", "InjectedCrash", "LatencyTransport",
    "Membership", "PeerInfo", "QueuePairTransport", "ResilientTransport", "RetryPolicy",
    "RoundReport", "TcpTransport", "TornWriter", "Transport", "arm_crashes", "crash_point",
    "disarm_crashes",
    "hello_accept", "hello_dial", "latency_pair", "linger", "queue_pair",
]
