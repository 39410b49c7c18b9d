"""The cluster layer's transports and roster (the port of the JAX
package's ``cluster`` package, less the gossip scheduler and the crash
injectors): frame transports and the ARQ that hardens them
(:mod:`~crdt_tpu_torch.cluster.transport`), seeded fault injection
(:mod:`~crdt_tpu_torch.cluster.faults`) and peer health
(:mod:`~crdt_tpu_torch.cluster.membership`).  Failures speak the
:class:`~crdt_tpu_torch.error.TransportError` taxonomy; counts are plain
fields."""

from .faults import (  # noqa: F401
    FaultPlan, FaultyTransport, FlappingDialer, LatencyTransport, latency_pair,
)
from .membership import ALIVE, DEAD, SUSPECT, Membership, PeerInfo  # noqa: F401
from .transport import (  # noqa: F401
    QueuePairTransport, ResilientTransport, RetryPolicy, TcpTransport, Transport, linger,
    queue_pair,
)

__all__ = [
    "ALIVE", "DEAD", "SUSPECT", "FaultPlan", "FaultyTransport", "FlappingDialer",
    "LatencyTransport", "Membership", "PeerInfo", "QueuePairTransport", "ResilientTransport",
    "RetryPolicy", "TcpTransport", "Transport", "latency_pair", "linger", "queue_pair",
]
