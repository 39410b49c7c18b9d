"""The dispatch gate of the mesh layer: a kernel runs sharded over the
object mesh only if its sharding contract allows it (the port of
``crdt_tpu/mesh/contracts.py``).

The JAX gate reads the static checker's kernel manifest
(``crdt_tpu.analysis.kernels.MANIFEST``).  The port imports nothing of
the JAX package, so it keeps its own table of the rows it consumes,
copied from that manifest; ``tests/test_torch_mesh.py`` holds the table
row by row against it.  A kernel with no row here is refused, as one
with no contract is there.
"""

from __future__ import annotations

import threading
from typing import Dict, FrozenSet, NamedTuple

from ..error import MeshContractError
from .state import _bump

#: shard classes the mesh layer may dispatch (host_only and replicated
#: are refused)
SHARDABLE_CLASSES = ("pointwise", "reduction")


class ShardContract(NamedTuple):
    """A kernel's declared sharding: its class, the collectives it runs
    and the mesh sizes it is declared for."""

    sclass: str
    collectives: tuple = ()
    mesh_sizes: tuple = (1, 2, 4, 8)
    reason: str = ""


_CONTRACTS = {
    "parallel.shard_local_merge": ShardContract(
        "pointwise", (), (1,), "already the per-shard body of the objects-mesh merge: the "
        "object axis arrives pre-sliced to this shard"),
    "sync.digest.orswot": ShardContract("pointwise"),
    "mesh.step.anti_entropy": ShardContract(
        "reduction", ("all_gather", "pmax", "psum"), reason="whole anti-entropy round fused "
        "over the objects mesh: shard-local pair merge + digest slice, ONE all_gather for the "
        "fleet digest vector, pmax clock join, psum member fold; salt operands ride "
        "replicated"),
    "parallel.member_clock_join": ShardContract(
        "reduction", ("pmax",), reason="clock join across the member-shard mesh axis; object "
        "axis rides through at dim 1"),
    "parallel.member_apply_add": ShardContract(
        "pointwise", reason="member-routed add: every shard sees the op, only the owner "
        "applies it — shard-local (no collective; the clock rebroadcast is "
        "member_clock_join's pmax)"),
}

_LOCK = threading.Lock()
_CONSUMED: set = set()


def contract_map() -> Dict[str, ShardContract]:
    """The contract of every kernel the port dispatches on a mesh, by name."""
    return dict(_CONTRACTS)


def require_shardable(name: str, mesh_size: int) -> ShardContract:
    """Return ``name``'s contract, or raise :class:`MeshContractError`
    when it forbids running sharded over ``mesh_size`` shards; records
    the name in :func:`consumed_contracts`."""
    contract = _CONTRACTS.get(name)
    if contract is None:
        why, sclass = "has no contract row: nothing proved it shardable", ""
    elif contract.sclass not in SHARDABLE_CLASSES:
        why, sclass = f"is declared {contract.sclass!r} ({contract.reason})", contract.sclass
    elif int(mesh_size) not in contract.mesh_sizes:
        why, sclass = (f"is contracted for mesh sizes {contract.mesh_sizes}, not {mesh_size}",
                       contract.sclass)
    else:
        with _LOCK:
            _CONSUMED.add(name)
        return contract
    _bump("contract_refused")
    raise MeshContractError(f"kernel {name!r} {why}: the mesh layer refuses to dispatch it",
                            kernel=name, sclass=sclass)


def consumed_contracts() -> FrozenSet[str]:
    """Kernel names the gate has approved so far in this process."""
    with _LOCK:
        return frozenset(_CONSUMED)
