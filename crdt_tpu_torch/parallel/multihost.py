"""Multi-process backend: DCN x ICI meshes over ``torch.distributed``
(the port of ``crdt_tpu/parallel/multihost.py``).

The reference delegates transport to the user (serialized state and ops,
`src/lib.rs:62-83` of the reference crate) and simulates replicas in one
process; it has no comm backend (SURVEY.md §2.3).  This module is the
NCCL/gloo layer a distributed deployment needs: the lattice-join
collectives of :mod:`.collective`, run across processes and hosts.

Design (pick a mesh, name its axes, run the collectives over each axis's
process group):

* **``objects`` rides the slow tier** (DCN between hosts; the leading
  dims of the mesh): distinct CRDT objects never exchange data during a
  join (each object's merge is independent, `src/orswot.rs:89-156`), so
  sharding them across hosts puts no join traffic on the slow links;
  each host anti-entropies its own object partition.
* **``replicas`` rides the fast tier** (NVLink inside a host): the N-way
  global join all-gathers member tables and all-reduce-maxes clock
  planes over the replica axis (``VClock::merge`` is elementwise max,
  `src/vclock.rs:131-137`), so the bandwidth-heavy collective stays on
  the fast tier.

Axis names are those of :mod:`.mesh`, so every collective runs on a
multi-host mesh unchanged; only the ranks' placement differs.  One rank
is one process with one device: a mesh's dims multiply to the world
size.

Single process: with no configuration :func:`initialize` is a no-op, and
:func:`make_multihost_mesh` is :func:`~.mesh.make_mesh` over a world of
one, so the same program text runs on a laptop and on a cluster.

**Interning across hosts.**  Dense planes built on different hosts mix
inside a cross-host collective, so the actor and member interning must
be deterministic and shared: use ``Universe.identity`` (dense index ==
value, which the bulk wire codec requires anyway) or distribute one
agreed registry.  Per-host insertion-order registries map different
actors to the same dense id, and the join silently conflates them.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Any, Dict

import torch
import torch.distributed as dist

from .mesh import GROUP_TIMEOUT, axis_size, make_mesh, replicate, tree_leaves

__all__ = [
    "initialize",
    "topology",
    "make_multihost_mesh",
    "global_batch_from_local",
    "local_shard",
    "LocalPart",
]

# the default group this module made -> its rendezvous; held weakly, so
# that neither outlives the group's destruction
_JOINED: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    store=None,
) -> dict:
    """Join (or skip joining) the process group; return :func:`topology`.

    * A ``store`` (``torch.distributed.FileStore``, ``TCPStore``,
      ``HashStore``) with ``num_processes`` and ``process_id`` wins; then
      ``coordinator_address`` (``"host:port"``, a TCP rendezvous); then
      the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
      environment (explicit arguments override the last two).
    * With none of them this is a no-op: one process.
    * Called again once joined, it returns :func:`topology` where the
      world size, rank and rendezvous asked for are the group's, and
      raises ``RuntimeError`` where they differ: a group made earlier
      (:func:`~.mesh.make_mesh`'s world of one, say) never stands in
      silently for the one asked for.

    The backend is gloo for CPU tensors, plus NCCL for CUDA tensors where
    a card is present; every group waits at most
    :data:`~.mesh.GROUP_TIMEOUT`."""
    if store is not None:
        how = {"store": store}
    elif coordinator_address:
        how = {"init_method": f"tcp://{coordinator_address}"}
    elif os.environ.get("MASTER_ADDR"):
        how = {"init_method": "env://"}
    else:
        how = None
    if dist.is_initialized():
        topo = topology()
        mine = _JOINED.get(dist.group.WORLD)  # None: the group was made elsewhere
        for asked, have in ((num_processes, topo["processes"]),
                            (process_id, topo["process_id"]), (how, mine)):
            if None not in (asked, have) and asked != have:
                raise RuntimeError(
                    f"initialize: this process is rank {topo['process_id']} of a group of "
                    f"{topo['processes']} already; asked for rank {process_id} of "
                    f"{num_processes} through {how}")
        return topo
    if how is None:
        return topology()
    cuda = torch.cuda.is_available() and dist.is_nccl_available()
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if cuda else "gloo", timeout=GROUP_TIMEOUT,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **how)
    _JOINED[dist.group.WORLD] = how
    return topology()


def topology() -> dict:
    """The live process topology as plain data: one device per rank."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    return {"processes": world, "process_id": dist.get_rank() if joined else 0,
            "devices": world, "local_devices": 1}


def make_multihost_mesh(
    ici_axes: Dict[str, int] | None = None,
    dcn_axes: Dict[str, int] | None = None,
    device=None,
):
    """A mesh whose ``dcn_axes`` span hosts and whose ``ici_axes`` stay
    inside one: ``make_multihost_mesh({"replicas": 4}, {"objects": 2})``
    over 8 ranks has the dims ``("objects", "replicas")``.  DCN dims
    lead, as in ``mesh_utils.create_hybrid_device_mesh``, so with
    consecutive ranks on one host a trailing dim's group stays on it.
    With one process or no ``dcn_axes`` this is :func:`~.mesh.make_mesh`
    over the merged axes."""
    merged = {**(dcn_axes or {}), **(ici_axes or {})}
    return make_mesh(merged or None, device=device)


def local_shard(n: int, axis_size: int, index: int) -> slice:
    """The half-open object range process ``index`` of ``axis_size``
    owns out of ``n`` objects (even split, remainder to the front)."""
    base, rem = divmod(n, axis_size)
    start = index * base + min(index, rem)
    return slice(start, start + base + (1 if index < rem else 0))


@dataclasses.dataclass(frozen=True)
class LocalPart:
    """This rank's planes of a batch sharded along ``axis`` of a mesh:
    ``value`` holds rows ``span`` of the ``size`` rows along ``axis``."""

    value: Any
    axis: str
    span: slice
    size: int


def global_batch_from_local(mesh, batch, axis: str = "objects") -> LocalPart:
    """Adopt this rank's planes as its shard of a batch sharded along
    ``axis``, with no all-gather (multi-host ingest: each host parses its
    own wire blobs, ``OrswotBatch.from_wire`` on the host-local slice).

    ``batch`` is any tree of tensors whose leading dimension is this
    rank's part of ``axis``; every rank holds as many rows, as JAX's
    ``make_array_from_process_local_data`` assumes.  The planes move to
    the mesh's device."""
    n = tree_leaves(batch)[0].shape[0]
    index = mesh.get_local_rank(axis)
    return LocalPart(replicate(batch, mesh), axis, slice(index * n, (index + 1) * n),
                     n * axis_size(mesh, axis))
