"""Sharded fleet state: one logical replica in S shards over the ranks of
an ``objects`` mesh (the port of ``crdt_tpu/mesh/state.py``).

* :class:`MeshLayout` — the shard→leaf-range map.  Boundaries sit on
  power-of-two **subtree granules** (the spans
  :func:`~crdt_tpu_torch.obs.stability.subtree_layout` hands out), so a
  shard owns whole digest-tree subtrees.  With a measured heat vector
  the granule is priced by the placement planner's ``mesh:S`` score
  (:func:`~crdt_tpu_torch.obs.heat.score_plan`, snapped by
  :func:`~crdt_tpu_torch.obs.heat.mesh_bounds`).
* :class:`ShardedBatch` — a batch padded to ``shards * per_shard`` rows
  (empty rows digest to 0, the XOR identity, so padding never shows in a
  digest or a tree) and placed on the mesh.

JAX places S shards on S devices of one process.  Here one process is
one rank with one device: rank ``r`` of a world of W holds the
contiguous shards ``[r·S/W, (r+1)·S/W)``, placed by
:func:`~crdt_tpu_torch.parallel.mesh.shard_batch`.  S must be a multiple
of W; a world of one (the card) holds all S shards.

Ids carried by value (op, read and delta rows) index the global object
axis; :meth:`MeshLayout.rebase` splits them into ``(shard, local_row)``
and :meth:`MeshLayout.unbase` inverts it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

#: the data-parallel mesh axis every plane shards over
MESH_AXIS = "objects"

#: the shard counts the contracts are declared for
MESH_SIZES = (1, 2, 4, 8)

_LOCK = threading.Lock()
_COUNTS: dict = {}


def _bump(key: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[key] = _COUNTS.get(key, 0) + int(n)


def mesh_counts() -> dict:
    """The mesh layer's process-wide counts (steps, subset syncs, fleet
    snapshots, rejections, refused contracts), published under the JAX
    package's ``mesh.*`` names (:func:`~crdt_tpu_torch.obs.publish.
    publish_mesh`)."""
    with _LOCK:
        return dict(_COUNTS)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """The shard→leaf-range map of one sharded fleet: ``per_shard`` rows
    per shard (a multiple of ``granule``); rows past ``n`` are padding.
    Shard ``s`` owns global rows ``[bounds[s], bounds[s+1])``."""

    n: int           # logical (unpadded) fleet rows
    shards: int      # shards over the object axis
    granule: int     # pow2 subtree span the boundaries snap to
    per_shard: int   # padded rows per shard
    imbalance: float = 1.0  # planner-predicted max/mean shard load

    @property
    def padded(self) -> int:
        return self.shards * self.per_shard

    @property
    def bounds(self) -> tuple:
        """Logical boundaries, ``shards + 1`` entries clipped to n."""
        return tuple(min(s * self.per_shard, self.n) for s in range(self.shards + 1))

    def ranges(self) -> tuple:
        """Per-shard logical ``(lo, hi)`` ranges."""
        b = self.bounds
        return tuple(zip(b[:-1], b[1:]))

    def objects_of(self, shard: int) -> int:
        lo, hi = self.ranges()[shard]
        return hi - lo

    def shard_of(self, obj: int) -> int:
        if not 0 <= obj < self.n:
            raise IndexError(f"object {obj} outside fleet [0, {self.n})")
        return min(obj // self.per_shard, self.shards - 1)

    def rebase(self, ids) -> tuple:
        """Global object ids → ``(shard, local_row)``."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise IndexError(f"object ids outside fleet [0, {self.n}): "
                             f"[{ids.min()}, {ids.max()}]")
        return ids // self.per_shard, ids % self.per_shard

    def unbase(self, shard, local) -> np.ndarray:
        """Inverse of :meth:`rebase`."""
        return np.asarray(shard, np.int64) * self.per_shard + np.asarray(local, np.int64)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "MeshLayout":
        return cls(*(int(obj[k]) for k in ("n", "shards", "granule", "per_shard")),
                   float(obj.get("imbalance", 1.0)))


def choose_layout(n: int, shards: int, *, heat: Optional[Sequence] = None,
                  span: Optional[int] = None, granule: Optional[int] = None) -> MeshLayout:
    """The shard→leaf-range map for ``n`` objects over ``shards`` shards.

    The granule defaults to the digest tree's subtree span for this fleet
    size.  With a per-subtree ``heat`` vector the span and its next two
    doublings are priced by the planner's ``mesh:S`` score and the lowest
    predicted imbalance wins (ties to the smaller granule).  An explicit
    ``granule`` skips the search and must be a power of two."""
    from ..obs import heat as heat_mod
    from ..obs.stability import subtree_layout

    if n < 1:
        raise ValueError(f"fleet size {n} < 1")
    if shards < 1:
        raise ValueError(f"shards {shards} < 1")
    span = max(1, int(subtree_layout(n)[1] if span is None else span))
    imbalance = 1.0
    if granule is None and heat is None:
        granule = span
    elif granule is None:
        heat = np.asarray(heat, dtype=np.float64)
        imbalance, granule = min(
            (float(heat_mod.score_plan(f"mesh:{shards}", heat, n=n, span=span,
                                       granule=g)["imbalance"]), g)
            for g in (span, span * 2, span * 4))
    bounds = heat_mod.mesh_bounds(n, shards, granule)  # validates the granule
    g = int(granule)
    layout = MeshLayout(int(n), int(shards), g, -(-(-(-n // shards)) // g) * g, float(imbalance))
    assert list(layout.bounds) == bounds  # one formula, two homes
    return layout


def _pad_batch(batch, pad: int, universe):
    """``batch`` with ``pad`` empty rows appended to every plane: the
    states that digest to the XOR identity."""
    import torch

    from ..parallel.mesh import tree_leaves, tree_map

    if pad == 0:
        return batch
    z = type(batch).zeros(pad, universe, device=tree_leaves(batch)[0].device)
    return tree_map(lambda a, b: torch.cat([a, b]), batch, z)


class ShardedBatch:
    """A fleet batch sharded over the object axis of a mesh: the one
    logical replica in S shards.  ``device`` is this rank's part of the
    padded batch (its shards' rows), ``layout`` the shard→leaf-range map,
    ``universe`` the salts and padding widths.  Build with :meth:`shard`."""

    def __init__(self, device_batch, layout: MeshLayout, mesh, universe=None):
        self.device = device_batch
        self.layout = layout
        self.mesh = mesh
        self.universe = universe

    @classmethod
    def shard(cls, batch, universe, *, shards: Optional[int] = None, mesh=None, heat=None,
              span: Optional[int] = None, granule: Optional[int] = None) -> "ShardedBatch":
        """Lay ``batch`` (every rank passes the whole logical fleet) out
        in ``shards`` shards (:func:`choose_layout`), pad the tail with
        empty rows and keep this rank's shards.  ``mesh`` (an ``objects``
        mesh) defaults to every rank of the process group, a world of one
        without one, on the batch's device; ``shards`` to its size."""
        from ..parallel import mesh as mesh_mod

        if mesh is None:
            if shards is None:
                raise ValueError("ShardedBatch.shard needs shards= or mesh=")
            mesh = mesh_mod.make_mesh(device=mesh_mod.tree_leaves(batch)[0].device)
        world = mesh_mod.axis_size(mesh, MESH_AXIS)
        shards = world if shards is None else int(shards)
        if shards % world:
            raise ValueError(f"shards {shards} is not a multiple of the {world} ranks")
        n = int(mesh_mod.tree_leaves(batch)[0].shape[0])
        layout = choose_layout(n, shards, heat=heat, span=span, granule=granule)
        padded = _pad_batch(batch, layout.padded - n, universe)
        return cls(mesh_mod.shard_batch(padded, mesh, MESH_AXIS), layout, mesh, universe)

    def logical(self):
        """The unpadded logical batch (rows ``[0, n)``) on every rank:
        the ranks' shards all-gathered in rank order, then cut to n."""
        from ..parallel.collective import _gather
        from ..parallel.mesh import axis_size, tree_map

        n, group = self.layout.n, self.mesh.get_group(MESH_AXIS)
        if axis_size(self.mesh, MESH_AXIS) == 1:
            return tree_map(lambda x: x[:n], self.device)
        return tree_map(lambda x: _gather(x, group).flatten(0, 1)[:n], self.device)

    def replace(self, device_batch) -> "ShardedBatch":
        """A new ShardedBatch around updated planes (same layout and mesh)."""
        return ShardedBatch(device_batch, self.layout, self.mesh, self.universe)

    def publish_gauges(self, registry=None, heat_vector=None, span: int = 1) -> None:
        """Set the placement gauges: ``mesh.layout.*`` and each shard's
        objects, plus each shard's load when a per-subtree heat vector is
        given (spread evenly within subtrees, as the planner prices)."""
        from ..obs import metrics, publish

        loads = None if heat_vector is None else shard_loads(self.layout, heat_vector, span)
        publish.publish_layout(registry if registry is not None else metrics.registry(),
                               self.layout, loads)


def shard_loads(layout: MeshLayout, heat_vector, span: int) -> np.ndarray:
    """Measured per-subtree heat attributed to each shard's leaf range:
    the runtime counterpart of the planner's predicted ``loads`` (the same
    spread within subtrees)."""
    from ..obs.heat import mesh_loads

    return mesh_loads(heat_vector, max(1, int(span)), layout.n, layout.bounds)
