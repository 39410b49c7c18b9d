"""Process-group meshes and batch placement: the port of
``crdt_tpu/parallel/mesh.py``.

JAX runs one process over many devices; torch runs one process per rank,
and each rank holds one device.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over every rank of
the default process group, with named dims (SURVEY.md §2.3):

* ``"objects"`` — independent CRDT objects shard over it, and a pairwise
  merge moves nothing between ranks;
* ``"replicas"`` — copies of the same objects, joined by collectives over
  the dim's process group (:mod:`.collective`).

Ranks are laid out row-major, as JAX reshapes its device array
(``np.asarray(devices).reshape(sizes)``).  So a dim's group orders its
ranks as JAX orders devices along that axis, and rank ``r`` of a
``{"replicas": k}`` mesh holds row ``r`` of the JAX arrays.  A dim's
group is gloo on a CPU mesh and NCCL on a CUDA mesh, and every group
waits at most :data:`GROUP_TIMEOUT`: a rank that raises alone then fails
its peers' next collective instead of hanging them for gloo's default 30
minutes.

Batches are trees of tensors: tensors, tuples and lists of trees, and
dataclasses (``OrswotBatch``, ``MapBatch``, ...) whose fields are trees;
other fields (a ``MapBatch``'s kernel) pass through unchanged.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import weakref
from typing import Dict

import torch
import torch.distributed as dist

from ..device import resolve_device

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
# default group -> {(rank grid shape, backend): each dim's group}; held
# weakly, so that the groups go with the default group when it is
# destroyed and none outlives it into the interpreter's exit
_GROUPS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``), keeping the tree's structure."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree``, in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def axis_size(mesh, axis: str) -> int:
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]


def mesh_device(mesh) -> torch.device:
    """The device of this rank's part of ``mesh``."""
    return resolve_device(mesh.device_type)


def _dim_group(grid: torch.Tensor, dim: int, backend: str):
    """This rank's group along ``dim`` of the rank grid.  Every rank
    creates every group of the dim, in one order, as ``new_group`` needs."""
    mine = None
    for line in grid.movedim(dim, -1).reshape(-1, grid.shape[dim]).tolist():
        group = dist.new_group(line, timeout=GROUP_TIMEOUT, backend=backend)
        if dist.get_rank() in line:
            mine = group
    return mine


def make_mesh(axes: Dict[str, int] | None = None, device=None):
    """A mesh from ``{axis_name: size}`` over every rank; the sizes'
    product must be the world size.  Defaults to a 1-D ``objects`` mesh.

    ``device`` (default ``"cuda"``) picks the groups' backend: NCCL for
    CUDA, gloo for the CPU.  With no process group yet, this process
    joins a world of one (:func:`~.multihost.initialize` over an
    in-memory store)."""
    from torch.distributed.device_mesh import DeviceMesh

    from .multihost import initialize

    dev = resolve_device(device)
    if not dist.is_initialized():
        initialize(num_processes=1, process_id=0, store=dist.HashStore())
    world = dist.get_world_size()
    axes = dict(axes) if axes is not None else {"objects": world}
    if math.prod(axes.values()) != world:
        raise ValueError(f"mesh axes {axes} need {math.prod(axes.values())} ranks, have {world}")
    grid = torch.arange(world).reshape(list(axes.values()))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    # a group is a communicator: made once per default group, grid shape
    # and backend, and handed out again to every later mesh of that shape
    made = _GROUPS.setdefault(dist.group.WORLD, {})
    key = (tuple(grid.shape), backend)
    if key not in made:
        made[key] = [_dim_group(grid, d, backend) for d in range(grid.dim())]
    return DeviceMesh.from_group(made[key], dev.type, mesh=grid, mesh_dim_names=tuple(axes))


def shard_batch(batch, mesh, axis: str = "objects"):
    """This rank's shard of every tensor's leading (object) axis along
    ``axis`` (:func:`~.multihost.local_shard`'s split), on the mesh's
    device."""
    from .multihost import local_shard

    size, index, dev = axis_size(mesh, axis), mesh.get_local_rank(axis), mesh_device(mesh)
    return tree_map(lambda x: x[local_shard(x.shape[0], size, index)].to(dev), batch)


def replicate(batch, mesh):
    """A full copy of ``batch`` on this rank's device."""
    dev = mesh_device(mesh)
    return tree_map(lambda x: x.to(dev), batch)
