"""The mesh anti-entropy step: merge, digest and fleet summaries of a
sharded fleet in one call (the port of ``crdt_tpu/mesh/step.py``).

JAX runs the round as one ``shard_map`` program over S devices.  Here
each rank runs it over the shards it holds:

* **shard-local joins** — the pairwise merge of the rank's rows
  (:func:`~crdt_tpu_torch.parallel.collective._orswot_pair_merge`, the
  merge kernel on the card); no bytes cross ranks;
* **the digest vector** — the rank's rows digested by the unsharded
  path's per-row body (:func:`~crdt_tpu_torch.sync.digest.
  orswot_digest_rows`), then one ``all_gather`` in rank order: digests
  have no cross-row coupling, so the concatenation is the unsharded
  vector, byte for byte;
* **reduction summaries** — an ``all_reduce`` MAX of the biased clock
  planes (the bias keeps the unsigned order) for the fleet version
  vector, and an ``all_reduce`` SUM of the live members.

The overflow flags are summed too, so every rank raises or none.
The dispatch gate (:mod:`.contracts`) runs at S, the shard count.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import contracts
from .state import MESH_AXIS, ShardedBatch, _bump

#: contract rows the step composes: the per-shard body runs at mesh size
#: 1 by construction, the step and its digest at the shard count
_SHARD_LOCAL_KERNELS = ("parallel.shard_local_merge",)
_SHARDED_KERNELS = ("sync.digest.orswot", "mesh.step.anti_entropy")


@dataclasses.dataclass(frozen=True)
class MeshStepResult:
    """One round's outputs: the merged sharded fleet, the logical digest
    vector (host ``uint64[n]``), the fleet version vector (``uint64[A]``)
    and the fleet's live members."""

    batch: ShardedBatch
    digests: np.ndarray
    version_vector: np.ndarray
    live_members: int


def anti_entropy_step(a: ShardedBatch, b: ShardedBatch, *, check: bool = True,
                      impl=None) -> MeshStepResult:
    """One anti-entropy round of two replicas of one sharded fleet (same
    layout and mesh).  Raises :class:`~crdt_tpu_torch.error.
    CapacityOverflowError` on any rank's slot overflow when ``check``."""
    import torch
    import torch.distributed as dist

    from ..batch.orswot_batch import OrswotBatch
    from ..dtypes import EMPTY, counters_to_numpy
    from ..error import raise_for_overflow
    from ..parallel.collective import _gather, _orswot_pair_merge, _planes
    from ..sync.digest import orswot_digest_rows

    lay = a.layout
    if b.layout != lay or b.mesh != a.mesh:
        raise ValueError(f"anti_entropy_step needs both fleets on one layout and mesh "
                         f"(got {lay} vs {b.layout})")
    for name in _SHARDED_KERNELS:
        contracts.require_shardable(name, lay.shards)
    for name in _SHARD_LOCAL_KERNELS:
        contracts.require_shardable(name, 1)
    da, group = a.device, a.mesh.get_group(MESH_AXIS)
    merged, overflow = _orswot_pair_merge(_planes(da), _planes(b.device), da.ids.shape[-1],
                                          da.d_ids.shape[-1], impl)
    digests = _gather(orswot_digest_rows(*merged, a.universe), group).reshape(-1)
    vv = merged[0].amax(dim=0)
    # live members and each overflow flag's count, summed over the ranks
    sums = torch.stack([(merged[1] != EMPTY).sum(), *overflow.reshape(-1, 2).sum(0)])
    dist.all_reduce(vv, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(sums, group=group)
    if check:
        raise_for_overflow(sums[1:] > 0, "mesh anti_entropy_step")
    digests = digests.cpu().numpy().view(np.uint64)[:lay.n]
    _bump("step_rounds")
    _bump("step_digest_bytes", digests.nbytes)
    return MeshStepResult(batch=a.replace(OrswotBatch(*merged)), digests=digests,
                          version_vector=counters_to_numpy(vv).astype(np.uint64),
                          live_members=int(sums[0]))
