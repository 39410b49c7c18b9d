"""What causal GC may reclaim (the port of the JAX package's
``gc/compact.py``), as torch ops where the planes live:

* :func:`settle_orswot` — tombstone settling: the defer plunger as one
  pass without a merge (dedup the deferred rows, replay those the
  object's clock dominates, re-pack both slot tables at unchanged
  capacities).  A settled replica and its unsettled twin reach the same
  digests after any plunged merge, so it may run unilaterally.
* :func:`compact_oplog` / :func:`compact_gap_buffer` — drop buffered
  add/inc/dec ops whose dot the local planes already witness, gated at
  the fleet watermark.  Removes and LWW writes are never dropped.
* :func:`truncate_orswot` — the reference's reset truncate
  (`orswot.rs:159-172`) at one clock, through
  :meth:`OrswotBatch.truncate <crdt_tpu_torch.batch.OrswotBatch.truncate>`
  (the merge kernel on a CUDA device).  It deletes members the clock
  dominates, so the default policy never runs it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtypes import EMPTY, counters_to_numpy
from ..ops import orswot_ops


#: cells of one row chunk's ``[rows, M + D, D, A]`` settle temporaries
_SETTLE_CELLS = 1 << 27


def _settle_rows(clock, ids, dots, d_ids, d_clocks):
    d_ids, d_clocks = orswot_ops._dedup_deferred(d_ids, d_clocks)
    ids, dots, d_ids, d_clocks = orswot_ops._apply_deferred(clock, ids, dots, d_ids, d_clocks)
    ids, dots, _ = orswot_ops.compact_by_id(ids, dots, ids.shape[-1])
    d_ids, d_clocks, _ = orswot_ops.compact(d_ids, d_clocks, d_ids.shape[-1])
    return ids, dots, d_ids, d_clocks


def settle_orswot(batch):
    """``(settled_batch, {"tombstones_cleared", "members_freed"})``: the
    standalone defer plunger over an ORSWOT batch, in row chunks (its
    ``[rows, M, D, A]`` replay temporaries), with one two-int copy to the
    host for the stats."""
    planes = (batch.clock, batch.ids, batch.dots, batch.d_ids, batch.d_clocks)
    m, d, a = batch.ids.shape[-1], batch.d_ids.shape[-1], batch.clock.shape[-1]
    step = max(1, _SETTLE_CELLS // max(1, (m + d) * max(1, d) * a))
    ids, dots, d_ids, d_clocks = out = [torch.empty_like(p) for p in planes[1:]]
    for s in range(0, batch.clock.shape[0], step):
        for o, x in zip(out, _settle_rows(*(p[s:s + step] for p in planes))):
            o[s:s + step] = x
    cleared = torch.stack([(batch.d_ids != EMPTY).sum() - (d_ids != EMPTY).sum(),
                           (batch.ids != EMPTY).sum() - (ids != EMPTY).sum()])
    tombs, members = cleared.tolist()
    settled = type(batch)(clock=batch.clock, ids=ids, dots=dots, d_ids=d_ids,
                          d_clocks=d_clocks)
    return settled, {"tombstones_cleared": tombs, "members_freed": members}


def truncate_orswot(batch, clock, check: bool = True):
    """The batched reset truncate at one fleet-wide clock: ``clock`` is
    unsigned ``[A]`` (e.g. a watermark), broadcast to every object, or a
    full ``[N, A]`` plane (a tensor is taken as biased)."""
    if not isinstance(clock, torch.Tensor):
        clock = np.broadcast_to(np.asarray(clock), batch.clock.shape)
    elif clock.dim() == 1:
        clock = clock.expand(batch.clock.shape)
    return batch.truncate(clock, check=check)


def witnessed_ops_mask(ops, clock_plane, watermark: Optional[np.ndarray] = None) -> np.ndarray:
    """``bool[B]``: buffered add/inc/dec ops the planes already witness
    (``counter <= clock[obj, actor]``), and with ``watermark`` also at or
    below their actor's watermark entry.  ``clock_plane``: unsigned host
    counters, or a biased tensor, of which only the ``[obj, actor]``
    cells the ops name are gathered, where it lives, and unbiased."""
    from ..oplog.records import OP_ADD, OP_DEC, OP_INC

    if not len(ops):
        return np.zeros(0, dtype=bool)
    if isinstance(clock_plane, torch.Tensor):
        dev = clock_plane.device
        base = counters_to_numpy(clock_plane[torch.from_numpy(ops.obj).to(dev),
                                             torch.from_numpy(ops.actor).to(dev).long()])
    else:
        base = np.asarray(clock_plane)[ops.obj, ops.actor]
    dotted = np.isin(ops.kind, np.asarray([OP_ADD, OP_INC, OP_DEC], np.uint8))
    counters = ops.counter.astype(np.uint64)
    witnessed = dotted & (counters <= base.astype(np.uint64))
    if watermark is not None:
        wm = np.asarray(watermark, dtype=np.uint64).reshape(-1)
        in_range = ops.actor < wm.size
        wm_of = np.zeros(len(ops), np.uint64)
        wm_of[in_range] = wm[ops.actor[in_range]]
        witnessed &= in_range & (counters <= wm_of)
    return witnessed


def compact_oplog(log, clock_plane, watermark: Optional[np.ndarray] = None) -> dict:
    """Drop an :class:`~crdt_tpu_torch.oplog.OpLog`'s witnessed dots at
    or below ``watermark`` in place: ``{"ops_dropped",
    "bytes_reclaimed"}``."""
    dropped, freed = log.compact(lambda ops: witnessed_ops_mask(ops, clock_plane, watermark))
    return {"ops_dropped": dropped, "bytes_reclaimed": freed}


def compact_gap_buffer(applier, clock_plane, watermark: Optional[np.ndarray] = None) -> dict:
    """The same for an :class:`~crdt_tpu_torch.oplog.OpApplier`'s park
    buffer: a parked add whose dot the planes now witness arrived twice."""
    dropped, freed = applier.prune(lambda ops: witnessed_ops_mask(ops, clock_plane, watermark))
    return {"ops_dropped": dropped, "bytes_reclaimed": freed}
