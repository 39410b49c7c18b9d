"""Collective lattice joins over process groups — anti-entropy as an
all-reduce (the port of ``crdt_tpu/parallel/collective.py``; SURVEY.md §5).

Because ``CvRDT::merge`` is associative, commutative and idempotent
(`src/traits.rs:9-12`), the global join of N replicas is a reduction
with merge as the combiner:

* **clock-shaped state** (VClock / GCounter / PNCounter): merge is
  pointwise max (`src/vclock.rs:131-137`), so the join across ranks is
  one ``all_reduce(MAX)``.  Counters are biased into the signed type of
  their width, which keeps their order, so MAX over biased planes is the
  unsigned MAX.
* **ORSWOT, Map, LWW and MVReg state**: an **all-gather and a fold in
  group-rank order** with merge as the combiner.  The reference merge is
  order-sensitive (`src/orswot.rs:94-103`: which side's stale dots an
  entry clock keeps), so every rank folds the gathered stack from group
  rank 0 up: the result is the same on every rank and bit-equal to the
  scalar left fold.  A ring (a different fold origin per rank) breaks
  both.
* **replica stacks on one device**: :func:`fold_reduce_merge`,
  :func:`tree_reduce_merge` and :func:`anti_entropy`.

JAX shards ``[R, N, ...]`` arrays one replica per device; here each
rank passes its own replica, with a leading axis of 1 or without it, and
gets its row of the JAX result back in the same form.  The planes go
over the mesh axis's group (gloo for CPU tensors, NCCL for CUDA ones; a
tensor on the other kind of device raises), ``bool`` planes as ``uint8``
(neither backend reduces ``bool``).

Anti-entropy to fixpoint (BASELINE.md config ★) is the fold plus
self-merges (the reference's "defer plunger", `test/orswot.rs:61-62`)
until the state stops changing.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist

from ..batch.gset_batch import GSetBatch
from ..batch.lwwreg_batch import LWWRegBatch
from ..batch.map_batch import MapBatch
from ..batch.mvreg_batch import MVRegBatch, _chunked_merge
from ..batch.orswot_batch import OrswotBatch
from ..error import CapacityOverflowError, ConflictingMarker, raise_for_overflow
from ..ops import lww_ops, orswot_ops
from .mesh import tree_leaves, tree_map

PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")


def _check_backend(group, x: torch.Tensor) -> None:
    """A CUDA tensor goes over NCCL and a CPU tensor over gloo; never the
    other way round."""
    backend = str(dist.get_backend(group))
    want = "nccl" if x.is_cuda else "gloo"
    if want not in backend:
        raise ValueError(f"a {x.device.type} tensor needs a {want} group, this one is "
                         f"{backend!r}")


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[k, *x.shape]``: every rank's ``x`` in group-rank order."""
    _check_backend(group, x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _local(x: torch.Tensor, lead: bool) -> torch.Tensor:
    """This rank's replica: ``x`` without its leading axis of 1."""
    if not lead:
        return x
    if x.shape[0] != 1:
        raise ValueError(f"leading replica axis {x.shape[0]} != 1 (one replica per rank)")
    return x[0]


def _take(stack, i: int):
    return tree_map(lambda x: x[i], stack)


# -- clock-shaped types ------------------------------------------------------


def all_reduce_clock_join(clocks, mesh, axis: str = "replicas"):
    """Global VClock/GCounter/PNCounter join across a mesh axis.

    ``clocks``: this rank's replicas, stacked on a leading axis (biased
    counters, any integer dtype); their ``amax``, then an all-reduce-max
    over ``axis``: the collective form of N-way ``VClock::merge``.  Every
    row of the output holds the global join."""
    group = mesh.get_group(axis)
    _check_backend(group, clocks)
    out = clocks.amax(dim=0, keepdim=True).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.expand(clocks.shape).contiguous()


# -- generic reductions over a replica axis ----------------------------------


def tree_reduce_merge(stack, merge_fn: Callable):
    """Reduce a replica-stacked tree (leading axis R on every leaf) to one
    state with a binary merge tree of ``merge_fn(a, b) -> merged``.

    Safe for types whose merge is truly commutative (clocks, counters,
    LWW, MVReg).  ORSWOT's merge order leaves different stale dots in
    entry clocks (`src/orswot.rs:94-103`): use :func:`fold_reduce_merge`
    where bit-parity with the scalar N-way join matters."""
    parts = [_take(stack, i) for i in range(tree_leaves(stack)[0].shape[0])]
    while len(parts) > 1:
        paired = [merge_fn(parts[i], parts[i + 1]) for i in range(0, len(parts) - 1, 2)]
        parts = paired + parts[len(parts) - len(parts) % 2:]
    return parts[0]


def fold_reduce_merge(stack, merge_fn: Callable):
    """Sequential left fold over the replica axis in order 0..R-1,
    bit-matching the scalar ``for w in witnesses: merged.merge(w)``
    (`test/orswot.rs:53-56`)."""
    acc = _take(stack, 0)
    for i in range(1, tree_leaves(stack)[0].shape[0]):
        acc = merge_fn(acc, _take(stack, i))
    return acc


# -- ORSWOT --------------------------------------------------------------------


def _planes(batch) -> tuple:
    return tuple(getattr(batch, name) for name in PLANES)


def _orswot_pair_merge(a, b, m_cap: int, d_cap: int, impl: str | None = None):
    """Pairwise merge over state 5-tuples; returns ``(state5, overflow)``.
    On a CUDA tensor this is the merge kernel."""
    *state, overflow = orswot_ops.merge(*a, *b, m_cap, d_cap, impl=impl)
    return tuple(state), overflow


def shard_local_merge_fn(mesh, axis: str, m_cap: int, d_cap: int, impl: str | None = None):
    """The pairwise merge of this rank's shards of ``axis``, over state
    5-tuples: ``(sa, sb) -> (state5, overflow)``.  Objects are
    independent, so it issues no collective."""
    return functools.partial(_orswot_pair_merge, m_cap=m_cap, d_cap=d_cap, impl=impl)


def shard_local_pairwise_merge(a, b, mesh, axis: str = "objects", impl: str | None = None):
    """Pairwise ORSWOT merge of two object-sharded batches
    (:func:`~.mesh.shard_batch`) with no collective at all: each rank
    merges its own object shard.  Returns ``(merged_state5, overflow)``
    for this rank's shard."""
    merge = shard_local_merge_fn(mesh, axis, a.ids.shape[-1], a.d_ids.shape[-1], impl)
    return merge(_planes(a), _planes(b))


def _fold_orswot_stack(stack5, m_cap: int, d_cap: int, impl: str | None = None):
    """Canonical left fold over a replica-stacked ORSWOT 5-tuple (leading
    axis R), ORing capacity overflow across every pairwise merge: the
    pairwise loop of ``orswot_ops.fold_merge_sequential``, no plunger."""
    out = orswot_ops.fold_merge_sequential(*stack5, m_cap, d_cap, plunger=False, impl=impl)
    return out[:5], out[5]


def gather_fold_orswot(local, group, m_cap: int, d_cap: int, impl: str | None = None):
    """The ORSWOT join across ``group``: all-gather each of the five
    planes, then fold in group-rank order 0..k-1 (k is the gather's
    leading axis, never a caller's count, so a wrong count cannot
    truncate the fold).

    ``local``: this rank's 5 planes (no replica axis).  Returns
    ``(state5, overflow)``, overflow the OR of every pairwise merge's
    flags, the same on every rank of ``group``."""
    return _fold_orswot_stack(tuple(_gather(x, group) for x in local), m_cap, d_cap, impl)


def allgather_join_orswot(batch, mesh, axis: str = "replicas", check: bool = True,
                          impl: str | None = None, object_axis: str | None = None):
    """All-reduce ORSWOT state across a mesh axis with merge as the
    combiner; the result is the same on every rank and bit-equal to the
    scalar left fold in group-rank order.

    ``batch``: this rank's :class:`OrswotBatch` replica.  Raises
    :class:`~crdt_tpu_torch.error.CapacityOverflowError` on capacity
    overflow when ``check``.

    ``object_axis``: the objects are sharded over this second mesh axis
    (the multi-host layout, :mod:`.multihost`), and each rank joins its
    object shard.  The overflow flags then collapse to one, MAX-reduced
    over that axis, so every rank takes the same raise or no-raise
    branch: a rank that raised alone would leave its peers waiting at
    their next collective."""
    lead = batch.ids.dim() == 3
    m_cap, d_cap = batch.ids.shape[-1], batch.d_ids.shape[-1]
    local = tuple(_local(x, lead) for x in _planes(batch))
    acc, overflow = gather_fold_orswot(local, mesh.get_group(axis), m_cap, d_cap, impl)
    over = overflow.any(dim=0)
    if object_axis is not None:
        # one flag for both axes, as JAX's pmax of ``any(over)``: the
        # regrow after a raise is global anyway
        flag = over.any().to(torch.uint8).reshape(1)
        group = mesh.get_group(object_axis)
        _check_backend(group, flag)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        over = flag.bool().expand(2)
    if check:
        raise_for_overflow(over, "collective join")
    return OrswotBatch(*(x[None] if lead else x for x in acc))


# -- Map -----------------------------------------------------------------------


def allgather_join_map(batch, mesh, axis: str = "replicas", check: bool = True):
    """All-reduce Map state across a mesh axis with the recursive
    reset-remove merge (`src/map.rs:192-269`) as the combiner, under
    :func:`allgather_join_orswot`'s contract: every leaf of
    ``batch.state``, the nested value state included, is gathered in one
    order on every rank and folded in group-rank order through the
    batch's value kernel (a nested ORSWOT through the merge kernel on the
    card).  Raises ``ValueError`` on any overflow when ``check``."""
    lead = batch.clock.dim() == 3
    group = mesh.get_group(axis)
    stack = tree_map(lambda x: _gather(_local(x, lead), group), batch.state)
    acc, overflow = _take(stack, 0), None
    for i in range(1, stack[0].shape[0]):
        acc, over = batch.kernel.merge(acc, _take(stack, i))
        overflow = over if overflow is None else overflow | over
    if check and overflow is not None and bool(overflow.any()):
        raise ValueError("Map collective join overflow: raise key/deferred/value capacities")
    return MapBatch.from_state(tree_map(lambda x: x[None] if lead else x, acc), batch.kernel)


# -- LWWReg / MVReg / GSet -------------------------------------------------------


def allgather_join_lww(batch, mesh, axis: str = "replicas", check: bool = True):
    """All-reduce LWW register state across a mesh axis: gather ``(vals,
    markers)`` and left-fold them in group-rank order with the pairwise
    rule (`src/lwwreg.rs:43-67`).  A prefix fold, not an argmax: the
    scalar N-way join errs on any pairwise equal-marker conflict on its
    way (markers ``[5, 5, 9]`` with different values conflict at step 1
    though the maximum is unique), so the fold replays that walk.

    Returns ``(joined, conflict_bitmap)``; when ``check``, raises
    :class:`~crdt_tpu_torch.error.ConflictingMarker` if any register hit
    an equal-marker, different-value pair in the fold."""
    lead = batch.vals.dim() == 2
    group = mesh.get_group(axis)
    vals, markers = (_gather(_local(x, lead), group) for x in (batch.vals, batch.markers))
    acc_v, acc_m = vals[0], markers[0]
    conflict = torch.zeros(acc_v.shape, dtype=torch.bool, device=acc_v.device)
    for i in range(1, vals.shape[0]):
        acc_v, acc_m, c = lww_ops.merge(acc_v, acc_m, vals[i], markers[i])
        conflict |= c
    if check and bool(conflict.any()):
        idx = torch.nonzero(conflict)[:, 0]
        raise ConflictingMarker(f"{idx.shape[0]} conflicting marker(s) in collective join, "
                                f"first at {int(idx[0])}")
    if lead:
        acc_v, acc_m, conflict = acc_v[None], acc_m[None], conflict[None]
    return LWWRegBatch(acc_v, acc_m), conflict


def allgather_join_mvreg(batch, mesh, axis: str = "replicas", check: bool = True):
    """All-reduce MVReg antichain state across a mesh axis: gather
    ``(clocks, vals)`` and left-fold them in group-rank order with the
    keep-mutually-undominated merge (`src/mvreg.rs:121-153`), re-packed
    to K slots at each step.  Raises
    :class:`~crdt_tpu_torch.error.CapacityOverflowError` past
    ``mv_capacity`` when ``check``."""
    lead = batch.clocks.dim() == 4
    group = mesh.get_group(axis)
    clocks, vals = (_gather(_local(x, lead), group) for x in (batch.clocks, batch.vals))
    kernel, acc = batch._kernel(), (clocks[0], vals[0])
    overflow = torch.zeros(clocks.shape[1:2], dtype=torch.bool, device=clocks.device)
    for i in range(1, clocks.shape[0]):
        acc, over = _chunked_merge(kernel, acc, (clocks[i], vals[i]))
        overflow |= over
    if check and bool(overflow.any()):
        raise CapacityOverflowError(
            "MVReg collective-join antichain overflow: raise CrdtConfig.mv_capacity",
            member=True, deferred=False)
    return MVRegBatch(*(x[None] if lead else x for x in acc))


def allgather_join_gset(batch, mesh, axis: str = "replicas"):
    """Global GSet join across a mesh axis: union has no order
    sensitivity (`src/gset.rs:30-34`), so it is the clock join of the
    membership bitmap as ``uint8`` (max is OR)."""
    lead = batch.bits.dim() == 3
    bits = batch.bits.to(torch.uint8)
    joined = all_reduce_clock_join(bits if lead else bits[None], mesh, axis).bool()
    return GSetBatch(bits=joined if lead else joined[0])


# -- fleet telemetry -----------------------------------------------------------


def allgather_fleet_snapshots(observatory):
    """Aggregate fleet telemetry across every rank of the process group,
    with no network peers to gossip with: every rank
    encodes its observatory's merged snapshot frame (versioned and
    CRC-guarded, so a skewed rank fails at decode), the frames' lengths
    and then the frames padded to the longest are all-gathered as CPU
    tensors (so over gloo, whatever backend carries the planes), and
    every rank folds every frame in rank order.  The snapshot merge is a
    join, so every rank ends with the same fleet view, its own echoed
    frame absorbed as a no-op.

    Returns the merged :class:`~crdt_tpu_torch.obs.fleet.FleetSnapshot`;
    with one process it is the local capture and merge."""
    frame = observatory.encode()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return observatory.merged(refresh=False)
    group = dist.group.WORLD
    sizes = _gather(torch.tensor(len(frame), dtype=torch.int64), group).tolist()
    buf = torch.zeros(max(sizes), dtype=torch.uint8)
    buf[:len(frame)] = torch.frombuffer(bytearray(frame), dtype=torch.uint8)
    for row, size in zip(_gather(buf, group), sizes):
        observatory.merge_frame(row[:size].numpy().tobytes())
    return observatory.merged(refresh=False)


# -- anti-entropy to fixpoint --------------------------------------------------


def anti_entropy(stack, max_rounds: int = 3, check: bool = True, impl: str | None = None):
    """Converge a replica-stacked :class:`OrswotBatch` (leading axis R) to
    its fixpoint on one device: left-fold-join the replicas in order
    0..R-1 (bit-parity with the scalar N-way join), then self-merge (the
    "defer plunger") until the state stops changing or ``max_rounds`` is
    reached.  Returns ``(merged, rounds_used)``, the fold counted as
    round 1.

    Deferred removes make one pass insufficient in general: a remove
    buffered under a future clock applies only once the joined clock
    covers it (`src/orswot.rs:195-211`).

    Capacity overflow across every merge accumulates on the device and is
    raised once at the end when ``check``: one host sync per round (the
    fixpoint test over the five planes), not one per merge.  On the card
    every merge, of the fold and of each round, is the merge kernel."""
    m_cap, d_cap = stack.ids.shape[-1], stack.d_ids.shape[-1]
    acc, over = _fold_orswot_stack(_planes(stack), m_cap, d_cap, impl)
    overflow = over.any(dim=0)
    rounds = 1
    for _ in range(max_rounds - 1):
        nxt, over = _orswot_pair_merge(acc, acc, m_cap, d_cap, impl)
        overflow |= over.any(dim=0)
        same = bool(torch.stack([(x == y).all() for x, y in zip(nxt, acc)]).all())
        acc, rounds = nxt, rounds + 1
        if same:
            break
    if check:
        raise_for_overflow(overflow, "anti-entropy")
    return OrswotBatch(*acc), rounds
