"""Batched ``CmRDT::apply``: fold op batches into the dense planes.

The port of the JAX package's ``oplog/apply.py``.
Ready adds scatter-max their dots into the set clock and planned member
slots, then one deferred replay ends them as the scalar ``apply`` does
(`orswot.rs:78`); removes run ``apply_remove`` (`orswot.rs:195-211`) in
rounds of at most one per object; an add whose dot does not extend its
actor's run on its object parks until its predecessors land.  The host
plans on numpy columns and reads from the device only ``clock[obj,
actor]`` and the touched id rows; the folds are torch ops on the device.  Under a
profiler a call is an ``oplog/apply`` span over its phases
(``oplog/partition``, ``plan_slots``, ``fold_adds``, ``deferred_replay``,
``removes`` with one ``remove_round`` a round).

Counter and LWW planes have folds of their own
(:func:`apply_gcounter_ops`, :func:`apply_pncounter_ops`,
:func:`apply_lww_ops`) with no causal buffering: a counter dot carries
its actor's cumulative total and an LWW write its marker, so one
scatter-max (or per-register winner) absorbs any delivery order and any
re-delivery.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..dtypes import EMPTY, as_counters, counters_to_numpy, zero_of
from ..error import CapacityOverflowError, ConflictingMarker, OpLogOverflowError
from ..ops.orswot_ops import _apply_deferred
from ..utils.tracing import span
from .records import OP_ADD, OP_DEC, OP_INC, OP_RM, OP_SET, OpBatch, opbatch_nbytes

#: member-id sentinel of an idle row in a remove round: it matches no
#: member slot (ids >= 0, empty slots EMPTY = -1) and no deferred row,
#: and rides the zero clock (never ahead), so the row is left as it was
_RM_IDLE = -2


@dataclasses.dataclass
class ApplyReport:
    """What one ``apply_ops`` call did with its batch."""

    ops: int = 0               # ops handed in (incoming + released parks)
    applied_adds: int = 0
    applied_rms: int = 0
    duplicates: int = 0        # adds the local clock already witnessed
    parked: int = 0            # adds newly parked on a causal gap
    released: int = 0          # previously parked adds applied this call
    still_parked: int = 0      # park-buffer depth after this call
    rm_rounds: int = 0         # remove rounds (max removes per object)
    merge_steps: int = 0       # add scatter-folds (1 per call with ready adds)

    @property
    def applied(self) -> int:
        return self.applied_adds + self.applied_rms


def _scatter_max(plane: torch.Tensor, lin: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``plane`` with ``vals`` max-scattered at flat indices ``lin`` (a
    new tensor; the biased order is the unsigned one, so max is the
    lattice join)."""
    return plane.reshape(-1).scatter_reduce(0, lin, vals, "amax").view_as(plane)


class OpApplier:
    """Fold :class:`OpBatch`\\ es into one ORSWOT fleet, parking causal
    gaps: one instance owns one fleet's park buffer, so reuse it across
    calls.  ``counts`` sums every call's report (plain integers)."""

    def __init__(self, universe, park_capacity: int = 1 << 16):
        if park_capacity < 1:
            raise ValueError(f"park_capacity {park_capacity} < 1")
        self.universe = universe
        self.park_capacity = park_capacity
        self._parked: OpBatch = OpBatch.empty()
        self.counts = dict.fromkeys(("ops", "applied", "duplicates", "parked", "released",
                                     "rm_rounds"), 0)

    @property
    def parked(self) -> OpBatch:
        """The currently parked (causally gapped) adds."""
        return self._parked

    def occupancy(self) -> dict:
        """Parked adds against ``park_capacity``, and their column bytes."""
        return {"ops": len(self._parked), "capacity": self.park_capacity,
                "bytes": opbatch_nbytes(self._parked)}

    def prune(self, droppable) -> Tuple[int, int]:
        """Shed parked adds flagged by ``droppable(batch) -> bool[B]``.
        Returns ``(ops_dropped, bytes_reclaimed)``.  Callers serialise it
        against :meth:`apply_ops`: the buffer has no lock of its own."""
        parked = self._parked
        if not len(parked):
            return 0, 0
        mask = np.asarray(droppable(parked), dtype=bool)
        if mask.shape != (len(parked),):
            raise ValueError(f"droppable mask has shape {mask.shape}, expected ({len(parked)},)")
        kept = parked.select(~mask)
        self._parked = kept
        return int(mask.sum()), opbatch_nbytes(parked) - opbatch_nbytes(kept)

    # -- the readiness partition ------------------------------------------------

    @staticmethod
    def _partition_adds(base: np.ndarray, num_actors: int, ops: OpBatch):
        """``(ready, dup, gap)`` masks over an all-adds batch, given each
        op's unsigned ``base = clock[obj, actor]``.  Duplicate: witnessed
        (`orswot.rs:71-73`) or earlier in the batch.  Ready: the distinct
        pending counters ``u_0 < u_1 < ...`` of an ``(obj, actor)`` group
        satisfy ``u_i == base + i + 1``.  Gapped otherwise."""
        b = len(ops)
        key = ops.obj * np.int64(num_actors + 1) + ops.actor.astype(np.int64)
        order = np.lexsort((ops.counter, key))
        sk, sc, sb = key[order], ops.counter[order], base[order]
        new_group = np.ones(b, bool)
        new_group[1:] = sk[1:] != sk[:-1]
        start_of = np.nonzero(new_group)[0][np.cumsum(new_group) - 1]
        dup_sorted = sc <= sb
        dup_sorted[1:] |= ~new_group[1:] & (sc[1:] == sc[:-1])
        # rank among the distinct not-yet-witnessed dots of the group
        nd = (~dup_sorted).astype(np.int64)
        cnd = np.cumsum(nd)
        prior = cnd - nd - (cnd[start_of] - nd[start_of])
        ready_sorted = ~dup_sorted & (sc == sb + (prior + 1).astype(np.uint64))
        ready, dup = np.zeros(b, bool), np.zeros(b, bool)
        ready[order] = ready_sorted
        dup[order] = dup_sorted
        return ready, dup, ~ready & ~dup

    # -- the folds ----------------------------------------------------------------

    @staticmethod
    def _plan_slots(batch, ops: OpBatch):
        """Member slots for a ready-add batch: each unique ``(obj,
        member)`` pair keeps its slot or takes its object's next free one
        (new members in ascending-id order), reading only the touched id
        rows.  Returns ``(op_slot, pair_obj, pair_slot, pair_member)``;
        raises :class:`~crdt_tpu_torch.error.CapacityOverflowError` when
        new members outgrow the free slots."""
        uniq, inv = np.unique(ops.obj * np.int64(1 << 32) + ops.member.astype(np.int64),
                              return_inverse=True)
        uo = uniq >> 32
        um = (uniq & ((1 << 32) - 1)).astype(np.int32)
        rows = batch.ids[torch.as_tensor(uo, device=batch.device)].cpu().numpy()  # [P, M]
        hit = rows == um[:, None]
        have = hit.any(axis=1)
        slot = np.where(have, hit.argmax(axis=1), -1).astype(np.int64)
        miss = np.nonzero(~have)[0]
        if miss.size:
            mo = uo[miss]
            # the k-th new member of an object takes its k-th free slot
            _, first, o_inv = np.unique(mo, return_index=True, return_inverse=True)
            rank = np.arange(mo.shape[0]) - np.searchsorted(mo, mo)
            o_inv = o_inv.reshape(-1)
            free = rows[miss[first]] == EMPTY  # [Q, M]
            if bool((rank >= free.sum(axis=1)[o_inv]).any()):
                raise CapacityOverflowError(
                    "Orswot capacity overflow in apply_ops: new members exceed free slots "
                    "— raise member_capacity", member=True, deferred=False)
            slot[miss] = np.argsort(~free, axis=1, kind="stable")[o_inv, rank]
        return slot[inv.reshape(-1)], uo, slot, um

    def _fold_adds(self, batch, ops: OpBatch):
        """One scatter-fold of the ready adds, then one deferred replay
        when the fleet holds any deferred row (the scalar ``apply`` tail,
        `orswot.rs:78`; without one the replay is a no-op)."""
        with span("oplog/plan_slots"):
            op_slot, po, pslot, pm = self._plan_slots(batch, ops)
        dev = batch.device
        m, a = batch.member_capacity, batch.clock.shape[1]

        def col(x):
            return torch.as_tensor(x, dtype=torch.int64, device=dev)

        with span("oplog/fold_adds"):
            oo, oa, os_ = col(ops.obj), col(ops.actor), col(op_slot)
            oc = as_counters(ops.counter, batch.clock.dtype, dev)
            clock = _scatter_max(batch.clock, oo * a + oa, oc)
            ids = _scatter_max(batch.ids, col(po) * m + col(pslot),
                               torch.as_tensor(pm, dtype=torch.int32, device=dev))
            dots = _scatter_max(batch.dots, (oo * m + os_) * a + oa, oc)
        d_ids, d_clocks = batch.d_ids, batch.d_clocks
        with span("oplog/deferred_replay"):
            if bool((d_ids != EMPTY).any()):
                ids, dots, d_ids, d_clocks = _apply_deferred(clock, ids, dots, d_ids, d_clocks)
        return type(batch)(clock, ids, dots, d_ids, d_clocks)

    @staticmethod
    def _fold_removes(batch, ops: OpBatch, check: bool, report: ApplyReport):
        """``apply_remove`` in rounds: round ``k`` carries each object's
        ``k``-th remove (batch order), put with ``index_put_`` over rows of
        :data:`_RM_IDLE` and the biased zero."""
        n, a = batch.clock.shape
        dev, dt = batch.device, batch.clock.dtype
        order = np.lexsort((np.arange(len(ops)), ops.obj))
        so = ops.obj[order]
        new_obj = np.ones(len(ops), bool)
        new_obj[1:] = so[1:] != so[:-1]
        rounds = np.arange(len(ops)) - np.nonzero(new_obj)[0][np.cumsum(new_obj) - 1]
        clocks = (ops.rm_clocks if ops.rm_clocks is not None
                  else np.zeros((len(ops), a), np.uint64))
        obj = torch.as_tensor(ops.obj, device=dev)
        mem = torch.as_tensor(ops.member, device=dev)
        rm = as_counters(clocks, dt, dev)
        for k in range(int(rounds.max(initial=-1)) + 1):
            with span("oplog/remove_round"):
                sel = torch.as_tensor(order[rounds == k], device=dev)
                member = torch.full((n,), _RM_IDLE, dtype=torch.int32, device=dev)
                member.index_put_((obj[sel],), mem[sel])
                rm_clock = torch.full((n, a), zero_of(dt), dtype=dt, device=dev)
                rm_clock.index_put_((obj[sel],), rm[sel])
                batch = batch.apply_remove(rm_clock, member, check=check)
            report.rm_rounds += 1
        return batch

    # -- the entry point ------------------------------------------------------------

    def apply_ops(self, batch, ops: OpBatch, check: bool = True):
        """``(folded_batch, report)``: fold ``ops`` and the parked adds
        whose gaps closed into ``batch`` (left as it was).  Raises
        :class:`~crdt_tpu_torch.error.CapacityOverflowError` past the
        capacities, :class:`~crdt_tpu_torch.error.OpLogOverflowError` when
        the park buffer fills.  Re-delivery of applied ops is a no-op."""
        with span("oplog/apply"):
            return self._apply_ops(batch, ops, check)

    def _apply_ops(self, batch, ops: OpBatch, check: bool):
        report = ApplyReport()
        with span("oplog/partition"):
            parked, self._parked = self._parked, OpBatch.empty()
            ops = OpBatch.concat([parked, ops])
            report.ops = len(ops)
            if len(ops) == 0:
                return batch, report
            is_add, is_rm = ops.kind == OP_ADD, ops.kind == OP_RM
            if not bool((is_add | is_rm).all()):
                raise ValueError("OpApplier folds ORSWOT add/rm ops; counter and LWW ops "
                                 "have planes of their own")
            num_actors = self.universe.config.num_actors
            ops.validate(batch.clock.shape[0], num_actors)

            adds = ops.select(is_add)
            dev = batch.device
            base = counters_to_numpy(batch.clock[
                torch.as_tensor(adds.obj, device=dev),
                torch.as_tensor(adds.actor, dtype=torch.int64, device=dev)])
            ready, dup, gap = self._partition_adds(base.astype(np.uint64), num_actors, adds)
            report.duplicates = int(dup.sum())
            # the parked adds were concatenated first: released = those that
            # left the gap set, parked = fresh arrivals that entered it
            n_parked_in = len(parked)
            report.released = n_parked_in - int(gap[:n_parked_in].sum())
            report.parked = int(gap[n_parked_in:].sum())
            if bool(gap.any()):
                gapped = adds.select(gap)
                if len(gapped) > self.park_capacity:
                    raise OpLogOverflowError(
                        f"causal-gap buffer full: {len(gapped)} gapped adds > park_capacity "
                        f"{self.park_capacity} — the missing predecessor dots never arrived")
                self._parked = gapped
            report.still_parked = len(self._parked)

        if bool(ready.any()):
            ready_ops = adds.select(ready)
            batch = self._fold_adds(batch, ready_ops)
            report.merge_steps += 1
            report.applied_adds = len(ready_ops)
        if bool(is_rm.any()):
            rms = ops.select(is_rm)
            with span("oplog/removes"):
                batch = self._fold_removes(batch, rms, check, report)
            report.applied_rms = len(rms)

        for k in ("ops", "applied", "duplicates", "parked", "released", "rm_rounds"):
            self.counts[k] += getattr(report, k)
        return batch, report


# -- counter and LWW folds ------------------------------------------------------


def _in_range(ops: OpBatch, n: int, a: int | None = None) -> None:
    """Raise ``ValueError`` for an op row (or, given ``a``, an actor)
    outside the planes: a device scatter has no out-of-range mode."""
    bad = ops.obj.min() < 0 or ops.obj.max() >= n
    if a is not None:
        bad = bad or ops.actor.min() < 0 or ops.actor.max() >= a
    if bad:
        raise ValueError(f"op object or actor outside the planes [0, {n}) x [0, {a})")


def _fold_dots(plane: torch.Tensor, ops: OpBatch, lin: np.ndarray) -> torch.Tensor:
    return _scatter_max(plane, torch.from_numpy(lin).to(plane.device),
                        as_counters(ops.counter, plane.dtype, plane.device))


def apply_gcounter_ops(batch, ops: OpBatch):
    """Fold ``inc`` dots into a ``GCounterBatch``: one scatter-max
    (`gcounter.rs:71-73`: the op is a dot, the apply a witness)."""
    if bool((ops.kind != OP_INC).any()):
        raise ValueError("apply_gcounter_ops folds inc ops only "
                         "(a GCounter cannot decrement, gcounter.rs:14)")
    if len(ops) == 0:
        return batch
    n, a = batch.clocks.shape
    _in_range(ops, n, a)
    return type(batch)(_fold_dots(batch.clocks, ops, ops.obj * a + ops.actor))


def apply_pncounter_ops(batch, ops: OpBatch):
    """Fold ``inc``/``dec`` dots into a ``PNCounterBatch``: the kind picks
    the P or N plane (`pncounter.rs:65-78`), one scatter-max."""
    if not bool(np.isin(ops.kind, np.asarray([OP_INC, OP_DEC], np.uint8)).all()):
        raise ValueError("apply_pncounter_ops folds inc/dec ops only")
    if len(ops) == 0:
        return batch
    n, _, a = batch.planes.shape
    _in_range(ops, n, a)
    plane = (ops.kind == OP_DEC).astype(np.int64)
    return type(batch)(_fold_dots(batch.planes, ops, (ops.obj * 2 + plane) * a + ops.actor))


def apply_lww_ops(batch, ops: OpBatch, check: bool = True):
    """Fold LWW writes — ``(marker, payload id)`` in the ``(counter,
    member)`` columns — into an ``LWWRegBatch``: per register the highest
    marker wins (`lwwreg.rs:56-66`), an exact re-delivery changes nothing.
    Equal markers with different values, in the batch or against the
    register, raise :class:`ConflictingMarker` when ``check``; with
    ``check=False`` the result is ``(batch, conflict bitmap)`` (numpy).
    The winners are chosen on the host; only their registers' current
    ``(val, marker)`` are read from the device, in one gather."""
    if bool((ops.kind != OP_SET).any()):
        raise ValueError("apply_lww_ops folds set ops only")
    n = batch.vals.shape[0]
    if len(ops) == 0:
        return batch if check else (batch, np.zeros(n, bool))
    _in_range(ops, n)
    # per register the lexicographic (marker, val) max: a total order, so
    # the pick does not depend on the delivery order
    order = np.lexsort((ops.member, ops.counter, ops.obj))
    so, sm, sv = ops.obj[order], ops.counter[order], ops.member[order].astype(np.uint64)
    last = np.ones(len(ops), bool)
    last[:-1] = so[:-1] != so[1:]
    clash = np.zeros(len(ops), bool)
    clash[:-1] = (so[:-1] == so[1:]) & (sm[:-1] == sm[1:]) & (sv[:-1] != sv[1:])
    w_obj, w_marker, w_val = so[last], sm[last], sv[last]
    rows = torch.from_numpy(w_obj).to(batch.vals.device)
    cur = torch.stack([batch.vals[rows], batch.markers[rows] ^ zero_of(torch.int64)])
    cur_v, cur_m = cur.cpu().numpy().view(np.uint64)
    newer = w_marker > cur_m
    # the conflicting registers, ascending: in the batch, or against the register
    bad = np.unique(np.concatenate([so[clash], w_obj[(w_marker == cur_m) & (w_val != cur_v)]]))
    if check and bad.size:
        raise ConflictingMarker(f"{bad.size} conflicting marker(s) in op fold, "
                                f"first at {int(bad[0])}")
    take = rows[torch.from_numpy(newer).to(rows.device)]
    out = type(batch)(
        vals=batch.vals.index_put((take,), torch.from_numpy(w_val[newer].view(np.int64)).to(
            take.device)),
        markers=batch.markers.index_put((take,), as_counters(w_marker[newer], torch.int64,
                                                             take.device)))
    if check:
        return out
    conflict = np.zeros(n, bool)
    conflict[bad] = True
    return out, conflict
