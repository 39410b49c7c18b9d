"""OrswotBatch — N add-wins OR-sets on the device.

Dense form of `orswot.rs:26-30`: the set clock, member-slot tables
(interned ids + per-member dot clocks) and a deferred-remove table, as
five tensors.  Counter planes are held biased in the signed type of
their width (:mod:`crdt_tpu_torch.dtypes`); :meth:`OrswotBatch.from_numpy`
and :meth:`OrswotBatch.to_numpy` apply and remove the bias, and take and
give the JAX package's numpy planes (``uint32`` or ``uint64``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import counter_dtype
from ..device import resolve_device
from ..dtypes import EMPTY, bias_np, counters_to_numpy, to_device, zero_of
from ..error import raise_for_overflow
from ..ops import orswot_ops


def _np_planes(n, cfg):
    """Empty unsigned numpy planes ``(clock, ids, dots, d_ids, d_clocks)``."""
    a, m, d = cfg.num_actors, cfg.member_capacity, cfg.deferred_capacity
    dt = counter_dtype(cfg)
    return (
        np.zeros((n, a), dtype=dt),
        np.full((n, m), EMPTY, dtype=np.int32),
        np.zeros((n, m, a), dtype=dt),
        np.full((n, d), EMPTY, dtype=np.int32),
        np.zeros((n, d, a), dtype=dt),
    )


def scalar_planes(states: Sequence, universe):
    """Unsigned numpy planes ``(clock, ids, dots, d_ids, d_clocks)`` of
    scalar ORSWOT states (anything with ``.clock.dots``, ``.entries`` and
    ``.deferred`` as the reference engine lays them out).  Actors and
    members are interned in the same order as the JAX package's
    ``OrswotBatch.from_scalar``, so two universes fed the same states
    agree on every id; member slots keep each state's entry order."""
    cfg = universe.config
    n = len(states)
    m, d = cfg.member_capacity, cfg.deferred_capacity
    clock, ids, dots, d_ids, d_clocks = _np_planes(n, cfg)
    aidx = universe.actors.intern
    midx = universe.members.intern
    for i, s in enumerate(states):
        try:
            cd = s.clock.dots
            ents = s.entries
            deferred = s.deferred
        except AttributeError as e:
            raise TypeError(
                f"object {i}: malformed scalar state ({type(s).__name__}: {e})"
            ) from None
        for actor, c in zip(list(map(aidx, cd)), cd.values()):
            clock[i, actor] = c
        if len(ents) > m:
            raise ValueError(f"object {i}: {len(ents)} members > member_capacity {m}")
        ids[i, : len(ents)] = list(map(midx, ents))
        for slot, vc in enumerate(ents.values()):
            vd = vc.dots
            for actor, c in zip(list(map(aidx, vd)), vd.values()):
                dots[i, slot, actor] = c
        nrows = sum(len(members) for members in deferred.values())
        if nrows > d:
            raise ValueError(f"object {i}: {nrows} deferred rows > deferred_capacity {d}")
        row = 0
        for ck, members in deferred.items():
            cols = [(aidx(actor), counter) for actor, counter in ck]
            for member in members:
                d_ids[i, row] = midx(member)
                for actor, c in cols:
                    d_clocks[i, row, actor] = c
                row += 1
    return clock, ids, dots, d_ids, d_clocks


def _cells(clock, ids, dots, d_ids, d_clocks):
    """The populated cells of unsigned host planes, in row-major order:
    set-clock ``(obj, actor, value)``, entries ``(obj, slot, id)``, entry
    dots ``(obj, slot, actor, value)``, deferred ids ``(obj, row, id)``
    and deferred clocks ``(obj, row, actor, value)``."""
    co, ca = np.nonzero(clock)
    eo, es = np.nonzero(ids != EMPTY)
    do, ds, da = np.nonzero(dots)
    qo, qr = np.nonzero(d_ids != EMPTY)
    ho, hr, ha = np.nonzero(d_clocks)
    return ((co, ca, clock[co, ca]), (eo, es, ids[eo, es]), (do, ds, da, dots[do, ds, da]),
            (qo, qr, d_ids[qo, qr]), (ho, hr, ha, d_clocks[ho, hr, ha]))


def _resolve_members(universe, id_array):
    """One registry lookup per unique member id of a cell column, plus the
    inverse index per cell."""
    uniq, inv = np.unique(id_array, return_inverse=True)
    member_of = universe.members.lookup
    return [member_of(int(m)) for m in uniq], inv


def scalars_of_planes(planes, universe) -> list:
    """Scalar ORSWOT states of unsigned host planes — the Python loop of
    the JAX package's ``OrswotBatch.to_scalar``: it walks the populated
    cells only, never the dense ``[N, M, A]`` volume, and inserts entries
    in slot order."""
    from ..scalar.orswot import Orswot
    from ..scalar.vclock import VClock

    n, a = planes[0].shape
    (co, ca, cv), (eo, es, em), (do, ds, da, dv), (qo, qr, qm), (ho, hr, ha, hv) = \
        _cells(*planes)
    n_interned = len(universe.actors)
    actor_name = [universe.actors.lookup(i) if i < n_interned else None for i in range(a)]
    out = [Orswot() for _ in range(n)]
    for i, aix, v in zip(co.tolist(), ca.tolist(), cv.tolist()):
        out[i].clock.dots[actor_name[aix]] = v
    uniq_names, inv = _resolve_members(universe, em)
    entry_clocks = {}
    for i, j, u in zip(eo.tolist(), es.tolist(), inv.tolist()):
        vc = VClock()
        out[i].entries[uniq_names[u]] = vc
        entry_clocks[(i, j)] = vc
    for i, j, aix, v in zip(do.tolist(), ds.tolist(), da.tolist(), dv.tolist()):
        entry_clocks[(i, j)].dots[actor_name[aix]] = v
    if qo.size:
        deferred_clocks, deferred_members = {}, {}
        d_names, d_inv = _resolve_members(universe, qm)
        for i, j, u in zip(qo.tolist(), qr.tolist(), d_inv.tolist()):
            deferred_clocks[(i, j)] = VClock()
            deferred_members[(i, j)] = d_names[u]
        for i, j, aix, v in zip(ho.tolist(), hr.tolist(), ha.tolist(), hv.tolist()):
            if (i, j) in deferred_clocks:
                deferred_clocks[(i, j)].dots[actor_name[aix]] = v
        for (i, j), vc in deferred_clocks.items():
            out[i].deferred.setdefault(vc.key(), set()).add(deferred_members[(i, j)])
    return out


def planes_to_wire(planes, universe) -> list[bytes]:
    """Wire blobs of unsigned host planes: the host codec where it
    applies, else ``to_binary`` of :func:`scalars_of_planes`."""
    from ..utils.serde import to_binary
    from .wirebulk import orswot_planes_to_wire

    blobs = orswot_planes_to_wire(*planes, universe)
    if blobs is None:
        return [to_binary(s) for s in scalars_of_planes(planes, universe)]
    return blobs


@dataclasses.dataclass
class OrswotBatch:
    clock: torch.Tensor  # int[N, A], biased
    ids: torch.Tensor  # int32[N, M] (-1 = empty)
    dots: torch.Tensor  # int[N, M, A], biased
    d_ids: torch.Tensor  # int32[N, D] (-1 = empty)
    d_clocks: torch.Tensor  # int[N, D, A], biased

    # -- construction and the package edge ---------------------------------

    @classmethod
    def zeros(cls, n: int, universe, device=None) -> "OrswotBatch":
        return cls.from_numpy(*_np_planes(n, universe.config), device=device)

    @classmethod
    def from_numpy(cls, clock, ids, dots, d_ids, d_clocks, device=None) -> "OrswotBatch":
        """Unsigned numpy planes (``uint32`` or ``uint64`` counters, int32
        ids) → a biased batch on ``device`` (default ``"cuda"``)."""
        dev = resolve_device(device)
        ids = np.asarray(ids, dtype=np.int32)
        d_ids = np.asarray(d_ids, dtype=np.int32)
        return cls(
            clock=to_device(bias_np(clock), dev),
            ids=to_device(ids, dev),
            dots=to_device(bias_np(dots), dev),
            d_ids=to_device(d_ids, dev),
            d_clocks=to_device(bias_np(d_clocks), dev),
        )

    def to_numpy(self):
        """The exact inverse of :meth:`from_numpy`: unsigned numpy planes
        ``(clock, ids, dots, d_ids, d_clocks)``."""
        return (
            counters_to_numpy(self.clock),
            self.ids.cpu().numpy(),
            counters_to_numpy(self.dots),
            self.d_ids.cpu().numpy(),
            counters_to_numpy(self.d_clocks),
        )

    @classmethod
    def from_scalar(cls, states: Sequence, universe, device=None) -> "OrswotBatch":
        """Pack scalar ORSWOT states into a batch on ``device`` (see
        :func:`scalar_planes`)."""
        return cls.from_numpy(*scalar_planes(states, universe), device=device)

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, device=None) -> "OrswotBatch":
        """Bulk ingest straight from wire blobs (``to_binary(orswot)``
        payloads, the replication format).

        With an identity universe (int actors < ``num_actors``, int32
        members) the host codec (``native/wire_ingest.cpp``) parses the
        blobs in parallel straight into dense planes; blobs outside its
        integer-keyed grammar (string members, big-int counters) are
        decoded by the scalar codec and spliced in, so
        ``from_wire(blobs, uni)`` always equals ``from_scalar([from_binary(b)
        for b in blobs], uni)``, member-slot order included (wire order).
        Any other universe takes the Python codec for the whole batch.
        A blob that does not decode, or does not fit the universe's
        capacities, raises :class:`~crdt_tpu_torch.error.WireFormatError`.
        The counters are biased into the device domain after the parse,
        by :meth:`from_numpy`."""
        from .wirebulk import orswot_planes_from_wire, planes_of_blobs

        dev = resolve_device(device)
        if len(blobs) == 0:
            return cls.zeros(0, universe, device=dev)
        planes = orswot_planes_from_wire(blobs, universe)
        if planes is None:
            planes = planes_of_blobs(blobs, universe)
        return cls.from_numpy(*planes, device=dev)

    def to_wire(self, universe) -> list[bytes]:
        """Bulk egress to wire blobs — the inverse of :meth:`from_wire`,
        byte-identical to ``[to_binary(s) for s in self.to_scalar(uni)]``.

        The counters are unbiased first (:meth:`to_numpy`); then, with an
        identity universe, the host codec encodes the planes in parallel,
        reproducing the serde codec's orderings exactly.  Counters at or
        above 2^63 (u64 planes only) and other universes take the Python
        encoder."""
        if self.clock.shape[0] == 0:
            return []
        return planes_to_wire(self.to_numpy(), universe)

    def to_scalar(self, universe) -> list:
        """The scalar ORSWOT state of every object (the port's own scalar
        engine, :mod:`crdt_tpu_torch.scalar`)."""
        return scalars_of_planes(self.to_numpy(), universe)

    # -- shape ---------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.clock.device

    @property
    def member_capacity(self) -> int:
        return self.ids.shape[-1]

    @property
    def deferred_capacity(self) -> int:
        return self.d_ids.shape[-1]

    def with_capacity(
        self, member_capacity: int | None = None, deferred_capacity: int | None = None
    ) -> "OrswotBatch":
        """Regrow the padded slot axes (elastic recovery from overflow).
        Empty slots are 'absent', so the regrown batch is the same CRDT
        state."""
        m_new = self.member_capacity if member_capacity is None else member_capacity
        d_new = self.deferred_capacity if deferred_capacity is None else deferred_capacity
        if m_new < self.member_capacity or d_new < self.deferred_capacity:
            raise ValueError("with_capacity cannot shrink (would drop live slots)")
        pad_m = m_new - self.member_capacity
        pad_d = d_new - self.deferred_capacity
        if pad_m == 0 and pad_d == 0:
            return self

        def pad_slots(x, pad, tail_axes, fill):
            shape = list(x.shape)
            shape[x.dim() - 1 - tail_axes] = pad
            return torch.cat(
                [x, torch.full(shape, fill, dtype=x.dtype, device=x.device)],
                dim=x.dim() - 1 - tail_axes,
            )

        z = zero_of(self.clock.dtype)
        return OrswotBatch(
            clock=self.clock,
            ids=pad_slots(self.ids, pad_m, 0, EMPTY),
            dots=pad_slots(self.dots, pad_m, 1, z),
            d_ids=pad_slots(self.d_ids, pad_d, 0, EMPTY),
            d_clocks=pad_slots(self.d_clocks, pad_d, 1, z),
        )

    # -- state path ------------------------------------------------------------

    def merge(self, other: "OrswotBatch", check: bool = True,
              impl: str | None = None) -> "OrswotBatch":
        """Pairwise ORSWOT merge (`orswot.rs:89-156`).  ``impl``: see
        :func:`crdt_tpu_torch.ops.orswot_ops.resolve_merge_impl`."""
        clock, ids, dots, d_ids, d_clocks, overflow = orswot_ops.merge(
            self.clock, self.ids, self.dots, self.d_ids, self.d_clocks,
            other.clock, other.ids, other.dots, other.d_ids, other.d_clocks,
            self.member_capacity, self.deferred_capacity, impl=impl,
        )
        if check:
            raise_for_overflow(overflow, "merge")
        return OrswotBatch(clock=clock, ids=ids, dots=dots, d_ids=d_ids, d_clocks=d_clocks)

    @classmethod
    def join_fleet(cls, fleets: Sequence["OrswotBatch"], check: bool = True,
                   plunger: bool = True, impl: str | None = None) -> "OrswotBatch":
        """N-way anti-entropy join of replica fleets holding the same
        objects: stack them and reduce as a pairwise tree
        (:func:`~crdt_tpu_torch.ops.orswot_ops.fold_merge_tree`), then the
        optional defer plunger."""
        if len(fleets) == 0:
            raise ValueError("join_fleet needs at least one fleet")
        if len(fleets) == 1:
            f = fleets[0]
            return f.merge(f, check=check, impl=impl) if plunger else f
        stacked = [
            torch.stack([getattr(f, name) for f in fleets])
            for name in ("clock", "ids", "dots", "d_ids", "d_clocks")
        ]
        clock, ids, dots, d_ids, d_clocks, overflow = orswot_ops.fold_merge_tree(
            *stacked, fleets[0].member_capacity, fleets[0].deferred_capacity,
            plunger=plunger, impl=impl,
        )
        if check:
            raise_for_overflow(overflow, "join_fleet")
        return cls(clock=clock, ids=ids, dots=dots, d_ids=d_ids, d_clocks=d_clocks)

    # -- reads -------------------------------------------------------------------

    def contains(self, member_id):
        """Membership bitmap (`orswot.rs:214-224`)."""
        mid = torch.as_tensor(member_id, dtype=torch.int32, device=self.device)
        return orswot_ops.contains(self.ids, mid)

    def member_count(self):
        return (self.ids != EMPTY).sum(dim=-1)

    def value_sets(self, universe) -> list[set]:
        """``value()`` per object (`orswot.rs:227-233`)."""
        lookup = universe.members.lookup
        return [{lookup(int(x)) for x in row if x != EMPTY} for row in self.ids.cpu().tolist()]
