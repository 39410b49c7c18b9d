"""OrswotBatch — N add-wins OR-sets on the device.

Dense form of `orswot.rs:26-30`: the set clock, member-slot tables
(interned ids + per-member dot clocks) and a deferred-remove table, as
five tensors.  Counter planes are held biased in the signed type of
their width (:mod:`crdt_tpu_torch.dtypes`); :meth:`OrswotBatch.from_numpy`
and :meth:`OrswotBatch.to_numpy` apply and remove the bias, and take and
give the JAX package's numpy planes (``uint32`` or ``uint64``).

Dense planes or COO columns: ``from_scalar``, ``from_wire`` and
``to_scalar`` take ``via_device`` (default: True when the batch lives
on a CUDA device), the JAX package's switch between copying dense
planes and copying compact columns that the device expands or compacts
(:meth:`OrswotBatch.from_coo`, :meth:`OrswotBatch.to_coo`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import counter_dtype
from ..device import resolve_device
from ..dtypes import (
    EMPTY, INT32_MAX, as_counters, bias_np, counters_to_numpy, to_device, torch_counter_dtype,
    zero_of,
)
from ..error import CapacityOverflowError, raise_for_overflow
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


def _obj_slot(counts):
    """(object, within-object slot) columns for rows laid out object-major
    with ``counts`` rows per object."""
    obj = np.repeat(np.arange(counts.shape[0]), counts)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return obj, np.arange(obj.shape[0]) - starts


def scalar_cells(states: Sequence, universe):
    """The COO cells of scalar ORSWOT states, in one pass as the JAX
    package's ``from_scalar``: set clock ``(obj, actor, value)``, entries
    ``(obj, slot, id)``, entry dots ``(obj, slot, actor, value)``,
    deferred ids ``(obj, row, id)`` and clocks ``(obj, row, actor,
    value)``, unsigned.  Ids are interned in the JAX package's order;
    member slots keep each state's entry order."""
    cfg = universe.config
    n = len(states)
    m, d = cfg.member_capacity, cfg.deferred_capacity
    dt = counter_dtype(cfg)
    aidx = universe.actors.intern
    midx = universe.members.intern
    ca, cc, em, ga, gc, g_counts, qm, ha, hc, h_counts = ([] for _ in range(10))
    c_counts, e_counts, q_counts = (np.empty(n, dtype=np.int64) for _ in range(3))
    for i, s in enumerate(states):
        try:
            cd = s.clock.dots
            c_counts[i] = len(cd)
            ca.extend(map(aidx, cd))
            cc.extend(cd.values())
            ents = s.entries
            if len(ents) > m:
                raise ValueError(f"object {i}: {len(ents)} members > member_capacity {m}")
            e_counts[i] = len(ents)
            em.extend(map(midx, ents))
            for vc in ents.values():
                vd = vc.dots
                g_counts.append(len(vd))
                ga.extend(map(aidx, vd))
                gc.extend(vd.values())
            nrows = sum(len(members) for members in s.deferred.values())
            if nrows > d:
                raise ValueError(f"object {i}: {nrows} deferred rows > deferred_capacity {d}")
            q_counts[i] = nrows
            for ck, members in s.deferred.items():
                pa = [aidx(actor) for actor, _ in ck]
                pc = [counter for _, counter in ck]
                for member in members:
                    qm.append(midx(member))
                    h_counts.append(len(pa))
                    ha.extend(pa)
                    hc.extend(pc)
        except AttributeError as e:
            raise TypeError(
                f"object {i}: malformed scalar state ({type(s).__name__}: {e})"
            ) from None
    eo, es = _obj_slot(e_counts)
    qo, qs = _obj_slot(q_counts)
    g_counts = np.asarray(g_counts, dtype=np.int64)
    h_counts = np.asarray(h_counts, dtype=np.int64)
    return (
        (np.repeat(np.arange(n), c_counts), np.asarray(ca, np.int64), np.asarray(cc, dt)),
        (eo, es, np.asarray(em, np.int32)),
        (np.repeat(eo, g_counts), np.repeat(es, g_counts), np.asarray(ga, np.int64),
         np.asarray(gc, dt)),
        (qo, qs, np.asarray(qm, np.int32)),
        (np.repeat(qo, h_counts), np.repeat(qs, h_counts), np.asarray(ha, np.int64),
         np.asarray(hc, dt)),
    )


def _host_planes(n, cfg, cells, join_counters=False):
    """Unsigned numpy planes from build cells: plain assignment, or the
    lattice ``np.maximum.at`` where duplicate counter cells must join."""
    planes = _np_planes(n, cfg)
    for k, (plane, cols) in enumerate(zip(planes, cells)):
        idx, vals = tuple(np.asarray(c) for c in cols[:-1]), np.asarray(cols[-1])
        if not vals.size:
            continue
        if join_counters and k in (0, 2, 4):
            np.maximum.at(plane, idx, vals)
        else:
            plane[idx] = vals
    return planes


def scalar_planes(states: Sequence, universe):
    """Unsigned numpy planes ``(clock, ids, dots, d_ids, d_clocks)`` of
    scalar ORSWOT states (:func:`scalar_cells`)."""
    return _host_planes(len(states), universe.config, scalar_cells(states, universe))


def _build_planes(n, cfg, cells, device, via_device, join_counters=False):
    """Dense device planes from build cells (:func:`scalar_cells`).
    ``via_device`` copies only the columns and max-scatters them into the
    planes on the device, the JAX package's ``_device_expand`` (whose
    power-of-two padding only kept ``jit`` shapes static): counters join
    by max, and ids >= 0 land once on EMPTY = -1.  Otherwise the planes
    are built on the host and copied whole."""
    if not via_device:
        return OrswotBatch.from_numpy(*_host_planes(n, cfg, cells, join_counters),
                                      device=device)
    a, m, d = cfg.num_actors, cfg.member_capacity, cfg.deferred_capacity
    dt = torch_counter_dtype(cfg.counter_bits)
    z = zero_of(dt)
    planes = (torch.full((n, a), z, dtype=dt, device=device),
              torch.full((n, m), EMPTY, dtype=torch.int32, device=device),
              torch.full((n, m, a), z, dtype=dt, device=device),
              torch.full((n, d), EMPTY, dtype=torch.int32, device=device),
              torch.full((n, d, a), z, dtype=dt, device=device))
    for k, (plane, cols) in enumerate(zip(planes, cells)):
        vals = np.asarray(cols[-1])
        if not vals.size:
            continue
        lin = None
        for size, c in zip(plane.shape, cols[:-1]):
            c = to_device(np.asarray(c, dtype=np.int32), device).to(torch.int64)
            lin = c if lin is None else lin * size + c
        v = to_device(bias_np(vals) if k in (0, 2, 4) else vals.astype(np.int32), device)
        plane.view(-1).scatter_reduce_(0, lin, v, "amax", include_self=True)
    return OrswotBatch(*planes)


def _host_cells(clock, ids, dots, d_ids, d_clocks, want_entries=True):
    """The populated cells of unsigned host planes, row-major: as
    :func:`scalar_cells`, the entry dots also carrying their member id
    ``(obj, slot, id, actor, value)``; ``want_entries=False`` leaves the
    entry bundle empty."""
    co, ca = np.nonzero(clock)
    if want_entries:
        eo, es = np.nonzero(ids != EMPTY)
        entries = (eo, es, ids[eo, es])
    else:
        z = np.zeros(0, dtype=np.int64)
        entries = (z, z, np.zeros(0, dtype=ids.dtype))
    do, ds, da = np.nonzero(dots)
    qo, qr = np.nonzero(d_ids != EMPTY)
    ho, hr, ha = np.nonzero(d_clocks)
    return ((co, ca, clock[co, ca]), entries, (do, ds, ids[do, ds], da, dots[do, ds, da]),
            (qo, qr, d_ids[qo, qr]), (ho, hr, ha, d_clocks[ho, hr, ha]))


def _nonzero(mask: torch.Tensor):
    """Row-major coordinates of a device mask, one int64 column per axis,
    in object chunks under 2^31 elements (``torch.nonzero``'s CUDA limit;
    the JAX package's ``_device_nnz`` padding is not needed)."""
    n = mask.shape[0]
    step = max(1, INT32_MAX // max(1, mask[0].numel())) if n else 1
    parts = []
    for s0 in range(0, n, step):
        nz = torch.nonzero(mask[s0:s0 + step])
        nz[:, 0] += s0
        parts.append(nz)
    if not parts:
        return (torch.zeros(0, dtype=torch.int64, device=mask.device),) * mask.dim()
    return torch.cat(parts).unbind(1)


def _device_cells(clock, ids, dots, d_ids, d_clocks, want_entries=True):
    """:func:`_host_cells` of biased device planes, computed on the
    device (the JAX package's ``_device_compact``): only the columns are
    copied back, coordinates as int32, counters unbiased."""
    z = zero_of(clock.dtype)

    def host(*coords):
        return tuple(c.to(torch.int32).cpu().numpy() for c in coords)

    co, ca = _nonzero(clock != z)
    if want_entries:
        eo, es = _nonzero(ids != EMPTY)
        entries = host(eo, es) + (ids[eo, es].cpu().numpy(),)
    else:
        e = np.zeros(0, dtype=np.int32)
        entries = (e, e, e)
    do, ds, da = _nonzero(dots != z)
    qo, qr = _nonzero(d_ids != EMPTY)
    ho, hr, ha = _nonzero(d_clocks != z)
    return (host(co, ca) + (counters_to_numpy(clock[co, ca]),), entries,
            host(do, ds) + (ids[do, ds].cpu().numpy(),) + host(da)
            + (counters_to_numpy(dots[do, ds, da]),),
            host(qo, qr) + (d_ids[qo, qr].cpu().numpy(),),
            host(ho, hr, ha) + (counters_to_numpy(d_clocks[ho, hr, ha]),))


def _resolve_members(universe, id_array):
    """One registry lookup per unique member id of a cell column, plus the
    inverse index per cell."""
    uniq, inv = np.unique(id_array, return_inverse=True)
    member_of = universe.members.lookup
    return [member_of(int(m)) for m in uniq], inv


def scalars_of_cells(cells, n: int, a: int, universe) -> list:
    """Scalar ORSWOT states of ``n`` objects from their populated cells
    (:func:`_host_cells`) — the Python loop of the JAX package's
    ``OrswotBatch.to_scalar``: it walks the populated cells only, never
    the dense ``[N, M, A]`` volume, and inserts entries in slot order."""
    from ..scalar.orswot import Orswot
    from ..scalar.vclock import VClock

    (co, ca, cv), (eo, es, em), (do, ds, _dm, da, dv), (qo, qr, qm), (ho, hr, ha, hv) = cells
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
    if len(qo):
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
    applies, else ``to_binary`` of :func:`scalars_of_cells`."""
    from ..utils.serde import to_binary
    from .wirebulk import orswot_planes_to_wire

    blobs = orswot_planes_to_wire(*planes, universe)
    if blobs is None:
        n, a = planes[0].shape
        return [to_binary(s) for s in scalars_of_cells(_host_cells(*planes), n, a, universe)]
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
    def from_scalar(cls, states: Sequence, universe, device=None,
                    via_device: bool | None = None) -> "OrswotBatch":
        """Pack scalar ORSWOT states into a batch on ``device``
        (:func:`_build_planes`; ``via_device`` defaults to True on CUDA)."""
        dev = resolve_device(device)
        via = dev.type == "cuda" if via_device is None else via_device
        return _build_planes(len(states), universe.config, scalar_cells(states, universe),
                             dev, via)

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, device=None,
                  via_device: bool | None = None) -> "OrswotBatch":
        """Bulk ingest straight from wire blobs (``to_binary(orswot)``
        payloads).  With an identity universe the host codec
        (``native/wire_ingest.cpp``) parses the blobs into dense planes,
        splicing in blobs outside its grammar through the scalar codec;
        other universes take the Python codec.  A blob that does not
        decode or fit raises :class:`~crdt_tpu_torch.error.WireFormatError`.
        ``via_device`` (default: True on CUDA) is the JAX package's route:
        the planes are compacted on the host and :meth:`from_coo` expands
        the columns on the device, member slots in ascending-id order;
        otherwise the planes keep wire order and are copied whole."""
        from .wirebulk import orswot_planes_from_wire, planes_of_blobs

        dev = resolve_device(device)
        if len(blobs) == 0:
            return cls.zeros(0, universe, device=dev)
        planes = orswot_planes_from_wire(blobs, universe)
        if planes is None:
            return cls.from_numpy(*planes_of_blobs(blobs, universe), device=dev)
        if not (dev.type == "cuda" if via_device is None else via_device):
            return cls.from_numpy(*planes, device=dev)
        clock, _e, (do, _ds, dm, da, dv), q, h = _host_cells(*planes, want_entries=False)
        deferred = {"deferred_members": q, "deferred_coords": h} if q[0].size else {}
        return cls.from_coo(len(blobs), universe, clock_coords=clock,
                            dot_coords=(do, dm, da, dv), via_device=True, device=dev,
                            **deferred)

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

    def to_scalar(self, universe, via_device: bool | None = None) -> list:
        """The scalar ORSWOT state of every object (the port's scalar
        engine) from the populated cells (:meth:`_cells`)."""
        n, a = self.clock.shape
        return scalars_of_cells(self._cells(via_device), n, a, universe)

    # -- COO route -------------------------------------------------------------

    @classmethod
    def from_coo(cls, n: int, universe, *, clock_coords, dot_coords, deferred_members=None,
                 deferred_coords=None, via_device: bool | None = None,
                 device=None) -> "OrswotBatch":
        """``n`` dense states from COO columns (unsigned counters):
        ``clock_coords`` ``(obj, actor, counter)``, ``dot_coords`` ``(obj,
        member_id, actor, counter)``, optionally ``deferred_members``
        ``(obj, row, member_id)`` with ``deferred_coords`` ``(obj, row,
        actor, counter)``.  Host validation and slot assignment (ascending
        ids per object), then :func:`_build_planes`; duplicate counter
        cells join by max.  Raises ``ValueError`` on a negative member id,
        member overflow, a deferred row out of range, half a deferred
        pair, or two ids for one deferred ``(obj, row)``."""
        cfg = universe.config
        m, d = cfg.member_capacity, cfg.deferred_capacity
        dt = counter_dtype(cfg)
        ei, ev, em32 = np.zeros(0, np.int64), np.zeros(0, dt), np.zeros(0, np.int32)
        entry_cells, dot_cells = (ei, ei, em32), (ei, ei, ei, ev)
        dref_cells, dclk_cells = (ei, ei, em32), (ei, ei, ei, ev)
        co, ca, cc = (np.asarray(x) for x in clock_coords)
        clock_cells = (co, ca, cc.astype(dt))

        do, dm, da, dc = (np.asarray(x) for x in dot_coords)
        if do.size:
            if dm.min(initial=0) < 0:
                raise ValueError(f"negative member id {int(dm.min())} in dot_coords "
                                 "(EMPTY sentinel leaking from an export?)")
            # unique (obj, member) pairs sort by object, then member id;
            # searchsorted ranks each pair within its object
            uniq, inv = np.unique(do.astype(np.int64) * (1 << 32) + dm.astype(np.int64),
                                  return_inverse=True)
            uo = uniq >> 32
            slot = np.arange(uniq.size) - np.searchsorted(uo, uo)
            counts = np.bincount(uo, minlength=n)
            if counts.max(initial=0) > m:
                bad = int(np.argmax(counts))
                raise ValueError(f"object {bad}: {int(counts[bad])} members > member_capacity {m}")
            entry_cells = (uo, slot, (uniq & ((1 << 32) - 1)).astype(np.int32))
            dot_cells = (do, slot[inv.reshape(-1)], da, dc.astype(dt))

        if (deferred_members is None) != (deferred_coords is None):
            raise ValueError("deferred_members and deferred_coords must be supplied together "
                             "(a deferred row is a (member, clock) pair)")
        if deferred_members is not None:
            def check_rows(rows, label):
                if rows.size and (rows.min() < 0 or rows.max() >= d):
                    raise ValueError(f"{label} row indices must lie in [0, deferred_capacity={d}); "
                                     f"got [{int(rows.min())}, {int(rows.max())}]")

            qo, qr, qm = (np.asarray(x) for x in deferred_members)
            check_rows(qr, "deferred_members")
            if qo.size:
                if qm.min(initial=0) < 0:
                    raise ValueError(f"negative member id {int(qm.min())} in deferred_members "
                                     "(EMPTY sentinel leaking from an export?)")
                # (obj, row) rows are assignments, not lattice cells
                key = qo.astype(np.int64) * d + qr.astype(np.int64)
                order = np.argsort(key, kind="stable")
                sk, sm = key[order], qm[order]
                clash = (sk[1:] == sk[:-1]) & (sm[1:] != sm[:-1])
                if clash.any():
                    i = int(np.nonzero(clash)[0][0])
                    raise ValueError(f"conflicting deferred_members assignments for "
                                     f"(obj={int(sk[i]) // d}, row={int(sk[i]) % d}): "
                                     f"member ids {int(sm[i])} and {int(sm[i + 1])}")
                dref_cells = (qo, qr, qm.astype(np.int32))
            ho, hr, ha, hc = (np.asarray(x) for x in deferred_coords)
            check_rows(hr, "deferred_coords")
            if ho.size:
                dclk_cells = (ho, hr, ha, hc.astype(dt))

        dev = resolve_device(device)
        via = dev.type == "cuda" if via_device is None else via_device
        return _build_planes(n, cfg, (clock_cells, entry_cells, dot_cells, dref_cells,
                                      dclk_cells), dev, via, join_counters=True)

    def _cells(self, via_device: bool | None = None, want_entries: bool = True):
        """The five cell bundles of :func:`_host_cells` as host numpy
        columns, computed on the device with ``via_device`` (default: True
        on CUDA), else from the planes copied to the host.  Populated: a
        counter other than the biased zero, an id other than EMPTY."""
        if via_device is None:
            via_device = self.device.type == "cuda"
        planes = (self.clock, self.ids, self.dots, self.d_ids, self.d_clocks)
        if via_device:
            return _device_cells(*planes, want_entries=want_entries)
        return _host_cells(*self.to_numpy(), want_entries=want_entries)

    def to_coo(self, via_device: bool | None = None):
        """The inverse of :meth:`from_coo`: ``(clock_coords, dot_coords,
        deferred_members, deferred_coords)`` (:meth:`_cells`)."""
        (co, ca, cv), _e, (do, _ds, dm, da, dv), q, h = self._cells(via_device,
                                                                    want_entries=False)
        return (co, ca, cv), (do, dm, da, dv), q, h

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

    def truncate(self, clock, check: bool = True) -> "OrswotBatch":
        """``Causal::truncate`` (`orswot.rs:159-172`) by one clock per object
        (unsigned ``[N, A]``; a tensor is taken as biased): the nested
        value kernel's merge with an empty set carrying ``clock``, then
        ``clock`` subtracted from the set clock and every member clock."""
        from .val_kernels import OrswotKernel

        kern = OrswotKernel(self.member_capacity, self.deferred_capacity, self.clock.shape[-1],
                            self.clock.element_size() * 8)
        (c, ids, dots, d_ids, d_clocks), overflow = kern.truncate_full(
            (self.clock, self.ids, self.dots, self.d_ids, self.d_clocks),
            as_counters(clock, self.clock.dtype, self.device))
        if check:
            raise_for_overflow(overflow, "truncate")
        return OrswotBatch(clock=c, ids=ids, dots=dots, d_ids=d_ids, d_clocks=d_clocks)

    # -- op path -------------------------------------------------------------

    def apply_add(self, actor_idx, counter, member_id, check: bool = True) -> "OrswotBatch":
        """One ``Op::Add`` per object (`orswot.rs:66-79`); ``counter``:
        unsigned counters, or a tensor already biased."""
        dev = self.device
        clock, ids, dots, d_ids, d_clocks, overflow = orswot_ops.apply_add(
            self.clock, self.ids, self.dots, self.d_ids, self.d_clocks,
            torch.as_tensor(actor_idx, device=dev), as_counters(counter, self.clock.dtype, dev),
            torch.as_tensor(member_id, dtype=torch.int32, device=dev))
        if check and bool(overflow.any()):
            raise CapacityOverflowError(
                "Orswot capacity overflow in apply_add: raise member_capacity",
                member=True, deferred=False)
        return OrswotBatch(clock=clock, ids=ids, dots=dots, d_ids=d_ids, d_clocks=d_clocks)

    def apply_remove(self, rm_clock, member_id, check: bool = True) -> "OrswotBatch":
        """One ``Op::Rm`` per object (`orswot.rs:80-83,195-211`);
        ``rm_clock``: unsigned counters, or a tensor already biased."""
        dev = self.device
        clock, ids, dots, d_ids, d_clocks, overflow = orswot_ops.apply_remove(
            self.clock, self.ids, self.dots, self.d_ids, self.d_clocks,
            as_counters(rm_clock, self.clock.dtype, dev),
            torch.as_tensor(member_id, dtype=torch.int32, device=dev))
        if check and bool(overflow.any()):
            raise CapacityOverflowError(
                "Orswot capacity overflow in apply_remove: raise deferred_capacity",
                member=False, deferred=True)
        return OrswotBatch(clock=clock, ids=ids, dots=dots, d_ids=d_ids, d_clocks=d_clocks)

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
