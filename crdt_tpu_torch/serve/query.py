"""Batched reads straight from the dense planes (the port of the JAX
package's ``serve/query.py``).

A read returns the reference's ``ReadCtx { add_clock, rm_clock, val }``
(`ctx.rs:12-21`) for thousands of ``(object, kind)`` rows at once, one
gather per kind, as torch ops where the planes live:

* ORSWOT: ``contains(member)`` (rm clock = the member's witnessing dots,
  empty when absent, `orswot.rs:214-224`) and ``value()`` (rm clock = the
  set clock; ``member = NO_MEMBER``);
* G/PN counters: row sums, the count plane as both clocks;
* LWW registers: value and marker, no clock;
* MV registers: slot values, slot clocks and the folded register clock;
* Maps: ``get(key)`` and ``len()`` (`map.rs:282-302`).

The request's object and member columns go to the device in one copy,
and each result column comes back in one copy.  Counters are biased on
the device (:mod:`crdt_tpu_torch.dtypes`): each clock row is unbiased to
int64 holding the unsigned bits before it leaves, so the frame carries
the JAX package's ``uint64`` columns, and counter sums run over unbiased
int64 (a u32 row sums without wrapping, a u64 row wraps mod 2^64, as
under the JAX package's x64).  A member's or key's clock is the row of
its one matching slot (ids are unique per row), never a sum of biased
cells.  A batch is gathered at its own size: with no compile cache to
feed, the JAX package's power-of-two padding would change no output.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..dtypes import EMPTY, ZERO32, ZERO64, zero_of

K_ORSWOT = 0
K_GCOUNTER = 1
K_PNCOUNTER = 2
K_LWW = 3
K_MVREG = 4
K_MAP = 5

KIND_NAMES = {
    K_ORSWOT: "orswot", K_GCOUNTER: "gcounter", K_PNCOUNTER: "pncounter",
    K_LWW: "lww", K_MVREG: "mvreg", K_MAP: "map",
}

#: every kind a read frame may name
READ_KINDS = tuple(sorted(KIND_NAMES))

#: ``member`` column sentinel: a whole-object read (ORSWOT ``value()``,
#: map ``len()``)
NO_MEMBER = -1

#: per-row result statuses
ST_OK = 0
ST_NOT_STABLE = 1
STATUSES = (ST_OK, ST_NOT_STABLE)

_COUNTS_LOCK = threading.Lock()
_COUNTS = {"reads": 0, "batches": 0}


def read_counts() -> dict:
    """Rows read and gather batches served since the last reset."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_read_counts() -> None:
    with _COUNTS_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def _upload(obj: np.ndarray, member: np.ndarray, device):
    """``(obj, member)`` int64 tensors on ``device``, in one copy."""
    cols = torch.from_numpy(np.stack([obj, member.astype(np.int64)])).to(device)
    return cols[0], cols[1]


def _u64(t: torch.Tensor) -> torch.Tensor:
    """Biased counters as int64 holding the unsigned bits."""
    if t.dtype == torch.int32:
        return (t ^ ZERO32).to(torch.int64) & 0xFFFFFFFF
    return t ^ ZERO64


def _hit_row(plane: torch.Tensor, obj, hit: torch.Tensor) -> torch.Tensor:
    """Row ``[B, A]`` of each read's matching slot of ``plane[obj]``
    (``[N, S, A]``), biased 0 where no slot matches."""
    slot = hit.to(torch.uint8).argmax(dim=1)
    rows = plane[obj, slot]
    return torch.where(hit.any(dim=1, keepdim=True), rows,
                       torch.full_like(rows, zero_of(plane.dtype)))


def _orswot(batch, obj, member):
    crow = batch.clock.index_select(0, obj)
    idrow = batch.ids.index_select(0, obj)
    want = member[:, None]
    hit = (idrow == want) & (want >= 0) & (idrow != EMPTY)
    value_read = member < 0
    rm = torch.where(value_read[:, None], crow, _hit_row(batch.dots, obj, hit))
    count = (idrow != EMPTY).sum(dim=1)
    val = torch.where(value_read, count, hit.any(dim=1).to(torch.int64))
    return val, _u64(crow), _u64(rm), {"members": idrow, "count": count}


def _counter_rows(plane, obj):
    row = _u64(plane.index_select(0, obj))
    return row.sum(dim=-1), row


def _gcounter(batch, obj, member):
    total, row = _counter_rows(batch.clocks, obj)
    return total, row, None, {}


def _pncounter(batch, obj, member):
    sums, rows = _counter_rows(batch.planes, obj)  # [B, 2], [B, 2, A]
    p, n = sums[:, 0], sums[:, 1]
    # P − N in two's complement (`pncounter.rs:117-119`); the clock is
    # the [B, 2A] flattening of the version vector
    return p - n, rows.reshape(rows.shape[0], -1), None, {"p": p, "n": n}


def _lww(batch, obj, member):
    empty = torch.zeros((obj.shape[0], 0), dtype=torch.int64, device=obj.device)
    return (batch.vals.index_select(0, obj), empty, empty,
            {"marker": _u64(batch.markers.index_select(0, obj))})


def _mvreg(batch, obj, member):
    c = batch.clocks.index_select(0, obj)
    fold = _u64(c.amax(dim=1))
    live = (c != zero_of(c.dtype)).any(dim=2)
    return (live.sum(dim=1), fold, None,
            {"mv_vals": batch.vals.index_select(0, obj), "mv_clocks": _u64(c), "mv_live": live})


def _map(batch, obj, key):
    crow = batch.clock.index_select(0, obj)
    krow = batch.keys.index_select(0, obj)
    want = key[:, None]
    hit = (krow == want) & (want >= 0)
    len_read = key < 0
    count = (krow >= 0).sum(dim=1)
    rm = torch.where(len_read[:, None], crow, _hit_row(batch.entry_clocks, obj, hit))
    val = torch.where(len_read, count, hit.any(dim=1).to(torch.int64))
    return val, _u64(crow), _u64(rm), {"count": count}


#: kind -> the device gather ``(batch, obj, member) -> (val, add, rm or
#: None for rm = add, extras)``, every tensor on the batch's device
KERNELS = {
    K_ORSWOT: _orswot,
    K_GCOUNTER: _gcounter,
    K_PNCOUNTER: _pncounter,
    K_LWW: _lww,
    K_MVREG: _mvreg,
    K_MAP: _map,
}

#: extras columns that keep their signed ids on the host
_SIGNED_COLUMNS = ("members",)


def _numpy(t: torch.Tensor, signed: bool = False) -> np.ndarray:
    """A host column as numpy; signed integers become the unsigned type
    of their width unless ``signed``."""
    x = t.numpy()
    if x.dtype.kind == "i" and not signed:
        x = x.view(np.uint32 if x.dtype == np.int32 else np.uint64)
    return x


def _download(out):
    """Each column on the host: one copy per column, into pinned memory
    from a CUDA device, then one wait for them all."""
    val, add, rm, extras = out
    cols = {"val": val, "add": add, **({} if rm is None else {"rm": rm}), **extras}
    host = {k: t.to("cpu", non_blocking=True) for k, t in cols.items()}
    if val.is_cuda:
        torch.cuda.current_stream(val.device).synchronize()
    add_h = _numpy(host.pop("add"))
    rm_h = add_h.copy() if rm is None else _numpy(host.pop("rm"))
    return (_numpy(host.pop("val")), add_h, rm_h,
            {k: _numpy(v, k in _SIGNED_COLUMNS) for k, v in host.items()})


@dataclasses.dataclass
class ReadRequest:
    """One columnar read batch: ``(object, kind)`` rows, a member/key
    probe column, a consistency mode and its clock floor."""

    obj: np.ndarray                     # int64[B]
    kind: np.ndarray                    # uint8[B] (K_*)
    member: np.ndarray                  # int32[B]; NO_MEMBER = whole object
    mode: str = "eventual"
    require: Optional[np.ndarray] = None  # uint64[W] version-vector floor

    def __post_init__(self):
        self.obj = np.asarray(self.obj, np.int64).reshape(-1)
        self.kind = np.broadcast_to(np.asarray(self.kind, np.uint8), self.obj.shape).copy()
        self.member = np.broadcast_to(np.asarray(self.member, np.int32), self.obj.shape).copy()
        if self.require is not None:
            self.require = np.asarray(self.require, np.uint64).reshape(-1)

    def __len__(self) -> int:
        return int(self.obj.shape[0])

    @classmethod
    def reads(cls, obj, *, kind: int = K_ORSWOT, member=NO_MEMBER, mode: str = "eventual",
              require=None) -> "ReadRequest":
        return cls(obj=np.asarray(obj, np.int64).reshape(-1), kind=kind, member=member,
                   mode=mode, require=require)


@dataclasses.dataclass
class ResultFrame:
    """The columnar answer to a read batch: echoed keys, per-row status,
    the value column and the add/rm clock rows (the scalar ``ReadCtx``
    triple, batched); ``token`` is the snapshot's version vector, stamped
    by a serve loop; ``extras`` holds per-kind columns."""

    obj: np.ndarray                     # int64[B]
    kind: np.ndarray                    # uint8[B]
    member: np.ndarray                  # int32[B]
    status: np.ndarray                  # uint8[B] (ST_*)
    val: np.ndarray                     # uint64[B]
    add_clock: np.ndarray               # uint64[B, W]
    rm_clock: np.ndarray                # uint64[B, W]
    token: np.ndarray                   # uint64[W]
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return int(self.obj.shape[0])

    def read_ctx(self, i: int, universe=None):
        """Row ``i`` as a scalar :class:`~crdt_tpu_torch.scalar.ctx.ReadCtx`."""
        from ..scalar.ctx import ReadCtx

        return ReadCtx(add_clock=row_to_vclock(self.add_clock[i], universe),
                       rm_clock=row_to_vclock(self.rm_clock[i], universe),
                       val=int(self.val[i]))


def row_to_vclock(row, universe=None):
    """A dense clock row as a scalar VClock (actors named through
    ``universe.actors`` when given, column indices otherwise)."""
    from ..scalar.vclock import VClock

    row = np.asarray(row, np.uint64).reshape(-1)
    vc = VClock()
    for i in np.nonzero(row)[0]:
        vc.dots[universe.actors.lookup(int(i)) if universe is not None else int(i)] = int(row[i])
    return vc


def infer_kind(batch) -> int:
    """The read kind of a dense batch by type."""
    from ..batch import (GCounterBatch, LWWRegBatch, MapBatch, MVRegBatch, OrswotBatch,
                         PNCounterBatch)

    for cls, kind in ((OrswotBatch, K_ORSWOT), (GCounterBatch, K_GCOUNTER),
                      (PNCounterBatch, K_PNCOUNTER), (LWWRegBatch, K_LWW),
                      (MVRegBatch, K_MVREG), (MapBatch, K_MAP)):
        if isinstance(batch, cls):
            return kind
    raise TypeError(f"no serve gather for {type(batch).__name__} "
                    f"(served kinds: {sorted(KIND_NAMES.values())})")


_PLANE = {K_ORSWOT: "clock", K_GCOUNTER: "clocks", K_PNCOUNTER: "planes", K_LWW: "vals",
          K_MVREG: "vals", K_MAP: "clock"}


def gather(batch, obj, *, member=None, kind: Optional[int] = None) -> ResultFrame:
    """Resolve one single-kind read batch against ``batch`` where its
    planes live.  ``member`` probes membership (ORSWOT) or keys (map);
    ``NO_MEMBER`` rows read the whole object.  The frame's ``token`` is
    left empty."""
    obj = np.asarray(obj, np.int64).reshape(-1)
    if kind is None:
        kind = infer_kind(batch)
    if kind not in KERNELS:
        raise ValueError(f"unknown read kind {kind}")
    member = np.full(obj.shape, NO_MEMBER, np.int32) if member is None \
        else np.broadcast_to(np.asarray(member, np.int32), obj.shape).copy()
    b = obj.shape[0]
    plane = getattr(batch, _PLANE[kind])
    n = int(plane.shape[0])
    if b and (obj.min() < 0 or obj.max() >= n):
        bad = int(obj.min()) if obj.min() < 0 else int(obj.max())
        raise IndexError(f"read object {bad} outside the fleet's dense axis [0, {n})")
    if b == 0:
        val, add, extras = np.zeros(0, np.uint64), np.zeros((0, 0), np.uint64), {}
        rm = add
    else:
        obj_t, mem_t = _upload(obj, member, plane.device)
        val, add, rm, extras = _download(KERNELS[kind](batch, obj_t, mem_t))
    with _COUNTS_LOCK:
        _COUNTS["reads"] += b
        _COUNTS["batches"] += 1
    return ResultFrame(obj=obj, kind=np.full(b, kind, np.uint8), member=member,
                       status=np.zeros(b, np.uint8), val=val, add_clock=add, rm_clock=rm,
                       token=np.zeros(0, np.uint64), extras=extras)


class QueryEngine:
    """Mixed-kind read batches over a set of dense batches: one gather
    per kind present, scattered back into one frame.  Holds ``{kind:
    batch}``; a bare batch serves its own kind only."""

    def __init__(self, batches):
        if not isinstance(batches, dict):
            batches = {infer_kind(batches): batches}
        for k in batches:
            if k not in KERNELS:
                raise ValueError(f"unknown read kind {k}")
        self.batches = dict(batches)

    def width(self) -> int:
        """The widest clock row any served kind produces."""
        w = 0
        for kind, batch in self.batches.items():
            if kind in (K_ORSWOT, K_MAP):
                w = max(w, int(batch.clock.shape[1]))
            elif kind == K_GCOUNTER:
                w = max(w, int(batch.clocks.shape[1]))
            elif kind == K_PNCOUNTER:
                w = max(w, int(batch.planes.shape[1] * batch.planes.shape[2]))
            elif kind == K_MVREG:
                w = max(w, int(batch.clocks.shape[2]))
        return w

    def gather(self, obj, kind=None, member=None) -> ResultFrame:
        obj = np.asarray(obj, np.int64).reshape(-1)
        b = obj.shape[0]
        if kind is None:
            if len(self.batches) != 1:
                raise ValueError("a mixed-kind engine needs an explicit kind column")
            kind = next(iter(self.batches))
        kind = np.broadcast_to(np.asarray(kind, np.uint8), obj.shape).copy()
        member = np.full(obj.shape, NO_MEMBER, np.int32) if member is None \
            else np.broadcast_to(np.asarray(member, np.int32), obj.shape).copy()
        present = np.unique(kind)
        missing = [int(k) for k in present if int(k) not in self.batches]
        if missing:
            raise ValueError(f"read batch names unserved kinds {missing} "
                             f"(served: {sorted(self.batches)})")
        w = self.width()
        val = np.zeros(b, np.uint64)
        add = np.zeros((b, w), np.uint64)
        rm = np.zeros((b, w), np.uint64)
        extras: Dict[str, Any] = {}
        for k in present:
            idx = np.nonzero(kind == k)[0]
            sub = gather(self.batches[int(k)], obj[idx], member=member[idx], kind=int(k))
            val[idx] = sub.val
            wk = sub.add_clock.shape[1]
            add[idx, :wk] = sub.add_clock
            rm[idx, :wk] = sub.rm_clock
            for name, col in sub.extras.items():
                extras.setdefault(name, {})[int(k)] = (idx, col)
        return ResultFrame(obj=obj, kind=kind, member=member, status=np.zeros(b, np.uint8),
                           val=val, add_clock=add, rm_clock=rm, token=np.zeros(0, np.uint64),
                           extras=extras)
