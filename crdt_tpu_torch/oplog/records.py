"""Columnar op records of the op-based (CmRDT) write front-end.

The port of the JAX package's ``oplog/records.py``: a user write ships as
an operation (`traits.rs:15-41`, `ctx.rs:26-53`), a few dozen bytes, not
a state.  :class:`OpBatch` holds a batch of them as numpy columns
(unsigned counters, biased only when copied to a device), :class:`OpLog`
buffers batches, :func:`derive_add_ctx` and :func:`derive_rm_ctx` mint
the causal contexts of a whole write batch (`ctx.rs:45-60`), and
:func:`intern_ops` interns writer names.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import bias_np, counters_to_numpy, to_device
from ..error import OpLogOverflowError

#: operation kinds: ORSWOT add/remove (`orswot.rs:60-83`), G/PN-counter
#: increment and decrement (`gcounter.rs:71-73`, `pncounter.rs:65-78`),
#: LWW write (`lwwreg.rs:104-118`)
OP_ADD = 0
OP_RM = 1
OP_INC = 2
OP_DEC = 3
OP_SET = 4

OP_KINDS = (OP_ADD, OP_RM, OP_INC, OP_DEC, OP_SET)
OP_NAMES = {OP_ADD: "add", OP_RM: "rm", OP_INC: "inc", OP_DEC: "dec", OP_SET: "set"}
_DOTTED = np.asarray([OP_ADD, OP_INC, OP_DEC], np.uint8)

#: ``member`` value for ops that carry none (counter increments)
NO_MEMBER = -1


def _col(x, dtype):
    return np.ascontiguousarray(np.asarray(x), dtype=dtype)


_COLUMNS = (("kind", np.uint8), ("obj", np.int64), ("actor", np.int32), ("counter", np.uint64),
            ("member", np.int32))


def opbatch_nbytes(batch: "OpBatch") -> int:
    """Exact byte footprint of one batch's columns, clocks included."""
    n = sum(getattr(batch, c).nbytes for c, _ in _COLUMNS)
    return int(n + (0 if batch.rm_clocks is None else batch.rm_clocks.nbytes))


@dataclasses.dataclass
class OpBatch:
    """A struct-of-arrays batch of ``B`` operations: ``kind`` (uint8,
    :data:`OP_KINDS`), ``obj`` (int64 fleet row), ``actor`` (int32),
    ``counter`` (uint64 dot, or LWW marker), ``member`` (int32 id, or
    :data:`NO_MEMBER`), and optionally ``rm_clocks`` (``uint64[B, A]``,
    a remove's witnessing clock on its row, zeros elsewhere)."""

    kind: np.ndarray
    obj: np.ndarray
    actor: np.ndarray
    counter: np.ndarray
    member: np.ndarray
    rm_clocks: Optional[np.ndarray] = None

    def __post_init__(self):
        b = np.shape(self.kind)[0]
        for name, dt in _COLUMNS:
            setattr(self, name, _col(getattr(self, name), dt))
            if getattr(self, name).shape != (b,):
                raise ValueError(f"OpBatch column {name!r} has shape "
                                 f"{getattr(self, name).shape}, expected ({b},)")
        if self.rm_clocks is not None:
            self.rm_clocks = _col(self.rm_clocks, np.uint64)
            if self.rm_clocks.ndim != 2 or self.rm_clocks.shape[0] != b:
                raise ValueError(f"OpBatch.rm_clocks has shape {self.rm_clocks.shape}, "
                                 f"expected ({b}, A)")
        known = np.isin(self.kind, np.asarray(OP_KINDS, np.uint8))
        if b and not known.all():
            raise ValueError(f"OpBatch holds unknown op kind {int(self.kind[~known][0])}")

    def __len__(self) -> int:
        return int(self.kind.shape[0])

    @classmethod
    def empty(cls) -> "OpBatch":
        return cls(*(np.zeros(0, dt) for _, dt in _COLUMNS))

    def select(self, mask) -> "OpBatch":
        """The sub-batch at ``mask`` (bool[B] or index array)."""
        mask = np.asarray(mask)
        return OpBatch(*(getattr(self, c)[mask] for c, _ in _COLUMNS),
                       rm_clocks=None if self.rm_clocks is None else self.rm_clocks[mask])

    @classmethod
    def concat(cls, batches: Sequence["OpBatch"]) -> "OpBatch":
        batches = [b for b in batches if len(b)]
        if len(batches) <= 1:
            return batches[0] if batches else cls.empty()
        widths = {b.rm_clocks.shape[1] for b in batches if b.rm_clocks is not None}
        if len(widths) > 1:
            raise ValueError(f"cannot concat OpBatches with mixed actor widths {widths}")
        clocks = None
        if widths:
            (a,) = widths
            clocks = np.concatenate([b.rm_clocks if b.rm_clocks is not None
                                     else np.zeros((len(b), a), np.uint64) for b in batches])
        return cls(*(np.concatenate([getattr(b, c) for b in batches]) for c, _ in _COLUMNS),
                   rm_clocks=clocks)

    def validate(self, n_objects: int, num_actors: int) -> None:
        """Raise ``ValueError`` when a column violates the fleet's bounds
        (decoded frames arrive checked by the codec already)."""
        if not len(self):
            return
        if self.obj.min() < 0 or self.obj.max() >= n_objects:
            raise ValueError(f"op object row outside fleet [0, {n_objects}): "
                             f"[{int(self.obj.min())}, {int(self.obj.max())}]")
        if self.actor.min() < 0 or self.actor.max() >= num_actors:
            raise ValueError(f"op actor index outside universe [0, {num_actors}): "
                             f"[{int(self.actor.min())}, {int(self.actor.max())}]")
        needs_member = np.isin(self.kind, np.asarray([OP_ADD, OP_RM, OP_SET], np.uint8))
        if bool((self.member[needs_member] < 0).any()):
            raise ValueError("add/rm/set op carries a negative member id "
                             "(the EMPTY sentinel leaking from an export?)")
        if bool((self.counter[np.isin(self.kind, _DOTTED)] == 0).any()):
            raise ValueError("dot counter 0 in an add/inc/dec op (dots start at 1 — "
                             "vclock.rs:206-210: an absent actor has an implied 0)")


class OpLog:
    """Bounded append-only staging log of :class:`OpBatch` segments: any
    thread may :meth:`append`, the fold :meth:`drain`\\ s them as one
    batch, and a full log raises
    :class:`~crdt_tpu_torch.error.OpLogOverflowError` (never a silent
    drop).  ``watermark``: the per-actor dot high-watermark (uint64[A]);
    ``appended_total``: every op ever appended."""

    def __init__(self, universe, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"OpLog capacity {capacity} < 1")
        self.universe = universe
        self.capacity = capacity
        self._lock = threading.Lock()
        self._segments: list = []
        self._count = 0
        self._watermark = np.zeros(universe.config.num_actors, np.uint64)
        self.appended_total = 0

    def __len__(self) -> int:
        with self._lock:
            return self._count

    @property
    def watermark(self) -> np.ndarray:
        """Copy of the per-actor dot high-watermark (uint64[A])."""
        with self._lock:
            return self._watermark.copy()

    def append(self, batch: OpBatch) -> None:
        if not isinstance(batch, OpBatch):
            raise TypeError(f"OpLog.append wants an OpBatch, got {type(batch).__name__}")
        b = len(batch)
        if b == 0:
            return
        with self._lock:
            if self._count + b > self.capacity:
                raise OpLogOverflowError(
                    f"op log full: {self._count} buffered + {b} appended > capacity "
                    f"{self.capacity} — drain (apply) before submitting more writes")
            self._segments.append(batch)
            self._count += b
            self.appended_total += b
            dotted = np.isin(batch.kind, _DOTTED)
            if dotted.any():
                np.maximum.at(self._watermark, batch.actor[dotted], batch.counter[dotted])

    def pending(self) -> OpBatch:
        """Everything buffered, as one batch, without clearing."""
        with self._lock:
            segments = list(self._segments)
        return OpBatch.concat(segments)

    def drain(self) -> OpBatch:
        """Everything buffered, as one batch; the log is empty after."""
        with self._lock:
            segments, self._segments = self._segments, []
            self._count = 0
        return OpBatch.concat(segments)

    def compact(self, droppable) -> tuple:
        """Drop buffered ops in place: ``droppable(batch) -> bool[B]``
        flags rows to shed.  Returns ``(ops_dropped, bytes_reclaimed)``;
        the high-watermark is untouched."""
        with self._lock:
            segments, self._segments = self._segments, []
            self._count = 0
        batch = OpBatch.concat(segments)
        if not len(batch):
            return 0, 0
        mask = np.asarray(droppable(batch), dtype=bool)
        if mask.shape != (len(batch),):
            raise ValueError(f"droppable mask has shape {mask.shape}, expected ({len(batch)},)")
        kept = batch.select(~mask)
        freed = opbatch_nbytes(batch) - opbatch_nbytes(kept)
        with self._lock:
            # survivors re-enter at the front, ahead of appends that raced
            if len(kept):
                self._segments.insert(0, kept)
            self._count += len(kept)
        return int(mask.sum()), int(freed)

    def occupancy(self) -> dict:
        """Buffered ops against the bound, segments, exact column bytes
        and the highest per-actor watermark, in one consistent read."""
        with self._lock:
            segments = list(self._segments)
            count = self._count
            high = int(self._watermark.max(initial=0))
        return {"ops": count, "capacity": self.capacity, "segments": len(segments),
                "bytes": sum(opbatch_nbytes(b) for b in segments), "watermark_max": high}


# -- batched causal contexts ----------------------------------------------------


def _biased_clock(base_clock, device) -> torch.Tensor:
    """A fleet clock plane as a biased tensor (a tensor is biased
    already; numpy holds unsigned counters, read as uint64 unless u32)."""
    if isinstance(base_clock, torch.Tensor):
        return base_clock
    x = np.asarray(base_clock)
    if x.dtype not in (np.uint32, np.uint64):
        x = x.astype(np.uint64)
    return to_device(bias_np(x), resolve_device(device))


def _derive_body(base, obj, actor):
    """Dot counters and AddCtx clocks of a write batch (see
    :func:`derive_add_ctx`), in the counter width of ``base``, biased."""
    b, a = obj.shape[0], base.shape[1]
    dt = base.dtype
    # stable sort by object: each object's writes form one segment, in
    # batch order
    order = torch.sort(obj, stable=True).indices
    so, sa = obj[order], actor[order]
    onehot = (sa[:, None] == torch.arange(a, device=base.device)[None, :]).to(dt)
    csum = torch.cumsum(onehot, dim=0, dtype=dt)  # inclusive
    is_start = torch.ones(b, dtype=torch.bool, device=base.device)
    is_start[1:] = so[1:] != so[:-1]
    start_row = torch.nonzero(is_start)[:, 0][torch.cumsum(is_start, 0) - 1]
    # within-segment inclusive per-actor counts: the k-th write by actor
    # a' on object o sees base[o] advanced by every earlier same-object
    # write's dot, and its own dot is base[o, a'] + k; the biased add
    # wraps as the unsigned one does
    incl = csum - csum[start_row] + onehot[start_row]
    ctx = base[so] + incl
    counters = torch.gather(ctx, 1, sa[:, None])[:, 0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(b, device=base.device)
    return counters[inv], ctx[inv]


def derive_add_ctx(base_clock, obj, actor, *, member=None, kind=OP_ADD, device=None):
    """Batched ``ReadCtx.derive_add_ctx`` over a write batch.

    ``base_clock``: the fleet's ``[N, A]`` clock, a biased tensor (the
    pass runs on its device) or unsigned numpy (copied to ``device``,
    default ``"cuda"``).  Returns ``(ops, ctx_clocks)``: an
    :class:`OpBatch` whose ``counter`` is the dot the scalar loop (read,
    clone, ``inc``, witness, apply; `ctx.rs:45-53`) would mint for each
    write, and each write's AddCtx clock ``uint64[B, A]``; both unsigned
    in ``base_clock``'s width (u32 wraps at 2^32, as in JAX)."""
    obj = np.asarray(obj, np.int64)
    actor = np.asarray(actor, np.int32)
    if obj.shape != actor.shape:
        raise ValueError(f"obj/actor shape mismatch: {obj.shape} vs {actor.shape}")
    if kind not in (OP_ADD, OP_INC, OP_DEC):
        raise ValueError(f"derive_add_ctx mints dots for add/inc/dec ops, not "
                         f"{OP_NAMES.get(kind, kind)!r} (removes derive a clock — "
                         "derive_rm_ctx)")
    a = (base_clock.shape if isinstance(base_clock, torch.Tensor) else np.shape(base_clock))[1]
    b = obj.shape[0]
    if b == 0:
        return OpBatch.empty(), np.zeros((0, a), np.uint64)
    if actor.min() < 0 or actor.max() >= a:
        raise ValueError(f"actor index outside the universe [0, {a})")
    base = _biased_clock(base_clock, device)
    counters, ctx = _derive_body(base, torch.as_tensor(obj, device=base.device),
                                 torch.as_tensor(actor, dtype=torch.int64, device=base.device))
    ops = OpBatch(kind=np.full(b, kind, np.uint8), obj=obj, actor=actor,
                  counter=counters_to_numpy(counters).astype(np.uint64),
                  member=np.full(b, NO_MEMBER, np.int32) if member is None
                  else _col(member, np.int32))
    return ops, counters_to_numpy(ctx).astype(np.uint64)


def derive_rm_ctx(base_clock, obj, member) -> OpBatch:
    """Batched ``derive_rm_ctx`` (`ctx.rs:56-60`): each remove witnesses
    its object's current clock (gathered on the device from a biased
    tensor); removes mint no dot, so ``counter`` and ``actor`` are 0."""
    obj = np.asarray(obj, np.int64)
    member = _col(member, np.int32)
    if obj.shape != member.shape:
        raise ValueError(f"obj/member shape mismatch: {obj.shape} vs {member.shape}")
    b = obj.shape[0]
    rows = None
    if b and isinstance(base_clock, torch.Tensor):
        idx = torch.as_tensor(obj, device=base_clock.device)
        rows = counters_to_numpy(base_clock[idx]).astype(np.uint64)
    elif b:
        rows = np.asarray(base_clock, np.uint64)[obj]
    return OpBatch(kind=np.full(b, OP_RM, np.uint8), obj=obj, actor=np.zeros(b, np.int32),
                   counter=np.zeros(b, np.uint64), member=member, rm_clocks=rows)


def intern_ops(universe, actors: Iterable, members: Iterable = None,
               objects: Iterable = None, object_registry=None):
    """Intern writer names through the universe's registries, and
    ``objects`` through a caller-owned ``object_registry``: ``(actor_idx
    int32[B], member_id int32[B] | None, obj int64[B] | None)``."""
    actor_idx = np.asarray(universe.actors.intern_all(list(actors)), np.int32)
    member_id = None
    if members is not None:
        member_id = np.asarray(universe.members.intern_all(list(members)), np.int32)
    obj = None
    if objects is not None:
        if object_registry is None:
            raise ValueError("interning object names needs an object_registry "
                             "(fleet rows are dense; pass rows directly otherwise)")
        obj = np.asarray(object_registry.intern_all(list(objects)), np.int64)
    return actor_idx, member_id, obj
