"""Map — composition of CRDTs with reset-remove semantics (L4).

Mirrors `src/map.rs`.  Values must be causal CRDTs
(``Causal + CmRDT + CvRDT + Default`` — `map.rs:16-25`), so any causal type
nests, including another Map.  *Reset-remove* (`map.rs:27-33`): if one
replica removes an entry while another concurrently edits it, after sync the
entry survives but every edit seen by the remover is gone.

State mirrors Orswot (`map.rs:83-99`): a map clock, per-key entries carrying
an entry clock plus the nested CRDT, and a deferred-removal buffer.  Ops are
``Nop`` / ``Rm {clock, key}`` / ``Up {dot, key, op}`` (`map.rs:104-123`);
``update`` builds the nested op via a closure over the current (or default)
value (`map.rs:306-317`); merge runs the Orswot dot-algebra per key plus
recursive ``val.merge`` and reset-remove ``val.truncate`` (`map.rs:192-269`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Set, Type

from ..traits import Causal, CmRDT, CvRDT
from .ctx import AddCtx, ReadCtx, RmCtx
from .vclock import ClockKey, Dot, VClock

Key = Hashable


@dataclasses.dataclass
class Entry:
    """Per-key state: which actors edited it + the nested CRDT (`map.rs:91-99`)."""

    clock: VClock
    val: Any

    def clone(self) -> "Entry":
        return Entry(clock=self.clock.clone(), val=self.val.clone())


@dataclasses.dataclass(frozen=True)
class Nop:
    """No change to the CRDT (`map.rs:105-106`)."""


@dataclasses.dataclass(frozen=True)
class Rm:
    """Remove a key under a witnessing clock (`map.rs:107-113`)."""

    clock: VClock
    key: Any


@dataclasses.dataclass(frozen=True)
class Up:
    """Update the entry under ``key`` with a nested op (`map.rs:114-122`)."""

    dot: Dot
    key: Any
    op: Any


class Map(CvRDT, CmRDT, Causal):
    """
    Runnable mirror of the reference's doc example (`map.rs:35-80`) —
    nested updates build one op, applied atomically under one dot:

    >>> from .mvreg import MVReg
    >>> m = Map(lambda: Map(MVReg))
    >>> ctx = m.get("config").derive_add_ctx("admin")
    >>> op = m.update(
    ...     "config", ctx,
    ...     lambda inner, c: inner.update("theme", c,
    ...                                   lambda reg, c2: reg.set("dark", c2)),
    ... )
    >>> m.apply(op)
    >>> m.get("config").val.get("theme").val.read().val
    ['dark']
    >>> rm = m.rm("config", m.get("config").derive_rm_ctx())
    >>> m.apply(rm)
    >>> m.get("config").val is None
    True
    """

    __slots__ = ("val_type", "clock", "entries", "deferred")

    def __init__(self, val_type: Callable[[], Any]):
        # val_type plays the role of the V: Val<A> generic + Default bound
        # (map.rs:16-25): a zero-arg constructor for the nested CRDT.
        self.val_type = val_type
        self.clock = VClock()
        self.entries: Dict[Key, Entry] = {}
        self.deferred: Dict[ClockKey, Set[Key]] = {}

    def default_val(self):
        v = self.val_type()
        return v

    def clone(self) -> "Map":
        m = Map(self.val_type)
        m.clock = self.clock.clone()
        m.entries = {k: e.clone() for k, e in self.entries.items()}
        m.deferred = {k: set(v) for k, v in self.deferred.items()}
        return m

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Map)
            and self.clock == other.clock
            and self.entries == other.entries
            and self.deferred == other.deferred
        )

    __hash__ = None  # type: ignore[assignment]

    # -- causal truncate (`map.rs:131-158`) --------------------------------

    def truncate(self, clock: VClock) -> None:
        to_remove = []
        for key, entry in self.entries.items():
            entry.clock.subtract(clock)
            if entry.clock.is_empty():
                to_remove.append(key)
            else:
                entry.val.truncate(clock)
        for key in to_remove:
            del self.entries[key]

        deferred: Dict[ClockKey, Set[Key]] = {}
        for rm_clock_key, keys in self.deferred.items():
            rm_clock = VClock.from_key(rm_clock_key)
            rm_clock.subtract(clock)
            if not rm_clock.is_empty():
                deferred[rm_clock.key()] = keys
        self.deferred = deferred

        self.clock.subtract(clock)

    # -- op path (`map.rs:160-189`) ----------------------------------------

    def apply(self, op) -> None:
        if isinstance(op, Nop):
            return
        if isinstance(op, Rm):
            self.apply_rm(op.key, op.clock)
            return
        if isinstance(op, Up):
            actor, counter = op.dot.actor, op.dot.counter
            if self.clock.get(actor) >= counter:
                return  # we've seen this op already
            entry = self.entries.pop(op.key, None)
            if entry is None:
                entry = Entry(clock=VClock(), val=self.default_val())
            try:
                entry.clock.witness(actor, counter)
                entry.val.apply(op.op)
            finally:
                # a raising nested op must not delete the popped entry
                self.entries[op.key] = entry
            self.clock.witness(actor, counter)
            self.apply_deferred()
            return
        raise TypeError(f"not a Map op: {op!r}")

    # -- state path (`map.rs:192-269`) -------------------------------------

    def merge(self, other: "Map") -> None:
        other_remaining = dict(other.entries)
        keep: Dict[Key, Entry] = {}
        for key, entry in list(self.entries.items()):
            entry = entry.clone()
            if key not in other.entries:
                # A key the peer lacks was either removed there (peer clock
                # covers every dot ⇒ drop) or never replicated (novel dots
                # remain ⇒ keep, truncating the nested value by whatever the
                # peer *did* witness — reset-remove).  (`map.rs:198-211`)
                entry.clock.subtract(other.clock)
                if entry.clock.is_empty():
                    pass
                else:
                    deleters = other.clock.clone()
                    deleters.subtract(entry.clock)
                    entry.val.truncate(deleters)
                    keep[key] = entry
            else:
                # present in both — the Orswot dot dance (`map.rs:213-240`)
                other_entry = other.entries[key].clone()
                common = entry.clock.intersection(other_entry.clock)
                entry.clock.subtract(common)
                other_entry.clock.subtract(common)
                entry.clock.subtract(other.clock)
                other_entry.clock.subtract(self.clock)

                common.merge(entry.clock)
                common.merge(other_entry.clock)
                if not common.is_empty():
                    entry.val.merge(other_entry.val)
                    deleters = entry.clock.clone()
                    deleters.merge(other_entry.clock)
                    deleters.subtract(common)
                    entry.val.truncate(deleters)
                    entry.clock = common
                    keep[key] = entry
                del other_remaining[key]

        for key, entry in other_remaining.items():
            # novel entries witnessed by other (`map.rs:244-253`)
            entry = entry.clone()
            entry.clock.subtract(self.clock)
            if not entry.clock.is_empty():
                deleters = self.clock.clone()
                deleters.subtract(entry.clock)
                entry.val.truncate(deleters)
                keep[key] = entry

        # replay other's deferred removals through apply_rm (`map.rs:256-260`);
        # snapshot first — Python allows other IS self, Rust's borrows don't
        for clock_key, deferred in list(other.deferred.items()):
            clock = VClock.from_key(clock_key)
            for key in deferred:
                self.apply_rm(key, clock)

        self.entries = keep
        self.clock.merge(other.clock)
        self.apply_deferred()

    # -- inherent API (`map.rs:271-351`) -----------------------------------

    def len(self) -> ReadCtx:
        """Number of entries with causal context (`map.rs:282-288`)."""
        return ReadCtx(
            add_clock=self.clock.clone(),
            rm_clock=self.clock.clone(),
            val=len(self.entries),
        )

    def get(self, key) -> ReadCtx:
        """Value stored under a key (`map.rs:291-302`)."""
        entry = self.entries.get(key)
        return ReadCtx(
            add_clock=self.clock.clone(),
            rm_clock=entry.clock.clone() if entry is not None else VClock(),
            val=entry.val.clone() if entry is not None else None,
        )

    def update(self, key, ctx: AddCtx, f: Callable[[Any, AddCtx], Any]) -> Up:
        """Update a value under a key; absent keys get the default value
        (`map.rs:306-317`).  ``f(val, ctx) -> nested op``; pure."""
        entry = self.entries.get(key)
        if entry is not None:
            op = f(entry.val, ctx.clone())
        else:
            op = f(self.default_val(), ctx.clone())
        return Up(dot=ctx.dot, key=key, op=op)

    def rm(self, key, ctx: RmCtx) -> Rm:
        """Build a remove op; pure (`map.rs:320-322`)."""
        return Rm(clock=ctx.clock, key=key)

    def apply_deferred(self) -> None:
        """Apply the pending deferred removes (`map.rs:325-333`)."""
        deferred = self.deferred
        self.deferred = {}
        for clock_key, keys in deferred.items():
            clock = VClock.from_key(clock_key)
            for key in keys:
                self.apply_rm(key, clock)

    def apply_rm(self, key, clock: VClock) -> None:
        """Apply a key removal given a clock, deferring if the clock is
        ahead of ours (`map.rs:336-350`)."""
        if not (clock <= self.clock):
            deferred_set = self.deferred.setdefault(clock.key(), set())
            deferred_set.add(key)

        if key in self.entries:
            existing_entry = self.entries.pop(key)
            existing_entry.clock.subtract(clock)
            if not existing_entry.clock.is_empty():
                existing_entry.val.truncate(clock)
                self.entries[key] = existing_entry

    def __repr__(self) -> str:
        return (
            f"Map(clock={self.clock!r}, entries={self.entries!r}, "
            f"deferred={self.deferred!r})"
        )
