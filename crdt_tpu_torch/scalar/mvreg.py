"""MVReg — multi-value register.

Mirrors `src/mvreg.rs`: on concurrent writes, all values
without an established causal order are kept as an antichain
``vals: [(VClock, V)]`` (`mvreg.rs:44-46`).  Merge keeps mutually-undominated
values from both sides, deduped by clock (`mvreg.rs:121-153`); apply retains
values not dominated by the op clock and skips ops dominated by existing
values (`mvreg.rs:155-187`); ``read()`` returns every concurrent value plus
the folded clock (`mvreg.rs:201-222`).  Equality is set-equality over
``(clock, val)`` pairs (`mvreg.rs:74-96`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

from ..traits import Causal, CmRDT, CvRDT
from .ctx import ReadCtx
from .vclock import VClock


@dataclasses.dataclass(frozen=True)
class Put:
    """The single MVReg op (`mvreg.rs:51-59`): put a value under a clock."""

    clock: VClock
    val: Any


class MVReg(CvRDT, CmRDT, Causal):
    """
    Concurrent writes both survive; a causally-later write collapses them:

    >>> a, b = MVReg(), MVReg()
    >>> a.apply(a.set("ok", a.read().derive_add_ctx("alice")))
    >>> b.apply(b.set("no", b.read().derive_add_ctx("bob")))
    >>> a.merge(b)
    >>> sorted(a.read().val)               # concurrent: both values
    ['no', 'ok']
    >>> a.apply(a.set("done", a.read().derive_add_ctx("alice")))
    >>> a.read().val                       # dominates both: collapses
    ['done']
    """

    __slots__ = ("vals",)

    def __init__(self, vals: List[Tuple[VClock, Any]] | None = None):
        self.vals: List[Tuple[VClock, Any]] = list(vals) if vals else []

    def clone(self) -> "MVReg":
        return MVReg([(c.clone(), v) for c, v in self.vals])

    @classmethod
    def default(cls) -> "MVReg":
        return cls()

    def __eq__(self, other) -> bool:
        """Set-equality over (clock, val) pairs (`mvreg.rs:74-96`)."""
        if not isinstance(other, MVReg):
            return NotImplemented
        for pair in self.vals:
            if sum(1 for d in other.vals if d == pair) == 0:
                return False
        for pair in other.vals:
            if sum(1 for d in self.vals if d == pair) == 0:
                return False
        return True

    __hash__ = None  # type: ignore[assignment]

    def truncate(self, clock: VClock) -> None:
        """Drop values whose clock is emptied by subtracting ``clock``
        (`mvreg.rs:100-113`)."""
        new_vals = []
        for val_clock, val in self.vals:
            val_clock = val_clock.clone()
            val_clock.subtract(clock)
            if not val_clock.is_empty():
                new_vals.append((val_clock, val))
        self.vals = new_vals

    def merge(self, other: "MVReg") -> None:
        """Keep mutually-undominated values, dedup by clock (`mvreg.rs:121-153`)."""
        vals: List[Tuple[VClock, Any]] = []
        for clock, val in self.vals:
            num_dominating = sum(1 for c, _ in other.vals if clock < c)
            if num_dominating == 0:
                vals.append((clock.clone(), val))
        for clock, val in other.vals:
            num_dominating = sum(1 for c, _ in self.vals if clock < c)
            if num_dominating == 0:
                if all(existing_c != clock for existing_c, _ in vals):
                    vals.append((clock.clone(), val))
        self.vals = vals

    def apply(self, op: Put) -> None:
        """Apply a Put (`mvreg.rs:158-186`): drop dominated values, skip the
        op if an existing value dominates its clock."""
        if not isinstance(op, Put):
            raise TypeError(f"not an MVReg op: {op!r}")
        clock, val = op.clock.clone(), op.val
        if clock.is_empty():
            return
        # filter out all values dominated by the op clock
        self.vals = [(vc, v) for vc, v in self.vals if not (vc <= clock)]
        # check whether an existing entry dominates this op
        should_add = all(not (existing_clock > clock) for existing_clock, _ in self.vals)
        if should_add:
            self.vals.append((clock, val))

    def set(self, val, ctx) -> Put:
        """Build a Put op from an AddCtx; pure (`mvreg.rs:196-198`)."""
        return Put(clock=ctx.clock, val=val)

    def read(self) -> ReadCtx:
        """All concurrent values + the folded clock (`mvreg.rs:201-213`)."""
        clock = self.clock()
        return ReadCtx(
            add_clock=clock,
            rm_clock=clock.clone(),
            val=[v for _, v in self.vals],
        )

    def clock(self) -> VClock:
        """Join of every value clock (`mvreg.rs:216-222`)."""
        accum = VClock()
        for c, _ in self.vals:
            accum.merge(c)
        return accum

    def __str__(self) -> str:
        inner = ", ".join(f"{v}@{c}" for c, v in self.vals)
        return f"|{inner}|"

    def __repr__(self) -> str:
        return f"MVReg({self.vals!r})"
