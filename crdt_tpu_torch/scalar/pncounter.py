"""PNCounter — increment/decrement counter as two GCounters.

Mirrors `src/pncounter.rs`: increments (P) and decrements (N)
live in separate internal G-Counters (`pncounter.rs:33-36`); merge merges P
and N (`pncounter.rs:90-95`); value is P − N (`pncounter.rs:117-119`).
Ops carry a witnessing dot and a direction (`pncounter.rs:39-56`).
"""

from __future__ import annotations

import dataclasses
import enum

from ..traits import CmRDT, CvRDT
from .gcounter import GCounter
from .vclock import Actor, Dot


class Dir(enum.Enum):
    """The direction of an op (`pncounter.rs:39-45`)."""

    POS = "pos"
    NEG = "neg"


@dataclasses.dataclass(frozen=True)
class Op:
    """A counter mutation: witnessing dot + direction (`pncounter.rs:49-56`)."""

    dot: Dot
    dir: Dir


class PNCounter(CvRDT, CmRDT):
    """
    >>> a, b = PNCounter(), PNCounter()
    >>> a.apply(a.inc("A"))
    >>> a.apply(a.inc("A"))
    >>> b.apply(b.dec("B"))
    >>> a.merge(b)
    >>> a.value()                # 2 increments - 1 decrement
    1
    """

    __slots__ = ("p", "n")

    def __init__(self, p: GCounter | None = None, n: GCounter | None = None):
        self.p = p if p is not None else GCounter()
        self.n = n if n is not None else GCounter()

    def clone(self) -> "PNCounter":
        return PNCounter(self.p.clone(), self.n.clone())

    # ordering by value (`pncounter.rs:58-77`)
    def __eq__(self, other) -> bool:
        return isinstance(other, PNCounter) and self.value() == other.value()

    def __lt__(self, other: "PNCounter") -> bool:
        return self.value() < other.value()

    def __le__(self, other: "PNCounter") -> bool:
        return self.value() <= other.value()

    def __gt__(self, other: "PNCounter") -> bool:
        return self.value() > other.value()

    def __ge__(self, other: "PNCounter") -> bool:
        return self.value() >= other.value()

    def __hash__(self):
        return hash((self.p, self.n))

    def apply(self, op: Op) -> None:
        """Route the dot on direction (`pncounter.rs:79-88`)."""
        if op.dir is Dir.POS:
            self.p.apply(op.dot)
        else:
            self.n.apply(op.dot)

    def merge(self, other: "PNCounter") -> None:
        """Merge P with P, N with N (`pncounter.rs:90-95`)."""
        self.p.merge(other.p)
        self.n.merge(other.n)

    def inc(self, actor: Actor) -> Op:
        """Increment op (`pncounter.rs:107-109`)."""
        return Op(dot=self.p.inc(actor), dir=Dir.POS)

    def dec(self, actor: Actor) -> Op:
        """Decrement op (`pncounter.rs:112-114`)."""
        return Op(dot=self.n.inc(actor), dir=Dir.NEG)

    def value(self) -> int:
        """P − N (`pncounter.rs:117-119`)."""
        return self.p.value() - self.n.value()

    def __repr__(self) -> str:
        return f"PNCounter(p={self.p!r}, n={self.n!r})"
