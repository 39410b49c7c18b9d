"""GCounter — grow-only witnessed counter.

Mirrors `src/gcounter.rs`: a newtype over :class:`VClock`
(`gcounter.rs:26-28`); ``inc`` mints a :class:`Dot` op (`gcounter.rs:71-73`);
``value`` is the sum of all counters (`gcounter.rs:76-78`).  Equality and
ordering are by *value*, not structure (`gcounter.rs:30-48`).
"""

from __future__ import annotations

from ..traits import CmRDT, CvRDT
from .vclock import Actor, Dot, VClock


class GCounter(CvRDT, CmRDT):
    """
    >>> a, b = GCounter(), GCounter()
    >>> a.apply(a.inc("A"))
    >>> b.apply(b.inc("B"))
    >>> a.apply(a.inc("A"))
    >>> a.merge(b)               # state-based replication
    >>> a.value()
    3
    >>> a.merge(b); a.value()    # idempotent: re-delivery is safe
    3
    """

    __slots__ = ("inner",)

    def __init__(self, inner: VClock | None = None):
        self.inner = inner if inner is not None else VClock()

    def clone(self) -> "GCounter":
        return GCounter(self.inner.clone())

    # ordering is by value (`gcounter.rs:30-48`)
    def __eq__(self, other) -> bool:
        return isinstance(other, GCounter) and self.value() == other.value()

    def __lt__(self, other: "GCounter") -> bool:
        return self.value() < other.value()

    def __le__(self, other: "GCounter") -> bool:
        return self.value() <= other.value()

    def __gt__(self, other: "GCounter") -> bool:
        return self.value() > other.value()

    def __ge__(self, other: "GCounter") -> bool:
        return self.value() >= other.value()

    def __hash__(self):
        return hash(self.inner)

    def apply(self, op: Dot) -> None:
        """CmRDT apply = witness the dot (`gcounter.rs:50-56`)."""
        self.inner.apply(op)

    def merge(self, other: "GCounter") -> None:
        """CvRDT merge = VClock join (`gcounter.rs:58-62`)."""
        self.inner.merge(other.inner)

    def inc(self, actor: Actor) -> Dot:
        """Increment op for this actor; pure (`gcounter.rs:71-73`)."""
        return self.inner.inc(actor)

    def value(self) -> int:
        """Current sum of the counter (`gcounter.rs:76-78`)."""
        return sum(self.inner.dots.values())

    def __repr__(self) -> str:
        return f"GCounter({self.inner.dots!r})"
