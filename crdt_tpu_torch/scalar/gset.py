"""GSet — grow-only set.

Mirrors `src/gset.rs`: a set whose merge is union
(`gset.rs:30-34`).  Like the reference, it exposes inherent methods only
(the reference does not implement the CvRDT/CmRDT traits for GSet and does
not re-export it from `lib.rs:6-15`; the README marks it unchecked).
"""

from __future__ import annotations

from typing import Hashable, Set


class GSet:
    """
    >>> a, b = GSet(), GSet()
    >>> a.insert(1); b.insert(2)
    >>> a.merge(b)                         # union
    >>> a.contains(1) and a.contains(2)
    True
    """

    __slots__ = ("value",)

    def __init__(self, value: Set[Hashable] | None = None):
        self.value: Set[Hashable] = set(value) if value else set()

    def clone(self) -> "GSet":
        return GSet(self.value)

    def __eq__(self, other) -> bool:
        return isinstance(other, GSet) and self.value == other.value

    def __hash__(self):
        return hash(frozenset(self.value))

    def merge(self, other: "GSet") -> None:
        """Union (`gset.rs:30-34`)."""
        for e in other.value:
            self.insert(e)

    def insert(self, element: Hashable) -> None:
        """Insert an element (`gset.rs:46-48`)."""
        self.value.add(element)

    def contains(self, element: Hashable) -> bool:
        """Membership test (`gset.rs:60-62`)."""
        return element in self.value

    def __repr__(self) -> str:
        return f"GSet({sorted(self.value, key=repr)!r})"
