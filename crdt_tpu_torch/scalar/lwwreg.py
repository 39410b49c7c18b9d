"""LWWReg — last-write-wins register.

Mirrors `src/lwwreg.rs`: a value plus a marker that must grow
monotonically *and* be globally unique (`lwwreg.rs:16-24`).  Merge keeps the
value with the larger marker and raises :class:`ConflictingMarker` when the
markers are equal but the values differ (`lwwreg.rs:43-67`).  Op-based
replication ships the whole register: ``Op = Self``, ``apply = merge``
(`lwwreg.rs:69-77`).  Only the *Funky* (fallible) traits are implemented,
matching the reference.
"""

from __future__ import annotations

from ..error import ConflictingMarker
from ..traits import FunkyCmRDT, FunkyCvRDT


class LWWReg(FunkyCvRDT, FunkyCmRDT):
    """
    Runnable mirror of `src/lwwreg.rs:84-103`:

    >>> r = LWWReg()
    >>> r.update("draft", marker=1)
    >>> r.update("final", marker=9)
    >>> r.update("stale", marker=3)      # older marker: ignored
    >>> r.val
    'final'
    >>> other = LWWReg("conflict!", 9)   # same marker, different value
    >>> try:
    ...     r.merge(other)
    ... except ConflictingMarker:
    ...     print("conflict detected")
    conflict detected
    """

    __slots__ = ("val", "marker")

    def __init__(self, val=None, marker=0):
        # marker defaults to 0, matching the reference's M::default()
        # (`lwwreg.rs:34-41`) so LWWReg().update(v, m) works out of the box
        self.val = val
        self.marker = marker

    def clone(self) -> "LWWReg":
        return LWWReg(self.val, self.marker)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, LWWReg)
            and self.val == other.val
            and self.marker == other.marker
        )

    def __hash__(self):
        return hash((self.val, self.marker))

    def merge(self, other: "LWWReg") -> None:
        """Keep the larger marker; raise on equal-marker/different-val
        (`lwwreg.rs:56-66`)."""
        if other.marker > self.marker:
            self.val = other.val
            self.marker = other.marker
        elif other.marker == self.marker and other.val != self.val:
            raise ConflictingMarker()

    def apply(self, op: "LWWReg") -> None:
        """Op = the register itself; apply = merge (`lwwreg.rs:69-77`)."""
        self.merge(op)

    def update(self, val, marker) -> None:
        """Update witnessed by the given marker (`lwwreg.rs:104-118`).

        Smaller marker: no-op.  Equal marker with different val: raises.
        """
        if self.marker < marker:
            self.val = val
            self.marker = marker
        elif self.marker == marker and val != self.val:
            raise ConflictingMarker()
        # else: seen already or identical — no-op

    def __repr__(self) -> str:
        return f"LWWReg(val={self.val!r}, marker={self.marker!r})"
