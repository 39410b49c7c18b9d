"""Scalar causality kernel: VClock and Dot — the framework's L1.

Bit-exact reference semantics of `src/vclock.rs`.  Actors may
be any hashable, orderable Python value (the reference's ``Actor`` trait,
`vclock.rs:27-28`); counters are unsigned ints (``Counter = u64``,
`vclock.rs:23`).  An actor absent from the clock has an implied counter of 0
(`vclock.rs:206-210`).

The comparison operators implement the lattice *partial* order
(`vclock.rs:59-71`): concurrent clocks compare False under every operator.
Use :meth:`VClock.compare` to get the four-way outcome explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, Iterator, Optional, Tuple

Actor = Hashable
Counter = int

# Key type used to index deferred maps (reference keys HashMaps by VClock,
# orswot.rs:29; Python needs an immutable key).
ClockKey = Tuple[Tuple[Actor, Counter], ...]


@dataclasses.dataclass(frozen=True)
class Dot:
    """A version marker for a single actor (`vclock.rs:34-39`)."""

    actor: Actor
    counter: Counter

    def to_vclock(self) -> "VClock":
        """``From<Dot> for VClock`` (`vclock.rs:273-279`)."""
        c = VClock()
        c.witness(self.actor, self.counter)
        return c


class VClock:
    """A standard vector clock: a mapping from actors to counters.

    The causal partial order mirrors `src/vclock.rs:59-71`
    (and the runnable example style of `vclock.rs:88-102`):

    >>> a, b = VClock(), VClock()
    >>> a.apply(a.inc("A"))
    >>> b.apply(b.inc("B"))
    >>> a.concurrent(b)          # neither saw the other's event
    True
    >>> a.merge(b)               # lattice join: pointwise max
    >>> a >= b and a.get("A") == 1 and a.get("B") == 1
    True
    >>> b <= a and not a <= b    # b is now strictly dominated
    True
    """

    __slots__ = ("dots",)

    def __init__(self, dots: Optional[Dict[Actor, Counter]] = None):
        self.dots: Dict[Actor, Counter] = dict(dots) if dots else {}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_iter(cls, it: Iterable[Tuple[Actor, Counter]]) -> "VClock":
        """``FromIterator`` (`vclock.rs:255-265`): witnesses each pair."""
        c = cls()
        for actor, counter in it:
            c.witness(actor, counter)
        return c

    def clone(self) -> "VClock":
        return VClock(self.dots)

    # -- core reads -------------------------------------------------------

    def get(self, actor: Actor) -> Counter:
        """Counter for this actor; absent actors have an implied 0."""
        return self.dots.get(actor, 0)

    def is_empty(self) -> bool:
        return not self.dots

    def __iter__(self) -> Iterator[Tuple[Actor, Counter]]:
        return iter(self.dots.items())

    def __len__(self) -> int:
        return len(self.dots)

    def key(self) -> ClockKey:
        """Immutable snapshot usable as a dict key (sorted for determinism)."""
        return tuple(sorted(self.dots.items(), key=lambda kv: repr(kv[0])))

    @classmethod
    def from_key(cls, key: ClockKey) -> "VClock":
        return cls(dict(key))

    # -- partial order (`vclock.rs:59-71`) -------------------------------

    def compare(self, other: "VClock") -> Optional[int]:
        """-1 if self < other, 0 if equal, 1 if self > other, None if concurrent."""
        if self.dots == other.dots:
            return 0
        if all(self.get(w) >= c for w, c in other.dots.items()):
            return 1
        if all(other.get(w) >= c for w, c in self.dots.items()):
            return -1
        return None

    def __eq__(self, other) -> bool:
        return isinstance(other, VClock) and self.dots == other.dots

    def __hash__(self):
        return hash(self.key())

    def __le__(self, other: "VClock") -> bool:
        cmp = self.compare(other)
        return cmp is not None and cmp <= 0

    def __lt__(self, other: "VClock") -> bool:
        return self.compare(other) == -1

    def __ge__(self, other: "VClock") -> bool:
        cmp = self.compare(other)
        return cmp is not None and cmp >= 0

    def __gt__(self, other: "VClock") -> bool:
        return self.compare(other) == 1

    def concurrent(self, other: "VClock") -> bool:
        """True if the two clocks have diverged (`vclock.rs:200-202`)."""
        return self.compare(other) is None

    # -- mutation ---------------------------------------------------------

    def witness(self, actor: Actor, counter: Counter) -> None:
        """Possibly store a new counter if it dominates (`vclock.rs:159-163`)."""
        if not (self.get(actor) >= counter):
            self.dots[actor] = counter

    def apply(self, dot: Dot) -> None:
        """CmRDT apply: witness the dot (`vclock.rs:123-129`)."""
        self.witness(dot.actor, dot.counter)

    def merge(self, other: "VClock") -> None:
        """CvRDT merge: pointwise max via witness (`vclock.rs:131-137`)."""
        for actor, counter in other.dots.items():
            self.witness(actor, counter)

    def inc(self, actor: Actor) -> Dot:
        """Next dot for this actor; pure — does not mutate (`vclock.rs:182-185`)."""
        return Dot(actor, self.get(actor) + 1)

    def truncate(self, other: "VClock") -> None:
        """Causal truncate: greatest-lower-bound (`vclock.rs:103-120`).

        Each counter drops to ``min(count, other.get(actor))``; actors whose
        min is 0 are removed (implied-zero rule).
        """
        to_remove = []
        for actor, count in self.dots.items():
            min_count = min(count, other.get(actor))
            if min_count > 0:
                self.dots[actor] = min_count
            else:
                to_remove.append(actor)
        for actor in to_remove:
            del self.dots[actor]

    def intersection(self, other: "VClock") -> "VClock":
        """Common (same actor AND same counter) dots (`vclock.rs:219-228`)."""
        dots = {}
        for actor, counter in self.dots.items():
            if other.get(actor) == counter:
                dots[actor] = counter
        return VClock(dots)

    def subtract(self, other: "VClock") -> None:
        """Forget actors that appear in ``other`` with descendent dots
        (`vclock.rs:236-242`): remove actor iff ``other[a] >= self[a]``.
        """
        for actor, counter in other.dots.items():
            if actor in self.dots and counter >= self.dots[actor]:
                del self.dots[actor]

    # -- display (`vclock.rs:73-84`) --------------------------------------

    def __str__(self) -> str:
        # BTreeMap iteration order = sorted by actor (`vclock.rs:76`);
        # mixed-type actor sets (untypical) fall back to repr order
        try:
            items = sorted(self.dots.items())
        except TypeError:
            items = sorted(self.dots.items(), key=lambda kv: repr(kv[0]))
        inner = ", ".join(f"{a}->{c}" for a, c in items)
        return f"({inner})"

    def __repr__(self) -> str:
        return f"VClock({self.dots!r})"
