"""Orswot — add-biased observed-remove set WithOut Tombstones (flagship type).

Mirrors `src/orswot.rs` (a port of riak_dt's ORSWOT):

* state: a set clock, per-member dot clocks, and a deferred-removal buffer
  for removes whose witnessing clock is ahead of the set clock
  (`orswot.rs:26-30`);
* ops: ``Add {dot, member}`` / ``Rm {clock, member}`` (`orswot.rs:38-53`);
* apply-Add dedups on the set clock (`orswot.rs:67-70`);
* merge implements the subtle dot-algebra (`orswot.rs:89-156`) — including
  the reference's asymmetry: a member present only in *self* keeps its full
  clock when any dot is novel (`orswot.rs:94-103`), while a member present
  only in *other* keeps the subtracted clock (`orswot.rs:132-138`);
* deferred removes are buffered, merged, and replayed (`orswot.rs:195-243`).

Every regression in the reference's ``quickcheck_evolution.log`` (same-dot
adds, deferred-only-in-other, entry-clock-vs-set-clock, …) has a named
fixture in ``tests/test_orswot.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Set

from ..traits import Causal, CmRDT, CvRDT
from .ctx import AddCtx, ReadCtx, RmCtx
from .vclock import ClockKey, Dot, VClock

Member = Hashable


@dataclasses.dataclass(frozen=True)
class Add:
    """Add a member to the set (`orswot.rs:39-45`)."""

    dot: Dot
    member: Any


@dataclasses.dataclass(frozen=True)
class Rm:
    """Remove a member under a witnessing clock (`orswot.rs:46-52`)."""

    clock: VClock
    member: Any


class Orswot(CvRDT, CmRDT, Causal):
    """
    The causal read-modify-write protocol (`ctx.rs:5-9` usage pattern):

    >>> s = Orswot()
    >>> add_op = s.add("apple", s.value().derive_add_ctx("alice"))
    >>> s.apply(add_op)                    # mutators are pure; apply commits
    >>> replica = Orswot()
    >>> replica.apply(add_op)              # ship the op, not the state
    >>> sorted(replica.value().val)
    ['apple']
    >>> rm_op = s.remove("apple", s.contains("apple").derive_rm_ctx())
    >>> s.apply(rm_op)
    >>> s.merge(replica)                   # remove wins: replica never re-adds
    >>> sorted(s.value().val)
    []
    """

    __slots__ = ("clock", "entries", "deferred")

    def __init__(self):
        self.clock = VClock()
        self.entries: Dict[Member, VClock] = {}
        # deferred removals, keyed by the (frozen) witnessing clock
        # (reference: HashMap<VClock, HashSet<M>>, orswot.rs:29)
        self.deferred: Dict[ClockKey, Set[Member]] = {}

    @classmethod
    def default(cls) -> "Orswot":
        return cls()

    def clone(self) -> "Orswot":
        c = Orswot()
        c.clock = self.clock.clone()
        c.entries = {m: vc.clone() for m, vc in self.entries.items()}
        c.deferred = {k: set(v) for k, v in self.deferred.items()}
        return c

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Orswot)
            and self.clock == other.clock
            and self.entries == other.entries
            and self.deferred == other.deferred
        )

    __hash__ = None  # type: ignore[assignment]

    # -- op path ----------------------------------------------------------

    def apply(self, op) -> None:
        """Apply an Add or Rm (`orswot.rs:64-84`)."""
        if isinstance(op, Add):
            if self.clock.get(op.dot.actor) >= op.dot.counter:
                return  # we've already seen this op
            member_vclock = self.entries.setdefault(op.member, VClock())
            member_vclock.apply(op.dot)
            self.clock.apply(op.dot)
            self.apply_deferred()
        elif isinstance(op, Rm):
            self.apply_remove(op.member, op.clock)
        else:
            raise TypeError(f"not an Orswot op: {op!r}")

    def add(self, member, ctx: AddCtx) -> Add:
        """Build an Add op; pure (`orswot.rs:185-187`)."""
        return Add(dot=ctx.dot, member=member)

    def remove(self, member, ctx: RmCtx) -> Rm:
        """Build a Rm op; pure (`orswot.rs:190-192`)."""
        return Rm(clock=ctx.clock, member=member)

    def apply_remove(self, member, clock: VClock) -> None:
        """Remove under a witnessing clock, deferring if the clock is ahead
        of ours (`orswot.rs:195-211`)."""
        if not (clock <= self.clock):
            deferred_drops = self.deferred.pop(clock.key(), set())
            deferred_drops.add(member)
            self.deferred[clock.key()] = deferred_drops

        if member in self.entries:
            existing_clock = self.entries.pop(member)
            existing_clock.subtract(clock)
            if not existing_clock.is_empty():
                self.entries[member] = existing_clock

    # -- state path -------------------------------------------------------

    def merge(self, other: "Orswot") -> None:
        """The ORSWOT dot-algebra merge (`orswot.rs:89-156`)."""
        other_remaining = {m: vc for m, vc in other.entries.items()}
        keep: Dict[Member, VClock] = {}
        for entry, clock in list(self.entries.items()):
            clock = clock.clone()
            if entry not in other.entries:
                # Absence on the other side is ambiguous: either the peer
                # observed the add and removed it (its set clock covers our
                # dots ⇒ drop), or the add simply never reached it (some dot
                # is novel ⇒ survive, with the full clock — the asymmetry
                # vs the novel-in-other branch below).  (`orswot.rs:94-103`)
                if clock <= other.clock:
                    pass
                else:
                    keep[entry] = clock
            else:
                # Both sides hold the member; survival still depends on the
                # dot algebra, not mere presence.  (`orswot.rs:105-129`)
                other_entry_clock = other.entries[entry].clone()
                common = clock.intersection(other_entry_clock)
                clock.subtract(common)
                other_entry_clock.subtract(common)
                clock.subtract(other.clock)
                other_entry_clock.subtract(self.clock)
                common.merge(clock)
                common.merge(other_entry_clock)
                if not common.is_empty():
                    keep[entry] = common
                del other_remaining[entry]

        for entry, clock in other_remaining.items():
            # novel additions witnessed by other (`orswot.rs:132-138`)
            clock = clock.clone()
            clock.subtract(self.clock)
            if not clock.is_empty():
                keep[entry] = clock

        # merge deferred removals (`orswot.rs:141-148`); snapshot first —
        # unlike Rust's &mut self / &Self split, Python allows other IS self
        for clock_key, deferred in list(other.deferred.items()):
            our_deferred = self.deferred.pop(clock_key, set())
            our_deferred |= deferred
            self.deferred[clock_key] = set(our_deferred)

        self.entries = keep
        self.clock.merge(other.clock)
        self.apply_deferred()

    def truncate(self, clock: VClock) -> None:
        """Causal truncate via merge-with-empty (`orswot.rs:159-172`)."""
        empty_set = Orswot()
        empty_set.clock = clock.clone()
        self.merge(empty_set)
        self.clock.subtract(clock)
        for member_clock in self.entries.values():
            member_clock.subtract(clock)

    def apply_deferred(self) -> None:
        """Replay buffered removes (`orswot.rs:235-243`)."""
        deferred = self.deferred
        self.deferred = {}
        for clock_key, entries in deferred.items():
            clock = VClock.from_key(clock_key)
            for member in entries:
                self.apply_remove(member, clock)

    # -- reads ------------------------------------------------------------

    def contains(self, member) -> ReadCtx:
        """Membership test with causal context (`orswot.rs:214-224`)."""
        member_clock = self.entries.get(member)
        return ReadCtx(
            add_clock=self.clock.clone(),
            rm_clock=member_clock.clone() if member_clock is not None else VClock(),
            val=member_clock is not None,
        )

    def value(self) -> ReadCtx:
        """Current members with causal context (`orswot.rs:227-233`)."""
        return ReadCtx(
            add_clock=self.clock.clone(),
            rm_clock=self.clock.clone(),
            val=set(self.entries.keys()),
        )

    def __repr__(self) -> str:
        return (
            f"Orswot(clock={self.clock!r}, entries={self.entries!r}, "
            f"deferred={self.deferred!r})"
        )
