"""Read/write contexts — the causal read-modify-write protocol (L2).

Mirrors `src/ctx.rs`.  Reads return a :class:`ReadCtx`
carrying causal metadata; a client derives an :class:`AddCtx` (for mutations
that add information) or :class:`RmCtx` (for removals) from it and ships the
ctx back with the mutation.  Causality travels with the data — no network
layer is assumed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Generic, TypeVar

from .vclock import Actor, Dot, VClock

V = TypeVar("V")


@dataclasses.dataclass
class AddCtx:
    """Context for mutations that add new information (`ctx.rs:26-32`)."""

    clock: VClock
    dot: Dot

    def clone(self) -> "AddCtx":
        return AddCtx(clock=self.clock.clone(), dot=self.dot)


@dataclasses.dataclass
class RmCtx:
    """Context for mutations that remove information (`ctx.rs:37-40`)."""

    clock: VClock

    def clone(self) -> "RmCtx":
        return RmCtx(clock=self.clock.clone())


@dataclasses.dataclass
class ReadCtx(Generic[V]):
    """Data read from a CRDT plus the causal history of the read (`ctx.rs:12-21`)."""

    add_clock: VClock
    rm_clock: VClock
    val: Any

    def derive_add_ctx(self, actor: Actor) -> AddCtx:
        """Derive an AddCtx for an actor (`ctx.rs:45-53`): clone the add
        clock, mint the actor's next dot, and witness it."""
        clock = self.add_clock.clone()
        dot = clock.inc(actor)
        clock.apply(dot)
        return AddCtx(clock=clock, dot=dot)

    def derive_rm_ctx(self) -> RmCtx:
        """Derive a RmCtx (`ctx.rs:56-60`): clone the rm clock."""
        return RmCtx(clock=self.rm_clock.clone())


def sequential_add_ctxs(base_clock: VClock, actors) -> list:
    """The scalar clone-and-increment LOOP over one object's writes —
    the oracle a batched derive of add contexts is held against.

    Each write re-reads the clock the previous apply produced: derive
    an AddCtx (`ctx.rs:45-53`), then witness ONLY its dot — which is
    all ``CmRDT::apply`` witnesses (`orswot.rs:75-77`) — before the
    next write's read.  Interleaved actors therefore see each other's
    dots, and an actor absent from the base clock boots from the
    implied 0 (`vclock.rs:206-210`).  Returns one :class:`AddCtx` per
    entry of ``actors``, in order.
    """
    clock = base_clock.clone()
    out = []
    for actor in actors:
        ctx = ReadCtx(add_clock=clock, rm_clock=clock, val=None) \
            .derive_add_ctx(actor)
        out.append(ctx)
        clock.apply(ctx.dot)
    return out
