"""Replication contracts — the framework's L0.

Mirrors `src/traits.rs`:

* :class:`CvRDT` — state-based replication: ``merge(other)`` must be a
  lattice join: commutative, associative, idempotent (`traits.rs:9-12`).
* :class:`CmRDT` — op-based replication: ``apply(op)``.  Ops from one actor
  must be replayed in the order that actor generated them; any interleaving
  across actors converges; ops are idempotent (`traits.rs:15-41`).
* :class:`Causal` — ``truncate(clock)`` garbage-collects causal history
  before the given clock (`traits.rs:44-47`).
* :class:`FunkyCvRDT` / :class:`FunkyCmRDT` — fallible variants for types
  (LWWReg) whose invariants can't be encoded in the type system
  (`traits.rs:53-75`).  In Python "fallible" means the methods may raise
  :class:`crdt_tpu_torch.error.CrdtError`.

The port's own copy of the JAX package's contracts.  The scalar engine
(``crdt_tpu_torch.scalar``, the bit-exact reference semantics) implements
them; the batch engine (``crdt_tpu_torch.batch``, dense tensors and CUDA
kernels) is held against it.
"""

from __future__ import annotations

import abc
from typing import Any, Generic, TypeVar

Op = TypeVar("Op")


class CvRDT(abc.ABC):
    """State-based CRDT: replicate by transmitting the entire state."""

    @abc.abstractmethod
    def merge(self, other) -> None:
        """Merge the given CRDT into the current CRDT (in place)."""


class CmRDT(abc.ABC, Generic[Op]):
    """Op-based CRDT: replicate with ops.

    Op-ordering law (`traits.rs:17-36`): a total order per actor's ops, a
    partial order across actors; any valid interleaving converges.  Ops are
    idempotent — any op may be applied more than once.
    """

    @abc.abstractmethod
    def apply(self, op: Op) -> None:
        """Apply an Op to the CRDT (in place)."""


class Causal(abc.ABC):
    """CRDTs are causal if they are built on top of vector clocks."""

    @abc.abstractmethod
    def truncate(self, clock) -> None:
        """Truncate the CRDT to remove anything before the clock."""


class FunkyCvRDT(abc.ABC):
    """Fallible CvRDT — ``merge`` may raise (e.g. LWWReg marker unicity)."""

    @abc.abstractmethod
    def merge(self, other) -> None:
        """Merge; raises :class:`crdt_tpu_torch.error.CrdtError` on conflict."""


class FunkyCmRDT(abc.ABC, Generic[Op]):
    """Fallible CmRDT — ``apply`` may raise."""

    @abc.abstractmethod
    def apply(self, op: Op) -> None:
        """Apply an Op; raises :class:`crdt_tpu_torch.error.CrdtError` on conflict."""


def is_crdt(x: Any) -> bool:
    return isinstance(x, (CvRDT, CmRDT, FunkyCvRDT, FunkyCmRDT))
