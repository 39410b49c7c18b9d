"""VClockBatch — N dense vector clocks on the device (`vclock.rs`).

Biased counters ``[N, A]``, actor columns assigned by a
:class:`~crdt_tpu_torch.utils.interning.Universe`.  The clock-row base
class here also carries :class:`~crdt_tpu_torch.batch.gcounter_batch.
GCounterBatch` (a GCounter is a VClock, `gcounter.rs:26-28`): the package
edge (``from_numpy``/``to_numpy``, unsigned numpy planes as the JAX
package holds them), the scalar and wire legs, and the merge.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import counter_dtype
from ..device import resolve_device
from ..dtypes import as_counters, bias_np, counters_to_numpy, to_device, torch_counter_dtype
from ..ops import clock_ops
from ..scalar.vclock import VClock
from .wirebulk import WIRE_TAG_VCLOCK, clockish_from_wire, clockish_to_wire


def row_to_vclock(row, universe) -> VClock:
    """One unsigned numpy clock row as a scalar VClock."""
    vc = VClock()
    for idx in np.nonzero(row)[0]:
        vc.dots[universe.actors.lookup(int(idx))] = int(row[idx])
    return vc


def vclock_rows(clocks: Sequence[VClock], universe) -> np.ndarray:
    """Unsigned numpy rows ``[len(clocks), A]`` of scalar VClocks."""
    buf = np.zeros((len(clocks), universe.config.num_actors), dtype=counter_dtype(universe.config))
    for i, vc in enumerate(clocks):
        for actor, counter in vc.dots.items():
            buf[i, universe.actor_idx(actor)] = counter
    return buf


@dataclasses.dataclass
class _ClockRows:
    clocks: torch.Tensor  # int[N, A], biased

    _TAG = WIRE_TAG_VCLOCK
    _KIND = VClock

    @staticmethod
    def _inner(state) -> VClock:
        return state

    @staticmethod
    def _outer(vc: VClock):
        return vc

    @classmethod
    def zeros(cls, n: int, universe, device=None):
        cfg = universe.config
        return cls(clocks=clock_ops.zeros((n, cfg.num_actors), torch_counter_dtype(cfg.counter_bits),
                                          resolve_device(device)))

    @classmethod
    def from_numpy(cls, clocks, device=None):
        """Unsigned numpy clocks (``uint32`` or ``uint64``) → a biased batch
        on ``device`` (default ``"cuda"``)."""
        return cls(clocks=to_device(bias_np(clocks), resolve_device(device)))

    def to_numpy(self) -> np.ndarray:
        """The inverse of :meth:`from_numpy`."""
        return counters_to_numpy(self.clocks)

    @classmethod
    def from_scalar(cls, states: Sequence, universe, device=None):
        return cls.from_numpy(vclock_rows([cls._inner(s) for s in states], universe), device)

    def to_scalar(self, universe) -> list:
        return [self._outer(row_to_vclock(row, universe)) for row in self.to_numpy()]

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, device=None):
        """Bulk ingest of ``to_binary`` blobs through the host codec; equal
        to ``from_scalar([from_binary(b) ...])``.  A blob that does not
        decode or fit raises :class:`~crdt_tpu_torch.error.WireFormatError`."""
        return cls.from_numpy(clockish_from_wire(
            blobs, universe, cls._TAG, cls._KIND,
            lambda states: (vclock_rows([cls._inner(s) for s in states], universe),)), device)

    def to_wire(self, universe) -> list[bytes]:
        """Blobs byte-identical to ``to_binary`` of :meth:`to_scalar`."""
        return clockish_to_wire(self, universe, self._TAG)

    def merge(self, other):
        """Pairwise lattice join (`vclock.rs:131-137`)."""
        return type(self)(clocks=clock_ops.merge(self.clocks, other.clocks))

    def _rows(self, x):
        """``x`` (a scalar or one per clock) as a tensor of one per clock."""
        return torch.as_tensor(x, device=self.clocks.device).expand(self.clocks.shape[:-1])


class VClockBatch(_ClockRows):
    def witness(self, actor_idx, counter) -> "VClockBatch":
        """Scatter-max one dot per clock; ``counter`` unsigned (a tensor is
        taken as biased)."""
        counter = as_counters(counter, self.clocks.dtype, self.clocks.device)
        return VClockBatch(clock_ops.witness(self.clocks, self._rows(actor_idx),
                                             self._rows(counter)))

    def subtract(self, other: "VClockBatch") -> "VClockBatch":
        return VClockBatch(clock_ops.subtract(self.clocks, other.clocks))

    def intersection(self, other: "VClockBatch") -> "VClockBatch":
        return VClockBatch(clock_ops.intersection(self.clocks, other.clocks))

    def truncate(self, other: "VClockBatch") -> "VClockBatch":
        return VClockBatch(clock_ops.truncate(self.clocks, other.clocks))

    def leq(self, other: "VClockBatch"):
        return clock_ops.leq(self.clocks, other.clocks)

    def concurrent(self, other: "VClockBatch"):
        return clock_ops.concurrent(self.clocks, other.clocks)

    def is_empty(self):
        return clock_ops.is_empty(self.clocks)
