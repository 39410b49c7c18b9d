"""PNCounterBatch — N inc/dec counters (`pncounter.rs`): two stacked
GCounter planes, biased ``[N, 2, A]`` (P = plane 0, N = plane 1,
`pncounter.rs:33-36`); merge is one max, value is P − N."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import counter_dtype
from ..device import resolve_device
from ..dtypes import bias_np, counters_to_numpy, to_device, torch_counter_dtype
from ..native import engine
from ..ops import clock_ops, counter_ops
from ..scalar.gcounter import GCounter
from ..scalar.pncounter import PNCounter
from .vclock_batch import row_to_vclock, vclock_rows
from .wirebulk import planes_from_wire, planes_to_wire


@dataclasses.dataclass
class PNCounterBatch:
    planes: torch.Tensor  # int[N, 2, A], biased

    @classmethod
    def zeros(cls, n: int, universe, device=None) -> "PNCounterBatch":
        cfg = universe.config
        return cls(planes=clock_ops.zeros((n, 2, cfg.num_actors),
                                          torch_counter_dtype(cfg.counter_bits),
                                          resolve_device(device)))

    @classmethod
    def from_numpy(cls, planes, device=None) -> "PNCounterBatch":
        """Unsigned numpy ``[N, 2, A]`` planes → a biased batch on ``device``."""
        return cls(planes=to_device(bias_np(planes), resolve_device(device)))

    def to_numpy(self) -> np.ndarray:
        return counters_to_numpy(self.planes)

    @staticmethod
    def _host(states, universe):
        return np.stack([vclock_rows([s.p.inner for s in states], universe),
                         vclock_rows([s.n.inner for s in states], universe)], axis=1)

    @classmethod
    def from_scalar(cls, states: Sequence[PNCounter], universe, device=None) -> "PNCounterBatch":
        return cls.from_numpy(cls._host(states, universe), device)

    def to_scalar(self, universe) -> list[PNCounter]:
        return [PNCounter(GCounter(row_to_vclock(p, universe)), GCounter(row_to_vclock(n, universe)))
                for p, n in self.to_numpy()]

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, device=None) -> "PNCounterBatch":
        """Bulk ingest of ``to_binary`` blobs (two clock bodies, P then N)
        through the host codec; equal to ``from_scalar([from_binary(b) ...])``."""
        cfg = universe.config
        (planes,) = planes_from_wire(
            blobs, universe, "pncounter", PNCounter,
            lambda buf, off: engine.pncounter_ingest_wire(buf, off, cfg.num_actors,
                                                          counter_dtype(cfg)),
            lambda states: (cls._host(states, universe),))
        return cls.from_numpy(planes, device)

    def to_wire(self, universe) -> list[bytes]:
        """Blobs byte-identical to ``to_binary`` of :meth:`to_scalar`."""
        return planes_to_wire(self, self.planes.shape[0], universe, "pncounter",
                              engine.pncounter_encode_wire, counters=(self.planes,))

    def merge(self, other: "PNCounterBatch") -> "PNCounterBatch":
        """`pncounter.rs:90-95`."""
        return PNCounterBatch(counter_ops.pncounter_merge(self.planes, other.planes))

    def inc(self, actor_idx) -> "PNCounterBatch":
        return self._bump(actor_idx, 0)

    def dec(self, actor_idx) -> "PNCounterBatch":
        return self._bump(actor_idx, 1)

    def _bump(self, actor_idx, plane: int) -> "PNCounterBatch":
        target = self.planes[:, plane]
        idx = torch.as_tensor(actor_idx, device=target.device).expand(target.shape[:-1])
        updated = clock_ops.witness(target, idx, clock_ops.inc_counter(target, idx))
        planes = self.planes.clone()
        planes[:, plane] = updated
        return PNCounterBatch(planes)

    def value(self):
        """int64 ``[N]``: P − N (`pncounter.rs:117-119`), wrapping as the
        JAX package's u64 sums cast to int64."""
        return counter_ops.pncounter_value(self.planes)
