"""LWWRegBatch — N last-write-wins registers (`lwwreg.rs`).

Two columns on the device: ``vals`` (raw payload ids, int64) and
``markers`` (biased int64).  Markers are u64 timestamps whatever
``counter_bits`` says (`lwwreg.rs:16-24`: an epoch-millis marker
overflows u32).  ``merge`` raises the equal-marker conflicts as
:class:`~crdt_tpu_torch.error.ConflictingMarker` (`lwwreg.rs:56-66`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import (
    as_counters, as_payload, bias_np, counters_to_numpy, payload_to_device, payload_to_numpy,
    to_device,
)
from ..error import ConflictingMarker
from ..native import engine
from ..ops import lww_ops
from ..scalar.lwwreg import LWWReg
from .wirebulk import planes_from_wire, planes_to_wire


@dataclasses.dataclass
class LWWRegBatch:
    vals: torch.Tensor  # int64[N], raw payload ids
    markers: torch.Tensor  # int64[N], biased

    @classmethod
    def from_numpy(cls, vals, markers, device=None) -> "LWWRegBatch":
        """``uint64`` ids and markers → a batch on ``device``."""
        dev = resolve_device(device)
        return cls(vals=payload_to_device(np.asarray(vals, np.uint64), dev),
                   markers=to_device(bias_np(np.asarray(markers, np.uint64)), dev))

    def to_numpy(self):
        """``(vals, markers)`` as ``uint64`` numpy columns."""
        return payload_to_numpy(self.vals), counters_to_numpy(self.markers)

    @staticmethod
    def _host(states, universe):
        return (np.asarray([universe.member_id(s.val) for s in states], dtype=np.uint64),
                np.asarray([s.marker for s in states], dtype=np.uint64))

    @classmethod
    def from_scalar(cls, states: Sequence[LWWReg], universe, device=None) -> "LWWRegBatch":
        return cls.from_numpy(*cls._host(states, universe), device=device)

    def to_scalar(self, universe) -> list[LWWReg]:
        vals, markers = self.to_numpy()
        return [LWWReg(val=universe.members.lookup(int(v)), marker=int(m))
                for v, m in zip(vals.tolist(), markers.tolist())]

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, device=None) -> "LWWRegBatch":
        """Bulk ingest of ``to_binary`` blobs through the host codec; equal
        to ``from_scalar([from_binary(b) ...])``."""
        planes = planes_from_wire(blobs, universe, "lww", LWWReg, engine.lww_ingest_wire,
                                  lambda states: cls._host(states, universe))
        return cls.from_numpy(*planes, device=device)

    def to_wire(self, universe) -> list[bytes]:
        """Blobs byte-identical to ``to_binary`` of :meth:`to_scalar`; ids or
        markers at or above 2^63 take the Python encoder."""
        return planes_to_wire(self, self.vals.shape[0], universe, "lww",
                              lambda host: engine.lww_encode_wire(*host),
                              counters=(self.markers,), payload=(self.vals,))

    def merge(self, other: "LWWRegBatch", check: bool = True) -> "LWWRegBatch":
        """Pairwise merge; raises :class:`ConflictingMarker` where equal
        markers hold different values (one host read), unless ``check`` is
        False (see :meth:`merge_with_conflicts`)."""
        merged, conflict = self.merge_with_conflicts(other)
        if check and bool(conflict.any()):
            idx = torch.nonzero(conflict)[:, 0]
            raise ConflictingMarker(f"{idx.shape[0]} conflicting marker(s), first at {int(idx[0])}")
        return merged

    def merge_with_conflicts(self, other: "LWWRegBatch"):
        """``(merged, conflict bitmap)``, without a host read."""
        vals, markers, conflict = lww_ops.merge(self.vals, self.markers, other.vals, other.markers)
        return LWWRegBatch(vals, markers), conflict

    def update(self, new_vals, new_markers) -> "LWWRegBatch":
        """Batched ``update`` (`lwwreg.rs:104-118`) with unsigned ids and
        markers (tensors: raw ids, biased markers); raises on a conflict."""
        vals, markers, conflict = lww_ops.update(
            self.vals, self.markers, as_payload(new_vals, self.vals),
            as_counters(new_markers, torch.int64, self.markers.device))
        if bool(conflict.any()):
            raise ConflictingMarker()
        return LWWRegBatch(vals, markers)
