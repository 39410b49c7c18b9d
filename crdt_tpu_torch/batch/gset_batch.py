"""GSetBatch — N grow-only sets as a membership bitmap (`gset.rs`):
``bool[N, U]`` over the interned member universe; merge is one OR."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import to_device
from ..native import engine
from ..scalar.gset import GSet
from .wirebulk import planes_from_wire, planes_to_wire


@dataclasses.dataclass
class GSetBatch:
    bits: torch.Tensor  # bool[N, U]

    @classmethod
    def zeros(cls, n: int, member_capacity: int, device=None) -> "GSetBatch":
        return cls(bits=torch.zeros((n, member_capacity), dtype=torch.bool,
                                    device=resolve_device(device)))

    @classmethod
    def from_numpy(cls, bits, device=None) -> "GSetBatch":
        return cls(bits=to_device(np.asarray(bits, dtype=bool), resolve_device(device)))

    def to_numpy(self) -> np.ndarray:
        return self.bits.cpu().numpy()

    @staticmethod
    def _host(states, universe, member_capacity):
        buf = np.zeros((len(states), member_capacity), dtype=bool)
        for i, s in enumerate(states):
            for e in s.value:
                mid = universe.member_id(e)
                if mid >= member_capacity:
                    raise ValueError(
                        f"member universe overflow: id {mid} >= capacity {member_capacity}")
                buf[i, mid] = True
        return buf

    @classmethod
    def from_scalar(cls, states: Sequence[GSet], universe, member_capacity: int,
                    device=None) -> "GSetBatch":
        return cls.from_numpy(cls._host(states, universe, member_capacity), device)

    def to_scalar(self, universe) -> list[GSet]:
        return [GSet({universe.members.lookup(int(i)) for i in np.nonzero(row)[0]})
                for row in self.to_numpy()]

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, member_capacity: int,
                  device=None) -> "GSetBatch":
        """Bulk ingest of ``to_binary`` blobs through the host codec; equal
        to ``from_scalar([from_binary(b) ...], uni, member_capacity)``."""
        (bits,) = planes_from_wire(
            blobs, universe, "gset", GSet,
            lambda buf, off: engine.gset_ingest_wire(buf, off, member_capacity),
            lambda states: (cls._host(states, universe, member_capacity),),
            errors={2: "member universe overflow: object {i} has a member id >= capacity "
                       f"{member_capacity}"})
        return cls.from_numpy(bits, device)

    def to_wire(self, universe) -> list[bytes]:
        """Blobs byte-identical to ``to_binary`` of :meth:`to_scalar`."""
        return planes_to_wire(self, self.bits.shape[0], universe, "gset", engine.gset_encode_wire)

    def merge(self, other: "GSetBatch", check: bool = True) -> "GSetBatch":
        """Union (`gset.rs:30-34`), the narrower side widened first (new
        columns are absent, so widening changes no state).  ``check`` is the
        executor's uniform signature: a union cannot overflow."""
        w = max(self.member_capacity, other.member_capacity)
        return GSetBatch(self.with_capacity(w).bits | other.with_capacity(w).bits)

    # -- the executor's elastic-capacity protocol: the bitmap width is the
    # one growable axis; merge itself never overflows

    @property
    def member_capacity(self) -> int:
        return self.bits.shape[-1]

    @property
    def deferred_capacity(self) -> int:
        return 0

    def with_capacity(self, member_capacity: int | None = None,
                      deferred_capacity: int | None = None) -> "GSetBatch":
        """Widen the bitmap (new columns absent); never shrinks."""
        if deferred_capacity:
            raise ValueError("GSetBatch has no deferred axis to grow")
        w = self.member_capacity
        new_w = w if member_capacity is None else member_capacity
        if new_w < w:
            raise ValueError("with_capacity cannot shrink (would drop members)")
        if new_w == w:
            return self
        pad = self.bits.new_zeros((*self.bits.shape[:-1], new_w - w))
        return GSetBatch(torch.cat([self.bits, pad], dim=-1))

    def _check_ids(self, member_ids) -> torch.Tensor:
        """Member ids as a device tensor; ids past the bitmap width raise
        ``ValueError`` (the registry is unbounded, the bitmap is not)."""
        if not isinstance(member_ids, torch.Tensor):
            member_ids = np.asarray(member_ids)
        ids = torch.as_tensor(member_ids, device=self.bits.device)
        bad = (ids < 0) | (ids >= self.member_capacity)
        if bool(bad.any()):
            raise ValueError(f"member id(s) {ids[bad].tolist()} out of bitmap capacity "
                             f"{self.member_capacity}")
        return ids.to(torch.int64)

    def insert(self, member_ids) -> "GSetBatch":
        ids = self._check_ids(member_ids)
        onehot = torch.arange(self.member_capacity, device=ids.device) == ids[..., None]
        return GSetBatch(self.bits | onehot)

    def contains(self, member_ids):
        ids = self._check_ids(member_ids)
        return torch.take_along_dim(self.bits, ids[..., None], dim=-1)[..., 0]
