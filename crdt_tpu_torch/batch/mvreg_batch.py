"""MVRegBatch — N multi-value registers (`mvreg.rs`).

A padded antichain per register: biased ``clocks [N, K, A]`` and raw
payload ids ``vals [N, K]`` (a slot is live iff its clock is not empty).
Merge keeps the mutually undominated values of both sides, deduplicated
by clock (`mvreg.rs:121-153`), and packs them into K slots, raising
:class:`~crdt_tpu_torch.error.CapacityOverflowError` on overflow.  The
pairwise dominance tests build ``[n, K, K, A]`` comparisons, so merges
run over object chunks of at most ``2^27`` such elements.  The bodies
are :class:`~crdt_tpu_torch.batch.val_kernels.MVRegKernel`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import counter_dtype
from ..device import resolve_device
from ..dtypes import (
    as_counters, as_payload, bias_np, counters_to_numpy, payload_to_device, payload_to_numpy,
    to_device,
)
from ..error import CapacityOverflowError
from ..native import engine
from ..ops import mvreg_ops
from ..scalar.mvreg import MVReg
from .val_kernels import MVRegKernel
from .vclock_batch import row_to_vclock
from .wirebulk import planes_from_wire, planes_to_wire

_PAIR_ELEMS = 1 << 27


def _chunked_merge(kern, a, b):
    """``kern.merge(a, b)`` over object chunks whose ``[n, K, K, A]``
    comparisons stay under ``_PAIR_ELEMS`` elements."""
    n = a[0].shape[0]
    step = max(1, _PAIR_ELEMS // max(1, a[0].shape[-2] * b[0].shape[-2] * a[0].shape[-1]))
    if n <= step:
        return kern.merge(a, b)
    parts = [kern.merge(tuple(x[i:i + step] for x in a), tuple(x[i:i + step] for x in b))
             for i in range(0, n, step)]
    cat = [torch.cat(p) for p in zip(*((c, v, over) for (c, v), over in parts))]
    return (cat[0], cat[1]), cat[2]


def mvreg_scalars(clocks, vals, universe) -> list[MVReg]:
    """Scalar registers of unsigned numpy planes ``clocks [n, K, A]``,
    ``vals [n, K]``."""
    return [MVReg([(row_to_vclock(c, universe), universe.members.lookup(int(v)))
                   for c, v in zip(cs, vs) if c.any()])
            for cs, vs in zip(clocks, vals)]


def _overflow_check(overflow):
    if bool(overflow.any()):
        raise CapacityOverflowError("MVReg antichain overflow: raise CrdtConfig.mv_capacity",
                                    member=True, deferred=False)


@dataclasses.dataclass
class MVRegBatch:
    clocks: torch.Tensor  # int[N, K, A], biased
    vals: torch.Tensor  # int[N, K], raw payload ids

    @classmethod
    def zeros(cls, n: int, universe, device=None) -> "MVRegBatch":
        return cls(*MVRegKernel.from_config(universe.config).zeros((n,), resolve_device(device)))

    @classmethod
    def from_numpy(cls, clocks, vals, device=None) -> "MVRegBatch":
        """Unsigned numpy clocks and payload ids (one dtype) → a batch on
        ``device``."""
        dev = resolve_device(device)
        return cls(to_device(bias_np(clocks), dev), payload_to_device(vals, dev))

    def to_numpy(self):
        return counters_to_numpy(self.clocks), payload_to_numpy(self.vals)

    @staticmethod
    def _host(states, universe):
        cfg = universe.config
        k, dt = cfg.mv_capacity, counter_dtype(cfg)
        clocks = np.zeros((len(states), k, cfg.num_actors), dtype=dt)
        vals = np.zeros((len(states), k), dtype=dt)
        for i, reg in enumerate(states):
            if len(reg.vals) > k:
                raise ValueError(f"register {i} has {len(reg.vals)} values > mv_capacity {k}")
            for j, (vc, val) in enumerate(reg.vals):
                for actor, counter in vc.dots.items():
                    clocks[i, j, universe.actor_idx(actor)] = counter
                vals[i, j] = universe.member_id(val)
        return clocks, vals

    @classmethod
    def from_scalar(cls, states: Sequence[MVReg], universe, device=None) -> "MVRegBatch":
        return cls.from_numpy(*cls._host(states, universe), device=device)

    def to_scalar(self, universe) -> list[MVReg]:
        return mvreg_scalars(*self.to_numpy(), universe)

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, device=None) -> "MVRegBatch":
        """Bulk ingest of ``to_binary`` blobs through the host codec; equal
        to ``from_scalar([from_binary(b) ...])``."""
        cfg = universe.config
        k, a = cfg.mv_capacity, cfg.num_actors
        planes = planes_from_wire(
            blobs, universe, "mvreg", MVReg,
            lambda buf, off: engine.mvreg_ingest_wire(buf, off, k, a, counter_dtype(cfg)),
            lambda states: cls._host(states, universe),
            errors={2: f"register {{i}} has more values than mv_capacity {k}",
                    4: "register {i}: actor outside the identity registry range [0, {a})"})
        return cls.from_numpy(*planes, device=device)

    def to_wire(self, universe) -> list[bytes]:
        """Blobs byte-identical to ``to_binary`` of :meth:`to_scalar`; u64
        counters or ids at or above 2^63 take the Python encoder."""
        return planes_to_wire(self, self.clocks.shape[0], universe, "mvreg",
                              lambda host: engine.mvreg_encode_wire(*host),
                              counters=(self.clocks,), payload=(self.vals,))

    def merge(self, other: "MVRegBatch", check: bool = True) -> "MVRegBatch":
        """`mvreg.rs:121-153`; raises :class:`CapacityOverflowError` when an
        antichain outgrows K (the executor regrows with
        :meth:`with_capacity` and requeues)."""
        (clocks, vals), overflow = _chunked_merge(self._kernel(), (self.clocks, self.vals),
                                                  (other.clocks, other.vals))
        if check:
            _overflow_check(overflow)
        return MVRegBatch(clocks, vals)

    def apply_put(self, op_clocks, op_vals, check: bool = True) -> "MVRegBatch":
        """Batched ``Op::Put`` (`mvreg.rs:158-186`), one op per register:
        unsigned op clocks ``[N, A]`` and ids (tensors: biased, raw)."""
        op_clocks = as_counters(op_clocks, self.clocks.dtype, self.clocks.device)
        (clocks, vals), overflow = self._kernel().apply_put(
            (self.clocks, self.vals), op_clocks, as_payload(op_vals, self.vals))
        if check:
            _overflow_check(overflow)
        return MVRegBatch(clocks, vals)

    def read_clock(self):
        """The folded clock of each register, biased ``[N, A]``
        (`mvreg.rs:216-222`)."""
        return mvreg_ops.read_clock(self.clocks)

    def truncate(self, clock) -> "MVRegBatch":
        """``Causal::truncate`` (`mvreg.rs:100-113`) by one clock per
        register (unsigned ``[N, A]``; a tensor is taken as biased)."""
        t = as_counters(clock, self.clocks.dtype, self.clocks.device)
        (clocks, vals), _ = self._kernel().truncate((self.clocks, self.vals), t)
        return MVRegBatch(clocks, vals)

    def _kernel(self, mv_capacity: int | None = None) -> MVRegKernel:
        """The value kernel of this batch's shapes (antichain ``mv_capacity``,
        default its own)."""
        k, a = self.clocks.shape[-2:]
        return MVRegKernel(k if mv_capacity is None else mv_capacity, a,
                           self.clocks.element_size() * 8)

    # -- the executor's elastic-capacity protocol: the antichain is the one
    # growable axis, under the protocol's "member" name

    @property
    def member_capacity(self) -> int:
        return self.clocks.shape[-2]

    @property
    def deferred_capacity(self) -> int:
        return 0

    def with_capacity(self, member_capacity: int | None = None,
                      deferred_capacity: int | None = None) -> "MVRegBatch":
        """Pad the antichain to ``member_capacity`` slots; never shrinks."""
        if deferred_capacity:
            raise ValueError("MVRegBatch has no deferred axis to grow")
        k = self.member_capacity
        new_k = k if member_capacity is None else member_capacity
        if new_k < k:
            raise ValueError("with_capacity cannot shrink (would drop live slots)")
        if new_k == k:
            return self
        return MVRegBatch(*self._kernel().grow_state((self.clocks, self.vals),
                                                     self._kernel(new_k)))
