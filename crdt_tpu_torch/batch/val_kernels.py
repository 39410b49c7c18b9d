"""Value kernels — the batched analogue of the ``V: Val<A>`` bound
(`map.rs:16-25`): a small frozen object that merges, truncates, grows and
zeroes a dense value state, rank-polymorphic over leading batch axes.
Only :class:`MVRegKernel` so far; its state is the tuple ``(clocks,
vals)`` of :mod:`~crdt_tpu_torch.ops.mvreg_ops` (biased clocks, raw
payload ids)."""

from __future__ import annotations

import dataclasses

import torch

from ..dtypes import torch_counter_dtype, zero_of
from ..ops import clock_ops, mvreg_ops


@dataclasses.dataclass(frozen=True)
class MVRegKernel:
    """Nested multi-value register (`mvreg.rs`)."""

    mv_capacity: int
    num_actors: int
    counter_bits: int = 64

    @classmethod
    def from_config(cls, cfg) -> "MVRegKernel":
        return cls(mv_capacity=cfg.mv_capacity, num_actors=cfg.num_actors,
                   counter_bits=cfg.counter_bits)

    def zeros(self, batch_shape, device=None):
        dt = torch_counter_dtype(self.counter_bits)
        return (clock_ops.zeros((*batch_shape, self.mv_capacity, self.num_actors), dt, device),
                torch.zeros((*batch_shape, self.mv_capacity), dtype=dt, device=device))

    def merge(self, va, vb):
        clocks, vals, keep = mvreg_ops.merge(va[0], va[1], vb[0], vb[1])
        clocks, vals, over = mvreg_ops.compact(clocks, vals, keep, self.mv_capacity)
        return (clocks, vals), over

    def truncate(self, v, clock):
        """`mvreg.rs:100-113`: subtract ``clock`` (biased ``[..., A]``) from
        every value's clock, dropping values whose clock empties."""
        new = clock_ops.subtract(v[0], clock[..., None, :])
        live = mvreg_ops.active(new)
        z = torch.full((), zero_of(new.dtype), dtype=new.dtype, device=new.device)
        out = (torch.where(live[..., None], new, z), torch.where(live, v[1], 0))
        return out, torch.zeros(new.shape[:-2], dtype=torch.bool, device=new.device)

    def apply_put(self, v, op_clock, op_val):
        """Nested ``Op::Put`` (`mvreg.rs:158-186`)."""
        c2, v2, keep = mvreg_ops.apply_put(v[0], v[1], op_clock, op_val)
        c2, v2, over = mvreg_ops.compact(c2, v2, keep, self.mv_capacity)
        return (c2, v2), over

    def grow_state(self, v, target: "MVRegKernel"):
        """Pad a state built under ``self`` to ``target``'s antichain (new
        slots dead: the biased zero clock, payload 0)."""
        pad = target.mv_capacity - self.mv_capacity
        if pad < 0:
            raise ValueError("grow_state cannot shrink")
        if pad == 0:
            return v
        clocks, vals = v
        extra = clock_ops.zeros((*clocks.shape[:-2], pad, clocks.shape[-1]), clocks.dtype,
                                clocks.device)
        return (torch.cat([clocks, extra], dim=-2),
                torch.cat([vals, vals.new_zeros((*vals.shape[:-1], pad))], dim=-1))
