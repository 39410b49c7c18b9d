"""Value kernels — the batched analogue of the ``V: Val<A>`` bound
(`map.rs:16-25`): a small frozen object that merges, truncates, grows and
zeroes a dense value state, rank-polymorphic over leading batch axes, so
that :mod:`~crdt_tpu_torch.ops.map_ops` nests ``Map<K, MVReg>``,
``Map<K, Orswot>`` and ``Map<K, Map<K2, V>>`` alike.

Device protocol (``v`` a nested tuple of tensors, biased counters):
``zeros(batch_shape, device)``, ``zeros_like(v)``, ``merge(va, vb) -> (v,
overflow)``, ``truncate(v, clock) -> (v, overflow)`` (a no-op for the
biased zero clock), ``grown``, ``unified``, ``grow_state``.

Host protocol (the package edge, unsigned numpy planes as the JAX
package's): ``kinds()`` names each leaf a counter (``"c"``, biased on the
device), an id (``"i"``, int32, ``-1`` empty) or a payload (``"p"``, raw);
``from_numpy_vals``/``to_numpy_vals`` move a state across by those kinds;
``default_scalar``, ``scalar_val_type``, ``from_scalar_vals(scalars,
universe)`` → numpy planes with leaves ``[n, *inner]``, and
``to_scalar_vals(planes, universe)`` → scalar states.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..dtypes import (
    EMPTY, bias_np, counters_to_numpy, payload_to_device, payload_to_numpy, to_device,
    torch_counter_dtype, zero_of,
)
from ..ops import clock_ops, map_ops, mvreg_ops, orswot_ops


def _kind_map(fn, kinds, v):
    return tuple(_kind_map(fn, k, x) if isinstance(k, tuple) else fn(k, x)
                 for k, x in zip(kinds, v))


class _Leaves:
    """The protocol methods that follow from :meth:`kinds`."""

    def zeros_like(self, v):
        return _kind_map(lambda k, x: torch.full_like(
            x, zero_of(x.dtype) if k == "c" else EMPTY if k == "i" else 0), self.kinds(), v)

    def from_numpy_vals(self, v, device):
        """Unsigned numpy planes (the JAX package's) → the device state."""
        return _kind_map(lambda k, x: to_device(bias_np(x), device) if k == "c" else
                         to_device(np.asarray(x, np.int32), device) if k == "i" else
                         payload_to_device(x, device), self.kinds(), v)

    def to_numpy_vals(self, v):
        """Inverse of :meth:`from_numpy_vals`."""
        return _kind_map(lambda k, x: counters_to_numpy(x) if k == "c" else
                         x.cpu().numpy() if k == "i" else payload_to_numpy(x), self.kinds(), v)


@dataclasses.dataclass(frozen=True)
class MVRegKernel(_Leaves):
    """Nested multi-value register (`mvreg.rs`): ``(clocks [..., K, A],
    vals [..., K])``, biased clocks and raw payload ids."""

    mv_capacity: int
    num_actors: int
    counter_bits: int = 64

    @classmethod
    def from_config(cls, cfg) -> "MVRegKernel":
        return cls(mv_capacity=cfg.mv_capacity, num_actors=cfg.num_actors,
                   counter_bits=cfg.counter_bits)

    def kinds(self):
        return ("c", "p")

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

    def grown(self, factor: int) -> "MVRegKernel":
        return dataclasses.replace(self, mv_capacity=self.mv_capacity * factor)

    def unified(self, other) -> "MVRegKernel":
        """The pointwise-max-capacity kernel covering both sides; raises on
        a structural mismatch (type, actors, width)."""
        if (type(other) is not MVRegKernel or other.num_actors != self.num_actors
                or other.counter_bits != self.counter_bits):
            raise ValueError(f"incompatible value kernels: {self} vs {other}")
        return dataclasses.replace(self, mv_capacity=max(self.mv_capacity, other.mv_capacity))

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

    def default_scalar(self):
        from ..scalar.mvreg import MVReg

        return MVReg()

    def scalar_val_type(self):
        """The serializable ``Map.val_type`` of this kernel."""
        from ..scalar.mvreg import MVReg

        return MVReg

    def from_scalar_vals(self, scalars, universe):
        from .mvreg_batch import MVRegBatch

        return MVRegBatch._host(list(scalars), universe)

    def to_scalar_vals(self, v, universe):
        from .mvreg_batch import mvreg_scalars

        return mvreg_scalars(*v, universe)


@dataclasses.dataclass(frozen=True)
class OrswotKernel(_Leaves):
    """Nested add-wins OR-Set (`orswot.rs`): ``(clock, ids, dots, d_ids,
    d_clocks)``.  ``merge_impl`` is :func:`orswot_ops.resolve_merge_impl`'s
    choice (``"auto"``: the merge kernel on a CUDA device for 32-bit
    counters)."""

    member_capacity: int
    deferred_capacity: int
    num_actors: int
    counter_bits: int = 64
    merge_impl: str = "auto"

    @classmethod
    def from_config(cls, cfg) -> "OrswotKernel":
        return cls(member_capacity=cfg.member_capacity,
                   deferred_capacity=cfg.deferred_capacity, num_actors=cfg.num_actors,
                   counter_bits=cfg.counter_bits)

    def kinds(self):
        return ("c", "i", "c", "i", "c")

    def zeros(self, batch_shape, device=None):
        dt = torch_counter_dtype(self.counter_bits)
        m, d, a = self.member_capacity, self.deferred_capacity, self.num_actors
        ids = dict(dtype=torch.int32, device=device)
        return (clock_ops.zeros((*batch_shape, a), dt, device),
                torch.full((*batch_shape, m), EMPTY, **ids),
                clock_ops.zeros((*batch_shape, m, a), dt, device),
                torch.full((*batch_shape, d), EMPTY, **ids),
                clock_ops.zeros((*batch_shape, d, a), dt, device))

    def merge(self, va, vb):
        out = orswot_ops.merge(*va, *vb, self.member_capacity, self.deferred_capacity,
                               impl=self.merge_impl)
        # one overflow flag per object: the member/deferred pair collapsed
        return out[:5], out[5].any(dim=-1)

    def truncate_full(self, v, clock):
        """`orswot.rs:159-172`: merge with an empty set carrying ``clock``,
        then subtract ``clock`` from the set clock and every member clock.
        Returns the member/deferred overflow pair (``bool[..., 2]``)."""
        empty = self.zeros_like(v)
        out = orswot_ops.merge(*v, clock, *empty[1:], self.member_capacity,
                               self.deferred_capacity, impl=self.merge_impl)
        mclock, ids, dots, d_ids, d_clocks = out[:5]
        mclock = clock_ops.subtract(mclock, clock)
        dots = clock_ops.subtract(dots, clock[..., None, :])
        live = ~clock_ops.is_empty(dots) & (ids != EMPTY)
        ids = torch.where(live, ids, torch.full_like(ids, EMPTY))
        dots = torch.where(live[..., None], dots, clock_ops.zeros((), dots.dtype, dots.device))
        return (mclock, ids, dots, d_ids, d_clocks), out[5]

    def truncate(self, v, clock):
        out, over = self.truncate_full(v, clock)
        return out, over.any(dim=-1)

    def apply_add(self, v, actor_idx, counter, member_id):
        """Nested ``Op::Add`` (`orswot.rs:66-79`)."""
        out = orswot_ops.apply_add(*v, actor_idx, counter, member_id)
        return out[:5], out[5]

    def apply_remove(self, v, rm_clock, member_id):
        """Nested ``Op::Rm`` (`orswot.rs:195-211`)."""
        out = orswot_ops.apply_remove(*v, rm_clock, member_id)
        return out[:5], out[5]

    def grown(self, factor: int) -> "OrswotKernel":
        return dataclasses.replace(self, member_capacity=self.member_capacity * factor,
                                   deferred_capacity=self.deferred_capacity * factor)

    def unified(self, other) -> "OrswotKernel":
        if (type(other) is not OrswotKernel or other.num_actors != self.num_actors
                or other.counter_bits != self.counter_bits):
            raise ValueError(f"incompatible value kernels: {self} vs {other}")
        return dataclasses.replace(
            self, member_capacity=max(self.member_capacity, other.member_capacity),
            deferred_capacity=max(self.deferred_capacity, other.deferred_capacity))

    def grow_state(self, v, target: "OrswotKernel"):
        from .orswot_batch import OrswotBatch

        g = OrswotBatch(*v).with_capacity(target.member_capacity, target.deferred_capacity)
        return (g.clock, g.ids, g.dots, g.d_ids, g.d_clocks)

    def default_scalar(self):
        from ..scalar.orswot import Orswot

        return Orswot()

    def scalar_val_type(self):
        from ..scalar.orswot import Orswot

        return Orswot

    def from_scalar_vals(self, scalars, universe):
        from .orswot_batch import scalar_planes

        return scalar_planes(list(scalars), universe)

    def to_scalar_vals(self, v, universe):
        from .orswot_batch import _host_cells, scalars_of_cells

        n, a = v[0].shape
        return scalars_of_cells(_host_cells(*v), n, a, universe)


@dataclasses.dataclass(frozen=True)
class MapKernel(_Leaves):
    """Nested Map — recursion into :mod:`~crdt_tpu_torch.ops.map_ops`
    (`map.rs:16-25` admits another Map as ``V``)."""

    key_capacity: int
    deferred_capacity: int
    num_actors: int
    val_kernel: Any
    counter_bits: int = 64

    @classmethod
    def from_config(cls, cfg, val_kernel) -> "MapKernel":
        vk_bits = getattr(val_kernel, "counter_bits", cfg.counter_bits)
        if vk_bits != cfg.counter_bits:
            raise ValueError(
                f"value kernel counter_bits={vk_bits} != config counter_bits="
                f"{cfg.counter_bits}; nested planes must share one width (build the value "
                "kernel with from_config)")
        return cls(key_capacity=cfg.key_capacity, deferred_capacity=cfg.deferred_capacity,
                   num_actors=cfg.num_actors, val_kernel=val_kernel,
                   counter_bits=cfg.counter_bits)

    def kinds(self):
        return ("c", "i", "c", self.val_kernel.kinds(), "i", "c")

    def zeros(self, batch_shape, device=None):
        dt = torch_counter_dtype(self.counter_bits)
        k, d, a = self.key_capacity, self.deferred_capacity, self.num_actors
        ids = dict(dtype=torch.int32, device=device)
        return (clock_ops.zeros((*batch_shape, a), dt, device),
                torch.full((*batch_shape, k), EMPTY, **ids),
                clock_ops.zeros((*batch_shape, k, a), dt, device),
                self.val_kernel.zeros((*batch_shape, k), device),
                torch.full((*batch_shape, d), EMPTY, **ids),
                clock_ops.zeros((*batch_shape, d, a), dt, device))

    def merge(self, va, vb):
        return map_ops.merge(va, vb, self.val_kernel, self.key_capacity, self.deferred_capacity)

    def truncate(self, v, clock):
        return map_ops.truncate(v, clock, self.val_kernel)

    def grown(self, factor: int) -> "MapKernel":
        """Every capacity axis (key, deferred, the value kernel's) times
        ``factor``: the Map's overflow flag does not say which overflowed."""
        return dataclasses.replace(self, key_capacity=self.key_capacity * factor,
                                   deferred_capacity=self.deferred_capacity * factor,
                                   val_kernel=self.val_kernel.grown(factor))

    def unified(self, other) -> "MapKernel":
        if (type(other) is not MapKernel or other.num_actors != self.num_actors
                or other.counter_bits != self.counter_bits):
            raise ValueError(f"incompatible value kernels: {self} vs {other}")
        return dataclasses.replace(
            self, key_capacity=max(self.key_capacity, other.key_capacity),
            deferred_capacity=max(self.deferred_capacity, other.deferred_capacity),
            val_kernel=self.val_kernel.unified(other.val_kernel))

    def grow_state(self, v, target: "MapKernel"):
        """Pad the key and deferred axes (EMPTY ids, biased zero clocks, the
        value kernel's empty state), then grow the value axes."""
        clock, keys, eclocks, vals, d_keys, d_clocks = v
        pk = target.key_capacity - self.key_capacity
        pd = target.deferred_capacity - self.deferred_capacity
        if pk < 0 or pd < 0:
            raise ValueError("grow_state cannot shrink")

        def pad(x, tail, n, fill):
            if n == 0:
                return x
            shape = list(x.shape)
            shape[x.dim() - 1 - tail] = n
            return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)],
                             dim=x.dim() - 1 - tail)

        z = zero_of(clock.dtype)
        if pk:
            empties = self.val_kernel.zeros(keys.shape[:-1] + (pk,), keys.device)
            vals = map_ops._tree_map(lambda x, e: torch.cat([x, e], dim=keys.dim() - 1),
                                     vals, empties)
        return (clock, pad(keys, 0, pk, EMPTY), pad(eclocks, 1, pk, z),
                self.val_kernel.grow_state(vals, target.val_kernel),
                pad(d_keys, 0, pd, EMPTY), pad(d_clocks, 1, pd, z))

    def default_scalar(self):
        from ..scalar.map import Map

        return Map(self.val_kernel.default_scalar)

    def scalar_val_type(self):
        """Nested maps serialize their val_type as ``MapOf(inner)``."""
        from ..utils.serde import MapOf

        return MapOf(self.val_kernel.scalar_val_type())

    def from_scalar_vals(self, scalars, universe):
        from .map_batch import map_planes

        return map_planes(list(scalars), universe, self.val_kernel)

    def to_scalar_vals(self, v, universe):
        from .map_batch import map_scalars

        return map_scalars(v, universe, self)


_KERNEL_CLASSES = {"MVRegKernel": MVRegKernel, "OrswotKernel": OrswotKernel,
                   "MapKernel": MapKernel}


def kernel_to_spec(kernel) -> dict:
    """A plain-dict description of a (possibly nested) value kernel."""
    spec = {"cls": type(kernel).__name__}
    for f in dataclasses.fields(kernel):
        v = getattr(kernel, f.name)
        spec[f.name] = kernel_to_spec(v) if dataclasses.is_dataclass(v) else v
    return spec


def kernel_from_spec(spec: dict):
    """Inverse of :func:`kernel_to_spec`."""
    return _KERNEL_CLASSES[spec["cls"]](**{
        k: kernel_from_spec(v) if isinstance(v, dict) else v
        for k, v in spec.items() if k != "cls"})
