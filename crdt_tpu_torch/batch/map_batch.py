"""MapBatch — N reset-remove CRDT maps on the device (`map.rs:83-99`).

The map clock, key-slot tables (interned key ids, per-key entry clocks and
the nested value state) and a deferred-remove table, as tensors; the
nested value type is a value kernel (:mod:`.val_kernels`):
``MVRegKernel``, ``OrswotKernel`` or a nested ``MapKernel``.  ``merge``
runs :func:`~crdt_tpu_torch.ops.map_ops.merge` (a nested ORSWOT through
the merge kernel on a CUDA device); ``apply_up``/``apply_rm`` apply one
op per object.  ``from_numpy``/``to_numpy`` take and give the JAX
package's unsigned planes; ``from_wire``/``to_wire`` run the host
codec's Map legs for ``Map<int, MVReg>``, ``Map<int, Orswot>`` and
``Map<int, Map<int, MVReg>>``, and the scalar codec otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..config import counter_dtype
from ..device import resolve_device
from ..dtypes import EMPTY, as_counters, as_payload
from ..error import CapacityOverflowError
from ..native import engine
from ..ops import map_ops
from ..ops.map_ops import _tree_map
from ..scalar.map import Entry, Map
from ..scalar.vclock import VClock
from . import wirebulk
from .val_kernels import MapKernel, MVRegKernel, OrswotKernel
from .vclock_batch import row_to_vclock

# the nested ops of apply_up and their arguments: an actor index (x), a
# counter (c), a payload id (p) or an interned id (i)
_NESTED_ARGS = {"apply_put": "cp", "apply_add": "xci", "apply_remove": "ci"}


def _leaves(tree) -> list:
    """The leaves of nested tuples, depth first."""
    return [x for part in tree for x in _leaves(part)] if isinstance(tree, tuple) else [tree]


def _unflatten(template, leaves):
    """Nested tuples shaped as ``template`` from an iterator of leaves."""
    if isinstance(template, tuple):
        return tuple(_unflatten(t, leaves) for t in template)
    return next(leaves)


def _clock_to_row(vc: VClock, row, universe) -> None:
    for actor, counter in vc.dots.items():
        row[universe.actor_idx(actor)] = counter


def map_planes(states: Sequence[Map], universe, val_kernel):
    """Unsigned numpy planes ``(clock, keys, eclocks, vals, d_keys,
    d_clocks)`` of scalar maps, as the JAX package's ``from_scalar``
    lays them out (entries and deferred rows in the states' order)."""
    cfg = universe.config
    n, k, d, a = len(states), cfg.key_capacity, cfg.deferred_capacity, cfg.num_actors
    dt = counter_dtype(cfg)
    clock, eclocks = np.zeros((n, a), dt), np.zeros((n, k, a), dt)
    keys, d_keys = np.full((n, k), EMPTY, np.int32), np.full((n, d), EMPTY, np.int32)
    d_clocks = np.zeros((n, d, a), dt)
    vals_flat = []
    for i, m in enumerate(states):
        if len(m.entries) > k:
            raise ValueError(f"map {i} has {len(m.entries)} keys > key_capacity {k}")
        _clock_to_row(m.clock, clock[i], universe)
        slot_vals = [val_kernel.default_scalar() for _ in range(k)]
        for j, (key, entry) in enumerate(m.entries.items()):
            keys[i, j] = universe.member_id(key)
            _clock_to_row(entry.clock, eclocks[i, j], universe)
            slot_vals[j] = entry.val
        vals_flat.extend(slot_vals)
        rows = [(ck, key) for ck, key_set in m.deferred.items() for key in key_set]
        if len(rows) > d:
            raise ValueError(f"map {i} has {len(rows)} deferred rows > deferred_capacity {d}")
        for j, (ck, key) in enumerate(rows):
            d_keys[i, j] = universe.member_id(key)
            _clock_to_row(VClock.from_key(ck), d_clocks[i, j], universe)
    vals = _tree_map(lambda x: x.reshape(n, k, *x.shape[1:]),
                     val_kernel.from_scalar_vals(vals_flat, universe))
    return clock, keys, eclocks, vals, d_keys, d_clocks


def map_scalars(state, universe, kernel) -> list[Map]:
    """Scalar maps of unsigned numpy planes (the inverse of
    :func:`map_planes`), with a serializable ``val_type``."""
    clock, keys, eclocks, vals, d_keys, d_clocks = state
    vk = kernel.val_kernel
    n, k = keys.shape
    scalar_vals = vk.to_scalar_vals(_tree_map(lambda x: x.reshape(n * k, *x.shape[2:]), vals),
                                    universe)
    lookup = universe.members.lookup
    out = []
    for i in range(n):
        m = Map(vk.scalar_val_type())
        m.clock = row_to_vclock(clock[i], universe)
        for j in np.nonzero(keys[i] != EMPTY)[0].tolist():
            m.entries[lookup(int(keys[i, j]))] = Entry(
                clock=row_to_vclock(eclocks[i, j], universe), val=scalar_vals[i * k + j])
        for j in np.nonzero(d_keys[i] != EMPTY)[0].tolist():
            ck = row_to_vclock(d_clocks[i, j], universe).key()
            m.deferred.setdefault(ck, set()).add(lookup(int(d_keys[i, j])))
        out.append(m)
    return out


def _map_wire_leg(val_kernel) -> str | None:
    """The host codec's Map leg for a value kernel, or None where only the
    scalar codec serves the composition."""
    if type(val_kernel) is MVRegKernel:
        return "mvreg"
    if type(val_kernel) is OrswotKernel:
        return "orswot"
    if type(val_kernel) is MapKernel and type(val_kernel.val_kernel) is MVRegKernel:
        return "map_mvreg"  # the reference's canonical nesting (`test/map.rs:8`)
    return None


def _ingest(leg, vk, cfg):
    """``(ingest(buf, offsets), what a status-5 value exceeds)`` of a leg."""
    head = (cfg.num_actors, cfg.key_capacity, cfg.deferred_capacity)
    dt = counter_dtype(cfg)
    if leg == "mvreg":
        return (lambda buf, off: engine.map_mvreg_ingest_wire(buf, off, *head, vk.mv_capacity,
                                                              dt),
                f"a value antichain wider than mv_capacity {vk.mv_capacity}")
    if leg == "orswot":
        return (lambda buf, off: engine.map_orswot_ingest_wire(
                    buf, off, *head, vk.member_capacity, vk.deferred_capacity, dt),
                f"a value set exceeding member_capacity {vk.member_capacity} / "
                f"deferred_capacity {vk.deferred_capacity}")
    inner = (vk.key_capacity, vk.deferred_capacity, vk.val_kernel.mv_capacity)
    return (lambda buf, off: engine.map_map_mvreg_ingest_wire(buf, off, *head, *inner, dt),
            f"an inner map exceeding key_capacity {inner[0]} / deferred_capacity {inner[1]} / "
            f"mv_capacity {inner[2]}")


@dataclasses.dataclass
class MapBatch:
    clock: torch.Tensor  # int[N, A], biased
    keys: torch.Tensor  # int32[N, K] (-1 = empty)
    entry_clocks: torch.Tensor  # int[N, K, A], biased
    vals: Any  # the nested value state, leaves [N, K, *inner]
    d_keys: torch.Tensor  # int32[N, D] (-1 = empty)
    d_clocks: torch.Tensor  # int[N, D, A], biased
    kernel: MapKernel

    @property
    def state(self):
        return (self.clock, self.keys, self.entry_clocks, self.vals, self.d_keys, self.d_clocks)

    @classmethod
    def from_state(cls, state, kernel: MapKernel) -> "MapBatch":
        return cls(*state, kernel=kernel)

    @property
    def device(self) -> torch.device:
        return self.clock.device

    @classmethod
    def zeros(cls, n: int, universe, val_kernel, device=None) -> "MapBatch":
        kernel = MapKernel.from_config(universe.config, val_kernel)
        return cls.from_state(kernel.zeros((n,), resolve_device(device)), kernel)

    @classmethod
    def from_numpy(cls, clock, keys, eclocks, vals, d_keys, d_clocks, kernel: MapKernel,
                   device=None) -> "MapBatch":
        """The JAX package's unsigned numpy planes (``vals`` the nested
        tuple of its value leaves) → a batch on ``device``."""
        state = kernel.from_numpy_vals((clock, keys, eclocks, vals, d_keys, d_clocks),
                                       resolve_device(device))
        return cls.from_state(state, kernel)

    def to_numpy(self):
        """The inverse of :meth:`from_numpy`."""
        return self.kernel.to_numpy_vals(self.state)

    @classmethod
    def from_scalar(cls, states: Sequence[Map], universe, val_kernel,
                    device=None) -> "MapBatch":
        kernel = MapKernel.from_config(universe.config, val_kernel)
        return cls.from_numpy(*map_planes(states, universe, val_kernel), kernel, device=device)

    def to_scalar(self, universe) -> list[Map]:
        return map_scalars(self.to_numpy(), universe, self.kernel)

    @classmethod
    def from_wire(cls, blobs: Sequence[bytes], universe, val_kernel,
                  device=None) -> "MapBatch":
        """Bulk ingest of ``to_binary(map)`` blobs, equal to
        ``from_scalar([from_binary(b) ...])``: the host codec's Map leg for
        the three compositions it knows (identity universes; blobs outside
        its grammar spliced in through the scalar codec), the scalar codec
        otherwise.  A blob that does not decode or fit raises
        :class:`~crdt_tpu_torch.error.WireFormatError` with its index."""
        cfg = universe.config
        leg = _map_wire_leg(val_kernel)

        def host(states):
            return _leaves(map_planes(states, universe, val_kernel))

        if leg is None:
            wirebulk._tally("from_wire", fallback=len(blobs), reason="no_native_leg", leg="map")
            flat = host(wirebulk.decode_blobs(blobs, range(len(blobs)), Map))
        else:
            ingest, value_msg = _ingest(leg, val_kernel, cfg)
            flat = wirebulk.planes_from_wire(blobs, universe, "map", Map, ingest, host, errors={
                2: f"map {{i}} has more keys than key_capacity {cfg.key_capacity}",
                3: f"map {{i}} has more deferred rows than deferred_capacity "
                   f"{cfg.deferred_capacity}",
                5: f"map {{i}} has {value_msg}",
                4: "map {i}: actor outside the identity registry range [0, {a})"})
        state = _unflatten(map_planes([], universe, val_kernel), iter(flat))
        return cls.from_numpy(*state, MapKernel.from_config(cfg, val_kernel), device=device)

    def to_wire(self, universe) -> list[bytes]:
        """Blobs byte-identical to ``to_binary`` of :meth:`to_scalar`: the
        host codec's Map leg, or the scalar codec for other compositions
        and for u64 counters or ids at or above 2^63."""
        from ..utils.serde import to_binary

        n = self.clock.shape[0]
        leg = _map_wire_leg(self.kernel.val_kernel)
        if leg is None:
            wirebulk._tally("to_wire", fallback=n, reason="no_native_leg", leg="map")
            return [to_binary(s) for s in self.to_scalar(universe)]
        kinds, leaves = _leaves(self.kernel.kinds()), _leaves(self.state)
        encode = getattr(engine, f"map_{leg}_encode_wire")
        return wirebulk.planes_to_wire(
            self, n, universe, "map", lambda host: encode(*_leaves(host)),
            counters=[x for k, x in zip(kinds, leaves) if k == "c"],
            payload=[x for k, x in zip(kinds, leaves) if k == "p"])

    # -- state path ----------------------------------------------------------

    def merge(self, other: "MapBatch", check: bool = True) -> "MapBatch":
        """`map.rs:192-269`.  Kernels that differ in capacities only are
        unified to the pointwise maximum first.  Raises
        :class:`CapacityOverflowError` on any overflow (key, deferred or a
        nested value: the flag is collapsed, so the executor grows every
        axis through :meth:`with_capacity`)."""
        if self.kernel != other.kernel:
            target = self.kernel.unified(other.kernel)
            a, b = (x if x.kernel == target else
                    MapBatch.from_state(x.kernel.grow_state(x.state, target), target)
                    for x in (self, other))
            return a.merge(b, check)
        state, overflow = self.kernel.merge(self.state, other.state)
        if check and bool(overflow.any()):
            raise CapacityOverflowError(
                "MapBatch merge overflow: raise key/deferred/value capacities",
                member=True, deferred=True)
        return MapBatch.from_state(state, self.kernel)

    # the executor's elastic-capacity protocol: the key axis reports as
    # member_capacity, the map's deferred table as deferred_capacity

    @property
    def member_capacity(self) -> int:
        return self.keys.shape[-1]

    @property
    def deferred_capacity(self) -> int:
        return self.d_keys.shape[-1]

    def with_capacity(self, member_capacity: int | None = None,
                      deferred_capacity: int | None = None) -> "MapBatch":
        """Pad the key and deferred axes exactly to the capacities asked
        for; the nested value axes grow by the same factor as the larger of
        the two (the overflow may have been a nested one).  Never
        shrinks."""
        k, d = self.member_capacity, self.deferred_capacity
        new_k = k if member_capacity is None else member_capacity
        new_d = d if deferred_capacity is None else deferred_capacity
        if new_k < k or new_d < d:
            raise ValueError("with_capacity cannot shrink (would drop live slots)")
        if (new_k, new_d) == (k, d):
            return self
        factor = max(-(-new_k // k), -(-new_d // d), 1)
        target = dataclasses.replace(self.kernel, key_capacity=new_k, deferred_capacity=new_d,
                                     val_kernel=self.kernel.val_kernel.grown(factor))
        return MapBatch.from_state(self.kernel.grow_state(self.state, target), target)

    def truncate(self, clock, check: bool = True) -> "MapBatch":
        """``Causal::truncate`` (`map.rs:131-158`) by one clock per object
        (unsigned ``[N, A]``; a tensor is taken as biased)."""
        t = as_counters(clock, self.clock.dtype, self.device)
        state, overflow = self.kernel.truncate(self.state, t)
        if check and bool(overflow.any()):
            raise ValueError("MapBatch truncate overflow")
        return MapBatch.from_state(state, self.kernel)

    # -- op path -----------------------------------------------------------------

    def apply_rm(self, rm_clock, key_id, check: bool = True) -> "MapBatch":
        """One ``Op::Rm`` per object (`map.rs:166-168`)."""
        state, overflow = map_ops.apply_rm(
            self.state, as_counters(rm_clock, self.clock.dtype, self.device),
            self._ids(key_id), self.kernel.val_kernel)
        if check and bool(overflow.any()):
            raise ValueError("MapBatch apply_rm overflow: raise deferred_capacity")
        return MapBatch.from_state(state, self.kernel)

    def apply_up(self, actor_idx, counter, key_id, nested_op: str, nested_args: tuple,
                 check: bool = True) -> "MapBatch":
        """One ``Op::Up`` per object (`map.rs:169-187`): ``nested_op`` names
        the value kernel's op (``"apply_put"``, ``"apply_add"``,
        ``"apply_remove"``) and ``nested_args`` its per-object arguments
        (counters unsigned, or tensors already biased)."""
        vk = self.kernel.val_kernel
        nested = getattr(vk, nested_op)
        dev = self.device
        conv = {"x": lambda x: torch.as_tensor(x, device=dev), "i": self._ids,
                "c": lambda x: as_counters(x, self.clock.dtype, dev),
                "p": lambda x: as_payload(x, self.clock)}
        args = tuple(conv[k](x) for k, x in zip(_NESTED_ARGS[nested_op], nested_args))
        state, overflow = map_ops.apply_up(
            self.state, torch.as_tensor(actor_idx, device=dev),
            as_counters(counter, self.clock.dtype, dev), self._ids(key_id),
            lambda v: nested(v, *args), vk)
        if check and bool(overflow.any()):
            raise ValueError("MapBatch apply_up overflow: raise key_capacity")
        return MapBatch.from_state(state, self.kernel)

    # -- reads (`map.rs:271-302`) -----------------------------------------------

    def _ids(self, x):
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def len_counts(self):
        """Entry counts per object (`map.rs:282-288`)."""
        return (self.keys != EMPTY).sum(dim=-1)

    def contains(self, key_id):
        """Key-presence bitmap."""
        return (self.keys == self._ids(key_id)[..., None]).any(dim=-1)
