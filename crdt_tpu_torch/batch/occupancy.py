"""Plane occupancy — how full every dense plane is (the port of the JAX
package's ``batch/occupancy.py``).

One torch reduction per plane family where the planes live, and one
small int64 vector copied to the host per sample.  Counters are biased
(:mod:`crdt_tpu_torch.dtypes`): an empty counter cell holds
:func:`~crdt_tpu_torch.dtypes.zero_of`, not 0, so "populated" is
``!= zero_of(dtype)``.  ``bytes`` is the sum of ``element_size() *
numel()`` over the plane tensors (a Map's nested value leaves included).
"""

from __future__ import annotations

import torch

from ..dtypes import EMPTY, zero_of
from ..obs.capacity import Occupancy


def _nbytes(tensors) -> int:
    return int(sum(t.element_size() * t.numel() for t in tensors))


def _host(*stats) -> list:
    """The stats as host ints, in one copy."""
    return torch.stack([s.to(torch.int64) for s in stats]).tolist()


def _slot_stats(clock, live, tombs):
    """Live slots (total, busiest object), live deferred rows (total,
    busiest object), populated clock cells, actor columns in use."""
    nz = clock != zero_of(clock.dtype)
    return _host(live.sum(), live.sum(dim=1).max(), tombs.sum(), tombs.sum(dim=1).max(),
                 nz.sum(), nz.any(dim=0).sum())


def _counter_stats(nz, cells):
    """Populated cells, the busiest object's live actors, objects in use,
    actor columns in use."""
    return _host(cells, nz.sum(dim=1).max(), nz.any(dim=1).sum(), nz.any(dim=0).sum())


def occupancy_of(batch) -> Occupancy:
    """The :class:`Occupancy` of a dense batch: ORSWOT member and deferred
    tables, Map key and deferred tables, PN-counter ``[N, 2, A]`` planes
    and ``[N, A]`` clock planes (VClock and GCounter; ``kind`` tells them
    apart).  Raises ``TypeError`` for other types."""
    if hasattr(batch, "d_ids") and hasattr(batch, "ids"):
        s = _slot_stats(batch.clock, batch.ids != EMPTY, batch.d_ids != EMPTY)
        n, m = batch.ids.shape
        planes = (batch.clock, batch.ids, batch.dots, batch.d_ids, batch.d_clocks)
        return Occupancy(kind="orswot", objects=n, bytes=_nbytes(planes), slot_capacity=m,
                         slots=n * m, live=s[0], live_max=s[1],
                         tombstone_capacity=batch.d_ids.shape[1], tombstones=s[2],
                         tombstones_max=s[3], actors=batch.clock.shape[1], actors_live=s[5])
    if hasattr(batch, "d_keys") and hasattr(batch, "keys"):
        from .map_batch import _leaves

        s = _slot_stats(batch.clock, batch.keys != EMPTY, batch.d_keys != EMPTY)
        n, k = batch.keys.shape
        return Occupancy(kind="map", objects=n, bytes=_nbytes(_leaves(batch.state)),
                         slot_capacity=k, slots=n * k, live=s[0], live_max=s[1],
                         tombstone_capacity=batch.d_keys.shape[1], tombstones=s[2],
                         tombstones_max=s[3], actors=batch.clock.shape[1], actors_live=s[5])
    if hasattr(batch, "planes"):
        planes = batch.planes
        z = zero_of(planes.dtype)
        s = _counter_stats(planes.amax(dim=1) != z, (planes != z).sum())
        n, _, a = planes.shape
        return Occupancy(kind="pncounter", objects=n, bytes=_nbytes((planes,)),
                         slot_capacity=a, slots=n * 2 * a, live=s[0], live_max=s[1],
                         actors=a, actors_live=s[3])
    if hasattr(batch, "clocks"):
        nz = batch.clocks != zero_of(batch.clocks.dtype)
        s = _counter_stats(nz, nz.sum())
        n, a = batch.clocks.shape
        kind = type(batch).__name__.removesuffix("Batch").lower()
        return Occupancy(kind=kind or "clock", objects=n, bytes=_nbytes((batch.clocks,)),
                         slot_capacity=a, slots=n * a, live=s[0], live_max=s[1], actors=a,
                         actors_live=s[3])
    raise TypeError(f"no occupancy reduction for {type(batch).__name__} (dense-plane batch "
                    "types only: Orswot/VClock/GCounter/PNCounter/Map)")
