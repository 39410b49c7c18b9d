"""Plane re-packing — the executor's regrow path in reverse (the port
of the JAX package's ``gc/repack.py``).

:func:`shrink_plan` picks the smallest power-of-two rung that still fits
the busiest object, and proposes it only when it clears ``hysteresis``
of the current rung (so a fleet at a rung boundary does not flap).
:func:`repack_orswot` packs live slots first (ascending member id, the
canonical order) and slices the slot axes down; slot order is
representation, so the digests are unchanged.  The bytes it frees are
its return value (:class:`~crdt_tpu_torch.gc.policy.GcEngine` counts
the shrinks).

Node-level GC never shrinks below the universe config's capacities:
the delta applier's peer rows come at exactly those widths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import orswot_ops


def _next_pow2(c: int) -> int:
    return 1 if c <= 0 else 1 << (c - 1).bit_length()


def _nbytes(batch) -> int:
    return sum(p.element_size() * p.numel()
               for p in (batch.clock, batch.ids, batch.dots, batch.d_ids, batch.d_clocks))


def shrink_plan(occ, *, member_floor: int, deferred_floor: int,
                hysteresis: float = 0.5) -> Optional[Tuple[int, int]]:
    """``(member_capacity, deferred_capacity)`` to re-pack to, or None
    when the planes are already tight.  ``occ``: an ORSWOT or Map
    :class:`~crdt_tpu_torch.obs.capacity.Occupancy`."""
    if not 0.0 < hysteresis <= 1.0:
        raise ValueError(f"hysteresis {hysteresis} not in (0, 1]")
    m_cur, d_cur = occ.slot_capacity, occ.tombstone_capacity
    m_new = min(max(int(member_floor), _next_pow2(occ.live_max)), m_cur)
    d_new = min(max(int(deferred_floor), _next_pow2(occ.tombstones_max)), d_cur)
    shrinks = False
    if m_new < m_cur and m_new <= m_cur * hysteresis:
        shrinks = True
    else:
        m_new = m_cur
    if d_new < d_cur and d_new <= d_cur * hysteresis:
        shrinks = True
    else:
        d_new = d_cur
    return (m_new, d_new) if shrinks else None


def repack_orswot(batch, member_capacity: Optional[int] = None,
                  deferred_capacity: Optional[int] = None):
    """``(repacked_batch, reclaimed_bytes)``: ``batch``'s slot axes
    shrunk to the given capacities (None keeps one).  Raises
    ``ValueError`` when a live row would not fit, or on a grow."""
    m_before, d_before = batch.member_capacity, batch.deferred_capacity
    m_new = m_before if member_capacity is None else int(member_capacity)
    d_new = d_before if deferred_capacity is None else int(deferred_capacity)
    if m_new > m_before or d_new > d_before:
        raise ValueError(f"repack cannot grow (member {m_before}->{m_new}, deferred "
                         f"{d_before}->{d_new}); use with_capacity to regrow")
    if (m_new, d_new) == (m_before, d_before):
        return batch, 0
    ids, dots, m_over = orswot_ops.compact_by_id(batch.ids, batch.dots, m_new)
    d_ids, d_clocks, d_over = orswot_ops.compact(batch.d_ids, batch.d_clocks, d_new)
    if bool(torch.stack([m_over.any(), d_over.any()]).any()):
        raise ValueError(f"repack to (member={m_new}, deferred={d_new}) would drop live "
                         "rows — re-run shrink_plan on a fresh occupancy sample")
    out = type(batch)(clock=batch.clock, ids=ids.contiguous(), dots=dots.contiguous(),
                      d_ids=d_ids.contiguous(), d_clocks=d_clocks.contiguous())
    return out, _nbytes(batch) - _nbytes(out)
