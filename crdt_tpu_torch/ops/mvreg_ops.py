"""Batched multi-value register ops in the biased counter domain.

A register batch is a padded antichain: biased ``clocks [..., K, A]``
and raw payload ids ``vals [..., K]``.  A slot is live iff its clock is
not empty (`mvreg.rs:161-163`); a cleared slot holds the biased zero
clock and payload 0.
"""

from __future__ import annotations

import torch

from ..dtypes import zero_of
from . import clock_ops


def active(clocks):
    """Slot-occupancy mask ``[..., K]``."""
    return ~clock_ops.is_empty(clocks)


def _clear(keep, clocks, vals):
    z = torch.full((), zero_of(clocks.dtype), dtype=clocks.dtype, device=clocks.device)
    return torch.where(keep[..., None], clocks, z), torch.where(keep, vals, 0)


def merge(clocks_a, vals_a, clocks_b, vals_b):
    """Pairwise antichain merge (`mvreg.rs:121-153`): ``(clocks, vals,
    keep)`` over the 2K slots of both sides (``a``'s first); keep each
    side's values that the other side does not strictly dominate, and
    ``b``'s only where no kept ``a`` value has an equal clock."""
    act_a, act_b = active(clocks_a), active(clocks_b)
    a_exp, b_exp = clocks_a[..., :, None, :], clocks_b[..., None, :, :]
    a_le_b = clock_ops.leq(a_exp, b_exp)  # [..., K, K]
    b_le_a = clock_ops.leq(b_exp, a_exp)
    a_eq_b = a_le_b & b_le_a
    keep_a = act_a & ~(a_le_b & ~a_eq_b & act_b[..., None, :]).any(dim=-1)
    keep_b = act_b & ~(b_le_a & ~a_eq_b & act_a[..., :, None]).any(dim=-2)
    keep_b &= ~(a_eq_b & keep_a[..., :, None]).any(dim=-2)
    keep = torch.cat([keep_a, keep_b], dim=-1)
    clocks, vals = _clear(keep, torch.cat([clocks_a, clocks_b], dim=-2),
                          torch.cat([vals_a, vals_b], dim=-1))
    return clocks, vals, keep


def compact(clocks, vals, keep, k_cap):
    """Live slots first (stable), cut to ``k_cap``: ``(clocks, vals,
    overflow)``, ``overflow`` where more than ``k_cap`` slots lived."""
    order = torch.argsort((~keep).to(torch.int32), dim=-1, stable=True)
    clocks = torch.take_along_dim(clocks, order[..., None], dim=-2)[..., :k_cap, :]
    vals = torch.take_along_dim(vals, order, dim=-1)[..., :k_cap]
    return clocks, vals, keep.sum(dim=-1) > k_cap


def apply_put(clocks, vals, op_clock, op_val):
    """Batched ``Op::Put`` (`mvreg.rs:158-186`), one op per register:
    drop slots the op's clock covers, add the op unless a retained slot
    strictly dominates it; an empty op clock changes nothing.  Returns
    K + 1 slots (the op last) and ``keep``, as :func:`merge`."""
    op_empty = clock_ops.is_empty(op_clock)
    act = active(clocks)
    op_exp = op_clock[..., None, :]
    retained = act & ~clock_ops.leq(clocks, op_exp)
    dominates_op = clock_ops.lt(op_exp, clocks) & retained
    should_add = ~dominates_op.any(dim=-1) & ~op_empty
    keep = torch.cat([torch.where(op_empty[..., None], act, retained), should_add[..., None]],
                     dim=-1)
    clocks, vals = _clear(keep, torch.cat([clocks, op_exp], dim=-2),
                          torch.cat([vals, op_val[..., None]], dim=-1))
    return clocks, vals, keep


def read_clock(clocks):
    """The fold of every slot's clock (`mvreg.rs:216-222`)."""
    return torch.amax(clocks, dim=-2)
