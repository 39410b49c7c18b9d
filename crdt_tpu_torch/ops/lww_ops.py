"""Batched last-write-wins register merge (`lwwreg.rs:43-67`).

Markers are biased counters (order-preserving, so ``>`` is the unsigned
order); values are raw payload ids, compared only for equality
(:mod:`crdt_tpu_torch.dtypes`).  A batch cannot raise per element, so
``merge`` returns a conflict bitmap that the batch raises as
:class:`~crdt_tpu_torch.error.ConflictingMarker`.
"""

from __future__ import annotations

import torch


def merge(val_a, marker_a, val_b, marker_b):
    """``(val, marker, conflict)``: the larger marker's side; ``conflict``
    where the markers are equal and the values differ (`lwwreg.rs:61-62`),
    keeping ``val_a`` there."""
    take_b = marker_b > marker_a
    val = torch.where(take_b, val_b, val_a)
    marker = torch.where(take_b, marker_b, marker_a)
    conflict = (marker_a == marker_b) & (val_a != val_b)
    return val, marker, conflict


def update(val, marker, new_val, new_marker):
    """Batched ``update`` (`lwwreg.rs:104-118`): the merge's rule."""
    return merge(val, marker, new_val, new_marker)
