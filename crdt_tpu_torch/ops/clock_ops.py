"""Dense vector-clock arithmetic in the biased counter domain.

A clock batch is a signed integer tensor whose **last axis is the actor
axis**; counters are biased (:mod:`crdt_tpu_torch.dtypes`), so an absent
actor holds the dtype's minimum, ``zero_of(dtype)``, instead of 0.  The
bias preserves order, so every VClock operation is still elementwise:

=====================  ==================================================
reference               dense op (``Z`` = biased zero)
=====================  ==================================================
``merge``               pointwise max                  (`vclock.rs:131-137`)
``intersection``        ``where(a == b, a, Z)``        (`vclock.rs:219-228`)
``subtract``            ``where(a > b, a, Z)``         (`vclock.rs:236-242`)
``truncate`` (GLB)      pointwise min                  (`vclock.rs:103-120`)
``partial_cmp``         all/any reductions over A      (`vclock.rs:59-71`)
``witness``             scatter-max                    (`vclock.rs:159-163`)
=====================  ==================================================

Adding to a biased counter wraps as the unsigned counter does
(``inc_counter``); a sum must unbias first (``value_sum``).
"""

from __future__ import annotations

import torch

from ..dtypes import zero_of


def _zero_like(a: torch.Tensor) -> torch.Tensor:
    return torch.full((), zero_of(a.dtype), dtype=a.dtype, device=a.device)


def zeros(shape, dtype, device=None):
    """An empty clock batch (all actors absent): the biased zero."""
    return torch.full(shape, zero_of(dtype), dtype=dtype, device=device)


def merge(a, b):
    """Lattice join: pointwise max (`vclock.rs:131-137`)."""
    return torch.maximum(a, b)


def intersection(a, b):
    """Common dots: same actor AND same counter (`vclock.rs:219-228`)."""
    return torch.where(a == b, a, _zero_like(a))


def subtract(a, b):
    """Keep ``a[i]`` iff ``a[i] > b[i]`` (`vclock.rs:236-242`)."""
    return torch.where(a > b, a, _zero_like(a))


def is_empty(a):
    """True where the clock has no dots, reduced over the actor axis."""
    return (a == zero_of(a.dtype)).all(dim=-1)


def eq(a, b):
    """Structural equality (same dots), reduced over the actor axis."""
    return (a == b).all(dim=-1)


def leq(a, b):
    """``a <= b``: b covers every dot of a (`vclock.rs:65`)."""
    return (a <= b).all(dim=-1)


def truncate(a, b):
    """Causal truncate: greatest lower bound, pointwise min
    (`vclock.rs:103-120`)."""
    return torch.minimum(a, b)


def dominates_or_eq(a, b):
    """``a >= b``: every dot of ``b`` is covered (`vclock.rs:63`)."""
    return (a >= b).all(dim=-1)


def lt(a, b):
    """Strict ``a < b``: covered and not equal."""
    return leq(a, b) & ~eq(a, b)


def concurrent(a, b):
    """Diverged: neither covers the other (`vclock.rs:200-202`)."""
    return ~leq(a, b) & ~dominates_or_eq(a, b)


def witness(clock, actor_idx, counter):
    """Scatter-max a dot into a clock batch (`vclock.rs:159-163`):
    ``clock [..., A]``, ``actor_idx``/``counter`` (biased) ``[...]``."""
    idx = actor_idx.to(torch.int64)[..., None]
    new = torch.maximum(torch.gather(clock, -1, idx), counter[..., None].to(clock.dtype))
    return clock.scatter(-1, idx, new)


def inc_counter(clock, actor_idx):
    """Next counter for an actor, ``get + 1`` (`vclock.rs:182-185`),
    biased; it wraps as the unsigned counter does."""
    return torch.gather(clock, -1, actor_idx.to(torch.int64)[..., None])[..., 0] + 1


def value_sum(a):
    """Sum of all counters, GCounter ``value`` (`gcounter.rs:76-78`):
    unbiased first, summed in int64 (for 64-bit counters, the bits of
    the unsigned sum modulo 2^64)."""
    if a.dtype == torch.int32:
        u = a.to(torch.int64) - zero_of(torch.int32)
    else:
        u = a ^ zero_of(a.dtype)
    return u.sum(dim=-1)
