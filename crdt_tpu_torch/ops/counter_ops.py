"""Batched counter ops in the biased counter domain.

GCounter is a VClock newtype (`gcounter.rs:26-28`); PNCounter stacks two
of them (`pncounter.rs:33-36`): ``[..., 2, A]``, plane 0 = P
(increments), plane 1 = N (decrements).  Sums unbias first
(:func:`~crdt_tpu_torch.ops.clock_ops.value_sum`): int64 holding the
bits of the unsigned sum modulo 2^64, as the JAX package's u64 sums.
"""

from __future__ import annotations

import torch

from . import clock_ops

gcounter_merge = clock_ops.merge
gcounter_value = clock_ops.value_sum


def pncounter_merge(a, b):
    """P with P and N with N (`pncounter.rs:90-95`): one max."""
    return torch.maximum(a, b)


def pncounter_value(pn):
    """P − N as int64 (`pncounter.rs:117-119`), wrapping as the JAX
    package's u64 sums cast to int64 do."""
    sums = clock_ops.value_sum(pn)
    return sums[..., 0] - sums[..., 1]
