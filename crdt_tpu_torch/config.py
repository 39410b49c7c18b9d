"""Static capacities of the dense batches — the port's own copy of the
JAX package's ``CrdtConfig``, without its jax helpers.

The reference stores unbounded maps; dense batches need static shapes,
so each axis gets a capacity.  ``counter_bits`` picks the counter width
(64 for reference parity, 32 for the kernel paths).  The pairwise merge
implementation is chosen per call (see
:func:`crdt_tpu_torch.ops.orswot_ops.resolve_merge_impl`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# canonical ORSWOT pairwise-merge implementation names (callers may also
# pass "auto")
MERGE_IMPLS = ("rank", "unrolled", "pallas")


def counter_dtype(config=None):
    """The numpy counter dtype at the package edge: ``uint64`` by default
    (reference parity), ``uint32`` for ``counter_bits=32``.  On the
    device the counters are held biased in the signed type of the same
    width (:mod:`crdt_tpu_torch.dtypes`)."""
    bits = config.counter_bits if config is not None else 64
    return np.uint32 if bits == 32 else np.uint64


@dataclasses.dataclass(frozen=True)
class CrdtConfig:
    """Static capacities for dense CRDT batches."""

    num_actors: int = 64  # actor-universe size A (dense interned ids)
    member_capacity: int = 32  # Orswot member slots per object
    deferred_capacity: int = 8  # deferred (clock, member) rows per object
    mv_capacity: int = 8  # MVReg antichain slots per register
    key_capacity: int = 16  # Map key slots per object
    # counter width: 64 = reference parity (u64), 32 = the kernel width
    counter_bits: int = 64

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"CrdtConfig.{f.name} must be a positive int, got {v!r}")
        if self.counter_bits not in (32, 64):
            raise ValueError(
                f"CrdtConfig.counter_bits must be 32 or 64, got {self.counter_bits!r}"
            )

    @classmethod
    def gpu_default(cls, **overrides) -> "CrdtConfig":
        """The configuration the GPU kernels run on: ``counter_bits=32``
        (the kernels are exact for 32-bit counters only; u64 batches stay
        on the plain rank path)."""
        return cls(**{"counter_bits": 32, **overrides})


DEFAULT_CONFIG = CrdtConfig()
