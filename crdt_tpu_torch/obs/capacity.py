"""The plane occupancy record (the port of the JAX package's
``obs/capacity.py`` ``Occupancy`` and ``WATERMARK_STATES``; the capacity
tracker that samples and grades it is not ported yet).
:func:`crdt_tpu_torch.batch.occupancy.occupancy_of` fills it for the
dense batch types."""

from __future__ import annotations

import dataclasses

#: watermark states, in severity order (the overall state is the max)
WATERMARK_STATES = ("ok", "warn", "critical")


@dataclasses.dataclass(frozen=True)
class Occupancy:
    """One plane family's occupancy at one instant.

    ``slot_capacity`` is the binding per-object axis, the one a capacity
    regrow widens (member slots for ORSWOT, key slots for Map, actor
    columns for the counter planes); ``live_max`` is the busiest
    object's live count along it.  ``bytes`` is the exact footprint of
    the plane tensors (``element_size() * numel()`` summed)."""

    kind: str               # orswot / vclock / gcounter / pncounter / map
    objects: int            # N
    bytes: int              # exact plane bytes
    slot_capacity: int      # binding axis width per object
    slots: int              # total padded cells along the binding axis
    live: int               # live cells along the binding axis, fleet-wide
    live_max: int           # busiest object's live count
    actors: int = 0         # actor columns carried
    actors_live: int = 0    # actor columns with any dot
    tombstone_capacity: int = 0  # deferred slots per object (0 = none)
    tombstones: int = 0     # live deferred rows, fleet-wide
    tombstones_max: int = 0  # busiest object's deferred rows

    @property
    def utilization(self) -> float:
        """Live fraction of the binding axis, fleet-wide."""
        return self.live / self.slots if self.slots else 0.0
