"""Causal garbage collection for long-lived fleets (the port of the JAX
package's ``gc``): the fleet low-watermark
(:mod:`~crdt_tpu_torch.gc.watermark`), tombstone settling, the reset
truncate and op-buffer compaction (:mod:`~crdt_tpu_torch.gc.compact`),
plane re-packing (:mod:`~crdt_tpu_torch.gc.repack`), and the policy and
engine that run a pass (:mod:`~crdt_tpu_torch.gc.policy`)."""

from .policy import GcEngine, GcPolicy, GcReport  # noqa: F401
from .watermark import FleetWatermark, WatermarkReport  # noqa: F401

__all__ = ["FleetWatermark", "GcEngine", "GcPolicy", "GcReport", "WatermarkReport"]
