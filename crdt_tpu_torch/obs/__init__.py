"""Observation state: plane occupancy and the capacity tracker
(:mod:`~crdt_tpu_torch.obs.capacity`), the per-peer version-vector cache
(:mod:`~crdt_tpu_torch.obs.convergence`), divergence aging, the
stability frontier and the lattice auditor
(:mod:`~crdt_tpu_torch.obs.stability`), heat and placement
(:mod:`~crdt_tpu_torch.obs.heat`) and the kernel observatory
(:mod:`~crdt_tpu_torch.obs.kernels`).  Plain counts and fields only; the
port declares no metric names."""

from .capacity import CapacityTracker, Occupancy, PlaneCapacity, capacity_tracker
from .heat import HeatTracker, heat_tracker
from .kernels import KernelObservatory, kernel_observatory, sample_device_memory
from .stability import AuditReport, FrontierReport, StabilityTracker, stability_tracker

__all__ = [
    "AuditReport", "CapacityTracker", "FrontierReport", "HeatTracker", "KernelObservatory",
    "Occupancy", "PlaneCapacity", "StabilityTracker", "capacity_tracker", "heat_tracker",
    "kernel_observatory", "sample_device_memory", "stability_tracker",
]
