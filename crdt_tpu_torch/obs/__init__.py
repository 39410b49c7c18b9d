"""Observation state: plane occupancy and the capacity tracker
(:mod:`~crdt_tpu_torch.obs.capacity`), per-peer convergence state
(:mod:`~crdt_tpu_torch.obs.convergence`), the flight recorder
(:mod:`~crdt_tpu_torch.obs.events`), session profiles, round-trip
estimates and replication lag (:mod:`~crdt_tpu_torch.obs.latency`),
divergence aging, the stability frontier and the lattice auditor
(:mod:`~crdt_tpu_torch.obs.stability`), heat and placement
(:mod:`~crdt_tpu_torch.obs.heat`) and the kernel observatory
(:mod:`~crdt_tpu_torch.obs.kernels`).  Plain counts and fields only; the
port declares no metric names."""

from .capacity import CapacityTracker, Occupancy, PlaneCapacity, capacity_tracker
from .events import FlightRecorder, recorder
from .heat import HeatTracker, heat_tracker
from .kernels import KernelObservatory, kernel_observatory, sample_device_memory
from .latency import LagTracker, RttEstimator, SessionProfile, lag_tracker
from .stability import AuditReport, FrontierReport, StabilityTracker, stability_tracker

__all__ = [
    "AuditReport", "CapacityTracker", "FlightRecorder", "FrontierReport", "HeatTracker",
    "KernelObservatory", "LagTracker", "Occupancy", "PlaneCapacity", "RttEstimator",
    "SessionProfile", "StabilityTracker", "capacity_tracker", "heat_tracker", "kernel_observatory", "lag_tracker",
    "recorder", "sample_device_memory", "stability_tracker",
]
