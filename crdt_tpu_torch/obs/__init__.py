"""Observation state: plane occupancy and the capacity tracker
(:mod:`~crdt_tpu_torch.obs.capacity`), per-peer convergence state
(:mod:`~crdt_tpu_torch.obs.convergence`), the flight recorder
(:mod:`~crdt_tpu_torch.obs.events`), session profiles, round-trip
estimates and replication lag (:mod:`~crdt_tpu_torch.obs.latency`),
divergence aging, the stability frontier and the lattice auditor
(:mod:`~crdt_tpu_torch.obs.stability`), heat and placement
(:mod:`~crdt_tpu_torch.obs.heat`), the kernel observatory
(:mod:`~crdt_tpu_torch.obs.kernels`), and the telemetry plane: the typed
registry (:mod:`~crdt_tpu_torch.obs.metrics`), the publisher that fills it
from the port's counts at read time (:mod:`~crdt_tpu_torch.obs.publish`),
the exporter (:mod:`~crdt_tpu_torch.obs.export`) and the fleet
observatory (:mod:`~crdt_tpu_torch.obs.fleet`)."""

from .capacity import CapacityTracker, Occupancy, PlaneCapacity, capacity_tracker
from .convergence import ConvergenceTracker, tracker
from .events import FlightRecorder, new_session_id, record, recorder
from .export import start_metrics_server
from .fleet import FleetObservatory, FleetSnapshot, observatory, stitch_trace
from .heat import HeatTracker, heat_tracker
from .kernels import KernelObservatory, kernel_observatory, sample_device_memory
from .latency import LagTracker, RttEstimator, SessionProfile
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry
from .stability import AuditReport, FrontierReport, StabilityTracker, stability_tracker

__all__ = [
    "AuditReport", "CapacityTracker", "ConvergenceTracker", "Counter", "FleetObservatory",
    "FleetSnapshot", "FlightRecorder", "FrontierReport", "Gauge", "HeatTracker", "Histogram",
    "KernelObservatory", "LagTracker", "MetricsRegistry", "Occupancy", "PlaneCapacity",
    "RttEstimator", "SessionProfile", "StabilityTracker", "capacity_tracker", "heat_tracker",
    "kernel_observatory", "new_session_id", "observatory", "record", "recorder",
    "registry", "sample_device_memory", "stability_tracker", "start_metrics_server",
    "stitch_trace", "tracker",
]

