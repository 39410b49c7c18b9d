"""Host-side observation state the sync and GC layers read: the plane
occupancy record (:class:`~crdt_tpu_torch.obs.capacity.Occupancy`) and
the per-peer version-vector cache (:mod:`~crdt_tpu_torch.obs.convergence`).
Plain counts and fields only; the port declares no metric names."""
