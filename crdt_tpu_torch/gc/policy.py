"""GcPolicy and GcEngine — when causal GC runs and what it reclaims (the
port of the JAX package's ``gc/policy.py``; its counters are plain
counts, :attr:`GcEngine.counts`).

One collection pass:

1. the fleet low-watermark from the cached per-peer version vectors
   (:class:`~crdt_tpu_torch.gc.watermark.FleetWatermark`);
2. tombstone settling (:func:`~crdt_tpu_torch.gc.compact.settle_orswot`);
3. a re-pack down the capacity ladder when the live occupancy clears
   the shrink hysteresis (:mod:`crdt_tpu_torch.gc.repack`);
4. the op log and the causal-gap park buffer compacted below each
   actor's watermark entry.

:attr:`GcReport.seconds` times each step on the host's clock (each ends
in a small copy to the host, so the device work is inside it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

from .watermark import FleetWatermark, WatermarkReport


@dataclasses.dataclass
class GcPolicy:
    """Knobs of one node's causal GC: run every ``interval_rounds``
    gossip round, or off-cadence once the capacity tracker's watermark
    state reaches ``utilization_trigger`` (None disables it); re-pack
    only when the fitted rung is at most ``shrink_hysteresis`` of the
    current one, never below ``member_floor``/``deferred_floor`` (None:
    the universe config's capacities); the watermark liveness knobs; and
    whether to compact the op buffers."""

    interval_rounds: int = 4
    utilization_trigger: Optional[str] = "warn"
    shrink_hysteresis: float = 0.5
    member_floor: Optional[int] = None
    deferred_floor: Optional[int] = None
    stale_after_s: float = 30.0
    quarantine_s: float = 300.0
    compact_op_buffers: bool = True

    def __post_init__(self):
        if self.interval_rounds < 1:
            raise ValueError(f"interval_rounds {self.interval_rounds} < 1")
        if self.utilization_trigger not in (None, "warn", "critical"):
            raise ValueError(f"utilization_trigger must be None/'warn'/'critical', got "
                             f"{self.utilization_trigger!r}")


@dataclasses.dataclass
class GcReport:
    """What one collection pass reclaimed.  ``reclaimed_bytes`` counts
    the planes' and the op buffers' bytes; ``oplog_bytes_reclaimed`` the
    op buffers' share."""

    watermark: Optional[WatermarkReport] = None
    tombstones_cleared: int = 0
    members_freed: int = 0
    shrunk: bool = False
    member_capacity: Optional[tuple] = None    # (before, after)
    deferred_capacity: Optional[tuple] = None  # (before, after)
    reclaimed_bytes: int = 0
    oplog_ops_dropped: int = 0
    oplog_bytes_reclaimed: int = 0
    skipped: Optional[str] = None  # why the pass did no plane work
    seconds: dict = dataclasses.field(default_factory=dict)  # step -> host seconds


class GcEngine:
    """Runs a :class:`GcPolicy` against one node's batch and op buffers.
    ``tracker`` feeds the watermark (the process-global one by default);
    ``capacity_tracker`` is any object whose ``watermark()["state"]`` is
    one of :data:`~crdt_tpu_torch.obs.capacity.WATERMARK_STATES`."""

    def __init__(self, policy: Optional[GcPolicy] = None, *, tracker=None,
                 capacity_tracker=None, clock=None):
        self.policy = policy if policy is not None else GcPolicy()
        self._capacity_tracker = capacity_tracker
        kwargs = {} if clock is None else {"clock": clock}
        self.watermark = FleetWatermark(tracker, stale_after_s=self.policy.stale_after_s,
                                        quarantine_s=self.policy.quarantine_s, **kwargs)
        self.runs = 0
        self.total_reclaimed_bytes = 0
        self.counts = dict.fromkeys(("tombstones_cleared", "oplog_ops_dropped", "shrinks"), 0)
        self.last_report: Optional[GcReport] = None

    def restore_watermark(self, clock) -> None:
        """Seed the watermark's floor from a persisted clock."""
        self.watermark.restore(clock)

    def due(self, round_no: int) -> bool:
        """Whether to collect this round: the cadence, or the capacity
        trigger firing early."""
        if round_no % self.policy.interval_rounds == 0:
            return True
        trigger = self.policy.utilization_trigger
        if trigger is not None and self._capacity_tracker is not None:
            from ..obs.capacity import WATERMARK_STATES

            state = self._capacity_tracker.watermark()["state"]
            return WATERMARK_STATES.index(state) >= WATERMARK_STATES.index(trigger)
        return False

    def collect(self, batch, *, universe=None, oplog=None, applier=None,
                peers: Optional[Iterable[str]] = None):
        """``(batch, GcReport)``: one collection pass.  Only ORSWOT
        batches compact their planes; other types get the watermark and
        the op-buffer compaction (``report.skipped`` says why)."""
        import numpy as np

        from ..sync import digest as digest_mod

        report = GcReport()
        t = time.perf_counter()
        try:
            local_vv = digest_mod.version_vector(batch)
        except TypeError:
            local_vv = None
        if local_vv is not None:
            report.watermark = self.watermark.compute(np.asarray(local_vv).reshape(-1),
                                                      peers=peers)
        t = self._lap(report, "watermark", t)
        if hasattr(batch, "d_ids") and hasattr(batch, "ids"):
            batch = self._collect_orswot(batch, universe, report, t)
        else:
            report.skipped = f"no compaction for {type(batch).__name__}"
        t = time.perf_counter()
        if self.policy.compact_op_buffers and report.watermark is not None:
            self._compact_buffers(batch, oplog, applier, report)
        self._lap(report, "op_buffers", t)
        self.runs += 1
        self.total_reclaimed_bytes += report.reclaimed_bytes
        self.counts["tombstones_cleared"] += report.tombstones_cleared
        self.counts["oplog_ops_dropped"] += report.oplog_ops_dropped
        self.counts["shrinks"] += int(report.shrunk)
        self.last_report = report
        return batch, report

    @staticmethod
    def _lap(report: GcReport, step: str, t0: float) -> float:
        t = time.perf_counter()
        report.seconds[step] = t - t0
        return t

    def _collect_orswot(self, batch, universe, report: GcReport, t: float):
        from ..batch.occupancy import occupancy_of
        from . import compact as gc_compact
        from . import repack as gc_repack

        batch, stats = gc_compact.settle_orswot(batch)
        report.tombstones_cleared = stats["tombstones_cleared"]
        report.members_freed = stats["members_freed"]
        t = self._lap(report, "settle", t)
        m_floor, d_floor = self.policy.member_floor, self.policy.deferred_floor
        if universe is not None:
            cfg = universe.config
            # never below the config rung: the delta applier's peer rows
            # come at exactly these widths
            m_floor = max(m_floor or 0, cfg.member_capacity)
            d_floor = max(d_floor or 0, cfg.deferred_capacity)
        if m_floor is None or d_floor is None:
            raise ValueError("GcEngine.collect needs a universe (config floors) or explicit "
                             "member_floor/deferred_floor in the policy")
        plan = gc_repack.shrink_plan(occupancy_of(batch), member_floor=m_floor,
                                     deferred_floor=d_floor,
                                     hysteresis=self.policy.shrink_hysteresis)
        if plan is not None:
            before = (batch.member_capacity, batch.deferred_capacity)
            batch, reclaimed = gc_repack.repack_orswot(batch, *plan)
            report.shrunk = True
            report.member_capacity = (before[0], batch.member_capacity)
            report.deferred_capacity = (before[1], batch.deferred_capacity)
            report.reclaimed_bytes += reclaimed
        self._lap(report, "repack", t)
        return batch

    def _compact_buffers(self, batch, oplog, applier, report: GcReport) -> None:
        from . import compact as gc_compact

        clock_plane = getattr(batch, "clock", None)
        if clock_plane is None or clock_plane.dim() != 2 or (oplog is None and applier is None):
            return
        wm = report.watermark.clock
        for buf, fn in ((oplog, gc_compact.compact_oplog),
                        (applier, gc_compact.compact_gap_buffer)):
            if buf is not None:
                res = fn(buf, clock_plane, wm)
                report.oplog_ops_dropped += res["ops_dropped"]
                report.oplog_bytes_reclaimed += res["bytes_reclaimed"]
        report.reclaimed_bytes += report.oplog_bytes_reclaimed
