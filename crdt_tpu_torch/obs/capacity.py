"""Plane occupancy and the capacity tracker (the port of the JAX
package's ``obs/capacity.py``; its gauges are the tracker's
:class:`PlaneCapacity` fields and :meth:`CapacityTracker.watermark`, and
its ``regrow_timeline`` waits for the flight recorder).
:func:`crdt_tpu_torch.batch.occupancy.occupancy_of` fills
:class:`Occupancy` for the dense batch types; :class:`CapacityTracker`
turns samples into EWMA growth rates, overflow ETAs and a watermark
state (``ok``/``warn``/``critical``), which ``GcEngine.due`` reads."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

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


#: the executor's default regrow ceiling, the horizon ETAs count toward
DEFAULT_CEILING = 1 << 16

#: ``eta_s`` when the plane is not growing
ETA_NOT_GROWING = -1.0


@dataclasses.dataclass
class PlaneCapacity:
    """One tracked plane's latest sample and derived series."""

    occupancy: Occupancy
    ceiling: int                 # regrow ceiling ETAs count toward
    rate: Optional[float]        # EWMA live_max growth, rows/s
    eta_s: float                 # seconds to ceiling (-1: not growing; 0: there)
    state: str                   # ok / warn / critical
    sampled_at: float            # tracker-clock timestamp


class CapacityTracker:
    """Samples plane occupancy into growth rates, overflow ETAs and a
    watermark state.  ``warn_frac``/``critical_frac`` grade the busiest
    object's share of the ceiling; ``alpha`` weighs the EWMA of growth;
    ``clock`` gives monotonic seconds; ``device`` is the card whose
    allocator :meth:`sample_device_memory` reads (default ``"cuda"``)."""

    def __init__(self, *, max_capacity: int = DEFAULT_CEILING, warn_frac: float = 0.7,
                 critical_frac: float = 0.9, alpha: float = 0.3,
                 clock: Callable[[], float] = time.monotonic, device=None):
        if not 0.0 < warn_frac <= critical_frac <= 1.0:
            raise ValueError(f"need 0 < warn_frac <= critical_frac <= 1, got "
                             f"{warn_frac}/{critical_frac}")
        self.max_capacity = max_capacity
        self.warn_frac = warn_frac
        self.critical_frac = critical_frac
        self.alpha = alpha
        self.device = device
        self._clock = clock
        self._lock = threading.Lock()
        self._planes: Dict[str, PlaneCapacity] = {}
        self._samples = 0
        self._growth_seen: set = set()  # labels whose growth rate was ever set
        self._devicemem: Optional[dict] = None
        self._devicemem_samples = 0

    def sample(self, batch, label: Optional[str] = None, *, ceiling: Optional[int] = None):
        """Measure ``batch``'s planes (one reduction where they live, one
        small copy to the host) and fold the sample in; TypeError for
        batch types without dense planes."""
        from ..batch.occupancy import occupancy_of

        return self.observe(occupancy_of(batch), label=label, ceiling=ceiling)

    def sample_oplog(self, log, label: str = "oplog"):
        """The op log's buffered ops against its bound."""
        o = log.occupancy()
        return self.observe(_buffer_occupancy("oplog", o), label=label, ceiling=o["capacity"])

    def sample_gap_buffer(self, applier, label: str = "oplog_gap"):
        """The causal-gap park buffer's parked adds against its bound."""
        o = applier.occupancy()
        return self.observe(_buffer_occupancy("oplog_gap", o), label=label,
                            ceiling=o["capacity"])

    def sample_device_memory(self):
        """The device allocator's statistics beside this tracker's plane
        bytes (:func:`crdt_tpu_torch.obs.kernels.sample_device_memory`)."""
        from .kernels import sample_device_memory

        out = sample_device_memory(self.device, tracker=self)
        if out is not None:
            with self._lock:
                self._devicemem = out
                self._devicemem_samples += 1
        return out

    def observe(self, occ: Occupancy, label: Optional[str] = None, *,
                ceiling: Optional[int] = None) -> Occupancy:
        """Fold one occupancy sample in under ``label`` (one segment,
        default its ``kind``)."""
        label = label if label is not None else occ.kind
        if not label or "." in label or "/" in label:
            raise ValueError(f"capacity label must be a single metric segment, got {label!r}")
        if ceiling is None:
            # actor planes cannot regrow: their horizon is their width
            ceiling = occ.slot_capacity if occ.kind in ("vclock", "gcounter", "pncounter") \
                else self.max_capacity
        now = self._clock()
        with self._lock:
            prev = self._planes.get(label)
            rate = prev.rate if prev is not None else None
            changed = prev is not None and prev.occupancy.slot_capacity != occ.slot_capacity
            if changed:
                # re-packed or regrown between samples: re-seed the rate
                rate, prev = None, None
            if prev is not None and now > prev.sampled_at:
                inst = (occ.live_max - prev.occupancy.live_max) / (now - prev.sampled_at)
                rate = inst if rate is None else self.alpha * inst + (1.0 - self.alpha) * rate
            headroom = ceiling - occ.live_max
            if headroom <= 0:
                eta = 0.0
            elif rate is not None and rate > 0:
                eta = headroom / rate
            else:
                eta = ETA_NOT_GROWING
            util = occ.live_max / ceiling if ceiling > 0 else 0.0
            state = "critical" if util >= self.critical_frac else \
                "warn" if util >= self.warn_frac else "ok"
            self._planes[label] = PlaneCapacity(occupancy=occ, ceiling=ceiling, rate=rate,
                                                eta_s=eta, state=state, sampled_at=now)
            self._samples += 1
            if rate is not None or changed:
                self._growth_seen.add(label)
        return occ

    def watermark(self) -> dict:
        """The overall ``state`` (the most severe plane's; ``ok`` with
        none) and a per-plane breakdown."""
        with self._lock:
            planes = dict(self._planes)
        state_idx = 0
        detail = {}
        for label, p in sorted(planes.items()):
            state_idx = max(state_idx, WATERMARK_STATES.index(p.state))
            detail[label] = {
                "state": p.state, "live_max": p.occupancy.live_max, "ceiling": p.ceiling,
                "utilization": round(p.occupancy.live_max / p.ceiling, 6) if p.ceiling else 0.0,
                "bytes": p.occupancy.bytes, "growth_rows_per_s": p.rate, "eta_s": p.eta_s,
            }
        return {"state": WATERMARK_STATES[state_idx], "planes": detail}

    def planes(self) -> Dict[str, PlaneCapacity]:
        """A consistent copy of the per-plane state."""
        with self._lock:
            return dict(self._planes)

    def published(self) -> dict:
        """The gauges' view: the ``planes``, the ``samples`` folded, the
        labels whose growth rate was ever set (``growth_seen``: a plane
        whose rate re-seeds reads 0, not a stale rate) and the newest
        device-memory sample with the count of them."""
        with self._lock:
            return {"planes": dict(self._planes), "samples": self._samples,
                    "growth_seen": set(self._growth_seen), "devicemem": self._devicemem,
                    "devicemem_samples": self._devicemem_samples}

    def reset(self) -> None:
        with self._lock:
            self._planes.clear()
            self._samples = self._devicemem_samples = 0
            self._growth_seen = set()
            self._devicemem = None

    def regrow_timeline(self, recorder=None) -> List[dict]:
        """The executor's capacity regrows in order: every
        ``executor.regrow`` flight-recorder event with its schedule and
        its before/after member and deferred capacities."""
        from . import events as events_mod

        rec = recorder if recorder is not None else events_mod.recorder()
        out = []
        for ev in rec.snapshot(kind="executor.regrow"):
            f = ev.get("fields", {})
            out.append({"mono_ts": ev["mono_ts"], "wall_ts": ev["wall_ts"],
                        "schedule": f.get("schedule"),
                        "member_capacity": (f.get("member_capacity_before"),
                                            f.get("member_capacity")),
                        "deferred_capacity": (f.get("deferred_capacity_before"),
                                              f.get("deferred_capacity"))})
        return out


def _buffer_occupancy(kind: str, o: dict) -> Occupancy:
    """An op-buffer occupancy dict (``OpLog.occupancy()``,
    ``OpApplier.occupancy()``) as an :class:`Occupancy`."""
    return Occupancy(kind=kind, objects=int(o.get("segments", 0)), bytes=int(o["bytes"]),
                     slot_capacity=int(o["capacity"]), slots=int(o["capacity"]),
                     live=int(o["ops"]), live_max=int(o["ops"]))


_DEFAULT: Optional[CapacityTracker] = None
_DEFAULT_LOCK = threading.Lock()


def capacity_tracker() -> CapacityTracker:
    """The process-global capacity tracker."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = CapacityTracker()
    return _DEFAULT
