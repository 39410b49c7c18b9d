"""Fleet low-watermark clocks — the causal-GC stability frontier (the
port of the JAX package's ``gc/watermark.py``; its gauges are fields of
:class:`WatermarkReport`).

The watermark is the element-wise minimum of the local version vector
and the per-peer vectors the digest exchange ships
(:mod:`crdt_tpu_torch.obs.convergence`): counters at or below it have
been witnessed by every peer this node has heard from.  Vectors of
different widths align by zero-padding (an absent actor's counter is 0,
`vclock.rs:206-210`).  Liveness rules:

* **staleness freeze** — a peer not heard from within ``stale_after_s``
  keeps contributing its last vector;
* **unheard peers** — a roster peer with no vector pins the watermark
  at zero;
* **quarantine** — a peer silent (or unheard) past ``quarantine_s`` is
  left out of the minimum, and counted;
* **restored floor** — a watermark persisted before a restart
  (:meth:`FleetWatermark.restore`) only ever raises the minimum.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from ..obs import convergence as obs_convergence


@dataclasses.dataclass
class WatermarkReport:
    """One watermark computation.  ``clock`` is the fleet low-watermark
    (``uint64[A]``); ``frozen`` is True when a stale or unheard peer
    holds it back."""

    clock: np.ndarray
    peers: int = 0          # peers contributing a cached vector
    stale: int = 0          # contributing but past stale_after_s
    unheard: int = 0        # roster peers with no vector yet (pin zero)
    excluded: int = 0       # quarantined out of the minimum
    age_s: float = 0.0      # oldest contributing observation's age
    max_counter: int = 0    # the watermark's largest counter
    local_lag: int = 0      # lag(local version vector) at compute time

    @property
    def frozen(self) -> bool:
        return self.stale > 0 or self.unheard > 0

    def lag(self, local_vv) -> int:
        """Max per-actor distance between the local frontier and the
        watermark."""
        wm, local = _aligned([self.clock, np.asarray(local_vv, dtype=np.uint64).reshape(-1)])
        if local.size == 0:
            return 0
        return int((local - np.minimum(local, wm)).max(initial=0))


def _aligned(vvs: Sequence[np.ndarray]) -> list:
    """Zero-pad vectors to a common width (implied-0 counters)."""
    width = max((v.size for v in vvs), default=0)
    return [np.concatenate([v, np.zeros(width - v.size, dtype=np.uint64)]).astype(np.uint64)
            for v in vvs]


class FleetWatermark:
    """Computes the fleet low-watermark from ``tracker``'s per-peer
    version vectors (the process-global tracker by default).  ``clock``
    is injectable for tests (monotonic seconds)."""

    def __init__(self, tracker: Optional[obs_convergence.ConvergenceTracker] = None, *,
                 stale_after_s: float = 30.0, quarantine_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < stale_after_s <= quarantine_s:
            raise ValueError(f"need 0 < stale_after_s <= quarantine_s, got "
                             f"{stale_after_s}/{quarantine_s}")
        self._tracker = tracker
        self.stale_after_s = stale_after_s
        self.quarantine_s = quarantine_s
        self._clock = clock
        self._lock = threading.Lock()
        self._first_seen: Dict[str, float] = {}
        self._floor: Optional[np.ndarray] = None

    def compute(self, local_vv, peers: Optional[Iterable[str]] = None) -> WatermarkReport:
        """The fleet low-watermark given the local version vector and an
        optional roster (whose peers without a vector pin it at zero until
        their quarantine)."""
        local = np.asarray(local_vv, dtype=np.uint64).reshape(-1)
        now = self._clock()
        tracker = self._tracker if self._tracker is not None else obs_convergence.tracker()
        vectors = tracker.version_vectors()
        report = WatermarkReport(clock=local.copy())
        contributing = [local]
        roster = set(peers) if peers is not None else set(vectors)
        with self._lock:
            floor = self._floor
            for peer in sorted(roster | set(vectors)):
                cached = vectors.get(peer)
                if cached is None:
                    if peer not in roster:
                        continue
                    first = self._first_seen.setdefault(peer, now)
                    if now - first > self.quarantine_s:
                        report.excluded += 1
                    else:
                        report.unheard += 1
                    continue
                self._first_seen.pop(peer, None)
                vv, seen_ts = cached
                age = max(0.0, now - seen_ts)
                if age > self.quarantine_s:
                    report.excluded += 1
                    continue
                report.peers += 1
                report.age_s = max(report.age_s, age)
                if age > self.stale_after_s:
                    report.stale += 1
                contributing.append(np.asarray(vv, dtype=np.uint64).reshape(-1))
        if report.unheard:
            report.clock = np.zeros_like(local)
        else:
            aligned = _aligned(contributing)
            report.clock = aligned[0]
            for v in aligned[1:]:
                report.clock = np.minimum(report.clock, v)
        if floor is not None:
            wm, fl = _aligned([report.clock, floor])
            report.clock = np.maximum(wm, fl)
        report.max_counter = int(report.clock.max(initial=0))
        report.local_lag = report.lag(local)
        return report

    def restore(self, clock) -> None:
        """Seed a floor persisted by a snapshot: counters at or below it
        were fleet-stable then, and stability is monotone."""
        with self._lock:
            self._floor = np.asarray(clock, dtype=np.uint64).reshape(-1).copy()

    def forget(self, peer: str) -> None:
        """Drop a peer's quarantine bookkeeping (it left the roster)."""
        with self._lock:
            self._first_seen.pop(peer, None)
