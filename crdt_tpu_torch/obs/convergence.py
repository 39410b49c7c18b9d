"""The per-peer version-vector cache the fleet watermark reads (the port
of the JAX package's ``ConvergenceTracker.observe_version_vector`` /
``version_vectors`` / ``reset`` and the process-global ``tracker()``;
the divergence and staleness telemetry around it is not ported)."""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class ConvergenceTracker:
    """The most recent version-vector summary per peer, with the
    monotonic time it was observed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vectors: Dict[str, tuple] = {}

    def observe_version_vector(self, peer: str, vv, at: Optional[float] = None) -> None:
        """Cache ``peer``'s version vector from a digest exchange (any
        iterable of counters, kept as a tuple of ints); ``at`` overrides
        the observation time (monotonic seconds)."""
        frozen = tuple(int(c) for c in vv)
        now = time.monotonic() if at is None else at
        with self._lock:
            self._vectors[peer] = (frozen, now)

    def version_vectors(self) -> Dict[str, tuple]:
        """``{peer: (version_vector, observed_ts)}``."""
        with self._lock:
            return dict(self._vectors)

    def reset(self) -> None:
        with self._lock:
            self._vectors.clear()


_DEFAULT = ConvergenceTracker()


def tracker() -> ConvergenceTracker:
    return _DEFAULT
