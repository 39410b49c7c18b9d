"""Per-peer convergence state (the port of the JAX package's
``ConvergenceTracker``: ``register_peer``, ``observe_divergence``,
``observe_session``, ``observe_tree``, the version-vector cache the
fleet watermark reads, ``snapshot``, ``refresh`` and ``urgency``, the
gossip scheduler's ranking key).  The JAX tracker mirrors each field into
a registry gauge; here they are plain fields of
:meth:`ConvergenceTracker.snapshot`, and :meth:`ConvergenceTracker.
published_leaves` says which of them the JAX tracker would have set."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

_HISTORY = 64  # delta_ratio observations retained per peer

#: what a roster peer reads before any exchange: never converged, and a
#: divergence that is unknown, never a reassuring 0
NEVER_SYNCED_STALENESS = float("inf")
UNKNOWN_DIVERGENCE = -1


class _PeerState:
    __slots__ = ("divergence", "objects", "rounds_to_converge", "sessions",
                 "converged_sessions", "last_converged_ts", "delta_ratios",
                 "divergence_resolved", "version_vector", "version_vector_ts",
                 "diverged_subtrees", "leaves")

    def __init__(self):
        self.divergence = 0
        self.objects = 0
        self.diverged_subtrees = 0         # widest diverged frontier of the last descent
        self.rounds_to_converge = 0
        self.sessions = 0
        self.converged_sessions = 0
        self.last_converged_ts: Optional[float] = None
        self.delta_ratios: deque = deque(maxlen=_HISTORY)
        self.divergence_resolved = True    # a converged session resolved `divergence`
        self.version_vector: Optional[tuple] = None
        self.version_vector_ts: Optional[float] = None
        self.leaves: set = set()           # the JAX gauges an observation has set


class ConvergenceTracker:
    """The convergence state of every peer this replica syncs with."""

    def __init__(self):
        self._lock = threading.Lock()
        self._peers: Dict[str, _PeerState] = {}

    def _state(self, peer: str) -> _PeerState:
        st = self._peers.get(peer)
        if st is None:
            st = self._peers[peer] = _PeerState()
        return st

    def register_peer(self, peer: str) -> None:
        """Seed a roster peer before any exchange: its divergence reads
        :data:`UNKNOWN_DIVERGENCE` until one lands.  A peer with state is
        left as it is."""
        with self._lock:
            if peer not in self._peers:
                st = self._state(peer)
                st.divergence = UNKNOWN_DIVERGENCE
                st.leaves |= {"staleness_s", "divergence", "divergence_frac"}

    def observe_divergence(self, peer: str, diverged: int, objects: int) -> None:
        """One digest exchange against ``peer``: ``diverged`` of
        ``objects`` rows differ."""
        with self._lock:
            st = self._state(peer)
            st.divergence = int(diverged)
            st.objects = int(objects)
            st.divergence_resolved = diverged == 0
            st.leaves |= {"divergence", "divergence_frac"}

    def observe_session(self, peer: str, *, converged: bool, rounds: int,
                        payload_bytes: int = 0, full_state_bytes: Optional[int] = None) -> None:
        """One finished session against ``peer``: its digest rounds and,
        when ``full_state_bytes`` is known, its delta ratio."""
        with self._lock:
            st = self._state(peer)
            st.sessions += 1
            st.rounds_to_converge = int(rounds)
            if converged:
                st.converged_sessions += 1
                st.last_converged_ts = time.monotonic()
                st.divergence_resolved = True
            if full_state_bytes:
                st.delta_ratios.append(payload_bytes / full_state_bytes)
                st.leaves.add("delta_ratio")
            st.leaves.add("rounds_to_converge")
            if converged:
                st.leaves.add("staleness_s")

    def observe_tree(self, peer: str, subtrees: int) -> None:
        """One tree descent's widest diverged frontier against ``peer``."""
        with self._lock:
            st = self._state(peer)
            st.diverged_subtrees = int(subtrees)
            st.leaves.add("diverged_subtrees")

    def observe_version_vector(self, peer: str, vv, at: Optional[float] = None) -> None:
        """Cache ``peer``'s version vector from a digest exchange (any
        iterable of counters, kept as a tuple of ints); ``at`` overrides
        the observation time (monotonic seconds)."""
        frozen = tuple(int(c) for c in vv)
        now = time.monotonic() if at is None else at
        with self._lock:
            st = self._state(peer)
            st.version_vector, st.version_vector_ts = frozen, now

    def version_vectors(self) -> Dict[str, tuple]:
        """``{peer: (version_vector, observed_ts)}`` of every peer that
        shipped one."""
        with self._lock:
            return {peer: (st.version_vector, st.version_vector_ts)
                    for peer, st in self._peers.items() if st.version_vector is not None}

    def snapshot(self) -> dict:
        """Per peer, its fields, with ``staleness_s`` (seconds since the
        last converged session, :data:`NEVER_SYNCED_STALENESS` before
        one) computed now."""
        now = time.monotonic()
        with self._lock:
            return {peer: {
                "divergence": st.divergence, "objects": st.objects,
                "divergence_frac": (st.divergence / st.objects if st.objects
                                    else float(min(st.divergence, 0))),
                "rounds_to_converge": st.rounds_to_converge,
                "divergence_resolved": st.divergence_resolved,
                "diverged_subtrees": st.diverged_subtrees, "sessions": st.sessions,
                "converged_sessions": st.converged_sessions,
                "staleness_s": (NEVER_SYNCED_STALENESS if st.last_converged_ts is None
                                else now - st.last_converged_ts),
                "delta_ratio_history": list(st.delta_ratios)}
                for peer, st in self._peers.items()}

    def published_leaves(self) -> Dict[str, tuple]:
        """Per peer, the :meth:`snapshot` fields the JAX tracker would have
        set as ``sync.peer.<peer>.<field>`` gauges by now (``delta_ratio``
        is the newest of ``delta_ratio_history``)."""
        with self._lock:
            return {peer: tuple(sorted(st.leaves)) for peer, st in self._peers.items()}

    def refresh(self) -> Dict[str, float]:
        """``{peer: seconds since its last converged session}`` for every
        peer that has converged, computed now (the JAX tracker publishes
        these as its staleness gauges before a scrape)."""
        now = time.monotonic()
        with self._lock:
            return {peer: now - st.last_converged_ts for peer, st in self._peers.items()
                    if st.last_converged_ts is not None}

    def urgency(self, peer: str) -> tuple:
        """How badly ``peer`` needs a sync, as a descending sort key:
        ``(staleness seconds, last diverged fraction, diverged subtree
        count)``, all +inf for a peer never converged with, so never-synced
        peers rank first, then the one ignored longest, then the one that
        differed most, then the costliest descent."""
        now = time.monotonic()
        with self._lock:
            st = self._peers.get(peer)
            if st is None or st.last_converged_ts is None:
                return (float("inf"), float("inf"), float("inf"))
            frac = st.divergence / st.objects if st.objects else 0.0
            return (now - st.last_converged_ts, frac, st.diverged_subtrees)

    def reset(self) -> None:
        with self._lock:
            self._peers.clear()


_DEFAULT = ConvergenceTracker()


def tracker() -> ConvergenceTracker:
    return _DEFAULT
