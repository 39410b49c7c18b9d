"""The peer roster: who is in the fleet and how healthy each peer looks
(the port of the JAX package's ``cluster/membership.py``).

Three states, driven by consecutive failed sessions:

* **alive**: the last session succeeded, or the peer is new;
* **suspect**: ``suspect_after`` failures in a row;
* **dead**: ``dead_after`` failures in a row (a scheduler only probes it).

One success from any state makes the peer alive again.  Each transition
records a ``cluster.peer_state`` event in the flight recorder; the
fleet's shape is :meth:`Membership.counts` and :meth:`Membership.snapshot`
(the JAX package mirrors both into gauges).  State changes under one
lock; events are recorded after it is released.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from ..obs import events as obs_events

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

#: health states in escalation order
STATES = (ALIVE, SUSPECT, DEAD)


@dataclasses.dataclass
class PeerInfo:
    """One fleet member; ``address`` is opaque here (the dialer reads it)."""

    peer_id: str
    address: object = None
    state: str = ALIVE
    consecutive_failures: int = 0
    sessions_ok: int = 0
    sessions_failed: int = 0


class Membership:
    """The roster and its consecutive-failure thresholds
    (``1 <= suspect_after <= dead_after``).  ``tracker`` is the
    convergence tracker whose peer state :meth:`add` registers (None:
    the process-global one)."""

    def __init__(self, *, suspect_after: int = 2, dead_after: int = 5, tracker=None):
        if not 1 <= suspect_after <= dead_after:
            raise ValueError(f"need 1 <= suspect_after ({suspect_after}) <= "
                             f"dead_after ({dead_after})")
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self._tracker = tracker
        self._lock = threading.Lock()
        self._peers: Dict[str, PeerInfo] = {}

    # -- roster ----------------------------------------------------------------

    def add(self, peer_id: str, address: object = None) -> PeerInfo:
        """Register ``peer_id`` (re-adding refreshes the address and keeps
        the health); a new peer is registered with the convergence
        tracker, so it shows as never exchanged until a session lands."""
        with self._lock:
            info = self._peers.get(peer_id)
            created = info is None
            if created:
                info = self._peers[peer_id] = PeerInfo(peer_id, address)
            elif address is not None:
                info.address = address
            snapshot = dataclasses.replace(info)
        if created:
            tracker = self._tracker
            if tracker is None:
                from ..obs import convergence

                tracker = convergence.tracker()
            tracker.register_peer(peer_id)
        return snapshot

    def remove(self, peer_id: str) -> None:
        with self._lock:
            self._peers.pop(peer_id, None)

    def get(self, peer_id: str) -> Optional[PeerInfo]:
        with self._lock:
            info = self._peers.get(peer_id)
            return None if info is None else dataclasses.replace(info)

    def peers(self, *states: str) -> List[PeerInfo]:
        """Copies of the roster in insertion order, optionally only those
        in ``states``."""
        with self._lock:
            return [dataclasses.replace(p) for p in self._peers.values()
                    if not states or p.state in states]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {s: 0 for s in STATES}
            for p in self._peers.values():
                out[p.state] += 1
            return out

    # -- health observations -----------------------------------------------------

    @staticmethod
    def _transition(info: PeerInfo, new_state: str) -> Optional[Tuple]:
        old = info.state
        if old == new_state:
            return None
        info.state = new_state
        return info.peer_id, old, new_state, info.consecutive_failures

    def record_success(self, peer_id: str) -> None:
        """One converged session: failures reset, the peer is alive."""
        with self._lock:
            info = self._peers.get(peer_id)
            if info is None:
                info = self._peers[peer_id] = PeerInfo(peer_id)
            info.sessions_ok += 1
            info.consecutive_failures = 0
            changed = self._transition(info, ALIVE)
        self._emit(changed)

    def record_failure(self, peer_id: str) -> None:
        """One failed session: escalate through the thresholds."""
        with self._lock:
            info = self._peers.get(peer_id)
            if info is None:
                info = self._peers[peer_id] = PeerInfo(peer_id)
            info.sessions_failed += 1
            info.consecutive_failures += 1
            n = info.consecutive_failures
            if n >= self.dead_after:
                changed = self._transition(info, DEAD)
            elif n >= self.suspect_after:
                changed = self._transition(info, SUSPECT)
            else:
                changed = None
        self._emit(changed)

    @staticmethod
    def _emit(changed: Optional[Tuple]) -> None:
        if changed is not None:
            peer_id, old, new, failures = changed
            obs_events.record("cluster.peer_state", peer=peer_id, old=old, new=new,
                              consecutive_failures=failures)

    def snapshot(self) -> dict:
        """The roster as JSON-ready fields."""
        with self._lock:
            return {p.peer_id: {"state": p.state,
                                "consecutive_failures": p.consecutive_failures,
                                "sessions_ok": p.sessions_ok,
                                "sessions_failed": p.sessions_failed}
                    for p in self._peers.values()}
