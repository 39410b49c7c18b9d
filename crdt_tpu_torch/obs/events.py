"""The flight recorder: a bounded ring of structured events (the port of
the JAX package's ``obs/events.py``).

Each event carries a dotted kind (``sync.phase``, ``sync.error``), both
clocks (``wall_ts`` for display and ordering, ``mono_ts`` for durations)
and, where one exists, the sync session's ID, so a failed session's
trajectory can be read back after the fact.  The ring is a
``deque(maxlen=...)``: old events fall off the front and
:attr:`FlightRecorder.dropped` says how many did.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    """The bounded event ring; ``capacity`` events are retained."""

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._recorded = 0

    def record(self, kind: str, session: Optional[str] = None, **fields) -> None:
        """Append one event of ``kind``, stamped with ``session`` and the
        JSON-ready ``fields``."""
        ev = {"seq": 0, "mono_ts": time.monotonic(), "wall_ts": time.time(), "kind": kind}
        if session is not None:
            ev["session"] = session
        if fields:
            ev["fields"] = fields
        with self._lock:
            self._seq += 1
            self._recorded += 1
            ev["seq"] = self._seq
            self._buf.append(ev)

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound since the last :meth:`clear`."""
        with self._lock:
            return self._recorded - len(self._buf)

    def snapshot(self, kind: Optional[str] = None, session: Optional[str] = None) -> List[Dict]:
        """Copies of the retained events, oldest first, filtered by
        ``kind`` prefix (``"sync"`` matches ``sync.phase``) and exact
        ``session``."""
        with self._lock:
            evs = list(self._buf)
        return [dict(ev) for ev in evs
                if (kind is None or ev["kind"] == kind or ev["kind"].startswith(kind + "."))
                and (session is None or ev.get("session") == session)]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._recorded = 0


_DEFAULT = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-global flight recorder."""
    return _DEFAULT


def record(kind: str, session: Optional[str] = None, **fields) -> None:
    """Append one event to the process-global flight recorder."""
    _DEFAULT.record(kind, session=session, **fields)


_SESSION_SEQ = itertools.count(1)
#: a per-process random tag, so two peer processes never mint the same
#: session ID; it also names the process's monotonic clock domain
_PROC_TAG = os.urandom(3).hex()


def new_session_id() -> str:
    """A process-unique session ID, ``sync-<proc>-<n>``."""
    return f"sync-{_PROC_TAG}-{next(_SESSION_SEQ):04x}"
