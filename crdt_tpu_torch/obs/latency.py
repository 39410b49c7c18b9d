"""Where a sync session's time goes, how long a link's round trip is,
and how stale a peer's writes are (the port of the JAX package's
``SessionProfile``, ``RttEstimator`` and ``LagTracker`` from
``obs/latency.py``; every node owns its lag tracker, and a session
without one exchanges no lag frames, so the port keeps no process-global
tracker).

* :class:`SessionProfile` accounts one session's wall time in integer
  nanoseconds: ``serialize`` (encode and decode), ``network`` (blocked
  in send or recv), ``kernel`` (digests, trees, delta apply) and
  ``other`` (the piggybacks).  ``serialize + network + kernel + other +
  unaccounted == wall`` holds to the nanosecond by construction.
* :class:`RttEstimator` is Jacobson/Karels smoothing of a link's round
  trips; the ARQ transport's adaptive retransmit timer reads it.
* :class:`LagTracker` measures write-to-visible lag per peer: the origin
  stamps each ingested dot ``(actor, counter)`` with its monotonic clock,
  the stamps ride a converged session as the LAG sidecar frame, and the
  observer measures each entry once its clock plane witnesses the dot.
  Monotonic stamps compare only within one process, so entries from
  another clock domain are counted and dropped.  Percentiles are plain
  fields of :meth:`LagTracker.snapshot`; :meth:`LagTracker.observe_round`
  keeps the convergence SLO over a window of gossip rounds.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: newest ingest stamps retained per origin actor
STAMPS_PER_ACTOR = 8
#: distinct origin actors the stamp table tracks
MAX_ACTORS = 512
#: measured write-to-visible samples retained per peer
LAG_WINDOW = 512
#: gossip-round outcomes the SLO window retains
SLO_WINDOW = 128
#: a round meets the convergence SLO when it converged within this budget
SLO_BUDGET_S = 1.0


class SessionProfile:
    """Integer-nanosecond accounting of one sync session's wall time.
    Used by the one thread that runs the session, so it has no lock.
    :meth:`clock` regions may nest: only the outermost is charged, so no
    time counts twice."""

    __slots__ = ("wall_ns", "serialize_ns", "network_ns", "kernel_ns", "other_ns",
                 "frames_sent", "frames_received", "_t0", "_depth")

    def __init__(self):
        self.wall_ns = self.serialize_ns = self.network_ns = 0
        self.kernel_ns = self.other_ns = 0
        self.frames_sent = self.frames_received = 0
        self._t0: Optional[int] = None
        self._depth = 0

    def start(self) -> None:
        self._t0 = time.monotonic_ns()

    def add(self, category: str, ns: int) -> None:
        setattr(self, f"{category}_ns", getattr(self, f"{category}_ns") + int(ns))

    @contextlib.contextmanager
    def clock(self, category: str) -> Iterator[None]:
        """Charge the region's wall time to ``category`` (the outermost
        region's category when regions nest)."""
        t0 = time.monotonic_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self.add(category, time.monotonic_ns() - t0)

    def finish(self) -> None:
        """Stop the wall clock (the last call wins)."""
        if self._t0 is not None:
            self.wall_ns = time.monotonic_ns() - self._t0

    @property
    def accounted_ns(self) -> int:
        return self.serialize_ns + self.network_ns + self.kernel_ns + self.other_ns

    @property
    def unaccounted_ns(self) -> int:
        """The wall time no stamp covered."""
        return self.wall_ns - self.accounted_ns

    @property
    def network_wait_frac(self) -> float:
        """The share of the wall spent blocked on the wire."""
        return self.network_ns / self.wall_ns if self.wall_ns else 0.0

    def to_dict(self) -> dict:
        return {"wall_ns": self.wall_ns, "serialize_ns": self.serialize_ns,
                "network_ns": self.network_ns, "kernel_ns": self.kernel_ns,
                "other_ns": self.other_ns, "unaccounted_ns": self.unaccounted_ns,
                "network_wait_frac": round(self.network_wait_frac, 6),
                "frames_sent": self.frames_sent, "frames_received": self.frames_received}

    def __repr__(self) -> str:
        ms = 1e6
        return (f"SessionProfile(wall={self.wall_ns / ms:.2f}ms "
                f"serialize={self.serialize_ns / ms:.2f} network={self.network_ns / ms:.2f} "
                f"kernel={self.kernel_ns / ms:.2f} other={self.other_ns / ms:.2f} "
                f"unaccounted={self.unaccounted_ns / ms:.2f})")


class RttEstimator:
    """SRTT and RTTVAR per Jacobson/Karels (RFC 6298's shape).

    The first sample seeds ``srtt = s``, ``rttvar = s/2``; each later one
    sets ``rttvar = (1-β)·rttvar + β·|srtt - s|``, then ``srtt = (1-α)·srtt
    + α·s``, with α=1/8 and β=1/4.  :meth:`rto` is ``srtt + 4·rttvar``
    clamped into the caller's bounds.  One lock: the transport's thread
    and a reader may race."""

    __slots__ = ("alpha", "beta", "srtt_s", "rttvar_s", "samples", "last_sample_s", "_lock")

    def __init__(self, alpha: float = 1.0 / 8, beta: float = 1.0 / 4):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.srtt_s: Optional[float] = None
        self.rttvar_s: Optional[float] = None
        self.samples = 0
        self.last_sample_s: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, sample_s: float) -> None:
        """Fold one round-trip sample in; a negative one (a clock that
        stepped back) is ignored.  Callers apply Karn's rule."""
        s = float(sample_s)
        if s < 0.0:
            return
        with self._lock:
            if self.srtt_s is None:
                self.srtt_s = s
                self.rttvar_s = s / 2.0
            else:
                self.rttvar_s = (1.0 - self.beta) * self.rttvar_s + self.beta * abs(self.srtt_s - s)
                self.srtt_s = (1.0 - self.alpha) * self.srtt_s + self.alpha * s
            self.samples += 1
            self.last_sample_s = s

    def rto(self, floor_s: float, cap_s: float,
            default_s: Optional[float] = None) -> Optional[float]:
        """``srtt + 4·rttvar`` clamped to ``[floor_s, cap_s]``; before the
        first sample ``default_s`` (clamped too), or None without one."""
        with self._lock:
            raw = None if self.srtt_s is None else self.srtt_s + 4.0 * self.rttvar_s
        if raw is None:
            if default_s is None:
                return None
            raw = default_s
        return min(max(raw, float(floor_s)), float(cap_s))

    def snapshot(self) -> dict:
        with self._lock:
            return {"srtt_s": self.srtt_s, "rttvar_s": self.rttvar_s, "samples": self.samples,
                    "last_sample_s": self.last_sample_s}


def _percentile(sorted_samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending sequence."""
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1, max(0, int(round(q * (len(sorted_samples) - 1)))))
    return float(sorted_samples[idx])


class _PeerLag:
    __slots__ = ("samples", "pending", "measured_frontier")

    def __init__(self):
        self.samples: deque = deque(maxlen=LAG_WINDOW)               # seconds
        self.pending: Dict[int, List[Tuple[int, int]]] = {}         # actor -> [(counter, ns)]
        self.measured_frontier: Dict[int, int] = {}                 # actor -> counter


class LagTracker:
    """The origin stamp table and the per-peer write-to-visible samples
    of one replica.  ``proc_tag`` names this process's monotonic clock
    domain (the flight recorder's process tag by default)."""

    def __init__(self, *, proc_tag: Optional[str] = None, slo_budget_s: float = SLO_BUDGET_S,
                 per_actor: int = STAMPS_PER_ACTOR, max_actors: int = MAX_ACTORS):
        from . import events

        self.proc_tag = events._PROC_TAG if proc_tag is None else proc_tag
        self.slo_budget_s = float(slo_budget_s)
        self.per_actor = int(per_actor)
        self.max_actors = int(max_actors)
        self._lock = threading.Lock()
        self._stamps: Dict[int, deque] = {}
        self._peers: Dict[str, _PeerLag] = {}
        self._foreign_dropped = 0
        self._measured = 0
        self._slo: deque = deque(maxlen=SLO_WINDOW)

    # -- origin side -----------------------------------------------------------

    def record_ingest(self, actor: int, counter: int, mono_ns: Optional[int] = None) -> None:
        """Stamp one ingested dot: the newest ``per_actor`` dots per actor
        of at most ``max_actors`` actors are kept (later actors are
        dropped)."""
        now = time.monotonic_ns() if mono_ns is None else int(mono_ns)
        with self._lock:
            dq = self._stamps.get(int(actor))
            if dq is None:
                if len(self._stamps) >= self.max_actors:
                    return
                dq = self._stamps[int(actor)] = deque(maxlen=self.per_actor)
            dq.append((int(counter), now))

    def record_ingest_batch(self, ops) -> None:
        """Stamp an op batch's dot frontier: per actor, its highest
        counter."""
        if ops is None or len(ops) == 0:
            return
        now = time.monotonic_ns()
        frontier: Dict[int, int] = {}
        for a, c in zip(ops.actor.tolist(), ops.counter.tolist()):
            if frontier.get(int(a), -1) < int(c):
                frontier[int(a)] = int(c)
        for a, c in frontier.items():
            self.record_ingest(a, c, mono_ns=now)

    def export_entries(self) -> List[Tuple[int, int, int]]:
        """The sidecar: every retained ``(actor, counter, mono_ns)``,
        actor-major, oldest first."""
        with self._lock:
            return [(a, c, t) for a in sorted(self._stamps) for c, t in self._stamps[a]]

    # -- observer side ---------------------------------------------------------

    def ingest_sidecar(self, peer: str, entries: Sequence[Tuple[int, int, int]],
                       origin_proc: str) -> int:
        """Add a peer's sidecar entries to its pending set; returns how many
        were taken.  Entries of another clock domain are dropped and
        counted; already measured or already pending ones are skipped."""
        if origin_proc != self.proc_tag:
            with self._lock:
                self._foreign_dropped += 1
            return 0
        accepted = 0
        with self._lock:
            st = self._peers.setdefault(peer, _PeerLag())
            for actor, counter, mono_ns in entries:
                actor, counter = int(actor), int(counter)
                if counter <= st.measured_frontier.get(actor, -1):
                    continue
                bucket = st.pending.setdefault(actor, [])
                if any(c == counter for c, _ in bucket):
                    continue
                bucket.append((counter, int(mono_ns)))
                accepted += 1
        return accepted

    def observe_visibility(self, visible, peer: Optional[str] = None) -> int:
        """Measure every pending entry (of ``peer``, or of all peers) whose
        dot ``visible`` witnesses: ``visible[actor]`` is the highest
        visible counter of that actor.  Returns the new samples."""
        measured = 0
        now = time.monotonic_ns()
        with self._lock:
            for name in ([peer] if peer is not None else list(self._peers)):
                st = self._peers.get(name)
                if st is None:
                    continue
                for actor in list(st.pending):
                    try:
                        vis = int(visible[actor])
                    except (IndexError, KeyError, TypeError):
                        continue
                    keep = []
                    for counter, mono_ns in st.pending[actor]:
                        if counter <= vis:
                            st.samples.append(max(0, now - mono_ns) / 1e9)
                            st.measured_frontier[actor] = max(
                                st.measured_frontier.get(actor, -1), counter)
                            measured += 1
                        else:
                            keep.append((counter, mono_ns))
                    if keep:
                        st.pending[actor] = keep
                    else:
                        del st.pending[actor]
            self._measured += measured
        return measured

    def observe_round(self, converged: bool, wall_s: float) -> float:
        """Record one gossip round's outcome; returns the share of the
        recent window of rounds that converged within ``slo_budget_s``."""
        ok = bool(converged) and float(wall_s) <= self.slo_budget_s
        with self._lock:
            self._slo.append(ok)
            return sum(self._slo) / len(self._slo)

    def refresh(self) -> dict:
        """The per-peer lag view, computed now (the JAX tracker publishes
        it as gauges): :meth:`snapshot`'s ``peers``."""
        return self.snapshot()["peers"]

    def snapshot(self) -> dict:
        """Per peer: retained samples, their p50 and p99 (seconds), the
        entries still outstanding and the age of the oldest one
        (``current_s``); the actors stamped, the samples measured in all,
        the sidecars dropped as another clock domain's, and the SLO
        window's length and share of rounds that met the budget (None
        before a round)."""
        now = time.monotonic_ns()
        with self._lock:
            peers = {}
            for name, st in self._peers.items():
                samples = sorted(st.samples)
                oldest = min((t for v in st.pending.values() for _, t in v), default=None)
                peers[name] = {
                    "samples": len(samples), "p50_s": _percentile(samples, 0.50),
                    "p99_s": _percentile(samples, 0.99),
                    "outstanding": sum(len(v) for v in st.pending.values()),
                    "current_s": 0.0 if oldest is None else max(0, now - oldest) / 1e9}
            return {"peers": peers, "stamped_actors": len(self._stamps),
                    "measured": self._measured,
                    "foreign_sidecars_dropped": self._foreign_dropped,
                    "slo_window": len(self._slo),
                    "slo_converged_frac": sum(self._slo) / len(self._slo) if self._slo else None}
