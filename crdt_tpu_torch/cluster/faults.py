"""Deterministic fault injection: the adversary the transports are tested
against (the port of the transport half of the JAX package's
``cluster/faults.py``; the same RNG draws per send, so the same plan and
seed inject the same faults into the same frames).

:class:`FaultyTransport` wraps a transport's SEND side with one seeded
roll per frame: drop, duplicate, truncate, delay (the frame ships after
the next one) or disconnect mid-frame (a prefix ships, then the link is
down for ``reconnect_after`` frames).  It sits under the ARQ::

    session -> ResilientTransport -> FaultyTransport -> queue or TCP

so drops and delays become retransmits or selective acks, truncations
die at the envelope CRC, duplicates are suppressed by sequence number and
disconnects back off as transient errors.  :class:`LatencyTransport`
gives a link a one-way propagation delay (:func:`latency_pair` for both
ends), and :class:`FlappingDialer` refuses a scheduled subset of dials.
Each keeps its tallies as plain counts (``injected``, ``refused``).

The crash half stands in for ``kill -9``: an armed :class:`CrashPlan`
makes the k-th hit of a named :func:`crash_point` raise
:class:`InjectedCrash`, which the cluster node's op drain and session
start call.
"""

from __future__ import annotations

import dataclasses
import random
import struct
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence

from ..error import PeerUnavailableError, TransportClosedError
from .transport import Transport, queue_pair


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-frame fault probabilities, tried in the order drop, duplicate,
    truncate, delay, disconnect (at most one fault per frame), and the
    flap width.  All zeros: a transparent wrapper."""

    seed: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    truncate: float = 0.0
    delay: float = 0.0
    disconnect: float = 0.0
    #: sends that fail after an injected disconnect before the link heals
    reconnect_after: int = 6

    def total(self) -> float:
        return self.drop + self.duplicate + self.truncate + self.delay + self.disconnect


class FaultyTransport(Transport):
    """``inner`` with ``plan``'s faults injected on the send side.  The
    k-th ``send`` draws the same two numbers for the same plan whatever
    the timing, so a run replays from its seed; ``injected`` tallies
    each kind."""

    def __init__(self, inner: Transport, plan: FaultPlan, *, name: str = "faulty"):
        if not 0.0 <= plan.total() <= 1.0:
            raise ValueError(f"fault probabilities sum to {plan.total():.3f}, "
                             "need a value in [0, 1]")
        self._inner = inner
        self.plan = plan
        self.name = name
        self._rng = random.Random(plan.seed)
        self._down_for = 0          # injected link-down sends remaining
        self._delayed: Optional[bytes] = None
        self.injected = {k: 0 for k in ("drop", "duplicate", "truncate", "delay", "disconnect")}

    def send(self, frame: bytes) -> None:
        frame = bytes(frame)
        # both draws come before the down-window check: the schedule is a
        # function of the attempt count only
        roll = self._rng.random()
        cut = self._rng.random()
        if self._down_for > 0:
            self._down_for -= 1
            raise TransportClosedError(f"{self.name}: injected link-down window "
                                       f"({self._down_for + 1} frames remaining)")
        p = self.plan
        edge = p.drop
        if roll < edge:
            self.injected["drop"] += 1
            return
        edge += p.duplicate
        if roll < edge:
            self.injected["duplicate"] += 1
            self._inner.send(frame)
            self._inner.send(frame)
        elif roll < (edge := edge + p.truncate):
            self.injected["truncate"] += 1
            self._inner.send(frame[: int(cut * len(frame))])
        elif roll < (edge := edge + p.delay):
            # held until after the next frame; one held at close is a drop
            self.injected["delay"] += 1
            if self._delayed is not None:
                self._inner.send(self._delayed)
            self._delayed = frame
            return
        elif roll < edge + p.disconnect:
            self.injected["disconnect"] += 1
            self._down_for = max(0, p.reconnect_after - 1)
            self._inner.send(frame[: int(cut * len(frame))])
            raise TransportClosedError(f"{self.name}: injected disconnect mid-frame")
        else:
            self._inner.send(frame)
        if self._delayed is not None:
            delayed, self._delayed = self._delayed, None
            self._inner.send(delayed)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        return self._inner.recv(timeout)

    def close(self) -> None:
        self._inner.close()


class LatencyTransport(Transport):
    """``inner`` with a one-way propagation delay.  ``send`` stamps the
    frame with its monotonic due time (``now + one_way_s`` plus seeded
    jitter) and forwards it at once; ``recv`` strips the stamp and sleeps
    out the rest of the transit.  Monotonic stamps: in-process links
    only.  ``injected`` counts the frames delayed."""

    _STAMP = 8  # u64 big-endian monotonic-ns due time

    def __init__(self, inner: Transport, one_way_s: float, *, jitter_s: float = 0.0,
                 seed: int = 0, name: str = "latency"):
        if one_way_s < 0.0:
            raise ValueError(f"one_way_s {one_way_s} < 0")
        if jitter_s < 0.0:
            raise ValueError(f"jitter_s {jitter_s} < 0")
        self._inner = inner
        self.one_way_s = float(one_way_s)
        self.jitter_s = float(jitter_s)
        self.name = name
        self._rng = random.Random(seed)
        self.injected = 0

    def send(self, frame: bytes) -> None:
        delay = self.one_way_s
        if self.jitter_s:
            delay += self.jitter_s * self._rng.random()
        due = time.monotonic_ns() + int(delay * 1e9)
        self.injected += 1
        self._inner.send(struct.pack(">Q", due) + bytes(frame))

    def recv(self, timeout: Optional[float] = None) -> bytes:
        env = self._inner.recv(timeout)
        if len(env) < self._STAMP:
            return bytes(env)  # a truncation ate the stamp: the ARQ's problem
        (due,) = struct.unpack_from(">Q", env)
        wait = (due - time.monotonic_ns()) / 1e9
        if wait > 0:
            time.sleep(wait)
        return bytes(env[self._STAMP:])

    def close(self) -> None:
        self._inner.close()


def latency_pair(one_way_s: float, *, jitter_s: float = 0.0, seed: int = 0,
                 default_timeout: float = 120.0):
    """A :func:`queue_pair` with both ends in :class:`LatencyTransport`:
    a ``2·one_way_s`` round trip."""
    a, b = queue_pair(default_timeout=default_timeout)
    return (LatencyTransport(a, one_way_s, jitter_s=jitter_s, seed=seed, name="latency-a"),
            LatencyTransport(b, one_way_s, jitter_s=jitter_s, seed=seed + 1, name="latency-b"))


class FlappingDialer:
    """A dialer whose k-th attempt goes through iff ``schedule[k % len]``;
    a refused attempt counts in ``refused`` and raises
    :class:`PeerUnavailableError`, which membership escalates on."""

    def __init__(self, dial, schedule: Sequence[bool]):
        if not schedule:
            raise ValueError("schedule must be non-empty")
        self._dial = dial
        self._schedule = tuple(bool(x) for x in schedule)
        self._calls = 0
        self.refused = 0

    def __call__(self, peer) -> Transport:
        up = self._schedule[self._calls % len(self._schedule)]
        self._calls += 1
        if not up:
            self.refused += 1
            raise PeerUnavailableError(f"injected dial refusal (attempt {self._calls})")
        return self._dial(peer)


# -- crash injection ------------------------------------------------------------------


class InjectedCrash(BaseException):
    """An in-process stand-in for ``kill -9``.  A ``BaseException``, so
    the ``except Exception`` paths that would mask a crash cannot swallow
    it: it unwinds to the harness, which abandons the node."""


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """``{point_name: k}``: the k-th (1-based) hit of each named point
    crashes, once; points not named never fire."""

    at: Mapping[str, int]

    def __post_init__(self):
        for name, k in self.at.items():
            if k < 1:
                raise ValueError(f"CrashPlan point {name!r} schedules hit {k} < 1")


class CrashState:
    """Per-point hit counts of one armed :class:`CrashPlan`, and the
    points that fired (each fires once)."""

    def __init__(self, plan: CrashPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fired: List[str] = []

    @property
    def fired(self) -> List[str]:
        with self._lock:
            return list(self._fired)

    def hit(self, name: str) -> bool:
        """Count one hit of ``name``; True when this hit is the one
        scheduled to crash and the point has not fired before."""
        scheduled = self.plan.at.get(name)
        with self._lock:
            self._hits[name] = self._hits.get(name, 0) + 1
            if scheduled is None or name in self._fired or self._hits[name] != scheduled:
                return False
            self._fired.append(name)
            return True


_crash_state: Optional[CrashState] = None


def arm_crashes(plan: CrashPlan) -> CrashState:
    """Arm ``plan`` process-wide and return its state; pair it with
    :func:`disarm_crashes` in a ``finally``."""
    global _crash_state
    state = CrashState(plan)
    _crash_state = state
    return state


def disarm_crashes() -> None:
    global _crash_state
    _crash_state = None


def crash_point(name: str) -> None:
    """A ``kill -9``-shaped moment: raises :class:`InjectedCrash` when the
    armed plan schedules this hit, and does nothing otherwise."""
    state = _crash_state
    if state is not None and state.hit(name):
        raise InjectedCrash(f"injected kill -9 at crash point {name!r}")
