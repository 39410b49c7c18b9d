"""Transports: the byte channels a :class:`~crdt_tpu_torch.sync.SyncSession`
runs over (the port of the JAX package's ``cluster/transport.py``; the
same frames and envelopes on the wire, byte for byte).

* :class:`Transport`: ``send(frame)``, ``recv(timeout) -> frame`` and
  ``close()``; :meth:`SyncSession.sync` takes one directly.
* :class:`QueuePairTransport` and :func:`queue_pair`: two paired
  in-process endpoints over queues.
* :class:`TcpTransport`: ``<I``-length-prefixed frames over a socket,
  written without ever blocking the reads (see the class).
* :class:`ResilientTransport`: a windowed selective-repeat ARQ over any
  frame transport: sequence numbers, cumulative and selective acks, CRC
  envelopes, per-frame retransmit timers on the adaptive RTO of an
  :class:`~crdt_tpu_torch.obs.latency.RttEstimator`, backoff with seeded
  jitter, a finite retry budget and per-leg deadlines.  Loss,
  duplication, truncation, reordering and transient disconnects below it
  are absorbed; what escapes is a
  :class:`~crdt_tpu_torch.error.TransportError`: a
  :class:`~crdt_tpu_torch.error.SyncTimeoutError` when a deadline
  elapses, a :class:`~crdt_tpu_torch.error.PeerUnavailableError` when the
  budget runs dry or the peer hung up.
* :func:`linger`: keep answering the peer after one's own session has
  returned, until the peer's has too.

Counts that the JAX package keeps as counters and gauges are plain
integers here: :meth:`ResilientTransport.counts`, and the estimator's
:meth:`~crdt_tpu_torch.obs.latency.RttEstimator.snapshot`.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import selectors
import socket
import struct
import time
import zlib
from collections import deque
from typing import Callable, Optional, Tuple

from ..error import (
    PeerUnavailableError, SyncTimeoutError, TransportClosedError, TransportError,
    TransportFrameError,
)
from ..obs import events as obs_events
from ..obs.latency import RttEstimator


class Transport:
    """A connected, frame-oriented byte channel between two peers.
    ``recv`` blocks up to ``timeout`` seconds (None: the transport's
    default) and raises :class:`SyncTimeoutError` on timeout and
    :class:`TransportClosedError` when the peer hung up."""

    def send(self, frame: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError

    def close(self) -> None:  # idempotent
        pass

    def __enter__(self) -> "Transport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CallableTransport(Transport):
    """A ``(send, recv)`` callable pair as a :class:`Transport`.  The
    callables know no deadline, so ``recv``'s ``timeout`` is advisory:
    the callable blocks as it always did."""

    def __init__(self, send: Callable[[bytes], None], recv: Callable[[], bytes]):
        self._send = send
        self._recv = recv

    def send(self, frame: bytes) -> None:
        self._send(frame)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        return self._recv()


class QueuePairTransport(Transport):
    """One endpoint of an in-process frame channel over two queues;
    ``close`` pushes a sentinel so the peer's ``recv`` raises
    :class:`TransportClosedError` at once (the in-process FIN)."""

    _CLOSED = object()

    def __init__(self, out_q: "queue.Queue", in_q: "queue.Queue",
                 default_timeout: float = 120.0):
        self._out = out_q
        self._in = in_q
        self._default_timeout = default_timeout
        self._closed = False

    def send(self, frame: bytes) -> None:
        if self._closed:
            raise TransportClosedError("queue transport is closed")
        self._out.put(bytes(frame))

    def recv(self, timeout: Optional[float] = None) -> bytes:
        if self._closed:
            raise TransportClosedError("queue transport is closed")
        t = self._default_timeout if timeout is None else timeout
        try:
            item = self._in.get(timeout=t)
        except queue.Empty:
            raise SyncTimeoutError(f"no frame from peer within {t:.3f}s") from None
        if item is self._CLOSED:
            self._in.put(item)  # every later recv sees closed too
            raise TransportClosedError("peer closed the queue transport")
        return item

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._out.put(self._CLOSED)


def queue_pair(default_timeout: float = 120.0
               ) -> Tuple[QueuePairTransport, QueuePairTransport]:
    """Two connected in-process endpoints: A's sends are B's recvs and
    back."""
    a_to_b: "queue.Queue" = queue.Queue()
    b_to_a: "queue.Queue" = queue.Queue()
    return (QueuePairTransport(a_to_b, b_to_a, default_timeout),
            QueuePairTransport(b_to_a, a_to_b, default_timeout))


class TcpTransport(Transport):
    """``<I``-length-prefixed frames over a connected socket: the JAX
    package's framing, the same bytes on the wire.

    The socket is put in non-blocking mode and waited on with a selector.
    :meth:`send` writes the frame in pieces and, while the socket is
    readable, reads the peer's bytes into a receive buffer that
    :meth:`recv` serves first: two peers that each send a frame larger
    than their socket buffers before reading both finish (a blocking
    ``sendall`` deadlocks there).  ``send`` has its own deadline, the
    default timeout; one that times out or fails partway through a frame
    closes the link and raises :class:`TransportClosedError`, so half a
    frame never stays on a live stream.  ``recv``'s timeout bounds its
    wait for readability only and never becomes the socket's timeout; a
    frame that arrives in pieces stays buffered across timed-out calls."""

    _LEN = struct.Struct("<I")
    _READ = 1 << 20

    def __init__(self, sock: socket.socket, default_timeout: float = 120.0):
        self._sock = sock
        self._default_timeout = default_timeout
        self._buf = bytearray()
        self._eof = False
        self._closed = False
        sock.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(sock, selectors.EVENT_READ)

    def _abort(self, why: str):
        self.close()
        raise TransportClosedError(why)

    def _fill(self) -> None:
        """Move what the socket holds into the receive buffer."""
        while not self._eof:
            try:
                chunk = self._sock.recv(self._READ)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self._abort(f"socket recv failed: {e}")
            if not chunk:
                self._eof = True
                return
            self._buf += chunk

    def _pop(self) -> Optional[bytes]:
        buf = self._buf
        if len(buf) < self._LEN.size:
            return None
        (ln,) = self._LEN.unpack_from(buf)
        end = self._LEN.size + ln
        if len(buf) < end:
            return None
        with memoryview(buf) as view:
            frame = bytes(view[self._LEN.size:end])
        del buf[:end]
        return frame

    def send(self, frame: bytes) -> None:
        if self._closed:
            raise TransportClosedError("tcp transport is closed")
        frame = bytes(frame)
        total = self._LEN.size + len(frame)
        deadline = time.monotonic() + self._default_timeout
        written = 0
        self._sel.modify(self._sock, selectors.EVENT_WRITE
                         | (0 if self._eof else selectors.EVENT_READ))
        for part in (memoryview(self._LEN.pack(len(frame))), memoryview(frame)):
            off = 0
            while off < len(part):
                try:
                    n = self._sock.send(part[off:])
                except (BlockingIOError, InterruptedError):
                    n = 0
                except OSError as e:
                    self._abort(f"socket send failed after {written}/{total} bytes: {e}")
                off += n
                written += n
                if off == len(part):
                    break
                wait = deadline - time.monotonic()
                if wait <= 0:
                    self._abort(f"socket send timed out after {written}/{total} bytes")
                for _key, mask in self._sel.select(wait):
                    if mask & selectors.EVENT_READ:
                        self._fill()
                        if self._eof:  # stop polling a socket that stays readable
                            self._sel.modify(self._sock, selectors.EVENT_WRITE)
        self._sel.modify(self._sock, selectors.EVENT_READ)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        if self._closed:
            raise TransportClosedError("tcp transport is closed")
        t = self._default_timeout if timeout is None else timeout
        deadline = time.monotonic() + t
        while True:
            self._fill()
            frame = self._pop()
            if frame is not None:
                return frame
            if self._eof:
                raise TransportClosedError("peer closed the socket"
                                           + (" mid-frame" if self._buf else ""))
            wait = deadline - time.monotonic()
            if wait <= 0 or not self._sel.select(wait):
                raise SyncTimeoutError(f"no frame from peer within {t:.3f}s ({len(self._buf)} "
                                       "bytes of the next frame buffered)")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._sel.close()
        try:
            self._sock.close()
        except OSError:
            pass


# -- the resilient (ARQ) wrapper ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deadlines, backoff shape, retry budget and window of one
    :class:`ResilientTransport` (the JAX package's defaults).

    ``ack_timeout_s`` is the first retransmit timer; each retransmit
    multiplies it by ``backoff_factor`` up to ``max_backoff_s``, with
    ``jitter`` (a fraction of the delay) from the transport's seeded RNG.
    ``retry_budget`` bounds the retransmits and transient inner errors
    over the transport's life.  With ``adaptive`` the timer is the
    estimator's ``srtt + 4·rttvar`` clamped to ``[min_rto_s,
    max_backoff_s]`` (``ack_timeout_s``, clamped, before the first
    sample).  ``window`` is the most DATA frames unacked at once (1:
    stop-and-wait); a session runs at the minimum of both peers'."""

    send_deadline_s: float = 30.0
    recv_deadline_s: float = 30.0
    ack_timeout_s: float = 0.1
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.25
    retry_budget: int = 64
    adaptive: bool = True
    min_rto_s: float = 0.01
    window: int = 16


_DATA = 0x01
_ACK = 0x02
_SACK = 0x03

#: ARQ envelope: kind(1) | seq(8) | crc32(4) | payload_len(4) | payload
_ENV = struct.Struct("<BQII")


def encode_envelope(kind: int, seq: int, payload: bytes = b"") -> bytes:
    return _ENV.pack(kind, seq, zlib.crc32(payload), len(payload)) + payload


def decode_envelope(env: bytes) -> Tuple[int, int, bytes]:
    """``(kind, seq, payload)`` of a valid envelope; raises
    :class:`TransportFrameError` on truncation, a length or CRC mismatch
    or an unknown kind (the receiver drops it as loss)."""
    if len(env) < _ENV.size:
        raise TransportFrameError(f"truncated ARQ envelope: {len(env)} bytes < "
                                  f"{_ENV.size}-byte header")
    kind, seq, crc, plen = _ENV.unpack_from(env)
    if kind not in (_DATA, _ACK, _SACK):
        raise TransportFrameError(f"unknown ARQ envelope kind {kind:#04x}")
    payload = env[_ENV.size:]
    if len(payload) != plen:
        raise TransportFrameError(f"ARQ envelope length mismatch: header says {plen}, "
                                  f"envelope carries {len(payload)}")
    if zlib.crc32(payload) != crc:
        raise TransportFrameError("ARQ envelope CRC mismatch")
    return kind, seq, payload


class _InFlight:
    """One unacked DATA frame on the sender's side of the window."""

    __slots__ = ("env", "seq", "t_first", "deadline", "expiry", "attempts", "sent", "sacked")

    def __init__(self, env: bytes, seq: int, now: float, send_deadline_s: float):
        self.env = env
        self.seq = seq
        self.t_first = now          # first transmission (Karn's base)
        self.deadline = now + send_deadline_s
        self.expiry = now           # due at once: the first send rides the timer path
        self.attempts = 0           # retransmissions so far
        self.sent = False           # at least one inner send went through
        self.sacked = False         # the peer holds it (selective ack)


_COUNTS = ("retransmits", "duplicates", "corrupt", "transient_errors", "sacks_sent",
           "frames_sacked", "ooo_buffered", "window_hw", "timeouts", "window_fallbacks")


class ResilientTransport(Transport):
    """Reliable, in-order, exactly-once delivery over an unreliable frame
    transport.

    ``send`` ships a sequence-numbered, CRC-guarded DATA envelope and
    returns once the window (``policy.window``) has room for the next
    frame; ``recv`` delivers payloads in order, once: arrivals past a gap
    are buffered and selectively acked, duplicates re-acked and dropped,
    corrupt envelopes dropped as loss.  One pump serves both directions
    from whichever leg is blocked (``send`` on a full window, ``recv`` on
    an empty inbox, ``flush``/``close`` on stragglers): it retransmits
    expired frames, answers the peer's DATA and retires acked frames.
    One session thread per transport: the state machine has no lock.

    ``ACK k`` is cumulative (every seq ``<= k`` delivered); ``SACK``
    carries the next expected seq and the seqs held past the gap, so only
    missing frames go again.  A leg past its deadline raises
    :class:`SyncTimeoutError`; a spent retry budget, or a link closed on
    the receive path, raises :class:`PeerUnavailableError`.  Closure on
    the send path is retried with backoff (a flap heals).

    First-transmission acks feed :attr:`rtt` (Karn's rule: retransmitted
    frames never sample; a selectively acked frame samples at SACK time),
    which drives the retransmit timers and the close drain under
    ``policy.adaptive``.  :meth:`counts` gives the link's tallies."""

    def __init__(self, inner: Transport, policy: Optional[RetryPolicy] = None, *,
                 name: str = "link", seed: int = 0):
        self._inner = inner
        self.policy = policy or RetryPolicy()
        self.name = name
        self._rng = random.Random(seed)
        self._send_seq = 0     # next DATA seq to ship
        self._recv_next = 0    # next in-order seq to deliver
        self._inbox: deque = deque()
        self._inflight: "dict[int, _InFlight]" = {}
        self._ooo: "dict[int, bytes]" = {}  # out-of-order receive buffer
        self._window = max(1, int(self.policy.window))
        self._budget = self.policy.retry_budget
        for k in _COUNTS:
            setattr(self, k, 0)
        self.rtt = RttEstimator()

    def counts(self) -> dict:
        """The link's tallies: ``retransmits``, ``duplicates``,
        ``corrupt``, ``transient_errors``, ``sacks_sent``,
        ``frames_sacked``, ``ooo_buffered``, ``window_hw`` (frames in
        flight, high water), ``timeouts`` and ``window_fallbacks``."""
        return {k: getattr(self, k) for k in _COUNTS}

    # -- window negotiation ------------------------------------------------------

    @property
    def window(self) -> int:
        """The window in force (after negotiation)."""
        return self._window

    def negotiate_window(self, peer_window: int) -> int:
        """Clamp the window to what the peer advertised over HELLO:
        ``min(configured, peer)``, and 1 against a peer that advertised
        none (0).  A clamp below the configured window counts a
        ``window_fallbacks`` and records a ``cluster.transport.fallback``
        event; the ack grammar is stop-and-wait's, so mixed windows
        converge all the same."""
        configured = max(1, int(self.policy.window))
        negotiated = max(1, min(configured, int(peer_window)))
        if negotiated < configured:
            self.window_fallbacks += 1
            obs_events.record("cluster.transport.fallback", link=self.name, reason="window",
                              configured=configured, peer=int(peer_window),
                              negotiated=negotiated)
        self._window = negotiated
        return negotiated

    # -- budget and backoff --------------------------------------------------------

    def _spend(self, reason: str) -> None:
        self._budget -= 1
        if self._budget < 0:
            raise PeerUnavailableError(f"transport {self.name}: retry budget "
                                       f"({self.policy.retry_budget}) exhausted ({reason})")

    def current_rto(self) -> float:
        """The retransmit timer in force: the estimator's, clamped to
        ``[min_rto_s, max_backoff_s]``, under ``policy.adaptive``; else
        ``ack_timeout_s``."""
        p = self.policy
        if not p.adaptive:
            return p.ack_timeout_s
        rto = self.rtt.rto(p.min_rto_s, p.max_backoff_s, default_s=p.ack_timeout_s)
        return p.ack_timeout_s if rto is None else rto

    def _delay(self, attempt: int) -> float:
        p = self.policy
        d = min(p.max_backoff_s, self.current_rto() * (p.backoff_factor ** attempt))
        return d * (1.0 + p.jitter * (2.0 * self._rng.random() - 1.0))

    def _transient(self, leg: str, err: TransportError) -> None:
        self.transient_errors += 1
        self._spend(f"{leg}: {err}")

    # -- the receive path ------------------------------------------------------------

    def _ooo_cap(self) -> int:
        # covers the peer's window, with room for a misconfigured one
        return max(64, 4 * self._window)

    def _send_ack(self, seq: int) -> None:
        try:
            self._inner.send(encode_envelope(_ACK, seq))
        except TransportError as e:
            self._transient("ack", e)  # a lost ack: the peer retransmits

    def _send_sack(self) -> None:
        """Next expected seq plus the seqs held past the gap (at most 128)."""
        seqs = sorted(self._ooo)[:128]
        payload = struct.pack(f"<{len(seqs)}Q", *seqs)
        try:
            self._inner.send(encode_envelope(_SACK, self._recv_next, payload))
            self.sacks_sent += 1
        except TransportError as e:
            self._transient("ack", e)

    def _ack_current(self) -> None:
        """A SACK while a gap is open, else a cumulative ACK of the whole
        delivered prefix."""
        if self._ooo:
            self._send_sack()
        elif self._recv_next > 0:
            self._send_ack(self._recv_next - 1)

    def _on_data(self, seq: int, payload: bytes) -> None:
        if seq == self._recv_next:
            self._recv_next += 1
            self._inbox.append(payload)
            while self._recv_next in self._ooo:  # a gap closed
                self._inbox.append(self._ooo.pop(self._recv_next))
                self._recv_next += 1
            self._ack_current()
        elif seq < self._recv_next or seq in self._ooo:
            self.duplicates += 1
            self._ack_current()
        else:
            if len(self._ooo) >= self._ooo_cap():
                return  # loss: the peer retransmits
            self._ooo[seq] = payload
            self.ooo_buffered += 1
            self._send_sack()

    def _on_ack(self, acked: int) -> None:
        now = time.monotonic()
        for seq in [s for s in self._inflight if s <= acked]:
            p = self._inflight.pop(seq)
            if p.attempts == 0 and not p.sacked:
                self.rtt.observe(now - p.t_first)  # Karn: sent exactly once

    def _on_sack(self, next_expected: int, payload: bytes) -> None:
        self._on_ack(next_expected - 1)
        now = time.monotonic()
        n = len(payload) // 8
        for (seq,) in struct.iter_unpack("<Q", payload[:n * 8]):
            p = self._inflight.get(seq)
            if p is not None and not p.sacked:
                p.sacked = True
                self.frames_sacked += 1
                if p.attempts == 0:
                    self.rtt.observe(now - p.t_first)

    def _dispatch(self, env: bytes) -> None:
        try:
            kind, seq, payload = decode_envelope(env)
        except TransportFrameError:
            self.corrupt += 1
            return
        if kind == _DATA:
            self._on_data(seq, payload)
        elif kind == _ACK:
            self._on_ack(seq)
        else:
            self._on_sack(seq, payload)

    # -- the pump ----------------------------------------------------------------------

    def _service_timers(self) -> Optional[float]:
        """(Re)transmit every in-flight frame whose timer expired and
        return the next due time (None: nothing armed); a frame past its
        send deadline raises."""
        now = time.monotonic()
        nxt: Optional[float] = None
        for p in list(self._inflight.values()):
            if p.sacked:
                continue
            if now >= p.deadline:
                self.timeouts += 1
                raise SyncTimeoutError(
                    f"transport {self.name}: no ack for seq={p.seq} within "
                    f"{self.policy.send_deadline_s:.3f}s ({p.attempts + 1} attempts)")
            if now >= p.expiry:
                delay = self._delay(p.attempts)
                try:
                    self._inner.send(p.env)
                except TransportError as e:
                    self._transient("send", e)  # a flap heals; the budget bounds it
                    p.expiry = now + min(delay, self.policy.ack_timeout_s)
                else:
                    if p.sent:
                        p.attempts += 1
                        self.retransmits += 1
                        self._spend(f"retransmit seq={p.seq}")
                        obs_events.record("cluster.transport.retry", link=self.name,
                                          seq=p.seq, attempt=p.attempts - 1,
                                          backoff_s=round(delay, 4))
                    else:
                        p.sent = True
                        p.t_first = now
                    p.expiry = now + self._delay(p.attempts)
            t = min(p.expiry, p.deadline)
            nxt = t if nxt is None else min(nxt, t)
        return nxt

    def _pump(self, deadline: float, *, idle_wait: Optional[float] = None) -> bool:
        """One step: service the timers, wait for at most one inner
        envelope (bounded by the next timer, ``deadline`` and
        ``idle_wait``) and dispatch it.  True when one was dispatched."""
        nxt = self._service_timers()
        now = time.monotonic()
        wait = max(0.0, deadline - now)
        if nxt is not None:
            wait = min(wait, max(0.0, nxt - now))
        if idle_wait is not None:
            wait = min(wait, idle_wait)
        try:
            env = self._inner.recv(timeout=max(wait, 0.001))
        except SyncTimeoutError:
            return False
        except TransportClosedError as e:
            # closed on the receive path is terminal: the peer hung up
            raise PeerUnavailableError(f"transport {self.name}: peer closed the link: {e}") \
                from e
        except TransportError as e:
            self._transient("recv", e)
            time.sleep(min(self.policy.ack_timeout_s, max(deadline - time.monotonic(), 0)))
            return False
        self._dispatch(env)
        return True

    # -- the public legs -------------------------------------------------------------

    def send(self, frame: bytes) -> None:
        """Ship one frame; return once it is on the wire and the window
        has room for the next (with ``window=1``, once it is acked)."""
        p = self.policy
        seq = self._send_seq
        self._send_seq += 1
        slot = _InFlight(encode_envelope(_DATA, seq, frame), seq, time.monotonic(),
                         p.send_deadline_s)
        self._inflight[seq] = slot
        self.window_hw = max(self.window_hw, len(self._inflight))
        self._service_timers()  # the first transmission
        while len(self._inflight) >= self._window:
            self._pump(slot.deadline)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Pump until every in-flight frame is acked (the delivery
        barrier; ``send`` only guarantees window admission)."""
        budget_s = self.policy.send_deadline_s if timeout is None else timeout
        deadline = time.monotonic() + budget_s
        while self._inflight:
            if time.monotonic() >= deadline:
                self.timeouts += 1
                raise SyncTimeoutError(f"transport {self.name}: {len(self._inflight)} frames "
                                       f"still unacked after {budget_s:.3f}s flush")
            self._pump(deadline)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        budget_s = self.policy.recv_deadline_s if timeout is None else timeout
        deadline = time.monotonic() + budget_s
        while not self._inbox:
            if time.monotonic() >= deadline:
                self.timeouts += 1
                raise SyncTimeoutError(f"transport {self.name}: no frame from peer within "
                                       f"{budget_s:.3f}s")
            self._pump(deadline)
        return self._inbox.popleft()

    def close(self) -> None:
        """Drain, then close the inner transport.  Our tail frames may be
        unacked and our last ack lost, so keep servicing our timers until
        the window empties and keep answering the peer (every answer is
        cumulative) until the link is quiet for two retransmit timers
        (at most 1 s), the peer hangs up or the cap elapses."""
        rto = self.current_rto()
        quiet_s = min(2.0 * rto, 1.0)
        cap = time.monotonic() + 3.0 * quiet_s + (3.0 * quiet_s if self._inflight else 0.0)
        last_activity = time.monotonic()
        while (time.monotonic() < cap
               and (self._inflight or time.monotonic() - last_activity < quiet_s)):
            try:
                if self._pump(cap, idle_wait=min(rto, max(cap - time.monotonic(), 0.001))):
                    last_activity = time.monotonic()
            except TransportError:
                break  # the peer hung up, the budget ran dry or a deadline lapsed
        self._inner.close()


def linger(link: Transport, until: Callable[[], bool], timeout_s: float) -> None:
    """Keep answering the peer over ``link`` until ``until()`` holds, the
    link fails or ``timeout_s`` elapses; frames that arrive are dropped.

    A session that has returned no longer reads its link, so over a lossy
    :class:`ResilientTransport` the peer's last frame, or the ack it
    waits for, can strand and run the peer into its deadline.  Where both
    sessions run side by side, the one that returns first lingers until
    the other has returned; then each closes its own end.  A peer in
    another process that only closes its link needs no lingering:
    :meth:`ResilientTransport.close` drains."""
    deadline = time.monotonic() + timeout_s
    while not until() and time.monotonic() < deadline:
        try:
            link.recv(timeout=0.05)
        except SyncTimeoutError:
            continue
        except TransportError:
            return
