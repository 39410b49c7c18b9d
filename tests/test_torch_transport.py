"""Parity of the port's transports (``crdt_tpu_torch.cluster.transport``
and ``faults``, ``obs.latency.RttEstimator``) with the JAX package's, on
the CPU: envelopes byte-equal and rejected alike, the same retry policy,
the same RTT trajectories and timer clamps, the same fault decisions for
the same plan and seed; the port's ARQ delivers every frame once and in
order under each fault kind, retransmits one lost frame once and clamps
its window against an old peer.

The TCP transport keeps the JAX bytes on the wire, and two of its
endpoints that each send a 10 MB frame before reading both finish, where
the JAX pair deadlocks (pinned: with 2 s socket timeouts both JAX sends
raise).  Every socket, thread join and receive here has a timeout, so a
regression fails in seconds."""

import dataclasses
import random
import socket
import struct
import threading
import time

import pytest
import torch

from crdt_tpu.cluster import faults as jfaults
from crdt_tpu.cluster import transport as jtransport
from crdt_tpu.error import TransportClosedError as JaxTransportClosedError
from crdt_tpu.error import TransportFrameError as JaxTransportFrameError
from crdt_tpu.obs import latency as jlatency
from crdt_tpu_torch.cluster import faults, transport
from crdt_tpu_torch.cluster.transport import (
    ResilientTransport, RetryPolicy, TcpTransport, queue_pair,
)
from crdt_tpu_torch.error import (
    PeerUnavailableError, SyncTimeoutError, TransportClosedError, TransportError,
    TransportFrameError,
)
from crdt_tpu_torch.obs import events
from crdt_tpu_torch.obs.latency import RttEstimator

torch.set_num_threads(1)

FAST = RetryPolicy(send_deadline_s=3.0, recv_deadline_s=3.0, ack_timeout_s=0.05,
                   max_backoff_s=0.3, retry_budget=400)
BIG = 10 * (1 << 20)
JOIN_S = 20.0


# -- envelopes, policy, estimator ---------------------------------------------------


ENVELOPES = [
    (transport._DATA, 0, b""),
    (transport._DATA, 7, b"payload"),
    (transport._ACK, (1 << 63) + 5, b""),
    (transport._SACK, 3, struct.pack("<3Q", 4, 5, 9)),
    (transport._DATA, (1 << 64) - 1, bytes(range(256)) * 40),
]


@pytest.mark.parametrize("kind,seq,payload", ENVELOPES)
def test_envelope_bytes_equal_jax(kind, seq, payload):
    env = transport.encode_envelope(kind, seq, payload)
    assert env == jtransport.encode_envelope(kind, seq, payload)
    assert transport.decode_envelope(env) == jtransport.decode_envelope(env) \
        == (kind, seq, payload)


def _malformed():
    env = transport.encode_envelope(transport._DATA, 7, b"payload")
    bad_crc = bytearray(env)
    bad_crc[-1] ^= 0xFF
    bad_kind = bytearray(env)
    bad_kind[0] = 0x7F
    return {"empty": b"", "truncated_header": env[:10], "truncated_payload": env[:-2],
            "extra_byte": env + b"\0", "bad_crc": bytes(bad_crc), "unknown_kind": bytes(bad_kind)}


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_decode_envelope_rejects_as_jax_does(case):
    env = _malformed()[case]
    with pytest.raises(TransportFrameError) as got:
        transport.decode_envelope(env)
    with pytest.raises(JaxTransportFrameError) as want:
        jtransport.decode_envelope(env)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, TransportError)


def test_retry_policy_defaults_equal_jax():
    assert dataclasses.asdict(RetryPolicy()) == dataclasses.asdict(jtransport.RetryPolicy())


def _samples(case):
    rng = random.Random(5)
    return {
        "fixed": [0.05] * 12,
        "jitter": [0.02 + 0.03 * rng.random() for _ in range(40)],
        "poisoned": [0.01, -3.0, 0.012, 100.0, 0.0, -1e-9, 0.011, 1e-6, 0.013],
        "ramp": [0.001 * (i + 1) for i in range(30)] + [0.5, 0.001],
    }[case]


@pytest.mark.parametrize("case", ["fixed", "jitter", "poisoned", "ramp"])
def test_rtt_estimator_trajectory_and_clamps_match_jax(case):
    got, want = RttEstimator(), jlatency.RttEstimator()
    bounds = [(0.01, 2.0, 0.1), (0.02, 0.5, None), (0.0, 10.0, 5.0), (0.2, 0.3, 0.01)]
    for floor, cap, default in bounds:
        assert got.rto(floor, cap, default_s=default) == want.rto(floor, cap, default_s=default)
    for s in _samples(case):
        got.observe(s)
        want.observe(s)
        assert got.snapshot() == want.snapshot()
        for floor, cap, default in bounds:
            assert got.rto(floor, cap, default_s=default) == \
                want.rto(floor, cap, default_s=default)


def test_current_rto_clamps_match_jax():
    pol, jpol = (RetryPolicy(ack_timeout_s=0.1, max_backoff_s=0.5, min_rto_s=0.02),
                 jtransport.RetryPolicy(ack_timeout_s=0.1, max_backoff_s=0.5, min_rto_s=0.02))
    for samples in ([], [100.0], [1e-6] * 32, [0.05, 0.07, 0.06]):
        r = ResilientTransport(queue_pair()[0], pol)
        jr = jtransport.ResilientTransport(jtransport.queue_pair()[0], jpol)
        for s in samples:
            r.rtt.observe(s)
            jr.rtt.observe(s)
        assert r.current_rto() == jr.current_rto()
        assert pol.min_rto_s <= r.current_rto() <= pol.max_backoff_s


# -- fault injection ----------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.sent = []

    def send(self, frame):
        self.sent.append(bytes(frame))

    def close(self):
        pass


PLANS = {
    "clean": dict(seed=1),
    "drop": dict(seed=3, drop=0.3),
    "duplicate": dict(seed=5, duplicate=0.3),
    "truncate": dict(seed=4, truncate=0.3),
    "delay": dict(seed=6, delay=0.3),
    "disconnect": dict(seed=8, disconnect=0.15, reconnect_after=3),
    "mixed": dict(seed=7, drop=0.1, truncate=0.1, duplicate=0.1, delay=0.1, disconnect=0.05),
    "all_faults": dict(seed=9, drop=0.2, duplicate=0.2, truncate=0.2, delay=0.2, disconnect=0.2),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_faulty_transport_decisions_match_jax(plan):
    rng = random.Random(17)
    frames = [bytes(rng.getrandbits(8) for _ in range(rng.choice([0, 1, 9, 100, 700])))
              for _ in range(120)]
    runs = []
    for mod, closed in ((faults, TransportClosedError), (jfaults, JaxTransportClosedError)):
        inner = _Recorder()
        ft = mod.FaultyTransport(inner, mod.FaultPlan(**PLANS[plan]), name="f")
        raised = []
        for f in frames:
            try:
                ft.send(f)
                raised.append(None)
            except closed as e:
                raised.append(str(e))
        runs.append((inner.sent, ft.injected, raised))
    assert runs[0] == runs[1]
    if plan != "clean":
        assert sum(runs[0][1].values()) > 0


def test_fault_plan_refuses_probabilities_above_one():
    with pytest.raises(ValueError, match="sum to"):
        faults.FaultyTransport(_Recorder(), faults.FaultPlan(drop=0.6, delay=0.6))


# -- the ARQ over queues --------------------------------------------------------------


def _pump_frames(ra, rb, n, payload=b"frame-%04d"):
    """Ship ``n`` frames a -> b, the receiver on a thread; the sender
    flushes (a windowed send only guarantees window admission)."""
    got, err = [], []

    def consume():
        try:
            for _ in range(n):
                got.append(rb.recv(timeout=10.0))
        except BaseException as e:  # re-raised below
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for i in range(n):
        ra.send(payload % i)
    ra.flush(timeout=30.0)
    t.join(timeout=JOIN_S)
    assert not t.is_alive(), "receiver hung"
    if err:
        raise err[0]
    return got


def test_queue_pair_roundtrip_and_close_as_jax():
    for pair, closed in ((queue_pair, TransportClosedError),
                         (jtransport.queue_pair, JaxTransportClosedError)):
        a, b = pair(default_timeout=1.0)
        a.send(b"hello")
        assert b.recv(timeout=1.0) == b"hello"
        b.close()
        for _ in range(2):
            with pytest.raises(closed):
                a.recv(timeout=1.0)
        with pytest.raises(closed):
            b.send(b"after close")
    a, _ = queue_pair()
    with pytest.raises(SyncTimeoutError):
        a.recv(timeout=0.01)


def test_callable_transport_relays_frames_as_jax():
    """A ``(send, recv)`` pair as a transport: frames pass through in
    order, ``recv``'s timeout is advisory and ``close`` is a no-op."""
    import queue

    for cls in (transport.CallableTransport, jtransport.CallableTransport):
        q = queue.Queue()
        t = cls(q.put, q.get)
        assert isinstance(t, transport.Transport if cls is transport.CallableTransport
                          else jtransport.Transport)
        with t:
            for frame in (b"", b"one", bytes(range(256)) * 40):
                t.send(frame)
            assert [t.recv(), t.recv(timeout=0.0), t.recv(timeout=1.0)] == \
                [b"", b"one", bytes(range(256)) * 40]
        t.close()
        t.send(b"after close")  # the callables own the channel
        assert t.recv() == b"after close"


def test_resilient_clean_channel_is_transparent():
    ta, tb = queue_pair(default_timeout=5.0)
    ra = ResilientTransport(ta, FAST, name="a", seed=1)
    rb = ResilientTransport(tb, FAST, name="b", seed=2)
    assert _pump_frames(ra, rb, 8) == [b"frame-%04d" % i for i in range(8)]
    assert ra.counts()["retransmits"] == 0 and rb.counts()["corrupt"] == 0
    assert ra.rtt.snapshot()["samples"] > 0


@pytest.mark.parametrize("plan", [
    dict(seed=3, drop=0.3), dict(seed=4, truncate=0.3), dict(seed=5, duplicate=0.3),
    dict(seed=6, delay=0.3), dict(seed=7, drop=0.1, truncate=0.1, duplicate=0.1, delay=0.1),
], ids=["drop", "truncate", "duplicate", "delay", "mixed"])
def test_resilient_delivers_exactly_once_under_faults(plan):
    ta, tb = queue_pair(default_timeout=5.0)
    fa = faults.FaultyTransport(ta, faults.FaultPlan(**plan), name="faulty-a")
    ra = ResilientTransport(fa, FAST, name="a", seed=11)
    rb = ResilientTransport(tb, FAST, name="b", seed=12)
    assert _pump_frames(ra, rb, 24) == [b"frame-%04d" % i for i in range(24)]
    assert sum(fa.injected.values()) > 0
    a, b = ra.counts(), rb.counts()
    assert (a["retransmits"] + b["duplicates"] + b["corrupt"] + a["transient_errors"]
            + b["ooo_buffered"]) > 0


class _DropSeq(transport.Transport):
    """Drops the DATA envelope of one seq, once."""

    def __init__(self, inner, seq):
        self._inner, self._seq, self.dropped = inner, seq, 0

    def send(self, frame):
        if self.dropped == 0 and len(frame) >= transport._ENV.size:
            kind, seq, _crc, _plen = transport._ENV.unpack_from(frame)
            if kind == transport._DATA and seq == self._seq:
                self.dropped += 1
                return
        self._inner.send(frame)

    def recv(self, timeout=None):
        return self._inner.recv(timeout)

    def close(self):
        self._inner.close()


def test_one_lost_frame_in_eight_costs_one_retransmit():
    ta, tb = queue_pair(default_timeout=5.0)
    drop = _DropSeq(ta, seq=2)
    ra = ResilientTransport(drop, dataclasses.replace(FAST, ack_timeout_s=0.3), name="a",
                            seed=31)
    rb = ResilientTransport(tb, FAST, name="b", seed=32)
    assert _pump_frames(ra, rb, 8) == [b"frame-%04d" % i for i in range(8)]
    assert drop.dropped == 1
    a, b = ra.counts(), rb.counts()
    assert a["retransmits"] == 1
    assert b["ooo_buffered"] >= 1 and b["sacks_sent"] >= 1 and a["frames_sacked"] >= 1
    assert a["window_hw"] >= 2
    ra.close()
    rb.close()


@pytest.mark.parametrize("configured,peer", [(16, 0), (16, 1), (16, 4), (16, 16), (16, 32),
                                             (1, 0), (4, 16)])
def test_negotiate_window_matches_jax(configured, peer):
    from crdt_tpu.obs import events as jevents

    r = ResilientTransport(queue_pair()[0], RetryPolicy(window=configured), name="n")
    jr = jtransport.ResilientTransport(jtransport.queue_pair()[0],
                                       jtransport.RetryPolicy(window=configured), name="n")
    events.recorder().clear()
    jevents.recorder().clear()
    assert r.negotiate_window(peer) == jr.negotiate_window(peer) == r.window == jr.window
    got = [e["fields"] for e in events.recorder().snapshot("cluster.transport.fallback")]
    want = [e["fields"] for e in jevents.recorder().snapshot("cluster.transport.fallback")]
    assert got == want
    assert r.counts()["window_fallbacks"] == len(got) == (r.window < configured)
    if peer == 0:
        assert r.window == 1


def test_deadline_and_budget_are_bounded():
    policy = RetryPolicy(send_deadline_s=0.3, recv_deadline_s=0.3, ack_timeout_s=0.02,
                         max_backoff_s=0.05, retry_budget=1000, window=1)
    ra = ResilientTransport(queue_pair(5.0)[0], policy, name="deadline", seed=13)
    t0 = time.monotonic()
    with pytest.raises(SyncTimeoutError):
        ra.send(b"into the void")
    assert time.monotonic() - t0 < 5.0 and ra.counts()["timeouts"] == 1
    tight = dataclasses.replace(policy, send_deadline_s=30.0, ack_timeout_s=0.01,
                                max_backoff_s=0.02, retry_budget=3)
    ra2 = ResilientTransport(queue_pair(5.0)[0], tight, name="budget", seed=14)
    with pytest.raises(PeerUnavailableError):
        ra2.send(b"into the void")
    assert ra2.retransmits <= 4
    ra3 = ResilientTransport(queue_pair(5.0)[0], dataclasses.replace(policy, window=8),
                             name="deadline-w8", seed=15)
    ra3.send(b"into the void")
    t0 = time.monotonic()
    with pytest.raises(SyncTimeoutError):
        ra3.flush()
    assert time.monotonic() - t0 < 5.0
    rr = ResilientTransport(queue_pair(5.0)[0], RetryPolicy(recv_deadline_s=0.2), name="r")
    with pytest.raises(SyncTimeoutError):
        rr.recv()


def test_close_drains_whole_window():
    ta, tb = queue_pair(default_timeout=5.0)
    fa = faults.FaultyTransport(ta, faults.FaultPlan(seed=41, drop=0.3), name="lossy")
    ra = ResilientTransport(fa, FAST, name="a", seed=42)
    rb = ResilientTransport(tb, FAST, name="b", seed=43)
    got, err = [], []

    def consume():
        try:
            for _ in range(6):
                got.append(rb.recv(timeout=10.0))
        except BaseException as e:  # re-raised below
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for i in range(6):
        ra.send(b"drain-%04d" % i)
    t0 = time.monotonic()
    ra.close()  # the delivery barrier: no flush
    elapsed = time.monotonic() - t0
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    if err:
        raise err[0]
    assert got == [b"drain-%04d" % i for i in range(6)]
    assert elapsed < 8.0


# -- TCP ------------------------------------------------------------------------------


def _socket_pair(buf=None):
    """A connected loopback pair; ``buf`` pins both socket buffers small,
    so a 10 MB frame cannot fit in them whatever the host's sysctls."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(5.0)
    c = socket.create_connection(srv.getsockname(), timeout=5.0)
    s, _ = srv.accept()
    srv.close()
    for x in (c, s):
        if buf:
            x.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, buf)
            x.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, buf)
    return c, s


def _both(fa, fb):
    """Run ``fa`` and ``fb`` on two threads; ``(results, errors)``."""
    res, err = {}, {}

    def run(key, fn):
        try:
            res[key] = fn()
        except BaseException as e:  # reported to the caller
            err[key] = e

    ts = [threading.Thread(target=run, args=kv, daemon=True) for kv in (("a", fa), ("b", fb))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ts), "a TCP peer hung"
    return res, err


def _frames():
    rng = random.Random(3)
    return [b"", b"x", bytes(rng.getrandbits(8) for _ in range(1000)),
            bytes(range(256)) * (3 << 12)]


def test_tcp_frames_are_the_jax_bytes():
    frames = _frames()
    c, s = _socket_pair()
    tx = TcpTransport(c, default_timeout=5.0)
    for f in frames:
        tx.send(f)
    tx.close()
    want = b"".join(struct.pack("<I", len(f)) + f for f in frames)
    raw = bytearray()
    s.settimeout(5.0)
    while len(raw) < len(want) + 1:
        chunk = s.recv(1 << 20)
        if not chunk:
            break
        raw += chunk
    s.close()
    assert bytes(raw) == want
    # and each package decodes the other's stream
    for send_cls, recv_cls in ((TcpTransport, jtransport.TcpTransport),
                               (jtransport.TcpTransport, TcpTransport)):
        c, s = _socket_pair()
        tx, rx = send_cls(c, default_timeout=5.0), recv_cls(s, default_timeout=5.0)
        res, err = _both(lambda: [tx.send(f) for f in frames],
                         lambda: [rx.recv(timeout=5.0) for _ in frames])
        assert not err and res["b"] == frames
        tx.close()
        rx.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_tcp_both_sides_send_10mb_before_reading(package):
    """The deadlock pin.  The port's send reads while it writes, so both
    peers finish and each decodes the other's frame; the JAX ``sendall``
    reads nothing, so with 2 s socket timeouts both sends raise (without
    them the pair hangs)."""
    c, s = _socket_pair(buf=1 << 18)
    fa, fb = bytes([1]) * BIG, bytes([2]) * BIG
    if package == "port":
        ta, tb = TcpTransport(c, default_timeout=15.0), TcpTransport(s, default_timeout=15.0)
        res, err = _both(lambda: (ta.send(fa), ta.recv(timeout=15.0))[1],
                         lambda: (tb.send(fb), tb.recv(timeout=15.0))[1])
        assert not err
        assert res["a"] == fb and res["b"] == fa
    else:
        c.settimeout(2.0)
        s.settimeout(2.0)
        ta, tb = jtransport.TcpTransport(c), jtransport.TcpTransport(s)
        res, err = _both(lambda: ta.send(fa), lambda: tb.send(fb))
        assert set(err) == {"a", "b"}
        assert all(isinstance(e, JaxTransportClosedError) for e in err.values())
    ta.close()
    tb.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_tcp_send_after_a_1ms_recv_timeout_keeps_the_frame_whole(package):
    """A recv with a 1 ms timeout, then a 10 MB send that the peer reads
    only 0.3 s later: the port's send has its own deadline and the peer
    decodes the whole frame; the JAX send runs under the recv's socket
    timeout, raises partway and leaves part of a frame on the stream."""
    c, s = _socket_pair(buf=1 << 18)
    frame = bytes(range(256)) * (BIG // 256)
    if package == "port":
        ta, tb = TcpTransport(c, default_timeout=15.0), TcpTransport(s, default_timeout=15.0)
        closed, timeout = TransportClosedError, SyncTimeoutError
    else:
        from crdt_tpu.error import SyncTimeoutError as JaxSyncTimeoutError

        ta, tb = jtransport.TcpTransport(c, 15.0), jtransport.TcpTransport(s, 15.0)
        closed, timeout = JaxTransportClosedError, JaxSyncTimeoutError
    with pytest.raises(timeout):
        ta.recv(timeout=0.001)

    def late_read():
        time.sleep(0.3)
        # the JAX peer waits for bytes that never come: keep its wait short
        return tb.recv(timeout=15.0 if package == "port" else 2.0)

    res, err = _both(lambda: ta.send(frame), late_read)
    if package == "port":
        assert not err and res["b"] == frame
    else:
        assert isinstance(err.get("a"), closed)
    ta.close()
    tb.close()


def test_tcp_frame_split_across_timeouts_stays_aligned():
    c, s = _socket_pair()
    rx = TcpTransport(s, default_timeout=5.0)
    f1, f2 = b"A" * 5000, b"second"
    wire = struct.pack("<I", len(f1)) + f1 + struct.pack("<I", len(f2)) + f2
    c.sendall(wire[:2])
    with pytest.raises(SyncTimeoutError):
        rx.recv(timeout=0.05)
    c.sendall(wire[2:3000])
    with pytest.raises(SyncTimeoutError):
        rx.recv(timeout=0.05)
    c.sendall(wire[3000:])
    assert rx.recv(timeout=5.0) == f1
    assert rx.recv(timeout=5.0) == f2
    c.close()
    with pytest.raises(TransportClosedError):
        rx.recv(timeout=5.0)
    rx.close()
    with pytest.raises(TransportClosedError):
        rx.send(b"after close")
    with pytest.raises(TransportClosedError):
        rx.recv(timeout=0.1)


def test_tcp_peer_closed_mid_frame_and_send_to_a_gone_peer_raise_closed():
    c, s = _socket_pair()
    rx = TcpTransport(s, default_timeout=5.0)
    c.sendall(struct.pack("<I", 100) + b"short")
    c.close()
    with pytest.raises(TransportClosedError, match="mid-frame"):
        rx.recv(timeout=5.0)
    with pytest.raises(TransportClosedError):
        for _ in range(64):  # the reset surfaces within a few writes
            rx.send(b"y" * (1 << 16))
    rx.close()


def test_resilient_over_tcp_delivers_10mb_frames_both_ways_under_faults():
    c, s = _socket_pair(buf=1 << 18)
    plan = dict(drop=0.1, duplicate=0.1, truncate=0.1, delay=0.1)
    ends = [ResilientTransport(faults.FaultyTransport(TcpTransport(x, 15.0),
                                                      faults.FaultPlan(seed=k, **plan)),
                               dataclasses.replace(FAST, send_deadline_s=15.0,
                                                   recv_deadline_s=15.0),
                               name=f"tcp-{k}", seed=k)
            for k, x in enumerate((c, s))]
    frames = [bytes([k]) * (BIG if k % 4 == 0 else 100 + k) for k in range(12)]
    done = [threading.Event(), threading.Event()]

    def side(k):
        r = ends[k]
        for f in frames:
            r.send(f)
        got = [r.recv() for _ in frames]
        r.flush()
        done[k].set()
        # keep answering until the peer's last frame is acked too: a side
        # that stops pumping strands a peer whose final ack was lost
        deadline = time.monotonic() + JOIN_S
        while not done[1 - k].is_set() and time.monotonic() < deadline:
            try:
                r.recv(timeout=0.05)
            except SyncTimeoutError:
                pass
        return got

    res, err = _both(lambda: side(0), lambda: side(1))
    assert not err, err
    assert res["a"] == frames and res["b"] == frames
    counts = [r.counts() for r in ends]
    assert sum(c["retransmits"] + c["duplicates"] + c["corrupt"] for c in counts) > 0
    _both(ends[0].close, ends[1].close)
