"""The port's cluster layer against the JAX package's, on the CPU:
``Membership`` over the same success and failure sequences (states,
``counts()``, ``snapshot()`` and the ``cluster.peer_state`` events),
``FlappingDialer`` over the same schedules, and the acceptance of the
transport slice: a JAX session and a port session converge over loopback
TCP, each through its own package's ``ResilientTransport(FaultyTransport(
TcpTransport))``, flat and by the digest tree, at windows 16/16 and 16/1,
with a clean plan and a mixed one.  Their digest vectors are equal, each
side's planes equal its own package's merge, and the payloads each side
is delivered equal those two JAX sessions deliver on the same fleets.
A port pair over a 20 ms one-way ``LatencyTransport`` samples the link's
round trip.

The JAX sessions stay off ``crdt_tpu.native`` (``probe_engine`` returns
None, the scalarize extension refuses to load); both packages' process
tags and each session's ID are pinned.  Every thread join, socket and
receive has a timeout."""

import dataclasses
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.cluster import faults as jfaults
from crdt_tpu.cluster import membership as jmembership
from crdt_tpu.cluster import transport as jtransport
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import PeerUnavailableError as JaxPeerUnavailableError
from crdt_tpu.error import SyncTimeoutError as JaxSyncTimeoutError
from crdt_tpu.error import TransportError as JaxTransportError
from crdt_tpu.obs import convergence as jconvergence
from crdt_tpu.obs import events as jevents
from crdt_tpu.obs import metrics as jmetrics
from crdt_tpu.sync import digest as jdigest
from crdt_tpu.sync import session as jsession
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
from crdt_tpu_torch.cluster import faults, membership, transport
from crdt_tpu_torch.error import PeerUnavailableError, SyncTimeoutError, TransportError
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.obs import convergence, events
from crdt_tpu_torch.sync import digest, session
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets

torch.set_num_threads(1)
engine.set_threads(1)

N, A, M, D = 64, 8, 8, 4
KW = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32)
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
PROC_TAG = "c1a57e"
JU, PU = JaxUniverse.identity(JaxConfig(**KW)), Universe.identity(CrdtConfig(**KW))
JOIN_S = 60.0


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The JAX package off its native library, and one process tag for
    both packages' hellos."""
    import crdt_tpu.batch.wirebulk as jax_wirebulk
    import crdt_tpu.native.scalarize as jax_scalarize

    def refuse():
        raise RuntimeError("the JAX native library is not used by port tests")

    monkeypatch.setattr(jax_wirebulk, "probe_engine", lambda *a, **k: None)
    monkeypatch.setattr(jax_scalarize, "load", refuse)
    monkeypatch.setattr(jevents, "_PROC_TAG", PROC_TAG)
    monkeypatch.setattr(events, "_PROC_TAG", PROC_TAG)


# -- membership and the dialer ---------------------------------------------------------


SEQUENCES = {
    "suspect_then_alive": (dict(suspect_after=2, dead_after=4),
                           ["+p", "-p", "-p", "-p", "ok p", "-p"]),
    "dead_and_probed_back": (dict(suspect_after=1, dead_after=3),
                             ["+p", "+q", "-p", "-p", "-p", "-p", "-q", "ok q", "ok p", "-p"]),
    "unknown_peer_and_remove": (dict(suspect_after=2, dead_after=2),
                                ["-x", "-x", "ok y", "+x addr", "x remove", "-x", "+z", "+z a2"]),
    "defaults": (dict(), ["+a", "+b", "+c"] + ["-a"] * 6 + ["-b"] * 2 + ["ok a", "-c"]),
}


def _apply(m, step):
    if step.startswith("+"):
        peer, *addr = step[1:].split()
        m.add(peer, address=addr[0] if addr else None)
    elif step.startswith("-"):
        m.record_failure(step[1:])
    elif step.startswith("ok "):
        m.record_success(step[3:])
    else:
        m.remove(step.split()[0])


def _roster(m):
    return [dataclasses.asdict(p) for p in m.peers()]


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_membership_transitions_match_jax(case):
    kw, steps = SEQUENCES[case]
    trk = convergence.ConvergenceTracker()
    jtrk = jconvergence.ConvergenceTracker(registry=jmetrics.MetricsRegistry())
    got = membership.Membership(tracker=trk, **kw)
    want = jmembership.Membership(registry=jmetrics.MetricsRegistry(), tracker=jtrk, **kw)
    events.recorder().clear()
    jevents.recorder().clear()
    for step in steps:
        _apply(got, step)
        _apply(want, step)
        assert _roster(got) == _roster(want), step
        assert got.counts() == want.counts()
        assert got.snapshot() == want.snapshot()
        for state in membership.STATES:
            assert [p.peer_id for p in got.peers(state)] == \
                [p.peer_id for p in want.peers(state)]
    assert membership.STATES == jmembership.STATES
    mine = [e["fields"] for e in events.recorder().snapshot("cluster.peer_state")]
    theirs = [e["fields"] for e in jevents.recorder().snapshot("cluster.peer_state")]
    assert mine == theirs and mine
    # a peer is registered with the tracker when add() creates it
    assert sorted(trk.snapshot()) == sorted(jtrk.snapshot())


def test_membership_refuses_bad_thresholds():
    for kw in (dict(suspect_after=0), dict(suspect_after=3, dead_after=2)):
        with pytest.raises(ValueError):
            membership.Membership(**kw)
        with pytest.raises(ValueError):
            jmembership.Membership(**kw)


@pytest.mark.parametrize("schedule", [(True,), (False, False, True), (True, False, False, True)])
def test_flapping_dialer_matches_jax(schedule):
    outcomes = []
    for mod, refused in ((faults, PeerUnavailableError), (jfaults, JaxPeerUnavailableError)):
        dialer = mod.FlappingDialer(lambda peer: f"link-{peer}", schedule)
        seen = []
        for k in range(10):
            try:
                seen.append(dialer(f"p{k}"))
            except refused as e:
                seen.append(str(e))
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    port = faults.FlappingDialer(lambda peer: peer, schedule)
    for k in range(10):
        try:
            port(k)
        except PeerUnavailableError:
            pass
    assert port.refused == sum(not schedule[k % len(schedule)] for k in range(10))
    with pytest.raises(ValueError):
        faults.FlappingDialer(lambda peer: peer, ())


# -- fleets ------------------------------------------------------------------------------


def _add_on(jb, rows, actor, member):
    rows = np.asarray(rows, np.int64)
    sub = jax.tree_util.tree_map(lambda p: p[rows], jb)
    k = rows.shape[0]
    sub = sub.apply_add(np.full(k, actor, np.int32), jnp.max(sub.clock, axis=-1) + 1,
                        np.full(k, member, np.int32))
    return jax.tree_util.tree_map(lambda p, s: p.at[rows].set(s), jb, sub)


def _replicas(seed, rows_a, rows_b):
    (planes,) = anti_entropy_fleets(np.random.RandomState(seed), N, A, M, D, 1, base=4,
                                    novel=0, deferred_frac=0.25)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    base = jb.merge(jb)
    return _add_on(base, rows_a, 1, 1 << 20), _add_on(base, rows_b, 0, 1 << 21)


def _port_of(jb):
    cols = tuple(np.asarray(getattr(jb, f.name)) for f in dataclasses.fields(jb))
    return OrswotBatch.from_numpy(*cols, device="cpu")


def _same_planes(port_batch, jax_batch):
    for got, want in zip(port_batch.to_numpy(), (np.asarray(getattr(jax_batch, f))
                                                 for f in PLANES)):
        np.testing.assert_array_equal(got, want)


# -- sessions over links ------------------------------------------------------------------


def _tcp_pair():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(5.0)
    c = socket.create_connection(srv.getsockname(), timeout=5.0)
    s, _ = srv.accept()
    srv.close()
    return c, s


def _recording(r):
    """Record the payloads ``r.recv`` delivers (the session reads the
    bound method off the instance)."""
    got, recv = [], r.recv

    def f(timeout=None):
        frame = recv(timeout)
        got.append(frame)
        return frame

    r.recv = f
    return got


class _PortErrors:
    """A JAX link whose ``recv`` raises the port's transport errors, so
    that ``transport.linger`` serves it as it serves a port link."""

    def __init__(self, link):
        self.link = link

    def recv(self, timeout=None):
        try:
            return self.link.recv(timeout)
        except JaxSyncTimeoutError as e:
            raise SyncTimeoutError(str(e)) from e
        except JaxTransportError as e:
            raise TransportError(str(e)) from e


def _linger(r, until):
    link = _PortErrors(r) if isinstance(r, jtransport.Transport) else r
    transport.linger(link, until, JOIN_S)


def _sessions_over(sa, sb, ra, rb):
    """Run ``sa`` over ``ra`` here and ``sb`` over ``rb`` on a thread,
    then close both links; ``(report_a, report_b)``."""
    out, err = {}, []
    a_done = threading.Event()

    def run_b():
        try:
            out["b"] = sb.sync(rb)
            _linger(rb, a_done.is_set)
        except BaseException as e:  # re-raised below
            err.append(e)

    t = threading.Thread(target=run_b, daemon=True)
    t.start()
    try:
        out["a"] = sa.sync(ra)
    finally:
        a_done.set()
        _linger(ra, lambda: not t.is_alive())
        t.join(timeout=JOIN_S)
        ra.close()
        rb.close()
    assert not t.is_alive(), "peer session hung"
    if err:
        raise err[0]
    return out["a"], out["b"]


POLICY = dict(send_deadline_s=15.0, recv_deadline_s=15.0, ack_timeout_s=0.05,
              max_backoff_s=0.3, retry_budget=4000)
MIXED = dict(drop=0.1, duplicate=0.1, truncate=0.1, delay=0.1)


@pytest.mark.parametrize("plan", ["clean", "mixed"])
@pytest.mark.parametrize("windows", [(16, 16), (16, 1)], ids=["w16-16", "w16-1"])
@pytest.mark.parametrize("tree", [False, True], ids=["flat", "tree"])
def test_port_and_jax_sessions_converge_over_tcp(tree, windows, plan, monkeypatch):
    monkeypatch.setattr(jsession, "DELTA_CHUNK_ROWS", 4)
    monkeypatch.setattr(session, "DELTA_CHUNK_ROWS", 4)
    ja, jb = _replicas(23, [1, 5, 9, 17, 40, 41, 63], [5, 30, 31, 50])
    tag = f"tcp-{tree}-{windows[1]}-{plan}"
    faults_kw = MIXED if plan == "mixed" else {}
    kw = dict(digest_tree=tree)

    # the port session (side a) against a JAX session (side b), each over
    # its own package's stack on one loopback connection
    c, s = _tcp_pair()
    fa = faults.FaultyTransport(transport.TcpTransport(c, 15.0),
                                faults.FaultPlan(seed=5, **faults_kw), name="port")
    fb = jfaults.FaultyTransport(jtransport.TcpTransport(s, 15.0),
                                 jfaults.FaultPlan(seed=6, **faults_kw), name="jax")
    ra = transport.ResilientTransport(fa, transport.RetryPolicy(window=windows[0], **POLICY),
                                      name="port", seed=7)
    rb = jtransport.ResilientTransport(fb, jtransport.RetryPolicy(window=windows[1], **POLICY),
                                       name="jax", seed=8)
    got = {"a": _recording(ra), "b": _recording(rb)}
    port_a = session.SyncSession(_port_of(ja), PU, peer="jax", **kw)
    jax_b = jsession.SyncSession(jb, JU, peer="port", **kw)
    # the same two fleets between two JAX sessions over JAX queue links
    qa, qb = jtransport.queue_pair(default_timeout=15.0)
    wa = jtransport.ResilientTransport(qa, jtransport.RetryPolicy(window=windows[0], **POLICY),
                                       name="ref-a", seed=9)
    wb = jtransport.ResilientTransport(qb, jtransport.RetryPolicy(window=windows[1], **POLICY),
                                       name="ref-b", seed=10)
    want = {"a": _recording(wa), "b": _recording(wb)}
    ref_a = jsession.SyncSession(ja, JU, peer="jax", **kw)
    ref_b = jsession.SyncSession(jb, JU, peer="port", **kw)
    for x in (port_a, ref_a):
        x.session_id = f"sync-{tag}-a"
    for x in (jax_b, ref_b):
        x.session_id = f"sync-{tag}-b"

    rep_a, rep_b = _sessions_over(port_a, jax_b, ra, rb)
    want_a, want_b = _sessions_over(ref_a, ref_b, wa, wb)
    assert rep_a.converged and rep_b.converged and rep_a.diverged == 10
    assert rep_a.tree_mode == rep_b.tree_mode == tree
    assert got == want
    assert (rep_a.window, rep_b.window) == (want_a.window, want_b.window) == (min(windows),) * 2
    assert rep_a.streaming == rep_b.streaming == (min(windows) > 1)
    assert rep_a.delta_bytes_sent == want_a.delta_bytes_sent
    assert rep_a.delta_chunks_sent == (3 if rep_a.streaming else 0)  # 10 rows, chunks of 4
    if windows[1] < windows[0]:
        assert ra.counts()["window_fallbacks"] == 1
    np.testing.assert_array_equal(digest.digest_of(port_a.batch, PU),
                                  np.asarray(jdigest.digest_of(jax_b.batch, JU)))
    a0, b0 = _port_of(ja), _port_of(jb)
    mine = a0.merge(b0)
    for f in PLANES:
        assert torch.equal(getattr(port_a.batch, f), getattr(mine, f)), f
    _same_planes(_port_of(jax_b.batch), jb.merge(ja))
    if plan == "mixed":
        assert sum(fa.injected.values()) > 0 and sum(fb.injected.values()) > 0
        recovered = ra.counts()
        assert recovered["retransmits"] + recovered["duplicates"] + recovered["corrupt"] \
            + rb.retransmits + rb.duplicates + rb.corrupt > 0
    else:
        assert sum(fa.injected.values()) == sum(fb.injected.values()) == 0


def test_port_pair_over_a_latency_link_samples_the_round_trip():
    ja, jb = _replicas(29, [3, 4, 50], [4, 60])
    one_way = 0.02
    la, lb = faults.latency_pair(one_way, seed=3, default_timeout=15.0)
    policy = transport.RetryPolicy(send_deadline_s=15.0, recv_deadline_s=15.0,
                                   ack_timeout_s=0.25, max_backoff_s=0.5, retry_budget=2000)
    ra = transport.ResilientTransport(la, policy, name="wan-a", seed=1)
    rb = transport.ResilientTransport(lb, policy, name="wan-b", seed=2)
    sa = session.SyncSession(_port_of(ja), PU, peer="b")
    sb = session.SyncSession(_port_of(jb), PU, peer="a")
    rep_a, rep_b = _sessions_over(sa, sb, ra, rb)
    assert rep_a.converged and rep_b.converged and rep_a.diverged == 4
    assert rep_a.streaming and rep_a.window == 16
    for r, link in ((ra, la), (rb, lb)):
        snap = r.rtt.snapshot()
        assert snap["samples"] > 0 and link.injected > 0
        assert snap["srtt_s"] >= 2 * one_way * 0.9
        assert policy.min_rto_s <= r.current_rto() <= policy.max_backoff_s
    for f in PLANES:
        assert torch.equal(getattr(sa.batch, f), getattr(sb.batch, f)), f
