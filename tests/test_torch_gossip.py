"""Parity of the port's cluster node and gossip scheduler
(``crdt_tpu_torch.cluster.gossip``) with the JAX package's, on the CPU:

* ``write_clock``, ``write_vv``, the minted dots and the op frames of a
  port node and a JAX node holding the same state, while their ops queue
  behind a running session and after the drain, with parked ops;
* a port node and a JAX node converging over a queue link, with writes
  made mid-session riding the op piggyback both ways;
* the JAX scheduler tests' cases (staleness ranking, dead peers only on
  probe rounds, a busy endpoint skipped, the node's busy bound), run on
  both packages side by side;
* an armed ``CrashPlan`` at ``oplog.fold.<node>`` raising
  ``InjectedCrash`` from ``submit_ops`` in both;
* a mixed fleet (one JAX node, two port nodes) on schedulers over
  loopback TCP through each package's ``ResilientTransport``, flat and by
  the digest tree, clean and with faults: identical digest vectors.

The JAX nodes stay off ``crdt_tpu.native``; both packages' process tags
are pinned.  Every join, socket and receive has a timeout."""

import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.cluster import faults as jfaults
from crdt_tpu.cluster import gossip as jgossip
from crdt_tpu.cluster import membership as jmembership
from crdt_tpu.cluster import transport as jtransport
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import PeerUnavailableError as JaxPeerUnavailableError
from crdt_tpu.obs import convergence as jconvergence
from crdt_tpu.obs import events as jevents
from crdt_tpu.obs import metrics as jmetrics
from crdt_tpu.oplog import OpLog as JaxOpLog
from crdt_tpu.oplog.records import OpBatch as JaxOpBatch
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
from crdt_tpu_torch.cluster import faults, gossip, membership, transport
from crdt_tpu_torch.dtypes import counters_to_numpy
from crdt_tpu_torch.error import PeerUnavailableError
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.obs import convergence, events
from crdt_tpu_torch.oplog import OpBatch, OpLog
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets

torch.set_num_threads(1)
engine.set_threads(1)

N, A, M, D = 64, 8, 8, 4
KW = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32)
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
JU, PU = JaxUniverse.identity(JaxConfig(**KW)), Universe.identity(CrdtConfig(**KW))
PROC_TAG = "9055a1"
JOIN_S = 60.0
OP_FIELDS = ("kind", "obj", "actor", "counter", "member")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The JAX package off its native library, and one process tag for
    both packages."""
    import crdt_tpu.batch.wirebulk as jax_wirebulk
    import crdt_tpu.native.scalarize as jax_scalarize

    def refuse():
        raise RuntimeError("the JAX native library is not used by port tests")

    monkeypatch.setattr(jax_wirebulk, "probe_engine", lambda *a, **k: None)
    monkeypatch.setattr(jax_scalarize, "load", refuse)
    monkeypatch.setattr(jevents, "_PROC_TAG", PROC_TAG)
    monkeypatch.setattr(events, "_PROC_TAG", PROC_TAG)


# -- fleets and nodes ---------------------------------------------------------------------


def _base(seed):
    (planes,) = anti_entropy_fleets(np.random.RandomState(seed), N, A, M, D, 1, base=4,
                                    novel=0, deferred_frac=0.25)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    return jb.merge(jb)


def _add_on(jb, rows, actor, member):
    rows = np.asarray(rows, np.int64)
    sub = jax.tree_util.tree_map(lambda p: p[rows], jb)
    k = rows.shape[0]
    sub = sub.apply_add(np.full(k, actor, np.int32), jnp.max(sub.clock, axis=-1) + 1,
                        np.full(k, member, np.int32))
    return jax.tree_util.tree_map(lambda p, s: p.at[rows].set(s), jb, sub)


def _port_of(jb):
    return OrswotBatch.from_numpy(*(np.asarray(getattr(jb, f)) for f in PLANES), device="cpu")


def _pair(seed=3, **kw):
    jb = _base(seed)
    return (gossip.ClusterNode("n0", _port_of(jb), PU, oplog=OpLog(PU), **kw),
            jgossip.ClusterNode("n0", jb, JU, oplog=JaxOpLog(JU), **kw))


def _same_planes(port_batch, jax_batch):
    for got, f in zip(port_batch.to_numpy(), PLANES):
        np.testing.assert_array_equal(got, np.asarray(getattr(jax_batch, f)), err_msg=f)


def _same_ops(got, want):
    for f in OP_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def _same_write_views(port, jax):
    np.testing.assert_array_equal(counters_to_numpy(port.write_clock()).astype(np.uint64),
                                  np.asarray(jax.write_clock()))
    np.testing.assert_array_equal(port.write_vv(), np.asarray(jax.write_vv()))


# -- the write front-end -------------------------------------------------------------------


def test_write_clock_and_minted_ops_match_jax_mid_session():
    port, jax_node = _pair()
    rng = np.random.RandomState(5)
    _same_write_views(port, jax_node)
    for node in (port, jax_node):  # a session is running: writes queue
        assert node._busy.acquire(blocking=False)
    try:
        pending = 0
        for step in range(4):
            obj = rng.randint(0, N, 7).astype(np.int64)
            obj[:2] = obj[2]  # several writes to one object in one batch
            member = (100 + rng.randint(0, 5, 7)).astype(np.int32)
            got = port.submit_writes(obj, member, actor=1 + step % 2)
            assert got == jax_node.submit_writes(obj, member, actor=1 + step % 2)
            assert got > pending
            pending = got
            _same_write_views(port, jax_node)
        _same_ops(port._oplog.pending(), jax_node._oplog.pending())
        assert port._op_outbox() == jax_node._op_outbox()
        # an add whose predecessor dots never arrived: parked by the drain
        gap = dict(kind=np.zeros(1, np.uint8), obj=np.array([5], np.int64),
                   actor=np.array([6], np.int32), member=np.array([77], np.int32))
        wc = counters_to_numpy(port.write_clock()).astype(np.uint64)
        counter = np.array([wc[5, 6] + 3], np.uint64)
        assert port.submit_ops(OpBatch(counter=counter, **gap)) == \
            jax_node.submit_ops(JaxOpBatch(counter=counter, **gap))
    finally:
        port._busy.release()
        jax_node._busy.release()
    assert port.try_drain() and jax_node.try_drain()
    assert len(port._applier.parked) == len(jax_node._applier.parked) == 1
    _same_planes(port.batch, jax_node.batch)
    _same_write_views(port, jax_node)  # the parked dot is in the write view
    assert counters_to_numpy(port.write_clock())[5, 6] == counter[0]
    obj = np.array([5, 9], np.int64)
    port.submit_writes(obj, np.array([1, 2], np.int32), actor=6)
    jax_node.submit_writes(obj, np.array([1, 2], np.int32), actor=6)
    _same_planes(port.batch, jax_node.batch)
    _same_write_views(port, jax_node)


class _WritesOnFirstRecv:
    """A link that submits writes to the nodes the first time its owner
    reads: both nodes are mid-session then, so the writes queue and ride
    the op piggyback."""

    def __init__(self, inner, write):
        self.inner, self.write = inner, write

    def send(self, frame):
        self.inner.send(frame)

    def recv(self, timeout=None):
        if self.write is not None:
            write, self.write = self.write, None
            write()
        return self.inner.recv(timeout)

    def close(self):
        self.inner.close()


def test_port_and_jax_nodes_converge_with_mid_session_writes():
    jb = _base(7)
    ja, jbb = _add_on(jb, [1, 9, 30], 1, 1 << 20), _add_on(jb, [9, 40, 41], 2, 1 << 21)
    port = gossip.ClusterNode("p", _port_of(ja), PU, oplog=OpLog(PU))
    jax_node = jgossip.ClusterNode("j", jbb, JU, oplog=JaxOpLog(JU))
    ta, tb = transport.queue_pair(default_timeout=30.0)
    written = {}

    def write():
        obj = np.array([3, 3, 50], np.int64)
        written["p"] = port.submit_writes(obj, np.array([7, 8, 9], np.int32), actor=4)
        written["j"] = jax_node.submit_writes(np.array([50, 61], np.int64),
                                              np.array([10, 11], np.int32), actor=5)

    out, err = {}, []

    def run_jax():
        try:
            out["j"] = jax_node.accept(tb, peer_id="p")
        except BaseException as e:  # re-raised below
            err.append(e)

    t = threading.Thread(target=run_jax, daemon=True)
    t.start()
    out["p"] = port.sync_with("j", _WritesOnFirstRecv(ta, write))
    t.join(timeout=JOIN_S)
    assert not t.is_alive() and not err
    assert written == {"p": 3, "j": 2}  # queued behind the sessions
    assert out["p"].converged and out["j"].converged
    assert len(port._oplog) == len(jax_node._oplog) == 0
    np.testing.assert_array_equal(port.digest(), np.asarray(jax_node.digest()))
    _same_planes(port.batch, jax_node.batch)
    assert counters_to_numpy(port.batch.clock)[50, 5] > 0  # the JAX node's write, piggybacked


# -- the scheduler ---------------------------------------------------------------------------


def _schedulers(node_pair, build_membership, **kw):
    """The same roster, tracker history and arguments on both packages."""
    out = []
    for mod, mmod, cmod, node, refused in (
            (gossip, membership, convergence, node_pair[0], PeerUnavailableError),
            (jgossip, jmembership, jconvergence, node_pair[1], JaxPeerUnavailableError)):
        is_jax = mod is jgossip
        trk = cmod.ConvergenceTracker(registry=jmetrics.MetricsRegistry()) if is_jax \
            else cmod.ConvergenceTracker()
        mkw = dict(registry=jmetrics.MetricsRegistry()) if is_jax else dict(tracker=trk)
        m = build_membership(mmod, mkw, trk)

        def dial(peer, _refused=refused):
            raise _refused("dial should not happen")

        out.append(mod.GossipScheduler(node, m, dial, tracker=trk, **kw))
    return out


def test_rank_peers_staleness_first_as_jax():
    def roster(mmod, mkw, trk):
        m = mmod.Membership(suspect_after=2, dead_after=4, **mkw)
        for p in ("fresh", "stale", "never"):
            m.add(p)
        return m

    scheds = _schedulers(_pair(), roster)
    for s in scheds:
        s._tracker.observe_session("stale", converged=True, rounds=1)
    time.sleep(0.05)
    for s in scheds:
        s._tracker.observe_session("fresh", converged=True, rounds=1)
    got = [[p.peer_id for p in s.rank_peers(round_no=1)] for s in scheds]
    assert got[0] == got[1] == ["never", "stale", "fresh"]
    urgency = scheds[0]._tracker.urgency
    assert urgency("never") == (float("inf"),) * 3
    assert urgency("stale")[0] > urgency("fresh")[0] > 0
    assert sorted(scheds[0]._tracker.refresh()) == ["fresh", "stale"]


def test_rank_peers_dead_only_on_probe_rounds_as_jax():
    def roster(mmod, mkw, trk):
        m = mmod.Membership(suspect_after=1, dead_after=2, **mkw)
        m.add("ok")
        m.add("gone")
        m.record_failure("gone")
        m.record_failure("gone")
        assert m.get("gone").state == mmod.DEAD
        return m

    scheds = _schedulers(_pair(), roster, probe_dead_every=4)
    for round_no in (1, 2, 3, 4, 8):
        got = [sorted(p.peer_id for p in s.rank_peers(round_no=round_no)) for s in scheds]
        assert got[0] == got[1] == (["gone", "ok"] if round_no % 4 == 0 else ["ok"])


def test_round_skips_endpoint_with_session_in_flight_as_jax():
    def roster(mmod, mkw, trk):
        m = mmod.Membership(**mkw)
        m.add("busy-peer")
        return m

    scheds = _schedulers(_pair(), roster, session_timeout_s=5.0)
    reports = []
    for s in scheds:
        lock = s._endpoint_lock("busy-peer")
        assert lock.acquire(blocking=False)
        try:
            reports.append(s.run_round())
        finally:
            lock.release()
    mine, theirs = reports
    for f in ("round_no", "ranked", "ok", "failed", "skipped_busy"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.skipped_busy == ["busy-peer"] and mine.attempted == theirs.attempted == 0
    assert scheds[0].membership.get("busy-peer").sessions_failed == 0  # a skip is no failure
    assert scheds[0].counts() == {"rounds": 1, "sessions_ok": 0, "sessions_failed": 0,
                                  "sessions_skipped_busy": 1}
    assert mine.health == {"attempted": 0, "ok": 0, "failed": 0, "skipped_busy": 1,
                           "fleet_divergence_max": 0, "eta_rounds": 0}
    snap = scheds[0].node.lag_tracker.snapshot()
    assert snap["slo_window"] == 1 and snap["slo_converged_frac"] == 1.0
    with pytest.raises(ValueError):
        gossip.GossipScheduler(scheds[0].node, scheds[0].membership, None, fanout=0)


def test_cluster_node_busy_bound_as_jax():
    for node, (ta, _tb), refused in (
            (_pair()[0], transport.queue_pair(default_timeout=1.0), PeerUnavailableError),
            (_pair()[1], jtransport.queue_pair(default_timeout=1.0), JaxPeerUnavailableError)):
        node.busy_timeout_s = 0.05
        assert node._busy.acquire(blocking=False)
        try:
            with pytest.raises(refused, match="busy with another session"):
                node.accept(ta, peer_id="px")
        finally:
            node._busy.release()


@pytest.mark.parametrize("hit", [1, 2])
def test_crash_plan_at_the_op_fold_raises_as_jax(hit):
    raised = []
    for mod, node in ((faults, _pair()[0]), (jfaults, _pair()[1])):
        state = mod.arm_crashes(mod.CrashPlan({f"oplog.fold.{node.node_id}": hit}))
        try:
            for k in range(hit):
                obj, member = np.array([k], np.int64), np.array([5], np.int32)
                if k + 1 < hit:
                    assert node.submit_writes(obj, member, actor=1) == 0
                    continue
                with pytest.raises(mod.InjectedCrash, match="oplog.fold.n0"):
                    node.submit_writes(obj, member, actor=1)
            raised.append(state.fired)
            node.submit_writes(np.array([9], np.int64), np.array([6], np.int32), actor=1)
            assert state.fired == raised[-1]  # each point fires once
        finally:
            mod.disarm_crashes()
    assert raised[0] == raised[1] == ["oplog.fold.n0"]
    with pytest.raises(ValueError):
        faults.CrashPlan({"x": 0})
    faults.crash_point("oplog.fold")  # disarmed: no-op


# -- a mixed fleet over loopback TCP ---------------------------------------------------------

POLICY = dict(send_deadline_s=15.0, recv_deadline_s=15.0, ack_timeout_s=0.05,
              max_backoff_s=0.3, retry_budget=4000)
FAULTS = dict(drop=0.05, duplicate=0.05, truncate=0.05, delay=0.05)
MAX_ROUNDS = 8


class _Member:
    """One node of the mixed fleet: its package, its node, a listener on
    127.0.0.1:0 whose accepted links run the acceptor's leg through the
    package's own ``ResilientTransport(FaultyTransport(TcpTransport))``,
    and its scheduler."""

    def __init__(self, i, jax_side, batch, tree, plan):
        self.i, self.name, self.plan = i, f"n{i}", plan
        if jax_side:
            self.g, self.t, self.f, self.m = jgossip, jtransport, jfaults, jmembership
            self.node = jgossip.ClusterNode(self.name, batch, JU, oplog=JaxOpLog(JU),
                                            digest_tree=tree, busy_timeout_s=20.0)
        else:
            self.g, self.t, self.f, self.m = gossip, transport, faults, membership
            self.node = gossip.ClusterNode(self.name, _port_of(batch), PU, oplog=OpLog(PU),
                                           digest_tree=tree, busy_timeout_s=20.0)
        self.seeds = iter(range(1000 * (i + 1), 1000 * (i + 2)))
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.srv.settimeout(0.2)
        self.stop = threading.Event()
        self.inbound_failures, self.threads, self.faulty = [], [], []
        self.listener = threading.Thread(target=self._listen, daemon=True)
        self.listener.start()

    def link(self, sock):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s = next(self.seeds)
        faulty = self.f.FaultyTransport(self.t.TcpTransport(sock, 15.0),
                                        self.f.FaultPlan(seed=s, **self.plan), name=self.name)
        self.faulty.append(faulty)
        return self.t.ResilientTransport(faulty, self.t.RetryPolicy(window=16, **POLICY),
                                         name=self.name, seed=s + 500)

    def _listen(self):
        while not self.stop.is_set():
            try:
                sock, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(sock,), daemon=True)
            self.threads.append(t)
            t.start()

    def _serve(self, sock):
        link = self.link(sock)
        try:
            peer = self.g.hello_accept(link, timeout=15.0)
            self.node.accept(link, peer_id=peer)
        except Exception as e:  # noqa: BLE001 - the initiator's error drives the roster
            self.inbound_failures.append(f"{type(e).__name__}: {e}")
        finally:
            link.close()

    def scheduler(self, fleet):
        roster = self.m.Membership(suspect_after=3, dead_after=6)
        for other in fleet:
            if other is not self:
                roster.add(other.name, address=other.srv.getsockname())

        def dial(peer):
            try:
                sock = socket.create_connection(peer.address, timeout=5.0)
            except OSError as e:
                raise (JaxPeerUnavailableError if self.g is jgossip
                       else PeerUnavailableError)(str(e)) from e
            link = self.link(sock)
            self.g.hello_dial(link, self.name)
            return link

        self.sched = self.g.GossipScheduler(self.node, roster, dial, fanout=2,
                                            session_timeout_s=JOIN_S, seed=self.i)

    def close(self):
        self.stop.set()
        self.listener.join(timeout=JOIN_S)
        for t in self.threads:
            t.join(timeout=JOIN_S)
        self.srv.close()
        assert not self.listener.is_alive() and not any(t.is_alive() for t in self.threads)


def _digest(member):
    return np.asarray(member.node.digest(), np.uint64)


@pytest.mark.parametrize("plan", ["clean", "faults"])
@pytest.mark.parametrize("tree", [False, True], ids=["flat", "tree"])
def test_mixed_fleet_converges_over_tcp(tree, plan):
    base = _base(11)
    starts = [_add_on(base, rows, i + 1, (1 << 20) + i)
              for i, rows in enumerate(([1, 2, 40], [2, 17, 63], [5, 40, 41, 50]))]
    fleet = [_Member(i, i == 0, starts[i], tree, FAULTS if plan == "faults" else {})
             for i in range(3)]
    try:
        for m in fleet:
            m.scheduler(fleet)
        rng = np.random.RandomState(13)
        for m in fleet:  # writes before the first round, on every node
            m.node.submit_writes(rng.randint(0, N, 5).astype(np.int64),
                                 (300 + rng.randint(0, 3, 5)).astype(np.int32), actor=4 + m.i)
        rounds, failed = 0, []
        while rounds < MAX_ROUNDS:
            rounds += 1
            for m in fleet:
                rep = m.sched.run_round()
                failed += list(rep.failed.values())
            digests = [_digest(m) for m in fleet]
            if all(np.array_equal(d, digests[0]) for d in digests[1:]):
                break
        assert all(np.array_equal(d, digests[0]) for d in digests[1:]), \
            f"no convergence in {rounds} rounds (failed {failed})"
        if plan == "clean":
            assert not failed and rounds <= 2
            assert all(not m.inbound_failures for m in fleet)
        injected = sum(sum(f.injected.values()) for m in fleet for f in m.faulty)
        assert (injected > 0) == (plan == "faults")
        port_counts = fleet[1].sched.counts()
        assert port_counts["rounds"] == rounds and port_counts["sessions_ok"] >= 2
        # the converged fleet is the join of the three starting replicas and
        # the writes: a port node's planes equal the JAX node's after a
        # self-merge (slot order is the merge's, not a canonical one)
        jax_planes = fleet[0].node.batch
        _same_planes(fleet[1].node.batch.merge(fleet[1].node.batch),
                     jax_planes.merge(jax_planes))
    finally:
        for m in fleet:
            m.close()
