"""Parity of the port's fleet observatory (``crdt_tpu_torch.obs.fleet``)
with the JAX package's, on the CPU:

* snapshot frames byte-equal to the JAX encoder's for the same slices,
  each package decoding the other's;
* the five frame mutations of the JAX fleet tests, a length mismatch and
  a payload that is not JSON, each rejected with the same reason in both
  packages and none of them touching an observatory's merged state;
* the merge, commutative, associative and idempotent, equal to the JAX
  merge (a Hypothesis property), and every fleet read, ``to_json``,
  ``stitch_trace`` and ``fleet_prometheus_text`` equal on one snapshot;
* a mixed fleet (one JAX node, two port nodes, each with an observatory)
  gossiping over loopback TCP: every observatory ends holding the three
  slices, and the JAX node's slice, decoded by the port, re-encodes to
  the same bytes.

The JAX node stays off ``crdt_tpu.native``; every join and socket has a
deadline."""

import json
import socket
import struct
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.cluster import gossip as jgossip
from crdt_tpu.cluster import membership as jmembership
from crdt_tpu.cluster import transport as jtransport
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import PeerUnavailableError as JaxPeerUnavailableError
from crdt_tpu.error import SyncProtocolError as JaxSyncProtocolError
from crdt_tpu.obs import events as jevents
from crdt_tpu.obs import fleet as jfleet
from crdt_tpu.oplog import OpLog as JaxOpLog
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe
from crdt_tpu_torch.cluster import gossip, membership, transport
from crdt_tpu_torch.error import PeerUnavailableError, SyncProtocolError
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.obs import events
from crdt_tpu_torch.obs import fleet as pfleet
from crdt_tpu_torch.obs.metrics import MetricsRegistry
from crdt_tpu_torch.oplog import OpLog
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets

torch.set_num_threads(1)
engine.set_threads(1)

N, A, M, D = 64, 8, 8, 4
KW = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32)
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
JU, PU = JaxUniverse.identity(JaxConfig(**KW)), Universe.identity(CrdtConfig(**KW))
PROC_TAG = "9055a2"
JOIN_S = 60.0


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The JAX package off its native library, one process tag for both."""
    import crdt_tpu.batch.wirebulk as jax_wirebulk
    import crdt_tpu.native.scalarize as jax_scalarize

    def refuse():
        raise RuntimeError("the JAX native library is not used by port tests")

    monkeypatch.setattr(jax_wirebulk, "probe_engine", lambda *a, **k: None)
    monkeypatch.setattr(jax_scalarize, "load", refuse)
    monkeypatch.setattr(jevents, "_PROC_TAG", PROC_TAG)
    monkeypatch.setattr(events, "_PROC_TAG", PROC_TAG)


# -- snapshots ------------------------------------------------------------------------------

NODES = ["n0", "n1", "n2", "n3"]
COUNTERS = ["sync.sessions", "cluster.rounds", "heat.subtree.0.reads", "heat.subtree.3.writes"]
GAUGES = ["sync.peer.a.divergence", "capacity.orswot.bytes", "capacity.orswot.eta_s",
          "stability.frontier.max_counter", "stability.frontier.subtree.1.max_counter",
          "sync.peer.n1.lag_p99_s", "sync.peer.n2.lag_current_s", "heat.hot.0.obj",
          "heat.hot.0.count", "heat.hot.1.obj", "heat.hot.1.count"]
HISTS = ["cluster.round", "serve.latency.ryw"]


def _slice(draw_int, draw_float, node):
    """A structurally valid slice from seeded draws.  An event is a
    function of its node and ``seq`` (a recorder's seq names one event)."""
    ts, seq = float(draw_int(0, 50)), draw_int(1, 50)
    pick = lambda names: [n for n in names if draw_int(0, 2)]  # noqa: E731
    return {
        "ts": ts, "seq": seq,
        "counters": {n: draw_int(0, 1000) for n in pick(COUNTERS)},
        "gauges": {n: [float(draw_int(0, 50)), draw_int(1, 50), draw_float()]
                   for n in pick(GAUGES)},
        "histograms": {n: [float(draw_int(0, 50)), draw_int(1, 50), {
            "count": draw_int(1, 20), "sum": draw_float(), "min": 0.5, "max": 8.0,
            "buckets": {str(e): draw_int(1, 9) for e in (-1075, 0, 2) if draw_int(0, 1)}}]
            for n in pick(HISTS)},
        "convergence": [ts, seq, {"peer": {"divergence": draw_int(0, 9)}}],
        "events_dropped": draw_int(0, 9),
        "events": [{"seq": s, "wall_ts": float(s) + 0.5 * NODES.index(node),
                    "kind": "sync.phase", "session": f"s{s % 3}",
                    "fields": {"trace": f"t{s % 2}"}}
                   for s in sorted({draw_int(0, 200) for _ in range(draw_int(0, 5))})],
    }


def _random_slices(rng):
    ints = lambda lo, hi: int(rng.randint(lo, hi + 1))  # noqa: E731
    floats = lambda: float(rng.choice([0.0, 1.5, -1.0, 7.25, 100.0, 3.0]))  # noqa: E731
    nodes = rng.choice(NODES, size=ints(1, 3), replace=False)
    return {str(n): _slice(ints, floats, str(n)) for n in nodes}


@st.composite
def slices(draw):
    ints = lambda lo, hi: draw(st.integers(lo, hi))  # noqa: E731
    floats = lambda: draw(st.sampled_from([0.0, 1.5, -1.0, 7.25, 100.0, 3.0]))  # noqa: E731
    nodes = draw(st.lists(st.sampled_from(NODES), min_size=1, max_size=3, unique=True))
    return {n: _slice(ints, floats, n) for n in nodes}


def _canon(snap):
    return json.dumps(snap.slices, sort_keys=True)


@settings(max_examples=60, deadline=None, database=None)
@given(slices(), slices(), slices())
def test_merge_is_aci_and_equals_the_jax_merge(a, b, c):
    pa, pb, pc = (pfleet.FleetSnapshot(json.loads(json.dumps(x))) for x in (a, b, c))
    ja, jb, jc = (jfleet.FleetSnapshot(json.loads(json.dumps(x))) for x in (a, b, c))
    ab = pa.merge(pb)
    assert ab == pb.merge(pa)
    assert ab.merge(pc) == pa.merge(pb.merge(pc))
    assert pa.merge(pa) == pa and ab.merge(pa) == ab
    assert _canon(ab.merge(pc)) == _canon(ja.merge(jb).merge(jc))


def test_every_fleet_read_equals_jax():
    rng = np.random.RandomState(5)
    for _ in range(40):
        raw = [_random_slices(rng) for _ in range(3)]
        p = pfleet.FleetSnapshot(json.loads(json.dumps(raw[0])))
        j = jfleet.FleetSnapshot(json.loads(json.dumps(raw[0])))
        for x in raw[1:]:
            p, j = p.merge(pfleet.FleetSnapshot(x)), j.merge(jfleet.FleetSnapshot(x))
        assert p.nodes() == j.nodes()
        for read in ("fleet_counters", "fleet_gauges", "fleet_histograms", "fleet_capacity",
                     "fleet_stability", "fleet_heat", "fleet_lag", "events", "to_json"):
            assert getattr(p, read)() == getattr(j, read)(), read
        assert p.counters_by_node("sync.sessions") == j.counters_by_node("sync.sessions")
        assert p.events("n1") == j.events("n1")
        for trace in ("t0", "t1", "s2", "none"):
            assert pfleet.stitch_trace(p, trace) == jfleet.stitch_trace(j, trace)
            assert pfleet.stitch_trace(p.events(), trace) == jfleet.stitch_trace(j, trace)
        assert pfleet.fleet_prometheus_text(p) == jfleet.fleet_prometheus_text(j)
        assert pfleet.encode_snapshot(p) == jfleet.encode_snapshot(j)


# -- frames -----------------------------------------------------------------------------------


def _captured_pair():
    """One registry's contents captured by both packages into slices with
    equal stamps (the stamps are then overwritten to match)."""
    from crdt_tpu.obs import metrics as jmetrics

    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter_inc("sync.sessions", 3)
        reg.gauge_set("cluster.peers.alive", 2.0)
        reg.observe("cluster.round", 0.25)
        reg.observe("cluster.round", 3.0)
    recs = (events.FlightRecorder(capacity=8), jevents.FlightRecorder(capacity=8))
    for rec in recs:
        rec.record("sync.phase", session="s1", phase="digest", trace="t")
    from crdt_tpu.obs import convergence as jconv
    from crdt_tpu_torch.obs import convergence as pconv

    p = pfleet.capture_slice("node-a", registry=regs[0], tracker=pconv.ConvergenceTracker(),
                             recorder=recs[0])
    j = jfleet.capture_slice("node-a", registry=regs[1],
                             tracker=jconv.ConvergenceTracker(registry=regs[1]),
                             recorder=recs[1])
    # the same instant for both: stamps and the recorder's clocks
    sl_p, sl_j = p.slices["node-a"], j.slices["node-a"]
    stamp = (sl_j["ts"], sl_j["seq"])
    sl_p["ts"], sl_p["seq"] = stamp
    for kind in ("gauges", "histograms"):
        for entry in sl_p[kind].values():
            entry[0], entry[1] = stamp
    sl_p["convergence"][:2] = list(stamp)
    for ep, ej in zip(sl_p["events"], sl_j["events"]):
        ep["mono_ts"], ep["wall_ts"] = ej["mono_ts"], ej["wall_ts"]
    return p, j


def test_captured_frames_are_byte_equal_and_cross_decode():
    p, j = _captured_pair()
    frame = pfleet.encode_snapshot(p)
    assert frame == jfleet.encode_snapshot(j)
    assert pfleet.decode_snapshot(jfleet.encode_snapshot(j)) == p
    assert jfleet.decode_snapshot(frame) == j
    assert frame[:2] == bytes([pfleet.FLEET_PROTOCOL_VERSION, pfleet.FRAME_FLEET_SNAPSHOT])


def _mutated(frame, how):
    frame = bytearray(frame)
    if how == "truncate":
        return bytes(frame[:7])
    if how == "version":
        frame[0] ^= 0x01
    elif how == "type":
        frame[1] = 0x7F
    elif how == "crc":
        frame[-1] ^= 0x40
    elif how == "length":
        return bytes(frame + b" ")
    else:
        payload = b"[1, 2, 3]" if how == "payload" else b"{not json"
        return struct.pack("<BBIQ", 1, 0x21, zlib.crc32(payload), len(payload)) + payload
    return bytes(frame)


@pytest.mark.parametrize("how,reason", [
    ("truncate", "truncated"), ("version", "version_mismatch"), ("type", "unknown_type"),
    ("crc", "crc_mismatch"), ("payload", "malformed_payload"),
    ("length", "length_mismatch"), ("notjson", "malformed_payload")])
def test_rejections_carry_the_jax_reason_and_leave_the_observatory(how, reason):
    p, _ = _captured_pair()
    bad = _mutated(pfleet.encode_snapshot(p), how)
    obs = pfleet.FleetObservatory("me", registry=MetricsRegistry(),
                                  recorder=events.FlightRecorder(capacity=8))
    obs.merge(p)
    before = pfleet.encode_snapshot(obs.merged(refresh=False))
    with pytest.raises(SyncProtocolError) as mine:
        obs.merge_frame(bad)
    assert pfleet.encode_snapshot(obs.merged(refresh=False)) == before
    assert obs.counts()["rejected"] == {reason: 1} and obs.counts()["decoded"] == 0
    assert mine.value.reason == reason
    assert events.recorder().snapshot(kind="obs.fleet.frame_rejected")[-1]["fields"]["reason"] \
        == reason
    with pytest.raises(JaxSyncProtocolError) as theirs:
        jfleet.decode_snapshot(bad)
    assert str(theirs.value) == str(mine.value)
    assert jevents.recorder().snapshot(kind="obs.fleet.frame_rejected")[-1]["fields"] \
        == events.recorder().snapshot(kind="obs.fleet.frame_rejected")[-1]["fields"]


def test_observatory_counts_merges_and_frames():
    p, _ = _captured_pair()
    reg = MetricsRegistry()
    reg.counter_inc("cluster.rounds", 2)
    obs = pfleet.FleetObservatory("me", registry=reg, recorder=events.FlightRecorder(capacity=8))
    frame = obs.encode()
    merged = obs.merge_frame(pfleet.encode_snapshot(p))
    assert merged.nodes() == ["me", "node-a"] and merged.fleet_counters()["cluster.rounds"] == 2
    obs.merge_frame(pfleet.encode_snapshot(p))  # idempotent re-delivery
    c = obs.counts()
    assert (c["merges"], c["nodes"], c["decoded"], c["encodes"]) == (2, 2, 2, 1)
    assert c["snapshot_bytes"].count == 1 and c["snapshot_bytes"].max == len(frame)
    assert obs.merged().nodes() == ["me", "node-a"]


# -- a mixed fleet over loopback TCP -----------------------------------------------------------

POLICY = dict(send_deadline_s=15.0, recv_deadline_s=15.0, ack_timeout_s=0.05,
              max_backoff_s=0.3, retry_budget=4000)


def _base(seed):
    (planes,) = anti_entropy_fleets(np.random.RandomState(seed), N, A, M, D, 1, base=4,
                                    novel=0, deferred_frac=0.25)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    return jb.merge(jb)


def _add_on(jb, rows, actor, member):
    rows = np.asarray(rows, np.int64)
    sub = jax.tree_util.tree_map(lambda p: p[rows], jb)
    sub = sub.apply_add(np.full(rows.shape[0], actor, np.int32),
                        jnp.max(sub.clock, axis=-1) + 1,
                        np.full(rows.shape[0], member, np.int32))
    return jax.tree_util.tree_map(lambda p, s: p.at[rows].set(s), jb, sub)


class _Member:
    """One node: its package, node and observatory, a listener on
    127.0.0.1:0 answering the acceptor's leg, and its scheduler."""

    def __init__(self, i, jax_side, batch):
        self.i, self.name, self.jax_side = i, f"n{i}", jax_side
        if jax_side:
            self.g, self.t, self.m = jgossip, jtransport, jmembership
            self.obs = jfleet.FleetObservatory(self.name)
            self.node = jgossip.ClusterNode(self.name, batch, JU, oplog=JaxOpLog(JU),
                                            busy_timeout_s=20.0, observatory=self.obs)
        else:
            self.g, self.t, self.m = gossip, transport, membership
            reg = MetricsRegistry()
            self.obs = pfleet.FleetObservatory(self.name, registry=reg)
            port_batch = OrswotBatch.from_numpy(*(np.asarray(getattr(batch, f)) for f in PLANES),
                                                device="cpu")
            self.node = gossip.ClusterNode(self.name, port_batch, PU, oplog=OpLog(PU),
                                           busy_timeout_s=20.0, observatory=self.obs,
                                           registry=reg)
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.srv.settimeout(0.2)
        self.stop = threading.Event()
        self.threads = []
        self.listener = threading.Thread(target=self._listen, daemon=True)
        self.listener.start()

    def link(self, sock):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self.t.ResilientTransport(self.t.TcpTransport(sock, 15.0),
                                         self.t.RetryPolicy(window=16, **POLICY),
                                         name=self.name, seed=self.i)

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
            self.node.accept(link, peer_id=self.g.hello_accept(link, timeout=15.0))
        except Exception:  # noqa: BLE001 - the initiator's error drives its roster
            pass
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
                raise (JaxPeerUnavailableError if self.jax_side
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


def test_mixed_fleet_observatories_hold_every_slice():
    base = _base(11)
    starts = [_add_on(base, rows, i + 1, (1 << 20) + i)
              for i, rows in enumerate(([1, 2, 40], [2, 17, 63], [5, 40, 41, 50]))]
    fleet = [_Member(i, i == 0, starts[i]) for i in range(3)]
    try:
        for m in fleet:
            m.scheduler(fleet)
        for _ in range(3):
            for m in fleet:
                assert not m.sched.run_round().failed
        digests = [np.asarray(m.node.digest(), np.uint64) for m in fleet]
        assert all(np.array_equal(d, digests[0]) for d in digests[1:])
        for m in fleet:
            assert m.obs.merged(refresh=False).nodes() == ["n0", "n1", "n2"], m.name
        port = fleet[1].obs.merged(refresh=False)
        jax_slice = pfleet.FleetSnapshot({"n0": port.slices["n0"]})
        frame = pfleet.encode_snapshot(jax_slice)
        assert pfleet.encode_snapshot(pfleet.decode_snapshot(frame)) == frame
        assert jfleet.encode_snapshot(jfleet.decode_snapshot(frame)) == frame
        # the port nodes' own slices carry their schedulers' counts
        for m in fleet[1:]:
            mine = fleet[1].obs.merged().slices[m.name]["counters"] if m is fleet[1] \
                else port.slices[m.name]["counters"]
            assert mine["cluster.rounds"] >= 2 and mine["cluster.sessions.ok"] >= 2
        assert fleet[1].obs.counts()["decoded"] >= 2
        from crdt_tpu.obs import namespace

        for name in ("n1", "n2"):
            sl = port.slices[name]
            for kind, table in (("counter", sl["counters"]), ("gauge", sl["gauges"]),
                                ("histogram", sl["histograms"])):
                for metric in table:
                    assert namespace.match(metric, kind) is not None, (name, metric, kind)
            assert "cluster.round" in sl["histograms"] and "cluster.gossip.ok" in sl["gauges"]
    finally:
        for m in fleet:
            m.close()
