"""Parity of the port's sync session (``crdt_tpu_torch.sync.session``)
with the JAX package's, on the CPU, exact: in every mode (flat,
idempotent, tree lock-step, tree converged, dense cutover, threshold,
requested full state, digest collision, counter and LWW fleets,
streaming over a windowed stub, version-pinned) two port sessions send
the frames two JAX sessions send, byte for byte, report the same fields
and converge to the same planes; a port session and a JAX session
converge against each other; the hello, fleet, ops and lag frames match
the JAX encoders and decode each other; the piggybacks, the observers
and the errors match.  Session IDs and the process tag the hello
carries are pinned on both sides.

The JAX sessions never reach ``crdt_tpu.native``: ``probe_engine``
returns None and the scalarize extension refuses to load, so the JAX
codec, applier and egress take their pure-Python and jnp routes."""

import dataclasses
import struct
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import SyncProtocolError as JaxSyncProtocolError
from crdt_tpu.obs import convergence as jax_convergence
from crdt_tpu.obs import events as jax_events
from crdt_tpu.obs import latency as jax_latency
from crdt_tpu.obs import metrics as jax_metrics
from crdt_tpu.obs import stability as jax_stability
from crdt_tpu.oplog import records as jax_records
from crdt_tpu.oplog import wire as jax_opwire
from crdt_tpu.sync import delta as jdelta
from crdt_tpu.sync import digest as jdigest
from crdt_tpu.sync import session as jsession
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CrdtConfig, GCounterBatch, HeatTracker, LWWRegBatch, OrswotBatch, PNCounterBatch,
    SyncProtocolError, Universe, _build,
)
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.obs import convergence, events, latency, stability
from crdt_tpu_torch.oplog import records as port_records
from crdt_tpu_torch.oplog import wire as port_opwire
from crdt_tpu_torch.sync import delta, digest, session
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets

torch.set_num_threads(1)
engine.set_threads(1)

N, A, M, D = 48, 8, 8, 4
KW = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32)
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
PROC_TAG = "7e57ed"


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
    monkeypatch.setattr(jax_events, "_PROC_TAG", PROC_TAG)
    monkeypatch.setattr(events, "_PROC_TAG", PROC_TAG)


def _unis():
    return JaxUniverse.identity(JaxConfig(**KW)), Universe.identity(CrdtConfig(**KW))


JU, PU = _unis()


# -- fleets ----------------------------------------------------------------------


def _rows(jb, rows):
    return jax.tree_util.tree_map(lambda p: p[rows], jb)


def _add_on(jb, rows, actor, member):
    """``jb`` with one add (the next dot of ``actor``) on each of ``rows``."""
    rows = np.asarray(rows, np.int64)
    sub = _rows(jb, rows)
    k = rows.shape[0]
    sub = sub.apply_add(np.full(k, actor, np.int32), jnp.max(sub.clock, axis=-1) + 1,
                        np.full(k, member, np.int32))
    return jax.tree_util.tree_map(lambda p, s: p.at[rows].set(s), jb, sub)


def _base(seed, n=N, offset=0):
    """A plunged JAX fleet; ``offset`` is added to every nonzero counter."""
    rng = np.random.RandomState(seed)
    (planes,) = anti_entropy_fleets(rng, n, A, M, D, 1, base=4, novel=0, deferred_frac=0.25)
    planes = tuple(np.where(p > 0, p + np.uint32(offset), p).astype(p.dtype)
                   if p.dtype == np.uint32 else p for p in planes)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    return jb.merge(jb)


def _replicas(seed, rows_a, rows_b, n=N, offset=0):
    base = _base(seed, n, offset)
    return _add_on(base, rows_a, 1, 1 << 20), _add_on(base, rows_b, 0, 1 << 21)


def _jnp_fields(b):
    return tuple(np.asarray(getattr(b, f.name)) for f in dataclasses.fields(b))


def _port_of(jb):
    """The port batch holding the same state as the JAX batch ``jb``."""
    cols = _jnp_fields(jb)
    cls = {JaxOrswotBatch: OrswotBatch, JaxPNCounterBatch: PNCounterBatch,
           JaxGCounterBatch: GCounterBatch, JaxLWWRegBatch: LWWRegBatch}[type(jb)]
    return cls.from_numpy(*cols, device="cpu")


def _port_np(b):
    out = b.to_numpy()
    return out if isinstance(out, tuple) else (out,)


def _same_planes(port_batch, jax_batch):
    for got, want in zip(_port_np(port_batch), _jnp_fields(jax_batch)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- runs ------------------------------------------------------------------------


class _Windowed:
    """A windowed transport stub: ``send``/``recv`` over one end of a
    queue transport, an ARQ window to advertise, and the negotiation."""

    def __init__(self, send, recv, window=4):
        self.send, self.recv, self.window = send, recv, window

    def negotiate_window(self, peer_window):
        self.window = min(self.window, int(peer_window))
        return self.window


def _run(sa, sb, window=None):
    """Run ``sa`` against ``sb`` (either package) over a queue transport,
    recording each side's frames; returns ``(report_a, report_b, frames)``."""
    (send_a, recv_a), (send_b, recv_b) = session.queue_transport()
    frames = {"a": [], "b": []}

    def recording(side, send):
        def f(frame):
            frames[side].append(bytes(frame))
            send(frame)
        return f

    ends = [(recording("a", send_a), recv_a), (recording("b", send_b), recv_b)]
    if window is not None:
        ends = [(_Windowed(s, r, window),) for s, r in ends]
    out = {}

    def run_b():
        try:
            out["b"] = sb.sync(*ends[1])
        except BaseException as e:  # re-raised below
            out["b_err"] = e

    t = threading.Thread(target=run_b, daemon=True)
    t.start()
    try:
        out["a"] = sa.sync(*ends[0])
    finally:
        t.join(timeout=120)
    assert not t.is_alive()
    if "b_err" in out:
        raise out["b_err"]
    return out["a"], out["b"], frames


def _fields(report):
    return {f.name: getattr(report, f.name) for f in dataclasses.fields(report)
            if f.name != "profile"}


def _pair(jax_a, jax_b, tag, jax_kw=None, port_kw=None, **kw):
    """One JAX session pair and one port session pair on the same state,
    session IDs pinned to ``sync-<tag>-a``/``-b``."""
    jkw, pkw = {**kw, **(jax_kw or {})}, {**kw, **(port_kw or {})}
    js = (jsession.SyncSession(jax_a, JU, peer=f"{tag}-b", **jkw),
          jsession.SyncSession(jax_b, JU, peer=f"{tag}-a", **jkw))
    ps = (session.SyncSession(_port_of(jax_a), PU, peer=f"{tag}-b", **pkw),
          session.SyncSession(_port_of(jax_b), PU, peer=f"{tag}-a", **pkw))
    for pair in (js, ps):
        pair[0].session_id, pair[1].session_id = f"sync-{tag}-a", f"sync-{tag}-b"
    return js, ps


def _assert_same_runs(js, ps, window=None):
    """Run both pairs; frames, report fields and converged planes agree.
    Returns the port reports and frames."""
    jra, jrb, jframes = _run(*js, window=window)
    pra, prb, pframes = _run(*ps, window=window)
    for side in "ab":
        assert pframes[side] == jframes[side], side
    assert _fields(pra) == _fields(jra)
    assert _fields(prb) == _fields(jrb)
    assert pra.converged and prb.converged
    for p, j in zip(ps, js):
        _same_planes(p.batch, j.batch)
    _same_planes(ps[0].batch, js[1].batch)
    return (pra, prb), pframes


def _modes():
    n17 = 17
    return {
        "flat": dict(rows=([1, 5, 9], [5, 30])),
        "idempotent": dict(rows=([], [])),
        "tree": dict(rows=([1, 5, 9, 40], [5, 30]), kw=dict(digest_tree=True)),
        "tree_converged": dict(rows=([], []), kw=dict(digest_tree=True)),
        "cutover": dict(rows=([0], [16]), n=n17, kw=dict(digest_tree=True)),
        "threshold": dict(rows=(list(range(0, N, 2)), list(range(1, N, 3)))),
        "full_state": dict(rows=([3], [7]), kw=dict(full_state=True)),
        "collision": dict(rows=([4, 14], [24]), collide=True),
    }


@pytest.mark.parametrize("mode", sorted(_modes()))
def test_port_pair_sends_the_jax_frames(mode):
    spec = _modes()[mode]
    n = spec.get("n", N)
    ja, jb = _replicas(11, *spec["rows"], n=n)
    kw = dict(spec.get("kw", {}))
    jkw = pkw = None
    if spec.get("collide"):
        zero = lambda b: np.zeros(n, np.uint64)  # noqa: E731
        jkw, pkw = dict(digest_fn=zero), dict(digest_fn=zero)
    js, ps = _pair(ja, jb, f"mode-{mode}", jax_kw=jkw, port_kw=pkw, **kw)
    (ra, rb), frames = _assert_same_runs(js, ps)
    planted = len(set(spec["rows"][0]) | set(spec["rows"][1]))
    if mode == "flat":
        assert ra.diverged == planted and ra.digest_rounds == 2 and not ra.full_state_fallback
        # the hello and the eager digest precede the negotiation
        assert [f[0] for f in frames["a"][:2]] == [delta.BASELINE_VERSION] * 2
        assert all(f[0] == delta.PROTOCOL_VERSION for f in frames["a"][2:])
    elif mode in ("idempotent", "tree_converged"):
        assert ra.diverged == 0 and ra.digest_rounds == 1
        assert ra.delta_bytes_sent == ra.full_bytes_sent == 0
        assert len(frames["a"]) == 2  # the hello and one digest (or root) frame
        assert ra.tree_mode == (mode == "tree_converged")
    elif mode == "tree":
        assert ra.tree_mode and ra.digest_bytes_sent == 0 and ra.diverged == planted
        assert ra.subtrees_diverged >= 1 and ra.tree_round_trips == ra.tree_levels + 1
    elif mode == "cutover":
        assert ra.tree_mode and ra.tree_frames_sent == 1 and ra.digest_bytes_sent > 0
    elif mode == "threshold":
        assert ra.full_state_fallback and ra.delta_bytes_sent == 0 and ra.full_bytes_sent > 0
    elif mode == "full_state":
        assert ra.full_state_fallback and ra.digest_rounds == 1
    elif mode == "collision":
        assert ra.full_state_fallback and ra.delta_objects_sent == 0 and ra.digest_rounds == 3


def _counter_pairs(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "lww":
        v = rng.randint(0, 1000, N).astype(np.uint64)
        m = rng.randint(1, 100, N).astype(np.uint64)
        v2, m2 = v.copy(), m.copy()
        rows = rng.choice(N, 3, replace=False)
        v2[rows] = rng.randint(0, 1000, 3).astype(np.uint64)
        m2[rows] = 500 + rows.astype(np.uint64)
        return (JaxLWWRegBatch(vals=jnp.asarray(v), markers=jnp.asarray(m)),
                JaxLWWRegBatch(vals=jnp.asarray(v2), markers=jnp.asarray(m2)), rows)
    shape = (N, 2, A) if kind == "pncounter" else (N, A)
    c = rng.randint(0, 6, shape).astype(np.uint32)
    c2 = c.copy()
    rows = rng.choice(N, 4, replace=False)
    c2[rows] += np.uint32(1)
    cls = JaxPNCounterBatch if kind == "pncounter" else JaxGCounterBatch
    key = "planes" if kind == "pncounter" else "clocks"
    return cls(**{key: jnp.asarray(c)}), cls(**{key: jnp.asarray(c2)}), rows


@pytest.mark.parametrize("kind", ["gcounter", "pncounter", "lww"])
@pytest.mark.parametrize("tree", [False, True])
def test_counter_and_lww_fleets_match_jax(kind, tree):
    ja, jb, rows = _counter_pairs(kind, 21)
    js, ps = _pair(ja, jb, f"{kind}-{tree}", digest_tree=tree)
    (ra, _), _ = _assert_same_runs(js, ps)
    assert ra.diverged == len(rows) and ra.tree_mode == tree


def test_streaming_over_a_windowed_transport(monkeypatch):
    """The speculative descent (one blast for two levels) and the chunked
    delta stream, against two JAX sessions over the same stub."""
    monkeypatch.setattr(jsession, "DELTA_CHUNK_ROWS", 2)
    monkeypatch.setattr(session, "DELTA_CHUNK_ROWS", 2)
    ja, jb = _replicas(13, [5, 100], [200], n=320)  # levels [320, 20, 2, 1]
    js, ps = _pair(ja, jb, "stream", digest_tree=True)
    (ra, rb), frames = _assert_same_runs(js, ps, window=4)
    for r in (ra, rb):
        assert r.streaming and r.window == 4 and r.tree_mode
        assert r.tree_round_trips == 2
        assert 0 < r.spec_hits < r.spec_misses
        assert r.delta_chunks_sent == 2 and r.diverged == 3
    # the same fleets lock-step (no window): more round trips, same rows
    js2, ps2 = _pair(ja, jb, "stream-lockstep", digest_tree=True)
    (la, _), _ = _assert_same_runs(js2, ps2)
    assert not la.streaming and la.tree_round_trips > ra.tree_round_trips
    assert la.spec_hits == la.spec_misses == 0 and la.diverged == ra.diverged


def test_window_one_peer_stays_lock_step():
    ja, jb = _replicas(13, [5], [200], n=320)
    js, ps = _pair(ja, jb, "window-one", digest_tree=True)
    (ra, _), _ = _assert_same_runs(js, ps, window=1)
    assert not ra.streaming and ra.window == 1 and ra.spec_hits == 0


# -- mixed packages --------------------------------------------------------------


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("versions", [(None, None), (2, None), (None, 2), (3, None)])
def test_port_and_jax_sessions_converge_against_each_other(tree, versions):
    """A port session against a JAX session: both converge to the same
    planes and digests, and the frames are those of two JAX sessions."""
    ja, jb = _replicas(17, [2, 7, 33], [7, 12])
    pv, jv = versions
    tag = f"mixed-{tree}-{pv}-{jv}"
    kw_p = dict(digest_tree=tree, protocol_version=pv)
    kw_j = dict(digest_tree=tree, protocol_version=jv)
    port_a = session.SyncSession(_port_of(ja), PU, peer="jax", **kw_p)
    jax_b = jsession.SyncSession(jb, JU, peer="port", **kw_j)
    ref_a = jsession.SyncSession(ja, JU, peer="jax", **kw_p)
    ref_b = jsession.SyncSession(jb, JU, peer="port", **kw_j)
    for s in (port_a, ref_a):
        s.session_id = f"sync-{tag}-a"
    for s in (jax_b, ref_b):
        s.session_id = f"sync-{tag}-b"
    ra, rb, frames = _run(port_a, jax_b)
    wa, wb, want = _run(ref_a, ref_b)
    assert frames == want
    assert _fields(ra) == _fields(wa) and _fields(rb) == _fields(wb)
    assert ra.converged and rb.converged and ra.diverged == 4
    negotiated = min(v or delta.PROTOCOL_VERSION for v in versions)
    assert ra.protocol_version == negotiated
    assert ra.tree_mode == (tree and negotiated >= 3)
    # after the hello (and an eager digest at the baseline version)
    assert all(f[0] in (negotiated, delta.BASELINE_VERSION) for f in frames["a"] + frames["b"])
    assert frames["a"][-1][0] == frames["b"][-1][0] == negotiated
    _same_planes(port_a.batch, jax_b.batch)
    np.testing.assert_array_equal(digest.digest_of(port_a.batch, PU),
                                  np.asarray(jdigest.digest_of(jax_b.batch, JU)))


# -- frames ----------------------------------------------------------------------


def _hello_args():
    return [("sync-1-0001", "proc-ab", False, {}),
            ("x" * 200, "n" * 100, True, dict(oplog=True, digest_tree=True, lag=True,
                                               window=8, ver=3)),
            ("t", "node", True, dict(window=-3, ver=2))]


@pytest.mark.parametrize("case", range(3))
def test_session_frames_match_jax(case):
    trace, node, fobs, kw = _hello_args()[case]
    got = delta.encode_hello_frame(trace, node, fobs, **kw)
    assert got == jdelta.encode_hello_frame(trace, node, fobs, **kw)
    assert got[0] == delta.BASELINE_VERSION
    for dec, enc in ((delta, jdelta), (jdelta, delta)):
        ftype, payload = dec.decode_frame(enc.encode_hello_frame(trace, node, fobs, **kw))
        assert ftype == delta.FRAME_HELLO
        assert tuple(dec.decode_hello_payload(payload)) == tuple(
            jdelta.decode_hello_payload(payload))
    blob = bytes(range(37)) * (case + 1)
    for name in ("encode_fleet_frame", "encode_ops_sync_frame"):
        for v in (None, 2, 3):
            assert getattr(delta, name)(blob, version=v) == getattr(jdelta, name)(blob,
                                                                                  version=v)
    assert delta.decode_fleet_payload(blob) == jdelta.decode_fleet_payload(blob) == blob
    assert delta.decode_ops_sync_payload(blob) == blob
    entries = [(a, (1 << 31) + 7 * a + case, -5 + a * 1000) for a in range(case * 3)]
    tag = ["p", "t" * 300, "é" * 100][case]  # the second is cut to 255 bytes
    got = delta.encode_lag_frame(entries, tag, version=3)
    assert got == jdelta.encode_lag_frame(entries, tag, version=3)
    for dec, enc in ((delta, jdelta), (jdelta, delta)):
        _, payload = dec.decode_frame(enc.encode_lag_frame(entries, tag))
        assert dec.decode_lag_payload(payload) == jdelta.decode_lag_payload(payload)


def test_hello_without_newer_keys_reads_as_v2():
    info = delta.decode_hello_payload(b'{"trace":"t"}')
    assert tuple(info) == tuple(jdelta.decode_hello_payload(b'{"trace":"t"}'))
    assert info.ver == 2 and not info.digest_tree and info.window == 0


@pytest.mark.parametrize("payload", [b"", b"not json", b"[1, 2]", b'{"node": "x"}',
                                     b'{"trace": ""}', b'{"trace": "t", "ver": "x"}',
                                     b"\xff\xfe"])
def test_malformed_hello_raises(payload):
    with pytest.raises(SyncProtocolError):
        delta.decode_hello_payload(payload)
    with pytest.raises(JaxSyncProtocolError):
        jdelta.decode_hello_payload(payload)


def _lag_bad():
    good = jdelta.decode_frame(jdelta.encode_lag_frame([(1, 2, 3)], "tag"))[1]
    return [b"", b"\x05ab", good[:-1], good + b"\x00", b"\x02\xff\xfe\x00\x00\x00\x00",
            struct.pack("<B", 0) + struct.pack("<I", 2) + good[-18:]]


@pytest.mark.parametrize("case", range(6))
def test_malformed_lag_payload_raises(case):
    payload = _lag_bad()[case]
    with pytest.raises(SyncProtocolError):
        delta.decode_lag_payload(payload)
    with pytest.raises(JaxSyncProtocolError):
        jdelta.decode_lag_payload(payload)


# -- piggybacks ------------------------------------------------------------------


class _Observatory:
    """A fleet observatory stub: its snapshot bytes, and the peers' it
    merged."""

    def __init__(self, node_id):
        self.node_id = node_id
        self.seen = []
        self.slices = [node_id]

    def encode(self):
        return f"snapshot of {self.node_id}".encode()

    def merge_frame(self, frame):
        self.seen.append(frame)
        self.slices = sorted(set(self.slices) | {frame.decode()})
        return self


def test_fleet_snapshot_piggyback_matches_jax():
    ja, jb = _replicas(23, [1], [2])
    obs = {k: _Observatory(k) for k in ("ja", "jb", "pa", "pb")}
    js, ps = _pair(ja, jb, "fleet")
    js[0].observatory, js[1].observatory = obs["ja"], obs["jb"]
    ps[0].observatory, ps[1].observatory = obs["pa"], obs["pb"]
    for s, name in ((js[0], "na"), (js[1], "nb"), (ps[0], "na"), (ps[1], "nb")):
        s.observatory.node_id = name
    (ra, rb), frames = _assert_same_runs(js, ps)
    assert ra.fleet_nodes == rb.fleet_nodes == 2 and ra.fleet_bytes_sent > 0
    assert obs["pa"].seen == obs["ja"].seen == [b"snapshot of nb"]
    assert delta.decode_frame(frames["a"][-1]) == (delta.FRAME_FLEET, b"snapshot of na")


def _op_batches(pkg):
    rng = np.random.RandomState(5)
    return pkg.OpBatch(kind=np.zeros(6, np.uint8), obj=rng.randint(0, N, 6),
                       actor=rng.randint(0, A, 6), counter=rng.randint(1, 50, 6),
                       member=rng.randint(0, 100, 6))


def test_ops_piggyback_matches_jax():
    ja, jb = _replicas(29, [3], [4])
    ops = {"j": jax_opwire.encode_ops_frame(_op_batches(jax_records)),
           "p": port_opwire.encode_ops_frame(_op_batches(port_records))}
    assert ops["j"] == ops["p"]
    sinks = {k: [] for k in ("ja", "jb", "pa", "pb")}
    js, ps = _pair(ja, jb, "ops")
    for s, key, outbox in ((js[0], "ja", lambda: ops["j"]), (js[1], "jb", lambda: b""),
                           (ps[0], "pa", lambda: ops["p"]), (ps[1], "pb", lambda: b"")):
        s._op_outbox, s._op_sink = outbox, sinks[key].append
    (ra, rb), _ = _assert_same_runs(js, ps)
    assert (ra.ops_sent, ra.ops_received, rb.ops_sent, rb.ops_received) == (6, 0, 0, 6)
    assert sinks["pb"] == sinks["jb"] == [ops["p"]]
    assert sinks["pa"] == sinks["ja"] and len(sinks["pa"]) == 1


def test_lag_sidecar_past_2_31_matches_jax():
    """A u32 fleet whose counters exceed 2^31: the converged clock plane
    unbiased witnesses the peer's new dots, and the counts match JAX's."""
    off = (1 << 31) + 5
    ja, jb = _replicas(31, [2, 9], [9, 20], offset=off)
    clock_a = np.asarray(ja.clock)
    assert clock_a.max() > (1 << 31)
    new_a = int(clock_a[:, 1].max())      # actor 1's newest dot, written on A
    new_b = int(np.asarray(jb.clock)[:, 0].max())
    trackers = {}
    for pkg, mod in (("j", jax_latency), ("p", latency)):
        kw = dict(registry=jax_metrics.MetricsRegistry()) if pkg == "j" else {}
        ta, tb = (mod.LagTracker(proc_tag="lag-domain", **kw) for _ in range(2))
        ta.record_ingest(1, new_a, mono_ns=1_000)
        ta.record_ingest(1, new_a + 5, mono_ns=2_000)  # never visible
        tb.record_ingest(0, new_b, mono_ns=3_000)
        trackers[pkg] = (ta, tb)
    js, ps = _pair(ja, jb, "lag")
    js[0].lag_tracker, js[1].lag_tracker = trackers["j"]
    ps[0].lag_tracker, ps[1].lag_tracker = trackers["p"]
    (ra, rb), _ = _assert_same_runs(js, ps)
    assert (ra.lag_entries_sent, ra.lag_entries_received) == (2, 1)
    assert (rb.lag_entries_sent, rb.lag_entries_received) == (1, 2)
    for (jt, pt), peer in zip(zip(trackers["j"], trackers["p"]), ("lag-b", "lag-a")):
        want, got = jt.snapshot()["peers"][peer], pt.snapshot()["peers"][peer]
        assert (got["samples"], got["outstanding"]) == (want["samples"], want["outstanding"])
    assert trackers["p"][1].snapshot()["peers"]["lag-a"]["samples"] == 1
    assert trackers["p"][1].snapshot()["peers"]["lag-a"]["outstanding"] == 1
    assert trackers["p"][0].snapshot()["peers"]["lag-b"]["samples"] == 1


def test_lag_sidecar_drops_a_foreign_clock_domain():
    ja, jb = _replicas(31, [2], [3])
    pa, pb = (latency.LagTracker(proc_tag=t) for t in ("one", "two"))
    pa.record_ingest(1, 5, mono_ns=1)
    _, ps = _pair(ja, jb, "lag-foreign")
    ps[0].lag_tracker, ps[1].lag_tracker = pa, pb
    _, rb, _ = _run(*ps)
    assert rb.lag_entries_received == 0
    assert pb.snapshot()["foreign_sidecars_dropped"] == 1


@pytest.mark.parametrize("piggyback", ["fleet", "ops"])
def test_one_sided_piggyback_ships_nothing(piggyback):
    """Only one side advertises the capability: no piggyback frame flows,
    on either package, and both converge."""
    ja, jb = _replicas(37, [2], [8])
    js, ps = _pair(ja, jb, f"one-sided-{piggyback}")
    sink = []
    for s in (js[0], ps[0]):
        if piggyback == "fleet":
            s.observatory = _Observatory("na")
        else:
            s._op_outbox, s._op_sink = (lambda: b""), sink.append
    (ra, rb), frames = _assert_same_runs(js, ps)
    assert ra.fleet_bytes_sent == ra.ops_bytes_sent == rb.fleet_bytes_sent == 0
    assert len(frames["a"]) == len(frames["b"]) == 4 and not sink


def test_lag_capable_session_against_a_peer_without_it():
    ja, jb = _replicas(37, [1], [6])
    before = session.session_counts().get("lag_fallback_capability", 0)
    js, ps = _pair(ja, jb, "lag-fallback")
    js[0].lag_tracker = jax_latency.LagTracker(registry=jax_metrics.MetricsRegistry())
    ps[0].lag_tracker = latency.LagTracker()
    (ra, _), _ = _assert_same_runs(js, ps)
    assert ra.converged and ra.lag_bytes_sent == 0
    assert session.session_counts()["lag_fallback_capability"] == before + 1
    evs = events.recorder().snapshot(kind="sync.lag_fallback", session=ps[0].session_id)
    assert evs and evs[-1]["fields"]["reason"] == "capability"


def test_lag_tracker_stamp_table_matches_jax():
    """Batches of ops stamp each actor's highest counter; the table keeps
    the newest ``per_actor`` stamps of at most ``max_actors`` actors."""
    rng = np.random.RandomState(3)
    jt = jax_latency.LagTracker(registry=jax_metrics.MetricsRegistry(), proc_tag="t",
                                per_actor=3, max_actors=4)
    pt = latency.LagTracker(proc_tag="t", per_actor=3, max_actors=4)
    for step in range(6):
        b = 40
        cols = dict(kind=np.zeros(b, np.uint8), obj=rng.randint(0, N, b),
                    actor=rng.randint(0, 6, b), counter=rng.randint(1, 1 << 40, b),
                    member=rng.randint(0, 9, b))
        jt.record_ingest_batch(jax_records.OpBatch(**cols))
        pt.record_ingest_batch(port_records.OpBatch(**cols))
    jt.record_ingest_batch(None)
    pt.record_ingest_batch(port_records.OpBatch.empty())
    strip = lambda es: [(a, c) for a, c, _ in es]  # noqa: E731 (stamps differ by clock)
    assert strip(pt.export_entries()) == strip(jt.export_entries())
    assert pt.snapshot()["stamped_actors"] == jt.snapshot()["stamped_actors"] == 4
    entries = [(1, 5, 0), (1, 5, 0), (1, 7, 0), (2, 1, 0)]
    for trk in (jt, pt):
        assert trk.ingest_sidecar("peer", entries, origin_proc="t") == 3
        assert trk.observe_visibility({1: 6, 2: 0}, peer="peer") == 1
        assert trk.ingest_sidecar("peer", [(1, 5, 0), (1, 9, 0)], origin_proc="t") == 1
    want, got = jt.snapshot()["peers"]["peer"], pt.snapshot()["peers"]["peer"]
    assert (got["samples"], got["outstanding"]) == (want["samples"], want["outstanding"]) \
        == (1, 3)


def test_registered_peer_reads_unknown_until_an_exchange():
    jt = jax_convergence.ConvergenceTracker(registry=jax_metrics.MetricsRegistry())
    pt = convergence.ConvergenceTracker()
    for trk in (jt, pt):
        trk.register_peer("roster")
        trk.observe_version_vector("seen", [3, 4])
        trk.register_peer("seen")  # has state: left as it is
    gauges = jt._reg().snapshot()["gauges"]
    snap = pt.snapshot()
    assert snap["roster"]["divergence"] == gauges["sync.peer.roster.divergence"] == -1
    assert snap["roster"]["divergence_frac"] == gauges["sync.peer.roster.divergence_frac"]
    assert snap["roster"]["staleness_s"] == gauges["sync.peer.roster.staleness_s"]
    assert snap["seen"]["divergence"] == jt.snapshot()["seen"]["divergence"] == 0
    assert pt.version_vectors()["seen"][0] == jt.version_vectors()["seen"][0] == (3, 4)
    pt.observe_divergence("roster", 5, 20)
    assert pt.snapshot()["roster"]["divergence_frac"] == 0.25


def test_flight_recorder_ring_matches_jax():
    jr, pr = jax_events.FlightRecorder(capacity=4), events.FlightRecorder(capacity=4)
    for rec in (jr, pr):
        for i in range(6):
            rec.record("sync.phase" if i % 2 else "sync.hello", session=f"s{i % 3}", i=i)
        rec.record("syncx.other")
    for kind, sid in ((None, None), ("sync", None), ("sync.phase", None), (None, "s2")):
        strip = lambda evs: [(e["seq"], e["kind"], e.get("session"), e.get("fields"))  # noqa
                             for e in evs]
        assert strip(pr.snapshot(kind, sid)) == strip(jr.snapshot(kind, sid))
    assert pr.dropped == jr.dropped == 3
    pr.clear()
    assert pr.snapshot() == [] and pr.dropped == 0
    with pytest.raises(ValueError):
        events.FlightRecorder(capacity=0)
    assert events.new_session_id().startswith(f"sync-{PROC_TAG}-")


# -- observers -------------------------------------------------------------------


def _kinds(rec, sid):
    return [(e["kind"], e.get("fields", {}).get("phase"))
            for e in rec.snapshot(session=sid)]


@pytest.mark.parametrize("mode", ["flat", "tree", "collision"])
def test_observers_match_jax(mode):
    """Convergence fields against the JAX gauges, the flight recorder's
    kinds in the JAX order, the heat tracker's repair rows."""
    rows_a, rows_b = [3, 17, 40], [17, 21]
    ja, jb = _replicas(41, rows_a, rows_b)
    kw = dict(digest_tree=mode == "tree")
    jkw = pkw = None
    if mode == "collision":
        jkw = pkw = dict(digest_fn=lambda b: np.zeros(N, np.uint64))
    tag = f"obs-{mode}"
    heat = HeatTracker(device="cpu")
    js, ps = _pair(ja, jb, tag, jax_kw=jkw, port_kw=pkw, full_state_bytes=10_000, **kw)
    ps[0].heat = heat
    _assert_same_runs(js, ps)
    for s, j in zip(ps, js):
        assert _kinds(events.recorder(), s.session_id) == _kinds(jax_events.recorder(),
                                                                  j.session_id)
    gauges = jax_metrics.registry().snapshot()["gauges"]
    snap = convergence.tracker().snapshot()
    for peer in (f"{tag}-a", f"{tag}-b"):
        for field in ("divergence", "divergence_frac", "rounds_to_converge"):
            assert snap[peer][field] == gauges[f"sync.peer.{peer}.{field}"], (peer, field)
        assert snap[peer]["delta_ratio_history"][-1] == gauges[f"sync.peer.{peer}.delta_ratio"]
        if mode == "tree":
            assert snap[peer]["diverged_subtrees"] == \
                gauges[f"sync.peer.{peer}.diverged_subtrees"]
        jsnap = jax_convergence.tracker().snapshot()[peer]
        for field in ("divergence", "objects", "rounds_to_converge", "divergence_resolved",
                      "diverged_subtrees"):
            assert snap[peer][field] == jsnap[field], (peer, field)
        assert 0 <= snap[peer]["staleness_s"] < 60
    want = 0 if mode == "collision" else len(set(rows_a) | set(rows_b))
    hs = heat.snapshot()
    assert hs["rows"]["repair"] == want
    if want:
        span = hs["layout"]["span"]
        per = np.bincount(np.array(sorted(set(rows_a) | set(rows_b))) // span,
                          minlength=hs["layout"]["subtrees"])
        assert [s["repair"] for s in hs["subtree"]] == per.tolist()


def test_stability_aging_and_frontier_match_jax():
    """A delta session resolves the aging but defers the frontier
    evidence; the idle re-sync commits it, on both packages alike."""
    ja, jb = _replicas(43, [1], [20])
    t = [100.0]
    clock = lambda: t[0]  # noqa: E731
    jt = [jax_stability.StabilityTracker(registry=jax_metrics.MetricsRegistry(), clock=clock)
          for _ in range(2)]
    pt = [stability.StabilityTracker(clock=clock) for _ in range(2)]
    js, ps = _pair(ja, jb, "stab")
    for pair, trk in ((js, jt), (ps, pt)):
        pair[0].stability, pair[1].stability = trk
    _assert_same_runs(js, ps)
    for trk in (jt[0], pt[0]):
        assert trk.oldest_divergence_age_s() == 0.0
    jrep = jt[0].frontier(js[0].batch, peers=["stab-b"])
    prep = pt[0].frontier(ps[0].batch, peers=["stab-b"])
    assert prep.unheard == jrep.unheard == 1
    np.testing.assert_array_equal(prep.clock, jrep.clock)
    js2, ps2 = _pair(js[0].batch, js[1].batch, "stab")
    for pair, trk in ((js2, jt), (ps2, pt)):
        pair[0].stability, pair[1].stability = trk
    (ra, _), _ = _assert_same_runs(js2, ps2)
    assert ra.diverged == 0
    for i in range(2):
        peer = ("stab-b", "stab-a")[i]
        jrep = jt[i].frontier(js2[i].batch, peers=[peer])
        prep = pt[i].frontier(ps2[i].batch, peers=[peer])
        assert prep.unheard == jrep.unheard == 0
        np.testing.assert_array_equal(prep.clock, jrep.clock)
        np.testing.assert_array_equal(prep.clock, digest.version_vector(ps2[i].batch))
        jsnap, psnap = jt[i].snapshot(), pt[i].snapshot()
        assert psnap["aging"]["resolved_total"] == jsnap["aging"]["resolved_total"]
        assert psnap["frontier"] == jsnap["frontier"]


@pytest.mark.parametrize("kind", ["orswot", "lww"])
def test_converged_session_samples_capacity_like_jax(kind):
    from crdt_tpu.obs import capacity as jax_capacity
    from crdt_tpu_torch import CapacityTracker

    ja, jb = _replicas(67, [1], [2]) if kind == "orswot" else _counter_pairs("lww", 67)[:2]
    js, ps = _pair(ja, jb, f"capacity-{kind}")
    t = [5.0]
    jt = jax_capacity.CapacityTracker(jax_metrics.MetricsRegistry(), clock=lambda: t[0])
    pt = CapacityTracker(clock=lambda: t[0])
    js[0].capacity_tracker, ps[0].capacity_tracker = jt, pt
    _assert_same_runs(js, ps)
    assert sorted(pt.planes()) == sorted(jt.planes()) == ([kind] if kind == "orswot" else [])
    if kind == "orswot":
        got, want = pt.planes()[kind], jt.planes()[kind]
        assert dataclasses.asdict(got.occupancy) == dataclasses.asdict(want.occupancy)
        assert got.state == want.state


def test_profile_accounting_identity_to_the_ns():
    ja, jb = _replicas(47, [1, 5], [4])
    _, ps = _pair(ja, jb, "profile")
    ra, rb, _ = _run(*ps)
    for rep in (ra, rb):
        p = rep.profile
        assert p is not None and p.wall_ns > 0
        assert p.serialize_ns + p.network_ns + p.kernel_ns + p.other_ns + p.unaccounted_ns \
            == p.wall_ns
        assert p.frames_sent == p.frames_received == 4
        assert 0.0 <= p.network_wait_frac <= 1.0
        assert set(p.to_dict()) == set(jax_latency.SessionProfile().to_dict())
    prof = latency.SessionProfile()
    prof.start()
    with prof.clock("kernel"):
        with prof.clock("serialize"):  # nested: charged to the outer region
            pass
    prof.finish()
    assert prof.serialize_ns == 0 and prof.kernel_ns > 0
    assert prof.accounted_ns + prof.unaccounted_ns == prof.wall_ns


# -- errors ----------------------------------------------------------------------


@pytest.mark.parametrize("hangup", [ConnectionResetError("peer closed mid-frame"),
                                    EOFError("stream ended inside a frame")])
def test_peer_closing_mid_frame_is_a_protocol_error(hangup):
    ja, _ = _replicas(53, [], [])
    s = session.SyncSession(_port_of(ja), PU, peer="hangup")

    def die():
        raise hangup

    with pytest.raises(SyncProtocolError) as info:
        s.sync(lambda f: None, die)
    assert info.value.__cause__ is hangup
    evs = events.recorder().snapshot(kind="sync.error", session=s.session_id)
    assert evs and "mid-session" in evs[-1]["fields"]["error"]


def test_transport_error_propagates_with_an_event():
    from crdt_tpu_torch import TransportError

    ja, _ = _replicas(53, [], [])
    s = session.SyncSession(_port_of(ja), PU, peer="deadline")
    err = TransportError("recv deadline passed")

    def late():
        raise err

    with pytest.raises(TransportError) as info:
        s.sync(lambda f: None, late)
    assert info.value is err
    evs = events.recorder().snapshot(kind="sync.error", session=s.session_id)
    assert evs and evs[-1]["fields"]["error"] == "recv deadline passed"


def test_fleet_size_mismatch_raises():
    a = _port_of(_base(59, n=8))
    b = _port_of(_base(59, n=12))
    for kw in ({}, dict(digest_tree=True)):
        with pytest.raises(SyncProtocolError):
            session.sync_pair(session.SyncSession(a, PU, **kw), session.SyncSession(b, PU, **kw))


def test_truncated_delta_inside_a_session_raises():
    b = _port_of(_base(61, n=8))
    s = session.SyncSession(b, PU)
    mine = digest.digest_of(b, PU).copy()
    mine[0] ^= np.uint64(1)
    delta_frame = delta.encode_delta_frame(8, np.array([0]), b.to_wire(PU)[:1])
    frames = iter([delta.encode_hello_frame("peer", "node", False),
                   delta.encode_digest_frame(mine), delta_frame[:-2]])
    with pytest.raises(SyncProtocolError, match="length mismatch"):
        s.sync(lambda f: None, lambda: next(frames))


def test_bad_arguments_raise():
    b = _port_of(_base(61, n=8))
    with pytest.raises(ValueError):
        session.SyncSession(b, PU, full_state_threshold=1.5)
    with pytest.raises(ValueError):
        session.SyncSession(b, PU, protocol_version=5)
    assert not session.SyncSession(b, PU, digest_tree=True, protocol_version=2).digest_tree


# -- the launch counter ----------------------------------------------------------


def test_launch_counter_is_exact_under_two_threads():
    """Two threads add 10,000 launches each to one kernel's count; with a
    short switch interval a lost update would show."""
    _build.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build._count("orswot_merge")
                                                    for _ in range(10_000)])
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _build.launch_counts()["orswot_merge"] == 20_000
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
