"""Parity of the port's read frames and serve loop
(``crdt_tpu_torch.serve.wire``, ``serve.loop``) with the JAX package's,
on the CPU, exact: request and result frames of all six kinds in all four
modes byte-equal both ways, every malformed frame rejected with the same
error class and reason, and a port ``ClusterNode`` against a JAX
``ClusterNode`` holding the same state and taking the same
``submit_writes``: the same result frames and tokens in every mode, the
same park-then-``ConsistencyUnavailableError``, the same frontier
rejection, the same ``serve_frames`` bytes and stats (overlapped and
serial).  A read whose snapshot was taken before a drain or a session
returns the frame of that snapshot, bit for bit.

The JAX nodes stay off ``crdt_tpu.native`` (``probe_engine`` returns None,
the scalarize extension refuses to load); both packages' process tags are
pinned."""

import queue
import struct
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu import serve as jserve
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.cluster import ClusterNode as JaxClusterNode
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import ConsistencyUnavailableError as JaxConsistencyUnavailableError
from crdt_tpu.obs import events as jevents
from crdt_tpu.oplog import OpLog as JaxOpLog
from crdt_tpu.utils import tracing as jtracing
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import ClusterNode, CrdtConfig, OrswotBatch, SyncSession, Universe, serve
from crdt_tpu_torch.error import ConsistencyUnavailableError
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.obs import events
from crdt_tpu_torch.oplog import OpLog
from crdt_tpu_torch.serve import consistency, query, wire
from crdt_tpu_torch.sync import sync_pair
from crdt_tpu_torch.utils.testdata import anti_entropy_fleets

torch.set_num_threads(1)
engine.set_threads(1)

N, A, M, D = 48, 8, 8, 4
KW = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32)
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
JU, PU = JaxUniverse.identity(JaxConfig(**KW)), Universe.identity(CrdtConfig(**KW))
PROC_TAG = "5e7e10"
FRAME_FIELDS = ("obj", "kind", "member", "status", "val", "add_clock", "rm_clock", "token")


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


# -- frames ------------------------------------------------------------------------------

#: each kind's clock-row width W in a result frame (0: clockless)
KIND_WIDTH = {query.K_ORSWOT: A, query.K_GCOUNTER: A, query.K_PNCOUNTER: 2 * A,
              query.K_LWW: 0, query.K_MVREG: A, query.K_MAP: A}


def _request_pair(rng, kind, mode, b):
    obj = rng.randint(0, N, b)
    member = rng.randint(-1, 40, b).astype(np.int32)
    require = None if mode in ("eventual", "frontier") else \
        rng.randint(0, 1 << 40, KIND_WIDTH[kind] or 1).astype(np.uint64)
    kw = dict(kind=kind, member=member, mode=mode, require=require)
    return query.ReadRequest.reads(obj, **kw), jserve.ReadRequest.reads(obj, **kw)


def _result_pair(rng, kind, b):
    w = KIND_WIDTH[kind]
    cols = dict(obj=rng.randint(0, N, b).astype(np.int64), kind=np.full(b, kind, np.uint8),
                member=rng.randint(-1, 40, b).astype(np.int32),
                status=rng.randint(0, 2, b).astype(np.uint8),
                val=rng.randint(0, 1 << 62, b).astype(np.uint64),
                add_clock=rng.randint(0, 1 << 62, (b, w)).astype(np.uint64),
                rm_clock=rng.randint(0, 1 << 62, (b, w)).astype(np.uint64),
                token=rng.randint(0, 1 << 62, w).astype(np.uint64))
    return query.ResultFrame(**cols), jserve.ResultFrame(**{k: v.copy() for k, v in cols.items()})


def _same_request(got, want):
    for f in ("obj", "kind", "member"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.mode == want.mode
    if want.require is None:
        assert got.require is None
    else:
        assert got.require.dtype == want.require.dtype
        np.testing.assert_array_equal(got.require, want.require)


def _same_result(got, want):
    for f in FRAME_FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("kind", sorted(query.KIND_NAMES))
def test_frames_are_byte_equal_to_jax_both_ways(kind):
    rng = np.random.RandomState(kind + 1)
    assert (wire.FRAME_READ, wire.FRAME_RESULT, wire.SERVE_PROTOCOL_VERSION) == \
        (jserve.FRAME_READ, jserve.FRAME_RESULT, jserve.SERVE_PROTOCOL_VERSION)
    for mode in consistency.MODES:
        for b in (0, 1, 9):
            mine, theirs = _request_pair(rng, kind, mode, b)
            frame = wire.encode_read_request(mine)
            assert frame == jserve.encode_read_request(theirs)
            _same_request(wire.decode_read_request(frame, num_objects=N),
                          jserve.decode_read_request(frame, num_objects=N))
    for b in (0, 1, 9):
        mine, theirs = _result_pair(rng, kind, b)
        frame = wire.encode_result_frame(mine)
        assert frame == jserve.encode_result_frame(theirs)
        _same_result(wire.decode_result_frame(frame), jserve.decode_result_frame(frame))
        _same_result(wire.decode_result_frame(frame), mine)


def _reframe(ftype, payload):
    """An honestly enveloped frame (right CRC and length) around ``payload``."""
    return struct.pack("<BBIQ", 1, ftype, zlib.crc32(payload), len(payload)) + payload


def _malformed():
    rng = np.random.RandomState(7)
    req, _ = _request_pair(rng, query.K_ORSWOT, "ryw", 5)
    good = wire.encode_read_request(req)
    res, _ = _result_pair(rng, query.K_ORSWOT, 4)
    good_res = wire.encode_result_frame(res)
    body, res_body = good[14:], good_res[14:]
    crc = bytearray(good)
    crc[-1] ^= 0xFF
    version = bytearray(good)
    version[0] = 9
    bad_kind = query.ReadRequest.reads([1, 2], kind=99)
    low_member = query.ReadRequest.reads([1, 2], member=[3, -5])
    bad_mode = bytearray(body)
    bad_mode[6] = 250
    wide = bytearray(body)
    struct.pack_into("<H", wide, 4, A + 3)  # W larger than the clock it carries
    narrow = bytearray(body)
    struct.pack_into("<H", narrow, 4, A - 3)  # W smaller: bytes left over
    bad_status = bytearray(res_body)
    bad_status[8 + 4 * 8 + 4 + 4 * 4] = 7  # the first status byte
    res_kind = bytearray(res_body)
    res_kind[8 + 4 * 8] = 42
    return {
        "truncated_header": ("read", good[:6], None),
        "truncated_column": ("read", _reframe(0x41, body[:-3]), None),
        "length_mismatch": ("read", good + b"\x00", None),
        "crc": ("read", bytes(crc), None),
        "version": ("read", bytes(version), None),
        "type_read_as_result": ("result", good, None),
        "type_result_as_read": ("read", good_res, None),
        "bad_mode": ("read", _reframe(0x41, bytes(bad_mode)), None),
        "kind_out_of_range": ("read", wire.encode_read_request(bad_kind), None),
        "member_below_sentinel": ("read", wire.encode_read_request(low_member), None),
        "object_out_of_range": ("read", good, 3),
        "w_too_wide": ("read", _reframe(0x41, bytes(wide)), None),
        "w_too_narrow": ("read", _reframe(0x41, bytes(narrow)), None),
        "trailing": ("read", _reframe(0x41, body + b"\x00\x00"), None),
        "result_truncated": ("result", _reframe(0x42, res_body[:-1]), None),
        "result_bad_status": ("result", _reframe(0x42, bytes(bad_status)), None),
        "result_bad_kind": ("result", _reframe(0x42, bytes(res_kind)), None),
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_frames_reject_as_jax(case):
    which, frame, num_objects = MALFORMED[case]

    def run(mod):
        if which == "read":
            mod.decode_read_request(frame, num_objects=num_objects)
        else:
            mod.decode_result_frame(frame)

    before = wire.rejected_counts()
    jbefore = jtracing.counters()
    events.recorder().clear()
    with pytest.raises(Exception) as mine:
        run(wire)
    with pytest.raises(Exception) as theirs:
        run(jserve)
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert type(mine.value).__name__ in ("SyncProtocolError", "WireFormatError")
    assert str(mine.value) == str(theirs.value)
    after = wire.rejected_counts()
    got = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    prefix = "serve.frames.rejected."
    want = {k[len(prefix):]: v for k, v in jtracing.counters_since(jbefore).items()
            if k.startswith(prefix)}
    assert got == want and sum(got.values()) == 1
    (ev,) = events.recorder().snapshot("serve.protocol_error")
    assert ev["fields"]["reason"] == next(iter(got))


# -- the serve loop on a node ------------------------------------------------------------


def _planes(seed):
    (planes,) = anti_entropy_fleets(np.random.RandomState(seed), N, A, M, D, 1, base=4,
                                    novel=0, deferred_frac=0.25)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    jb = jb.merge(jb)
    return jb, tuple(np.asarray(getattr(jb, f)) for f in PLANES)


def _nodes(seed=3):
    jb, planes = _planes(seed)
    port = ClusterNode("n0", OrswotBatch.from_numpy(*planes, device="cpu"), PU, oplog=OpLog(PU))
    jax = JaxClusterNode("n0", jb, JU, oplog=JaxOpLog(JU))
    return port, jax


def _write_both(port, jax, rng, k=6, actor=2):
    obj = rng.randint(0, N, k).astype(np.int64)
    member = (200 + rng.randint(0, 4, k)).astype(np.int32)
    assert port.submit_writes(obj, member, actor=actor) == jax.submit_writes(obj, member,
                                                                            actor=actor)
    return obj, member


def _same_planes(port_batch, jax_batch):
    for got, f in zip(port_batch.to_numpy(), PLANES):
        np.testing.assert_array_equal(got, np.asarray(getattr(jax_batch, f)), err_msg=f)


def _serve_both(port, jax, obj, member, mode, require):
    mine = port.serve_reads(query.ReadRequest.reads(obj, member=member, mode=mode,
                                                    require=require))
    theirs = jax.serve_reads(jserve.ReadRequest.reads(obj, member=member, mode=mode,
                                                      require=require))
    assert wire.encode_result_frame(mine) == jserve.encode_result_frame(theirs)
    _same_result(mine, theirs)
    return mine


def test_node_serves_every_mode_as_jax():
    port, jax = _nodes()
    rng = np.random.RandomState(11)
    np.testing.assert_array_equal(port.read_token(), np.asarray(jax.read_token()))
    token = port.read_token()
    for step in range(4):
        obj, member = _write_both(port, jax, rng, actor=1 + step % 3)
        _same_planes(port.batch, jax.batch)
        ack = port.write_vv()
        np.testing.assert_array_equal(ack, np.asarray(jax.write_vv()))
        probe = np.concatenate([obj, rng.randint(0, N, 5)])
        members = np.concatenate([member, np.full(5, -1, np.int32)])
        frame = _serve_both(port, jax, probe, members, "ryw", ack)
        assert (frame.val[:len(obj)] == 1).all()  # every acknowledged write reads as a member
        frame = _serve_both(port, jax, probe, members, "monotonic", token)
        assert (frame.token >= token).all()
        token = frame.token
        _serve_both(port, jax, probe, members, "eventual", None)
    assert port.observe_stability(peers=[]) is not None
    assert jax.observe_stability(peers=[]) is not None
    frame = _serve_both(port, jax, np.arange(N), np.full(N, -1, np.int32), "frontier", None)
    assert frame.status.shape == (N,)
    counts = port.serve_loop().counts()
    assert counts["admit"] == {"ryw": 4, "monotonic": 4, "eventual": 4, "frontier": 1}
    assert counts["park"] == counts["reject"] == {}
    assert sum(v["count"] for v in counts["latency_s"].values()) == 13


def test_unreachable_floor_parks_then_rejects_as_jax():
    port, jax = _nodes()
    floor = np.full(A, 1 << 40, np.uint64)
    errs = []
    for node, req, err in ((port, query.ReadRequest, ConsistencyUnavailableError),
                           (jax, jserve.ReadRequest, JaxConsistencyUnavailableError)):
        node.serve_reads(req.reads([0]))  # builds the loop
        node._serve_loop.park_timeout_s = 0.03
        with pytest.raises(err) as ei:
            node.serve_reads(req.reads([0, 1], mode="ryw", require=floor))
        errs.append(ei.value)
    assert (errs[0].mode, errs[0].reason, str(errs[0])) == \
        (errs[1].mode, errs[1].reason, str(errs[1])) == \
        ("ryw", "not_visible", str(errs[1]))
    counts = port.serve_loop().counts()
    assert counts["park"] == {"ryw": 1} and counts["reject"] == {"ryw": 1}
    assert counts["park_wait_s"] == 0.0  # a rejected read served nothing


def test_frontier_rejects_before_a_frontier_forms_as_jax():
    port, jax = _nodes()
    with pytest.raises(ConsistencyUnavailableError) as mine:
        port.serve_reads(query.ReadRequest.reads([0], mode="frontier"))
    with pytest.raises(JaxConsistencyUnavailableError) as theirs:
        jax.serve_reads(jserve.ReadRequest.reads([0], mode="frontier"))
    assert (mine.value.mode, mine.value.reason, str(mine.value)) == \
        (theirs.value.mode, theirs.value.reason, str(theirs.value))
    assert mine.value.reason == "no_frontier"


@pytest.mark.parametrize("overlap", [True, False], ids=["overlapped", "serial"])
def test_serve_frames_match_jax(overlap):
    port, jax = _nodes(5)
    rng = np.random.RandomState(13)
    _write_both(port, jax, rng)
    ack = port.write_vv()
    frames = []
    for k in range(6):
        obj = rng.randint(0, N, 8)
        member = np.where(rng.rand(8) < 0.25, -1, 200 + rng.randint(0, 4, 8)).astype(np.int32)
        mode, require = [("eventual", None), ("ryw", ack), ("monotonic", port.read_token())][k % 3]
        frames.append(wire.encode_read_request(query.ReadRequest.reads(
            obj, member=member, mode=mode, require=require)))
    frames.append(wire.encode_read_request(query.ReadRequest.reads(
        [0], mode="ryw", require=np.full(A, 1 << 40, np.uint64))))
    frames.append(wire.encode_read_request(query.ReadRequest.reads([], mode="eventual")))
    outs = []
    for node in (port, jax):
        node.serve_reads((query if node is port else jserve).ReadRequest.reads([0]))
        node._serve_loop.park_timeout_s = 0.02
        outs.append(node._serve_loop.serve_frames(frames, overlap=overlap))
    (mine, stats), (theirs, jstats) = outs
    assert mine == theirs
    assert mine[-2] is None and all(f is not None for f in mine[:-2] + mine[-1:])
    for k in ("frames", "rows", "rejected", "pipeline"):
        assert stats[k] == jstats[k], k
    assert (stats["frames"], stats["rows"], stats["rejected"]) == (8, 48, 1)
    assert set(stats["stage_s"]) == {"decode", "serve", "encode"} and stats["e2e_s"] >= 0
    with pytest.raises(ValueError):
        serve.ServeLoop(port, depth=1)
    with pytest.raises(ValueError):
        jserve.ServeLoop(jax, depth=1)


class _SnapshotThenChange:
    """A node whose first ``batch`` read hands out the snapshot and then
    changes the real node (a drain of fresh writes, or a session with a
    peer) before the serve loop gathers from it."""

    def __init__(self, node, change):
        self.node, self.change = node, change
        self.stability, self.heat, self.try_drain = node.stability, node.heat, node.try_drain
        self.snapshot = None

    @property
    def batch(self):
        snap = self.node.batch
        if self.snapshot is None:
            self.snapshot = snap
            self.change()
        return snap


@pytest.mark.parametrize("change", ["drain", "session"])
def test_snapshot_read_returns_the_pre_change_frame(change):
    port, _ = _nodes(7)
    rng = np.random.RandomState(17)
    obj = np.arange(N)
    member = (200 + rng.randint(0, 4, N)).astype(np.int32)
    member[::3] = -1
    before = serve.gather(port.batch, obj, member=member)
    token = port.read_token()
    planes = [getattr(port.batch, f).clone() for f in PLANES]

    def drain():
        port.submit_writes(obj, np.maximum(member, 200), actor=3)

    def session():
        _, peer_planes = _planes(8)
        peer = SyncSession(OrswotBatch.from_numpy(*peer_planes, device="cpu"), PU, peer="n0")
        with port._busy:  # held as _run_session holds it
            mine = SyncSession(port.batch, PU, peer="p")
            ra, _ = sync_pair(mine, peer)
            assert ra.converged and ra.diverged > 0
            with port._lock:
                port._batch = mine.batch

    proxy = _SnapshotThenChange(port, {"drain": drain, "session": session}[change])
    frame = serve.ServeLoop(proxy).serve(query.ReadRequest.reads(obj, member=member))
    assert port.batch is not proxy.snapshot
    for f in FRAME_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(frame, f), getattr(before, f), err_msg=f)
    np.testing.assert_array_equal(frame.token, token)
    for f, p in zip(PLANES, planes):  # the snapshot was not written in place
        assert torch.equal(getattr(proxy.snapshot, f), p), f
    after = serve.gather(port.batch, obj, member=member)
    assert any(not np.array_equal(getattr(after, f), getattr(before, f))
               for f in ("val", "add_clock", "rm_clock"))


def test_concurrent_reads_and_writes_keep_ryw():
    """Reads on a thread while the main thread writes: every RYW read of
    an acknowledged write sees it, and no read is rejected."""
    port, _ = _nodes(9)
    rng = np.random.RandomState(19)
    acks, errors = queue.Queue(), []

    def reader():
        try:
            while True:
                item = acks.get(timeout=60)
                if item is None:
                    return
                obj, member, ack = item
                frame = port.serve_reads(query.ReadRequest.reads(obj, member=member,
                                                                 mode="ryw", require=ack))
                assert (frame.val == 1).all()
        except BaseException as e:  # re-raised below
            errors.append(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    for _ in range(8):
        obj = rng.randint(0, N, 4).astype(np.int64)
        member = (300 + rng.randint(0, 3, 4)).astype(np.int32)
        port.submit_writes(obj, member, actor=4)
        acks.put((obj, member, port.write_vv()))
    acks.put(None)
    t.join(timeout=60)
    assert not t.is_alive() and not errors
    assert port.serve_loop().counts()["admit"] == {"ryw": 8}
    assert port.serve_loop().counts()["reject"] == {}
