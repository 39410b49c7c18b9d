"""Parity of the port's durability layer (``crdt_tpu_torch.durable``) with
the JAX package's, on the CPU:

* WAL segments byte-equal (names and bytes) for the same op batches,
  ``split_frames``, a torn tail truncated loudly when a writer resumes,
  ``truncate_below`` and ``replay_frames(from_seq=)``;
* snapshot files byte-equal for the same batch, WAL sequence, version
  vector, watermark, parked ops, frontier and node id, each store loading
  the other's; every rejection reason of ``decode_snapshot`` raised,
  counted and recorded in both; retain and prune, the fallback past a
  generation torn by ``TornWriter``, all generations bad raising
  ``DurabilityError``, an empty store giving None;
* ``recover`` of a JAX directory and the JAX ``recover`` of a port
  directory (clean, a torn WAL tail, a corrupt frame): equal digests and
  equal ``RecoveryReport`` fields but ``wall_s``; ``recover(device="cuda")``
  without a card raising ``DeviceUnavailableError``;
* the JAX ``tests/test_durable.py`` node cases on port nodes: kill -9
  after a checkpoint, a crash mid-fold, a crash mid-checkpoint, and a
  three-node fleet whose killed node rejoins by delta sync alone.

The JAX side stays off ``crdt_tpu.native``; both process tags are
pinned.  Every join and receive has a timeout."""

import dataclasses
import os
import struct
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.durable import SnapshotStore as JaxSnapshotStore, WalWriter as JaxWalWriter
from crdt_tpu.durable import recover as jax_recover, replay_frames as jax_replay_frames
from crdt_tpu.durable import snapshot as jsnap
from crdt_tpu.durable import split_frames as jax_split_frames
from crdt_tpu.error import CheckpointFormatError as JaxCheckpointFormatError
from crdt_tpu.obs import events as jevents
from crdt_tpu.oplog.records import OpBatch as JaxOpBatch
from crdt_tpu.sync import digest as jdigest
from crdt_tpu.utils import tracing as jtracing
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CheckpointFormatError, CrdtConfig, CrdtError, DeviceUnavailableError, DurabilityError,
    OrswotBatch, Universe,
)
from crdt_tpu_torch.cluster import (
    ClusterNode, CrashPlan, GossipScheduler, InjectedCrash, Membership, TornWriter, arm_crashes,
    disarm_crashes, queue_pair,
)
from crdt_tpu_torch.durable import (
    Durability, SnapshotStore, WalWriter, recover, replay_frames, split_frames,
)
from crdt_tpu_torch.durable import snapshot as psnap
from crdt_tpu_torch.durable import wal as pwal
from crdt_tpu_torch.error import PeerUnavailableError
from crdt_tpu_torch.native import engine
from crdt_tpu_torch.obs import convergence, events
from crdt_tpu_torch.oplog import OpBatch, OpLog
from crdt_tpu_torch.sync import digest as pdigest
from crdt_tpu_torch.utils import serde
from crdt_tpu_torch.utils.testdata import random_orswot_arrays

torch.set_num_threads(1)
engine.set_threads(1)

N, A, M, D = 32, 8, 16, 4
KW = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=32)
JU, PU = JaxUniverse.identity(JaxConfig(**KW)), Universe.identity(CrdtConfig(**KW))
PROC_TAG = "d0ab1e"
JOIN_S = 60.0
REPORT_FIELDS = [f.name for f in dataclasses.fields(jax_recover.__globals__["RecoveryReport"])
                 if f.name != "wall_s"]


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


def _planes(seed=3, n=N):
    """Random planes with at most ``M // 2`` members a row, so writes fit."""
    clock, ids, dots, d_ids, d_clocks = random_orswot_arrays(
        np.random.RandomState(seed), n, A, M // 2, D, max_counter=20, deferred_frac=0.25)
    pad = M - ids.shape[1]
    return (clock, np.pad(ids, ((0, 0), (0, pad)), constant_values=-1),
            np.pad(dots, ((0, 0), (0, pad), (0, 0))), d_ids, d_clocks)


def _both(seed=3, n=N):
    planes = _planes(seed, n)
    return (JaxOrswotBatch(*(jnp.asarray(x) for x in planes)),
            OrswotBatch.from_numpy(*planes, device="cpu"))


def _ops(obj, member, counter=1, actor=0, jax=False):
    obj = np.atleast_1d(np.asarray(obj, np.int64))
    cls = JaxOpBatch if jax else OpBatch
    return cls(kind=np.zeros(obj.shape[0], np.uint8), obj=obj,
               actor=np.full(obj.shape[0], actor, np.int32),
               counter=np.full(obj.shape[0], counter, np.uint64),
               member=np.atleast_1d(np.asarray(member)).astype(np.int32))


def _files(path):
    return {name: (path / name).read_bytes() for name in sorted(os.listdir(path))}


def _jdigest(batch, uni=JU):
    return np.asarray(jdigest.digest_of(batch, uni), np.uint64)


def _pdigest(batch, uni=PU):
    return np.asarray(pdigest.digest_of(batch, uni), np.uint64)


# -- the WAL ---------------------------------------------------------------------------


def _wal_ops(i):
    return [i % N, (i * 7) % N], [30 + i, 40 + i], 90 + i, i % A


@pytest.mark.parametrize("segment_bytes", [1, 64, 4 << 20])
def test_wal_segments_equal_and_replay(tmp_path, segment_bytes):
    jw = JaxWalWriter(tmp_path / "jax", segment_bytes=segment_bytes)
    pw = WalWriter(tmp_path / "port", segment_bytes=segment_bytes)
    for i in range(6):
        obj, mem, c, a = _wal_ops(i)
        assert pw.append(_ops(obj, mem, c, a)) == jw.append(_ops(obj, mem, c, a, jax=True)) == i
    assert pw.head_seq == jw.head_seq == 6
    assert pw.pending() == jw.pending()
    jw.close()
    pw.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert pw.counts()["frames"] == 6
    for from_seq in (0, 4, 6):
        assert list(replay_frames(tmp_path / "port", from_seq=from_seq)) == \
            list(jax_replay_frames(tmp_path / "jax", from_seq=from_seq))
    data = b"".join(f for _, f in replay_frames(tmp_path / "port"))
    for cut in (0, 5, 23, len(data) - 9):
        assert split_frames(data[:cut]) == jax_split_frames(data[:cut])


def test_wal_torn_tail_resumes_loudly_in_both(tmp_path):
    for pkg, cls, ops in (("jax", JaxWalWriter, True), ("port", WalWriter, False)):
        w = cls(tmp_path / pkg)
        for i in range(3):
            w.append(_ops([i], [i], counter=1 + i, jax=ops))
        w.close()
        (seg,) = (tmp_path / pkg).iterdir()
        seg.write_bytes(seg.read_bytes()[:-9])  # tear the last frame
    torn_j, torn_p = jtracing.counters().get("durable.wal.torn", 0), pwal.torn_count()
    assert [s for s, _ in replay_frames(tmp_path / "port")] == [0, 1]
    assert [s for s, _ in jax_replay_frames(tmp_path / "jax")] == [0, 1]
    assert pwal.torn_count() == torn_p + 1
    assert jtracing.counters().get("durable.wal.torn", 0) == torn_j + 1
    w2, jw2 = WalWriter(tmp_path / "port"), JaxWalWriter(tmp_path / "jax")
    assert w2.head_seq == jw2.head_seq == 2
    assert w2.append(_ops([9], [9])) == jw2.append(_ops([9], [9], jax=True)) == 2
    w2.close()
    jw2.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert events.recorder().snapshot("durable.wal_torn")[-1]["fields"]["frames_kept"] == 2


def test_wal_truncate_below_in_both(tmp_path):
    for pkg, cls, ops in (("jax", JaxWalWriter, True), ("port", WalWriter, False)):
        w = cls(tmp_path / pkg, segment_bytes=1)  # one frame per segment
        for i in range(4):
            w.append(_ops([i], [i], jax=ops))
        w.roll()
        assert w.truncate_below(3) == 3
        w.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert [s for s, _ in replay_frames(tmp_path / "port")] == [3]


def test_wal_refuses_to_append_behind_a_torn_segment(tmp_path):
    w = WalWriter(tmp_path, segment_bytes=1)
    w.append(_ops([0], [0]))
    w.roll()
    (tmp_path / "wal-0000000001.log").write_bytes(b"x")  # a torn segment at the head
    with pytest.raises(DurabilityError, match="run recovery first"):
        w.append(_ops([1], [1]))


# -- the snapshot store -----------------------------------------------------------------


def _snap_args(jax):
    frontier = np.arange(A, dtype=np.uint64) + 3
    return dict(wal_seq=17, watermark=np.arange(A, dtype=np.uint64),
                parked=_ops([0, 1], [7, 8], counter=50, jax=jax), frontier=frontier,
                node_id="n0")


def test_snapshot_files_equal_and_cross_load(tmp_path):
    jb, pb = _both()
    jsnap_ = JaxSnapshotStore(tmp_path / "jax").write(jb, JU, **_snap_args(True))
    psnap_ = SnapshotStore(tmp_path / "port").write(pb, PU, **_snap_args(False))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert (psnap_.generation, psnap_.root, psnap_.nbytes) == \
        (jsnap_.generation, jsnap_.root, jsnap_.nbytes)
    np.testing.assert_array_equal(psnap_.vv, jsnap_.vv)
    np.testing.assert_array_equal(psnap_.digests, _jdigest(jb))
    assert set(psnap_.split_s) >= {"digest", "to_numpy", "npz", "crc", "write_fsync",
                                   "rename_fsync"}
    # each store loads the other's file
    got = SnapshotStore(tmp_path / "jax").load_latest(device="cpu")
    want = JaxSnapshotStore(tmp_path / "port").load_latest()
    for a, b in ((got, want), (psnap_, jsnap_)):
        assert (a.generation, a.wal_seq, a.root, a.node_id) == \
            (b.generation, b.wal_seq, b.root, b.node_id)
        for f in ("vv", "watermark", "frontier"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        for f in ("kind", "obj", "actor", "counter", "member"):
            np.testing.assert_array_equal(getattr(a.parked, f), getattr(b.parked, f))
    for g, f in zip(got.batch.to_numpy(), ("clock", "ids", "dots", "d_ids", "d_clocks")):
        np.testing.assert_array_equal(g, np.asarray(getattr(want.batch, f)), err_msg=f)
    np.testing.assert_array_equal(_pdigest(got.batch, got.universe),
                                  _jdigest(want.batch, want.universe))
    assert set(got.split_s) >= {"read", "crc", "decode", "h2d", "root_verify"}


def _forge_root(data, head):
    meta = serde.from_binary(data[head:])
    meta["root"] = int(meta["root"]) ^ 1
    return meta


def _envelope(meta):
    payload = serde.to_binary(meta)
    return psnap.SNAPSHOT_MAGIC + psnap._HEADER.pack(1, psnap.FRAME_SNAPSHOT,
                                                       zlib.crc32(payload), len(payload)) + payload


def _corrupt(data, reason):
    head = len(psnap.SNAPSHOT_MAGIC) + psnap._HEADER.size
    data = bytearray(data)
    if reason == "truncated":
        return bytes(data[:10])
    if reason == "bad_magic":
        data[:4] = b"XXXX"
    elif reason == "version_mismatch":
        data[len(psnap.SNAPSHOT_MAGIC)] = 2
    elif reason == "unknown_type":
        data[len(psnap.SNAPSHOT_MAGIC) + 1] = 0x42
    elif reason == "length_mismatch":
        return bytes(data[:len(data) // 2])
    elif reason == "crc_mismatch":
        data[-1] ^= 0xFF
    elif reason == "bad_payload":
        return _envelope(42)
    elif reason == "bad_checkpoint":
        meta = serde.from_binary(bytes(data[head:]))
        meta["checkpoint"] = b"garbage-not-a-zip"
        return _envelope(meta)
    elif reason == "root_mismatch":
        return _envelope(_forge_root(bytes(data), head))
    elif reason == "bad_parked":
        meta = serde.from_binary(bytes(data[head:]))
        meta["parked"] = b"\x01\x31" + bytes(20)
        return _envelope(meta)
    return bytes(data)


REASONS = ("truncated", "bad_magic", "version_mismatch", "unknown_type", "length_mismatch",
           "crc_mismatch", "bad_payload", "bad_checkpoint", "root_mismatch", "bad_parked")


@pytest.mark.parametrize("reason", REASONS)
def test_every_rejection_raised_counted_and_recorded_in_both(tmp_path, reason):
    jb, pb = _both()
    SnapshotStore(tmp_path).write(pb, PU, **_snap_args(False))
    path = SnapshotStore(tmp_path).path_of(1)
    bad = _corrupt(open(path, "rb").read(), reason)
    jbefore = jtracing.counters().get(f"durable.snapshot.rejected.{reason}", 0)
    pbefore = psnap.snapshot_counts()["rejected"].get(reason, 0)
    with pytest.raises(JaxCheckpointFormatError) as jei:
        jsnap.decode_snapshot(bad)
    with pytest.raises(CheckpointFormatError) as pei:
        psnap.decode_snapshot(bad, device="cpu")
    assert isinstance(pei.value, CrdtError) and isinstance(pei.value, ValueError)
    assert str(pei.value).split(":")[0] == str(jei.value).split(":")[0]
    assert jtracing.counters().get(f"durable.snapshot.rejected.{reason}", 0) == jbefore + 1
    assert psnap.snapshot_counts()["rejected"].get(reason, 0) == pbefore + 1
    for rec in (events.recorder(), jevents.recorder()):
        assert rec.snapshot("durable.snapshot_rejected")[-1]["fields"]["reason"] == reason


def test_retain_prune_and_fallback_past_a_torn_generation(tmp_path):
    jb, pb = _both()
    store = SnapshotStore(tmp_path / "a", retain=2)
    for seq in (1, 2, 3, 4):
        store.write(pb, PU, wal_seq=seq)
    assert store.generations() == [3, 4]
    assert store.wal_floor() == 3
    assert store.load_latest(device="cpu").wal_seq == 4
    # a torn second write in both packages: the same torn file, and both
    # fall back to generation 1
    from crdt_tpu.cluster.faults import TornWriter as JaxTornWriter

    pw = TornWriter(psnap.default_writer, at_write=2, keep_frac=0.4)
    jw = JaxTornWriter(jsnap.default_writer, at_write=2, keep_frac=0.4)
    pstore = SnapshotStore(tmp_path / "port", retain=3, writer=pw)
    jstore = JaxSnapshotStore(tmp_path / "jax", retain=3, writer=jw)
    for seq in (1, 2):
        pstore.write(pb, PU, wal_seq=seq)
        jstore.write(jb, JU, wal_seq=seq)
    assert pw.injected == jw.injected == 1 and pw.calls == 2
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    fallbacks = psnap.snapshot_counts()["fallbacks"]
    assert pstore.load_latest(device="cpu").generation == jstore.load_latest().generation == 1
    assert psnap.snapshot_counts()["fallbacks"] == fallbacks + 1
    assert events.recorder().snapshot("durable.snapshot_fallback")[-1]["fields"][
        "generation"] == 2


def test_all_bad_raises_and_empty_store_gives_none(tmp_path):
    store = SnapshotStore(tmp_path / "bad", retain=3)
    store.write(_both()[1], PU)
    for path in (tmp_path / "bad").iterdir():
        path.write_bytes(b"not a snapshot")
    with pytest.raises(DurabilityError) as ei:
        store.load_latest(device="cpu")
    assert not isinstance(ei.value, ValueError)
    empty = SnapshotStore(tmp_path / "empty")
    assert empty.load_latest(device="cpu") is None
    (tmp_path / "empty" / "snap-0000000001.crdtsnap.tmp").write_bytes(b"half")
    assert empty.load_latest(device="cpu") is None and empty.generations() == []


# -- recovery -----------------------------------------------------------------------------


def _durable_dir(path, jax, wal_fault):
    """A node directory: a snapshot at WAL sequence 2 with two parked ops,
    then five frames (two below the sequence, one duplicate, one that
    closes a parked op's gap, one that parks), with a torn tail or a
    corrupt frame when asked."""
    jb, pb = _both(seed=11)
    store = (JaxSnapshotStore if jax else SnapshotStore)(path / "snapshots")
    parked = _ops([4, 5], [60, 61], counter=80, actor=2, jax=jax)
    store.write(jb if jax else pb, JU if jax else PU, wal_seq=2, parked=parked,
                watermark=np.zeros(A, np.uint64), node_id="n7")
    wal = (JaxWalWriter if jax else WalWriter)(path / "wal")
    clock = np.asarray(jb.clock)
    for i, (obj, actor) in enumerate([(0, 1), (1, 1), (2, 3), (4, 2), (6, 4)]):
        counter = int(clock[obj, actor]) + (1 if i != 3 else 80 - int(clock[obj, actor]) - 1)
        if i == 4:
            counter += 5  # a causal gap: parks
        wal.append(_ops([obj], [50 + i], counter=counter, actor=actor, jax=jax))
    wal.append(_ops([2], [52], counter=int(clock[2, 3]) + 1, actor=3, jax=jax))  # duplicate
    wal.close()
    (seg,) = (path / "wal").iterdir()
    data = seg.read_bytes()
    if wal_fault == "torn":
        seg.write_bytes(data[:-5])
    elif wal_fault == "corrupt":
        frames, _ = split_frames(data)
        at = sum(len(f) for f in frames[:4])
        data = bytearray(data)
        data[at + 20] ^= 0xFF
        seg.write_bytes(bytes(data))


@pytest.mark.parametrize("wal_fault", ["clean", "torn", "corrupt"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recover_across_packages(tmp_path, writer, wal_fault):
    _durable_dir(tmp_path, writer == "jax", wal_fault)
    rec = recover(tmp_path, device="cpu")
    jrec = jax_recover(tmp_path)
    for f in REPORT_FIELDS:
        assert getattr(rec.report, f) == getattr(jrec.report, f), f
    assert rec.report.wall_s > 0
    np.testing.assert_array_equal(_pdigest(rec.batch, rec.universe),
                                  _jdigest(jrec.batch, jrec.universe))
    np.testing.assert_array_equal(rec.vv, jrec.vv)
    np.testing.assert_array_equal(rec.watermark, jrec.watermark)
    assert len(rec.applier.parked) == len(jrec.applier.parked) == rec.report.parked_ops
    assert rec.report.replayed_frames == {"clean": 4, "torn": 3, "corrupt": 2}[wal_fault]
    assert rec.report.rejected_frames == (wal_fault == "corrupt")
    assert set(rec.split_s) >= {"read", "crc", "decode", "h2d", "root_verify", "replay"}
    kinds = [e["kind"] for e in events.recorder().snapshot()]
    assert kinds[-1] == "durable.recovery"


def test_recover_empty_dir_and_the_card_default(tmp_path, monkeypatch):
    assert recover(tmp_path, device="cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="cuda"):
        recover(tmp_path)


# -- the node ---------------------------------------------------------------------------


def _node(path, name="n0", batch=None, **kw):
    batch = _both()[1] if batch is None else batch
    return ClusterNode(name, batch, PU, oplog=OpLog(PU), durability=Durability(path), **kw)


def _members(batch, obj):
    return set(int(x) for x in batch.ids[obj].tolist() if x >= 0)


def test_node_kill9_after_checkpoint_recovers_digest_identical(tmp_path):
    node = _node(tmp_path)
    node.submit_writes([0, 1, 2], [100, 101, 102], actor=1)
    snap = node.checkpoint()
    assert snap is not None and snap.generation == 1 and node.last_snapshot.batch is None
    assert {"drain", "wal_roll_truncate"} <= set(snap.split_s)
    node.submit_writes([3, 4], [200, 201], actor=2)  # in the WAL only
    want = node.digest()
    counts = node.durability.counts()
    assert counts["snapshots"] == 1 and counts["wal_frames"] == 2
    assert node.durability.snapshot()["wal_depth"] == 1  # the segment after the roll
    rec = recover(tmp_path, device="cpu")
    assert rec.report.replayed_ops >= 2 and rec.report.wall_s > 0
    np.testing.assert_array_equal(_pdigest(rec.batch, rec.universe), want)


def test_node_mid_fold_crash_recovers_the_drained_ops(tmp_path):
    node = _node(tmp_path)
    node.checkpoint()
    arm_crashes(CrashPlan(at={"oplog.fold": 1}))
    try:
        with pytest.raises(InjectedCrash):
            node.submit_writes([0, 5], [150, 151], actor=1)
    finally:
        disarm_crashes()
    rec = recover(tmp_path, device="cpu")
    assert rec.report.replayed_ops == 2
    assert 150 in _members(rec.batch, 0) and 151 in _members(rec.batch, 5)


def test_mid_checkpoint_crash_keeps_the_previous_generation(tmp_path):
    node = _node(tmp_path)
    node.submit_writes([0], [100], actor=1)
    node.checkpoint()
    node.submit_writes([1], [110], actor=1)
    want = node.digest()
    arm_crashes(CrashPlan(at={"durable.snapshot.pre_rename": 1}))
    try:
        with pytest.raises(InjectedCrash):
            node.checkpoint()
    finally:
        disarm_crashes()
    rec = recover(tmp_path, device="cpu")
    assert rec.report.generation == 1
    np.testing.assert_array_equal(_pdigest(rec.batch, rec.universe), want)


def _mesh(nodes, threads):
    """Schedulers over queue links on a mutable node list: dialing a slot
    whose node is None fails like a dead host."""
    def make_dialer(i):
        def dial(peer):
            j = int(peer.peer_id[1:])
            if nodes[j] is None:
                raise PeerUnavailableError(f"n{j} is down (killed)")
            ta, tb = queue_pair(default_timeout=10.0)

            def serve(target=nodes[j], label=f"n{i}"):
                try:
                    target.accept(tb, peer_id=label)
                except Exception:  # noqa: BLE001 - the dialer's leg reports it
                    pass
                finally:
                    tb.close()

            t = threading.Thread(target=serve, daemon=True)
            threads.append(t)
            t.start()
            return ta
        return dial

    scheds = []
    for i in range(len(nodes)):
        m = Membership(suspect_after=3, dead_after=8)
        for j in range(len(nodes)):
            if j != i:
                m.add(f"n{j}")
        scheds.append(GossipScheduler(nodes[i], m, make_dialer(i), fanout=2,
                                      session_timeout_s=30.0, seed=i))
    return scheds


def test_fleet_kill9_rejoin_converges_by_delta_sync_alone(tmp_path):
    convergence.tracker().reset()
    threads = []
    try:
        base = _both(seed=7)[1]
        nodes = [_node(tmp_path / f"n{i}", f"n{i}", base, busy_timeout_s=5.0)
                 for i in range(3)]
        scheds = _mesh(nodes, threads)

        def converge(max_sweeps=8):
            reports = []
            for _ in range(max_sweeps):
                for i, sched in enumerate(scheds):
                    if nodes[i] is not None:
                        reports += list(sched.run_round().reports.values())
                ds = [n.digest() for n in nodes if n is not None]
                if all(np.array_equal(ds[0], d) for d in ds[1:]):
                    return reports
            raise AssertionError("no convergence within the sweep budget")

        nodes[1].submit_writes([0, 1, 2, 3], [300, 301, 302, 303], actor=2)
        converge()
        assert nodes[1].last_snapshot is not None  # the round-end checkpoints ran
        # kill -9 node 1 inside its fold, after its WAL took the writes
        arm_crashes(CrashPlan(at={"oplog.fold": 1}))
        try:
            with pytest.raises(InjectedCrash):
                nodes[1].submit_writes([4, 5], [310, 311], actor=2)
        finally:
            disarm_crashes()
        nodes[1] = None
        nodes[0].submit_writes([6, 7], [320, 321], actor=1)
        converge()

        rec = recover(tmp_path / "n1", device="cpu")
        assert rec.report.replayed_ops >= 2
        nodes[1] = ClusterNode("n1", rec.batch, rec.universe, busy_timeout_s=5.0,
                               oplog=OpLog(rec.universe), applier=rec.applier,
                               durability=Durability(tmp_path / "n1"))
        scheds[1:2] = [_mesh(nodes, threads)[1]]
        reports = converge()
        assert reports and not any(r.full_state_fallback or r.full_bytes_sent for r in reports)
        batch = nodes[1].batch
        assert {310, 300} <= _members(batch, 4) | _members(batch, 0)
        assert 311 in _members(batch, 5)
        assert 320 in _members(batch, 6) and 321 in _members(batch, 7)
    finally:
        for t in threads:
            t.join(timeout=JOIN_S)
        convergence.tracker().reset()
    assert not any(t.is_alive() for t in threads)


def test_struct_header_matches_the_op_frame_envelope():
    assert pwal._FRAME_HEADER.format == struct.Struct("<BBIQ").format
