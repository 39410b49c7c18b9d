"""Parity of the port's occupancy and causal GC (``crdt_tpu_torch.batch.
occupancy``, ``crdt_tpu_torch.gc``) with the JAX package, on the CPU,
exact: ``occupancy_of`` for every dense type, ``settle_orswot``'s planes
and stats, ``shrink_plan``/``repack_orswot``, ``truncate_orswot``,
``witnessed_ops_mask`` and the op-log and park-buffer compaction, the
four watermark cases of the JAX GC tests with injected clocks,
``GcEngine.collect`` on the same inputs as the JAX engine, and the GC
property: a GC'd replica joined with any peer gives the digests of the
never-GC'd join."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.map_batch import MapBatch as JaxMapBatch
from crdt_tpu.batch.occupancy import occupancy_of as jax_occupancy_of
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.batch.val_kernels import MVRegKernel as JaxMVRegKernel
from crdt_tpu.batch.vclock_batch import VClockBatch as JaxVClockBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.gc import GcEngine as JaxGcEngine, GcPolicy as JaxGcPolicy
from crdt_tpu.gc.watermark import FleetWatermark as JaxFleetWatermark
from crdt_tpu.gc import compact as jax_compact, repack as jax_repack
from crdt_tpu.obs import convergence as jax_convergence, metrics as jax_metrics
from crdt_tpu.obs.capacity import WATERMARK_STATES as JAX_WATERMARK_STATES
from crdt_tpu.oplog import OpApplier as JaxOpApplier, OpBatch as JaxOpBatch, OpLog as JaxOpLog
from crdt_tpu.parallel import JoinExecutor as JaxJoinExecutor
from crdt_tpu.scalar.ctx import RmCtx as JaxRmCtx
from crdt_tpu.scalar.orswot import Orswot as JaxOrswot
from crdt_tpu.sync import digest as jax_digest
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import from_binary as jax_from_binary
from crdt_tpu_torch import (
    CrdtConfig, FleetWatermark, GcEngine, GcPolicy, GCounterBatch, JoinExecutor, MapBatch,
    MapKernel, MVRegKernel, OrswotBatch, PNCounterBatch, Universe, VClockBatch,
)
from crdt_tpu_torch.batch.occupancy import occupancy_of
from crdt_tpu_torch.gc import compact, repack
from crdt_tpu_torch.obs import convergence
from crdt_tpu_torch.obs.capacity import WATERMARK_STATES
from crdt_tpu_torch.oplog import OpApplier, OpBatch, OpLog
from crdt_tpu_torch.sync import digest
from crdt_tpu_torch.utils.serde import to_binary
from crdt_tpu_torch.utils.testdata import random_map, random_orswot_arrays

torch.set_num_threads(1)

A, M, D = 8, 8, 4
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")


def _unis(bits=32):
    kw = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=bits)
    return JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))


def _np(jb):
    return tuple(np.asarray(getattr(jb, p)) for p in PLANES)


def _port(jb):
    return OrswotBatch.from_numpy(*_np(jb), device="cpu")


def _same(pb, jb):
    for name, g, w in zip(PLANES, pb.to_numpy(), _np(jb)):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _random_replicas(seed, n_objects=12, n_replicas=3):
    """The JAX GC tests' seeded op histories: a shared prefix, per-replica
    adds and removes, and removes witnessed by a peer's clock (deferred
    rows); the JAX batches and the port's."""
    rng = np.random.RandomState(seed)
    juni, _ = _unis()
    fleets = []
    for _ in range(n_replicas):
        row = []
        for i in range(n_objects):
            s = JaxOrswot()
            for j in range((i % 3) + 1):
                s.apply(s.add((i * 7 + j) % 11, s.value().derive_add_ctx(0)))
            row.append(s)
        fleets.append(row)
    for r in range(n_replicas):
        for _ in range(n_objects * 2):
            s = fleets[r][int(rng.randint(n_objects))]
            if rng.rand() < 0.7:
                s.apply(s.add(int(rng.randint(20, 40)), s.value().derive_add_ctx(r + 1)))
            else:
                read = s.value()
                if read.val:
                    m = sorted(read.val)[int(rng.randint(len(read.val)))]
                    s.apply(s.remove(m, s.contains(m).derive_rm_ctx()))
    for r in range(n_replicas):
        for _ in range(n_objects // 2):
            i = int(rng.randint(n_objects))
            peer = fleets[(r + 1) % n_replicas][i]
            target = sorted(peer.value().val)
            if not target:
                continue
            m = target[int(rng.randint(len(target)))]
            fleets[r][i].apply(fleets[r][i].remove(m, JaxRmCtx(
                clock=peer.value().add_clock.clone())))
    jbs = [JaxOrswotBatch.from_scalar(row, juni, via_device=False) for row in fleets]
    return jbs, [_port(jb) for jb in jbs]


def _dominated_planes(seed, bits=32, n=24):
    """Random planes plus deferred rows the object's clock dominates
    (what a replica holds right after ingesting settled state)."""
    rng = np.random.RandomState(seed)
    dt = np.uint32 if bits == 32 else np.uint64
    clock, ids, dots, d_ids, d_clocks = random_orswot_arrays(rng, n, A, M, D, dtype=dt,
                                                            deferred_frac=0.5)
    rows = np.nonzero((d_ids[:, -1] == -1) & (ids[:, 0] != -1))[0][::2]
    d_ids[rows, -1] = ids[rows, 0]
    d_clocks[rows, -1] = clock[rows]  # dominated: replayed and cleared
    d_ids[rows[:2], 0] = d_ids[rows[:2], -1]  # an exact duplicate row
    d_clocks[rows[:2], 0] = d_clocks[rows[:2], -1]
    return clock, ids, dots, d_ids, d_clocks


# -- occupancy -----------------------------------------------------------------------


def _occ(o):
    return dataclasses.asdict(o)


@pytest.mark.parametrize("bits", [32, 64])
def test_occupancy_of_orswot_matches_jax(bits):
    planes = _dominated_planes(1, bits)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    pb = OrswotBatch.from_numpy(*planes, device="cpu")
    assert _occ(occupancy_of(pb)) == _occ(jax_occupancy_of(jb))
    grown = pb.with_capacity(4 * M, 2 * D)
    assert _occ(occupancy_of(grown)) == _occ(jax_occupancy_of(jb.with_capacity(4 * M, 2 * D)))


@pytest.mark.parametrize("bits", [32, 64])
def test_occupancy_of_counters_match_jax(bits):
    rng = np.random.RandomState(bits)
    dt = np.uint32 if bits == 32 else np.uint64
    planes = (rng.rand(20, 2, A) < 0.3) * rng.randint(1, 9, size=(20, 2, A))
    planes[3] = 0
    planes = planes.astype(dt)
    pairs = ((PNCounterBatch.from_numpy(planes, device="cpu"),
              JaxPNCounterBatch(planes=jnp.asarray(planes))),
             (GCounterBatch.from_numpy(planes[:, 0], device="cpu"),
              JaxGCounterBatch(clocks=jnp.asarray(planes[:, 0]))),
             (VClockBatch.from_numpy(planes[:, 1], device="cpu"),
              JaxVClockBatch(clocks=jnp.asarray(planes[:, 1]))))
    for pb, jb in pairs:
        assert _occ(occupancy_of(pb)) == _occ(jax_occupancy_of(jb))
    with pytest.raises(TypeError, match="no occupancy"):
        occupancy_of(object())


def test_occupancy_of_map_matches_jax():
    rng = np.random.RandomState(2)
    maps = [random_map(rng, "mvreg", n_keys=5, n_actors=A) for _ in range(20)]
    kw = dict(num_actors=A, key_capacity=8, deferred_capacity=8, mv_capacity=8,
              member_capacity=M, counter_bits=32)
    juni, uni = JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    jb = JaxMapBatch.from_scalar([jax_from_binary(to_binary(m)) for m in maps], juni,
                                 JaxMVRegKernel.from_config(juni.config))
    pb = MapBatch.from_numpy(*jax.tree.map(np.asarray, jb.state),
                             MapKernel.from_config(uni.config, MVRegKernel.from_config(
                                 uni.config)), device="cpu")
    assert _occ(occupancy_of(pb)) == _occ(jax_occupancy_of(jb))


# -- compaction -------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [32, 64])
def test_settle_matches_jax(bits, monkeypatch):
    planes = _dominated_planes(3, bits)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    pb = OrswotBatch.from_numpy(*planes, device="cpu")
    jset, jstats = jax_compact.settle_orswot(jb)
    pset, pstats = compact.settle_orswot(pb)
    _same(pset, jset)
    assert pstats == jstats and pstats["tombstones_cleared"] > 0
    # five rows per row chunk: (M + D) * D * A cells a row
    monkeypatch.setattr(compact, "_SETTLE_CELLS", 5 * (M + D) * D * A)
    chunked, cstats = compact.settle_orswot(pb)
    _same(chunked, jset)
    assert cstats == jstats
    # settle == plunger: the unsettled twin's self-merge digests alike
    np.testing.assert_array_equal(digest.digest_of(pset.merge(pset)),
                                  digest.digest_of(pb.merge(pb)))


def test_shrink_plan_and_repack_match_jax():
    planes = _dominated_planes(4)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes)).with_capacity(64, 16)
    pb = OrswotBatch.from_numpy(*planes, device="cpu").with_capacity(64, 16)
    occ_p, occ_j = occupancy_of(pb), jax_occupancy_of(jb)
    for floors, hyst in (((8, 4), 0.5), ((4, 2), 0.5), ((4, 2), 0.25), ((64, 16), 0.5),
                         ((16, 4), 1.0)):
        kw = dict(member_floor=floors[0], deferred_floor=floors[1], hysteresis=hyst)
        assert repack.shrink_plan(occ_p, **kw) == jax_repack.shrink_plan(occ_j, **kw)
    with pytest.raises(ValueError, match="hysteresis"):
        repack.shrink_plan(occ_p, member_floor=8, deferred_floor=4, hysteresis=0.0)
    plan = repack.shrink_plan(occ_p, member_floor=8, deferred_floor=4)
    got, reclaimed = repack.repack_orswot(pb, *plan)
    want, want_reclaimed = jax_repack.repack_orswot(jb, *plan,
                                                    registry=jax_metrics.MetricsRegistry())
    _same(got, want)
    assert reclaimed == want_reclaimed > 0
    np.testing.assert_array_equal(digest.digest_of(got), digest.digest_of(pb))
    assert repack.repack_orswot(got, *plan) == (got, 0)
    with pytest.raises(ValueError, match="live rows"):
        repack.repack_orswot(got, 1, 4)
    with pytest.raises(ValueError, match="cannot grow"):
        repack.repack_orswot(got, 2 * plan[0], 4)


@pytest.mark.parametrize("bits", [32, 64])
def test_truncate_matches_jax(bits):
    planes = _dominated_planes(5, bits)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    pb = OrswotBatch.from_numpy(*planes, device="cpu")
    wm = np.asarray([20, 5, 0, 70, 1, 0, 33, 2], np.uint64)
    _same(compact.truncate_orswot(pb, wm), jax_compact.truncate_orswot(jb, wm))
    full = np.asarray(planes[0]) // 2
    _same(compact.truncate_orswot(pb, full), jax_compact.truncate_orswot(jb, full))


def _ops(cls, kind, obj, actor, counter, member):
    return cls(kind=np.asarray(kind, np.uint8), obj=np.asarray(obj, np.int64),
               actor=np.asarray(actor, np.int32), counter=np.asarray(counter, np.uint64),
               member=np.asarray(member, np.int32))


def _op_columns(seed, n_obj, b=200):
    rng = np.random.RandomState(seed)
    return ([0, 1, 2, 3, 4] * (b // 5), rng.randint(0, n_obj, size=b), rng.randint(0, A, size=b),
            rng.randint(1, 60, size=b), rng.randint(0, 40, size=b))


def test_witnessed_ops_and_buffer_compaction_match_jax():
    planes = _dominated_planes(6)
    clock = planes[0]
    cols = _op_columns(7, clock.shape[0])
    jops, pops = _ops(JaxOpBatch, *cols), _ops(OpBatch, *cols)
    biased = OrswotBatch.from_numpy(*planes, device="cpu").clock
    wm = np.asarray([30, 0, 59, 10, 60, 5, 1, 45], np.uint64)
    for w in (None, wm, wm[:5]):
        want = jax_compact.witnessed_ops_mask(jops, clock, w)
        np.testing.assert_array_equal(compact.witnessed_ops_mask(pops, clock, w), want)
        # a biased plane: only the cells the ops name are gathered and unbiased
        np.testing.assert_array_equal(compact.witnessed_ops_mask(pops, biased, w), want)
    assert compact.witnessed_ops_mask(OpBatch.empty(), clock).shape == (0,)
    juni, uni = _unis()
    jlog, plog = JaxOpLog(juni, capacity=1024), OpLog(uni, capacity=1024)
    jlog.append(jops)
    plog.append(pops)
    assert compact.compact_oplog(plog, biased, wm) == jax_compact.compact_oplog(jlog, clock, wm)
    assert len(plog) == len(jlog)
    for c, _ in (("kind", 0), ("obj", 0), ("counter", 0)):
        np.testing.assert_array_equal(getattr(plog.pending(), c), getattr(jlog.pending(), c))


def test_gap_buffer_compaction_matches_jax():
    juni, uni = _unis()
    japp, papp = JaxOpApplier(juni), OpApplier(uni)
    gapped = ([0, 0, 0], [0, 1, 1], [0, 2, 2], [9, 4, 7], [7, 8, 9])
    japp.apply_ops(JaxOrswotBatch.zeros(2, juni), _ops(JaxOpBatch, *gapped))
    papp.apply_ops(OrswotBatch.zeros(2, uni, device="cpu"), _ops(OpBatch, *gapped))
    assert len(papp.parked) == len(japp.parked) == 3
    closed = np.zeros((2, A), np.uint64)
    closed[0, 0], closed[1, 2] = 9, 5
    wm = np.full(A, 9, np.uint64)
    assert compact.compact_gap_buffer(papp, closed, wm) == jax_compact.compact_gap_buffer(
        japp, closed, wm)
    assert len(papp.parked) == len(japp.parked) == 1


# -- the watermark -----------------------------------------------------------------------


def _tracker(vvs, at=None):
    trk = convergence.ConvergenceTracker()
    for peer, vv in vvs.items():
        trk.observe_version_vector(peer, vv, at=at)
    return trk


class _Watermarks:
    """The JAX ``FleetWatermark`` and the port's over the same tracker
    contents (each vector observed at ``seen[peer]``, else at time 0) and
    one injected clock (``self.t``): every call runs on both, and each
    report is compared field by field (the JAX gauges for ``max_counter``
    and ``local_lag``)."""

    def __init__(self, vvs, seen=None, **kw):
        self.t = 0.0
        self.reg = jax_metrics.MetricsRegistry()
        jtrk = jax_convergence.ConvergenceTracker(self.reg)
        ptrk = convergence.ConvergenceTracker()
        for peer, vv in vvs.items():
            for trk in (jtrk, ptrk):
                trk.observe_version_vector(peer, vv, at=(seen or {}).get(peer, 0.0))
        self.jax = JaxFleetWatermark(jtrk, registry=self.reg, clock=lambda: self.t, **kw)
        self.port = FleetWatermark(ptrk, clock=lambda: self.t, **kw)

    def compute(self, local, peers=None):
        j = self.jax.compute(local, peers=peers)
        p = self.port.compute(local, peers=peers)
        gauges = self.reg.snapshot()["gauges"]
        assert p.clock.dtype == j.clock.dtype
        np.testing.assert_array_equal(p.clock, j.clock)
        for f in ("peers", "stale", "unheard", "excluded", "age_s", "frozen"):
            assert getattr(p, f) == getattr(j, f), f
        assert p.max_counter == gauges["gc.watermark.max_counter"]
        assert p.local_lag == gauges["gc.watermark.lag"] == j.lag(local)
        assert p.lag([12, 1, 30]) == j.lag([12, 1, 30])
        assert self.port._first_seen == self.jax._first_seen
        return p

    def restore(self, clock):
        self.jax.restore(clock)
        self.port.restore(clock)

    def forget(self, peer):
        self.jax.forget(peer)
        self.port.forget(peer)


def test_watermark_is_elementwise_min_including_local():
    wm = _Watermarks({"p1": [5, 2, 0], "p2": [3, 9, 1]})
    wm.t = 1.0
    report = wm.compute([4, 4, 4])
    assert report.clock.tolist() == [3, 2, 0]
    assert report.peers == 2 and not report.frozen
    assert report.max_counter == 3 and report.local_lag == 4
    # with a roster naming only heard peers, and with one naming a subset
    assert wm.compute([4, 4, 4], peers=["p1", "p2"]).clock.tolist() == [3, 2, 0]
    assert wm.compute([4, 4, 4], peers=["p1"]).peers == 2


def test_watermark_aligns_mixed_widths_by_implied_zero():
    wm = _Watermarks({"narrow": [7], "wide": [8, 8, 8, 8]})
    assert wm.compute([5, 6, 7]).clock.tolist() == [5, 0, 0, 0]
    assert wm.compute([9]).clock.tolist() == [7, 0, 0, 0]
    wm.restore([1, 2, 3, 4, 5])
    assert wm.compute([5, 6, 7]).clock.tolist() == [5, 2, 3, 4, 5]


def test_watermark_staleness_freezes_and_quarantine_excludes():
    wm = _Watermarks({"p1": [2, 2], "p2": [4, 1]}, seen={"p2": 40.0}, stale_after_s=10.0,
                     quarantine_s=100.0)
    for t, clock, stale, excluded in ((5.0, [2, 1], 0, 0), (45.0, [2, 1], 1, 0),
                                      (50.0, [2, 1], 1, 0), (120.0, [4, 1], 1, 1),
                                      (200.0, [9, 9], 0, 2)):
        wm.t = t
        r = wm.compute([9, 9])
        assert (r.clock.tolist(), r.stale, r.excluded) == (clock, stale, excluded), t
        assert r.frozen == bool(stale)
    assert r.peers == 0 and r.age_s == 0.0


def test_watermark_unheard_roster_peer_pins_zero_until_quarantined():
    wm = _Watermarks({"p1": [4, 4]}, stale_after_s=10.0, quarantine_s=60.0)
    r = wm.compute([9, 9], peers=["p1", "ghost"])
    assert r.clock.tolist() == [0, 0] and r.unheard == 1 and r.frozen
    wm.t = 30.0
    r = wm.compute([9, 9], peers=["p1", "ghost"])
    assert r.clock.tolist() == [0, 0] and r.unheard == 1 and r.stale == 1
    wm.t = 120.0
    r = wm.compute([9, 9], peers=["p1", "ghost"])
    assert r.unheard == 0 and r.excluded == 2 and r.clock.tolist() == [9, 9]
    # a restored floor only ever raises the minimum; forget drops the ghost,
    # which then counts as unheard again from its next sighting
    wm.restore([3, 12])
    wm.t = 130.0
    assert wm.compute([9, 9], peers=["ghost"]).clock.tolist() == [9, 12]
    wm.forget("ghost")
    r = wm.compute([9, 9], peers=["ghost"])
    assert r.unheard == 1 and r.clock.tolist() == [3, 12]
    wm.t = 200.0
    assert wm.compute([9, 9], peers=["ghost"]).excluded == 2
    for cls in (FleetWatermark, JaxFleetWatermark):
        with pytest.raises(ValueError, match="stale_after_s"):
            cls(stale_after_s=5.0, quarantine_s=1.0)


# -- the engine ----------------------------------------------------------------------------


def _jax_engine(vvs, **policy):
    reg = jax_metrics.MetricsRegistry()
    trk = jax_convergence.ConvergenceTracker(reg)
    for peer, vv in vvs.items():
        trk.observe_version_vector(peer, vv)
    return JaxGcEngine(JaxGcPolicy(**policy), tracker=trk, registry=reg)


def test_gc_engine_collect_matches_jax():
    juni, uni = _unis()
    planes = _dominated_planes(8)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes)).with_capacity(64, 16)
    pb = OrswotBatch.from_numpy(*planes, device="cpu").with_capacity(64, 16)
    vvs = {"p1": [40] * A, "p2": [30, 99, 99, 99, 99, 99, 99, 99]}
    cols = _op_columns(9, planes[0].shape[0], b=100)
    jlog, plog = JaxOpLog(juni, capacity=512), OpLog(uni, capacity=512)
    jlog.append(_ops(JaxOpBatch, *cols))
    plog.append(_ops(OpBatch, *cols))
    jeng = _jax_engine(vvs, interval_rounds=1)
    peng = GcEngine(GcPolicy(interval_rounds=1), tracker=_tracker(vvs))
    jout, jrep = jeng.collect(jb, universe=juni, oplog=jlog, applier=JaxOpApplier(juni),
                              peers=["p1", "p2"])
    pout, prep = peng.collect(pb, universe=uni, oplog=plog, applier=OpApplier(uni),
                              peers=["p1", "p2"])
    _same(pout, jout)
    np.testing.assert_array_equal(prep.watermark.clock, jrep.watermark.clock)
    for f in ("tombstones_cleared", "members_freed", "shrunk", "member_capacity",
              "deferred_capacity", "reclaimed_bytes", "oplog_ops_dropped", "skipped"):
        assert getattr(prep, f) == getattr(jrep, f), f
    assert prep.shrunk and prep.member_capacity == (64, M) and prep.oplog_ops_dropped > 0
    assert prep.reclaimed_bytes - prep.oplog_bytes_reclaimed == (
        sum(x.nbytes for x in pb.to_numpy()) - sum(x.nbytes for x in pout.to_numpy()))
    assert set(prep.seconds) == {"watermark", "settle", "repack", "op_buffers"}
    assert peng.runs == 1 and peng.total_reclaimed_bytes == prep.reclaimed_bytes
    assert peng.counts == {"tombstones_cleared": prep.tombstones_cleared,
                           "oplog_ops_dropped": prep.oplog_ops_dropped, "shrinks": 1}
    # other types: the watermark only
    g = GCounterBatch.from_numpy(np.ones((3, A), np.uint32), device="cpu")
    out, rep = peng.collect(g)
    assert out is g and rep.skipped and rep.watermark is not None
    with pytest.raises(ValueError, match="universe"):
        GcEngine(GcPolicy(), tracker=_tracker({})).collect(pb)


def test_gc_engine_due_cadence_and_utilization_trigger():
    class Capacity:
        state = "ok"

        def watermark(self):
            return {"state": self.state}

    cap = Capacity()
    for interval, trigger in ((3, "warn"), (1, None), (4, "critical"), (2, None)):
        jpol, ppol = (JaxGcPolicy(interval_rounds=interval, utilization_trigger=trigger),
                      GcPolicy(interval_rounds=interval, utilization_trigger=trigger))
        for tracker in (cap, None):
            jeng = JaxGcEngine(jpol, tracker=jax_convergence.ConvergenceTracker(
                jax_metrics.MetricsRegistry()), capacity_tracker=tracker,
                registry=jax_metrics.MetricsRegistry())
            peng = GcEngine(ppol, tracker=_tracker({}), capacity_tracker=tracker)
            for state in JAX_WATERMARK_STATES:
                cap.state = state
                for round_no in range(9):
                    assert peng.due(round_no) == jeng.due(round_no), (
                        interval, trigger, tracker, state, round_no)
    eng = GcEngine(GcPolicy(interval_rounds=3, utilization_trigger="warn"),
                   tracker=_tracker({}), capacity_tracker=cap)
    cap.state = "ok"
    assert eng.due(3) and eng.due(6) and not eng.due(1)
    cap.state = "warn"
    assert eng.due(1)
    assert WATERMARK_STATES == JAX_WATERMARK_STATES
    # the restored floor, against the JAX engine's, over an unheard ghost
    t = [0.0]
    jeng = JaxGcEngine(JaxGcPolicy(), tracker=jax_convergence.ConvergenceTracker(
        jax_metrics.MetricsRegistry()), registry=jax_metrics.MetricsRegistry(),
        clock=lambda: t[0])
    peng = GcEngine(GcPolicy(), tracker=_tracker({}), clock=lambda: t[0])
    for eng in (jeng, peng):
        eng.restore_watermark([5] * A)
    for now in (0.0, 400.0):
        t[0] = now
        want = jeng.watermark.compute([9] * A, peers=["ghost"])
        got = peng.watermark.compute([9] * A, peers=["ghost"])
        np.testing.assert_array_equal(got.clock, want.clock)
        assert (got.unheard, got.excluded) == (want.unheard, want.excluded)
    assert got.clock.tolist() == [9] * A and got.excluded == 1
    with pytest.raises(ValueError, match="interval_rounds"):
        GcPolicy(interval_rounds=0)
    with pytest.raises(ValueError, match="utilization_trigger"):
        GcPolicy(utilization_trigger="hot")


# -- the property ----------------------------------------------------------------------------


def _gc(pb, uni):
    eng = GcEngine(GcPolicy(interval_rounds=1), tracker=convergence.ConvergenceTracker())
    return eng.collect(pb, universe=uni)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gc_then_merge_matches_never_gcd_fleet(seed):
    """Compact any replica, merge it with any peer (compacted or not):
    the digests of the never-compacted merge, in the port and the JAX
    package alike."""
    _, uni = _unis()
    jbs, pbs = _random_replicas(seed)
    jbs[0], pbs[0] = jbs[0].with_capacity(32, 16), pbs[0].with_capacity(32, 16)
    join = JoinExecutor(strategy="sequential").join_all
    jjoin = JaxJoinExecutor(strategy="sequential").join_all
    for victim in range(len(pbs)):
        gcd, report = _gc(pbs[victim], uni)
        assert report.watermark is not None
        for peer_idx in range(len(pbs)):
            if peer_idx == victim:
                continue
            want = digest.digest_of(join([pbs[victim], pbs[peer_idx]]))
            np.testing.assert_array_equal(
                want, jax_digest.digest_of(jjoin([jbs[victim], jbs[peer_idx]])))
            for peer in (pbs[peer_idx], _gc(pbs[peer_idx], uni)[0]):
                np.testing.assert_array_equal(digest.digest_of(join([gcd, peer])), want)
        np.testing.assert_array_equal(digest.digest_of(gcd.merge(gcd)),
                                      digest.digest_of(pbs[victim].merge(pbs[victim])))
