"""Parity of the port's mesh layer (``crdt_tpu_torch.mesh``) and member
sharding across ranks with the JAX package's, on the CPU.

The JAX side runs in this process on the conftest's 8-device CPU mesh.
The port runs in gloo process groups of 1, 2, 4 and 8 ranks: one spawn
per world size (``tests/torch_rank_mesh.py``, which imports no JAX), world
1 in this process.  Rank ``r`` holds shards ``[r·S/W, (r+1)·S/W)``; its
rows must equal those rows of the JAX result bit for bit, and the
gathered results (digests, version vector, live members, shard roots,
logical planes, subset-sync stats and planes, raised errors) must equal
the JAX package's.  In this process: layouts and rebasing, heat-priced
granules, digest-invisible padding, the contract table against the JAX
manifest and the gate's typed refusals, shard-subset sync and the
``ClusterNode`` repair, the fleet snapshot files byte-equal to the JAX
package's with each package restoring the other's, every typed
rejection, and the published gauges and counts.  The tolerance is
bit-equality throughout.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from crdt_tpu import Dot, Orswot, mesh as jmesh
from crdt_tpu.analysis.kernels import MANIFEST
from crdt_tpu.batch import OrswotBatch as JOrswotBatch
from crdt_tpu.cluster import ClusterNode as JClusterNode
from crdt_tpu.config import CrdtConfig as JConfig
from crdt_tpu.error import (
    CheckpointFormatError as JCheckpointFormatError, DurabilityError as JDurabilityError,
)
from crdt_tpu.mesh import durable as jmesh_durable
from crdt_tpu.obs import metrics as jmetrics
from crdt_tpu.parallel.member_sharding import (
    member_sharded_merge as j_member_merge, partition_dense as j_partition,
    rebroadcast_clock as j_rebroadcast, sharded_apply_add as j_apply_add,
)
from crdt_tpu.parallel.mesh import make_mesh as j_make_mesh
from crdt_tpu.scalar.orswot import Add
from crdt_tpu.sync import digest as jdigest
from crdt_tpu.utils import tracing as jtracing
from crdt_tpu.utils.interning import Universe as JUniverse
from crdt_tpu_torch import CrdtConfig, OrswotBatch, Universe, mesh
from crdt_tpu_torch.cluster import ClusterNode
from crdt_tpu_torch.error import (
    CapacityOverflowError, CheckpointFormatError, DurabilityError, MeshContractError,
    PeerUnavailableError,
)
from crdt_tpu_torch.mesh import contracts, durable as mesh_durable, step as mesh_step
from crdt_tpu_torch.obs import metrics, publish
from crdt_tpu_torch.obs.stability import subtree_layout
from crdt_tpu_torch.parallel.mesh import tree_map
from crdt_tpu_torch.sync import digest as pdigest
from test_mesh import _history_batches, _with_extras

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
RANKS = HERE / "torch_rank_mesh.py"
WORLDS = (1, 2, 4, 8)
RANK_TIMEOUT_S = 120
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")
KW = dict(num_actors=8, member_capacity=16, deferred_capacity=8)
JU, PU = JUniverse.identity(JConfig(**KW)), Universe.identity(CrdtConfig(**KW))
# member sharding: 8 shards of 16 member slots over a logical 64
MKW = dict(num_actors=8, member_capacity=64, deferred_capacity=8)
MJU = JUniverse.identity(JConfig(**MKW))
STEP_N, STEP_GRANULE, SYNC_N, SYNC_ROWS = 48, 4, 40, (33, 34, 36)


@pytest.fixture(autouse=True, scope="module")
def _jax_off_native():
    """The JAX package off its native library: a port test never builds or
    loads it (its wire codec and scalarizer take their Python paths)."""
    import crdt_tpu.batch.wirebulk as jax_wirebulk
    import crdt_tpu.native.scalarize as jax_scalarize

    def refuse():
        raise RuntimeError("the JAX native library is not used by port tests")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wirebulk, "probe_engine", lambda *a, **k: None)
        mp.setattr(jax_scalarize, "load", refuse)
        yield


@pytest.fixture(autouse=True)
def _no_group():
    """A test that made a world of one leaves no process group behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def planes_of(b):
    return [np.asarray(getattr(b, f)) for f in PLANES]


def port(jb):
    return OrswotBatch.from_numpy(*planes_of(jb), device="cpu")


def same(got, want, what=""):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, what
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=what)


def pd(b, uni=PU):
    return np.asarray(pdigest.digest_of(b, uni), np.uint64)


def jd(b, uni=JU):
    return np.asarray(jdigest.digest_of(b, uni), np.uint64)


def mesh_deltas(before):
    return {k: v - before.get(k, 0) for k, v in mesh.mesh_counts().items()
            if v != before.get(k, 0)}


# -- layouts -------------------------------------------------------------------------------


@pytest.mark.parametrize("n,shards,kw", [
    (100, 4, {"granule": 16}), (100, 8, {}), (1, 1, {}), (4096, 8, {}), (40, 4, {"granule": 16}),
    (12, 8, {"granule": 2}), (4097, 2, {"span": 4}), (64, 2, {"granule": 64}),
])
def test_layout_bounds_and_rebase_match_jax(n, shards, kw):
    got, want = mesh.choose_layout(n, shards, **kw), jmesh.choose_layout(n, shards, **kw)
    assert got.to_json() == want.to_json()
    assert (got.bounds, got.ranges(), got.padded) == (want.bounds, want.ranges(), want.padded)
    ids = np.arange(n, dtype=np.int64)
    same(list(got.rebase(ids)), list(want.rebase(ids)))
    np.testing.assert_array_equal(got.unbase(*got.rebase(ids)), ids)
    for s, (lo, hi) in enumerate(got.ranges()):
        assert got.objects_of(s) == hi - lo
        for i in {lo, hi - 1} if hi > lo else ():
            assert got.shard_of(i) == want.shard_of(i) == s
    assert mesh.MeshLayout.from_json(json.loads(json.dumps(got.to_json()))) == got
    with pytest.raises(IndexError):
        got.rebase(np.array([n]))
    with pytest.raises(IndexError):
        got.shard_of(-1)


@pytest.mark.parametrize("bad", [0, 3, -16])
def test_bad_granules_and_sizes_raise_in_both(bad):
    for pkg in (mesh, jmesh):
        with pytest.raises(ValueError):
            pkg.choose_layout(100, 4, granule=bad)
    for args in ((0, 4), (10, 0)):
        for pkg in (mesh, jmesh):
            with pytest.raises(ValueError):
                pkg.choose_layout(*args)


def test_choose_layout_prices_granules_like_jax():
    """Heavy heat in the first subtree: the coarsest granule prices badly,
    and both packages pick the same finer one at the same imbalance."""
    n, rng = 64, np.random.RandomState(5)
    for hv in (np.r_[500.0, np.ones(3)], rng.rand(4) * 10, np.ones(4), np.r_[np.zeros(3), 9.0]):
        for shards in (2, 4, 8):
            got = mesh.choose_layout(n, shards, heat=hv)
            assert got.to_json() == jmesh.choose_layout(n, shards, heat=hv).to_json()
    assert mesh.choose_layout(n, 2, heat=np.r_[500.0, np.ones(3)]).granule < 64
    span = subtree_layout(n)[1]
    loads = mesh.shard_loads(mesh.choose_layout(n, 2, granule=8), hv, span)
    np.testing.assert_array_equal(loads, jmesh.shard_loads(
        jmesh.choose_layout(n, 2, granule=8), hv, span))
    assert float(loads.sum()) == pytest.approx(float(hv.sum()))


# -- the step ------------------------------------------------------------------------------


def test_padding_rows_are_digest_invisible():
    """Empty rows digest to 0, so the padding of 12 rows over 8 shards
    shows in no digest, shard root or tree root."""
    assert (pd(OrswotBatch.zeros(8, PU, device="cpu")) == 0).all()
    a, _ = _history_batches(12, JU)
    sa = mesh.ShardedBatch.shard(port(a), PU, shards=8, granule=2)
    assert sa.layout.padded > sa.layout.n and sa.device.clock.shape[0] == sa.layout.padded
    res = mesh.anti_entropy_step(sa, mesh.ShardedBatch.shard(port(a), PU, shards=8, granule=2))
    jres = jmesh.anti_entropy_step(*(jmesh.ShardedBatch.shard(a, JU, shards=8, granule=2)
                                     for _ in range(2)))
    np.testing.assert_array_equal(res.digests, jd(a))
    np.testing.assert_array_equal(res.digests, jres.digests)
    same(res.batch.device.to_numpy(), planes_of(jres.batch.device))
    with pytest.raises(ValueError):
        mesh.anti_entropy_step(sa, mesh.ShardedBatch.shard(port(a), PU, shards=4, granule=2))


def test_step_overflow_raises_like_jax():
    uni = JUniverse.identity(JConfig(num_actors=8, member_capacity=2, deferred_capacity=2))
    puni = Universe.identity(CrdtConfig(num_actors=8, member_capacity=2, deferred_capacity=2))
    fleets = []
    for r in range(2):
        row = []
        for i in range(4):
            o = Orswot()
            for m in (r * 2, r * 2 + 1) if i == 3 else (0,):
                o.apply(o.add(m, o.value().derive_add_ctx(r)))
            row.append(o)
        fleets.append(JOrswotBatch.from_scalar(row, uni))
    got = [mesh.ShardedBatch.shard(port(b), puni, shards=2, granule=2) for b in fleets]
    want = [jmesh.ShardedBatch.shard(b, uni, shards=2, granule=2) for b in fleets]
    with pytest.raises(Exception) as je:
        jmesh.anti_entropy_step(*want)
    with pytest.raises(CapacityOverflowError) as pe:
        mesh.anti_entropy_step(*got)
    assert (type(pe.value).__name__, pe.value.member, pe.value.deferred) == \
        (type(je.value).__name__, je.value.member, je.value.deferred)
    res = mesh.anti_entropy_step(*got, check=False)
    np.testing.assert_array_equal(res.digests, jmesh.anti_entropy_step(*want, check=False).digests)


# -- the contracts -------------------------------------------------------------------------


def test_contract_table_matches_the_manifest_row_by_row():
    rows = {s.name: s.sharding for s in MANIFEST if s.sharding is not None}
    table = mesh.contract_map()
    assert set(table) == {"parallel.shard_local_merge", "sync.digest.orswot",
                          "mesh.step.anti_entropy", "parallel.member_clock_join",
                          "parallel.member_apply_add"}
    assert set(table) <= set(jmesh.contract_map())
    for name, c in table.items():
        j = rows[name]
        assert (c.sclass, tuple(c.collectives), tuple(c.mesh_sizes), c.reason) == \
            (j.sclass, tuple(j.collectives), tuple(j.mesh_sizes), j.reason), name
    assert mesh.SHARDABLE_CLASSES == jmesh.SHARDABLE_CLASSES
    assert mesh.MESH_SIZES == jmesh.MESH_SIZES and mesh.MESH_AXIS == jmesh.MESH_AXIS


def test_step_consumes_its_declared_contracts():
    a, b = _history_batches(8, JU)
    mesh.anti_entropy_step(*(mesh.ShardedBatch.shard(port(x), PU, shards=2, granule=2)
                             for x in (a, b)))
    expected = set(mesh_step._SHARDED_KERNELS) | set(mesh_step._SHARD_LOCAL_KERNELS)
    assert expected == {"mesh.step.anti_entropy", "sync.digest.orswot",
                        "parallel.shard_local_merge"}
    consumed = mesh.consumed_contracts()
    assert expected <= consumed <= set(mesh.contract_map())
    for name in consumed:
        assert mesh.contract_map()[name].sclass in mesh.SHARDABLE_CLASSES


def test_contract_gate_refuses_with_typed_errors(monkeypatch):
    """Each refusal is a ``MeshContractError`` (a ``TypeError``) naming
    the kernel, counted once; a row of a refused class carries it.  A
    kernel with no port row is refused as one with no contract is."""
    replicated = next(s.sharding for s in MANIFEST if s.name == "obs.heat.sketch_update")
    monkeypatch.setitem(contracts._CONTRACTS, "obs.heat.sketch_update", contracts.ShardContract(
        replicated.sclass, tuple(replicated.collectives), tuple(replicated.mesh_sizes),
        replicated.reason))
    for name, size, sclass in (("obs.heat.sketch_update", 2, "replicated"),
                               ("parallel.shard_local_merge", 2, "pointwise"),
                               ("parallel.member_apply_add", 3, "pointwise"),
                               ("utils.benchtime.sync_probe", 1, ""), ("no.such.kernel", 1, "")):
        before = mesh.mesh_counts()
        jbefore = jtracing.counters()
        with pytest.raises(MeshContractError) as pe:
            mesh.require_shardable(name, size)
        with pytest.raises(TypeError) as je:
            jmesh.require_shardable(name, size)
        assert isinstance(pe.value, TypeError)
        assert (pe.value.kernel, pe.value.sclass) == (name, sclass)
        assert je.value.kernel == name and (je.value.sclass == sclass or not sclass)
        assert mesh_deltas(before) == {"contract_refused": 1}
        assert jtracing.counters_since(jbefore).get("mesh.contract.refused") == 1
        assert sclass == "pointwise" or name not in mesh.consumed_contracts()


# -- shard-subset sync ---------------------------------------------------------------------


def sync_stats(st):
    return (st.shards_synced, st.shards_skipped, st.objects, st.root_bytes, st.descent_bytes,
            st.delta_bytes, st.per_shard, st.object_ids.tolist())


@pytest.mark.parametrize("case", ["one_shard", "twins", "converged", "kill9_rejoin"])
def test_shard_subset_sync_matches_jax(case):
    """The stats and the merged planes of the same pair equal the JAX
    package's, and each repair pulls only its shard's rows."""
    n, granule, shards = SYNC_N, 16, 4
    a, _ = _history_batches(n, JU)
    if case == "one_shard":
        b = _with_extras(a, JU, n, SYNC_ROWS)
    elif case == "twins":
        n, granule = 32, 8
        a, _ = _history_batches(n, JU)
        row = [Orswot() for _ in range(n)]
        for i in (20, 21):  # one shard, the identical update
            row[i].apply(Add(dot=Dot(7, 9), member=9))
        b = a.merge(JOrswotBatch.from_scalar(row, JU))
    elif case == "converged":
        b = a
    else:
        b = _with_extras(a, JU, n, (2, 9, 21))
        granule = 8
    lay, jlay = mesh.choose_layout(n, shards, granule=granule), \
        jmesh.choose_layout(n, shards, granule=granule)
    before = mesh.mesh_counts()
    merged, st = mesh.shard_subset_sync(port(a), port(b), lay, PU)
    jmerged, jst = jmesh.shard_subset_sync(a, b, jlay, JU)
    assert sync_stats(st) == sync_stats(jst)
    same(merged.to_numpy(), planes_of(jmerged))
    np.testing.assert_array_equal(pd(merged), jd(a.merge(b)))
    diverged = set(np.nonzero(jd(a) != jd(b))[0].tolist())
    assert set(st.object_ids.tolist()) == diverged
    for s, row in st.per_shard.items():
        lo, hi = lay.ranges()[s]
        assert all(0 <= r < hi - lo for r in row["local_rows"])
    assert st.shards_synced + st.shards_skipped == shards
    if case == "twins":
        da, db = jd(a), jd(b)
        lo, hi = lay.ranges()[2]
        assert np.bitwise_xor.reduce(da[lo:hi]) == np.bitwise_xor.reduce(db[lo:hi])
        assert mesh.diverged_shards(da, db, lay, "cpu").tolist() == [2]
        for s, (slo, shi) in enumerate(lay.ranges()):
            assert mesh.shard_roots(da, lay, "cpu")[s] == \
                mesh_durable.shard_root_of(da[slo:shi], "cpu") == \
                jmesh_durable.shard_root_of(da[slo:shi])
    want = {"sync_rounds": 1, "sync_shards_synced": st.shards_synced,
            "sync_shards_skipped": st.shards_skipped, "sync_objects": st.objects,
            "sync_delta_bytes": st.delta_bytes}
    assert mesh_deltas(before) == {k: v for k, v in want.items() if v}


def test_cluster_node_repairs_one_shard_and_records_heat():
    """``sync_shard_subset`` between two in-process nodes: the same stats
    as two JAX nodes, the repaired replica equal to the control, the
    repaired rows in the initiator's heat; a busy peer is refused."""
    n, rows = SYNC_N, (17, 20)
    lay = mesh.choose_layout(n, 4, granule=16)
    a, _ = _history_batches(n, JU)
    b = _with_extras(a, JU, n, rows)
    n0, n1 = ClusterNode("n0", port(a), PU), ClusterNode("n1", port(b), PU)
    j0, j1 = JClusterNode("n0", a, JU), JClusterNode("n1", b, JU)
    st = n0.sync_shard_subset(n1, lay)
    assert sync_stats(st) == sync_stats(j0.sync_shard_subset(j1, jmesh.choose_layout(
        n, 4, granule=16)))
    assert set(st.per_shard) == {1}
    np.testing.assert_array_equal(pd(n0.batch), jd(a.merge(b)))
    same(n0.batch.to_numpy(), planes_of(j0._batch))
    heat = np.asarray(n0.heat.heat_vector())
    span = subtree_layout(n)[1]
    assert sum(heat[i // span] for i in rows) > 0
    n1.busy_timeout_s = 0.05
    with n1._busy:
        with pytest.raises(PeerUnavailableError):
            n0.sync_shard_subset(n1, lay)
    # the refusal released the initiator's lock
    assert n0._busy.acquire(blocking=False)
    n0._busy.release()
    done = threading.Event()
    threading.Thread(target=lambda: (n1.sync_shard_subset(n0, lay), done.set())).start()
    assert done.wait(30)


# -- per-shard snapshots -------------------------------------------------------------------


def files(path):
    return {str(p.relative_to(path)): p.read_bytes() for p in sorted(path.rglob("*"))
            if p.is_file()}


def test_fleet_snapshot_files_byte_equal_and_cross_restore(tmp_path):
    n = 24
    lay, jlay = mesh.choose_layout(n, 4, granule=4), jmesh.choose_layout(n, 4, granule=4)
    a, _ = _history_batches(n, JU)
    store = mesh_durable.MeshSnapshotStore(tmp_path / "port", lay)
    jstore = jmesh_durable.MeshSnapshotStore(tmp_path / "jax", jlay)
    before = mesh.mesh_counts()
    for _ in range(3):  # three generations, two retained
        manifest = store.write_fleet(port(a), PU, node_id="n0", wal_seq=7)
        assert manifest == jstore.write_fleet(a, JU, node_id="n0", wal_seq=7)
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert manifest["generations"] == [3] * 4 and manifest["wal_seq"] == 7
    for src, dst in (("jax", "port"), ("port", "jax")):
        shutil.copytree(tmp_path / src, tmp_path / f"{src}_for_{dst}")
    got, loaded = mesh_durable.MeshSnapshotStore(tmp_path / "jax_for_port", lay).load_fleet(
        device="cpu")
    want, jloaded = jmesh_durable.MeshSnapshotStore(tmp_path / "port_for_jax", jlay).load_fleet()
    assert loaded == jloaded == manifest
    same(got.to_numpy(), planes_of(want))
    same(got.to_numpy(), planes_of(a))
    restored, _ = store.load_fleet(device="cpu")
    np.testing.assert_array_equal(pd(restored), jd(a))
    assert mesh_deltas(before) == {"durable_snapshots": 3, "durable_restores": 2}


def test_fleet_kill9_before_manifest_restores_the_old_cut(tmp_path):
    n = 24
    lay = mesh.choose_layout(n, 4, granule=4)
    a, _ = _history_batches(n, JU)
    newer = port(_with_extras(a, JU, n, (2, 9, 21)))
    store = mesh_durable.MeshSnapshotStore(tmp_path, lay)
    store.write_fleet(port(a), PU, node_id="n0")
    for s, (lo, hi) in enumerate(lay.ranges()):  # the shards advance, no manifest
        store.store(s).write(tree_map(lambda x: x[lo:hi], newer), PU, node_id="n0")
    restored, manifest = store.load_fleet(device="cpu")
    assert manifest["generations"] == [1] * 4
    np.testing.assert_array_equal(pd(restored), jd(a))
    merged, st = mesh.shard_subset_sync(restored, newer, lay, PU)
    np.testing.assert_array_equal(pd(merged), pd(newer))
    assert 0 < st.shards_synced < lay.shards and st.delta_bytes > 0


def _tamper_root(path):
    manifest = json.loads(path.read_text())
    manifest["roots"][0] ^= 0xDEAD
    del manifest["crc"]
    manifest["crc"] = mesh_durable._manifest_crc(manifest)
    path.write_text(json.dumps(manifest))


def _tear(path):
    raw = path.read_text()
    path.write_text(raw[: len(raw) // 2])


@pytest.mark.parametrize("reason", ["manifest_missing", "root_mismatch", "manifest_corrupt",
                                    "layout_mismatch", "shard_missing", "version"])
def test_fleet_restore_rejections_are_typed_and_counted_as_in_jax(tmp_path, reason):
    n = 16
    a, _ = _history_batches(n, JU)
    for pkg, dur, batch, uni, root in ((mesh, mesh_durable, port(a), PU, tmp_path / "port"),
                                       (jmesh, jmesh_durable, a, JU, tmp_path / "jax")):
        lay = pkg.choose_layout(n, 4, granule=4)
        store = dur.MeshSnapshotStore(root, lay)
        if reason != "manifest_missing":
            store.write_fleet(batch, uni, node_id="n0")
        path = pathlib.Path(store.manifest_path)
        if reason == "root_mismatch":
            _tamper_root(path)
        elif reason == "manifest_corrupt":
            _tear(path)
        elif reason == "version":
            path.write_text(path.read_text().replace('"version": 1', '"version": 2'))
        elif reason == "layout_mismatch":
            store = dur.MeshSnapshotStore(root, pkg.choose_layout(n, 2, granule=4))
        elif reason == "shard_missing":
            shutil.rmtree(root / "shard-01")
            store = dur.MeshSnapshotStore(root, lay)
        before, jbefore = mesh.mesh_counts(), jtracing.counters()
        err = ((DurabilityError, CheckpointFormatError) if pkg is mesh else
               (JDurabilityError, JCheckpointFormatError))[reason != "manifest_missing"]
        with pytest.raises(err):
            store.load_fleet(*(() if pkg is jmesh else (None, "cpu")))
        key = "manifest_corrupt" if reason == "version" else reason
        if pkg is mesh:
            assert mesh_deltas(before) == {"durable_rejected_" + key: 1}
        else:
            got = jtracing.counters_since(jbefore)
            assert {k: v for k, v in got.items() if k.startswith("mesh.")} == \
                {"mesh.durable.rejected." + key: 1}
        if reason == "manifest_missing":
            assert store.latest_manifest() is None


# -- gauges and counts ---------------------------------------------------------------------


def test_publish_gauges_and_counts_under_the_jax_names():
    a, _ = _history_batches(32, JU)
    span = subtree_layout(32)[1]
    heat = np.arange(1, -(-32 // span) + 1, dtype=np.float64)
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    sa = mesh.ShardedBatch.shard(port(a), PU, shards=4, granule=8)
    sa.publish_gauges(registry=reg, heat_vector=heat, span=span)
    jmesh.ShardedBatch.shard(a, JU, shards=4, granule=8).publish_gauges(
        registry=jreg, heat_vector=heat, span=span)
    assert reg.snapshot()["gauges"] == jreg.snapshot()["gauges"]
    assert reg.snapshot()["gauges"]["mesh.layout.shards"] == 4
    mesh.anti_entropy_step(sa, sa)
    reg = metrics.MetricsRegistry()
    publish.publish_mesh(reg)
    counters = reg.snapshot()["counters"]
    assert counters["mesh.step.rounds"] == mesh.mesh_counts()["step_rounds"] >= 1
    assert counters["mesh.step.digest_bytes"] >= 8 * 32
    assert all(k.startswith("mesh.") for k in counters)


# -- across ranks --------------------------------------------------------------------------


def store_planes(inp, key, arrays):
    for i, x in enumerate(arrays):
        inp[f"{key}/{i}"] = np.asarray(x)


def member_fleets():
    """Two replica fleets of 4 sets of 40 members (more than one shard's
    16 slots) with some causal removes, and a pair whose merge overflows
    shard 0's 2 slots."""
    from test_member_sharding import build_replicas

    fleets = [JOrswotBatch.from_scalar(f, MJU) for f in build_replicas(seed=11)]
    over = []
    for r in range(2):
        row = []
        for _ in range(3):
            o = Orswot()
            for m in (16 * r, 16 * r + 8):  # every member on shard 0
                o.apply(o.add(m, o.value().derive_add_ctx(r)))
            row.append(o)
        over.append(JOrswotBatch.from_scalar(row, MJU))
    return fleets, over


def attempt(fn):
    try:
        return [np.asarray(x) for x in fn()]
    except Exception as e:
        return f"{type(e).__name__} {[getattr(e, 'member', None), getattr(e, 'deferred', None)]}"


def build(k):
    """The k-rank run's inputs and the JAX results, not yet computed."""
    inp, want = {"cfg": np.array([8, 16, 8]), "granule": np.array(STEP_GRANULE)}, {}
    a, b = _history_batches(STEP_N, JU)
    b = _with_extras(b, JU, STEP_N, (3, 17, 40))
    store_planes(inp, "a", planes_of(a))
    store_planes(inp, "b", planes_of(b))
    for s in mesh.MESH_SIZES:
        if s % k:
            continue

        def step(s=s):
            sa, sb = (jmesh.ShardedBatch.shard(x, JU, shards=s, granule=STEP_GRANULE)
                      for x in (a, b))
            res = jmesh.anti_entropy_step(sa, sb)
            lay = sa.layout
            return [res.digests, res.version_vector, np.array(res.live_members),
                    jmesh.shard_roots(res.digests, lay), *planes_of(res.batch.device),
                    np.array([lay.n, lay.shards, lay.granule, lay.per_shard, lay.imbalance]),
                    *planes_of(res.batch.logical())]
        want[f"step{s}"] = step
    sa, _ = _history_batches(SYNC_N, JU)
    sb = _with_extras(sa, JU, SYNC_N, SYNC_ROWS)
    store_planes(inp, "sync_a", planes_of(sa))
    store_planes(inp, "sync_b", planes_of(sb))

    def subset():
        merged, st = jmesh.shard_subset_sync(sa, sb, jmesh.choose_layout(
            SYNC_N, max(4, k), granule=8), JU)
        return [np.array([st.shards_synced, st.shards_skipped, st.objects, st.root_bytes,
                          st.descent_bytes, st.delta_bytes]), st.object_ids,
                np.array(sorted(st.per_shard)), *planes_of(merged)]
    want["subset"] = subset

    (ma, mb), (oa, ob) = member_fleets()
    for key, fl in (("ma", ma), ("mb", mb), ("oa", oa), ("ob", ob)):
        store_planes(inp, key, planes_of(fl))
    actor, member = np.array([1, 2, 3, 1], np.int32), np.array([777, 778, 779, 780], np.int32)
    counter = np.asarray(ma.clock)[np.arange(4), actor] + np.uint64(5)
    inp.update({"add/actor": actor, "add/member": member, "add/counter": counter})
    jm = j_make_mesh({"members": k}, devices=jax.devices()[:k])

    def sharded(fl, cap=16):
        from jax.sharding import NamedSharding, PartitionSpec as P

        return tuple(jax.device_put(jnp.asarray(x), NamedSharding(jm, P("members")))
                     for x in j_partition(*planes_of(fl), 8, cap, 4))

    def jmerge():
        return j_member_merge(sharded(ma), sharded(mb), jm, "members")
    want["member_merge"] = jmerge
    want["member_add"] = lambda: j_apply_add(jmerge(), jnp.asarray(actor), jnp.asarray(counter),
                                            jnp.asarray(member), jm, "members")
    want["member_clock"] = lambda: j_rebroadcast(sharded(ma), jm, "members")
    want["member_over"] = lambda: j_member_merge(sharded(oa, 2), sharded(ob, 2), jm, "members")
    return inp, want


_RUNS = {}


def run_world(k, tmp_root):
    if k in _RUNS:
        return _RUNS[k]
    path = tmp_root / f"world{k}"
    path.mkdir()
    inp, thunks = build(k)
    np.savez(path / "in.npz", **inp)
    if k == 1:
        from torch_rank_mesh import run

        outs = [run(str(path), 0, 1, store=dist.HashStore())]
        want = {key: attempt(fn) for key, fn in thunks.items()}
    else:
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, str(RANKS), str(path), str(r), str(k)],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(k)]
        want = {key: attempt(fn) for key, fn in thunks.items()}
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {k} failed:\n{log[-4000:]}"
        outs = [dict(np.load(path / f"out{r}.npz")) for r in range(k)]
    _RUNS[k] = (outs, want)
    return _RUNS[k]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"world{k}")
def world(request, tmp_path_factory):
    return (request.param, *run_world(request.param, tmp_path_factory.mktemp("mesh_ranks")))


def got_case(out, key):
    if f"{key}/err" in out:
        return str(out[f"{key}/err"])
    arrays, i = [], 0
    while f"{key}/{i}" in out:
        arrays.append(out[f"{key}/{i}"])
        i += 1
    return arrays


def rows_of(x, r, k):
    n = x.shape[0] // k
    return x[r * n:(r + 1) * n]


def test_step_matches_jax_on_every_rank(world):
    """Digests, version vector, live members, shard roots and the logical
    planes equal on every rank; each rank's padded rows are its shards'
    (rank ``r`` holds shards ``[r·S/W, (r+1)·S/W)``)."""
    k, outs, want = world
    steps = [key for key in want if key.startswith("step")]
    assert steps == [f"step{s}" for s in mesh.MESH_SIZES if s % k == 0]
    for key in steps:
        w = want[key]
        for r, out in enumerate(outs):
            got = got_case(out, key)
            what = f"{key}: rank {r} of {k}"
            same(got[:4], w[:4], what)
            same(got[4:9], [rows_of(x, r, k) for x in w[4:9]], what)
            same(got[9:], w[9:], what)


def test_subset_sync_matches_jax_on_every_rank(world):
    k, outs, want = world
    for r, out in enumerate(outs):
        got = got_case(out, "subset")
        same(got, want["subset"], f"rank {r} of {k}")
        assert got[0][:2].tolist() == [1, max(4, k) - 1]


@pytest.mark.parametrize("case", ["member_merge", "member_add", "member_clock", "member_over"])
def test_member_sharding_matches_jax_on_every_rank(world, case):
    """Each rank's member-shard rows of the merge, the add with its clock
    rebroadcast and the rebroadcast alone equal the JAX rows; an overflow
    of one shard raises on every rank, as in JAX."""
    k, outs, want = world
    for r, out in enumerate(outs):
        got, w = got_case(out, case), want[case]
        if isinstance(w, str):
            assert got == w, f"{case}: rank {r} of {k}"
        else:
            same(got, [rows_of(x, r, k) for x in w], f"{case}: rank {r} of {k}")
    assert want["member_over"] == "CapacityOverflowError [True, False]"
