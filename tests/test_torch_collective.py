"""Parity of the port's collective joins (``crdt_tpu_torch.parallel``)
with the JAX package's, on the CPU.

The port's joins run in gloo process groups of 1, 2, 4 and 8 ranks: one
spawn per world size (``tests/torch_rank_joins.py``, which imports no
JAX) runs every join in turn, world 1 in this process; the 4-rank spawn
also runs the 2x2 ``objects`` x ``replicas`` hybrid.  The JAX joins run
here on a sub-mesh of the virtual CPU devices of the same size, and
rank ``r``'s output must equal row ``r`` of the JAX output bit for bit,
planes and raised errors alike.  The single-device reductions and
``anti_entropy`` are held against the JAX package in this process, and
against the scalar left fold.
"""

import os
import pathlib
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from crdt_tpu import Dot, Map, MVReg, Orswot, VClock
from crdt_tpu.batch import (
    GSetBatch as JGSetBatch, LWWRegBatch as JLWWRegBatch, MapBatch as JMapBatch,
    MVRegBatch as JMVRegBatch, MVRegKernel as JMVRegKernel, OrswotBatch as JOrswotBatch,
    VClockBatch as JVClockBatch,
)
from crdt_tpu.config import CrdtConfig as JConfig
from crdt_tpu.parallel import (
    all_reduce_clock_join as j_clock_join, allgather_join_gset as j_gset_join,
    allgather_join_lww as j_lww_join, allgather_join_map as j_map_join,
    allgather_join_mvreg as j_mvreg_join, allgather_join_orswot as j_orswot_join,
    anti_entropy as j_anti_entropy, fold_reduce_merge as j_fold_reduce,
    make_mesh as j_make_mesh, make_multihost_mesh as j_make_multihost_mesh,
    tree_reduce_merge as j_tree_reduce,
)
from crdt_tpu.parallel.collective import shard_local_pairwise_merge as j_shard_local
from crdt_tpu.parallel.mesh import shard_batch as j_shard_batch
from crdt_tpu.scalar.gset import GSet
from crdt_tpu.scalar.lwwreg import LWWReg
from crdt_tpu.scalar.map import Rm as MapRm, Up
from crdt_tpu.scalar.mvreg import Put
from crdt_tpu.scalar.orswot import Add, Rm
from crdt_tpu.utils import serde as jserde
from crdt_tpu.utils.interning import Universe as JUniverse
from crdt_tpu_torch import (
    CrdtConfig, GSetBatch, LWWRegBatch, MapBatch, MVRegBatch, OrswotBatch, Universe, VClockBatch,
)
from crdt_tpu_torch.obs.fleet import decode_snapshot, merge_snapshots
from crdt_tpu_torch.parallel import (
    anti_entropy, fold_reduce_merge, local_shard, make_mesh, replicate, tree_reduce_merge,
)
from crdt_tpu_torch.utils import serde

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
RANKS = HERE / "torch_rank_joins.py"
WORLDS = (1, 2, 4, 8)
RANK_TIMEOUT_S = 120
CASES = ("clock", "orswot", "orswot_unchecked", "orswot32", "orswot32_unchecked",
         "orswot32_unrolled", "over", "over_unchecked", "map", "lww", "lwwc", "lwwc_unchecked",
         "mvreg", "mvo", "gset", "shard_local", "truncate", "global_join")
# the joins held against the scalar left fold too
SCALAR_CASES = ("orswot", "map", "lww", "mvreg", "gset")


def small(**kw):
    return JUniverse.identity(JConfig(num_actors=8, member_capacity=16, deferred_capacity=8,
                                     **kw))


def random_orswots(seed, n_replicas, n_objects):
    """``test_sharding.py``'s fleet: random adds and removes, so some
    removes run ahead of their clocks and defer."""
    rng = np.random.RandomState(seed)
    fleet = []
    for _ in range(n_replicas):
        row = []
        for _ in range(n_objects):
            s = Orswot()
            for _ in range(rng.randint(0, 8)):
                actor, member, counter = (int(rng.randint(0, 8)), int(rng.randint(0, 8)),
                                          int(rng.randint(1, 6)))
                if rng.rand() < 0.7:
                    s.apply(Add(dot=Dot(actor, counter), member=member))
                else:
                    s.apply(Rm(clock=Dot(actor, counter).to_vclock(), member=member))
            row.append(s)
        fleet.append(row)
    return fleet


def overflow_fleet(n_replicas, n_objects=4):
    """Only the last object's member union outgrows ``m_cap=2``."""
    fleet = []
    for r in range(n_replicas):
        row = []
        for i in range(n_objects):
            o = Orswot()
            for m in ([0] if i < n_objects - 1 else [r * 2, r * 2 + 1]):
                o.apply(o.add(m, o.value().derive_add_ctx(r)))
            row.append(o)
        fleet.append(row)
    return fleet


def random_maps(seed, n_replicas, n_objects):
    rng = random.Random(seed)

    def one():
        m = Map(MVReg)
        for _ in range(rng.randrange(0, 8)):
            actor, counter, key = rng.randrange(0, 8), rng.randrange(1, 6), rng.randrange(0, 5)
            clock = VClock.from_iter([(actor, counter)])
            if rng.random() < 0.25:
                m.apply(MapRm(clock=clock, key=key))
            else:
                m.apply(Up(dot=Dot(actor, counter), key=key,
                           op=Put(clock=clock, val=rng.randrange(0, 9))))
        return m
    return [[one() for _ in range(n_objects)] for _ in range(n_replicas)]


def random_mvregs(seed, n_replicas, n_objects, writes=4):
    rng = np.random.RandomState(seed)
    fleet = []
    for _ in range(n_replicas):
        row = []
        for _ in range(n_objects):
            reg = MVReg()
            for _ in range(rng.randint(0, writes)):
                reg.apply(reg.set(int(rng.randint(0, 40)),
                                  reg.read().derive_add_ctx(int(rng.randint(0, 8)))))
            row.append(reg)
        fleet.append(row)
    return fleet


def concurrent_mvregs(n_replicas, n_objects=3):
    """Every replica writes its own value from the empty register: the
    join keeps all of them, past ``mv_capacity=1`` from two replicas."""
    fleet = []
    for r in range(n_replicas):
        row = []
        for i in range(n_objects):
            reg = MVReg()
            reg.apply(reg.set(10 * r + i, reg.read().derive_add_ctx(r)))
            row.append(reg)
        fleet.append(row)
    return fleet


def lww_fleets(k, seed, n=10):
    """Distinct markers (no conflict), and a conflicting fleet: on
    register 2, replicas 0 and 1 share marker 50 with different values
    while replica k-1 holds the unique maximum 99 (for k >= 3)."""
    markers = np.random.RandomState(seed).permutation(k * n).reshape(k, n) + 1
    clean = [[LWWReg(val=int(markers[r, i]) * 7, marker=int(markers[r, i])) for i in range(n)]
             for r in range(k)]
    conflict = [[LWWReg(val=100 + r, marker=1 + r) for _ in range(4)] for r in range(k)]
    if k >= 2:
        conflict[0][2], conflict[1][2] = LWWReg(val=111, marker=50), LWWReg(val=222, marker=50)
    if k >= 3:
        conflict[k - 1][2] = LWWReg(val=333, marker=99)
    return clean, conflict


def stack(batches):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *batches)


def orswot_np(b):
    return [np.asarray(x) for x in (b.clock, b.ids, b.dots, b.d_ids, b.d_clocks)]


def attempt(fn):
    """``fn()``'s arrays, or the error it raised as the rank helper
    records it."""
    try:
        return [np.asarray(x) for x in fn()]
    except Exception as e:
        return f"{type(e).__name__} {[getattr(e, 'member', None), getattr(e, 'deferred', None)]}"


def store(inp, key, arrays):
    for i, x in enumerate(arrays):
        inp[f"{key}/{i}"] = np.asarray(x)


def build(k):
    """The fleets of a k-rank run (unsigned numpy planes, replica axis
    first); per case the JAX join on a k-device sub-mesh, not yet run:
    ``(a function of no argument returning the arrays, replica axis
    first, whether the rank keeps its leading axis of 1)``; and the
    scalar fleets of :data:`SCALAR_CASES`."""
    uni = small()
    mesh = j_make_mesh({"replicas": k}, devices=jax.devices()[:k])
    inp, want, scalars = {}, {}, {}
    rng = np.random.RandomState(100 + k)
    clocks = jnp.stack([JVClockBatch.from_scalar(
        [VClock.from_iter([(int(a), int(rng.randint(1, 9))) for a in rng.choice(8, 3)])
         for _ in range(16)], uni).clocks for _ in range(k)])
    inp["clock"] = np.asarray(clocks)
    want["clock"] = (lambda: [j_clock_join(clocks, mesh)], True)

    over_uni = JUniverse.identity(JConfig(num_actors=8, member_capacity=2, deferred_capacity=2))
    for key, fleet, u in (("orswot", random_orswots(3 + k, k, 6), uni),
                          ("over", overflow_fleet(k), over_uni)):
        scalars[key] = fleet
        st = stack([JOrswotBatch.from_scalar(row, u) for row in fleet])
        store(inp, key, orswot_np(st))
        want[key] = (lambda st=st: orswot_np(j_orswot_join(st, mesh)), True)
        want[key + "_unchecked"] = (
            lambda st=st: orswot_np(j_orswot_join(st, mesh, check=False)), True)
    # the same fleet with u32 counters (all small), each rank's replica
    # passed without its leading axis: the merge kernel's plain version
    store(inp, "orswot32", [x.astype(np.uint32) if x.dtype == np.uint64 else x
                            for x in (inp[f"orswot/{i}"] for i in range(5))])
    for key, lead in (("orswot32", False), ("orswot32_unchecked", False),
                      ("orswot32_unrolled", True), ("global_join", True)):
        want[key] = (want["orswot"][0], lead)

    kernel = JMVRegKernel.from_config(uni.config)
    scalars["map"] = random_maps(23 + k, k, 4)
    st = stack([JMapBatch.from_scalar(row, uni, kernel) for row in scalars["map"]])
    store(inp, "map", jax.tree_util.tree_leaves(st.state))
    want["map"] = (lambda st=st: jax.tree_util.tree_leaves(j_map_join(st, mesh).state), True)

    clean, conflict = lww_fleets(k, 11 + k)
    scalars["lww"] = clean
    for key, fleet, check in (("lww", clean, True), ("lwwc", conflict, True),
                              ("lwwc_unchecked", conflict, False)):
        st = stack([JLWWRegBatch.from_scalar(row, uni) for row in fleet])
        store(inp, key.split("_")[0], (st.vals, st.markers))
        want[key] = (lambda st=st, check=check: (
            lambda out: (out[0].vals, out[0].markers, out[1]))(
                j_lww_join(st, mesh, check=check)), False)

    scalars["mvreg"] = random_mvregs(37 + k, k, 6)
    for key, fleet, u in (("mvreg", scalars["mvreg"], uni),
                          ("mvo", concurrent_mvregs(k), small(mv_capacity=1))):
        st = stack([JMVRegBatch.from_scalar(row, u) for row in fleet])
        store(inp, key, (st.clocks, st.vals))
        want[key] = (lambda st=st: (lambda j: (j.clocks, j.vals))(j_mvreg_join(st, mesh)),
                     True)

    scalars["gset"] = sets = [[GSet({int(m) for m in rng.choice(12, rng.randint(0, 6), replace=False)})
             for _ in range(10)] for _ in range(k)]
    st = stack([JGSetBatch.from_scalar(row, uni, 16) for row in sets])
    store(inp, "gset", (st.bits,))
    want["gset"] = (lambda st=st: [j_gset_join(st, mesh).bits], False)

    pair = random_orswots(9, 2, 32)
    a, b = (JOrswotBatch.from_scalar(row, uni) for row in pair)
    store(inp, "a", orswot_np(a))
    store(inp, "b", orswot_np(b))
    omesh = j_make_mesh({"objects": k}, devices=jax.devices()[:k])
    want["shard_local"] = (lambda: (lambda s5, over: (*s5, over))(*j_shard_local(
        j_shard_batch(a, omesh), j_shard_batch(b, omesh), omesh)), None)
    inp["horizon"] = rng.randint(0, 4, size=a.clock.shape).astype(np.uint64)
    want["truncate"] = (lambda: orswot_np(j_shard_batch(a, omesh).truncate(
        jnp.asarray(inp["horizon"]))), None)

    if k == 4:
        hybrid(inp, want, uni)
    return inp, want, scalars


def hybrid(inp, want, uni):
    """The 2x2 mesh's fleets and JAX's ``object_axis`` joins; the JAX mesh
    leads with its DCN dim, as the port's."""
    mesh = j_make_multihost_mesh({"replicas": 2}, {"objects": 2}, devices=jax.devices()[:4])
    rng = np.random.RandomState(11)
    fleet = []
    for _ in range(2):
        row = []
        for _ in range(8):
            o = Orswot()
            for _ in range(rng.randint(1, 4)):
                o.apply(o.add(int(rng.randint(0, 12)),
                              o.value().derive_add_ctx(int(rng.randint(0, 4)))))
            row.append(o)
        fleet.append(row)
    over_uni = JUniverse.identity(JConfig(num_actors=8, member_capacity=2, deferred_capacity=2))
    for key, fl, u in (("hyb", fleet, uni), ("hybo", overflow_fleet(2), over_uni)):
        st = stack([JOrswotBatch.from_scalar(row, u) for row in fl])
        store(inp, key, orswot_np(st))
        want[key] = (lambda st=st: orswot_np(j_orswot_join(st, mesh, object_axis="objects")),
                     False)


_RUNS = {}


def run_world(k, tmp_root):
    """Rank outputs and JAX expectations of a k-rank run; computed once
    per world size.  The ranks run while the JAX joins compile."""
    if k in _RUNS:
        return _RUNS[k]
    path = tmp_root / f"world{k}"
    path.mkdir()
    inp, thunks, scalars = build(k)
    np.savez(path / "in.npz", **inp)
    if k == 1:
        from torch_rank_joins import run

        try:
            outs = [run(str(path), 0, 1, store=dist.HashStore())]
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        want = {key: (attempt(fn), lead) for key, (fn, lead) in thunks.items()}
    else:
        procs = start_ranks(path, k)
        want = {key: (attempt(fn), lead) for key, (fn, lead) in thunks.items()}
        outs = wait_ranks(procs, path, k)
    _RUNS[k] = (outs, want, scalars)
    return _RUNS[k]


def start_ranks(path, k):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(RANKS), str(path), str(r), str(k)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(k)]


def wait_ranks(procs, path, k):
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
    return [dict(np.load(path / f"out{r}.npz")) for r in range(k)]


def got_case(out, key):
    if f"{key}/err" in out:
        return str(out[f"{key}/err"])
    arrays, i = [], 0
    while f"{key}/{i}" in out:
        arrays.append(out[f"{key}/{i}"])
        i += 1
    return arrays


def rank_row(want, r, lead):
    """Row ``r`` of the JAX output, with the leading axis of 1 kept when
    the rank passed its replica with it."""
    if isinstance(want, str):
        return want
    return [x[r:r + 1] if lead else x[r] for x in want]


def same(got, want, what):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want, what
        return
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype), err_msg=what)
        assert g.shape == np.asarray(w).shape, what


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"world{k}")
def world(request, tmp_path_factory):
    outs, want, scalars = run_world(request.param, tmp_path_factory.mktemp("ranks"))
    return request.param, (outs, want), scalars


@pytest.mark.parametrize("case", CASES)
def test_join_matches_jax_row_per_rank(world, case):
    k, (outs, want), _ = world
    expected, lead = want[case]
    for r, out in enumerate(outs):
        got = got_case(out, case)
        if case in ("shard_local", "truncate"):
            rows = local_shard(expected[0].shape[0], k, r)
            same(got, [x[rows] for x in expected], f"{case}: rank {r} of {k}")
        else:
            same(got, rank_row(expected, r, lead), f"{case}: rank {r} of {k}")


def test_errors_raise_on_every_rank_as_in_jax(world):
    """The overflow and conflict raises are the JAX package's, on every
    rank, from two ranks up (world 1 folds one replica)."""
    k, (outs, want), _ = world
    raised = {c for c in CASES if isinstance(want[c][0], str)}
    assert raised == ({"over", "lwwc", "mvo"} if k > 1 else set())


def test_fleet_snapshots_equal_the_merge_of_every_rank_frame(world):
    k, (outs, _), _ = world
    sent = [bytes(got_case(out, "fleet")[0]) for out in outs]
    merged = [decode_snapshot(bytes(got_case(out, "fleet")[1])) for out in outs]
    want = merge_snapshots(sent)
    assert want.nodes() == sorted(f"rank{r}" for r in range(k))
    for r, snap in enumerate(merged):
        assert snap == want, f"rank {r}"
    assert want.fleet_counters()["rank_ops"] == sum(100 + r for r in range(k))


def test_global_batch_from_local_tags_each_rank_span(world):
    k, (outs, _), _ = world
    for r, out in enumerate(outs):
        assert out["global/span"].tolist() == [r, r + 1, k]


def scalar_fold(fleet, plunge):
    """The scalar left fold of each object over the replicas, as wire
    bytes (ORSWOT with the defer plunger, as ``test_sharding.py``)."""
    out = []
    for i in range(len(fleet[0])):
        acc = fleet[0][i].clone()
        for row in fleet[1:]:
            acc.merge(row[i])
        if plunge:
            acc.merge(Orswot())
        out.append(jserde.to_binary(acc))
    return out


@pytest.mark.parametrize("case", SCALAR_CASES)
def test_join_equals_the_scalar_left_fold(world, case):
    """Each rank's join, read back as the port's scalar objects, has the
    wire bytes of the JAX scalar engine's N-way left fold."""
    from torch_rank_joins import CFG, MAP_KERNEL

    k, (outs, _), scalars = world
    uni = Universe.identity(CFG)
    for r, out in enumerate(outs):
        got = got_case(out, case)
        if case == "orswot":
            b = OrswotBatch.from_numpy(*(x[0] for x in got), device="cpu")
            batch = b.merge(OrswotBatch.zeros(b.clock.shape[0], uni, device="cpu"))
        elif case == "map":
            from crdt_tpu_torch.batch.map_batch import _unflatten, map_planes

            template = map_planes([], uni, MAP_KERNEL.val_kernel)
            batch = MapBatch.from_numpy(*_unflatten(template, (x[0] for x in got)),
                                        MAP_KERNEL, device="cpu")
        elif case == "lww":
            batch = LWWRegBatch.from_numpy(*got[:2], device="cpu")
        elif case == "mvreg":
            batch = MVRegBatch.from_numpy(*(x[0] for x in got), device="cpu")
        else:
            batch = GSetBatch.from_numpy(got[0], device="cpu")
        assert [serde.to_binary(s) for s in batch.to_scalar(uni)] == scalar_fold(
            scalars[case], plunge=case == "orswot"), f"{case}: rank {r} of {k}"


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(4, tmp_path_factory.mktemp("ranks"))[:2]


def test_hybrid_object_axis_join_matches_jax(world4):
    outs, want = world4
    expected = want["hyb"][0]
    for r, out in enumerate(outs):
        obj, rep = out["hyb/coords"].tolist()
        assert (obj, rep) == (r // 2, r % 2)
        rows = local_shard(expected[0].shape[1], 2, obj)
        same(got_case(out, "hyb"), [x[rep][rows] for x in expected], f"hybrid rank {r}")


def test_hybrid_overflow_on_one_shard_raises_on_every_rank(world4):
    """The overflow is planted on the last object, in object shard 1
    only; the flags are MAX-reduced over ``objects``, so shard 0's ranks
    raise too, and the collective after the raise runs on every rank."""
    outs, want = world4
    assert want["hybo"][0].startswith("CapacityOverflowError")
    for r, out in enumerate(outs):
        assert got_case(out, "hybo") == want["hybo"][0], f"rank {r}"
        (after,) = got_case(out, "hyb_after")
        assert after.tolist() == [[2 + r % 2]], f"rank {r}"


# -- one device: the reductions, anti-entropy --------------------------------


def port_orswot(planes):
    return OrswotBatch.from_numpy(*planes, device="cpu")


def scalar_join(fleet, plunge=True):
    out = []
    for i in range(len(fleet[0])):
        merged = Orswot()
        for row in fleet:
            merged.merge(row[i])
        if plunge:
            merged.merge(Orswot())
        out.append(merged)
    return out


def test_fold_and_tree_reduce_match_jax():
    uni = small()
    fleet = random_orswots(5, 7, 4)
    st = stack([JOrswotBatch.from_scalar(row, uni) for row in fleet])
    want = j_fold_reduce(st, lambda a, b: a.merge(b, check=False))
    got = fold_reduce_merge(port_orswot(orswot_np(st)), lambda a, b: a.merge(b, check=False))
    same(list(got.to_numpy()), orswot_np(want), "fold_reduce_merge")
    rng = np.random.RandomState(17)
    for r in (1, 2, 5, 8):
        clocks = rng.randint(0, 2**63, size=(r, 6, 8), dtype=np.uint64)
        port = VClockBatch.from_numpy(clocks.reshape(-1, 8), device="cpu").clocks.view(r, 6, 8)
        tree = tree_reduce_merge(port, torch.maximum)
        assert torch.equal(tree, fold_reduce_merge(port, torch.maximum))
        want = j_tree_reduce(jnp.asarray(clocks), jnp.maximum)
        same([VClockBatch(tree).to_numpy()], [np.asarray(want)], f"tree_reduce_merge R={r}")


def ae_stack(fleet, bits=64, m_cap=16, d_cap=8):
    uni = JUniverse.identity(JConfig(num_actors=8, member_capacity=m_cap,
                                     deferred_capacity=d_cap, counter_bits=bits))
    return stack([JOrswotBatch.from_scalar(row, uni) for row in fleet])


def ae_case(st, impl=None, check=True, max_rounds=3):
    """``anti_entropy`` of both packages on one stacked fleet: the planes
    and rounds, or the error raised."""
    def jax_side():
        merged, rounds = j_anti_entropy(st, max_rounds=max_rounds, check=check)
        return orswot_np(merged) + [np.array(rounds)]

    def port_side():
        merged, rounds = anti_entropy(port_orswot(orswot_np(st)), max_rounds=max_rounds,
                                      check=check, impl=impl)
        return list(merged.to_numpy()) + [np.array(rounds)]
    return attempt(jax_side), attempt(port_side)


@pytest.mark.parametrize("seed", (11, 13, 21))
@pytest.mark.parametrize("impl", [None, "pallas"])
def test_anti_entropy_matches_jax_and_scalar(seed, impl):
    bits = 32 if impl == "pallas" else 64
    fleet = random_orswots(seed, 5, 8)
    want, got = ae_case(ae_stack(fleet, bits), impl=impl)
    same(got, want, f"anti_entropy seed {seed}")
    uni = Universe.identity(CrdtConfig(num_actors=8, member_capacity=16, deferred_capacity=8,
                                       counter_bits=bits))
    merged = port_orswot(got[:5]).to_scalar(uni)
    assert [serde.to_binary(s) for s in merged] == [
        jserde.to_binary(s) for s in scalar_join(fleet)]


@pytest.mark.parametrize("replicas,max_rounds", [(1, 3), (1, 4), (3, 3)])
@pytest.mark.parametrize("impl", [None, "pallas"])
def test_anti_entropy_three_rounds_matches_jax(impl, replicas, max_rounds):
    """Replicas whose member slots run in descending id order (as op
    writes leave them).  One replica: the fold merges nothing, the first
    self-merge sorts the slots, the second changes nothing: 3 rounds.
    Three: the fold's merges sort them, so 2."""
    st = ae_stack(random_orswots(31, replicas, 8), 32 if impl == "pallas" else 64)
    st = JOrswotBatch(clock=st.clock, ids=st.ids[..., ::-1], dots=st.dots[..., ::-1, :],
                      d_ids=st.d_ids, d_clocks=st.d_clocks)
    want, got = ae_case(st, impl=impl, max_rounds=max_rounds)
    same(got, want, "unsorted slots")
    assert int(got[-1]) == (3 if replicas == 1 else 2)


@pytest.mark.parametrize("impl", [None, "pallas"])
@pytest.mark.parametrize("check", [True, False])
def test_anti_entropy_overflow_matches_jax(impl, check):
    """The last object's member union outgrows ``m_cap=2``: the fold
    flags it, and the flags and planes are JAX's."""
    want, got = ae_case(ae_stack(overflow_fleet(5), 32, m_cap=2, d_cap=1), impl=impl,
                        check=check)
    if check:
        assert want == "CapacityOverflowError [True, False]"
    same(got, want, f"anti_entropy overflow check={check}")


def test_anti_entropy_max_rounds_one_is_the_fold():
    want, got = ae_case(ae_stack(random_orswots(13, 5, 8)), max_rounds=1)
    same(got, want, "max_rounds=1")
    assert int(got[-1]) == 1


def test_replicate_and_world_of_one_mesh():
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("objects",) and mesh.mesh.shape == (1,)
        batch = port_orswot(orswot_np(JOrswotBatch.from_scalar(random_orswots(21, 1, 4)[0],
                                                                small())))
        copy = replicate(batch, mesh)
        same(list(copy.to_numpy()), list(batch.to_numpy()), "replicate")
        with pytest.raises(ValueError, match="need 2 ranks"):
            make_mesh({"replicas": 2}, device="cpu")
    finally:
        dist.destroy_process_group()
