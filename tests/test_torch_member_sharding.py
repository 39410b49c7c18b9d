"""Parity of the port's member sharding (``crdt_tpu_torch.parallel.
member_sharding``) with the JAX package's, on the CPU: the cases of
``tests/test_member_sharding.py``.

Sets larger than one member table are hash-partitioned over 8 member
shards, merged shard-locally and their clocks joined.  The port runs a
``members`` mesh of one rank in this process (all 8 shard rows on it);
the JAX side runs on the conftest's 8-device CPU mesh.  Planes are held
bit for bit against the JAX package's, and the values against the scalar
engine (the JAX package's, by the serde bytes).  ``test_torch_mesh.py``
runs these joins at gloo world sizes 2, 4 and 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from crdt_tpu.batch import OrswotBatch as JOrswotBatch
from crdt_tpu.config import CrdtConfig as JConfig
from crdt_tpu.parallel.member_sharding import (
    member_sharded_merge as j_merge, partition_dense as j_partition,
    sharded_apply_add as j_apply_add, unpartition_dense as j_unpartition,
)
from crdt_tpu.parallel.mesh import make_mesh as j_make_mesh
from crdt_tpu.scalar.orswot import Orswot
from crdt_tpu.utils import serde as jserde
from crdt_tpu.utils.interning import Universe as JUniverse
from crdt_tpu_torch import CapacityOverflowError, CrdtConfig, OrswotBatch, Universe
from crdt_tpu_torch.dtypes import bias_np
from crdt_tpu_torch.parallel import (
    make_mesh, member_sharded_merge, partition_dense, rebroadcast_clock, sharded_apply_add,
    unpartition_dense,
)
from crdt_tpu_torch.parallel.collective import _planes
from crdt_tpu_torch.utils import serde
from test_member_sharding import build_replicas

torch.set_num_threads(1)

N_SHARDS, M_CAP, M_CAP_SHARD, D_CAP, D_CAP_SHARD = 8, 64, 16, 8, 4
KW = dict(num_actors=8, member_capacity=M_CAP, deferred_capacity=D_CAP)
JU, PU = JUniverse.identity(JConfig(**KW)), Universe.identity(CrdtConfig(**KW))
PLANES = ("clock", "ids", "dots", "d_ids", "d_clocks")


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
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def np_planes(batch):
    return [np.asarray(getattr(batch, f)) for f in PLANES]


def jax_state(states, jm, uni=JU):
    parts = j_partition(*np_planes(JOrswotBatch.from_scalar(states, uni)), N_SHARDS,
                        M_CAP_SHARD, D_CAP_SHARD)
    return tuple(jax.device_put(jnp.asarray(x), NamedSharding(jm, P("members"))) for x in parts)


def port_state(states, uni=JU):
    """The port's member-sharded state of the sets the JAX ``uni`` packs."""
    parts = partition_dense(*np_planes(JOrswotBatch.from_scalar(states, uni)), N_SHARDS,
                            M_CAP_SHARD, D_CAP_SHARD)
    return _planes(OrswotBatch.from_numpy(*parts, device="cpu"))


def same(state, jstate):
    for g, w in zip(OrswotBatch(*state).to_numpy(), jstate):
        np.testing.assert_array_equal(g, np.asarray(w))


def scalars(state):
    """The port state's sets by the port's scalar engine, as serde bytes."""
    dense = unpartition_dense(*OrswotBatch(*state).to_numpy(), m_cap=M_CAP, d_cap=D_CAP)
    states = OrswotBatch.from_numpy(*dense, device="cpu").to_scalar(PU)
    return [serde.to_binary(s) for s in states]


def scalar_merge(a_states, b_states):
    out = []
    for a, b in zip(a_states, b_states):
        m = a.clone()
        m.merge(b)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [11, 12])
def test_huge_set_merge_matches_jax_and_the_scalar_engine(seed):
    jm = j_make_mesh({"members": N_SHARDS})
    fleet_a, fleet_b = build_replicas(seed=seed)
    assert max(len(s.entries) for s in fleet_a) > M_CAP_SHARD  # larger than one shard
    got = member_sharded_merge(port_state(fleet_a), port_state(fleet_b), make_mesh(
        {"members": 1}, device="cpu"))
    same(got, j_merge(jax_state(fleet_a, jm), jax_state(fleet_b, jm), jm, "members"))
    assert scalars(got) == [jserde.to_binary(s) for s in scalar_merge(fleet_a, fleet_b)]


def test_partition_and_its_inverse_match_jax():
    fleet_a, _ = build_replicas(seed=13, n_objects=2)
    planes = np_planes(JOrswotBatch.from_scalar(fleet_a, JU))
    parts = partition_dense(*planes, N_SHARDS, M_CAP_SHARD, D_CAP_SHARD)
    jparts = j_partition(*planes, N_SHARDS, M_CAP_SHARD, D_CAP_SHARD)
    for g, w in zip(parts, jparts):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    back = unpartition_dense(*parts, m_cap=M_CAP, d_cap=D_CAP)
    for g, w in zip(back, j_unpartition(*jparts, m_cap=M_CAP, d_cap=D_CAP)):
        np.testing.assert_array_equal(g, w)
    restored = OrswotBatch.from_numpy(*back, device="cpu").to_scalar(PU)
    assert [serde.to_binary(s) for s in restored] == [jserde.to_binary(s) for s in fleet_a]
    for args, kw in (((N_SHARDS, 2, D_CAP_SHARD), {}), ((), {"m_cap": 4, "d_cap": D_CAP})):
        with pytest.raises(ValueError) as pe:
            (partition_dense(*planes, *args) if args else unpartition_dense(*parts, **kw))
        with pytest.raises(ValueError) as je:
            (j_partition(*planes, *args) if args else j_unpartition(*jparts, **kw))
        assert str(pe.value) == str(je.value)


def test_deferred_remove_routes_and_resolves_across_shards():
    """A remove ahead of its clock buffers on the member's shard and
    resolves once a merge brings the covering clock (`orswot.rs:195-211`)."""
    mesh = make_mesh({"members": 1}, device="cpu")
    a = Orswot()
    members = list(range(100, 140))
    for m in members:
        a.apply(a.add(m, a.value().derive_add_ctx("w1")))
    victim = members[5]
    a_future = a.clone()
    a_future.apply(a_future.add(999, a_future.value().derive_add_ctx("w2")))
    rm = a_future.remove(victim, a_future.contains(victim).derive_rm_ctx())
    b = Orswot()
    b.apply(rm)
    assert b.deferred
    want = a_future.clone()
    want.merge(b)
    want.merge(Orswot())  # the plunger
    uni = JUniverse(JConfig(**KW))  # the actors are names: an interning universe
    jm = j_make_mesh({"members": N_SHARDS})
    got = member_sharded_merge(port_state([a_future], uni), port_state([b], uni), mesh)
    got = member_sharded_merge(got, port_state([Orswot()], uni), mesh)
    jgot = j_merge(j_merge(jax_state([a_future], jm, uni), jax_state([b], jm, uni), jm,
                           "members"), jax_state([Orswot()], jm, uni), jm, "members")
    same(got, jgot)
    dense = unpartition_dense(*OrswotBatch(*got).to_numpy(), m_cap=M_CAP, d_cap=D_CAP)
    val = JOrswotBatch(*(jnp.asarray(x) for x in dense)).to_scalar(uni)[0]
    assert victim not in val.value().val
    assert val.value().val == want.value().val and val.entries == want.entries


@pytest.mark.parametrize("base", [200, 300])
def test_sharded_apply_add_then_merge_coherent(base):
    """An add routes to the owning shard; after the clock rebroadcast
    every shard row holds the same clock, equal to the JAX package's and
    the scalar op path's."""
    mesh, jm = make_mesh({"members": 1}, device="cpu"), j_make_mesh({"members": N_SHARDS})
    s = Orswot()
    for m in range(base, base + 30):
        s.apply(s.add(m, s.value().derive_add_ctx(0)))
    want = s.clone()
    ctx = want.value().derive_add_ctx(1)
    want.apply(want.add(777, ctx))
    actor, member = np.array([1], np.int32), np.array([777], np.int32)
    counter = np.array([ctx.dot.counter], np.uint64)
    out = sharded_apply_add(port_state([s]), torch.from_numpy(actor),
                            torch.from_numpy(bias_np(counter)), torch.from_numpy(member), mesh)
    jout = j_apply_add(jax_state([s], jm), jnp.asarray(actor), jnp.asarray(counter),
                       jnp.asarray(member), jm, "members")
    same(out, jout)
    assert scalars(out) == [jserde.to_binary(want)]
    clocks = OrswotBatch(*out).to_numpy()[0]
    for sh in range(1, N_SHARDS):
        np.testing.assert_array_equal(clocks[0], clocks[sh])
    same(rebroadcast_clock(out, mesh), jout)


def test_add_overflow_raises_a_member_overflow():
    """An add with no free slot on its shard overflows the member table."""
    mesh = make_mesh({"members": 1}, device="cpu")
    s = Orswot()
    for m in range(0, 8 * 16, 8):  # sixteen members, all on shard 0
        s.apply(s.add(m, s.value().derive_add_ctx(0)))
    with pytest.raises(CapacityOverflowError) as e:
        sharded_apply_add(port_state([s]), torch.tensor([1], dtype=torch.int32),
                          torch.from_numpy(bias_np(np.array([9], np.uint64))),
                          torch.tensor([8 * 16], dtype=torch.int32), mesh)
    assert (e.value.member, e.value.deferred) == (True, False)


def test_member_sharded_merge_runs_no_collective_without_its_check(monkeypatch):
    """The merge is shard-local: with ``check=False`` it calls no
    collective at all (the check's SUM is the only one)."""
    mesh = make_mesh({"members": 1}, device="cpu")
    fleet_a, fleet_b = build_replicas(seed=17, n_objects=2)
    a, b = port_state(fleet_a), port_state(fleet_b)
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast", "all_to_all", "reduce_scatter"):
        monkeypatch.setattr(dist, name, lambda *x, name=name, **k: calls.append(name))
    member_sharded_merge(a, b, mesh, check=False)
    assert calls == []
    member_sharded_merge(a, b, mesh)
    assert calls == ["all_reduce"]
