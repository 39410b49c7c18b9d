"""Parity of the port's digests (``crdt_tpu_torch.sync.digest``) with the
JAX package's, on the CPU at small sizes, bit for bit: the ORSWOT,
counter and LWW digest bodies over identity and interned universes, u32
counters at 2^31 and 2^32-1 and u64 counters at or above 2^63, twins
that differ only in slot order or capacity, the name salts, the version
vector, the fleet summary and the memo."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.batch.gcounter_batch import GCounterBatch as JaxGCounterBatch
from crdt_tpu.batch.lwwreg_batch import LWWRegBatch as JaxLWWRegBatch
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.pncounter_batch import PNCounterBatch as JaxPNCounterBatch
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.sync import digest as jd
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import (
    CrdtConfig, GCounterBatch, LWWRegBatch, OrswotBatch, PNCounterBatch, Universe,
)
from crdt_tpu_torch.sync import digest as pd
from crdt_tpu_torch.utils.testdata import random_orswot_arrays

torch.set_num_threads(1)

N, A, M, D = 48, 8, 6, 3


def _unis(mode, bits=32, n_members=64):
    """A JAX and a port universe of the same mode; interned ones register
    the same string names (actors in reverse order on the port side when
    ``mode`` is ``"interned_reordered"``, members always in order)."""
    cfg = dict(num_actors=A, member_capacity=M, deferred_capacity=D, counter_bits=bits)
    if mode == "identity":
        return JaxUniverse.identity(JaxConfig(**cfg)), Universe.identity(CrdtConfig(**cfg))
    ju, pu = JaxUniverse(JaxConfig(**cfg)), Universe(CrdtConfig(**cfg))
    for uni in (ju, pu):
        for j in range(n_members):
            uni.member_id(f"m{j}")
    actors = [f"actor-{i}" for i in range(A - 2)]
    for i in actors:
        ju.actor_idx(i)
    for i in actors:
        pu.actor_idx(i)
    return ju, pu


def _orswot_planes(seed, bits=32, edge=None, deferred=0.4):
    rng = np.random.RandomState(seed)
    dt = np.uint32 if bits == 32 else np.uint64
    clock, ids, dots, d_ids, d_clocks = random_orswot_arrays(rng, N, A, M, D, dtype=dt,
                                                            deferred_frac=deferred)
    if edge is not None:
        for x in (dots, d_clocks):
            nz = x != 0
            x[nz] = np.asarray(edge, dtype=dt)[rng.randint(0, len(edge), size=int(nz.sum()))]
        clock = np.maximum(clock, dots.max(axis=1))
    return clock, ids, dots, d_ids, d_clocks


def _port(planes):
    return OrswotBatch.from_numpy(*planes, device="cpu")


def _jax_digest(planes, juni):
    return jd.orswot_digest(*(jnp.asarray(x) for x in planes), juni)


EDGES = {
    "u32": (32, None),
    "u32_2p31": (32, [1, 2**31 - 1, 2**31, 2**31 + 1]),
    "u32_max": (32, [2**32 - 1, 2**32 - 2, 1]),
    "u64_2p63": (64, [2**63, 2**63 + 7, 2**64 - 1, 3]),
}


@pytest.mark.parametrize("mode", ["identity", "interned"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_orswot_digest_matches_jax(mode, edge):
    bits, vals = EDGES[edge]
    ju, pu = _unis(mode, bits)
    planes = _orswot_planes(3, bits, vals)
    want = _jax_digest(planes, ju if mode != "identity" else None)
    b = _port(planes)
    got = pd.orswot_digest(b.clock, b.ids, b.dots, b.d_ids, b.d_clocks,
                           pu if mode != "identity" else None)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    # the universe-free call is what an identity universe derives
    if mode == "identity":
        np.testing.assert_array_equal(pd.digest_of(b, pu), want)


def test_digest_rows_do_not_depend_on_the_chunking(monkeypatch):
    planes = _orswot_planes(5)
    b = _port(planes)
    whole = pd.orswot_digest(b.clock, b.ids, b.dots, b.d_ids, b.d_clocks)
    monkeypatch.setattr(pd, "_CHUNK_CELLS", 7 * (M + D) * A)  # 7 rows per chunk
    chunked = pd.orswot_digest(b.clock, b.ids, b.dots, b.d_ids, b.d_clocks)
    np.testing.assert_array_equal(chunked, whole)
    np.testing.assert_array_equal(whole, _jax_digest(planes, None))


def test_interned_digest_is_independent_of_the_interning_order():
    ju, pu = _unis("interned")
    planes = _orswot_planes(9)
    b = _port(planes)
    want = pd.digest_of(b, pu)
    # a second universe that interned the same actor names the other way
    # round: the same state, with its actor columns permuted to match
    cfg = pu.config
    pu2 = Universe(CrdtConfig(num_actors=A, member_capacity=M, deferred_capacity=D,
                              counter_bits=32))
    for j in range(len(pu.members)):
        pu2.member_id(pu.members.lookup(j))
    names = [pu.actors.lookup(i) for i in range(len(pu.actors))][::-1]
    for name in names:
        pu2.actor_idx(name)
    perm = [pu.actor_idx(n) for n in names] + list(range(len(names), cfg.num_actors))
    clock, ids, dots, d_ids, d_clocks = planes
    twin = _port((clock[:, perm], ids, dots[:, :, perm], d_ids, d_clocks[:, :, perm]))
    np.testing.assert_array_equal(pd.digest_of(twin, pu2), want)
    np.testing.assert_array_equal(want, _jax_digest(planes, ju))


def test_slot_order_and_capacity_twins_share_a_digest():
    planes = _orswot_planes(11)
    b = _port(planes)
    want = _jax_digest(planes, None)
    rng = np.random.RandomState(0)
    perm = torch.from_numpy(rng.permutation(M))
    dperm = torch.from_numpy(rng.permutation(D))
    shuffled = OrswotBatch(clock=b.clock, ids=b.ids[:, perm], dots=b.dots[:, perm],
                           d_ids=b.d_ids[:, dperm], d_clocks=b.d_clocks[:, dperm])
    grown = b.with_capacity(4 * M, 2 * D)
    for twin in (shuffled, grown):
        np.testing.assert_array_equal(pd.digest_of(twin), want)
    # and the JAX digest of the grown twin agrees
    np.testing.assert_array_equal(_jax_digest(grown.to_numpy(), None), want)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("mode", ["identity", "interned"])
@pytest.mark.parametrize("shape", ["gcounter", "pncounter"])
def test_counter_digest_matches_jax(bits, mode, shape):
    ju, pu = _unis(mode, bits)
    rng = np.random.RandomState(bits + len(shape))
    dt = np.uint32 if bits == 32 else np.uint64
    tail = (A,) if shape == "gcounter" else (2, A)
    top = 2**bits - 1
    vals = np.asarray([0, 0, 1, 5, 2**31, top, top - 1], dtype=dt)
    planes = vals[rng.randint(0, len(vals), size=(N,) + tail)]
    cls = GCounterBatch if shape == "gcounter" else PNCounterBatch
    port = cls.from_numpy(planes, device="cpu")
    want = jd.counter_digest(jnp.asarray(planes), ju if mode != "identity" else None)
    got = pd.counter_digest(port.clocks if shape == "gcounter" else port.planes,
                            pu if mode != "identity" else None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pd.digest_of(port, pu if mode != "identity" else None), want)


@pytest.mark.parametrize("mode", ["identity", "interned"])
def test_lww_digest_matches_jax(mode):
    ju, pu = _unis(mode)
    rng = np.random.RandomState(4)
    vals = rng.randint(0, 64, size=N).astype(np.uint64)
    vals[:3] = [2**63, 2**64 - 1, 100]  # ids past the member table clip high
    markers = rng.randint(1, 1 << 40, size=N).astype(np.uint64)
    markers[:2] = [2**63 + 1, 2**64 - 1]
    port = LWWRegBatch.from_numpy(vals, markers, device="cpu")
    want = jd.lww_digest(jnp.asarray(vals), jnp.asarray(markers),
                         ju if mode != "identity" else None)
    np.testing.assert_array_equal(pd.digest_of(port, pu if mode != "identity" else None), want)


@pytest.mark.parametrize("name", [0, 7, 2**40, -3, "alice", "", b"\x00bytes", ("t", 1), 2.5,
                                  True])
def test_stable_name_salt_matches_jax(name):
    for domain in (pd._T_ASALT, pd._T_MSALT):
        assert pd.stable_name_salt(name, domain) == jd.stable_name_salt(name, domain)


def test_salt_tables_match_jax():
    ju, pu = _unis("interned")
    np.testing.assert_array_equal(pd.actor_salt_table(pu), jd.actor_salt_table(ju))
    np.testing.assert_array_equal(pd.member_salt_table(pu), jd.member_salt_table(ju))
    np.testing.assert_array_equal(pd.actor_salt_table(None, num_actors=5),
                                  jd.actor_salt_table(None, num_actors=5))
    assert pd.member_salt_table(Universe.identity()) is None


@pytest.mark.parametrize("bits", [32, 64])
def test_version_vector_and_fleet_summary_match_jax(bits):
    edge = EDGES["u32_max" if bits == 32 else "u64_2p63"][1]
    planes = _orswot_planes(13, bits, edge)
    jb = JaxOrswotBatch(*(jnp.asarray(x) for x in planes))
    pb = _port(planes)
    np.testing.assert_array_equal(pd.version_vector(pb), jd.version_vector(jb))
    pn = np.random.RandomState(2).randint(0, 9, size=(N, 2, A)).astype(
        np.uint32 if bits == 32 else np.uint64)
    np.testing.assert_array_equal(
        pd.version_vector(PNCounterBatch.from_numpy(pn, device="cpu")),
        jd.version_vector(JaxPNCounterBatch(planes=jnp.asarray(pn))))
    np.testing.assert_array_equal(
        pd.version_vector(GCounterBatch.from_numpy(pn[:, 0], device="cpu")),
        jd.version_vector(JaxGCounterBatch(clocks=jnp.asarray(pn[:, 0]))))
    lww = (np.arange(4, dtype=np.uint64), np.arange(1, 5, dtype=np.uint64))
    assert pd.version_vector(LWWRegBatch.from_numpy(*lww, device="cpu")) is None
    assert jd.version_vector(JaxLWWRegBatch(*(jnp.asarray(x) for x in lww))) is None
    empty = OrswotBatch.zeros(0, _unis("identity", bits)[1], device="cpu")
    np.testing.assert_array_equal(pd.version_vector(empty), np.zeros(A, np.uint64))
    d = pd.digest_of(pb)
    assert pd.fleet_summary(d) == jd.fleet_summary(d)
    assert pd.fleet_summary(np.zeros(0, np.uint64)) == (0, 0)


def test_digest_follows_in_place_writes():
    """Torch planes are mutable: the digest, its tree and the version
    vector are computed from the planes as they are at the call."""
    b = _port(_orswot_planes(17))
    first = pd.digest_of(b)
    np.testing.assert_array_equal(pd.digest_of(b.with_capacity(2 * M)), first)
    tree = pd.digest_tree_of(b)
    assert tree.n == N
    vv = pd.version_vector(b)
    b.clock[3, 0] = b.clock[3, 0] + 1
    moved = pd.digest_of(b)
    assert (moved != first).nonzero()[0].tolist() == [3]
    assert pd.digest_tree_of(b).root != tree.root
    assert pd.version_vector(b)[0] == max(vv[0], int(b.to_numpy()[0][3, 0]))
    with pytest.raises(TypeError, match="no digest"):
        pd.digest_of(object())
