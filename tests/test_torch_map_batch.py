"""Parity of the port's MapBatch with the JAX package's, fed the same
planes (``MapBatch.from_numpy`` of the JAX batch's numpy leaves), for
``Map<K, MVReg>``, ``Map<K, Orswot>`` and ``Map<K, Map<K2, MVReg>>``:
merge both ways (overflow flags included), truncate, ``apply_up``
(``apply_put``, ``apply_add``, ``apply_remove``), ``apply_rm``,
``with_capacity`` and unified merges of mismatched kernels,
``OrswotBatch.truncate``, a ``JoinExecutor`` regrow of a Map fleet,
``len_counts``/``contains``, the scalar round trip and ``kernel_to_spec``.
Bit-equal planes throughout, with counters at and above 2^31 (u32) and
2^63 (u64).  The JAX side runs on the CPU, where its nested ORSWOT merge
takes ``rank``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_tpu.batch import map_batch as jax_map_batch
from crdt_tpu.batch.map_batch import MapBatch as JaxMapBatch
from crdt_tpu.batch.orswot_batch import OrswotBatch as JaxOrswotBatch
from crdt_tpu.batch.val_kernels import (
    MapKernel as JaxMapKernel, MVRegKernel as JaxMVRegKernel, OrswotKernel as JaxOrswotKernel,
    kernel_to_spec as jax_kernel_to_spec,
)
from crdt_tpu.config import CrdtConfig as JaxConfig
from crdt_tpu.error import CapacityOverflowError as JaxCapacityOverflowError
from crdt_tpu.parallel import JoinExecutor as JaxJoinExecutor, JoinStats as JaxJoinStats
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu.utils.serde import from_binary as jax_from_binary, to_binary as jax_to_binary
from crdt_tpu_torch import (
    CapacityOverflowError, CrdtConfig, JoinExecutor, JoinStats, MapBatch, MapKernel,
    MVRegKernel, OrswotBatch, OrswotKernel, Universe,
)
from crdt_tpu_torch.batch.val_kernels import kernel_from_spec, kernel_to_spec
from crdt_tpu_torch.dtypes import as_counters
from crdt_tpu_torch.utils.serde import from_binary, to_binary
from crdt_tpu_torch.utils.testdata import random_map, random_orswot_arrays

torch.set_num_threads(1)

N, A, KEYS = 40, 6, 5
KINDS = ("mvreg", "orswot", "map")
BITS = [(32, False), (32, True), (64, False), (64, True)]


def _counters(bits, big):
    top = 1 << (bits - 1)
    return (1, 2, 3, 4, 5) + ((top, top + 1, top + 2) if big else ())


def _flat(tree):
    return [x for t in tree for x in _flat(t)] if isinstance(tree, tuple) else [tree]


def _need(maps):
    """The capacities the scalar maps need: key, deferred, antichain and
    member slots over every nesting level."""
    need = dict(key_capacity=1, deferred_capacity=1, mv_capacity=1, member_capacity=1)

    def walk(v):
        if hasattr(v, "entries") and hasattr(v, "val_type"):
            need["key_capacity"] = max(need["key_capacity"], len(v.entries))
            for e in v.entries.values():
                walk(e.val)
        elif hasattr(v, "entries"):
            need["member_capacity"] = max(need["member_capacity"], len(v.entries))
        else:
            need["mv_capacity"] = max(need["mv_capacity"], len(v.vals))
            return
        rows = sum(len(s) for s in v.deferred.values())
        need["deferred_capacity"] = max(need["deferred_capacity"], rows)

    for m in maps:
        walk(m)
    return need


def _setup(kind, bits, maps, **over):
    """Both packages' universes and value kernels for ``maps`` (capacities
    just large enough for every input)."""
    kw = dict(num_actors=A, counter_bits=bits, **{**_need(maps), **over})
    juni, uni = JaxUniverse.identity(JaxConfig(**kw)), Universe.identity(CrdtConfig(**kw))
    jc, pc = juni.config, uni.config
    if kind == "mvreg":
        return juni, uni, JaxMVRegKernel.from_config(jc), MVRegKernel.from_config(pc)
    if kind == "orswot":
        return juni, uni, JaxOrswotKernel.from_config(jc), OrswotKernel.from_config(pc)
    return (juni, uni, JaxMapKernel.from_config(jc, JaxMVRegKernel.from_config(jc)),
            MapKernel.from_config(pc, MVRegKernel.from_config(pc)))


def _maps(kind, bits, seed, big=False, n=N, forks=2, n_keys=KEYS):
    """``forks`` replica lists of ``n`` scalar maps grown from shared bases."""
    rng = np.random.RandomState(seed)
    kw = dict(n_keys=n_keys, n_actors=A, counters=_counters(bits, big))
    base = [random_map(rng, kind, **kw) for _ in range(n)]
    return [[random_map(rng, kind, m=m.clone(), **kw) for m in base] for _ in range(forks)]


def _jax(maps, juni, jvk):
    return JaxMapBatch.from_scalar([jax_from_binary(to_binary(m)) for m in maps], juni, jvk)


def _port(jb, uni, vk):
    state = jax.tree.map(np.asarray, jb.state)
    return MapBatch.from_numpy(*state, MapKernel.from_config(uni.config, vk), device="cpu")


def _same(port_state, jax_state, kernel):
    got, want = _flat(kernel.to_numpy_vals(port_state)), jax.tree_util.tree_leaves(jax_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits,big", BITS)
def test_merge_both_ways_matches_jax(kind, bits, big):
    a, b = _maps(kind, bits, 10 + bits + big, big)
    juni, uni, jvk, vk = _setup(kind, bits, a + b)
    ja, jb = _jax(a, juni, jvk), _jax(b, juni, jvk)
    pa, pb = _port(ja, uni, vk), _port(jb, uni, vk)
    assert bool((np.asarray(ja.d_keys) != -1).any())
    flagged = 0
    for (j1, j2), (p1, p2) in (((ja, jb), (pa, pb)), ((jb, ja), (pb, pa)), ((ja, ja), (pa, pa))):
        want, want_over = jax_map_batch._merge(j1.state, j2.state, j1.kernel)
        got, got_over = p1.kernel.merge(p1.state, p2.state)
        _same(got, want, p1.kernel)
        np.testing.assert_array_equal(got_over.numpy(), np.asarray(want_over))
        flagged += int(got_over.sum())
        _same(p1.merge(p2, check=False).state, want, p1.kernel)
    if flagged:
        with pytest.raises(JaxCapacityOverflowError):
            ja.merge(jb) if bool(jax_map_batch._merge(ja.state, jb.state, ja.kernel)[1].any()) \
                else jb.merge(ja)
        with pytest.raises(CapacityOverflowError) as e:
            pa.merge(pb) if bool(pa.kernel.merge(pa.state, pb.state)[1].any()) else pb.merge(pa)
        assert (e.value.member, e.value.deferred) == (True, True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits,big", [(32, True), (64, True)])
def test_truncate_matches_jax(kind, bits, big):
    (a,) = _maps(kind, bits, 20 + bits, big, forks=1)
    juni, uni, jvk, vk = _setup(kind, bits, a)
    ja = _jax(a, juni, jvk)
    pa = _port(ja, uni, vk)
    rng = np.random.RandomState(bits)
    t = np.array(ja.clock)
    t[::3] = np.asarray(_counters(bits, big), t.dtype)[rng.randint(0, 6, size=t[::3].shape)]
    t[1::3] = 0
    want = ja.truncate(jnp.asarray(t), check=False)
    _same(pa.truncate(t).state, want.state, pa.kernel)
    want_state, want_over = jax_map_batch._truncate(ja.state, jnp.asarray(t), ja.kernel)
    got_state, got_over = pa.kernel.truncate(pa.state, as_counters(t, pa.clock.dtype, "cpu"))
    _same(got_state, want_state, pa.kernel)
    np.testing.assert_array_equal(got_over.numpy(), np.asarray(want_over))


def _up_args(op, ja, rng, bits):
    """Per-object ``apply_up`` arguments: the map dot (some already seen),
    the key (some new, some absent from every table) and the nested op's
    arguments."""
    n = ja.clock.shape[0]
    clock = np.asarray(ja.clock)
    dt = clock.dtype
    actor = rng.randint(0, A, size=n).astype(np.int32)
    counter = (clock[np.arange(n), actor] + rng.randint(0, 3, size=n)).astype(dt)
    counter[::7] = np.asarray(1 << (bits - 1), dt)
    key = rng.randint(0, KEYS + 2, size=n).astype(np.int32)
    if op == "apply_put":
        op_clock = np.zeros((n, A), dt)
        op_clock[np.arange(n), actor] = counter
        return actor, counter, key, (op_clock, rng.randint(0, 9, size=n).astype(dt))
    if op == "apply_add":
        return actor, counter, key, (actor, counter, rng.randint(0, 9, size=n).astype(np.int32))
    rm = np.asarray(ja.clock).copy()
    rm[::2] += rng.randint(0, 2, size=rm[::2].shape).astype(dt)
    return actor, counter, key, (rm, rng.randint(0, 9, size=n).astype(np.int32))


@pytest.mark.parametrize("op", ["apply_put", "apply_add", "apply_remove"])
@pytest.mark.parametrize("bits", [32, 64])
def test_apply_up_matches_jax(op, bits):
    kind = "mvreg" if op == "apply_put" else "orswot"
    (a,) = _maps(kind, bits, 30 + bits, True, forks=1)
    juni, uni, jvk, vk = _setup(kind, bits, a)
    ja = _jax(a, juni, jvk)
    pa = _port(ja, uni, vk)
    actor, counter, key, nested = _up_args(op, ja, np.random.RandomState(bits + len(op)), bits)
    jargs = tuple(jnp.asarray(x) for x in nested)
    want, want_over = jax_map_batch._apply_up(ja.state, jnp.asarray(actor), jnp.asarray(counter),
                                              jnp.asarray(key), jargs, op, ja.kernel)
    got = pa.apply_up(actor, counter, key, op, nested, check=False)
    _same(got.state, want, pa.kernel)
    if bool(np.asarray(want_over).any()):
        with pytest.raises(ValueError, match="apply_up overflow"):
            pa.apply_up(actor, counter, key, op, nested)
    else:
        _same(pa.apply_up(actor, counter, key, op, nested).state, want, pa.kernel)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [32, 64])
def test_apply_rm_matches_jax(kind, bits):
    (a,) = _maps(kind, bits, 40 + bits, True, forks=1)
    juni, uni, jvk, vk = _setup(kind, bits, a, deferred_capacity=_need(a)["deferred_capacity"])
    ja = _jax(a, juni, jvk)
    pa = _port(ja, uni, vk)
    rng = np.random.RandomState(bits)
    rm = np.asarray(ja.clock).copy()
    rm[::2] += rng.randint(0, 2, size=rm[::2].shape).astype(rm.dtype)
    rm[::5] = 0
    key = rng.randint(0, KEYS + 1, size=rm.shape[0]).astype(np.int32)
    want, want_over = jax_map_batch._apply_rm(ja.state, jnp.asarray(rm), jnp.asarray(key),
                                              ja.kernel)
    _same(pa.apply_rm(rm, key, check=False).state, want, pa.kernel)
    if bool(np.asarray(want_over).any()):
        with pytest.raises(ValueError, match="apply_rm overflow"):
            pa.apply_rm(rm, key)


@pytest.mark.parametrize("kind", KINDS)
def test_with_capacity_and_unified_merges_match_jax(kind):
    a, b = _maps(kind, 64, 50, True)
    juni, uni, jvk, vk = _setup(kind, 64, a + b)
    ja, jb = _jax(a, juni, jvk), _jax(b, juni, jvk)
    pa, pb = _port(ja, uni, vk), _port(jb, uni, vk)
    k, d = pa.member_capacity, pa.deferred_capacity
    jg, pg = ja.with_capacity(2 * k, d + 3), pa.with_capacity(2 * k, d + 3)
    assert pg.kernel == MapKernel(2 * k, d + 3, A, vk.grown(2), 64)
    assert (pg.member_capacity, pg.deferred_capacity) == (2 * k, d + 3)
    _same(pg.state, jg.state, pg.kernel)
    assert pa.with_capacity(k, d) is pa
    with pytest.raises(ValueError, match="shrink"):
        pa.with_capacity(k - 1)
    # capacity-only mismatches unify to the pointwise max, both ways
    _same(pg.merge(pb, check=False).state, jg.merge(jb, check=False).state, pg.kernel)
    _same(pb.merge(pg, check=False).state, jb.merge(jg, check=False).state, pg.kernel)
    other = MapKernel.from_config(CrdtConfig(num_actors=A + 1, counter_bits=64), vk)
    with pytest.raises(ValueError, match="incompatible"):
        pa.kernel.unified(other)


@pytest.mark.parametrize("bits", [32, 64])
def test_orswot_batch_truncate_matches_jax(bits):
    dt = np.uint32 if bits == 32 else np.uint64
    planes = random_orswot_arrays(np.random.RandomState(bits), 48, A, 6, 3, dtype=dt,
                                  deferred_frac=0.4)
    t = np.array(planes[0])
    t[::2] = np.random.RandomState(1).randint(0, 60, size=t[::2].shape)
    t[::5] = 0
    want = JaxOrswotBatch(*(jnp.asarray(x) for x in planes)).truncate(jnp.asarray(t))
    got = OrswotBatch.from_numpy(*planes, device="cpu").truncate(t)
    for g, w in zip(got.to_numpy(), (want.clock, want.ids, want.dots, want.d_ids, want.d_clocks)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_executor_regrows_a_map_fleet_as_jax():
    fleets = _maps("orswot", 32, 60, forks=4, n=24, n_keys=16)
    juni, uni, jvk, vk = _setup("orswot", 32, [m for f in fleets for m in f])
    jf = [_jax(f, juni, jvk) for f in fleets]
    pf = [_port(j, uni, vk) for j in jf]
    jstats, stats = JaxJoinStats(), JoinStats()
    want = JaxJoinExecutor(strategy="sequential").join_all(jf, stats=jstats)
    got = JoinExecutor().join_all(pf, stats=stats)
    assert stats.overflow_regrows == jstats.overflow_regrows > 0
    assert (stats.final_member_capacity, stats.final_deferred_capacity) == (
        jstats.final_member_capacity, jstats.final_deferred_capacity)
    _same(got.state, want.state, got.kernel)


def test_len_counts_contains_and_scalar_round_trip():
    (a,) = _maps("map", 64, 70, True, forks=1)
    juni, uni, jvk, vk = _setup("map", 64, a)
    ja = _jax(a, juni, jvk)
    # both packages' states decoded from the same bytes (entry order is
    # insertion order)
    pa = MapBatch.from_scalar([from_binary(to_binary(m)) for m in a], uni, vk, device="cpu")
    _same(pa.state, ja.state, pa.kernel)
    np.testing.assert_array_equal(pa.len_counts().numpy(), np.asarray(ja.len_counts()))
    key = np.arange(len(a), dtype=np.int32) % (KEYS + 1)
    np.testing.assert_array_equal(pa.contains(key).numpy(),
                                  np.asarray(ja.contains(jnp.asarray(key))))
    assert [to_binary(s) for s in pa.to_scalar(uni)] == [to_binary(m) for m in a]
    assert [to_binary(s) for s in pa.to_scalar(uni)] == [
        jax_to_binary(jax_from_binary(to_binary(m))) for m in a]
    z = MapBatch.zeros(3, uni, vk, device="cpu")
    _same(z.state, JaxMapBatch.zeros(3, juni, jvk).state, z.kernel)


def test_kernel_spec_round_trips_as_jax():
    cfg, jcfg = CrdtConfig(num_actors=A), JaxConfig(num_actors=A)
    kernels = [
        (MVRegKernel.from_config(cfg), JaxMVRegKernel.from_config(jcfg)),
        (OrswotKernel.from_config(cfg), JaxOrswotKernel.from_config(jcfg)),
        (MapKernel.from_config(cfg, MapKernel.from_config(cfg, OrswotKernel.from_config(cfg))),
         JaxMapKernel.from_config(jcfg, JaxMapKernel.from_config(
             jcfg, JaxOrswotKernel.from_config(jcfg)))),
    ]
    for k, jk in kernels:
        assert kernel_to_spec(k) == jax_kernel_to_spec(jk)
        assert kernel_from_spec(kernel_to_spec(k)) == k
    with pytest.raises(ValueError, match="counter_bits"):
        MapKernel.from_config(CrdtConfig(counter_bits=32), MVRegKernel.from_config(cfg))


def test_nested_sets_merge_alike_by_the_tile_path_and_rank():
    """On the CPU the tile path is the merge kernel's plain version: the
    nested ORSWOT merge, truncate and settle agree with ``rank``."""
    a, b = _maps("orswot", 32, 80, True)
    juni, uni, _, vk = _setup("orswot", 32, a + b)
    tile = MapKernel.from_config(uni.config, OrswotKernel(vk.member_capacity,
                                                          vk.deferred_capacity, A, 32, "pallas"))
    pa = MapBatch.from_scalar(a, uni, vk, device="cpu")
    pb = MapBatch.from_scalar(b, uni, vk, device="cpu")
    want = pa.kernel.merge(pa.state, pb.state)
    got = tile.merge(pa.state, pb.state)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
