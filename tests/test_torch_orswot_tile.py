"""Parity of the port's tile merge (plain version of the K2/K3 kernels,
``crdt_tpu_torch.ops.orswot_tile``) with the JAX package's Pallas
kernels run in interpret mode and with its unrolled merge, which is the
same tile math as plain jnp.  Exact equality throughout, overflow flags
included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.ops import orswot_ops as jops, orswot_pallas, orswot_unrolled
from crdt_tpu.utils.testdata import anti_entropy_fleets, random_orswot_arrays
from crdt_tpu_torch import OrswotBatch
from crdt_tpu_torch.ops import orswot_tile

torch.set_num_threads(1)

NAMES = ("clock", "ids", "dots", "d_ids", "d_clocks", "overflow")


def _port(planes):
    b = OrswotBatch.from_numpy(*planes, device="cpu")
    return b.clock, b.ids, b.dots, b.d_ids, b.d_clocks


def _unport(out):
    return OrswotBatch(*out[:5]).to_numpy() + (out[5].numpy(),)


def _assert_same(want, got):
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _full_range(rng, planes):
    """Counters spread over the whole u32 range, clocks covering dots."""
    clock, ids, dots, d_ids, d_clocks = (np.array(x) for x in planes)
    vals = np.array([1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    for x in (dots, d_clocks):
        nz = x != 0
        x[nz] = vals[rng.randint(0, len(vals), size=int(nz.sum()))]
    clock = np.maximum(clock, dots.max(axis=-2))
    clock[rng.rand(*clock.shape) < 0.1] = np.uint32(2**32 - 1)
    return clock, ids, dots, d_ids, d_clocks


def _pair(seed, n, a, m, d, full_range=False, **kw):
    rng = np.random.RandomState(seed)
    a_np = random_orswot_arrays(rng, n, a, m, d, **kw)
    b_np = random_orswot_arrays(rng, n, a, m, d, **kw)
    if full_range:
        a_np, b_np = _full_range(rng, a_np), _full_range(rng, b_np)
    return a_np, b_np


@pytest.mark.parametrize("case", [
    # (seed, n, a, m, d, m_cap, d_cap, kwargs)
    (0, 13, 8, 6, 2, 6, 2, {"max_counter": 5, "deferred_frac": 0.5}),
    (1, 29, 16, 8, 3, 8, 3, {"max_counter": 4, "deferred_frac": 1.0}),
    (2, 7, 4, 5, 2, 3, 1, {"max_counter": 3, "deferred_frac": 0.7}),  # overflow
    (3, 17, 8, 6, 2, 6, 2, {"max_counter": 5, "deferred_frac": 0.5, "full_range": True}),
    (4, 11, 33, 4, 2, 4, 2, {"max_counter": 9}),  # A not a multiple of 32
    (14, 37, 13, 5, 3, 5, 3, {"max_counter": 5, "deferred_frac": 0.6}),
    (15, 23, 8, 32, 2, 32, 2, {"max_counter": 5, "deferred_frac": 0.5, "min_live": 12}),
    # stages too wide for the card's shared memory: the kernel's direct route
    (16, 5, 256, 64, 2, 64, 2, {"max_counter": 5, "deferred_frac": 0.5, "min_live": 24}),
], ids=["deferred", "dense_deferred", "overflow", "full_range", "odd_actors", "odd_widths",
        "m_32", "wide_actors"])
def test_merge_reference_matches_unrolled(case):
    seed, n, a, m, d, m_cap, d_cap, kw = case
    a_np, b_np = _pair(seed, n, a, m, d, **kw)
    want = orswot_unrolled.merge_unrolled(*map(jnp.asarray, a_np), *map(jnp.asarray, b_np),
                                          m_cap, d_cap)
    got = orswot_tile.merge_reference(*_port(a_np), *_port(b_np), m_cap, d_cap)
    _assert_same(want, _unport(got))


def test_merge_reference_matches_pallas_interpret_with_overflow():
    """Ragged n (not a tile multiple) with forced member overflow."""
    a_np, b_np = _pair(5, 9, 8, 6, 2, max_counter=4, deferred_frac=0.6, min_live=4)
    want = orswot_pallas.merge(*map(jnp.asarray, a_np), *map(jnp.asarray, b_np), 4, 2,
                               interpret=True)
    got = _unport(orswot_tile.merge_reference(*_port(a_np), *_port(b_np), 4, 2))
    assert got[5][:, 0].any()
    _assert_same(want, got)


def test_fold_reference_matches_pallas_interpret():
    rng = np.random.RandomState(6)
    fl = anti_entropy_fleets(rng, 9, 8, 6, 2, 3, base=3, novel=1, deferred_frac=0.5)
    st = tuple(np.stack([f[k] for f in fl]) for k in range(5))
    want = orswot_pallas.fold_merge(*map(jnp.asarray, st), 6, 2, interpret=True)
    got = orswot_tile.fold_merge_reference(*_port(st), 6, 2)
    _assert_same(want, _unport(got))


def _fleet_stack(seed, n, a, m, d, r, **kw):
    fl = anti_entropy_fleets(np.random.RandomState(seed), n, a, m, d, r, **kw)
    return tuple(np.stack([f[k] for f in fl]) for k in range(5))


def _dup_ids(st):
    """Replica 1 holds one id in two rows of every other object (invalid
    state, which the kernels still fold exactly)."""
    ids = st[1].copy()
    ids[1, ::2, 1] = ids[1, ::2, 0]
    return (st[0], ids) + st[2:]


@pytest.mark.parametrize("case", [
    # (seed, n, a, m, d, r, m_cap, d_cap, fleet kwargs, duplicate ids)
    (20, 23, 8, 6, 2, 3, 8, 3, {"base": 3, "novel": 1}, False),
    (21, 17, 16, 6, 2, 1, 6, 2, {"base": 4, "novel": 1}, False),
    (22, 19, 8, 6, 2, 3, 6, 2, {"base": 3, "novel": 1}, True),
], ids=["m_cap_d_cap_differ", "one_replica_plunger", "duplicate_ids"])
def test_fold_matches_pallas_interpret(case):
    """``orswot_tile.fold_merge`` on CPU tensors against the JAX fold
    kernel run in interpret mode: capacities other than the replicas',
    one replica with the plunger, and a replica with duplicate ids."""
    seed, n, a, m, d, r, m_cap, d_cap, kw, dup = case
    st = _fleet_stack(seed, n, a, m, d, r, deferred_frac=0.5, **kw)
    if dup:
        st = _dup_ids(st)
    want = orswot_pallas.fold_merge(*map(jnp.asarray, st), m_cap, d_cap, interpret=True)
    got = orswot_tile.fold_merge(*_port(st), m_cap, d_cap, prebiased=True)
    _assert_same(want, _unport(got))


def test_fold_wide_actors_matches_sequential_unrolled_fold():
    """Widths whose footprint takes the fold kernel's direct route on the
    card (A=256, M=64), against the JAX sequential unrolled fold."""
    st = _fleet_stack(23, 5, 256, 64, 2, 3, base=24, novel=4, deferred_frac=0.5)
    want = jops.fold_merge_sequential(*map(jnp.asarray, st), 64, 2, impl="unrolled")
    got = orswot_tile.fold_merge(*_port(st), 64, 2, prebiased=True)
    _assert_same(want, _unport(got))


@pytest.mark.parametrize("plunger", [True, False])
def test_fold_reference_is_the_sequential_unrolled_fold(plunger):
    rng = np.random.RandomState(9)
    fl = anti_entropy_fleets(rng, 21, 8, 8, 2, 5, base=3, novel=1, deferred_frac=0.5)
    st = tuple(np.stack([f[k] for f in fl]) for k in range(5))
    want = jops.fold_merge_sequential(*map(jnp.asarray, st), 8, 2, plunger=plunger,
                                      impl="unrolled")
    got = orswot_tile.fold_merge(*_port(st), 8, 2, plunger=plunger, prebiased=True)
    _assert_same(want, _unport(got))


def test_wrappers_take_uint32_and_round_trip_prebiased():
    a_np, b_np = _pair(12, 10, 8, 6, 2, max_counter=5, deferred_frac=0.5, full_range=True)
    u32 = lambda planes: tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in planes)  # noqa: E731
    out = orswot_tile.merge(*u32(a_np), *u32(b_np), 6, 2)
    assert out[0].dtype == torch.uint32 and out[2].dtype == torch.uint32
    biased = orswot_tile.merge(*_port(a_np), *_port(b_np), 6, 2, prebiased=True)
    back = orswot_tile.to_kernel_domain(out[:5])
    for x, y in zip(back + (out[5],), biased):
        assert torch.equal(x, y)
    with pytest.raises(TypeError):
        orswot_tile.merge(*_port(a_np), *_port(b_np), 6, 2)  # biased without prebiased
    with pytest.raises(TypeError):
        orswot_tile.merge(*u32(a_np), *u32(b_np), 6, 2, prebiased=True)


def test_merge_flattens_leading_batch_axes():
    """The tree fold calls merge on [R/2, N, ...] planes."""
    rng = np.random.RandomState(13)
    fl = anti_entropy_fleets(rng, 8, 8, 8, 2, 4, base=3, novel=1, deferred_frac=0.5)
    st = _port(tuple(np.stack([f[k] for f in fl]) for k in range(5)))
    lhs = tuple(x[0::2].contiguous() for x in st)
    rhs = tuple(x[1::2].contiguous() for x in st)
    batched = orswot_tile.merge(*lhs, *rhs, 8, 2, prebiased=True)
    for r in range(2):
        one = orswot_tile.merge(*(x[r] for x in lhs), *(x[r] for x in rhs), 8, 2,
                                prebiased=True)
        for x, y in zip(batched, one):
            assert torch.equal(x[r], y)
