"""Parity of the port's GSetBatch with the JAX package: the union at one
width and at mixed widths, ``with_capacity``, ``insert``/``contains``,
the member-id check, and the scalar round trip."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from crdt_tpu.batch.gset_batch import GSetBatch as JaxGSetBatch
from crdt_tpu.scalar.gset import GSet as JaxGSet
from crdt_tpu.utils.interning import Universe as JaxUniverse
from crdt_tpu_torch import GSetBatch, Universe
from crdt_tpu_torch.scalar import GSet

torch.set_num_threads(1)

N = 128


def _bits(seed, u):
    return np.random.RandomState(seed).rand(N, u) < 0.2


def _pair(wa, wb):
    a, b = _bits(wa, wa), _bits(wb + 1, wb)
    return ((JaxGSetBatch(bits=jnp.asarray(a)), JaxGSetBatch(bits=jnp.asarray(b))),
            (GSetBatch.from_numpy(a, device="cpu"), GSetBatch.from_numpy(b, device="cpu")))


@pytest.mark.parametrize("wa,wb", [(64, 64), (16, 64), (64, 33)])
def test_merge_widens_and_unions_as_jax(wa, wb):
    (ja, jb), (pa, pb) = _pair(wa, wb)
    got = pa.merge(pb)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(ja.merge(jb).bits))
    assert got.member_capacity == max(wa, wb) and got.deferred_capacity == 0
    np.testing.assert_array_equal(pb.merge(pa, check=False).to_numpy(), np.asarray(jb.merge(ja).bits))


def test_with_capacity_as_jax():
    (ja, _), (pa, _) = _pair(16, 16)
    np.testing.assert_array_equal(pa.with_capacity(40).to_numpy(),
                                  np.asarray(ja.with_capacity(40).bits))
    assert pa.with_capacity(16) is pa
    for kw, match in (({"member_capacity": 8}, "shrink"), ({"deferred_capacity": 2}, "deferred")):
        with pytest.raises(ValueError, match=match):
            ja.with_capacity(**kw)
        with pytest.raises(ValueError, match=match):
            pa.with_capacity(**kw)


def test_insert_and_contains_match_jax():
    (ja, _), (pa, _) = _pair(48, 48)
    ids = np.random.RandomState(4).randint(0, 48, size=N)
    np.testing.assert_array_equal(pa.insert(ids).to_numpy(), np.asarray(ja.insert(ids).bits))
    np.testing.assert_array_equal(pa.contains(ids).numpy(), np.asarray(ja.contains(ids)))
    np.testing.assert_array_equal(pa.insert(ids).contains(ids).numpy(), np.ones(N, bool))


@pytest.mark.parametrize("bad", [48, -1, 1000])
def test_member_ids_past_the_bitmap_raise_as_jax(bad):
    (ja, _), (pa, _) = _pair(48, 48)
    ids = np.zeros(N, np.int64)
    ids[7] = bad
    for op in ("insert", "contains"):
        with pytest.raises(ValueError) as want:
            getattr(ja, op)(ids)
        with pytest.raises(ValueError) as got:
            getattr(pa, op)(ids)
        assert str(got.value) == str(want.value)


def test_scalar_round_trip_interns_as_jax():
    rng = np.random.RandomState(5)
    pool = ["a", "b", 7, ("k", 2), "c", 11]
    sets = [{pool[i] for i in rng.randint(0, len(pool), size=rng.randint(0, 4))}
            for _ in range(25)]
    juni, uni = JaxUniverse(), Universe()
    want = JaxGSetBatch.from_scalar([JaxGSet(set(s)) for s in sets], juni, 8)
    got = GSetBatch.from_scalar([GSet(set(s)) for s in sets], uni, 8, device="cpu")
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.bits))
    assert [g.value for g in got.to_scalar(uni)] == sets
    with pytest.raises(ValueError, match="member universe overflow"):
        JaxGSetBatch.from_scalar([JaxGSet(set(pool))], JaxUniverse(), 4)
    with pytest.raises(ValueError, match="member universe overflow"):
        GSetBatch.from_scalar([GSet(set(pool))], Universe(), 4, device="cpu")
    assert GSetBatch.zeros(3, 5, device="cpu").to_numpy().shape == (3, 5)
